// K1: the weighted ELL gather-reduce (SpMM) over every degree bucket of a
// graph, for Hopper (built for sm_90a by graphaibench_tpu_torch/ops/_build.py
// and bound with ctypes; the wrapper is graphaibench_tpu_torch/ops/ell_spmm.py).
//
// Replaces graphaibench_tpu/ops/pallas_spmm.py::_bucket_kernel, the Pallas
// TPU kernel that _run_bucket / spmm_ell_pallas launch once per bucket.
// For each bucket of width W with R virtual rows:
//
//     out[row_ids[r], :] += sum_{j < W} w[r*W + j] * x[nbr[r*W + j], :]
//
// Pad slots carry nbr 0 and weight 0, so they add nothing. A row of degree
// 1..split is exactly one virtual row; a row wider than the split (64) is
// cut into several virtual rows that target the same output row, in the
// width-64 bucket and again in a narrower bucket for the remainder.
//
// What bounds it on this card: bytes. The work is a gather of rows of x by
// index at 0.5 FLOP per byte. A call must read x once, the slot ids and
// weights once, and write the output once (172.6 MB on the GCN main path at
// F = 128: rmat17 with self-loops, 4.72 M slots). What it really reads
// depends on how many gathered rows the 50 MB L2 still holds: x at F = 128
// is 64 MB there.
//
// What the design does about it:
//   * One launch for all buckets. A table of per-bucket pointers, row
//     counts and widths travels by value as a kernel argument; a block finds
//     its bucket from a prefix of block counts. The caller lists the widest
//     bucket first, so the long rows start first and do not form the tail.
//   * 16-byte loads, sub-warp groups. When F % 4 == 0 a group of G lanes
//     (G = the tile's float4 columns rounded up to a power of two, at most
//     32) owns one virtual row and each lane gathers one float4 per slot:
//     at F = 128 one load of the group reads a whole 512-byte row, at F = 16
//     a group is 4 lanes and a warp works on 8 rows at once. The kernel is
//     instantiated per width (4, 8, 16, 32, 64), so the slot loop unrolls
//     into chunks of 8 independent gathers per lane. A row's ids and
//     weights are read as int4 / float4 too, every lane of the group from
//     the same address (one transaction, broadcast). Reading them once,
//     coalesced across the group, and passing them by __shfl_sync timed
//     the same on an H100 at F = 128 and within its own spread at F = 16;
//     it needs the group size as a second template parameter and every
//     lane alive at the shuffles, so it was not kept.
//   * Store where a row has one piece, add only where it is split.
//     `is_split[row]` (degree > split, built on the host) selects a plain
//     16-byte store or an atomicAdd. The wrapper allocates `out`
//     uninitialised and zeroes only the rows that no store covers (degree 0
//     and split rows), so there is no full zero-fill and unsplit rows are
//     bit-reproducible.
//   * A feature tile that stays in cache. A block works on `tile_f4` float4
//     columns of its rows; the tile index is the slowest-varying part of the
//     block index, so one tile's rows are gathered (nv * tile * 4 bytes of
//     x: 16 MB at rmat17 with a tile of 32 floats) before the next tile's.
//     The ids and weights are re-read once per tile. Blocks may run in any
//     order: each (row, tile) is written by its own lanes only, so the
//     tiling is right for any order and only faster for the usual one. The
//     wrapper picks the tile from nv and F; a piece is never narrower than
//     one 128-byte line (32 floats).
//   * A narrow instantiation for F < 4 (PageRank's F = 1 on a rank's
//     tables): lanes a virtual row by the bucket's width, as K8 has them
//     (one at widths 4 and 8, then one a chunk of 8 slots: 8 lanes at 64),
//     each lane reading its chunk's ids and weights as int4 / float4 and
//     having its 4-8 gathers in flight; the row's lanes add by shuffles.
//     On an H100 at F = 1, on the own table of rank 0 of rmat(19, 16) at
//     two ranks, where rmat's hubs lie: 0.057 ms of device time, against
//     0.090 for a thread a row (8 chunks one after the other at width 64)
//     and 0.258 for the scalar instantiation (PERF.md).
//     It needs the listed widths and 16-byte aligned ids and weights.
//   * A scalar instantiation (run-time width, one warp per virtual row,
//     lanes over the features, 4-byte loads) takes the rest: F % 4 != 0
//     from F = 5 on, unaligned tensors and widths outside the list above,
//     with the same table, the same store-or-add rule and one launch. At
//     F = 1 one lane of its 32 would work, which the narrow one avoids.
//
// Not used: shared memory, cp.async, TMA. The gathered rows are used once
// per block, TMA copies tiles and not rows chosen by index, and at 34
// registers per thread every SM holds its full 64 warps, whose gathers in
// flight from registers cover more bytes than the memory rate needs.
//
// Addresses are computed in 64 bits: nbr * F fits int32 at rmat17 but not
// at products scale with wide F.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBuckets = 8;
constexpr int kThreads = 256;

struct Bucket {
  const int32_t* row_ids;  // (rows,)
  const int32_t* nbr;      // (rows * width,)
  const float* w;          // (rows * width,)
  int64_t rows;
  int32_t width;
  int32_t first_block;     // of this bucket inside one tile's blocks
};

struct Table {
  Bucket b[kMaxBuckets];
  int32_t n;
  int32_t blocks_per_tile;
};

// One lane's part of one virtual row: W slots, one float4 column.
template <int W>
__device__ __forceinline__ void row_vec(const Bucket& b, int64_t r,
                                        int64_t col4, int64_t f4,
                                        const float4* __restrict__ x4,
                                        float4* __restrict__ out4,
                                        const uint8_t* __restrict__ is_split) {
  constexpr int kChunk = W < 8 ? W : 8;
  const int32_t row = __ldg(b.row_ids + r);
  const int4* ids = reinterpret_cast<const int4*>(b.nbr + r * W);
  const float4* ws = reinterpret_cast<const float4*>(b.w + r * W);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j0 = 0; j0 < W; j0 += kChunk) {
    int32_t id[kChunk];
    float wt[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk / 4; ++q) {
      const int4 i4 = __ldg(ids + j0 / 4 + q);
      const float4 w4 = __ldg(ws + j0 / 4 + q);
      id[4 * q + 0] = i4.x; id[4 * q + 1] = i4.y;
      id[4 * q + 2] = i4.z; id[4 * q + 3] = i4.w;
      wt[4 * q + 0] = w4.x; wt[4 * q + 1] = w4.y;
      wt[4 * q + 2] = w4.z; wt[4 * q + 3] = w4.w;
    }
    float4 v[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      v[k] = __ldg(x4 + static_cast<int64_t>(id[k]) * f4 + col4);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      acc.x = fmaf(wt[k], v[k].x, acc.x);
      acc.y = fmaf(wt[k], v[k].y, acc.y);
      acc.z = fmaf(wt[k], v[k].z, acc.z);
      acc.w = fmaf(wt[k], v[k].w, acc.w);
    }
  }
  float4* dst = out4 + static_cast<int64_t>(row) * f4 + col4;
  if (__ldg(is_split + row)) {
    atomicAdd(dst, acc);
  } else {
    *dst = acc;
  }
}

// Lanes a virtual row in the narrow instantiation, by the bucket's width:
// one at widths 4 and 8, then one a chunk of 8 slots (2 at 16, 4 at 32, 8
// at 64). Returns their log2.
__host__ __device__ inline int narrow_lg(int width) {
  return width <= 8 ? 0 : width == 16 ? 1 : width == 32 ? 2 : 3;
}

// One lane's chunk of C slots (4 or 8) of virtual row r at F < 4: the
// chunk's ids and weights as int4 / float4, its C gathers of a column in
// flight. The row's 1 << lg lanes, aligned in the warp, add by shuffles,
// and the first stores (or adds, where the row is split). Every lane of the
// warp takes part in the shuffles: those past the bucket's rows come with
// valid false and load nothing.
template <int C>
__device__ __forceinline__ void row_narrow(const Bucket& b, int64_t r,
                                           bool valid, int gl, int lg, int f,
                                           const float* __restrict__ x,
                                           float* __restrict__ out,
                                           const uint8_t* __restrict__ is_split) {
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (valid) {
    const int64_t s0 = r * b.width + gl * C;
    const int4* ids = reinterpret_cast<const int4*>(b.nbr + s0);
    const float4* ws = reinterpret_cast<const float4*>(b.w + s0);
    int32_t id[C];
    float wt[C];
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const int4 i4 = __ldg(ids + q);
      const float4 w4 = __ldg(ws + q);
      id[4 * q + 0] = i4.x; id[4 * q + 1] = i4.y;
      id[4 * q + 2] = i4.z; id[4 * q + 3] = i4.w;
      wt[4 * q + 0] = w4.x; wt[4 * q + 1] = w4.y;
      wt[4 * q + 2] = w4.z; wt[4 * q + 3] = w4.w;
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < f) {
        float v[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
          v[k] = __ldg(x + static_cast<int64_t>(id[k]) * f + c);
        }
#pragma unroll
        for (int k = 0; k < C; ++k) acc[c] = fmaf(wt[k], v[k], acc[c]);
      }
    }
  }
  for (int off = 1; off < (1 << lg); off <<= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < f) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
    }
  }
  if (!valid || gl != 0) return;
  const int32_t row = __ldg(b.row_ids + r);
  const bool split = __ldg(is_split + row) != 0;
  float* dst = out + static_cast<int64_t>(row) * f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c < f) {
      if (split) {
        atomicAdd(dst + c, acc[c]);
      } else {
        dst[c] = acc[c];
      }
    }
  }
}

enum Mode { kScalar = 0, kVector = 1, kNarrow = 2 };

// kVector: `lg` is log2 of the lanes per virtual row, `tile_f4` the float4
// columns of a tile and f4 = F / 4. kNarrow: lanes a row by the bucket's
// width (narrow_lg), one tile, f = F < 4. kScalar: lg = 5, one tile, f = F.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const __grid_constant__ Table tab,
                const uint8_t* __restrict__ is_split,
                const float* __restrict__ x, float* __restrict__ out,
                int64_t f, int tile_f4, int lg) {
  const int64_t tile = blockIdx.x / tab.blocks_per_tile;
  const int32_t blk = blockIdx.x % tab.blocks_per_tile;
  int i = 0;
  while (i + 1 < tab.n && blk >= tab.b[i + 1].first_block) ++i;
  const Bucket& b = tab.b[i];
  if constexpr (kMode == kNarrow) {
    const int nlg = narrow_lg(b.width);
    const int64_t rn =
        (static_cast<int64_t>(blk - b.first_block) * kThreads + threadIdx.x) >> nlg;
    const int gln = threadIdx.x & ((1 << nlg) - 1);
    const bool valid = rn < b.rows;
    const int fi = static_cast<int>(f);
    if (b.width == 4) {
      row_narrow<4>(b, rn, valid, gln, nlg, fi, x, out, is_split);
    } else {
      row_narrow<8>(b, rn, valid, gln, nlg, fi, x, out, is_split);
    }
    return;
  }
  const int64_t r =
      (static_cast<int64_t>(blk - b.first_block) * kThreads + threadIdx.x) >> lg;
  const int gl = threadIdx.x & ((1 << lg) - 1);
  if (r >= b.rows) return;
  if constexpr (kMode == kVector) {
    const int64_t f4 = f >> 2;
    const int64_t col4 = tile * tile_f4 + gl;
    if (gl >= tile_f4 || col4 >= f4) return;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    float4* out4 = reinterpret_cast<float4*>(out);
    switch (b.width) {
      case 4: row_vec<4>(b, r, col4, f4, x4, out4, is_split); break;
      case 8: row_vec<8>(b, r, col4, f4, x4, out4, is_split); break;
      case 16: row_vec<16>(b, r, col4, f4, x4, out4, is_split); break;
      case 32: row_vec<32>(b, r, col4, f4, x4, out4, is_split); break;
      case 64: row_vec<64>(b, r, col4, f4, x4, out4, is_split); break;
      default: break;  // the C entry admits no other width here
    }
  } else {
    const int width = b.width;
    const int64_t slot0 = r * width;
    const int32_t row = b.row_ids[r];
    const bool split = is_split[row] != 0;
    float* dst = out + static_cast<int64_t>(row) * f;
    for (int64_t c = gl; c < f; c += 32) {
      float acc = 0.0f;
      for (int j = 0; j < width; ++j) {
        const float wj = b.w[slot0 + j];
        const int64_t src = static_cast<int64_t>(b.nbr[slot0 + j]) * f;
        acc = fmaf(wj, x[src + c], acc);
      }
      if (split) {
        atomicAdd(dst + c, acc);
      } else {
        dst[c] = acc;
      }
    }
  }
}

bool vec_width(int w) {
  return w == 4 || w == 8 || w == 16 || w == 32 || w == 64;
}

}  // namespace

// One SpMM over n_buckets buckets, given in launch order (widest first).
// row_ids[i] (rows[i],) int32, nbr[i] and w[i] (rows[i] * widths[i],) int32
// and f32, is_split (nv,) uint8, x (nv, f) f32 row-major, out (nv, f) f32
// whose rows of degree 0 and split rows are zero; every pointer on CUDA
// device `device`, stream a cudaStream_t of that device.
//
// tile_f4 > 0 asks for the vector instantiation with tiles of tile_f4
// float4 columns (at most 32): it needs f % 4 == 0, every width in
// {4, 8, 16, 32, 64}, and x, out, nbr[i] and w[i] aligned to 16 bytes.
// tile_f4 == -1 asks for the narrow instantiation: it needs f < 4, every
// width in that list and nbr[i] and w[i] aligned to 16 bytes. tile_f4 == 0
// asks for the scalar instantiation, which takes any f, width and
// alignment.
//
// The library links its own CUDA runtime, whose current device is not the
// caller's, so the entry selects `device` before launching. Returns the
// first CUDA error (0 on success). Allocates nothing, does not synchronise.
extern "C" int gab_ell_spmm(const void* const* row_ids, const void* const* nbr,
                            const void* const* w, const int64_t* rows,
                            const int32_t* widths, int n_buckets,
                            const void* is_split, const void* x, void* out,
                            int64_t f, int tile_f4, int device, void* stream) {
  if (n_buckets <= 0 || f <= 0) return 0;
  if (n_buckets > kMaxBuckets || tile_f4 < -1 || tile_f4 > 32 ||
      (tile_f4 > 0 && f % 4 != 0) || (tile_f4 < 0 && f >= 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int mode = tile_f4 > 0 ? kVector : tile_f4 < 0 ? kNarrow : kScalar;
  int lg = 5;
  int64_t tiles = 1;
  if (mode == kVector) {
    lg = 0;
    while ((1 << lg) < tile_f4) ++lg;
    tiles = (f / 4 + tile_f4 - 1) / tile_f4;
  }
  const int64_t rows_per_block = kThreads >> lg;
  Table tab = {};
  tab.n = n_buckets;
  int64_t blocks = 0;
  for (int i = 0; i < n_buckets; ++i) {
    if (rows[i] <= 0 || widths[i] <= 0 ||
        (mode != kScalar && !vec_width(widths[i]))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    tab.b[i].row_ids = static_cast<const int32_t*>(row_ids[i]);
    tab.b[i].nbr = static_cast<const int32_t*>(nbr[i]);
    tab.b[i].w = static_cast<const float*>(w[i]);
    tab.b[i].rows = rows[i];
    tab.b[i].width = widths[i];
    if (blocks > 0x7fffffff) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    tab.b[i].first_block = static_cast<int32_t>(blocks);
    const int64_t per = mode == kNarrow ? kThreads >> narrow_lg(widths[i])
                                        : rows_per_block;
    blocks += (rows[i] + per - 1) / per;
  }
  if (blocks * tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  tab.blocks_per_tile = static_cast<int32_t>(blocks);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned>(blocks * tiles));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  if (mode == kVector) {
    ell_spmm_kernel<kVector><<<grid, dim3(kThreads), 0, s>>>(
        tab, split, xf, of, f, tile_f4, lg);
  } else if (mode == kNarrow) {
    ell_spmm_kernel<kNarrow><<<grid, dim3(kThreads), 0, s>>>(
        tab, split, xf, of, f, 0, lg);
  } else {
    ell_spmm_kernel<kScalar><<<grid, dim3(kThreads), 0, s>>>(
        tab, split, xf, of, f, 0, lg);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
