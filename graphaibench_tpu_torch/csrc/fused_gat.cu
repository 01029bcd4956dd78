// The four bucket passes of the fused GAT attention (v2), for Hopper (built
// for sm_90a by graphaibench_tpu_torch/ops/_build.py and bound with ctypes;
// the wrappers and the plain PyTorch versions are in
// graphaibench_tpu_torch/ops/fused_gat.py).
//
// They replace the bucket sweeps of graphaibench_tpu/ops/fused_gat.py, which
// the JAX package writes as XLA programs over one bucket chunk at a time:
//
//   gat_rowmax     _sr_rowmax        m0_i  = max_j sr_j
//   gat_v2_fwd     _v2_fwd_pass      e_ij  = exp(leaky(sl_i + sr_j) - m_i)
//                                    acc_i = sum_j e_ij h_j,  z_i = sum_j e_ij
//   gat_v2_bwd_sl  _v2_bwd, pass B1  p = e_ij zinv_i
//                                    d_sl_i = sum_j p (<ct_i, h_j> - inner_i) leaky'
//   gat_v2_bwd_h   _v2_bwd, pass B2  transpose role, same buckets (the graph is
//                                    structurally symmetric): for row j over
//                                    its neighbours i,
//                                    p = exp(leaky(sl_i + sr_j) - m_i) zinv_i
//                                    d_h_j  = sum_i p ct_i
//                                    d_sr_j = sum_i p (<h_j, ct_i> - inner_i) leaky'
//
// j (or i) runs over the real slots of a virtual row. A pad slot carries
// neighbour 0 and cannot be neutralised by a zero weight (exp of a pad is not
// 0), so every pass loops over the first valid[r] slots of row r only: the
// pads sit at the tail of their row. leaky is LeakyReLU with slope 0.2.
//
// What bounds them on this card: bytes. Each of the three wide passes is a
// gather of rows of an (nv, F) matrix by index, like the SpMM (K1), with an
// exp and a few multiply-adds per gathered float4 on top; gat_rowmax gathers
// one float per slot.
//
// What the design does about it (the same family as csrc/ell_spmm.cu):
//   * One launch per pass for all buckets: a table of per-bucket pointers,
//     row counts and widths travels by value, a block finds its bucket from a
//     prefix of block counts, the widest bucket first (csrc/ell_table.cuh,
//     shared with csrc/ell_edge.cu).
//   * A group of 2^lg lanes owns one virtual row; each lane owns one column
//     of V (float4 when F % 4 == 0 and the tensors are aligned, else float)
//     of the current feature tile. The per-slot scalars (sr_j, or the packed
//     sl_i, m_i, zinv_i, inner_i) are read by every lane of the group from
//     one address and the exp is computed redundantly per lane: that costs
//     no memory traffic and keeps the lanes independent.
//   * A feature tile of at most 32 columns of V: the tile index is the
//     slowest part of the block index, so one tile's slice of the gathered
//     matrix is read by all rows before the next tile's and can stay in L2.
//     Every tile repeats the scalar gathers and the exp, so the wrapper
//     cuts a matrix that exceeds its L2 budget into tiles of 64 floats, not
//     the SpMM's 32. More than 32 columns of V (F > 128) always take
//     several tiles.
//   * The dot products <ct_i, h_j> are never completed per slot. A lane sums
//     p leaky' <its columns> over the slots; the group adds its lanes once
//     per row by shuffles, and the term with inner is subtracted once (by the
//     first tile). The sum is the same; its order differs.
//   * Store where a row has one virtual row, combine where it is split
//     (degree > 64): atomicAdd for sums, an ordered-integer atomicMax/Min for
//     the row max. The wrappers hand in outputs whose split and edgeless rows
//     are initialised (0, or -inf for the max) and nothing else. With more
//     than one feature tile the per-row scalars d_sl and d_sr are summed over
//     tiles too, so then all of their rows are added to a zeroed output.
//   * Gathers are started four slots at a time before any is used.
//
// Built without --use_fast_math: the softmax floor 1e-30 of the wrapper must
// stay a normal float, and exp is expf, not __expf.
//
// Addresses are computed in 64 bits.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "ell_table.cuh"

namespace {

// Two tuning constants can be set at build time (-D...), which
// tools/gat_kernels_probe.py uses to time the alternatives.
#ifndef GAB_GAT_CHUNK
#define GAB_GAT_CHUNK 4
#endif
#ifndef GAB_GAT_ROWMAX_LG
#define GAB_GAT_ROWMAX_LG 3
#endif

constexpr int kChunk = GAB_GAT_CHUNK;          // slots gathered together
constexpr int kRowmaxLg = GAB_GAT_ROWMAX_LG;   // log2 lanes per row, gat_rowmax
constexpr float kSlope = 0.2f;

__device__ __forceinline__ float leaky(float raw) {
  return raw > 0.0f ? raw : kSlope * raw;
}

__device__ __forceinline__ float leaky_grad(float raw) {
  return raw > 0.0f ? 1.0f : kSlope;
}

__global__ void __launch_bounds__(kThreads)
gat_rowmax_kernel(const __grid_constant__ Table tab,
                  const uint8_t* __restrict__ is_split,
                  const float* __restrict__ sr, float* __restrict__ m0) {
  const Pos p = locate(tab, kRowmaxLg);
  const Bucket& b = tab.b[p.bucket];
  float v = -INFINITY;
  if (p.live) {
    const int cnt = __ldg(b.valid + p.r);
    const int32_t* ids = b.nbr + p.r * b.width;
    for (int j = p.gl; j < cnt; j += 1 << kRowmaxLg) {
      v = fmaxf(v, __ldg(sr + __ldg(ids + j)));
    }
  }
  for (int o = (1 << kRowmaxLg) >> 1; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  if (p.live && p.gl == 0) {
    const int32_t row = __ldg(b.row_ids + p.r);
    if (__ldg(is_split + row)) {
      atomic_max_float(m0 + row, v);
    } else {
      m0[row] = v;
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gat_v2_fwd_kernel(const __grid_constant__ Table tab,
                  const uint8_t* __restrict__ is_split,
                  const float* __restrict__ sl, const float* __restrict__ sr,
                  const float* __restrict__ m, const V* __restrict__ h,
                  V* __restrict__ acc, float* __restrict__ z, int64_t f_v,
                  int tile_v, int lg) {
  const Pos p = locate(tab, lg);
  const int64_t col = p.tile * tile_v + p.gl;
  if (!p.live || p.gl >= tile_v || col >= f_v) return;
  const Bucket& b = tab.b[p.bucket];
  const int32_t row = __ldg(b.row_ids + p.r);
  const int cnt = __ldg(b.valid + p.r);
  const int32_t* ids = b.nbr + p.r * b.width;
  const float sli = __ldg(sl + row);
  const float mi = __ldg(m + row);
  V a = zero<V>();
  float zz = 0.0f;
  for (int j0 = 0; j0 < cnt; j0 += kChunk) {
    int32_t id[kChunk];
    V v[kChunk];
    float e[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      id[k] = j0 + k < cnt ? __ldg(ids + j0 + k) : 0;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      v[k] = __ldg(h + static_cast<int64_t>(id[k]) * f_v + col);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float raw = sli + __ldg(sr + id[k]);
      e[k] = j0 + k < cnt ? expf(leaky(raw) - mi) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      axpy(a, e[k], v[k]);
      zz += e[k];
    }
  }
  const bool add = __ldg(is_split + row) != 0;
  put(acc + static_cast<int64_t>(row) * f_v + col, a, add);
  if (p.gl == 0 && p.tile == 0) put(z + row, zz, add);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gat_v2_bwd_sl_kernel(const __grid_constant__ Table tab,
                     const uint8_t* __restrict__ is_split,
                     const float* __restrict__ sl,
                     const float* __restrict__ sr, const float* __restrict__ m,
                     const float* __restrict__ zinv,
                     const float* __restrict__ inner,
                     const V* __restrict__ h, const V* __restrict__ ct,
                     float* __restrict__ d_sl, int64_t f_v, int tile_v,
                     int lg) {
  const Pos p = locate(tab, lg);
  const int64_t col = p.tile * tile_v + p.gl;
  const bool active = p.live && p.gl < tile_v && col < f_v;
  const Bucket& b = tab.b[p.bucket];
  int32_t row = 0;
  float a = 0.0f;  // sum_j p leaky' <ct_i, h_j> over this lane's columns
  float s = 0.0f;  // sum_j p leaky'
  if (p.live) {
    row = __ldg(b.row_ids + p.r);
    const int cnt = __ldg(b.valid + p.r);
    const int32_t* ids = b.nbr + p.r * b.width;
    const float sli = __ldg(sl + row);
    const float mi = __ldg(m + row);
    const float zi = __ldg(zinv + row);
    const V c = active ? __ldg(ct + static_cast<int64_t>(row) * f_v + col)
                       : zero<V>();
    for (int j0 = 0; j0 < cnt; j0 += kChunk) {
      int32_t id[kChunk];
      V v[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        id[k] = j0 + k < cnt ? __ldg(ids + j0 + k) : 0;
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        v[k] = active ? __ldg(h + static_cast<int64_t>(id[k]) * f_v + col)
                      : zero<V>();
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float raw = sli + __ldg(sr + id[k]);
        const float pl = j0 + k < cnt
                             ? expf(leaky(raw) - mi) * zi * leaky_grad(raw)
                             : 0.0f;
        a = fmaf(pl, dot(c, v[k]), a);
        s += pl;
      }
    }
  }
  a = group_sum(a, lg);
  if (p.live && p.gl == 0) {
    const float val = p.tile == 0 ? a - __ldg(inner + row) * s : a;
    put(d_sl + row, val, __ldg(is_split + row) != 0 || tab.tiles > 1);
  }
}

// pack[i] = (sl_i, m_i, zinv_i, inner_i): what the pass needs of a neighbour
// besides its row of ct, in one 16-byte load.
template <typename V>
__global__ void __launch_bounds__(kThreads)
gat_v2_bwd_h_kernel(const __grid_constant__ Table tab,
                    const uint8_t* __restrict__ is_split,
                    const float4* __restrict__ pack,
                    const float* __restrict__ sr, const V* __restrict__ h,
                    const V* __restrict__ ct, V* __restrict__ d_h,
                    float* __restrict__ d_sr, int64_t f_v, int tile_v, int lg) {
  const Pos p = locate(tab, lg);
  const int64_t col = p.tile * tile_v + p.gl;
  const bool active = p.live && p.gl < tile_v && col < f_v;
  const Bucket& b = tab.b[p.bucket];
  int32_t row = 0;
  float a = 0.0f;  // sum_i p leaky' <h_j, ct_i> over this lane's columns
  float s = 0.0f;  // sum_i p leaky' inner_i
  if (p.live) {
    row = __ldg(b.row_ids + p.r);
    const int cnt = __ldg(b.valid + p.r);
    const int32_t* ids = b.nbr + p.r * b.width;
    const float srj = __ldg(sr + row);
    const V hv = active ? __ldg(h + static_cast<int64_t>(row) * f_v + col)
                        : zero<V>();
    V acc = zero<V>();
    for (int j0 = 0; j0 < cnt; j0 += kChunk) {
      int32_t id[kChunk];
      V v[kChunk];
      float4 q[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        id[k] = j0 + k < cnt ? __ldg(ids + j0 + k) : 0;
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        v[k] = active ? __ldg(ct + static_cast<int64_t>(id[k]) * f_v + col)
                      : zero<V>();
        q[k] = __ldg(pack + id[k]);
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const float raw = q[k].x + srj;
        const float pp =
            j0 + k < cnt ? expf(leaky(raw) - q[k].y) * q[k].z : 0.0f;
        const float pl = pp * leaky_grad(raw);
        axpy(acc, pp, v[k]);
        a = fmaf(pl, dot(hv, v[k]), a);
        s = fmaf(pl, q[k].w, s);
      }
    }
    if (active) {
      put(d_h + static_cast<int64_t>(row) * f_v + col, acc,
          __ldg(is_split + row) != 0);
    }
  }
  a = group_sum(a, lg);
  if (p.live && p.gl == 0) {
    const float val = p.tile == 0 ? a - s : a;
    put(d_sr + row, val, __ldg(is_split + row) != 0 || tab.tiles > 1);
  }
}


}  // namespace

// Common arguments of the four entries: the per-bucket arrays
// (GAB_TABLE_PARAMS of csrc/ell_table.cuh; these passes do not read the edge
// ids), then is_split (nv,) uint8; every pointer on CUDA
// device `device`, stream a cudaStream_t of that device. The wide passes take
// f = F, tile_v (1..32 columns of V per tile) and vec: 1 asks for V = float4
// (f % 4 == 0; the (nv, f) matrices aligned to 16 bytes), 0 for V = float.
// The library links its own CUDA runtime, so each entry selects `device`
// before launching. Each returns the first CUDA error (0 on success),
// allocates nothing and does not synchronise.

// m0 (nv,) with -inf in split and edgeless rows -> m0_i = max_j sr_j.
extern "C" int gab_gat_rowmax(GAB_TABLE_PARAMS, const void* is_split,
                              const void* sr, void* m0, int device,
                              void* stream) {
  Table tab;
  cudaError_t err;
  const int64_t grid = fill_table(&tab, GAB_TABLE_ARGS, kRowmaxLg, 1, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gat_rowmax_kernel<<<dim3(static_cast<unsigned>(grid)), dim3(kThreads), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<const uint8_t*>(is_split),
      static_cast<const float*>(sr), static_cast<float*>(m0));
  return static_cast<int>(cudaGetLastError());
}

// acc (nv, f) and z (nv,) with zeros in split and edgeless rows.
extern "C" int gab_gat_v2_fwd(GAB_TABLE_PARAMS, const void* is_split,
                              const void* sl, const void* sr, const void* m,
                              const void* h, void* acc, void* z, int64_t f,
                              int tile_v, int vec, int device, void* stream) {
  WidePlan p;
  const cudaError_t err = plan_wide(&p, GAB_TABLE_ARGS, f, tile_v, vec, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float* slf = static_cast<const float*>(sl);
  const float* srf = static_cast<const float*>(sr);
  const float* mf = static_cast<const float*>(m);
  float* zf = static_cast<float*>(z);
  if (vec) {
    gat_v2_fwd_kernel<float4><<<p.grid, dim3(kThreads), 0, s>>>(
        p.tab, split, slf, srf, mf, static_cast<const float4*>(h),
        static_cast<float4*>(acc), zf, p.f_v, tile_v, p.lg);
  } else {
    gat_v2_fwd_kernel<float><<<p.grid, dim3(kThreads), 0, s>>>(
        p.tab, split, slf, srf, mf, static_cast<const float*>(h),
        static_cast<float*>(acc), zf, p.f_v, tile_v, p.lg);
  }
  return static_cast<int>(cudaGetLastError());
}

// d_sl (nv,) with zeros in split and edgeless rows, or all zeros when the
// pass takes more than one tile (f / (vec ? 4 : 1) > tile_v).
extern "C" int gab_gat_v2_bwd_sl(
    GAB_TABLE_PARAMS, const void* is_split, const void* sl, const void* sr,
    const void* m, const void* zinv, const void* inner, const void* h,
    const void* ct, void* d_sl, int64_t f, int tile_v, int vec, int device,
    void* stream) {
  WidePlan p;
  const cudaError_t err = plan_wide(&p, GAB_TABLE_ARGS, f, tile_v, vec, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float* slf = static_cast<const float*>(sl);
  const float* srf = static_cast<const float*>(sr);
  const float* mf = static_cast<const float*>(m);
  const float* zf = static_cast<const float*>(zinv);
  const float* innerf = static_cast<const float*>(inner);
  float* out = static_cast<float*>(d_sl);
  if (vec) {
    gat_v2_bwd_sl_kernel<float4><<<p.grid, dim3(kThreads), 0, s>>>(
        p.tab, split, slf, srf, mf, zf, innerf, static_cast<const float4*>(h),
        static_cast<const float4*>(ct), out, p.f_v, tile_v, p.lg);
  } else {
    gat_v2_bwd_sl_kernel<float><<<p.grid, dim3(kThreads), 0, s>>>(
        p.tab, split, slf, srf, mf, zf, innerf, static_cast<const float*>(h),
        static_cast<const float*>(ct), out, p.f_v, tile_v, p.lg);
  }
  return static_cast<int>(cudaGetLastError());
}

// pack (nv, 4) f32 rows (sl, m, zinv, inner), aligned to 16 bytes; d_h
// (nv, f) with zeros in split and edgeless rows; d_sr (nv,) likewise, or all
// zeros when the pass takes more than one tile.
extern "C" int gab_gat_v2_bwd_h(
    GAB_TABLE_PARAMS, const void* is_split, const void* pack, const void* sr,
    const void* h, const void* ct, void* d_h, void* d_sr, int64_t f,
    int tile_v, int vec, int device, void* stream) {
  WidePlan p;
  const cudaError_t err = plan_wide(&p, GAB_TABLE_ARGS, f, tile_v, vec, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float4* pk = static_cast<const float4*>(pack);
  const float* srf = static_cast<const float*>(sr);
  float* dsr = static_cast<float*>(d_sr);
  if (vec) {
    gat_v2_bwd_h_kernel<float4><<<p.grid, dim3(kThreads), 0, s>>>(
        p.tab, split, pk, srf, static_cast<const float4*>(h),
        static_cast<const float4*>(ct), static_cast<float4*>(d_h), dsr, p.f_v,
        tile_v, p.lg);
  } else {
    gat_v2_bwd_h_kernel<float><<<p.grid, dim3(kThreads), 0, s>>>(
        p.tab, split, pk, srf, static_cast<const float*>(h),
        static_cast<const float*>(ct), static_cast<float*>(d_h), dsr, p.f_v,
        tile_v, p.lg);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
