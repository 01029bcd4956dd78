// K8, the pull step of the analytics solvers, for Hopper (built for sm_90a by
// graphaibench_tpu_torch/ops/_build.py and bound with ctypes; the wrapper and
// the plain PyTorch version are in graphaibench_tpu_torch/ops/ell_pull.py).
//
// It replaces graphaibench_tpu/ops/segment.py::neighbor_reduce, an XLA
// program of the JAX package that sweeps one bucket chunk at a time:
//
//   neighbor_reduce  out_i = reduce over the real slots j of row i of
//                             vals[nbr_j], or vals[nbr_j] + ev_j (min, max),
//                             or vals[nbr_j] * ev_j (sum)
//
// with reduce one of min, max and sum, vals int32 or float32 with one value
// per gathered row (n_cols; nv but in a rank's rectangular table), and ev
// the per-slot edge values of the bucket (float32 only), packed once per
// solve by the wrapper in the layout of the slot ids. A row with no
// edge keeps the reduction's identity (INT_MAX / INT_MIN / 0, +-inf / 0),
// which the wrapper writes. BFS, SSSP, connected components and PageRank
// spend their sweeps here: one launch a sweep.
//
// What bounds it on this card: the gathers. The compulsory traffic is 4
// bytes per edge of ids (8 with edge values), 8 per virtual row (row id and
// count), the split flags and 4 per vertex each for vals and out: 73 MB on
// rmat(19, 16) (136 MB with edge values), 0.022 ms at 3.35 TB/s (0.041).
// Measured there (tools/analytics_probe.py --pull-kernels; NVIDIA H100
// 80GB HBM3, 700 W): the sweep with every gather sent to one vertex takes
// 0.027-0.035 ms, the id stream; 15.8 M gathers with no id stream take
// 0.113 ms at uniformly random ids, 0.024 ms inside 128 KiB of vals (which
// L1 holds), 0.014 ms inside one line. So a gather that L1 misses is served
// at L2's rate of scattered 32-byte sectors, and the sweep (0.09 ms) is set
// by how many of rmat's skewed gathers L1 catches; the split rows' atomics
// cost nothing measurable (their slots run at the wide buckets' rate).
//
// What the design does about it (over csrc/ell_table.cuh's table):
//   * One launch per call covers every bucket, widest first; a block finds
//     its bucket from a prefix of block counts, counted with the bucket's
//     own lanes a row.
//   * Lanes a row by the bucket's width (1 at width 4-8, 2 at 16, 4 at 32,
//     8 at 64): every lane reads two int4 of ids a step (and, with edge
//     values, two float4 of them beside the ids) and has their eight gathers
//     in flight, in every bucket; a row of width 64 takes one step. The ids
//     and edge values are read once, without allocating in L1
//     (ld.global.nc.L1::no_allocate), which L1 keeps for vals: on that card
//     the id stream alone (every gather at vertex 0) reads 11% faster than
//     through L1, the sweeps up to 5%. The ids are
//     read up to the bucket's width without waiting for the row's count
//     (every slot holds a real or a pad neighbour, and pads hold vertex 0),
//     which arrives beside them and decides which slots are gathered: the
//     pads at the tail of the row take the identity, in place of the JAX
//     package's mask by edge id.
//   * The lanes of a row reduce by shuffles; a row that has one virtual row
//     is stored, the pieces of a split row (degree > 64) are combined:
//     atomicMin / atomicMax for int32, the ordered-integer atomics of
//     ell_table.cuh for float32 min and max, atomicAdd for sums.
//   * Templates over the reduction, the value type and the edge values: nine
//     kernels, each without a branch on the kind in its loop.
//   * vals is indexed by the slot ids alone: a table whose ids index n_cols
//     gathered rows (a rank's own and halo rows) works as it is.
//
// Exact for min, max and int32 sums (integer adds wrap in any order). A
// float32 sum adds in another order than the plain version, and the atomics
// of split rows in an order that changes from run to run.
//
// Not carried over from the JAX package: its two-column packing of vals
// (a TPU gather rule), its row chunks and its segmented sweep.
//
// Addresses are computed in 64 bits.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "ell_table.cuh"

namespace {

// int4 of ids a lane reads a step. The lanes a row follow the bucket's
// width (lanes_lg): each lane has kPullQuads int4 of ids, and their gathers,
// in flight in every bucket, and a row of width 64 takes one step.
constexpr int kPullQuads = 2;
constexpr int kPullMaxLg = 3;

enum Kind { kMin = 0, kMax = 1, kSum = 2 };
enum Dtype { kInt32 = 0, kFloat32 = 1 };

// The per-bucket slot arrays of the edge values, in the table's order.
struct EdgeVals {
  const float* b[kMaxBuckets];
};

template <int KIND>
__device__ __forceinline__ int32_t identity(int32_t) {
  return KIND == kMin ? INT_MAX : KIND == kMax ? INT_MIN : 0;
}
template <int KIND>
__device__ __forceinline__ float identity(float) {
  return KIND == kMin ? INFINITY : KIND == kMax ? -INFINITY : 0.0f;
}

template <int KIND>
__device__ __forceinline__ int32_t reduce2(int32_t a, int32_t b) {
  return KIND == kMin ? min(a, b) : KIND == kMax ? max(a, b) : a + b;
}
template <int KIND>
__device__ __forceinline__ float reduce2(float a, float b) {
  return KIND == kMin ? fminf(a, b) : KIND == kMax ? fmaxf(a, b) : a + b;
}

// Combines into a row that several virtual rows share.
template <int KIND>
__device__ __forceinline__ void combine(int32_t* dst, int32_t v) {
  if (KIND == kMin) {
    atomicMin(dst, v);
  } else if (KIND == kMax) {
    atomicMax(dst, v);
  } else {
    atomicAdd(dst, v);
  }
}
template <int KIND>
__device__ __forceinline__ void combine(float* dst, float v) {
  if (KIND == kMin) {
    atomic_min_float(dst, v);
  } else if (KIND == kMax) {
    atomic_max_float(dst, v);
  } else {
    atomicAdd(dst, v);
  }
}

// Sixteen bytes of the id or edge-value stream, read once, not kept in L1.
template <typename V>
__device__ __forceinline__ V stream16(const V* p) {
  int4 r;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return *reinterpret_cast<V*>(&r);
}

// One slot: its neighbour's value, with the slot's edge value where given;
// the identity for a pad.
template <int KIND, typename T, bool EV>
__device__ __forceinline__ T slot(const T* __restrict__ vals, int32_t id,
                                  float e, bool real) {
  if (!real) return identity<KIND>(T());
  const T x = __ldg(vals + id);
  if constexpr (EV) {
    return KIND == kSum ? x * e : x + e;
  } else {
    return x;
  }
}

// log2 lanes a row for a bucket of `width` slots.
int lanes_lg(int32_t width) {
  int lg = 0;
  while (lg < kPullMaxLg && (4 * kPullQuads << lg) < width) ++lg;
  return lg;
}

// A group of 2^lg lanes a row (lg by the bucket's width); lane gl takes
// the quads of slots 4 gl + 4 2^lg u + 4 kPullQuads 2^lg s (u < kPullQuads,
// s = 0, 1, ...) up to the bucket's width. Every bucket's width is a
// multiple of 4 and its ids (and edge values) start 16-byte aligned: the
// wrapper checks.
template <int KIND, typename T, bool EV>
__global__ void __launch_bounds__(kThreads)
neighbor_reduce_kernel(const __grid_constant__ Table tab,
                       const __grid_constant__ EdgeVals ev,
                       const uint8_t* __restrict__ is_split,
                       const T* __restrict__ vals, T* __restrict__ out) {
  const int32_t blk = blockIdx.x;
  int bi = 0;
  while (bi + 1 < tab.n && blk >= tab.b[bi + 1].first_block) ++bi;
  const Bucket& b = tab.b[bi];
  const int lg = b.lg;
  const int64_t r =
      (static_cast<int64_t>(blk - b.first_block) * kThreads + threadIdx.x) >>
      lg;
  const int gl = threadIdx.x & ((1 << lg) - 1);
  const bool live = r < b.rows;
  const int step = 4 * kPullQuads << lg;  // slots a group takes a step
  T v = identity<KIND>(T());
  int32_t row = 0;
  bool split = false;
  if (live) {
    row = __ldg(b.row_ids + r);
    const int cnt = __ldg(b.valid + r);
    const int64_t first = r * b.width;
    const int4* ids = reinterpret_cast<const int4*>(b.nbr + first);
    const float4* evs =
        EV ? reinterpret_cast<const float4*>(ev.b[bi] + first) : nullptr;
    for (int j0 = 4 * gl; j0 < b.width; j0 += step) {
      int4 q[kPullQuads];
      float4 e[kPullQuads];
#pragma unroll
      for (int u = 0; u < kPullQuads; ++u) {
        const int j = j0 + (4 << lg) * u;
        const bool in = j < b.width;
        q[u] = in ? stream16(ids + j / 4) : make_int4(0, 0, 0, 0);
        e[u] = EV && in ? stream16(evs + j / 4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      T sv[kPullQuads][4];
#pragma unroll
      for (int u = 0; u < kPullQuads; ++u) {
        const int j = j0 + (4 << lg) * u;
        sv[u][0] = slot<KIND, T, EV>(vals, q[u].x, e[u].x, j < cnt);
        sv[u][1] = slot<KIND, T, EV>(vals, q[u].y, e[u].y, j + 1 < cnt);
        sv[u][2] = slot<KIND, T, EV>(vals, q[u].z, e[u].z, j + 2 < cnt);
        sv[u][3] = slot<KIND, T, EV>(vals, q[u].w, e[u].w, j + 3 < cnt);
      }
#pragma unroll
      for (int u = 0; u < kPullQuads; ++u) {
        v = reduce2<KIND>(v, reduce2<KIND>(reduce2<KIND>(sv[u][0], sv[u][1]),
                                           reduce2<KIND>(sv[u][2], sv[u][3])));
      }
    }
    split = __ldg(is_split + row) != 0;
  }
  // every thread of a block has its bucket's lg
  for (int o = (1 << lg) >> 1; o > 0; o >>= 1) {
    v = reduce2<KIND>(v, __shfl_xor_sync(kFullMask, v, o));
  }
  if (live && gl == 0) {
    if (split) {
      combine<KIND>(out + row, v);
    } else {
      out[row] = v;
    }
  }
}

template <int KIND, typename T, bool EV>
void launch(int64_t blocks, cudaStream_t stream, const Table& tab,
            const EdgeVals& ev, const uint8_t* is_split, const void* vals,
            void* out) {
  neighbor_reduce_kernel<KIND, T, EV>
      <<<dim3(static_cast<unsigned>(blocks)), dim3(kThreads), 0, stream>>>(
          tab, ev, is_split, static_cast<const T*>(vals), static_cast<T*>(out));
}

template <typename T, bool EV>
void launch_kind(int kind, int64_t blocks, cudaStream_t stream,
                 const Table& tab, const EdgeVals& ev,
                 const uint8_t* is_split, const void* vals, void* out) {
  if (kind == kMin) {
    launch<kMin, T, EV>(blocks, stream, tab, ev, is_split, vals, out);
  } else if (kind == kMax) {
    launch<kMax, T, EV>(blocks, stream, tab, ev, is_split, vals, out);
  } else {
    launch<kSum, T, EV>(blocks, stream, tab, ev, is_split, vals, out);
  }
}

}  // namespace

// The per-bucket arrays (GAB_TABLE_PARAMS of csrc/ell_table.cuh; the edge ids
// are not read), then is_split (nv,) uint8 and edge_vals: null, or one
// float32 slot array per bucket in the table's order, (rows[i] * widths[i],),
// 16-byte aligned. vals (n_cols,) and out (nv,) of int32 (dtype 0) or float32
// (dtype 1): vals is read only at the slots' ids and out written only at
// the virtual rows' row ids, so a rectangular table needs nothing else; out
// holds the identity of `kind` (0 min, 1 max, 2 sum) in split and
// edgeless rows. Edge values go with float32 only. Every pointer on CUDA
// device `device`, stream a cudaStream_t of that device. Every bucket's width
// is a multiple of 4 and its nbr 16-byte aligned. The library links its own
// CUDA runtime, so the entry selects `device` before launching. Returns the
// first CUDA error (0 on success), allocates nothing and does not
// synchronise.
extern "C" int gab_neighbor_reduce(GAB_TABLE_PARAMS, const void* is_split,
                                   const void* const* edge_vals,
                                   const void* vals, void* out, int kind,
                                   int dtype, int device, void* stream) {
  if (kind < kMin || kind > kSum || dtype < kInt32 || dtype > kFloat32 ||
      (edge_vals != nullptr && dtype != kFloat32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table tab;
  cudaError_t err;
  const int64_t blocks =
      fill_table(&tab, GAB_TABLE_ARGS, 0, 1, &err, lanes_lg);
  if (blocks == 0) return static_cast<int>(err);
  EdgeVals ev{};
  if (edge_vals != nullptr) {
    for (int i = 0; i < n_buckets; ++i) {
      ev.b[i] = static_cast<const float*>(edge_vals[i]);
    }
  }
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  if (dtype == kInt32) {
    launch_kind<int32_t, false>(kind, blocks, s, tab, ev, split, vals, out);
  } else if (edge_vals != nullptr) {
    launch_kind<float, true>(kind, blocks, s, tab, ev, split, vals, out);
  } else {
    launch_kind<float, false>(kind, blocks, s, tab, ev, split, vals, out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
