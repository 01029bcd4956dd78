// Three bucket passes over per-edge values, for Hopper (built for sm_90a by
// graphaibench_tpu_torch/ops/_build.py and bound with ctypes; the wrappers and
// the plain PyTorch versions are in graphaibench_tpu_torch/ops/ell_edge.py).
//
// They replace XLA programs of the JAX package that sweep the ELL buckets
// with per-edge arrays read through the slots' edge ids:
//
//   ell_row_reduce  ops/segment.py::_row_reduce_ell and
//                   ops/fused_gat.py::_row_denom_ell
//                                    per row i over its edges e:
//                                    max_e v_e, sum_e v_e, sum_e exp(v_e - m_i)
//   gat_v1_fwd      ops/fused_gat.py::_fused_fwd_pass
//                                    out_i = sum_j exp(l_e - m_i) zinv_i w_e x_j
//                                    (e the edge of slot j, x_j its neighbour's
//                                    row): the fused GAT attention on per-edge
//                                    logits and per-edge weights or masks
//   sddmm_dot_ell   ops/spmm.py::sddmm_dot
//                                    raw_e = <a_i, b_j> for the edge e = (i, j)
//                                    of every real slot
//
// Plain PyTorch would write an (E, F) or (R, W, F) intermediate for the two
// wide passes and run a scatter by edge source for the reduction.
//
// A pad slot carries edge id ne, one past the per-edge arrays, so every pass
// loops over the first valid[r] slots of virtual row r only (the pads sit at
// the tail of their row) and never reads v[ne].
//
// What bounds them on this card: bytes. ell_row_reduce streams 8 bytes per
// edge (the id and the value; the ids of a row are consecutive when the
// layout was packed from a CSR graph, so the values arrive coalesced) for
// one multiply-add or exp. The two wide passes are gathers of rows of an
// (nv, F) matrix by index, like the SpMM (K1), with two scalar gathers by
// edge id (gat_v1_fwd) or one scalar store by edge id (sddmm_dot_ell) per
// slot on top.
//
// What the design does about it (the family of csrc/ell_spmm.cu and
// csrc/fused_gat.cu, with the table, the position rule and the
// store-or-combine rule of csrc/ell_table.cuh):
//   * One launch per pass for all buckets, the widest bucket first.
//   * ell_row_reduce: 8 lanes per virtual row, a shuffle reduction, then a
//     store where the row has one virtual row and an atomic (add, or the
//     ordered-integer max) where it is split. The wrapper initialises only
//     the split and edgeless rows (0, or -inf for the max).
//   * gat_v1_fwd: a group of 2^lg lanes owns a virtual row, each lane one
//     column of V (float4 when F % 4 == 0 and the tensors are aligned, else
//     float) of the current feature tile; the per-slot scalars (l_e, w_e) are
//     read by every lane of the group from one address. A zero weight gives
//     an exact 0 whatever the exp is. Feature tiles, gathers four slots at a
//     time and the store-or-add rule as in gat_v2_fwd.
//   * sddmm_dot_ell: the same group owns a virtual row and keeps its row of
//     `a` in registers (one column of V per lane; with more columns than
//     lanes the lane loops over its columns, so a dot product is completed
//     inside the group and each edge is written once, by a plain store: every
//     edge sits in exactly one slot). Per slot the lanes' partial dot
//     products are added by shuffles. Every lane of a warp takes part in a
//     shuffle, and the rows of a warp differ in length, so the slot loop runs
//     to the bucket's width for all of them (a block lies inside one bucket)
//     and a lane past its row's end adds zeros and stores nothing.
//
// Built without --use_fast_math: exp is expf, and the softmax floor 1e-30 of
// the wrapper must stay a normal float.
//
// Addresses are computed in 64 bits.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "ell_table.cuh"

namespace {

constexpr int kChunk = 4;     // slots gathered together
constexpr int kReduceLg = 3;  // log2 lanes per row, ell_row_reduce

enum Kind { kMax = 0, kSum = 1, kSumExp = 2 };

template <int KIND>
__global__ void __launch_bounds__(kThreads)
ell_row_reduce_kernel(const __grid_constant__ Table tab,
                      const uint8_t* __restrict__ is_split,
                      const float* __restrict__ vals,
                      const float* __restrict__ m, float* __restrict__ out) {
  const Pos p = locate(tab, kReduceLg);
  const Bucket& b = tab.b[p.bucket];
  float v = KIND == kMax ? -INFINITY : 0.0f;
  int32_t row = 0;
  if (p.live) {
    row = __ldg(b.row_ids + p.r);
    const int cnt = __ldg(b.valid + p.r);
    const int32_t* eids = b.edge_id + p.r * b.width;
    const float mi = KIND == kSumExp ? __ldg(m + row) : 0.0f;
    for (int j = p.gl; j < cnt; j += 1 << kReduceLg) {
      const float x = __ldg(vals + __ldg(eids + j));
      if (KIND == kMax) {
        v = fmaxf(v, x);
      } else if (KIND == kSum) {
        v += x;
      } else {
        v += expf(x - mi);
      }
    }
  }
  for (int o = (1 << kReduceLg) >> 1; o > 0; o >>= 1) {
    const float other = __shfl_xor_sync(0xffffffffu, v, o);
    v = KIND == kMax ? fmaxf(v, other) : v + other;
  }
  if (p.live && p.gl == 0) {
    if (__ldg(is_split + row) == 0) {
      out[row] = v;
    } else if (KIND == kMax) {
      atomic_max_float(out + row, v);
    } else {
      atomicAdd(out + row, v);
    }
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gat_v1_fwd_kernel(const __grid_constant__ Table tab,
                  const uint8_t* __restrict__ is_split,
                  const float* __restrict__ logits,
                  const float* __restrict__ edge_w,
                  const float* __restrict__ m, const float* __restrict__ zinv,
                  const V* __restrict__ x, V* __restrict__ out, int64_t f_v,
                  int tile_v, int lg) {
  const Pos p = locate(tab, lg);
  const int64_t col = p.tile * tile_v + p.gl;
  if (!p.live || p.gl >= tile_v || col >= f_v) return;
  const Bucket& b = tab.b[p.bucket];
  const int32_t row = __ldg(b.row_ids + p.r);
  const int cnt = __ldg(b.valid + p.r);
  const int32_t* ids = b.nbr + p.r * b.width;
  const int32_t* eids = b.edge_id + p.r * b.width;
  const float mi = __ldg(m + row);
  const float zi = __ldg(zinv + row);
  V a = zero<V>();
  for (int j0 = 0; j0 < cnt; j0 += kChunk) {
    int32_t id[kChunk];
    int32_t e[kChunk];
    V v[kChunk];
    float s[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const bool real = j0 + k < cnt;
      id[k] = real ? __ldg(ids + j0 + k) : 0;
      e[k] = real ? __ldg(eids + j0 + k) : -1;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      v[k] = __ldg(x + static_cast<int64_t>(id[k]) * f_v + col);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      s[k] = 0.0f;
      if (e[k] >= 0) {
        const float w = __ldg(edge_w + e[k]);
        // a masked edge adds an exact zero, not 0 * exp(...)
        if (w != 0.0f) s[k] = expf(__ldg(logits + e[k]) - mi) * zi * w;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      axpy(a, s[k], v[k]);
    }
  }
  put(out + static_cast<int64_t>(row) * f_v + col, a,
      __ldg(is_split + row) != 0);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
sddmm_dot_ell_kernel(const __grid_constant__ Table tab,
                     const V* __restrict__ a, const V* __restrict__ b,
                     float* __restrict__ raw, int64_t f_v, int lg) {
  const Pos p = locate(tab, lg);
  const Bucket& bk = tab.b[p.bucket];
  const int lanes = 1 << lg;
  int cnt = 0;
  const int32_t* ids = nullptr;
  const int32_t* eids = nullptr;
  const V* arow = nullptr;
  if (p.live) {
    cnt = __ldg(bk.valid + p.r);
    ids = bk.nbr + p.r * bk.width;
    eids = bk.edge_id + p.r * bk.width;
    arow = a + static_cast<int64_t>(__ldg(bk.row_ids + p.r)) * f_v;
  }
  // the usual case: one column of V per lane, the row of `a` in registers
  const bool one_pass = f_v <= lanes;
  const V a0 = (cnt > 0 && p.gl < f_v) ? __ldg(arow + p.gl) : zero<V>();
  for (int j0 = 0; j0 < bk.width; j0 += kChunk) {
    int32_t id[kChunk];
    float d[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      id[k] = j0 + k < cnt ? __ldg(ids + j0 + k) : -1;
      d[k] = 0.0f;
    }
    for (int64_t c = p.gl; c < f_v; c += lanes) {
      const V av = one_pass ? a0 : (cnt > 0 ? __ldg(arow + c) : zero<V>());
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (id[k] >= 0) {
          d[k] += dot(av, __ldg(b + static_cast<int64_t>(id[k]) * f_v + c));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      d[k] = group_sum(d[k], lg);
    }
    if (p.gl == 0) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if (id[k] >= 0) raw[__ldg(eids + j0 + k)] = d[k];
      }
    }
  }
}

}  // namespace

// Common arguments of the three entries: the per-bucket arrays
// (GAB_TABLE_PARAMS of csrc/ell_table.cuh), is_split (nv,) uint8 where rows
// are combined; per-edge arrays are (ne,) f32, per-vertex ones (nv,) f32;
// every pointer on CUDA device `device`, stream a cudaStream_t of that
// device. The library links its own CUDA runtime, so each entry selects
// `device` before launching. Each returns the first CUDA error (0 on success),
// allocates nothing and does not synchronise.

// kind 0: out_i = max_e vals_e (out holds -inf in split and edgeless rows);
// kind 1: out_i = sum_e vals_e; kind 2: out_i = sum_e exp(vals_e - m_i) (out
// holds zeros in split and edgeless rows). m is read for kind 2 only.
extern "C" int gab_ell_row_reduce(GAB_TABLE_PARAMS, const void* is_split,
                                  const void* vals, const void* m, void* out,
                                  int kind, int device, void* stream) {
  if (kind < kMax || kind > kSumExp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table tab;
  cudaError_t err;
  const int64_t blocks = fill_table(&tab, GAB_TABLE_ARGS, kReduceLg, 1, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float* v = static_cast<const float*>(vals);
  const float* mf = static_cast<const float*>(m);
  float* o = static_cast<float*>(out);
  if (kind == kMax) {
    ell_row_reduce_kernel<kMax><<<grid, dim3(kThreads), 0, s>>>(tab, split, v,
                                                               mf, o);
  } else if (kind == kSum) {
    ell_row_reduce_kernel<kSum><<<grid, dim3(kThreads), 0, s>>>(tab, split, v,
                                                               mf, o);
  } else {
    ell_row_reduce_kernel<kSumExp><<<grid, dim3(kThreads), 0, s>>>(
        tab, split, v, mf, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (nv, f) with zeros in split and edgeless rows; f, tile_v (1..32 columns
// of V per tile) and vec (1: V = float4, f % 4 == 0 and x, out aligned to 16
// bytes; 0: V = float) as in csrc/fused_gat.cu.
extern "C" int gab_gat_v1_fwd(GAB_TABLE_PARAMS, const void* is_split,
                              const void* logits, const void* edge_w,
                              const void* m, const void* zinv, const void* x,
                              void* out, int64_t f, int tile_v, int vec,
                              int device, void* stream) {
  WidePlan p;
  const cudaError_t err = plan_wide(&p, GAB_TABLE_ARGS, f, tile_v, vec, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float* lf = static_cast<const float*>(logits);
  const float* wf = static_cast<const float*>(edge_w);
  const float* mf = static_cast<const float*>(m);
  const float* zf = static_cast<const float*>(zinv);
  if (vec) {
    gat_v1_fwd_kernel<float4><<<p.grid, dim3(kThreads), 0, s>>>(
        p.tab, split, lf, wf, mf, zf, static_cast<const float4*>(x),
        static_cast<float4*>(out), p.f_v, tile_v, p.lg);
  } else {
    gat_v1_fwd_kernel<float><<<p.grid, dim3(kThreads), 0, s>>>(
        p.tab, split, lf, wf, mf, zf, static_cast<const float*>(x),
        static_cast<float*>(out), p.f_v, tile_v, p.lg);
  }
  return static_cast<int>(cudaGetLastError());
}

// a, b (nv, f) f32; raw (ne,) f32, every element of which is written (each
// edge has one slot). vec as above (a, b aligned to 16 bytes). The group is
// the smallest power of two of lanes that covers the columns of V, at most 32.
extern "C" int gab_sddmm_dot_ell(GAB_TABLE_PARAMS, const void* a,
                                 const void* b, void* raw, int64_t f, int vec,
                                 int device, void* stream) {
  if (f <= 0 || (vec && f % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t f_v = vec ? f / 4 : f;
  int lg = 0;
  while (lg < 5 && (1 << lg) < f_v) ++lg;
  Table tab;
  cudaError_t err;
  const int64_t blocks = fill_table(&tab, GAB_TABLE_ARGS, lg, 1, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(raw);
  if (vec) {
    sddmm_dot_ell_kernel<float4><<<grid, dim3(kThreads), 0, s>>>(
        tab, static_cast<const float4*>(a), static_cast<const float4*>(b), out,
        f_v, lg);
  } else {
    sddmm_dot_ell_kernel<float><<<grid, dim3(kThreads), 0, s>>>(
        tab, static_cast<const float*>(a), static_cast<const float*>(b), out,
        f_v, lg);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
