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
// (nv, F) matrix by index, like the SpMM (K1): each pair (i, j) is one dot
// product or one scaled row add, with no reuse across pairs, at 0.5 flop per
// gathered byte. That is why neither gets tensor cores: there is no tile of
// operands to multiply, and the float32 rate outside them is already 2-3
// times what the bytes allow. What the card offers such a pass is the rate of
// its L2 (at F = 128 the gathered matrix is 64 MB on the main path's graph,
// a little more than L2 holds), coalesced 16-byte accesses, and shuffles; so
// the design is about how few instructions and how few memory transactions
// ride on each gathered row.
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
//     float) of the current feature tile. The per-slot scalar work is done
//     once per slot and tile, not once per lane: the group's lanes each
//     prepare one slot (several, in a group narrower than the chunk) - its
//     neighbour id and edge id, read coalesced across the group, then the
//     edge's weight and logit and one expf - and the id and the coefficient
//     reach the other lanes by one shuffle each. A zero weight gives an exact
//     0 whatever the exp is. The rows of x of a whole chunk (8 slots; 16 in
//     groups of up to four lanes) are gathered before any is used. All lanes
//     of a warp shuffle, so the loop runs to the longest row of the warp,
//     with id -1 (no gather) and coefficient 0 past a row's end. Where the
//     caller wants them, the lanes that prepared the slots also store the
//     scores exp(l_e - m_i) zinv_i (first tile only), after the round's
//     gathers have been started: the backward reads them and computes no
//     softmax again. Feature tiles and the store-or-add rule as in
//     gat_v2_fwd; the wrapper has a tile rule of its own.
//   * sddmm_dot_ell: a group of at most 16 lanes owns a virtual row and keeps
//     its row of `a` in registers, lane gl the columns gl, gl + G, ... of V
//     (two float4 a lane at F = 128: a load of the group still covers 256
//     contiguous bytes, and half as many shuffles ride on a gathered float4
//     as with 32 lanes; more columns than that are read again per chunk). A
//     chunk of 8 slots is gathered together; then the lanes' 8 partial dot
//     products are added over the group by a transposing butterfly: at each
//     step a lane keeps half of its values and hands the other half to the
//     lane across one bit, so 8 slots cost 4 + 2 + 1 + 1 = 8 shuffles in a
//     group of 16, not 8 x 4, and end up in 8 different lanes, which store
//     them together (a row's edge ids are consecutive: one 32-byte store).
//     Each edge sits in exactly one slot, so every element is written once,
//     by a plain store. The loop runs to the longest row of the warp, not to
//     the bucket's width.
//
// Tried on an H100 and not kept (tools/gat_kernels_probe.py, rmat17,
// device ms): sddmm_dot_ell with 32 lanes and one column a lane (0.314 at
// F = 128 against 0.286), with 8 lanes and four columns (0.309-0.311), with
// chunks of 4 or 16 slots (F = 128 / 16: 0.283 / 0.063 and 0.382 / 0.059
// against 0.286 / 0.056), fewer than four lanes at F = 16 (0.087 with two,
// 0.198 with one: 16-byte accesses scattered over 32 rows); gat_v1_fwd with
// chunks of 4 or 16 in wide groups (0.306-0.323 against 0.289 at F = 128)
// and of 8 in narrow ones (0.069 against 0.072 at F = 16, but 0.103 against
// 0.087 with the scores). Asynchronous copies into shared memory were not
// tried: with 32-80 registers a thread the gathers in flight from registers
// already cover the L2's latency, and both passes run at the time of K1's
// gather.
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

// Tuning constants that can be set at build time (-D...), which
// tools/gat_kernels_probe.py uses to time the alternatives.
#ifndef GAB_V1_CHUNK_LG
#define GAB_V1_CHUNK_LG 3
#endif
#ifndef GAB_V1_NARROW_CHUNK_LG
#define GAB_V1_NARROW_CHUNK_LG 4
#endif
#ifndef GAB_DOT_CHUNK_LG
#define GAB_DOT_CHUNK_LG 3
#endif
#ifndef GAB_DOT_COLS
#define GAB_DOT_COLS 2
#endif
#ifndef GAB_DOT_LANES_LG
#define GAB_DOT_LANES_LG 4
#endif

// gat_v1_fwd: log2 of the slots gathered together by a group of more than
// four lanes, and of up to four (F = 16: a row of x is 64 bytes), which
// spends more of a round on preparing its slots than on gathering and takes
// longer rounds.
constexpr int kV1ChunkLg = GAB_V1_CHUNK_LG;
constexpr int kV1NarrowChunkLg = GAB_V1_NARROW_CHUNK_LG;
// sddmm_dot_ell: log2 of the slots gathered together, the columns of `a` that
// a lane of the widest group keeps in registers, and log2 of the most lanes a
// row gets.
constexpr int kDotChunkLg = GAB_DOT_CHUNK_LG;
constexpr int kDotChunk = 1 << kDotChunkLg;
constexpr int kDotCols = GAB_DOT_COLS;
constexpr int kDotLanesLg = GAB_DOT_LANES_LG;
constexpr int kReduceLg = 3;  // log2 lanes per row, ell_row_reduce
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kV1ChunkLg >= 0 && kV1ChunkLg <= 5 && kV1NarrowChunkLg >= 0 &&
                  kV1NarrowChunkLg <= 5 && kDotChunkLg >= 0 && kDotChunkLg <= 5,
              "a chunk is at most 32 slots");
static_assert(kDotCols >= 1 && kDotLanesLg >= 0 && kDotLanesLg <= 5,
              "a group is at most one warp");

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

// A group of G = 2^LG lanes owns a virtual row and works through it in rounds
// of max(G, kChunk) slots. In a round every lane prepares the slots
// j0 + q G + gl (q < kPrep): their neighbours' ids (-1 past the row's end)
// and, from the edge's weight and logit, the coefficient of the neighbour's
// row, one expf per slot and tile. Then the round's slots are taken kChunk at
// a time: ids and coefficients reach all lanes by one shuffle each, the
// chunk's rows of x are gathered together, then used. The slot t of a round
// was prepared by lane t mod G in its register t / G. The scores, where they
// are wanted, are stored after the round's gathers have been started.
template <typename V, int LG>
__global__ void __launch_bounds__(kThreads)
gat_v1_fwd_kernel(const __grid_constant__ Table tab,
                  const uint8_t* __restrict__ is_split,
                  const float* __restrict__ logits,
                  const float* __restrict__ edge_w,
                  const float* __restrict__ m, const float* __restrict__ zinv,
                  const V* __restrict__ x, V* __restrict__ out,
                  float* __restrict__ scores, int64_t f_v, int tile_v) {
  constexpr int G = 1 << LG;
  constexpr int kChunk = 1 << (LG <= 2 ? kV1NarrowChunkLg : kV1ChunkLg);
  constexpr int kPrep = G >= kChunk ? 1 : kChunk / G;
  constexpr int kRound = G * kPrep;
  const Pos p = locate(tab, LG);
  const int64_t col = p.tile * tile_v + p.gl;
  // a lane without a column still prepares slots and takes part in shuffles
  const bool active = p.live && p.gl < tile_v && col < f_v;
  const Bucket& b = tab.b[p.bucket];
  int32_t row = 0;
  int cnt = 0;
  const int32_t* ids = nullptr;
  const int32_t* eids = nullptr;
  float mi = 0.0f;
  float zi = 0.0f;
  if (p.live) {
    row = __ldg(b.row_ids + p.r);
    cnt = __ldg(b.valid + p.r);
    ids = b.nbr + p.r * b.width;
    eids = b.edge_id + p.r * b.width;
    mi = __ldg(m + row);
    zi = __ldg(zinv + row);
  }
  // the rows of a warp differ in length: all lanes loop to the longest
  const int top = __reduce_max_sync(kFullMask, cnt);
  const bool keep = scores != nullptr && p.tile == 0;
  V acc = zero<V>();
  for (int j0 = 0; j0 < top; j0 += kRound) {
    int32_t my_id[kPrep];
    int32_t my_e[kPrep];
    float my_s[kPrep];  // the score, exp(l_e - m_i) zinv_i
    float my_c[kPrep];  // the coefficient, the score times the weight
#pragma unroll
    for (int q = 0; q < kPrep; ++q) {
      const int j = j0 + q * G + p.gl;
      my_id[q] = j < cnt ? __ldg(ids + j) : -1;
      my_e[q] = j < cnt ? __ldg(eids + j) : -1;
    }
#pragma unroll
    for (int q = 0; q < kPrep; ++q) {
      my_c[q] = my_e[q] >= 0 ? __ldg(edge_w + my_e[q]) : 0.0f;
      my_s[q] = my_e[q] >= 0 ? __ldg(logits + my_e[q]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kPrep; ++q) {
      my_s[q] = my_e[q] >= 0 ? expf(my_s[q] - mi) * zi : 0.0f;
      // a masked edge adds an exact zero, not 0 * exp(...)
      my_c[q] = my_c[q] != 0.0f ? my_s[q] * my_c[q] : 0.0f;
    }
#pragma unroll 1
    for (int c0 = 0; c0 < kRound && j0 + c0 < top; c0 += kChunk) {
      int32_t id[kChunk];
      V v[kChunk];
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        if constexpr (kPrep == 1) {
          id[k] = __shfl_sync(kFullMask, my_id[0], c0 + k, G);
        } else {
          id[k] = __shfl_sync(kFullMask, my_id[k >> LG], k & (G - 1), G);
        }
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        v[k] = active && id[k] >= 0
                   ? __ldg(x + static_cast<int64_t>(id[k]) * f_v + col)
                   : zero<V>();
      }
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        float c;
        if constexpr (kPrep == 1) {
          c = __shfl_sync(kFullMask, my_c[0], c0 + k, G);
        } else {
          c = __shfl_sync(kFullMask, my_c[k >> LG], k & (G - 1), G);
        }
        axpy(acc, c, v[k]);
      }
    }
    if (keep) {
#pragma unroll
      for (int q = 0; q < kPrep; ++q) {
        if (my_e[q] >= 0) scores[my_e[q]] = my_s[q];
      }
    }
  }
  if (active) {
    put(out + static_cast<int64_t>(row) * f_v + col, acc,
        __ldg(is_split + row) != 0);
  }
}

__device__ __forceinline__ float dot_acc(float acc, float a, float b) {
  return fmaf(a, b, acc);
}
__device__ __forceinline__ float dot_acc(float acc, const float4& a,
                                         const float4& b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// Adds, over the 2^LG lanes of a group, the kDotChunk partial sums that each
// lane holds, one per slot, and leaves every slot's total in one lane: a
// transposing butterfly. At step s a lane keeps the even or the odd half of
// its values, by bit s of its lane number, and hands the other half to the
// lane across that bit, so the values halve while the lanes summed double.
// After T = min(LG, log2 kDotChunk) steps d[i] is the group's total for slot
// i 2^T + (gl mod 2^T), for i < kDotChunk / 2^T. With more lanes than slots
// the remaining bits are summed in place and every lane holds slot
// gl mod kDotChunk. Every lane of the warp takes part.
template <int LG>
__device__ __forceinline__ void transpose_sum(float (&d)[kDotChunk], int gl) {
  constexpr int T = LG < kDotChunkLg ? LG : kDotChunkLg;
#pragma unroll
  for (int s = 0; s < T; ++s) {
    const bool odd = ((gl >> s) & 1) != 0;
#pragma unroll
    for (int i = 0; i < (kDotChunk >> (s + 1)); ++i) {
      const float mine = odd ? d[2 * i + 1] : d[2 * i];
      const float theirs = odd ? d[2 * i] : d[2 * i + 1];
      d[i] = mine + __shfl_xor_sync(kFullMask, theirs, 1 << s);
    }
  }
#pragma unroll
  for (int s = T; s < LG; ++s) {
    d[0] += __shfl_xor_sync(kFullMask, d[0], 1 << s);
  }
}

// A group of G = 2^LG lanes owns a virtual row; lane gl owns the columns
// gl + q G of V and keeps the first COLS of its row of `a` in registers
// (further columns, of a wide F, are read again per chunk).
template <typename V, int LG, int COLS = 1>
__global__ void __launch_bounds__(kThreads)
sddmm_dot_ell_kernel(const __grid_constant__ Table tab,
                     const V* __restrict__ a, const V* __restrict__ b,
                     float* __restrict__ raw, int64_t f_v) {
  constexpr int G = 1 << LG;
  constexpr int T = LG < kDotChunkLg ? LG : kDotChunkLg;
  constexpr int kOwn = kDotChunk >> T;  // slots whose totals a lane stores
  const Pos p = locate(tab, LG);
  const Bucket& bk = tab.b[p.bucket];
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
  // the rows of a warp differ in length: all lanes loop to the longest
  const int top = __reduce_max_sync(kFullMask, cnt);
  V a0[COLS];
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    const int64_t c = p.gl + q * G;
    a0[q] = cnt > 0 && c < f_v ? __ldg(arow + c) : zero<V>();
  }
  // with more lanes than slots only the first kDotChunk lanes store
  const bool owner = LG <= kDotChunkLg || p.gl < kDotChunk;
  const int first = p.gl & ((1 << T) - 1);
  for (int j0 = 0; j0 < top; j0 += kDotChunk) {
    int32_t id[kDotChunk];
    int32_t e[kOwn];
    float d[kDotChunk];
#pragma unroll
    for (int k = 0; k < kDotChunk; ++k) {
      id[k] = j0 + k < cnt ? __ldg(ids + j0 + k) : -1;
      d[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int j = j0 + (i << T) + first;
      e[i] = owner && j < cnt ? __ldg(eids + j) : -1;
    }
#pragma unroll
    for (int q = 0; q < COLS; ++q) {
      const int64_t c = p.gl + q * G;
      V v[kDotChunk];
#pragma unroll
      for (int k = 0; k < kDotChunk; ++k) {
        v[k] = id[k] >= 0 && c < f_v
                   ? __ldg(b + static_cast<int64_t>(id[k]) * f_v + c)
                   : zero<V>();
      }
#pragma unroll
      for (int k = 0; k < kDotChunk; ++k) {
        d[k] = dot_acc(d[k], a0[q], v[k]);
      }
    }
    for (int64_t c = p.gl + COLS * G; c < f_v; c += G) {
      const V av = cnt > 0 ? __ldg(arow + c) : zero<V>();
      V v[kDotChunk];
#pragma unroll
      for (int k = 0; k < kDotChunk; ++k) {
        v[k] = id[k] >= 0 ? __ldg(b + static_cast<int64_t>(id[k]) * f_v + c)
                          : zero<V>();
      }
#pragma unroll
      for (int k = 0; k < kDotChunk; ++k) {
        d[k] = dot_acc(d[k], av, v[k]);
      }
    }
    transpose_sum<LG>(d, p.gl);
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      if (e[i] >= 0) raw[e[i]] = d[i];
    }
  }
}

// Launches `kernel<V, LG>` for the run-time `lg` (0..5).
#define GAB_FOR_LG(lg, V, kernel, grid, stream, ...)                        \
  switch (lg) {                                                             \
    case 0: kernel<V, 0><<<grid, dim3(kThreads), 0, stream>>>(__VA_ARGS__); \
      break;                                                                \
    case 1: kernel<V, 1><<<grid, dim3(kThreads), 0, stream>>>(__VA_ARGS__); \
      break;                                                                \
    case 2: kernel<V, 2><<<grid, dim3(kThreads), 0, stream>>>(__VA_ARGS__); \
      break;                                                                \
    case 3: kernel<V, 3><<<grid, dim3(kThreads), 0, stream>>>(__VA_ARGS__); \
      break;                                                                \
    case 4: kernel<V, 4><<<grid, dim3(kThreads), 0, stream>>>(__VA_ARGS__); \
      break;                                                                \
    default: kernel<V, 5><<<grid, dim3(kThreads), 0, stream>>>(__VA_ARGS__);\
      break;                                                                \
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
// bytes; 0: V = float) as in csrc/fused_gat.cu. scores is null or (ne,), and
// then every element of it is written: exp(logits_e - m_i) zinv_i, the
// softmax of the logits over each row, weights apart.
extern "C" int gab_gat_v1_fwd(GAB_TABLE_PARAMS, const void* is_split,
                              const void* logits, const void* edge_w,
                              const void* m, const void* zinv, const void* x,
                              void* out, void* scores, int64_t f, int tile_v,
                              int vec, int device, void* stream) {
  WidePlan p;
  const cudaError_t err = plan_wide(&p, GAB_TABLE_ARGS, f, tile_v, vec, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float* lf = static_cast<const float*>(logits);
  const float* wf = static_cast<const float*>(edge_w);
  const float* mf = static_cast<const float*>(m);
  const float* zf = static_cast<const float*>(zinv);
  float* sc = static_cast<float*>(scores);
  if (vec) {
    GAB_FOR_LG(p.lg, float4, gat_v1_fwd_kernel, p.grid, s, p.tab, split, lf,
               wf, mf, zf, static_cast<const float4*>(x),
               static_cast<float4*>(out), sc, p.f_v, tile_v)
  } else {
    GAB_FOR_LG(p.lg, float, gat_v1_fwd_kernel, p.grid, s, p.tab, split, lf, wf,
               mf, zf, static_cast<const float*>(x), static_cast<float*>(out),
               sc, p.f_v, tile_v)
  }
  return static_cast<int>(cudaGetLastError());
}

// a, b (nv, f) f32; raw (ne,) f32, every element of which is written (each
// edge has one slot). vec as above (a, b aligned to 16 bytes). The group is
// the smallest power of two of lanes that covers the columns of V, at most
// 2^kDotLanesLg: a wider F takes several columns a lane.
extern "C" int gab_sddmm_dot_ell(GAB_TABLE_PARAMS, const void* a,
                                 const void* b, void* raw, int64_t f, int vec,
                                 int device, void* stream) {
  if (f <= 0 || (vec && f % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t f_v = vec ? f / 4 : f;
  int lg = 0;
  while (lg < kDotLanesLg && (1 << lg) < f_v) ++lg;
  const bool wide = f_v > (1 << lg);
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
    const float4* a4 = static_cast<const float4*>(a);
    const float4* b4 = static_cast<const float4*>(b);
    if (wide) {
      sddmm_dot_ell_kernel<float4, kDotLanesLg, kDotCols>
          <<<grid, dim3(kThreads), 0, s>>>(tab, a4, b4, out, f_v);
    } else {
      GAB_FOR_LG(lg, float4, sddmm_dot_ell_kernel, grid, s, tab, a4, b4, out,
                 f_v)
    }
  } else {
    const float* af = static_cast<const float*>(a);
    const float* bf = static_cast<const float*>(b);
    if (wide) {
      sddmm_dot_ell_kernel<float, kDotLanesLg, kDotCols>
          <<<grid, dim3(kThreads), 0, s>>>(tab, af, bf, out, f_v);
    } else {
      GAB_FOR_LG(lg, float, sddmm_dot_ell_kernel, grid, s, tab, af, bf, out,
                 f_v)
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
