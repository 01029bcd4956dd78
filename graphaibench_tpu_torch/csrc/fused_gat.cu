// The bucket passes of the fused GAT attention (v2), for Hopper (built for
// sm_90a by graphaibench_tpu_torch/ops/_build.py and bound with ctypes; the
// wrappers and the plain PyTorch versions are in
// graphaibench_tpu_torch/ops/fused_gat.py).
//
// They replace the bucket sweeps of graphaibench_tpu/ops/fused_gat.py, which
// the JAX package writes as XLA programs over one bucket chunk at a time:
//
//   gat_rowmax     _sr_rowmax        m0_i  = max_j sr_j
//   gat_v2_fwd     _v2_fwd_pass      e_ij  = exp(leaky(sl_i + sr_j) - m_i)
//                                    acc_i = sum_j e_ij h_j,  z_i = sum_j e_ij
//   gat_v2_bwd_sl  _v2_bwd, pass B1  p = e_ij zinv_i,  pl = p leaky'
//                                    d_sl_i = sum_j pl (<ct_i, h_j> - inner_i)
//   gat_v2_bwd_h   _v2_bwd, pass B2  transpose role, same buckets (the graph is
//                                    structurally symmetric): for row j over
//                                    its neighbours i,
//                                    p = exp(leaky(sl_i + sr_j) - m_i) zinv_i
//                                    d_h_j  = sum_i p ct_i
//                                    t_ij   = pl (<h_j, ct_i> - inner_i)
//                                    d_sr_j = sum_i t_ij
//   gat_v2_bwd     both of them      gat_v2_bwd_h, which also adds every t_ij
//                                    into d_sl_i: the whole backward with one
//                                    gather where the JAX package does two
//
// j (or i) runs over the real slots of a virtual row. A pad slot carries
// neighbour 0 and cannot be neutralised by a zero weight (exp of a pad is not
// 0), so every pass respects valid[r]: the pads sit at the tail of their row.
// leaky is LeakyReLU with slope 0.2.
//
// What bounds them on this card: bytes. Each of the wide passes is a gather
// of rows of an (nv, F) matrix by index, like the SpMM (K1), with an exp and a
// few multiply-adds per gathered float4 on top; gat_rowmax gathers one float
// per slot. At F = 128 the gather moves 13 times the compulsory bytes out of
// L2, and that sets the time: no pass that gathers is faster than K1. So the
// backward's first gain is to gather once, not twice.
//
// What the design does about it (the same family as csrc/ell_spmm.cu):
//   * One launch per pass for all buckets: a table of per-bucket pointers,
//     row counts and widths travels by value, a block finds its bucket from a
//     prefix of block counts, the widest bucket first (csrc/ell_table.cuh,
//     shared with csrc/ell_edge.cu).
//   * A group of 2^lg lanes owns one virtual row; a lane owns columns of V
//     (float4 when F % 4 == 0 and the tensors are aligned, else float) of the
//     current feature tile. The tile index is the slowest part of the block
//     index, so one tile's slice of the gathered matrix is read by all rows
//     before the next tile's. More than 32 columns of V (F > 128) always take
//     several tiles.
//   * Store where a row has one virtual row, combine where it is split
//     (degree > 64): atomicAdd for sums, an ordered-integer atomicMax/Min for
//     the row max. The wrappers hand in outputs whose split and edgeless rows
//     are initialised (0, or -inf for the max) and nothing else. With more
//     than one feature tile the per-row scalars d_sl and d_sr are summed over
//     tiles too, so then all of their rows are added to a zeroed output.
//   * gat_rowmax: four lanes a row, each reading two int4 of ids a step and
//     keeping their eight sr gathers in flight; the ids are read up to the
//     bucket's width without waiting for the row's count. Its gathers of
//     one float per slot are bound by the rate at which L1 serves scattered
//     lines, not by bytes.
//   * Every wide pass does a slot's scalar work once, not once per lane:
//     the group's lanes each prepare one slot of a round - its neighbour id,
//     read coalesced, the neighbour's scalars (sr_j, or the 16-byte packed
//     sl_i, m_i, zinv_i, inner_i) and one expf - and id and coefficient reach
//     the other lanes by one shuffle each; id -1 past a row's end stops the
//     gather. All lanes of a warp shuffle, so the loop runs to the longest
//     row of the warp. Eight slots' rows are gathered before any is used (in
//     the backward four in groups of up to four lanes, whose buckets are
//     mostly narrow).
//   * gat_v2_fwd: one column a lane; the ids and sr_j of a round are loaded
//     a round ahead, the first beside the row's count; z is summed by the
//     lanes that prepared the slots; groups of more than four lanes are held
//     to 40 registers (6 blocks per SM); tiles of 64 floats at every size.
//     At F = 128 it moves the gathered rows out of L2 at 7.5 TB/s, K1's rate
//     within 7%.
//   * The backward passes: one tile of up to 128 floats at every size.
//   * gat_v2_bwd_sl: 32 lanes a row, one column a lane; a lane sums
//     pl <its columns> over the slots and the group adds its lanes once per
//     row; the term with inner is subtracted once.
//   * gat_v2_bwd_h: at most 16 lanes a row with two float4 columns a lane at
//     F = 128 (h_j and the sum for d_h_j in registers). The dot products are
//     completed per slot: the lanes' partial sums of a chunk are added by the
//     transposing butterfly of csrc/ell_table.cuh (8 shuffles for 8 slots in a
//     group of 16), which leaves the total of a slot in the very lane that
//     prepared it and so holds its pl, inner_i and neighbour id. That lane
//     forms t_ij, sums it for d_sr_j, and, for gat_v2_bwd, adds it into
//     d_sl_i with one atomicAdd per slot. The atomics hide behind the gather
//     where the gather is long (the wrapper's rule); they make d_sl's
//     summation order change from run to run, as that of split rows does.
//   * A row's own vector (ct_i, h_j) is read and d_h written with the
//     streaming hint: they pass through L2 once, the gathered rows are read
//     some 30 times.
//
// Tried on an H100 and not kept, the forward (tools/gat_kernels_probe.py,
// device ms at F = 128 at 2^17 / 2^19 vertices unless said; shipped:
// gat_v2_fwd 0.271 / 1.304, 0.053 / 0.266 at F = 16; gat_rowmax 0.018 /
// 0.097-0.102):
//   * The ids read and sr gathered after the row's count, sr for pads too,
//     registers left to the compiler (72-80): 0.315-0.323 at 2^17.
//   * Wide groups held to 64 registers: 0.286 / 1.358; to 48: 0.277 /
//     1.333; to 36: 0.277 / 1.373.
//   * Chunks of 4 slots in wide groups: 0.276 / 1.350; in groups of four
//     lanes (F = 16) 4 and 16 slots: 0.053 / 0.267 and 0.055 / 0.276.
//   * One tile of 128 floats: 0.271 / 1.386, and 0.0595 against 0.0581 at
//     2^15, 0.1260 against 0.1271 at 2^16; it wins only at 2^13 (0.0144
//     against 0.0150). Tiles of 32: 0.287 / 1.358.
//   * 16 lanes a row with two float4 columns (tile 128, 40 registers, so
//     spilling): 0.506 / 2.622.
//   * gat_rowmax with eight lanes a row and one int4 a step: 0.019 / 0.096-
//     0.101; sixteen lanes 0.024 / 0.114-0.117; four lanes with one int4
//     0.018 / 0.099-0.100. At 2^19 they all tie. One id a lane a step (no
//     int4) with four lanes: 0.0217 / 0.1046 against 0.0196 / 0.0979 in the
//     same call.
//
// And the backward (rmat17, device ms at F = 128 / 16 unless said; shipped:
// gat_v2_bwd_sl 0.281 / 0.054, gat_v2_bwd_h 0.338 / 0.065, gat_v2_bwd 0.348
// / 0.140):
//   * d_sl from a per-edge array: the pass stores t at the slot's edge id
//     and d_sl = row sum of t[transpose permutation] (0.391 + 0.10 for the
//     (E,) gather and the row sum = 0.49 / 0.20), or stores t through the
//     permutation (0.46 + 0.04 = 0.50 / 0.20); the atomics cost 0.01 / 0.08.
//   * gat_v2_bwd_h with per-lane partial dots and pl by a shuffle, no
//     butterfly: 0.367 / 0.069 against 0.374 / 0.081 in the same build (a
//     tie at F = 128, and no t to give away).
//   * gat_v2_bwd_h with 32 lanes and one column 0.453-0.457, with 8 lanes and
//     four columns 0.412-0.421 (201 registers), against 0.372-0.390 with 16
//     and two; gat_v2_bwd_sl with 16 lanes and two columns 0.294 against
//     0.283 with 32 and one, with 8 and four 0.38.
//   * Chunks of 4 slots in wide groups: 0.315-0.319 (bwd_sl) and 0.381-0.431
//     (bwd_h) against 0.293 and 0.374-0.390; of 16: 0.329 and 0.835 (184
//     registers). In groups of four lanes, 16 and 8 slots a round cost
//     gat_v2_bwd_h 0.077-0.081 and 0.071-0.073 at F = 16 against 0.065 with 4.
//   * gat_v2_bwd_h without a register limit (127 registers, no spill) 0.390,
//     held to 2 blocks 0.376, to 4 (64 registers, 24 bytes spilt) 0.369,
//     against 0.341-0.343 held to 3 (80 registers, 24 bytes spilt).
//   * Two tiles of 64 floats: gat_v2_bwd_h 0.376-0.48 and gat_v2_bwd 0.41-0.49
//     against 0.341 and 0.352; at 2^19 vertices 1.81 and 1.97 against 1.78 and
//     1.89 ms (gat_v2_bwd_sl 1.38 against 1.41: a tie).
//   * Plain loads and stores for the row's own vector and d_h: 1-2% slower
//     at both sizes.
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

// Tuning constants that can be set at build time (-D...), which
// tools/gat_kernels_probe.py uses to time the alternatives.
#ifndef GAB_GAT_ROWMAX_LG
#define GAB_GAT_ROWMAX_LG 2
#endif
#ifndef GAB_FWD_CHUNK_LG
#define GAB_FWD_CHUNK_LG 3
#endif
#ifndef GAB_FWD_MIN_BLOCKS
#define GAB_FWD_MIN_BLOCKS 6
#endif

#ifndef GAB_BWD_CHUNK_LG
#define GAB_BWD_CHUNK_LG 3
#endif
#ifndef GAB_BWD_NARROW_CHUNK_LG
#define GAB_BWD_NARROW_CHUNK_LG 2
#endif
#ifndef GAB_BWD_LANES_LG
#define GAB_BWD_LANES_LG 4
#endif
#ifndef GAB_BWD_SL_LANES_LG
#define GAB_BWD_SL_LANES_LG 5
#endif

#ifndef GAB_BWD_MIN_BLOCKS
#define GAB_BWD_MIN_BLOCKS 3
#endif

constexpr int kRowmaxLg = GAB_GAT_ROWMAX_LG;   // log2 lanes per row, gat_rowmax
constexpr int kRowmaxQuads = 2;  // int4 of ids a lane reads a step (1 ties)
// gat_v2_fwd: log2 of the slots gathered together by a group of more than
// four lanes (groups of up to four gather 8 as well), and the blocks per SM
// the compiler must leave registers for.
constexpr int kFwdChunkLg = GAB_FWD_CHUNK_LG;
constexpr int kFwdMinBlocks = GAB_FWD_MIN_BLOCKS;
static_assert(kRowmaxLg >= 2 && kRowmaxLg <= 5, "4 to 32 lanes a row");
static_assert(kFwdChunkLg >= 0 && kFwdChunkLg <= 5,
              "a chunk is at most 32 slots");
// The backward passes: log2 of the slots gathered together by a group of more
// than four lanes, and of up to four (F = 16: a row is 64 bytes), and log2 of
// the most lanes a row gets in each pass: a tile of 32 columns of V then
// gives a lane 32 / lanes of them.
constexpr int kBwdChunkLg = GAB_BWD_CHUNK_LG;
constexpr int kBwdNarrowChunkLg = GAB_BWD_NARROW_CHUNK_LG;
constexpr int kBwdLanesLg = GAB_BWD_LANES_LG;        // gat_v2_bwd_h
constexpr int kBwdSlLanesLg = GAB_BWD_SL_LANES_LG;   // gat_v2_bwd_sl
// gat_v2_bwd_h: blocks per SM the compiler must leave room for. Three hold it
// to 80 registers, which costs the widest group 24 bytes of spilt loop
// invariants and is still the fastest build (see the note above).
constexpr int kBwdMinBlocks = GAB_BWD_MIN_BLOCKS;
static_assert(kBwdChunkLg >= 0 && kBwdChunkLg <= 5 && kBwdNarrowChunkLg >= 2 &&
                  kBwdNarrowChunkLg <= 5,
              "a chunk is at most 32 slots, and a narrow group's at least 4");
static_assert(kBwdLanesLg >= 0 && kBwdLanesLg <= 5 && kBwdSlLanesLg >= 0 &&
                  kBwdSlLanesLg <= 5,
              "a group is at most one warp");
constexpr float kSlope = 0.2f;

__device__ __forceinline__ float leaky(float raw) {
  return raw > 0.0f ? raw : kSlope * raw;
}

__device__ __forceinline__ float leaky_grad(float raw) {
  return raw > 0.0f ? 1.0f : kSlope;
}

// The wide passes share one shape. A group of G = 2^LG lanes owns a virtual
// row and works through it in rounds of max(G, kChunk) slots; lane gl owns
// the columns gl + q G (q < COLS) of V of the current feature tile. In a
// round every lane prepares the slots j0 + q G + gl (q < kPrep): the
// neighbour's id (-1 past the row's end), its scalars and one expf per slot
// and tile. Then the round's slots are taken kChunk at a time: ids and
// coefficients reach all lanes by one shuffle each, and a chunk's rows are
// gathered together, column by column, before any is used. The slot t of a
// round was prepared by lane t mod G in its register t / G. A row's own
// vector is read and its result written with the streaming hint (evict
// first): they pass through L2 once, the gathered rows are read by many rows.
template <int LG, int CHUNK_LG, int NARROW_CHUNK_LG>
struct Rounds {
  static constexpr int G = 1 << LG;
  static constexpr int kChunkLg = LG <= 2 ? NARROW_CHUNK_LG : CHUNK_LG;
  static constexpr int kChunk = 1 << kChunkLg;
  static constexpr int kPrep = G >= kChunk ? 1 : kChunk / G;
  static constexpr int kRound = G * kPrep;
};
template <int LG>
using FwdShape = Rounds<LG, kFwdChunkLg, 3>;
template <int LG>
using BwdShape = Rounds<LG, kBwdChunkLg, kBwdNarrowChunkLg>;

// Slot c0 + k of a round, as prepared: register k / G of lane (c0 + k) mod G.
template <int LG, int PREP, typename T>
__device__ __forceinline__ T from_slot(const T (&mine)[PREP], int c0, int k) {
  if constexpr (PREP == 1) {
    return __shfl_sync(kFullMask, mine[0], c0 + k, 1 << LG);
  } else {
    return __shfl_sync(kFullMask, mine[k >> LG], k & ((1 << LG) - 1), 1 << LG);
  }
}

// A group of 2^LG lanes a row. Every slot of a row up to its bucket's width
// holds a real or a pad neighbour (pad: vertex 0), so a lane loads ids up
// to the width without waiting for the row's count, which arrives beside
// them and decides which slots' sr are gathered; the row's id and split
// flag are loaded beside them too. A lane reads kRowmaxQuads int4 of ids a
// step and has their gathers in flight at once: every bucket's width is a
// multiple of 4 and its ids start 16-byte aligned (the wrapper checks; the
// port builds widths 4 to 64, a tensor each).
template <int LG>
__global__ void __launch_bounds__(kThreads)
gat_rowmax_kernel(const __grid_constant__ Table tab,
                  const uint8_t* __restrict__ is_split,
                  const float* __restrict__ sr, float* __restrict__ m0) {
  constexpr int kStep = 4 * kRowmaxQuads << LG;  // slots a group takes a step
  const Pos p = locate(tab, LG);
  const Bucket& b = tab.b[p.bucket];
  float v = -INFINITY;
  int32_t row = 0;
  bool split = false;
  if (p.live) {
    row = __ldg(b.row_ids + p.r);
    const int cnt = __ldg(b.valid + p.r);
    const int4* ids = reinterpret_cast<const int4*>(b.nbr + p.r * b.width);
    for (int j0 = 4 * p.gl; j0 < b.width; j0 += kStep) {
      int4 q[kRowmaxQuads];
      float s[kRowmaxQuads][4];
#pragma unroll
      for (int u = 0; u < kRowmaxQuads; ++u) {
        const int j = j0 + (4 << LG) * u;
        q[u] = j < b.width ? __ldg(ids + j / 4) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kRowmaxQuads; ++u) {
        const int j = j0 + (4 << LG) * u;
        s[u][0] = j < cnt ? __ldg(sr + q[u].x) : -INFINITY;
        s[u][1] = j + 1 < cnt ? __ldg(sr + q[u].y) : -INFINITY;
        s[u][2] = j + 2 < cnt ? __ldg(sr + q[u].z) : -INFINITY;
        s[u][3] = j + 3 < cnt ? __ldg(sr + q[u].w) : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kRowmaxQuads; ++u) {
        v = fmaxf(v, fmaxf(fmaxf(s[u][0], s[u][1]), fmaxf(s[u][2], s[u][3])));
      }
    }
    split = __ldg(is_split + row) != 0;
  }
  for (int o = (1 << LG) >> 1; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(kFullMask, v, o));
  }
  if (p.live && p.gl == 0) {
    if (split) {
      atomic_max_float(m0 + row, v);
    } else {
      m0[row] = v;
    }
  }
}

// acc_i = sum_j e_ij h_j and z_i = sum_j e_ij, e_ij = exp(leaky(sl_i + sr_j)
// - m_i): row i gathers h_j. A lane prepares its slots' e (their sr_j
// gathered, one expf each) and sums them; the group adds its lanes' sums
// once per row. A slot up to the bucket's width is readable whatever the
// row's count (pads hold vertex 0), so the ids of a round are loaded one
// round ahead - the first round's beside the row's count, the next round's
// while this round's rows are gathered - and so are the sr_j of its real
// slots. A tile has at most 32 columns of V, so a lane owns one of them.
// With several feature tiles only the first stores z. Groups of up to four
// lanes prepare several slots a lane and keep their registers; the wider
// ones are held to kFwdMinBlocks blocks per SM.
template <typename V, int LG>
__global__ void __launch_bounds__(kThreads, LG > 2 ? kFwdMinBlocks : 1)
gat_v2_fwd_kernel(const __grid_constant__ Table tab,
                  const uint8_t* __restrict__ is_split,
                  const float* __restrict__ sl, const float* __restrict__ sr,
                  const float* __restrict__ m, const V* __restrict__ h,
                  V* __restrict__ acc, float* __restrict__ z, int64_t f_v,
                  int tile_v) {
  using S = FwdShape<LG>;
  constexpr int G = S::G;
  const Pos p = locate(tab, LG);
  const Bucket& b = tab.b[p.bucket];
  const int width = p.live ? b.width : 0;
  const int32_t* ids = b.nbr + p.r * b.width;
  int32_t row = 0;
  int cnt = 0;
  if (p.live) {
    row = __ldg(b.row_ids + p.r);
    cnt = __ldg(b.valid + p.r);
  }
  int32_t next_id[S::kPrep];   // the next round's slots, loaded ahead
  float next_sr[S::kPrep];
  auto ahead = [&](int j0) {
#pragma unroll
    for (int q = 0; q < S::kPrep; ++q) {
      const int j = j0 + q * G + p.gl;
      next_id[q] = j < width ? __ldg(ids + j) : 0;
    }
#pragma unroll
    for (int q = 0; q < S::kPrep; ++q) {
      const int j = j0 + q * G + p.gl;
      next_sr[q] = j < cnt ? __ldg(sr + next_id[q]) : 0.0f;
    }
  };
  ahead(0);
  float sli = 0.0f, mi = 0.0f;
  bool add = false;
  if (p.live) {
    sli = __ldg(sl + row);
    mi = __ldg(m + row);
    add = __ldg(is_split + row) != 0;
  }
  // the rows of a warp differ in length: all lanes loop to the longest
  const int top = __reduce_max_sync(kFullMask, cnt);
  const int64_t col = p.tile * tile_v + p.gl;
  // a lane without a column still prepares slots and shuffles
  const bool on = p.live && p.gl < tile_v && col < f_v;
  V a = zero<V>();
  float zz = 0.0f;  // sum of e over the slots this lane prepared
  for (int j0 = 0; j0 < top; j0 += S::kRound) {
    int32_t my_id[S::kPrep];
    float my_e[S::kPrep];
#pragma unroll
    for (int q = 0; q < S::kPrep; ++q) {
      const bool real = j0 + q * G + p.gl < cnt;
      my_id[q] = real ? next_id[q] : -1;
      my_e[q] = real ? expf(leaky(sli + next_sr[q]) - mi) : 0.0f;
      zz += my_e[q];
    }
    if (j0 + S::kRound < top) ahead(j0 + S::kRound);
#pragma unroll 1
    for (int c0 = 0; c0 < S::kRound && j0 + c0 < top; c0 += S::kChunk) {
      int32_t id[S::kChunk];
      V v[S::kChunk];
#pragma unroll
      for (int k = 0; k < S::kChunk; ++k) {
        id[k] = from_slot<LG>(my_id, c0, k);
      }
#pragma unroll
      for (int k = 0; k < S::kChunk; ++k) {
        v[k] = on && id[k] >= 0
                   ? __ldg(h + static_cast<int64_t>(id[k]) * f_v + col)
                   : zero<V>();
      }
#pragma unroll
      for (int k = 0; k < S::kChunk; ++k) {
        axpy(a, from_slot<LG>(my_e, c0, k), v[k]);
      }
    }
  }
  if (on) {
    V* dst = acc + static_cast<int64_t>(row) * f_v + col;
    if (add) {
      atomicAdd(dst, a);
    } else {
      __stcs(dst, a);
    }
  }
  zz = group_sum(zz, LG);
  if (p.live && p.gl == 0 && p.tile == 0) put(z + row, zz, add);
}

// d_sl_i = sum_j pl_ij (<ct_i, h_j> - inner_i): row i keeps ct_i in registers
// and gathers h_j. A lane sums pl <its columns> over the slots, and pl over
// the slots it prepared; the group adds its lanes once per row.
template <typename V, int LG, int COLS>
__global__ void __launch_bounds__(kThreads)
gat_v2_bwd_sl_kernel(const __grid_constant__ Table tab,
                     const uint8_t* __restrict__ is_split,
                     const float* __restrict__ sl,
                     const float* __restrict__ sr, const float* __restrict__ m,
                     const float* __restrict__ zinv,
                     const float* __restrict__ inner,
                     const V* __restrict__ h, const V* __restrict__ ct,
                     float* __restrict__ d_sl, int64_t f_v, int tile_v) {
  using S = BwdShape<LG>;
  constexpr int G = S::G;
  const Pos p = locate(tab, LG);
  const Bucket& b = tab.b[p.bucket];
  int32_t row = 0;
  int cnt = 0;
  const int32_t* ids = nullptr;
  float sli = 0.0f, mi = 0.0f, zi = 0.0f;
  if (p.live) {
    row = __ldg(b.row_ids + p.r);
    cnt = __ldg(b.valid + p.r);
    ids = b.nbr + p.r * b.width;
    sli = __ldg(sl + row);
    mi = __ldg(m + row);
    zi = __ldg(zinv + row);
  }
  // the rows of a warp differ in length: all lanes loop to the longest
  const int top = __reduce_max_sync(kFullMask, cnt);
  int64_t col[COLS];
  bool on[COLS];  // a lane without a column still prepares slots and shuffles
  V c[COLS];
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    col[q] = p.tile * tile_v + p.gl + q * G;
    on[q] = p.live && p.gl + q * G < tile_v && col[q] < f_v;
    c[q] = on[q] ? __ldcs(ct + static_cast<int64_t>(row) * f_v + col[q])
                 : zero<V>();
  }
  float a = 0.0f;  // sum_j pl <ct_i, h_j> over this lane's columns
  float s = 0.0f;  // sum of pl over the slots this lane prepared
  for (int j0 = 0; j0 < top; j0 += S::kRound) {
    int32_t my_id[S::kPrep];
    float my_pl[S::kPrep];
#pragma unroll
    for (int q = 0; q < S::kPrep; ++q) {
      const int j = j0 + q * G + p.gl;
      my_id[q] = j < cnt ? __ldg(ids + j) : -1;
    }
#pragma unroll
    for (int q = 0; q < S::kPrep; ++q) {
      const float raw = sli + (my_id[q] >= 0 ? __ldg(sr + my_id[q]) : 0.0f);
      my_pl[q] = my_id[q] >= 0
                     ? expf(leaky(raw) - mi) * zi * leaky_grad(raw)
                     : 0.0f;
      s += my_pl[q];
    }
#pragma unroll 1
    for (int c0 = 0; c0 < S::kRound && j0 + c0 < top; c0 += S::kChunk) {
      int32_t id[S::kChunk];
      float pl[S::kChunk];
#pragma unroll
      for (int k = 0; k < S::kChunk; ++k) {
        id[k] = from_slot<LG>(my_id, c0, k);
      }
#pragma unroll
      for (int q = 0; q < COLS; ++q) {
        V v[S::kChunk];
#pragma unroll
        for (int k = 0; k < S::kChunk; ++k) {
          v[k] = on[q] && id[k] >= 0
                     ? __ldg(h + static_cast<int64_t>(id[k]) * f_v + col[q])
                     : zero<V>();
        }
#pragma unroll
        for (int k = 0; k < S::kChunk; ++k) {
          if (q == 0) pl[k] = from_slot<LG>(my_pl, c0, k);
          a = fmaf(pl[k], dot(c[q], v[k]), a);
        }
      }
    }
  }
  if (p.tile == 0) a -= (p.live ? __ldg(inner + row) : 0.0f) * s;
  a = group_sum(a, LG);
  if (p.live && p.gl == 0) {
    put(d_sl + row, a, __ldg(is_split + row) != 0 || tab.tiles > 1);
  }
}

// pack[i] = (sl_i, m_i, zinv_i, inner_i): what the pass needs of a neighbour
// besides its row of ct, in one 16-byte load per slot.
//
// Transpose role: row j keeps h_j in registers and gathers ct_i.
//   d_h_j  = sum_i p_ij ct_i
//   t_ij   = pl_ij (<h_j, ct_i> - inner_i),   d_sr_j = sum_i t_ij
// and, where the caller hands in d_sl, d_sl_i += t_ij as well. For that the
// dot products are completed per slot: the lanes' partial sums of a chunk are
// added by the transposing butterfly of csrc/ell_table.cuh, which leaves the
// total of slot c0 + k in the very lane that prepared it (and so holds its pl,
// inner_i and i). With several feature tiles t is the tile's part of it: only
// the first tile subtracts inner, and the sums add up over the tiles.
template <typename V, int LG, int COLS>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks)
gat_v2_bwd_h_kernel(const __grid_constant__ Table tab,
                    const uint8_t* __restrict__ is_split,
                    const float4* __restrict__ pack,
                    const float* __restrict__ sr, const V* __restrict__ h,
                    const V* __restrict__ ct, V* __restrict__ d_h,
                    float* __restrict__ d_sr, float* __restrict__ d_sl,
                    int64_t f_v, int tile_v) {
  using S = BwdShape<LG>;
  constexpr int G = S::G;
  const Pos p = locate(tab, LG);
  const Bucket& b = tab.b[p.bucket];
  int32_t row = 0;
  int cnt = 0;
  const int32_t* ids = nullptr;
  float srj = 0.0f;
  if (p.live) {
    row = __ldg(b.row_ids + p.r);
    cnt = __ldg(b.valid + p.r);
    ids = b.nbr + p.r * b.width;
    srj = __ldg(sr + row);
  }
  // the rows of a warp differ in length: all lanes loop to the longest
  const int top = __reduce_max_sync(kFullMask, cnt);
  int64_t col[COLS];
  bool on[COLS];  // a lane without a column still prepares slots and shuffles
  V hv[COLS];
  V acc[COLS];
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    col[q] = p.tile * tile_v + p.gl + q * G;
    on[q] = p.live && p.gl + q * G < tile_v && col[q] < f_v;
    hv[q] = on[q] ? __ldcs(h + static_cast<int64_t>(row) * f_v + col[q])
                  : zero<V>();
    acc[q] = zero<V>();
  }
  float a = 0.0f;  // sum of t over the slots this lane prepared
  for (int j0 = 0; j0 < top; j0 += S::kRound) {
    int32_t my_id[S::kPrep];
    float my_pp[S::kPrep];  // p_ij
    float my_pl[S::kPrep];  // p_ij leaky'
    float my_in[S::kPrep];  // inner_i, for the first tile
#pragma unroll
    for (int q = 0; q < S::kPrep; ++q) {
      const int j = j0 + q * G + p.gl;
      my_id[q] = j < cnt ? __ldg(ids + j) : -1;
    }
#pragma unroll
    for (int q = 0; q < S::kPrep; ++q) {
      const float4 k4 = my_id[q] >= 0 ? __ldg(pack + my_id[q]) : zero<float4>();
      const float raw = k4.x + srj;
      my_pp[q] = my_id[q] >= 0 ? expf(leaky(raw) - k4.y) * k4.z : 0.0f;
      my_pl[q] = my_pp[q] * leaky_grad(raw);
      my_in[q] = p.tile == 0 ? k4.w : 0.0f;
    }
#pragma unroll 1
    for (int c0 = 0; c0 < S::kRound && j0 + c0 < top; c0 += S::kChunk) {
      int32_t id[S::kChunk];
      float pp[S::kChunk];
      float d[S::kChunk];
#pragma unroll
      for (int k = 0; k < S::kChunk; ++k) {
        id[k] = from_slot<LG>(my_id, c0, k);
        d[k] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < COLS; ++q) {
        V v[S::kChunk];
#pragma unroll
        for (int k = 0; k < S::kChunk; ++k) {
          v[k] = on[q] && id[k] >= 0
                     ? __ldg(ct + static_cast<int64_t>(id[k]) * f_v + col[q])
                     : zero<V>();
        }
#pragma unroll
        for (int k = 0; k < S::kChunk; ++k) {
          if (q == 0) pp[k] = from_slot<LG>(my_pp, c0, k);
          axpy(acc[q], pp[k], v[k]);
          d[k] = dot_acc(d[k], hv[q], v[k]);
        }
      }
      transpose_sum<LG, S::kChunkLg>(d, p.gl);
      if constexpr (S::kPrep == 1) {
        // every lane holds the total of slot c0 + gl mod kChunk: its own slot
        // where that is the one it prepared
        if ((p.gl & ~(S::kChunk - 1)) == c0) {
          const float t = my_pl[0] * (d[0] - my_in[0]);
          a += t;
          if (d_sl != nullptr && my_id[0] >= 0) atomicAdd(d_sl + my_id[0], t);
        }
      } else {
        // d[i] is the total of slot i G + gl, which this lane prepared
#pragma unroll
        for (int i = 0; i < S::kPrep; ++i) {
          const float t = my_pl[i] * (d[i] - my_in[i]);
          a += t;
          if (d_sl != nullptr && my_id[i] >= 0) atomicAdd(d_sl + my_id[i], t);
        }
      }
    }
  }
  const bool add = p.live && __ldg(is_split + row) != 0;
#pragma unroll
  for (int q = 0; q < COLS; ++q) {
    if (!on[q]) continue;
    V* dst = d_h + static_cast<int64_t>(row) * f_v + col[q];
    if (add) {
      atomicAdd(dst, acc[q]);
    } else {
      __stcs(dst, acc[q]);
    }
  }
  a = group_sum(a, LG);
  if (p.live && p.gl == 0) put(d_sr + row, a, add || tab.tiles > 1);
}

// Launches `kernel<V, LG, ...>` (CASE's template arguments) for the plan's
// 2^LG lanes a row.
#define GAB_LG_SWITCH(CASE, plan, ...)                                          \
  switch (plan.lg) {                                                           \
    case 0: CASE(0, plan, __VA_ARGS__); break;                                 \
    case 1: CASE(1, plan, __VA_ARGS__); break;                                 \
    case 2: CASE(2, plan, __VA_ARGS__); break;                                 \
    case 3: CASE(3, plan, __VA_ARGS__); break;                                 \
    case 4: CASE(4, plan, __VA_ARGS__); break;                                 \
    default: CASE(5, plan, __VA_ARGS__);                                       \
  }
#define GAB_WIDE_CASE(kernel, V, LG, COLS, plan, stream, ...)                  \
  kernel<V, LG, COLS><<<plan.grid, dim3(kThreads), 0, stream>>>(plan.tab,      \
                                                               __VA_ARGS__)
#define GAB_ONE_COL_CASE(LG, plan, kernel, V, stream, ...)                     \
  GAB_WIDE_CASE(kernel, V, LG, 1, plan, stream, __VA_ARGS__)
// Launches `kernel<V, LG, COLS>` for a plan made with at most 2^LANES_LG
// lanes a row: one column a lane while the tile fits the group, else
// 32 >> LANES_LG columns a lane in the widest group.
#define GAB_WIDE_LAUNCH(kernel, V, LANES_LG, plan, tile_v, stream, ...)        \
  if ((tile_v) > (1 << plan.lg)) {                                             \
    GAB_WIDE_CASE(kernel, V, LANES_LG, (32 >> LANES_LG), plan, stream,         \
                 __VA_ARGS__);                                                 \
  } else {                                                                     \
    GAB_LG_SWITCH(GAB_ONE_COL_CASE, plan, kernel, V, stream, __VA_ARGS__)      \
  }
// gat_v2_fwd_kernel<V, LG>: one column a lane, up to 32 lanes a row.
#define GAB_FWD_CASE(LG, plan, V, stream, ...)                                 \
  gat_v2_fwd_kernel<V, LG><<<plan.grid, dim3(kThreads), 0, stream>>>(          \
      plan.tab, __VA_ARGS__)

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

// m0 (nv,) with -inf in split and edgeless rows -> m0_i = max_j sr_j. Every
// bucket's width is a multiple of 4 and its nbr 16-byte aligned.
extern "C" int gab_gat_rowmax(GAB_TABLE_PARAMS, const void* is_split,
                              const void* sr, void* m0, int device,
                              void* stream) {
  Table tab;
  cudaError_t err;
  const int64_t grid = fill_table(&tab, GAB_TABLE_ARGS, kRowmaxLg, 1, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  gat_rowmax_kernel<kRowmaxLg><<<dim3(static_cast<unsigned>(grid)),
                                 dim3(kThreads), 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<const uint8_t*>(is_split),
      static_cast<const float*>(sr), static_cast<float*>(m0));
  return static_cast<int>(cudaGetLastError());
}

// acc (nv, f) and z (nv,) with zeros in split and edgeless rows; z is
// stored by the first feature tile alone.
extern "C" int gab_gat_v2_fwd(GAB_TABLE_PARAMS, const void* is_split,
                              const void* sl, const void* sr, const void* m,
                              const void* h, void* acc, void* z, int64_t f,
                              int tile_v, int vec, int device, void* stream) {
  WidePlan p;
  const cudaError_t err =
      plan_wide(&p, GAB_TABLE_ARGS, f, tile_v, vec, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float* slf = static_cast<const float*>(sl);
  const float* srf = static_cast<const float*>(sr);
  const float* mf = static_cast<const float*>(m);
  float* zf = static_cast<float*>(z);
  if (vec) {
    GAB_LG_SWITCH(GAB_FWD_CASE, p, float4, s, split, slf, srf, mf,
                  static_cast<const float4*>(h), static_cast<float4*>(acc),
                  zf, p.f_v, tile_v)
  } else {
    GAB_LG_SWITCH(GAB_FWD_CASE, p, float, s, split, slf, srf, mf,
                  static_cast<const float*>(h), static_cast<float*>(acc), zf,
                  p.f_v, tile_v)
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
  const cudaError_t err =
      plan_wide(&p, GAB_TABLE_ARGS, f, tile_v, vec, device, kBwdSlLanesLg);
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
    GAB_WIDE_LAUNCH(gat_v2_bwd_sl_kernel, float4, kBwdSlLanesLg, p, tile_v, s,
                   split, slf, srf, mf, zf, innerf,
                   static_cast<const float4*>(h),
                   static_cast<const float4*>(ct), out, p.f_v, tile_v)
  } else {
    GAB_WIDE_LAUNCH(gat_v2_bwd_sl_kernel, float, kBwdSlLanesLg, p, tile_v, s,
                   split, slf, srf, mf, zf, innerf,
                   static_cast<const float*>(h), static_cast<const float*>(ct),
                   out, p.f_v, tile_v)
  }
  return static_cast<int>(cudaGetLastError());
}

// pack (nv, 4) f32 rows (sl, m, zinv, inner), aligned to 16 bytes; d_h
// (nv, f) with zeros in split and edgeless rows; d_sr (nv,) likewise, or all
// zeros when the pass takes more than one tile. d_sl is null or (nv,) of
// zeros, and then the pass adds every t_ij into d_sl_i as well.
extern "C" int gab_gat_v2_bwd_h(
    GAB_TABLE_PARAMS, const void* is_split, const void* pack, const void* sr,
    const void* h, const void* ct, void* d_h, void* d_sr, void* d_sl,
    int64_t f, int tile_v, int vec, int device, void* stream) {
  WidePlan p;
  const cudaError_t err =
      plan_wide(&p, GAB_TABLE_ARGS, f, tile_v, vec, device, kBwdLanesLg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* split = static_cast<const uint8_t*>(is_split);
  const float4* pk = static_cast<const float4*>(pack);
  const float* srf = static_cast<const float*>(sr);
  float* dsr = static_cast<float*>(d_sr);
  float* dsl = static_cast<float*>(d_sl);
  if (vec) {
    GAB_WIDE_LAUNCH(gat_v2_bwd_h_kernel, float4, kBwdLanesLg, p, tile_v, s,
                   split, pk, srf, static_cast<const float4*>(h),
                   static_cast<const float4*>(ct), static_cast<float4*>(d_h),
                   dsr, dsl, p.f_v, tile_v)
  } else {
    GAB_WIDE_LAUNCH(gat_v2_bwd_h_kernel, float, kBwdLanesLg, p, tile_v, s,
                   split, pk, srf, static_cast<const float*>(h),
                   static_cast<const float*>(ct),
                   static_cast<float*>(d_h), dsr, dsl, p.f_v, tile_v)
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
