// K10, one sweep of k-core's h-index fixpoint, for Hopper (built for sm_90a
// by graphaibench_tpu_torch/ops/_build.py and bound with ctypes; the wrapper
// and the plain PyTorch version are in graphaibench_tpu_torch/ops/hindex.py).
//
// It replaces graphaibench_tpu/analytics/kcore.py::_row_hindex and
// _hindex_sweep, an XLA program of the JAX package that gathers the
// neighbours' core values into a no-split padded layout and binary-searches
// each row's h-index:
//
//   new[v] = min(core[v], H(core[N(v)])),  H(x) = max t with #{x_i >= t} >= t
//   changed = #{v : new[v] != core[v]}
//
// on a symmetric graph; a row without neighbours keeps its value. The sweep
// reads `core` and writes a second buffer (Jacobi order): an update in place
// would reach the same fixpoint in another number of sweeps.
//
// What bounds it on this card: bytes, and of those the scattered ones. The
// compulsory traffic is 4 bytes an edge of ids, 4 a vertex each of row
// pointers, the row order, core and new: 71 MB on rmat(19, 16), 0.021 ms at
// 3.35 TB/s. But each slot gathers one 4-byte value from a random line of
// core (2 MiB at 2^19 vertices, in L2), the access that bounds K8
// (csrc/ell_pull.cu) too.
//
// What the design does about it: each slot is gathered at most once a level
// of its row's search, every row takes as many lanes as its values need,
// and the widest rows start first. The h-index does not decompose over
// pieces of a row, so a row stays whole; the kernel reads the CSR directly.
// With
// c = min(deg(v), core[v]) the answer is max t <= c with S(t) >= t, where
// S(t) = #{y_i >= t} over y_i = min(x_i, c). The wrapper orders the vertices
// once per graph, hubs first, then classes by degree, and one launch covers
// them all, a block finding its class from a prefix of block counts:
//   * hubs (more than 1024 neighbours; 25,058 at most on rmat(19, 16)): a
//     block a row, the first blocks of the launch, widest first, so that the
//     widest row does not finish the sweep alone. The block builds a
//     histogram of y over [lo, hi] = [0, c] in shared memory (kHubBins bins)
//     in one pass over the row, then scans it from the top bin down, 256 bins
//     a step, for the largest bin whose lower edge t has S(t) >= t. The
//     first pass gives each value below kHubBins - 1 a bin and the rest the
//     top bin; only an answer in the top bin needs more passes, which split
//     what is left into even bins and go on inside the bin found: exact at
//     any width, every pass a gather of the row. A pass stops early once
//     S(hi) >= hi is seen, which makes hi the answer: in a later sweep c is
//     the row's coreness so far, far below its width, and a row whose value
//     holds finds c values that reach it long before its end;
//   * rows of 129-1024 neighbours: a warp a row, the same search in a
//     histogram of kWarpBins bins of the warp's own (an answer of 255 or
//     more takes more passes), stopping early the same way;
//   * rows of up to 128: 2, 4, 8, 16 or 32 lanes a row, 4 values a lane in
//     registers, and a binary search over [0, c] whose steps follow c (one
//     warp reduction a step over the row's values, not over a padded
//     width), its first step at c itself: in a later sweep most rows keep
//     their value, and one step settles them.
// A warp adds its changed rows into the counter with one atomic; the
// wrapper reads the counter once a sweep.
//
// Exact: integer counts and compares.
//
// Addresses are computed in 64 bits; ids and row pointers are int32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// The row classes after the hubs: five in registers, then a warp a row.
constexpr int kClasses = 6;
// A warp's histogram; a hub block's is the warps' together.
constexpr int kWarpBins = 256;
constexpr int kHubBins = kWarpBins * kWarps;
// Values a lane gathers before it bins them.
constexpr int kUnroll = 4;

// Hubs are rows[0, hubs), a block each; the rows of class c are
// rows[start[c], start[c + 1]), its blocks [block_start[c],
// block_start[c + 1]) (after the hubs' blocks).
struct Classes {
  int64_t hubs;
  int64_t start[kClasses + 1];
  int64_t block_start[kClasses + 1];
};

// The bins of a pass over [lo, hi] with `bins` of them: the first pass
// gives each value below lo + bins - 1 a bin of its own and the rest the
// top bin (a row's answer is most often far below c, and then one pass
// finds it); a later pass splits [lo, hi] into bins of even width w.
__device__ __forceinline__ void pass_bins(int lo, int hi, int bins,
                                          bool first, int& w, int& nb) {
  const int span = hi - lo + 1;
  if (first || span <= bins) {
    w = 1;
    nb = min(span, bins);
  } else {
    w = (span + bins - 1) / bins;
    nb = (span + w - 1) / w;
  }
}

// One round of a row's values, kUnroll of them STRIDE apart from j0: each
// y = min(x, hi) >= lo added into bin min((y - lo) / w, nb - 1). Returns
// how many of them reach hi.
template <int STRIDE>
__device__ __forceinline__ int bin_round(const int32_t* __restrict__ nbr,
                                         int d,
                                         const int32_t* __restrict__ core,
                                         int lo, int hi, int w, int nb,
                                         int j0, int* bins) {
  int y[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int j = j0 + k * STRIDE;
    y[k] = j < d ? min(__ldg(core + __ldg(nbr + j)), hi) : -1;
  }
  int top = 0;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (y[k] >= lo) {
      atomicAdd(bins + min(w == 1 ? y[k] - lo : (y[k] - lo) / w, nb - 1), 1);
    }
    top += y[k] == hi;
  }
  return top;
}

// The h-index of a row of 129-1024 neighbours, c = min(d, core[v]), by
// the calling warp, in its own kWarpBins bins.
__device__ int warp_hindex(const int32_t* __restrict__ nbr, int d,
                           const int32_t* __restrict__ core, int c,
                           int* bins) {
  const int lane = threadIdx.x & 31;
  int lo = 0;  // S(lo) >= lo, and the answer is in [lo, hi]
  int hi = c;
  for (bool first = true; lo < hi; first = false) {
    int w;
    int nb;
    pass_bins(lo, hi, kWarpBins, first, w, nb);
    for (int b = lane; b < nb; b += 32) bins[b] = 0;
    __syncwarp();
    // S(hi) >= hi makes hi the answer: the pass stops as soon as it is seen
    int above = 0;
    for (int j0 = 0; j0 < d && above < hi; j0 += kUnroll * 32) {
      above += __reduce_add_sync(
          kFullMask,
          bin_round<32>(nbr, d, core, lo, hi, w, nb, j0 + lane, bins));
    }
    if (above >= hi) return hi;
    __syncwarp();
    // From the top bin down, 32 bins a step: S at bin b's lower edge is
    // the bins from b up; the first bin (from the top) where it reaches
    // the edge holds the answer. Bin 0 always does.
    int carry = 0;
    int found = 0;
    for (int top = nb - 1; top >= 0; top -= 32) {
      const int b = top - lane;
      int s = b >= 0 ? bins[b] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, s, o);
        if (lane >= o) s += y;
      }
      s += carry;
      const unsigned hit = __ballot_sync(kFullMask, b >= 0 && s >= lo + b * w);
      if (hit != 0) {
        found = top - (__ffs(hit) - 1);
        break;
      }
      carry = __shfl_sync(kFullMask, s, 31);
    }
    __syncwarp();  // every lane has read the bins before they are cleared
    // the answer is in the bin found: the top bin holds the rest up to hi
    lo += found * w;
    if (found < nb - 1) hi = lo + w - 1;
  }
  return lo;
}

// The h-index of a hub, c = min(d, core[v]), by the whole block, in
// kHubBins bins.
__device__ int block_hindex(const int32_t* __restrict__ nbr, int d,
                            const int32_t* __restrict__ core, int c,
                            int* bins) {
  __shared__ int warp_sum[kWarps];
  __shared__ int first_hit;
  // each warp's count of values reaching hi, by the parity of the round
  __shared__ int warp_above[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int lo = 0;
  int hi = c;
  // lo and hi are the same in every thread
  for (bool first = true; lo < hi; first = false) {
    int w;
    int nb;
    pass_bins(lo, hi, kHubBins, first, w, nb);
    for (int b = tid; b < nb; b += kThreads) bins[b] = 0;
    __syncthreads();
    // as the warp's: the pass stops once S(hi) >= hi is seen, a round of
    // kUnroll * kThreads values at a time
    int above = 0;
    int block_above = 0;
    for (int j0 = 0, r = 0; j0 < d && block_above < hi;
         j0 += kUnroll * kThreads, ++r) {
      above += __reduce_add_sync(
          kFullMask,
          bin_round<kThreads>(nbr, d, core, lo, hi, w, nb, j0 + tid, bins));
      if (lane == 0) warp_above[r & 1][warp] = above;
      __syncthreads();
      block_above = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) block_above += warp_above[r & 1][k];
    }
    if (block_above >= hi) return hi;
    int carry = 0;
    int found = 0;
    for (int top = nb - 1; top >= 0; top -= kThreads) {
      const int b = top - tid;
      int s = b >= 0 ? bins[b] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFullMask, s, o);
        if (lane >= o) s += y;
      }
      if (lane == 31) warp_sum[warp] = s;
      if (tid == 0) first_hit = kThreads;
      __syncthreads();
      int chunk = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        if (k < warp) s += warp_sum[k];
        chunk += warp_sum[k];
      }
      s += carry;
      if (b >= 0 && s >= lo + b * w) atomicMin(&first_hit, tid);
      __syncthreads();
      const int f = first_hit;
      __syncthreads();  // every thread has read first_hit and warp_sum
      if (f < kThreads) {
        found = top - f;
        break;
      }
      carry += chunk;
    }
    lo += found * w;
    if (found < nb - 1) hi = lo + w - 1;
  }
  return lo;
}

// One class of short rows: 2^LG lanes a row, K values a lane (rows of up to
// 2^LG * K neighbours).
template <int LG, int K>
__device__ __forceinline__ void short_rows(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
    const int32_t* __restrict__ core, const int32_t* __restrict__ rows,
    int64_t first, int64_t end, int64_t blk, int32_t* __restrict__ out,
    int* __restrict__ changed) {
  constexpr int kLanes = 1 << LG;
  const int64_t r = first + blk * (kThreads >> LG) + (threadIdx.x >> LG);
  const int gl = threadIdx.x & (kLanes - 1);
  const int lane = threadIdx.x & 31;
  const unsigned gmask =
      kLanes == 32 ? kFullMask
                   : ((1u << (kLanes & 31)) - 1u) << (lane & ~(kLanes - 1));
  const bool live = r < end;
  int32_t v = 0;
  int32_t begin = 0;
  int d = 0;
  int32_t cv = 0;
  if (live) {
    v = __ldg(rows + r);
    begin = __ldg(row_ptr + v);
    d = __ldg(row_ptr + v + 1) - begin;
    cv = __ldg(core + v);
  }
  const int32_t* nbr = col + static_cast<int64_t>(begin);
  int32_t vals[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = gl + k * kLanes;
    vals[k] = j < d ? __ldg(core + __ldg(nbr + j)) : 0;
  }
  int lo = 0;
  int hi = min(d, cv);
  // lo and hi are the same in the whole group; the first step asks for hi
  // itself: in a later sweep most rows keep their value, and one step
  // settles them
  for (int mid = hi; lo < hi; mid = (lo + hi + 1) >> 1) {
    int c = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) c += vals[k] >= mid;
    c = __reduce_add_sync(gmask, c);
    if (c >= mid) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int32_t nw = d == 0 ? cv : lo;
  const bool lead = live && gl == 0;
  if (lead) out[v] = nw;
  const unsigned ch = __ballot_sync(kFullMask, lead && nw != cv);
  if (lane == 0 && ch != 0) atomicAdd(changed, __popc(ch));
}

// Rows of 129-1024 neighbours: a warp a row.
__device__ __forceinline__ void wide_rows(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
    const int32_t* __restrict__ core, const int32_t* __restrict__ rows,
    int64_t first, int64_t end, int64_t blk, int* bins_all,
    int32_t* __restrict__ out, int* __restrict__ changed) {
  const int64_t r = first + blk * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const bool live = r < end;
  int32_t v = 0;
  int32_t cv = 0;
  int32_t nw = 0;
  if (live) {  // the same in the whole warp
    v = __ldg(rows + r);
    const int32_t begin = __ldg(row_ptr + v);
    const int d = __ldg(row_ptr + v + 1) - begin;
    cv = __ldg(core + v);
    nw = warp_hindex(col + static_cast<int64_t>(begin), d, core, min(d, cv),
                     bins_all + (threadIdx.x >> 5) * kWarpBins);
  }
  const bool lead = live && lane == 0;
  if (lead) out[v] = nw;
  const unsigned ch = __ballot_sync(kFullMask, lead && nw != cv);
  if (lane == 0 && ch != 0) atomicAdd(changed, __popc(ch));
}

__global__ void __launch_bounds__(kThreads)
hindex_kernel(const int32_t* __restrict__ row_ptr,
              const int32_t* __restrict__ col,
              const int32_t* __restrict__ core,
              const int32_t* __restrict__ rows,
              const __grid_constant__ Classes cls, int32_t* __restrict__ out,
              int* __restrict__ changed) {
  __shared__ int bins[kHubBins];
  const int64_t blk = blockIdx.x;
  if (blk < cls.hubs) {  // a hub row
    const int32_t v = __ldg(rows + blk);
    const int32_t begin = __ldg(row_ptr + v);
    const int d = __ldg(row_ptr + v + 1) - begin;
    const int32_t cv = __ldg(core + v);
    const int nw = block_hindex(col + static_cast<int64_t>(begin), d, core,
                                min(d, cv), bins);
    if (threadIdx.x == 0) {
      out[v] = nw;
      if (nw != cv) atomicAdd(changed, 1);
    }
  } else if (blk < cls.block_start[1]) {
    short_rows<1, 4>(row_ptr, col, core, rows, cls.start[0], cls.start[1],
                     blk - cls.block_start[0], out, changed);
  } else if (blk < cls.block_start[2]) {
    short_rows<2, 4>(row_ptr, col, core, rows, cls.start[1], cls.start[2],
                     blk - cls.block_start[1], out, changed);
  } else if (blk < cls.block_start[3]) {
    short_rows<3, 4>(row_ptr, col, core, rows, cls.start[2], cls.start[3],
                     blk - cls.block_start[2], out, changed);
  } else if (blk < cls.block_start[4]) {
    short_rows<4, 4>(row_ptr, col, core, rows, cls.start[3], cls.start[4],
                     blk - cls.block_start[3], out, changed);
  } else if (blk < cls.block_start[5]) {
    short_rows<5, 4>(row_ptr, col, core, rows, cls.start[4], cls.start[5],
                     blk - cls.block_start[4], out, changed);
  } else {
    wide_rows(row_ptr, col, core, rows, cls.start[5], cls.start[6],
              blk - cls.block_start[5], bins, out, changed);
  }
}

}  // namespace

// row_ptr (nv + 1,) and col_idx (ne,) int32: a symmetric graph's CSR. core
// and out (nv,) int32, out written in every row. rows (nv,) int32: every
// vertex once, hubs first, then by class; class_start (8,) host int64: the
// hubs (more than 1024 neighbours) are rows[class_start[0] = 0,
// class_start[1]), the rows of class c (up to 8, 16, 32, 64, 128 and 1024
// neighbours) rows[class_start[c + 1], class_start[c + 2]), up to
// class_start[7] = nv. changed: one device int32, set to 0 here, then the
// count of rows whose value changed. Every pointer but class_start on CUDA
// device `device`, stream a cudaStream_t of that device. The library links
// its own CUDA runtime, so the entry selects `device` before launching.
// Returns the first CUDA error (0 on success), allocates nothing and does
// not synchronise.
extern "C" int gab_hindex_sweep(const void* row_ptr, const void* col_idx,
                                const void* core, const void* rows,
                                const int64_t* class_start, void* out,
                                void* changed, int device, void* stream) {
  Classes cls{};
  cls.hubs = class_start[1] - class_start[0];
  if (class_start[0] != 0 || cls.hubs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t blocks = cls.hubs;
  constexpr int kLgLanes[kClasses] = {1, 2, 3, 4, 5, 5};
  for (int c = 0; c < kClasses; ++c) {
    const int64_t n = class_start[c + 2] - class_start[c + 1];
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    cls.start[c] = class_start[c + 1];
    cls.block_start[c] = blocks;
    const int64_t per_block = kThreads >> kLgLanes[c];
    blocks += (n + per_block - 1) / per_block;
  }
  cls.start[kClasses] = class_start[kClasses + 1];
  cls.block_start[kClasses] = blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    hindex_kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kThreads), 0,
                    s>>>(static_cast<const int32_t*>(row_ptr),
                         static_cast<const int32_t*>(col_idx),
                         static_cast<const int32_t*>(core),
                         static_cast<const int32_t*>(rows), cls,
                         static_cast<int32_t*>(out),
                         static_cast<int*>(changed));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
