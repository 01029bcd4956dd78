// K14, the first-fit step of greedy vertex coloring, for Hopper (built for
// sm_90a by graphaibench_tpu_torch/ops/_build.py and bound with ctypes; the
// wrapper, its tables and the plain PyTorch version are in
// graphaibench_tpu_torch/ops/first_fit.py).
//
// It replaces graphaibench_tpu/analytics/coloring.py::color's first_fit, an
// XLA program of the JAX package that scatters every edge's colour into a
// dense (nv, max_colors) "forbidden" matrix and takes each row's argmax of
// the free entries. For every active row v:
//
//   new[v] = the smallest c < max_colors that no neighbour u != v holds in
//            colors[u], or 0 where all max_colors colours are taken (the
//            argmax of an all-False row)
//
// and new[v] = colors[v] on inactive rows. The step reads the previous
// round's colours and writes a second buffer: JAX's rounds are Jacobi, and
// an update in place would give other colours.
//
// What bounds it on this card: bytes, and of those the scattered ones. A
// round reads the row pointers, the ids of its active rows once, the active
// flags, and writes the new colours: 70 MB on rmat(19, 16) in the first
// round, 0.021 ms at 3.35 TB/s. Each id gathers one 4-byte colour from a
// random line (2 MiB of colours at 2^19 vertices, in L2), as K8's gathers
// do.
//
// What the design does about it: the dense matrix is never formed (it would
// be 13.6 GB at rmat19, where the largest degree is about 26,000), and the
// answer of a row of degree d is at most d (d neighbours hold at most d
// colours).
//   * Marks in registers. Each lane ORs the colours below kLowWords * 32
//     (128) of its ids into kLowWords register words, and the row's lanes
//     combine them with __reduce_or_sync (a group of fewer lanes with
//     __shfl_xor_sync): no atomic, no shared memory. In the solve's first
//     round every colour is 0, so a bitmap in shared memory (the first
//     design) serialised every mark on one word. Only a row whose 128 low
//     colours are all taken, and whose max_colors lies above them, marks
//     the colours past them in a shared-memory window (1,024 colours a
//     warp, 8,192 a hub's block, atomicOr), reading its ids again, and
//     takes the next window while the current one is full.
//   * Lanes by degree. The rows of at most kHubDegree neighbours come in a
//     table of chunks of 32 entries (the wrapper's, built once per graph:
//     rows of like degree, in classes, widest first, -1 pads); a warp takes
//     a chunk, a lane an entry, and reads the 32 active flags at once.
//     Where the chunk's active rows have at most 16, 32 or 64 neighbours,
//     groups of 4, 8 or 16 lanes take 8, 4 or 2 rows side by side; else
//     the 32 lanes take one row after another. A lane has up to kUnroll ids
//     and their colours in flight.
//   * Inactive rows cost one table entry, one flag and the colour copied;
//     no row pointer is read.
//   * Hubs (more than kHubDegree neighbours; the wrapper lists them once
//     per graph): a block a slice of kHubSlice ids of a hub, the first
//     blocks of the launch. Each warp combines its marks in registers and
//     ORs them into the hub's kLowWords words in device memory (zeroed by
//     the entry before the launch), one atomicOr a warp and word; the
//     hub's last slice to finish (a count beside the words) takes the
//     answer. A hub's row is then a few loads deep, not its degree over
//     the block's threads: the solve's widest row, vertex 0 of rmat,
//     loses every conflict and is active in nearly every round.
// Any table that lists every row of at most kHubDegree neighbours once
// gives the same colours: it only makes the launch faster or slower.
//
// Exact: integer compares and bit sets.
//
// Ids, row pointers and colours are int32; colours at or past max_colors
// (which no round produces) mark nothing.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpColors = 1024;              // a warp's window
constexpr int kBlockColors = 32 * kThreads;    // a hub block's window
constexpr int kHubDegree = 1024;               // ops/first_fit.py HUB_DEGREE
constexpr int kHubSlice = 4096;                // ops/first_fit.py HUB_SLICE
constexpr int kChunk = 32;                     // ops/first_fit.py CHUNK
constexpr int kLowWords = 4;                   // colours kept in registers / 32
constexpr int kUnroll = 4;                     // ids a lane loads at once
constexpr unsigned kFullMask = 0xffffffffu;
// a group of fewer than 32 lanes takes rows of at most 16 * kUnroll
// neighbours, whose first free colour the low words hold
static_assert(16 * kUnroll < 32 * kLowWords, "groups past the low words");

// A window's word with the colours at or past max_colors set: they count as
// taken. `lo` is the word's first colour.
__device__ __forceinline__ uint32_t cap(uint32_t word, int64_t lo,
                                        int32_t max_colors) {
  const int64_t valid = static_cast<int64_t>(max_colors) - lo;
  if (valid >= 32) return word;
  if (valid <= 0) return kFullMask;
  return word | (kFullMask << valid);
}

// Colour c into the register words w (c below 32 * kLowWords).
__device__ __forceinline__ void mark_low(uint32_t (&w)[kLowWords],
                                         uint32_t c) {
  const uint32_t bit = 1u << (c & 31);
#pragma unroll
  for (int k = 0; k < kLowWords; ++k) w[k] |= (c >> 5) == k ? bit : 0u;
}

// Marks in w the colours below 32 * kLowWords of the neighbours u != v of
// ids[start, end), threads `t` of `n` side by side, kUnroll ids a thread
// in flight.
__device__ __forceinline__ void mark_row_low(
    uint32_t (&w)[kLowWords], const int32_t* __restrict__ col,
    const int32_t* __restrict__ colors, int64_t start, int64_t end, int32_t v,
    int t, int n) {
  for (int64_t e0 = start + t; e0 < end; e0 += static_cast<int64_t>(n) *
                                               kUnroll) {
    int32_t u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t e = e0 + static_cast<int64_t>(n) * k;
      u[k] = e < end ? __ldg(col + e) : v;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (u[k] != v) {
        const uint32_t c = static_cast<uint32_t>(__ldg(colors + u[k]));
        if (c < 32u * kLowWords) mark_low(w, c);
      }
    }
  }
}

// The first free colour of the low words (taken: marked, or at or past
// max_colors), or 32 * kLowWords where every one is taken.
__device__ __forceinline__ int first_free_low(const uint32_t (&w)[kLowWords],
                                              int32_t max_colors) {
#pragma unroll
  for (int k = 0; k < kLowWords; ++k) {
    const uint32_t x = cap(w[k], 32 * k, max_colors);
    if (x != kFullMask) return 32 * k + __ffs(~x) - 1;
  }
  return 32 * kLowWords;
}

// Marks in `bits` (words of the window [base, base + 32 * words)) the colour
// of every neighbour u != v of ids[start, end), threads `t` of `n` side by
// side.
__device__ __forceinline__ void mark(uint32_t* bits, int words,
                                     const int32_t* __restrict__ col,
                                     const int32_t* __restrict__ colors,
                                     int64_t start, int64_t end, int32_t v,
                                     int64_t base, int t, int n) {
  for (int64_t e = start + t; e < end; e += n) {
    const int32_t u = __ldg(col + e);
    if (u == v) continue;
    const int64_t c = static_cast<int64_t>(__ldg(colors + u)) - base;
    if (c >= 0 && c < 32 * words) {
      atomicOr(bits + (c >> 5), 1u << (c & 31));
    }
  }
}

// Row v (ids[start, end)) by the warp's 32 lanes: its new colour, the same
// in every lane.
__device__ __forceinline__ int32_t warp_row(uint32_t* wbits,
                                            const int32_t* __restrict__ col,
                                            const int32_t* __restrict__ colors,
                                            int64_t start, int64_t end,
                                            int32_t v, int32_t max_colors,
                                            int lane) {
  uint32_t w[kLowWords] = {};
  mark_row_low(w, col, colors, start, end, v, lane, 32);
#pragma unroll
  for (int k = 0; k < kLowWords; ++k) w[k] = __reduce_or_sync(kFullMask, w[k]);
  const int low = first_free_low(w, max_colors);
  if (low < 32 * kLowWords) return low;
  // every low colour taken: the windows past them in shared memory
  for (int64_t base = 32 * kLowWords; base < max_colors;
       base += kWarpColors) {
    wbits[lane] = 0;
    __syncwarp();
    mark(wbits, 32, col, colors, start, end, v, base, lane, 32);
    __syncwarp();
    const uint32_t word = cap(wbits[lane], base + 32 * lane, max_colors);
    const unsigned free_lanes = __ballot_sync(kFullMask, word != kFullMask);
    if (free_lanes != 0) {
      const int l = __ffs(free_lanes) - 1;
      const uint32_t x = __shfl_sync(kFullMask, word, l);
      return static_cast<int32_t>(base + 32 * l + __ffs(~x) - 1);
    }
    __syncwarp();  // every lane read its word before the next window
  }
  return 0;
}

// Hub v's row from the low words its slices combined (`words`), by the
// block of its last slice: its new colour in thread 0's out[v].
__device__ __forceinline__ void hub_answer(
    const int32_t* __restrict__ col, const int32_t* __restrict__ colors,
    int32_t v, int64_t start, int64_t end, int32_t max_colors,
    const uint32_t* words, uint32_t* bits, int* warp_first,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t w[kLowWords];
#pragma unroll
  for (int k = 0; k < kLowWords; ++k) {
    w[k] = *reinterpret_cast<const volatile uint32_t*>(words + k);
  }
  int32_t result = first_free_low(w, max_colors);
  if (result == 32 * kLowWords) {
    // every low colour taken: the windows past them in shared memory, the
    // block over every id of the hub
    result = 0;
    for (int64_t base = 32 * kLowWords; base < max_colors;
         base += kBlockColors) {
      bits[threadIdx.x] = 0;
      __syncthreads();
      mark(bits, kThreads, col, colors, start, end, v, base, threadIdx.x,
           kThreads);
      __syncthreads();
      const uint32_t word =
          cap(bits[threadIdx.x], base + 32 * threadIdx.x, max_colors);
      const unsigned free_lanes = __ballot_sync(kFullMask, word != kFullMask);
      int cand = INT_MAX;
      if (free_lanes != 0) {
        const int l = __ffs(free_lanes) - 1;
        const uint32_t x = __shfl_sync(kFullMask, word, l);
        cand = 32 * (32 * warp + l) + __ffs(~x) - 1;
      }
      if (lane == 0) warp_first[warp] = cand;
      __syncthreads();
      int first = INT_MAX;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) first = min(first, warp_first[k]);
      if (first != INT_MAX) {
        result = static_cast<int32_t>(base + first);
        break;
      }
      __syncthreads();  // every thread read warp_first before the next round
    }
  }
  if (threadIdx.x == 0) out[v] = result;
}

// Slice k of hub v (ids k * kHubSlice .. + kHubSlice of its row) a block:
// its marks into the hub's words (kLowWords, then the count of its slices
// done); the last of its slices answers. A hub flagged inactive copies its
// colour in its first slice.
__device__ __forceinline__ void hub_slice(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
    const int32_t* __restrict__ colors, const uint8_t* __restrict__ active,
    int32_t v, int32_t k, uint32_t* words, int32_t max_colors,
    uint32_t* bits, int* warp_first, int* last, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  if (!active[v]) {
    if (k == 0 && threadIdx.x == 0) out[v] = colors[v];
    return;
  }
  const int64_t start = __ldg(row_ptr + v), end = __ldg(row_ptr + v + 1);
  const int64_t lo = start + static_cast<int64_t>(k) * kHubSlice;
  const int64_t hi = end - lo < kHubSlice ? end : lo + kHubSlice;
  uint32_t w[kLowWords] = {};
  mark_row_low(w, col, colors, lo, hi, v, threadIdx.x, kThreads);
#pragma unroll
  for (int q = 0; q < kLowWords; ++q) {
    w[q] = __reduce_or_sync(kFullMask, w[q]);
    if (lane == 0 && w[q] != 0) atomicOr(words + q, w[q]);
  }
  __threadfence();
  __syncthreads();  // every warp's marks are in before the count
  if (threadIdx.x == 0) {
    const uint32_t n =
        static_cast<uint32_t>((end - start + kHubSlice - 1) / kHubSlice);
    *last = atomicAdd(words + kLowWords, 1u) == n - 1;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  hub_answer(col, colors, v, start, end, max_colors, words, bits, warp_first,
             out);
}

__global__ void __launch_bounds__(kThreads)
first_fit_kernel(const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ col,
                 const int32_t* __restrict__ colors,
                 const uint8_t* __restrict__ active,
                 const int32_t* __restrict__ hubs,
                 const int32_t* __restrict__ slices, int64_t n_slices,
                 uint32_t* __restrict__ hub_words,
                 const int32_t* __restrict__ order, int64_t n_chunks,
                 int32_t max_colors, int32_t* __restrict__ out) {
  __shared__ uint32_t bits[kThreads];
  __shared__ int warp_first[kWarps];
  __shared__ int last;
  // a warp's active rows of its chunk: id, first id, end
  __shared__ int32_t rows_v[kThreads];
  __shared__ int32_t rows_s[kThreads];
  __shared__ int32_t rows_e[kThreads];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x < n_slices) {
    const int32_t h = __ldg(slices + 2 * static_cast<int64_t>(blockIdx.x));
    hub_slice(row_ptr, col, colors, active, __ldg(hubs + h),
              __ldg(slices + 2 * static_cast<int64_t>(blockIdx.x) + 1),
              hub_words + static_cast<int64_t>(h) * (kLowWords + 1),
              max_colors, bits, warp_first, &last, out);
    return;
  }
  // a warp a chunk of the table, a lane an entry
  const int64_t chunk =
      static_cast<int64_t>(blockIdx.x - n_slices) * kWarps + warp;
  if (chunk >= n_chunks) return;
  const int32_t v = __ldg(order + chunk * kChunk + lane);
  bool act = false;
  int32_t s = 0, e = 0;
  if (v >= 0) {
    act = active[v] != 0;
    if (act) {
      s = __ldg(row_ptr + v);
      e = __ldg(row_ptr + v + 1);
    } else {
      out[v] = __ldg(colors + v);
    }
  }
  const unsigned live = __ballot_sync(kFullMask, act);
  if (live == 0) return;
  int32_t* wv = rows_v + 32 * warp;
  int32_t* ws = rows_s + 32 * warp;
  int32_t* we = rows_e + 32 * warp;
  if (act) {
    const int rank = __popc(live & ((1u << lane) - 1));
    wv[rank] = v;
    ws[rank] = s;
    we[rank] = e;
  }
  const int m = __popc(live);
  const int widest = __reduce_max_sync(kFullMask, act ? e - s : 0);
  __syncwarp();
  // groups of 4, 8, 16 lanes for rows of at most 4, 8, 16 times kUnroll
  // neighbours
  const int lg = widest <= 4 * kUnroll    ? 2
                 : widest <= 8 * kUnroll  ? 3
                 : widest <= 16 * kUnroll ? 4
                                          : 5;
  if (lg < 5) {
    const int gl = lane & ((1 << lg) - 1);
    for (int k0 = 0; k0 < m; k0 += 32 >> lg) {
      const int k = k0 + (lane >> lg);
      const bool has = k < m;
      const int32_t rv = has ? wv[k] : -1;
      uint32_t w[kLowWords] = {};
      mark_row_low(w, col, colors, has ? ws[k] : 0, has ? we[k] : 0, rv, gl,
                   1 << lg);
      for (int o = 1 << (lg - 1); o > 0; o >>= 1) {
#pragma unroll
        for (int q = 0; q < kLowWords; ++q) {
          w[q] |= __shfl_xor_sync(kFullMask, w[q], o);
        }
      }
      // at most 16 * kUnroll neighbours: a free colour among the low
      // words, or every colour below max_colors taken
      const int r = first_free_low(w, max_colors);
      if (has && gl == 0) out[rv] = r < 32 * kLowWords ? r : 0;
    }
    return;
  }
  // the 32 lanes a row, one row after another
  for (int k = 0; k < m; ++k) {
    const int32_t rv = wv[k];
    const int32_t r = warp_row(bits + 32 * warp, col, colors, ws[k], we[k],
                               rv, max_colors, lane);
    if (lane == 0) out[rv] = r;
  }
}

}  // namespace

// One first-fit round. row_ptr (nv + 1,) and col_idx (ne,) int32: a CSR
// graph; colors (nv,) int32, the previous round's colours; active (nv,)
// uint8; hubs (n_hubs,) int32, every row of more than kHubDegree (1024)
// neighbours; slices (n_slices, 2) int32, (index into hubs, slice number)
// for every kHubSlice ids of each hub's row; hub_words ((kLowWords + 1)
// n_hubs,) uint32 scratch, zeroed here; order (32 n_chunks,) int32, every
// other row once (rows or -1, chunks of 32 entries,
// ops/first_fit.py::first_fit_tables); out (nv,) int32, written in every
// row. Every pointer on CUDA device `device`, stream a cudaStream_t of that
// device; the entry selects `device` before launching. Returns the first
// CUDA error (0 on success), allocates nothing and does not synchronise.
extern "C" int gab_first_fit(const void* row_ptr, const void* col_idx,
                             const void* colors, const void* active,
                             const void* hubs, int64_t n_hubs,
                             const void* slices, int64_t n_slices,
                             void* hub_words, const void* order,
                             int64_t n_chunks, int max_colors, void* out,
                             int device, void* stream) {
  if (n_hubs < 0 || n_slices < n_hubs || n_chunks < 0 || max_colors < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = n_slices + (n_chunks + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_hubs > 0) {
    err = cudaMemsetAsync(hub_words, 0,
                          static_cast<size_t>(n_hubs) * (kLowWords + 1) *
                              sizeof(uint32_t),
                          st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) {
    first_fit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const int32_t*>(row_ptr),
        static_cast<const int32_t*>(col_idx),
        static_cast<const int32_t*>(colors),
        static_cast<const uint8_t*>(active),
        static_cast<const int32_t*>(hubs),
        static_cast<const int32_t*>(slices), n_slices,
        static_cast<uint32_t*>(hub_words),
        static_cast<const int32_t*>(order), n_chunks, max_colors,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
