// K14, the first-fit step of greedy vertex coloring, for Hopper (built for
// sm_90a by graphaibench_tpu_torch/ops/_build.py and bound with ctypes; the
// wrapper and the plain PyTorch version are in
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
// round reads the row pointers, the ids once, the active flags, and writes
// the new colours: 70 MB on rmat(19, 16) in the first round, 0.021 ms at
// 3.35 TB/s. Each id gathers one 4-byte colour from a random line (2 MiB of
// colours at 2^19 vertices, in L2), as K8's and K10's gathers do.
//
// What the design does about it: the dense matrix is never formed (it would
// be 13.6 GB at rmat19, where the largest degree is about 26,000). A row's
// neighbour colours are marked in a bitmap in shared memory over a window of
// colours, and the window's first clear bit is found with __ballot_sync and
// __ffs. The next window is tried only when the current one is full; the
// answer is at most the row's degree, so a row of degree d reads its ids at
// most d / window + 1 times, and in practice once.
//   * rows of up to kHubDegree neighbours: a warp a row, its window 1,024
//     colours (32 words, a word a lane), the ids read by the 32 lanes side
//     by side;
//   * hubs (more than kHubDegree neighbours; their list `hubs` comes from the
//     wrapper, once per graph): a block a row, the first blocks of the
//     launch, its window 8,192 colours (256 words, a word a thread), the ids
//     read by the 256 threads side by side.
// One launch a round. Rows of an inactive vertex copy their colour.
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
constexpr unsigned kFullMask = 0xffffffffu;

// A window's word with the colours at or past max_colors set: they count as
// taken. `lo` is the word's first colour.
__device__ __forceinline__ uint32_t cap(uint32_t word, int64_t lo,
                                        int32_t max_colors) {
  const int64_t valid = static_cast<int64_t>(max_colors) - lo;
  if (valid >= 32) return word;
  if (valid <= 0) return kFullMask;
  return word | (kFullMask << valid);
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

__global__ void __launch_bounds__(kThreads)
first_fit_kernel(const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ col,
                 const int32_t* __restrict__ colors,
                 const uint8_t* __restrict__ active,
                 const int32_t* __restrict__ hubs, int64_t n_hubs,
                 int64_t nv, int32_t max_colors, int32_t* __restrict__ out) {
  __shared__ uint32_t bits[kThreads];
  __shared__ int warp_first[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x < n_hubs) {
    // a hub a block
    const int32_t v = __ldg(hubs + blockIdx.x);
    if (!active[v]) {
      if (threadIdx.x == 0) out[v] = colors[v];
      return;
    }
    const int64_t start = __ldg(row_ptr + v), end = __ldg(row_ptr + v + 1);
    int32_t result = 0;
    for (int64_t base = 0; base < max_colors; base += kBlockColors) {
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
        const uint32_t w = __shfl_sync(kFullMask, word, l);
        cand = 32 * (32 * warp + l) + __ffs(~w) - 1;
      }
      if (lane == 0) warp_first[warp] = cand;
      __syncthreads();
      int first = INT_MAX;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) first = min(first, warp_first[w]);
      if (first != INT_MAX) {
        result = static_cast<int32_t>(base + first);
        break;
      }
      __syncthreads();  // every thread read warp_first before the next round
    }
    if (threadIdx.x == 0) out[v] = result;
    return;
  }
  // a warp a row
  const int64_t v64 =
      static_cast<int64_t>(blockIdx.x - n_hubs) * kWarps + warp;
  if (v64 >= nv) return;
  const int32_t v = static_cast<int32_t>(v64);
  const int64_t start = __ldg(row_ptr + v), end = __ldg(row_ptr + v + 1);
  if (end - start > kHubDegree) return;  // a hub block writes this row
  if (!active[v]) {
    if (lane == 0) out[v] = colors[v];
    return;
  }
  uint32_t* wbits = bits + 32 * warp;
  int32_t result = 0;
  for (int64_t base = 0; base < max_colors; base += kWarpColors) {
    wbits[lane] = 0;
    __syncwarp();
    mark(wbits, 32, col, colors, start, end, v, base, lane, 32);
    __syncwarp();
    const uint32_t word = cap(wbits[lane], base + 32 * lane, max_colors);
    const unsigned free_lanes = __ballot_sync(kFullMask, word != kFullMask);
    if (free_lanes != 0) {
      const int l = __ffs(free_lanes) - 1;
      const uint32_t w = __shfl_sync(kFullMask, word, l);
      result = static_cast<int32_t>(base + 32 * l + __ffs(~w) - 1);
      break;
    }
    __syncwarp();  // every lane read its word before the next window
  }
  if (lane == 0) out[v] = result;
}

}  // namespace

// One first-fit round. row_ptr (nv + 1,) and col_idx (ne,) int32: a CSR
// graph; colors (nv,) int32, the previous round's colours; active (nv,)
// uint8; hubs (n_hubs,) int32, every row of more than kHubDegree (1024)
// neighbours, no other; out (nv,) int32, written in every row. Every pointer
// on CUDA device `device`, stream a cudaStream_t of that device; the entry
// selects `device` before launching. Returns the first CUDA error (0 on
// success), allocates nothing and does not synchronise.
extern "C" int gab_first_fit(const void* row_ptr, const void* col_idx,
                             const void* colors, const void* active,
                             const void* hubs, int64_t n_hubs, int64_t nv,
                             int max_colors, void* out, int device,
                             void* stream) {
  if (nv < 0 || n_hubs < 0 || n_hubs > nv || max_colors < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = n_hubs + (nv + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    first_fit_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(row_ptr),
        static_cast<const int32_t*>(col_idx),
        static_cast<const int32_t*>(colors),
        static_cast<const uint8_t*>(active),
        static_cast<const int32_t*>(hubs), n_hubs, nv, max_colors,
        static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
