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
// 3.35 TB/s; the searches need a few compares a slot. But each slot gathers
// one 4-byte value from a random line of core (2 MiB at 2^19 vertices, in
// L2), the access that bounds K8 (csrc/ell_pull.cu) too.
//
// What the design does about it: each slot is gathered once a sweep, into
// registers or shared memory, and the binary search on h then runs over
// what was gathered. The h-index does not decompose over pieces of a row,
// so a row stays whole (the JAX package builds a no-split layout for that
// reason); the kernel reads the CSR directly. The wrapper orders the
// vertices once per graph into classes by degree:
//   * up to 16 neighbours: 4 lanes a row, 4 values a lane;
//   * up to 128: a warp a row, 4 values a lane;
//   * up to 1024: a warp a row, 32 values a lane;
// one launch of hindex_rows_kernel covers these three, a block finding its
// class from a prefix of block counts, and each class runs the fixed number
// of search steps its widest row needs (extra steps change nothing), with a
// group's count added by shuffles;
//   * wider rows (hubs: 25,058 neighbours at most on rmat(19, 16)): a block
//     of 512 threads a row, in a second launch, hindex_hub_kernel, the values
//     in dynamic shared memory (up to 48 Ki values; a wider row reads the
//     rest again from device memory at each step), the count added through
//     shared memory, and as many steps as the row needs.
// The search runs on [0, min(deg, core[v])], so the minimum with core[v]
// comes out of it. A warp adds its changed rows into the counter with one
// atomic; the wrapper reads the counter once a sweep.
//
// Exact: integer counts and compares.
//
// Addresses are computed in 64 bits; ids and row pointers are int32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHubThreads = 512;
constexpr unsigned kFullMask = 0xffffffffu;
// The row kernel's classes; the hubs follow them in the row order.
constexpr int kClasses = 3;
// Values of a hub row kept in shared memory (192 KiB).
constexpr int kHubCap = 48 * 1024;

// The rows of class c are rows[start[c], start[c + 1]); its blocks are
// [block_start[c], block_start[c + 1]).
struct Classes {
  int64_t start[kClasses + 1];
  int64_t block_start[kClasses + 1];
};

// One class of rows: 2^LG lanes a row, K values a lane (rows of up to
// 2^LG * K neighbours), STEPS = log2(2^LG * K) + 1 steps of the search.
template <int LG, int K, int STEPS>
__device__ __forceinline__ void hindex_rows(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
    const int32_t* __restrict__ core, const int32_t* __restrict__ rows,
    int64_t first, int64_t end, int64_t blk, int32_t* __restrict__ out,
    int* __restrict__ changed) {
  constexpr int kLanes = 1 << LG;
  const int64_t r = first + blk * (kThreads >> LG) + (threadIdx.x >> LG);
  const int gl = threadIdx.x & (kLanes - 1);
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
  for (int s = 0; s < STEPS; ++s) {
    const int mid = (lo + hi + 1) >> 1;
    int c = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) c += vals[k] >= mid;
#pragma unroll
    for (int o = kLanes >> 1; o > 0; o >>= 1) {
      c += __shfl_xor_sync(kFullMask, c, o);
    }
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
  if ((threadIdx.x & 31) == 0 && ch != 0) atomicAdd(changed, __popc(ch));
}

__global__ void __launch_bounds__(kThreads)
hindex_rows_kernel(const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ col,
                   const int32_t* __restrict__ core,
                   const int32_t* __restrict__ rows,
                   const __grid_constant__ Classes cls,
                   int32_t* __restrict__ out, int* __restrict__ changed) {
  const int64_t blk = blockIdx.x;
  if (blk < cls.block_start[1]) {
    hindex_rows<2, 4, 5>(row_ptr, col, core, rows, cls.start[0], cls.start[1],
                         blk - cls.block_start[0], out, changed);
  } else if (blk < cls.block_start[2]) {
    hindex_rows<5, 4, 8>(row_ptr, col, core, rows, cls.start[1], cls.start[2],
                         blk - cls.block_start[1], out, changed);
  } else {
    hindex_rows<5, 32, 11>(row_ptr, col, core, rows, cls.start[2],
                           cls.start[3], blk - cls.block_start[2], out,
                           changed);
  }
}

// One hub row a block; `cap` values of it in shared memory.
__global__ void __launch_bounds__(kHubThreads)
hindex_hub_kernel(const int32_t* __restrict__ row_ptr,
                  const int32_t* __restrict__ col,
                  const int32_t* __restrict__ core,
                  const int32_t* __restrict__ hubs, int cap,
                  int32_t* __restrict__ out, int* __restrict__ changed) {
  extern __shared__ int32_t vals[];
  __shared__ int warp_counts[kHubThreads / 32];
  const int32_t v = __ldg(hubs + blockIdx.x);
  const int32_t begin = __ldg(row_ptr + v);
  const int d = __ldg(row_ptr + v + 1) - begin;
  const int32_t cv = __ldg(core + v);
  const int32_t* nbr = col + static_cast<int64_t>(begin);
  const int held = min(d, cap);
  for (int j = threadIdx.x; j < held; j += kHubThreads) {
    vals[j] = __ldg(core + __ldg(nbr + j));
  }
  __syncthreads();
  int lo = 0;
  int hi = min(d, cv);
  while (lo < hi) {  // lo and hi are the same in every thread
    const int mid = (lo + hi + 1) >> 1;
    int c = 0;
    for (int j = threadIdx.x; j < d; j += kHubThreads) {
      c += (j < held ? vals[j] : __ldg(core + __ldg(nbr + j))) >= mid;
    }
    c = __reduce_add_sync(kFullMask, c);
    if ((threadIdx.x & 31) == 0) warp_counts[threadIdx.x >> 5] = c;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kHubThreads / 32; ++w) total += warp_counts[w];
    __syncthreads();  // every thread has read the counts of this step
    if (total >= mid) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  if (threadIdx.x == 0) {
    out[v] = lo;
    if (lo != cv) atomicAdd(changed, 1);
  }
}

}  // namespace

// row_ptr (nv + 1,) and col_idx (ne,) int32: a symmetric graph's CSR. core
// and out (nv,) int32, out written in every row. rows (nv,) int32: every
// vertex once, ordered by class; class_start (5,) host int64: the rows of
// class c (c < 3: up to 16, 128 and 1024 neighbours) are
// rows[class_start[c], class_start[c + 1]), the hubs (more than 1024) follow
// up to class_start[4] = nv. hub_width: the most neighbours of a hub (0
// without hubs). changed: one device int32, set to 0 here, then the count of
// rows whose value changed. Every pointer but class_start on CUDA device
// `device`, stream a cudaStream_t of that device. The library links its own
// CUDA runtime, so the entry selects `device` before launching. Returns the
// first CUDA error (0 on success), allocates nothing and does not
// synchronise.
extern "C" int gab_hindex_sweep(const void* row_ptr, const void* col_idx,
                                const void* core, const void* rows,
                                const int64_t* class_start, int64_t hub_width,
                                void* out, void* changed, int device,
                                void* stream) {
  Classes cls{};
  int64_t blocks = 0;
  constexpr int kLgLanes[kClasses] = {2, 5, 5};
  for (int c = 0; c < kClasses; ++c) {
    const int64_t n = class_start[c + 1] - class_start[c];
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    cls.start[c] = class_start[c];
    cls.block_start[c] = blocks;
    const int64_t per_block = kThreads >> kLgLanes[c];
    blocks += (n + per_block - 1) / per_block;
  }
  cls.start[kClasses] = class_start[kClasses];
  cls.block_start[kClasses] = blocks;
  const int64_t n_hubs = class_start[kClasses + 1] - class_start[kClasses];
  if (n_hubs < 0 || blocks > 0x7fffffff || n_hubs > 0x7fffffff ||
      (n_hubs > 0 && hub_width <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(changed, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int32_t* rp = static_cast<const int32_t*>(row_ptr);
  const int32_t* ci = static_cast<const int32_t*>(col_idx);
  const int32_t* cr = static_cast<const int32_t*>(core);
  const int32_t* order = static_cast<const int32_t*>(rows);
  int32_t* o = static_cast<int32_t*>(out);
  int* ch = static_cast<int*>(changed);
  if (blocks > 0) {
    hindex_rows_kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                         0, s>>>(rp, ci, cr, order, cls, o, ch);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_hubs > 0) {
    const int cap = static_cast<int>(hub_width < kHubCap ? hub_width : kHubCap);
    const int smem = cap * static_cast<int>(sizeof(int32_t));
    err = cudaFuncSetAttribute(hindex_hub_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    hindex_hub_kernel<<<dim3(static_cast<unsigned>(n_hubs)),
                        dim3(kHubThreads), smem, s>>>(
        rp, ci, cr, order + class_start[kClasses], cap, o, ch);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
