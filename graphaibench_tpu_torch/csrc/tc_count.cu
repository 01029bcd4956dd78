// K9, the DAG intersection count of triangle counting, for Hopper (built for
// sm_90a by graphaibench_tpu_torch/ops/_build.py and bound with ctypes; the
// wrapper and the plain PyTorch version are in
// graphaibench_tpu_torch/ops/tc_count.py).
//
// It replaces graphaibench_tpu/analytics/tc.py::_count_group, an XLA program
// of the JAX package that answers a chunk of DAG edges by compare-all over
// two sentinel-padded rows:
//
//   total = sum over DAG edges (u, v) of |N+(u) ∩ N+(v)|
//
// with N+ the out-neighbours of the degree-ordered DAG (each triangle counted
// once), and repeated ids counted with their multiplicity, as compare-all
// counts them: sum over a in N+(u) of #{b in N+(v) : b == a}.
//
// What bounds it on this card: neither bytes nor operations but latency of
// dependent gathers. The compulsory traffic is the edge list (8 bytes an
// edge), the DAG's ids (4 an edge) and row pointers (4 a vertex): 97 MB on
// rmat(19, 16), 0.029 ms at 3.35 TB/s; the binary searches need about
// sum over edges of min(a, b) * log2(max(a, b)) compares, some 0.6 G there.
// But every edge reads two rows at random places, and each step of a binary
// search waits on the load before it: the kernel lives on the number of
// loads in flight.
//
// What the design does about it (the reference's GPU shape,
// bs_warp_edge.cuh): a group of lanes takes one DAG edge, walks the shorter
// of the two rows, a lane an id, and binary-searches each id in the longer
// row, so that a group has as many independent searches in flight as it has
// lanes. The group's size follows the shorter row's length (4, 8, 16 or 32
// lanes, the GPU's counterpart of the JAX package's pow2 grouping by degree):
// the wrapper orders the edges by group once per graph, and one launch
// covers every group, a block finding its group from a prefix of block
// counts. Edges whose shorter row is empty are left out by the wrapper. A
// warp adds its lanes' counts with one reduction and one 64-bit atomic, so
// the total reaches the billions of the reference's goldens.
//
// The rows must be sorted: the wrapper sorts the DAG's rows on the host when
// they are not (compare-all does not need it).
//
// Addresses are computed in 64 bits; ids and row pointers are int32 (the DAG
// has fewer than 2^31 edges: the wrapper checks).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFullMask = 0xffffffffu;
// lane groups of 4, 8, 16 and 32 lanes an edge: log2 lanes = 2 + group
constexpr int kGroups = 4;

// The edges of group g are [start[g], start[g + 1]) of the edge list; its
// blocks are [block_start[g], block_start[g + 1]).
struct Segments {
  int64_t start[kGroups + 1];
  int64_t block_start[kGroups + 1];
};

// The first position of the sorted row b[0, n) whose id is not below x.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ b,
                                           int n, int32_t x) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(b + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
tc_count_kernel(const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col,
                const int32_t* __restrict__ src,
                const int32_t* __restrict__ dst,
                const __grid_constant__ Segments seg,
                unsigned long long* __restrict__ total) {
  const int64_t blk = blockIdx.x;
  int g = 0;
  while (g + 1 < kGroups && blk >= seg.block_start[g + 1]) ++g;
  const int lg = 2 + g;
  const int lanes = 1 << lg;
  const int64_t e = seg.start[g] +
                    (blk - seg.block_start[g]) * (kThreads >> lg) +
                    (threadIdx.x >> lg);
  const int gl = threadIdx.x & (lanes - 1);
  unsigned cnt = 0;
  if (e < seg.start[g + 1]) {
    const int32_t u = __ldg(src + e);
    const int32_t v = __ldg(dst + e);
    const int32_t ub = __ldg(row_ptr + u);
    const int32_t ua = __ldg(row_ptr + u + 1) - ub;
    const int32_t vb = __ldg(row_ptr + v);
    const int32_t va = __ldg(row_ptr + v + 1) - vb;
    const bool u_short = ua <= va;
    const int32_t* a = col + static_cast<int64_t>(u_short ? ub : vb);
    const int32_t* b = col + static_cast<int64_t>(u_short ? vb : ub);
    const int na = u_short ? ua : va;
    const int nb = u_short ? va : ua;
    for (int i = gl; i < na; i += lanes) {
      const int32_t x = __ldg(a + i);
      for (int k = lower_bound(b, nb, x); k < nb && __ldg(b + k) == x; ++k) {
        ++cnt;
      }
    }
  }
  cnt = __reduce_add_sync(kFullMask, cnt);
  if ((threadIdx.x & 31) == 0 && cnt != 0) {
    atomicAdd(total, static_cast<unsigned long long>(cnt));
  }
}

}  // namespace

// row_ptr (nv + 1,) and col_idx (ne,) int32: the DAG's CSR, rows sorted
// ascending. src and dst (P,) int32: the DAG edges to count, ordered by lane
// group; group_start (5,) host int64: the edges of group g (4 << g lanes an
// edge) are [group_start[g], group_start[g + 1]). total: one device uint64,
// set to 0 here and then added to. Every pointer but group_start on CUDA
// device `device`, stream a cudaStream_t of that device. The library links
// its own CUDA runtime, so the entry selects `device` before launching.
// Returns the first CUDA error (0 on success), allocates nothing and does not
// synchronise.
extern "C" int gab_tc_count(const void* row_ptr, const void* col_idx,
                            const void* src, const void* dst,
                            const int64_t* group_start, void* total,
                            int device, void* stream) {
  Segments seg{};
  int64_t blocks = 0;
  for (int g = 0; g < kGroups; ++g) {
    const int64_t n = group_start[g + 1] - group_start[g];
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    seg.start[g] = group_start[g];
    seg.block_start[g] = blocks;
    const int64_t per_block = kThreads >> (2 + g);
    blocks += (n + per_block - 1) / per_block;
  }
  seg.start[kGroups] = group_start[kGroups];
  seg.block_start[kGroups] = blocks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(total, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks > 0) {
    tc_count_kernel<<<dim3(static_cast<unsigned>(blocks)), dim3(kThreads), 0,
                      s>>>(static_cast<const int32_t*>(row_ptr),
                           static_cast<const int32_t*>(col_idx),
                           static_cast<const int32_t*>(src),
                           static_cast<const int32_t*>(dst), seg,
                           static_cast<unsigned long long*>(total));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
