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
// counts them: sum over b in N+(v) of #{a in N+(u) : a == b}.
//
// What bounds it on this card: the bytes and compares it needs are few (the
// edge list, the DAG's ids and row pointers: 97 MB on rmat(19, 16), 0.029 ms
// at 3.35 TB/s), but every edge reads two rows at random places. A binary
// search of one row in the other from device memory waits on each load
// before the next (the first design: a lane group an edge, 0.85% of the
// bound), so the kernel lives on how many loads it keeps in flight and how
// many of them depend on each other.
//
// What the design does about it (the vertex-centric hashing of GPU
// counters such as TRUST): a lane group takes a task, up to 32 edges (u, v)
// of one destination v (the wrapper lays the edges out by destination, on
// the card). It builds a hash table of N+(v) once in shared memory (16
// slots a lane, at most half full, linear probing; a repeated id is an
// entry of its own), and then streams the rows N+(u) of the task's sources
// as one run of ids: the lanes take consecutive ids of the concatenated
// rows, so the loads are coalesced and independent of each other, and each
// id probes the table, counting every equal entry, about 1.4 probes an id
// at a quarter full. A lane finds the edge of its id from the group's
// prefix of row lengths, held a lane an edge, by a ballot, a reduction and
// two popcounts. Grouping by destination streams sum over edges of
// |N+(u)| ids, 40% fewer than by source on rmat(17, 16) (52.8 M against
// 88.0 M). A destination wider than its group's table (more than 8 ids a
// lane) is binary-searched where it lies, in device memory (through L1;
// exact all the same). The group's size follows the task's work, the ids
// it streams: 32 lanes above 256, 16 above 64, 8 above 16, else 4; the
// heaviest class's blocks come first in the one launch, so that they are
// not the last to start. A warp adds its lanes' counts with one reduction
// and one 64-bit atomic, so the total reaches the billions of the
// reference's goldens.
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
// classes of tasks: class c takes 32 >> c lanes a task (log2 lanes 5 - c)
constexpr int kClasses = 4;
// hash slots a lane of the group; a row of up to half as many ids is hashed
constexpr int kSlots = 16;
constexpr int32_t kEmpty = -1;
constexpr uint32_t kHashMul = 0x9E3779B1u;

// The tasks of class c are [start[c], start[c + 1]) of the task list; its
// blocks are [block_start[c], block_start[c + 1]).
struct Classes {
  int64_t start[kClasses + 1];
  int64_t block_start[kClasses + 1];
};

// The ids of the task's sources' rows N+(u), edges [e0, e1), looked up in
// N+(v): in the hash table `table` of 2^bits slots, or (bits == 0) by a
// binary search of b[0, nb), the row in device memory, `top` the largest
// power of two not above nb. Returns the lane's count of equal pairs.
template <int LG>
__device__ __forceinline__ unsigned stream_rows(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
    const int32_t* __restrict__ src, int32_t e0, int32_t e1,
    const int32_t* table, int bits, const int32_t* __restrict__ b, int nb,
    int top, unsigned gmask) {
  constexpr int kLanes = 1 << LG;
  const int gl = threadIdx.x & (kLanes - 1);
  const unsigned tmask = (1u << bits) - 1u;
  unsigned cnt = 0;
  for (int32_t c = e0; c < e1; c += kLanes) {
    const int32_t e = c + gl;
    int32_t ub = 0;
    int un = 0;
    if (e < e1) {
      const int32_t u = __ldg(src + e);
      ub = __ldg(row_ptr + u);
      un = __ldg(row_ptr + u + 1) - ub;
    }
    // the group's prefix of row lengths: lane k's row is the ids
    // [excl_k, excl_k + un_k) of the run (every row of a task is
    // non-empty, the lanes past the task's edges are empty)
    int incl = un;
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) {
      const int y = __shfl_up_sync(gmask, incl, o, kLanes);
      if (gl >= o) incl += y;
    }
    const int total = __shfl_sync(gmask, incl, kLanes - 1, kLanes);
    const int excl = incl - un;
    for (int base = 0; base < total; base += kLanes) {
      // the edge of the run's id base + gl: the rows begun by base, then
      // those begun inside the window up to the lane
      const int begun = __popc(__ballot_sync(gmask, un > 0 && excl <= base) &
                               gmask);
      const unsigned starts = __reduce_or_sync(
          gmask, un > 0 && excl > base && excl < base + kLanes
                     ? 1u << (excl - base) : 0u);
      const int k = begun - 1 + __popc(starts & ((2u << gl) - 1u));
      const int32_t kb = __shfl_sync(gmask, ub, k, kLanes);
      const int kex = __shfl_sync(gmask, excl, k, kLanes);
      const int i = base + gl;
      if (i < total) {
        const int32_t x = __ldg(col + static_cast<int64_t>(kb) + (i - kex));
        if (bits > 0) {
          unsigned p = (static_cast<uint32_t>(x) * kHashMul) >> (32 - bits);
          for (int32_t y; (y = table[p]) != kEmpty; p = (p + 1) & tmask) {
            cnt += y == x;
          }
        } else {
          int p = 0;  // ids of b below x
          for (int s = top; s > 0; s >>= 1) {
            if (p + s <= nb && __ldg(b + p + s - 1) < x) p += s;
          }
          for (; p < nb && __ldg(b + p) == x; ++p) ++cnt;
        }
      }
    }
  }
  return cnt;
}

// One class of tasks: 2^LG lanes a task, kSlots * 2^LG hash slots.
template <int LG>
__device__ __forceinline__ unsigned count_tasks(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ col,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ tasks, int64_t first, int64_t end,
    int64_t blk, int32_t* slots_all) {
  constexpr int kLanes = 1 << LG;
  constexpr int kTable = kSlots << LG;
  const int64_t t = first + blk * (kThreads >> LG) + (threadIdx.x >> LG);
  if (t >= end) return 0;  // the same in the whole group
  const int gl = threadIdx.x & (kLanes - 1);
  const int lane = threadIdx.x & 31;
  const unsigned gmask =
      kLanes == 32 ? kFullMask
                   : ((1u << (kLanes & 31)) - 1u) << (lane & ~(kLanes - 1));
  int32_t* table = slots_all + (threadIdx.x & ~(kLanes - 1)) * kSlots;
  const int32_t e0 = __ldg(tasks + t);
  const int32_t e1 = __ldg(tasks + t + 1);
  const int32_t v = __ldg(dst + e0);
  const int32_t vb = __ldg(row_ptr + v);
  const int nb = __ldg(row_ptr + v + 1) - vb;
  const int32_t* b = col + static_cast<int64_t>(vb);
  int bits = 0;
  if (nb <= kTable / 2) {
    // at most a quarter full where the group's slots allow: 4 nb slots
    // rounded up to a power of two
    bits = min(32 - __clz(4 * nb - 1), LG + 4);
    const unsigned tmask = (1u << bits) - 1u;
    for (int j = gl; j <= static_cast<int>(tmask); j += kLanes) {
      table[j] = kEmpty;
    }
    __syncwarp(gmask);
    for (int j = gl; j < nb; j += kLanes) {
      const int32_t x = __ldg(b + j);
      unsigned p = (static_cast<uint32_t>(x) * kHashMul) >> (32 - bits);
      while (atomicCAS(table + p, kEmpty, x) != kEmpty) p = (p + 1) & tmask;
    }
    __syncwarp(gmask);
  }
  const int top = nb > 0 ? 1 << (31 - __clz(nb)) : 0;
  return stream_rows<LG>(row_ptr, col, src, e0, e1, table, bits, b, nb, top,
                         gmask);
}

__global__ void __launch_bounds__(kThreads)
tc_count_kernel(const int32_t* __restrict__ row_ptr,
                const int32_t* __restrict__ col,
                const int32_t* __restrict__ src,
                const int32_t* __restrict__ dst,
                const int32_t* __restrict__ tasks,
                const __grid_constant__ Classes cls,
                unsigned long long* __restrict__ total) {
  __shared__ int32_t slots[kThreads * kSlots];
  const int64_t blk = blockIdx.x;
  unsigned cnt;
  if (blk < cls.block_start[1]) {
    cnt = count_tasks<5>(row_ptr, col, src, dst, tasks, cls.start[0],
                         cls.start[1], blk - cls.block_start[0], slots);
  } else if (blk < cls.block_start[2]) {
    cnt = count_tasks<4>(row_ptr, col, src, dst, tasks, cls.start[1],
                         cls.start[2], blk - cls.block_start[1], slots);
  } else if (blk < cls.block_start[3]) {
    cnt = count_tasks<3>(row_ptr, col, src, dst, tasks, cls.start[2],
                         cls.start[3], blk - cls.block_start[2], slots);
  } else {
    cnt = count_tasks<2>(row_ptr, col, src, dst, tasks, cls.start[3],
                         cls.start[4], blk - cls.block_start[3], slots);
  }
  cnt = __reduce_add_sync(kFullMask, cnt);
  if ((threadIdx.x & 31) == 0 && cnt != 0) {
    atomicAdd(total, static_cast<unsigned long long>(cnt));
  }
}

}  // namespace

// row_ptr (nv + 1,) and col_idx (ne,) int32: the DAG's CSR, rows sorted
// ascending. src and dst (P,) int32: the DAG edges to count, both rows
// non-empty, each task's edges one run of one destination. tasks (T + 1,)
// int32: task t is the edges [tasks[t], tasks[t + 1]), at most 32 of them; the
// tasks are ordered by class, and class_start (5,) host int64 gives the
// tasks of class c (32 >> c lanes a task) as [class_start[c],
// class_start[c + 1]). total: one device uint64, set to 0 here and then
// added to. Every pointer but class_start on CUDA device `device`, stream a
// cudaStream_t of that device. The library links its own CUDA runtime, so
// the entry selects `device` before launching. Returns the first CUDA error
// (0 on success), allocates nothing and does not synchronise.
extern "C" int gab_tc_count(const void* row_ptr, const void* col_idx,
                            const void* src, const void* dst,
                            const void* tasks, const int64_t* class_start,
                            void* total, int device, void* stream) {
  Classes cls{};
  int64_t blocks = 0;
  for (int c = 0; c < kClasses; ++c) {
    const int64_t n = class_start[c + 1] - class_start[c];
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    cls.start[c] = class_start[c];
    cls.block_start[c] = blocks;
    const int64_t per_block = kThreads >> (5 - c);
    blocks += (n + per_block - 1) / per_block;
  }
  cls.start[kClasses] = class_start[kClasses];
  cls.block_start[kClasses] = blocks;
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
                           static_cast<const int32_t*>(dst),
                           static_cast<const int32_t*>(tasks), cls,
                           static_cast<unsigned long long*>(total));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
