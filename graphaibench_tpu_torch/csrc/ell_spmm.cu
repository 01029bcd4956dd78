// K1: the weighted ELL gather-reduce (SpMM) of one degree bucket, for
// Hopper (built for sm_90a by graphaibench_tpu_torch/ops/_build.py and
// bound with ctypes; the wrapper is graphaibench_tpu_torch/ops/ell_spmm.py).
//
// Replaces graphaibench_tpu/ops/pallas_spmm.py::_bucket_kernel, the Pallas
// TPU kernel that _run_bucket / spmm_ell_pallas launch once per bucket.
// For a bucket of width W with R virtual rows:
//
//     out[row_ids[r], :] += sum_{j < W} w[r*W + j] * x[nbr[r*W + j], :]
//
// Pad slots carry nbr 0 and weight 0, so they add nothing. Rows wider than
// the split (64) are cut into several virtual rows that target the same
// output row, in the width-64 bucket and again in a narrower bucket for
// the remainder, so the add into `out` is an atomicAdd: a plain store
// would keep only one piece. The wrapper zeroes `out` once and launches
// this kernel once per bucket on the current stream.
//
// What bounds it on this card: gathered rows of x. A call reads about
// slots * F * 4 B of x, slots * 8 B of ids and weights, and writes
// nv * F * 4 B. The GCN main path (rmat17 with self-loops) has 4.72 M
// slots; x at F = 128 is 64 MB, larger than the 50 MB L2, so the gathers
// of the first layer go to HBM at random rows.
//
// The design is the simple one: one warp per virtual row, lanes over the
// features (f = lane; f < F; f += 32), the W-long sum kept in a register,
// then one atomicAdd per output element. It does nothing yet about the
// bound: x is not staged in shared memory, F = 16 leaves half the lanes
// idle, every virtual row pays an atomic, and each bucket is its own
// launch. Later work: pack several narrow rows per warp, vector (16 B)
// loads, one launch over all buckets, atomics only for split rows, and
// reordering rows for L2 reuse of x.
//
// Addresses are computed in 64 bits: nbr * F fits int32 at rmat17 but not
// at products scale with wide F.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_bucket_kernel(const int32_t* __restrict__ row_ids,
                  const int32_t* __restrict__ nbr,
                  const float* __restrict__ w,
                  const float* __restrict__ x,
                  float* __restrict__ out,
                  int64_t rows, int width, int64_t f) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t slot0 = r * width;
  float* dst = out + static_cast<int64_t>(row_ids[r]) * f;
  for (int64_t c = lane; c < f; c += 32) {
    float acc = 0.0f;
    for (int j = 0; j < width; ++j) {
      const float wj = w[slot0 + j];
      const int64_t src = static_cast<int64_t>(nbr[slot0 + j]) * f;
      acc += wj * x[src + c];
    }
    atomicAdd(dst + c, acc);
  }
}

}  // namespace

// One bucket: row_ids (rows,) int32, nbr (rows*width,) int32,
// w (rows*width,) f32, x (nv, f) f32 row-major, out (nv, f) f32, all
// pointers on CUDA device `device`; stream is a cudaStream_t of that
// device. The library links its own CUDA runtime, whose current device is
// not the caller's, so the entry selects `device` before launching.
// Returns the first CUDA error (0 on success). Allocates nothing, does not
// synchronise.
extern "C" int gab_ell_spmm_bucket(const void* row_ids, const void* nbr,
                                   const void* w, const void* x, void* out,
                                   int64_t rows, int width, int64_t f,
                                   int device, void* stream) {
  if (rows <= 0 || f <= 0) return 0;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffff || width <= 0) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  ell_bucket_kernel<<<dim3(static_cast<unsigned>(blocks)),
                      dim3(kWarpsPerBlock * 32), 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ids), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<float*>(out), rows, width, f);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
