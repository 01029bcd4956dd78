// K11, the decode of the byte codecs (StreamVByte and VarintGB) on the card,
// for Hopper (built for sm_90a by graphaibench_tpu_torch/ops/_build.py and
// bound with ctypes; the wrappers and the plain PyTorch versions are in
// graphaibench_tpu_torch/ops/vbyte_decode.py).
//
// It replaces the XLA programs of graphaibench_tpu/compress/device_decode.py:
//
//   svb_decode  streamvbyte_decode_device (:47), and the sub-decode and
//               scatter of decode_hybrid_device's high-degree rows
//               (:474-486)
//   vgb_tags    _vgb_tag_chain (:207)
//   vgb_values  _vgb_flat_values (:249)
//
// StreamVByte, a row of n ids: ceil(n / 4) key bytes, four 2-bit byte lengths
// (minus one) a byte, least significant first; then the values, 1 to 4 bytes
// each, little-endian; each value the gap to the previous id (the first id
// itself). VarintGB: groups of four values, each a tag byte of four 2-bit
// lengths and then its four values; a row's last group is padded with zeros
// to four values, so a group's length (5 plus its four codes) is a function
// of its tag alone, but where a group starts depends on every group before
// it in the row.
//
// What bounds them: bytes. Each reads its stream bytes once and writes its
// output once, with a few integer operations a value; at rmat(19, 16) about
// 33 MB of stream and 63 MB of ids. What the design does (it computes what
// the JAX programs compute, not in their shape): JAX finds each value's
// owner, offset and delta base by scatters and prefix sums over every edge,
// because XLA has no loop that carries a sum; here a row's prefix sums are
// the loop's carry.
//
// - svb_decode: a warp a row, 32 values a step. A lane reads its key byte and
//   its length; a warp scan of the lengths gives each value's byte offset
//   within the step, and a second scan of the gaps gives the ids; the last
//   lane's sums carry to the next step.
// - vgb_tags: a thread a row walks the row's tag chain, one dependent byte
//   load a group, and records each tag's position. The chain is serial, so
//   the widest row (25,058 ids, 6,265 groups, at rmat(19, 16)) sets the
//   kernel's time.
// - vgb_values: a warp a row, a lane a group: the lane reads its tag and four
//   values (a prefix within the group), a warp scan of the group sums gives
//   the prefix across the row's groups; ids past the row's count are dropped.
//
// Every byte read is clamped to the stream, so a stream that does not parse
// reads nothing outside it, and the plain versions, which clamp the same
// way, give the same values; sums are taken modulo 2^32 and stored as int32.
// A slot outside the output is not written.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Bytes {
  const uint8_t* p;
  int64_t n;  // at least 1
};

__device__ __forceinline__ uint32_t byte_at(const Bytes& s, int64_t i) {
  i = i < 0 ? 0 : (i >= s.n ? s.n - 1 : i);
  return __ldg(s.p + i);
}

// The little-endian value of the len (0..4) bytes at o.
__device__ __forceinline__ uint32_t read_le(const Bytes& s, int64_t o,
                                            int len) {
  uint32_t v = 0;
  for (int k = 0; k < len; ++k) v |= byte_at(s, o + k) << (8 * k);
  return v;
}

// The inclusive prefix sum of x over the warp's lanes, modulo 2^32.
__device__ __forceinline__ uint32_t warp_prefix(uint32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
svb_decode_kernel(const Bytes s, const int32_t* __restrict__ key_start,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ out_slot, int64_t rows,
                  int32_t* __restrict__ col, int64_t ncol) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t ks = __ldg(key_start + r);
  const int64_t n = __ldg(counts + r);
  const int64_t slot0 = __ldg(out_slot + r);
  int64_t data = ks + ((n + 3) >> 2);
  uint32_t carry = 0;
  for (int64_t c = 0; c < n; c += 32) {
    const int64_t i = c + lane;
    const bool valid = i < n;
    int len = 0;
    if (valid) {
      const uint32_t key = byte_at(s, ks + (i >> 2));
      len = static_cast<int>((key >> ((i & 3) * 2)) & 3) + 1;
    }
    const uint32_t end = warp_prefix(static_cast<uint32_t>(len), lane);
    const uint32_t gap = read_le(s, data + end - len, len);
    const uint32_t id = carry + warp_prefix(gap, lane);
    const int64_t slot = slot0 + i;
    if (valid && slot >= 0 && slot < ncol) {
      col[slot] = static_cast<int32_t>(id);
    }
    data += __shfl_sync(kFull, end, 31);
    carry = __shfl_sync(kFull, id, 31);
  }
}

__global__ void __launch_bounds__(kThreads)
vgb_tags_kernel(const Bytes s, const int32_t* __restrict__ pos,
                const int32_t* __restrict__ ngroups,
                const int32_t* __restrict__ gbase, int64_t rows,
                int32_t* __restrict__ tagpos, int64_t n_g) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  int64_t p = __ldg(pos + r);
  const int64_t ng = __ldg(ngroups + r);
  const int64_t g0 = __ldg(gbase + r);
  for (int64_t j = 0; j < ng; ++j) {
    const int64_t slot = g0 + j;
    if (slot >= 0 && slot < n_g) tagpos[slot] = static_cast<int32_t>(p);
    const uint32_t t = byte_at(s, p);
    p += 5 + (t & 3) + ((t >> 2) & 3) + ((t >> 4) & 3) + (t >> 6);
  }
}

__global__ void __launch_bounds__(kThreads)
vgb_values_kernel(const Bytes s, const int32_t* __restrict__ tagpos,
                  int64_t n_g, const int32_t* __restrict__ gbase,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ out_slot, int64_t rows,
                  int32_t* __restrict__ col, int64_t ncol) {
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int64_t n = __ldg(counts + r);
  const int64_t g0 = __ldg(gbase + r);
  const int64_t slot0 = __ldg(out_slot + r);
  const int64_t ng = (n + 3) >> 2;
  uint32_t carry = 0;
  for (int64_t c = 0; c < ng; c += 32) {
    const int64_t j = c + lane;
    uint32_t v[4] = {0, 0, 0, 0};   // the prefix within the group
    if (j < ng) {
      const int64_t gi = g0 + j;
      int64_t o = (gi >= 0 && gi < n_g) ? __ldg(tagpos + gi) : 0;
      const uint32_t t = byte_at(s, o);
      ++o;
      uint32_t acc = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int len = static_cast<int>((t >> (2 * k)) & 3) + 1;
        acc += read_le(s, o, len);
        o += len;
        v[k] = acc;
      }
    }
    const uint32_t incl = warp_prefix(v[3], lane);
    const uint32_t base = carry + incl - v[3];
    if (j < ng) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t e = 4 * j + k;
        const int64_t slot = slot0 + e;
        if (e < n && slot >= 0 && slot < ncol) {
          col[slot] = static_cast<int32_t>(base + v[k]);
        }
      }
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
}

unsigned blocks_for(int64_t n, int64_t per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

bool bad_grid(int64_t n, int64_t per_block) {
  return n < 0 || (n + per_block - 1) / per_block > 0x7fffffff;
}

}  // namespace

// Common to every entry: the stream is `bytes` (nbytes of them, at least 1),
// every other array int32, all on CUDA device `device`; `stream` a
// cudaStream_t of that device. The library links its own CUDA runtime, so
// each entry selects `device` before launching. Each returns the first CUDA
// error (0 on success), allocates nothing and does not synchronise; with no
// rows it launches nothing.

// col[out_slot[r] + i] for i < counts[r]: row r's ids, its key bytes from
// byte key_start[r] and its values right after them.
extern "C" int gab_svb_decode(const void* bytes, int64_t nbytes,
                              const void* key_start, const void* counts,
                              const void* out_slot, int64_t rows, void* col,
                              int64_t ncol, int device, void* stream) {
  if (nbytes < 1 || bad_grid(rows, kWarpsPerBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    svb_decode_kernel<<<blocks_for(rows, kWarpsPerBlock), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        Bytes{static_cast<const uint8_t*>(bytes), nbytes},
        static_cast<const int32_t*>(key_start),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(out_slot), rows,
        static_cast<int32_t*>(col), ncol);
  }
  return static_cast<int>(cudaGetLastError());
}

// tagpos[gbase[r] + j] for j < ngroups[r]: the byte of row r's j-th tag, the
// first at byte pos[r].
extern "C" int gab_vgb_tags(const void* bytes, int64_t nbytes,
                            const void* pos, const void* ngroups,
                            const void* gbase, int64_t rows, void* tagpos,
                            int64_t n_g, int device, void* stream) {
  if (nbytes < 1 || bad_grid(rows, kThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    vgb_tags_kernel<<<blocks_for(rows, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        Bytes{static_cast<const uint8_t*>(bytes), nbytes},
        static_cast<const int32_t*>(pos), static_cast<const int32_t*>(ngroups),
        static_cast<const int32_t*>(gbase), rows,
        static_cast<int32_t*>(tagpos), n_g);
  }
  return static_cast<int>(cudaGetLastError());
}

// col[out_slot[r] + i] for i < counts[r]: row r's ids from its groups
// gbase[r] .. gbase[r] + ceil(counts[r] / 4), whose tags are at tagpos (n_g).
extern "C" int gab_vgb_values(const void* bytes, int64_t nbytes,
                              const void* tagpos, int64_t n_g,
                              const void* gbase, const void* counts,
                              const void* out_slot, int64_t rows, void* col,
                              int64_t ncol, int device, void* stream) {
  if (nbytes < 1 || bad_grid(rows, kWarpsPerBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0) {
    vgb_values_kernel<<<blocks_for(rows, kWarpsPerBlock), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        Bytes{static_cast<const uint8_t*>(bytes), nbytes},
        static_cast<const int32_t*>(tagpos), n_g,
        static_cast<const int32_t*>(gbase),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(out_slot), rows,
        static_cast<int32_t*>(col), ncol);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
