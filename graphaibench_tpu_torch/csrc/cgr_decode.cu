// K12, the decode of a CGR bit stream on the card, for Hopper (built for
// sm_90a by graphaibench_tpu_torch/ops/_build.py and bound with ctypes; the
// wrappers and the plain PyTorch versions are in
// graphaibench_tpu_torch/ops/cgr_decode.py).
//
// It replaces the XLA programs of graphaibench_tpu/compress/cgr_device.py:
//
//   cgr_gamma     _headers (:139) and _counts (:156), via _read_gamma (:82)
//   cgr_interval  _interval_pass (:163)
//   cgr_residual  _residual_pass (:221), via _read_code_quad (:106) and
//                 _nat2int (:133)
//   cgr_merge     _expand_intervals (:198) and the row sort of
//                 cgr_device_run (:440-442)
//
// A CGR stream is a run of Elias gamma and zeta_k codes, most significant
// bit first (gamma(x): with y = x + 1 and h = floor(log2 y), h zeros, then
// y in h + 1 bits; zeta_k(x): h = floor(log2 y) / k, h zeros and a one, then
// y in (h + 1) k bits). Every closed segment of a vertex's residuals (or
// intervals) is padded to a fixed number of bits, so segment j of a vertex
// starts at a position the host computes from the vertex's header: a
// (vertex, segment) lane decodes its codes alone.
//
// What the design does (it computes what the JAX passes compute, not in
// their shape): the JAX package buckets lanes by code count and pads them
// to powers of two because a lax.scan needs static lengths; here a thread
// is a lane and loops over its own count, and one launch covers every lane.
// cgr_gamma reads one code (two for a header with a degree) at each of its
// positions, four positions a thread where the launch has four for every
// thread the card holds (else one), their windows loaded before any is
// decoded. Its stream reads are set by the data: residual segments' counts
// lie 256 bits apart, a 32-byte sector each, so a launch on every segment
// reads every sector of the residuals once; staging a tile's span in
// shared memory reads the same sectors and, on the card, lost to reading
// the windows directly (PERF.md).
// A lane's codes are serial (where a code starts depends on every code
// before it), but consecutive lanes have consecutive stream bits and
// consecutive output slots. So cgr_residual takes a block a tile of
// consecutive lanes (the prep's table): the tile's span of the stream is
// staged in shared memory (16-byte asynchronous copies), so that a code's
// two 64-bit windows are read from there and not as three loads at each
// lane's own bit position; the tile's lanes are handed to its threads
// largest count first (the table's order), so that a warp's lanes are of
// like length and it does not wait for one long lane; the ids are
// collected in shared memory and stored in order, 16 bytes a store, where
// a thread's own run of ids would have a warp's store touch 32 sectors.
// The count of a segment is bounded by the segment's length (about
// 2 res_seg_len / 3 codes in the merged last segment).
//
// The merge of a row's sorted residuals with its intervals needs no sort
// of the edge array: residual i goes to slot i plus the interval ids below
// it, interval j's ids to the lengths before j plus the residuals below
// its left. The merge is split by output slots, not by rows: a warp takes
// a tile of tile_slots consecutive slots of col, from the row that the
// prep's tile table gives (the rows' slots are consecutive, so a hub
// spreads over many tiles and short rows share one). A tile whose rows
// have no interval holds their residuals where they already lie in the
// residual buffer: a copy, 16 bytes a lane. Otherwise a lane takes every
// 32nd slot of the tile: the slot's row by stepping through the row
// pointers (a binary search past a few steps), then, by its index in the
// row, a residual (the row's first nres ids) or an interval id, and where
// it goes. A lane's slots rise, so
// the intervals below its residual, and the interval that holds its
// interval id, only move forward: a binary search once a row, then a
// linear merge; the residuals below an interval are searched once an
// interval. Consecutive lanes write consecutive ids of a residual run or
// of an interval.

// A 64-bit window at bit p is three big-endian words: the stream is read as
// 32-bit words, byte-swapped with __byte_perm (the bytes are MSB-first),
// and shifted together with __funnelshift_l, which shifts by p & 31 with no
// case for 0 (a C++ shift by 32 is undefined). The host pads the stream by
// 16 bytes, and the word index is clamped to the stream, so no position
// reads outside it; positions advance in 64 bits. A valid code is at most
// 63 bits; on a stream that does not parse (which the host detects after
// the pass, from the final positions, and refuses) the leading-zero count
// is capped at 31 and a code's value bits at 63, so every shift stays
// defined and the plain version, which does the same, gives the same
// values.
//
// Bounds: every pass reads its lanes' stream bits once and writes its
// outputs once; the host's lane tables make every write land inside its
// output (the slots of a lane are base .. base + count - 1, prefix sums of
// the counts; the host refuses a parse with a negative count or an
// interval shorter than min_itv_len, so the rows' slots lie in order).

#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kRowSteps = 4;  // cgr_merge's linear steps to a slot's row

// Kinds of cgr_gamma (ops/cgr_decode.py: COUNT, HEADER, HEADER_DEG).
constexpr int kCount = 0;
constexpr int kHeader = 1;
constexpr int kHeaderDeg = 2;

struct Stream {
  const uint32_t* words;  // raw 32-bit loads of the MSB-first bytes
  int64_t nwords;         // at least 4 (the padding)
};

__device__ __forceinline__ uint32_t be_word(const Stream& s, int64_t i) {
  return __byte_perm(__ldg(s.words + i), 0, 0x0123);
}

// Bits [p, p + 64) as hi:lo.
__device__ __forceinline__ void window(const Stream& s, int64_t p,
                                       uint32_t& hi, uint32_t& lo) {
  int64_t wi = p >> 5;
  wi = wi < 0 ? 0 : (wi > s.nwords - 3 ? s.nwords - 3 : wi);
  const uint32_t w0 = be_word(s, wi);
  const uint32_t w1 = be_word(s, wi + 1);
  const uint32_t w2 = be_word(s, wi + 2);
  const unsigned sh = static_cast<unsigned>(p & 31);
  hi = __funnelshift_l(w1, w0, sh);
  lo = __funnelshift_l(w2, w1, sh);
}

// The first nb (1..63) bits of hi:lo.
__device__ __forceinline__ int64_t first_bits(uint32_t hi, uint32_t lo,
                                              int nb) {
  const uint64_t win = (static_cast<uint64_t>(hi) << 32) | lo;
  return static_cast<int64_t>(win >> (64 - nb));
}

// The zeta_k code (gamma for k = 1) at p: its value, and its length in nb.
__device__ __forceinline__ int64_t read_code(const Stream& s, int64_t p,
                                             int k, int& nbits) {
  uint32_t hi, lo;
  window(s, p, hi, lo);
  int h = __clz(hi);
  h = h > 31 ? 31 : h;
  if (k == 1) {
    const int nb = 2 * h + 1;
    nbits = nb;
    return first_bits(hi, lo, nb) - 1;
  }
  int nb = (h + 1) * k;
  nb = nb > 63 ? 63 : nb;
  uint32_t hi2, lo2;
  window(s, p + h + 1, hi2, lo2);
  nbits = h + 1 + nb;
  return first_bits(hi2, lo2, nb) - 1;
}

// The stream's words with a tile's span of them staged in shared memory:
// words w0 .. w0 + nst at win, byte-swapped (most significant bit first).
struct Staged {
  Stream s;
  const uint32_t* win;
  int64_t w0;
  int64_t nst;
};

// read_code's value and length from the staged words where the four from
// the one holding p lie there (no clamp can apply: they lie inside the
// stream), else read_code's own: the same windows, in one read. The code
// is at most 95 bits (a zero count capped at 31, value bits at 63), and
// the 96 bits from p hold both of read_code's windows.
__device__ __forceinline__ int64_t read_code(const Staged& c, int64_t p,
                                             int k, int& nbits) {
  const int64_t r = (p >> 5) - c.w0;
  if (r < 0 || r + 4 > c.nst) return read_code(c.s, p, k, nbits);
  const uint32_t* w = c.win + r;
  const unsigned sh = static_cast<unsigned>(p & 31);
  const uint32_t a = __funnelshift_l(w[1], w[0], sh);
  const uint32_t b = __funnelshift_l(w[2], w[1], sh);
  int h = __clz(a);
  h = h > 31 ? 31 : h;
  if (k == 1) {
    const int nb = 2 * h + 1;
    nbits = nb;
    return first_bits(a, b, nb) - 1;
  }
  const uint32_t cw = __funnelshift_l(w[3], w[2], sh);
  int nb = (h + 1) * k;
  nb = nb > 63 ? 63 : nb;
  const unsigned s1 = static_cast<unsigned>(h + 1);   // 1..32
  nbits = h + 1 + nb;
  return first_bits(__funnelshift_lc(b, a, s1), __funnelshift_lc(cw, b, s1),
                    nb) - 1;
}

__device__ __forceinline__ int64_t nat2int(int64_t x) {
  return (x & 1) ? -((x + 1) >> 1) : (x >> 1);
}

// cgr_gamma's positions a thread where a launch has enough of them: a warp
// takes 32 * kGammaPer consecutive positions, lane l those at l, l + 32,
// ..., so that each load and store of a warp stays on consecutive positions
// (and, for residual segments' counts 256 bits apart, consecutive lines of
// the stream). A launch of fewer than kGammaPer positions for every thread
// the card holds (kResidentThreads an SM) takes one a thread: four a thread
// would leave SMs idle.
constexpr int kGammaPer = 4;
constexpr int kResidentThreads = 2048;

// The gamma code(s) at PER positions a thread: every position's window
// loaded before any is decoded, PER * 3 independent loads in flight (a
// header with a degree loads its second windows the same way).
template <int PER>
__global__ void __launch_bounds__(kThreads)
cgr_gamma_kernel(const Stream s, const int32_t* __restrict__ pos, int64_t n,
                 int kind, int32_t* __restrict__ value,
                 int32_t* __restrict__ next) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
          32 * PER +
      (threadIdx.x & 31);
  if (i0 >= n) return;
  int64_t p[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int64_t i = i0 + 32 * k;
    p[k] = i < n ? __ldg(pos + i) : 0;
  }
  uint32_t hi[PER], lo[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) window(s, p[k], hi[k], lo[k]);
  int64_t x[PER], q[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    int h = __clz(hi[k]);
    h = h > 31 ? 31 : h;
    x[k] = first_bits(hi[k], lo[k], 2 * h + 1) - 1;
    q[k] = p[k] + 2 * h + 1;
  }
  if (kind == kHeaderDeg) {
#pragma unroll
    for (int k = 0; k < PER; ++k) window(s, q[k], hi[k], lo[k]);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int64_t i = i0 + 32 * k;
    if (i >= n) break;
    if (kind == kCount) {
      value[i] = static_cast<int32_t>(x[k]);
      next[i] = static_cast<int32_t>(q[k]);
    } else if (kind == kHeader) {
      value[i] = static_cast<int32_t>(x[k] + 1);
      next[i] = static_cast<int32_t>(q[k]);
    } else {
      int h = __clz(hi[k]);
      h = h > 31 ? 31 : h;
      const int64_t ns = first_bits(hi[k], lo[k], 2 * h + 1) - 1;
      value[i] = static_cast<int32_t>(x[k] == 0 ? 0 : ns + 1);
      next[i] = static_cast<int32_t>(x[k] == 0 ? q[k] : q[k] + 2 * h + 1);
    }
  }
}

// cgr_residual's work items: a block a tile of consecutive lanes (the
// prep's table: at most kThreads lanes, their ids about kResSlots / 4 * 3),
// the tile's span of the stream (from its first lane's first code to the
// next tile's, at most kResWords words) staged, its ids collected from its
// first lane's first slot on.
constexpr int kResWords = 2048;
constexpr int kResSlots = 4096;

struct ResTile {
  alignas(16) uint32_t win[kResWords];
  alignas(16) int32_t ids[kResSlots];
  alignas(16) uint8_t flag[kResSlots];
  uint8_t done[kThreads];
};

// The collected ids of the slots cbase .. cbase + kResSlots (cbase a
// multiple of 4) whose flags are set, into col: 16 bytes a store where all
// four of an aligned quad are set, else one by one. Every thread takes part.
__device__ __forceinline__ void flush_ids(const int32_t* ids,
                                          const uint8_t* flag, int64_t cbase,
                                          int32_t* __restrict__ col,
                                          int64_t ncol) {
  const bool aligned = (reinterpret_cast<uintptr_t>(col) & 15) == 0;
  for (int i = threadIdx.x; i < kResSlots / 4; i += kThreads) {
    const uint32_t f = reinterpret_cast<const uint32_t*>(flag)[i];
    if (f == 0) continue;
    const int64_t q = cbase + 4 * i;
    if (f == 0x01010101u && aligned && q >= 0 && q + 4 <= ncol) {
      *reinterpret_cast<int4*>(col + q) =
          *reinterpret_cast<const int4*>(ids + 4 * i);
      continue;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (((f >> (8 * k)) & 1u) && q + k >= 0 && q + k < ncol) {
        col[q + k] = ids[4 * i + k];
      }
    }
  }
}

// Lane l's residuals, collected (ids from cbase, flags) where all of its
// slots lie there, else each stored through put; and its final bit.
template <typename Put>
__device__ __forceinline__ void residual_lane(
    const Staged& c, const int32_t* __restrict__ data_p,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ lane_v,
    const int32_t* __restrict__ base, int64_t l, int k, int64_t cbase,
    int32_t* ids, uint8_t* flag, int32_t* __restrict__ pfin, Put put) {
  int64_t p = __ldg(data_p + l);
  const int32_t n = __ldg(counts + l);
  const int64_t v = __ldg(lane_v + l);
  const int64_t b = __ldg(base + l);
  int32_t prev = 0;
  const int64_t rel0 = b - cbase;
  const bool inside = rel0 >= 0 && rel0 + n <= kResSlots;
  for (int32_t i = 0; i < n; ++i) {
    int nb;
    const int64_t x = read_code(c, p, k, nb);
    const int32_t val = static_cast<int32_t>(
        i == 0 ? v + nat2int(x) : static_cast<int64_t>(prev) + x + 1);
    if (inside) {
      ids[rel0 + i] = val;
      flag[rel0 + i] = 1;
    } else {
      put(b + i, val);
    }
    prev = val;
    p += nb;
  }
  pfin[l] = static_cast<int32_t>(p);
}

// A block a tile: lanes tiles[b] .. tiles[b + 1], kThreads a round, thread
// t taking lane order[i] of the round's position i (the prep orders a
// tile's lanes by count, largest first, so that a warp's lanes are of like
// length; an order that names a lane outside the round, or names one
// twice, still leaves no lane out: a lane no thread took is decoded by the
// thread of its position). The codes are read from the staged words, the
// ids collected and stored in order; a word outside the staged span is
// read from the stream, a slot outside the collected span written
// directly: any table is exact, a good one only faster (hybrid's low rows
// have high rows between them, in the stream and in col).
__global__ void __launch_bounds__(kThreads)
cgr_residual_kernel(const Stream s, const int32_t* __restrict__ data_p,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ lane_v,
                    const int32_t* __restrict__ base, int64_t lanes,
                    const int32_t* __restrict__ tiles,
                    const int32_t* __restrict__ order, int k,
                    int32_t* __restrict__ col, int64_t ncol,
                    int32_t* __restrict__ pfin) {
  __shared__ ResTile sm;
  const int t = threadIdx.x;
  int64_t lo = __ldg(tiles + blockIdx.x);
  int64_t hi = __ldg(tiles + blockIdx.x + 1);
  lo = lo < 0 ? 0 : (lo > lanes ? lanes : lo);
  hi = hi > lanes ? lanes : (hi < lo ? lo : hi);
  // the span: whole 16-byte lines from the first lane's first code's word
  // to the next tile's (the last tile: as many as fit)
  const int64_t p0 = lo < hi ? __ldg(data_p + lo) : 0;
  int64_t w0 = p0 >> 5;
  w0 -= w0 & 3;
  const int64_t w1 = hi < lanes ? (static_cast<int64_t>(__ldg(data_p + hi))
                                   >> 5) + 4
                                : w0 + kResWords;
  int64_t nst = w1 - w0;
  nst = nst < 0 ? 0 : (nst > kResWords ? kResWords : nst);
  nst = (nst + 3) & ~int64_t{3};
  if (w0 < 0 || (reinterpret_cast<uintptr_t>(s.words) & 15) != 0) nst = 0;
  if (nst > s.nwords - w0) nst = (s.nwords - w0) & ~int64_t{3};
  for (int i = t; 4 * i < nst; i += kThreads) {
    __pipeline_memcpy_async(sm.win + 4 * i, s.words + w0 + 4 * i, 16);
  }
  __pipeline_commit();
  const int64_t s_lo = lo < hi ? __ldg(base + lo) : 0;
  const int64_t cbase = s_lo - (s_lo & 3);
  for (int i = t; i < kResSlots / 16; i += kThreads) {
    reinterpret_cast<uint4*>(sm.flag)[i] = make_uint4(0, 0, 0, 0);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  // the staged words' bytes swapped once, most significant first
  for (int i = t; i < nst; i += kThreads) {
    sm.win[i] = __byte_perm(sm.win[i], 0, 0x0123);
  }
  const Staged c{s, sm.win, w0, nst};
  auto put = [&](int64_t slot, int32_t val) {
    const int64_t rel = slot - cbase;
    if (rel >= 0 && rel < kResSlots) {
      sm.ids[rel] = val;
      sm.flag[rel] = 1;
    } else if (slot >= 0 && slot < ncol) {
      col[slot] = val;
    }
  };
  for (int64_t r0 = lo; r0 < hi; r0 += kThreads) {
    const int64_t end = hi - r0 < kThreads ? hi : r0 + kThreads;
    const int64_t i = r0 + t;
    sm.done[t] = 0;
    __syncthreads();  // the staged words swapped; the round before checked
    if (i < end) {
      int64_t l = __ldg(order + i);
      l = l >= r0 && l < end ? l : i;
      residual_lane(c, data_p, counts, lane_v, base, l, k, cbase, sm.ids,
                    sm.flag, pfin, put);
      sm.done[l - r0] = 1;
    }
    __syncthreads();
    if (i < end && !sm.done[t]) {
      residual_lane(c, data_p, counts, lane_v, base, i, k, cbase, sm.ids,
                    sm.flag, pfin, put);
    }
  }
  __syncthreads();
  flush_ids(sm.ids, sm.flag, cbase, col, ncol);
}

__global__ void __launch_bounds__(kThreads)
cgr_interval_kernel(const Stream s, const int32_t* __restrict__ data_p,
                    const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ lane_v,
                    const int32_t* __restrict__ base, int64_t lanes,
                    int min_itv_len, int32_t* __restrict__ left,
                    int32_t* __restrict__ length,
                    int32_t* __restrict__ pfin) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (l >= lanes) return;
  int64_t p = __ldg(data_p + l);
  const int32_t n = __ldg(counts + l);
  const int64_t v = __ldg(lane_v + l);
  const int64_t b = __ldg(base + l);
  int32_t prev_left = 0;
  int32_t prev_len = 0;
  for (int32_t i = 0; i < n; ++i) {
    int nb1, nb2;
    const int64_t x1 = read_code(s, p, 1, nb1);
    const int64_t x2 = read_code(s, p + nb1, 1, nb2);
    const int32_t lf = static_cast<int32_t>(
        i == 0 ? v + nat2int(x1)
               : static_cast<int64_t>(prev_left) + prev_len + 1 + x1);
    const int32_t ln = static_cast<int32_t>(x2 + min_itv_len);
    left[b + i] = lf;
    length[b + i] = ln;
    prev_left = lf;
    prev_len = ln;
    p += nb1 + nb2;
  }
  pfin[l] = static_cast<int32_t>(p);
}

// The number of ids of the sorted run a[0, n) below x.
__device__ __forceinline__ int32_t count_below(const int32_t* __restrict__ a,
                                               int32_t n, int32_t x) {
  int32_t lo = 0;
  int32_t hi = n;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The number of entries of the ascending run a[0, n) at most x.
__device__ __forceinline__ int32_t count_at_most(const int32_t* __restrict__ a,
                                                 int32_t n, int64_t x) {
  int32_t lo = 0;
  int32_t hi = n;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
cgr_merge_kernel(const int32_t* __restrict__ res,
                 const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ nres,
                 const int32_t* __restrict__ itv_ptr,
                 const int32_t* __restrict__ left,
                 const int32_t* __restrict__ itv_pre, int64_t nv,
                 const int32_t* __restrict__ tile_row, int64_t n_tiles,
                 int64_t tile_slots, int64_t ne, int32_t* __restrict__ col) {
  const int64_t w =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_tiles) return;
  const int lane = threadIdx.x & 31;
  const int64_t lo = w * tile_slots;
  const int64_t hi = lo + tile_slots < ne ? lo + tile_slots : ne;
  int64_t v = __ldg(tile_row + w);
  int64_t v_last = __ldg(tile_row + w + 1);
  v = v < 0 ? 0 : (v >= nv ? nv - 1 : v);
  v_last = v_last < v ? v : (v_last >= nv ? nv - 1 : v_last);
  if (__ldg(itv_ptr + v_last + 1) == __ldg(itv_ptr + v)) {
    const bool vec = hi - lo == tile_slots && (tile_slots & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(res) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(col) & 15) == 0;
    if (vec) {
      const int4* src = reinterpret_cast<const int4*>(res + lo);
      int4* dst = reinterpret_cast<int4*>(col + lo);
      for (int64_t i = lane; i < tile_slots / 4; i += 32) dst[i] = __ldg(src + i);
    } else {
      for (int64_t s = lo + lane; s < hi; s += 32) col[s] = __ldg(res + s);
    }
    return;
  }
  int64_t rb = __ldg(row_ptr + v);
  int64_t re = __ldg(row_ptr + v + 1);
  bool fresh = true;   // the row's tables are still to be read
  int32_t nr = 0, ib = 0, ni = 0, pb = 0;
  int32_t below = -1;  // the intervals below the lane's last residual
  int32_t held = -1;   // the interval that held its last interval id
  int32_t hleft = 0;   // that interval's left
  int64_t hfirst = 0;  // its first id's index among the row's interval ids
  int64_t hslot = 0;   // its first id's slot
  for (int64_t s = lo + lane; s < hi; s += 32) {
    // the slot's row: a few steps, then a binary search up to v_last (a
    // run of empty rows between two tiles' slots can be long)
    for (int k = 0; k < kRowSteps && s >= re && v + 1 < nv; ++k) {
      ++v;
      rb = re;
      re = __ldg(row_ptr + v + 1);
      fresh = true;
    }
    if (s >= re && v < v_last) {
      int64_t a = v + 1;
      int64_t b = v_last;
      while (a < b) {
        const int64_t mid = (a + b + 1) >> 1;
        if (__ldg(row_ptr + mid) <= s) {
          a = mid;
        } else {
          b = mid - 1;
        }
      }
      v = a;
      rb = __ldg(row_ptr + v);
      re = __ldg(row_ptr + v + 1);
      fresh = true;
    }
    if (s < rb || s >= re) continue;  // tables that disagree
    if (fresh) {
      nr = __ldg(nres + v);
      ib = __ldg(itv_ptr + v);
      ni = __ldg(itv_ptr + v + 1) - ib;
      pb = __ldg(itv_pre + ib);
      below = -1;
      held = -1;
      fresh = false;
    }
    const int64_t e = s - rb;
    if (e < nr) {
      const int32_t r = __ldg(res + s);
      if (below < 0) {
        below = count_below(left + ib, ni, r);
      } else {
        while (below < ni && __ldg(left + ib + below) < r) ++below;
      }
      const int64_t d = rb + e + (__ldg(itv_pre + ib + below) - pb);
      if (d >= 0 && d < ne) col[d] = r;
    } else {
      const int64_t q = e - nr;
      int32_t j = held;
      if (j < 0) {
        j = count_at_most(itv_pre + ib, ni, q + pb) - 1;
      } else {
        while (j + 1 < ni && __ldg(itv_pre + ib + j + 1) - pb <= q) ++j;
      }
      if (j < 0) continue;  // tables that disagree
      if (j != held) {
        held = j;
        hleft = __ldg(left + ib + j);
        hfirst = __ldg(itv_pre + ib + j) - pb;
        hslot = rb + hfirst + count_below(res + rb, nr, hleft);
      }
      const int64_t d = hslot + (q - hfirst);
      if (d >= 0 && d < ne) col[d] = static_cast<int32_t>(hleft + (q - hfirst));
    }
  }
}

unsigned blocks_for(int64_t n, int64_t per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

bool bad_grid(int64_t n, int64_t per_block) {
  return n < 0 || (n + per_block - 1) / per_block > 0x7fffffff;
}

}  // namespace

// Common to every entry: the stream is `words` (nwords 32-bit words of the
// MSB-first bytes, padded, 16-byte aligned as torch allocates), every other
// array int32, all on CUDA device `device`; `stream` a cudaStream_t of that
// device. The library links its own CUDA runtime, so each entry selects
// `device` before launching. Each returns the first CUDA error (0 on
// success), allocates nothing and does not synchronise; with no lanes it
// launches nothing.

// value, next (n,) = the gamma code(s) at pos (n,): kind 0 one count, 1 a
// header's nsegs, 2 a degree and then the header (nsegs 0 for degree 0).
extern "C" int gab_cgr_gamma(const void* words, int64_t nwords,
                             const void* pos, int64_t n, int kind,
                             void* value, void* next, int device,
                             void* stream) {
  if (nwords < 4 || bad_grid(n, kThreads) || kind < kCount ||
      kind > kHeaderDeg) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool wide =
      n >= static_cast<int64_t>(kGammaPer) * kResidentThreads * sms;
  const int per = wide ? kGammaPer : 1;
  auto kernel = wide ? cgr_gamma_kernel<kGammaPer> : cgr_gamma_kernel<1>;
  if (n > 0) {
    kernel<<<blocks_for(n, kThreads * per), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        Stream{static_cast<const uint32_t*>(words), nwords},
        static_cast<const int32_t*>(pos), n, kind,
        static_cast<int32_t*>(value), static_cast<int32_t*>(next));
  }
  return static_cast<int>(cudaGetLastError());
}

// col[base[l] + i] for i < counts[l]: the residuals of lane l, whose codes
// start at bit data_p[l], decoded against its vertex lane_v[l]; pfin (lanes,)
// the bit after each lane's last code. The tiles (n_tiles + 1 lane bounds)
// cover the lanes, a block each; order (lanes,) the order in which a
// tile's threads take its lanes. A slot outside col (ncol) is not written;
// a lane left out of every tile is not decoded.
extern "C" int gab_cgr_residual(const void* words, int64_t nwords,
                                const void* data_p, const void* counts,
                                const void* lane_v, const void* base,
                                int64_t lanes, const void* tiles,
                                int64_t n_tiles, const void* order, int k,
                                void* col, int64_t ncol, void* pfin,
                                int device, void* stream) {
  if (nwords < 4 || lanes < 0 || n_tiles < 0 || n_tiles > 0x7fffffff ||
      k < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes > 0 && n_tiles > 0) {
    cgr_residual_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        Stream{static_cast<const uint32_t*>(words), nwords},
        static_cast<const int32_t*>(data_p),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(lane_v),
        static_cast<const int32_t*>(base), lanes,
        static_cast<const int32_t*>(tiles),
        static_cast<const int32_t*>(order), k, static_cast<int32_t*>(col),
        ncol, static_cast<int32_t*>(pfin));
  }
  return static_cast<int>(cudaGetLastError());
}

// left, length [base[l] + i] for i < counts[l]: the intervals of lane l;
// pfin (lanes,) the bit after each lane's last code.
extern "C" int gab_cgr_interval(const void* words, int64_t nwords,
                                const void* data_p, const void* counts,
                                const void* lane_v, const void* base,
                                int64_t lanes, int min_itv_len, void* left,
                                void* length, void* pfin, int device,
                                void* stream) {
  if (nwords < 4 || bad_grid(lanes, kThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes > 0) {
    cgr_interval_kernel<<<blocks_for(lanes, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        Stream{static_cast<const uint32_t*>(words), nwords},
        static_cast<const int32_t*>(data_p),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(lane_v),
        static_cast<const int32_t*>(base), lanes, min_itv_len,
        static_cast<int32_t*>(left), static_cast<int32_t*>(length),
        static_cast<int32_t*>(pfin));
  }
  return static_cast<int>(cudaGetLastError());
}

// col (ne,): row v's sorted residuals res[row_ptr[v], + nres[v]) merged with
// its intervals itv_ptr[v] .. itv_ptr[v + 1] (left, length; itv_pre the
// prefix of the lengths, n_itv + 1 entries), expanded, in the row's slots
// row_ptr[v] .. row_ptr[v + 1], which nres[v] and the lengths fill. The
// tiles: n_tiles of tile_slots slots each, tile_row[k] the row that holds
// slot k * tile_slots, tile_row[n_tiles] the last row. length is not read:
// itv_pre holds the lengths.
extern "C" int gab_cgr_merge(const void* res, const void* row_ptr,
                             const void* nres, const void* itv_ptr,
                             const void* left, const void* length,
                             const void* itv_pre, int64_t nv,
                             const void* tile_row, int64_t n_tiles,
                             int64_t tile_slots, int64_t ne, void* col,
                             int device, void* stream) {
  (void)length;
  if (nv < 0 || ne < 0 || tile_slots < 1 ||
      bad_grid(n_tiles, kWarpsPerBlock)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nv > 0 && n_tiles > 0) {
    cgr_merge_kernel<<<blocks_for(n_tiles, kWarpsPerBlock), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(res), static_cast<const int32_t*>(row_ptr),
        static_cast<const int32_t*>(nres),
        static_cast<const int32_t*>(itv_ptr),
        static_cast<const int32_t*>(left),
        static_cast<const int32_t*>(itv_pre), nv,
        static_cast<const int32_t*>(tile_row), n_tiles, tile_slots, ne,
        static_cast<int32_t*>(col));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
