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
// - svb_decode: one launch, a block a long row (above long_values values;
//   the prep's table, widest first), then a warp a tile of the other rows.
//   A long row is walked in tiles of kThreads x kLongQuads quads (a quad:
//   the up to four values of one key byte): the tile's key bytes are staged
//   in shared memory (asynchronous 16-byte copies, issued while the tile
//   before is decoded), a block scan of each thread's lengths gives its
//   byte offset and the tile's span of value bytes, which is staged next;
//   each thread decodes its consecutive quads there, a block scan of the
//   gaps gives the ids, which are collected in shared memory and stored in
//   order (a thread's own run of ids would have a warp's store touch 32
//   sectors), and the tile's bytes and gaps carry to the next. A tile of
//   short rows (at most 32 consecutive rows, the prep's table) takes a quad
//   a lane, two a lane a round: a quad's byte offset is a warp scan of the
//   lengths over the round less the scan at its row's first quad (or, for
//   the row that crosses from the round before, plus what that round
//   carried), its ids likewise a scan of the gaps; its 16 bytes come from
//   five aligned word loads, so short rows do not leave most lanes idle.
// - vgb_tags: one launch, a block a work item, the long rows first (widest
//   first), then tiles of the other rows. A row's chain is serial (where a
//   tag lies depends on every tag before it), so a long row (above
//   long_groups groups) is cut into chunks of kChunk bytes: the first tag
//   in a chunk lies at one of kEntries (17, the longest group) offsets from
//   its start, and a thread walks its chunk from all 17 at once, in
//   registers, keeping for each its group count and where it leaves the
//   chunk. Those small maps are composed in order (each warp's 32 from
//   every entry, then the 8 warps from the round's known entry), which
//   gives every chunk its true entry and the groups before it; each thread
//   then walks its chunk once more from there and writes its tags. A round
//   stages kThreads chunks of the stream in shared memory (16-byte loads)
//   and covers at most 17 bytes a group still missing; the rounds go on
//   until the row has all its groups, so any width, and any stream, is
//   exact. A tile is a run of consecutive rows (the prep cuts it at
//   VGB_TILE_BYTES of stream and at every long row): its bytes and its tag
//   slots are consecutive, so the block stages the tile's span of the
//   stream (given by its table) in shared memory, walks each row there (a
//   thread a row), collects the tag positions in shared memory and writes
//   them back in order. A byte outside the staged span is read from the
//   stream, a slot outside the collected span is written directly: any
//   table is exact, a good one only faster.
// - vgb_values: one launch, a block a long row (above long_groups groups;
//   widest first), then a block a tile of consecutive rows (the prep's
//   table: up to kThreads rows whose groups fit kValGroups). The groups of
//   consecutive rows are consecutive in tagpos, their bytes in the stream
//   and their ids in col, so a tile is decoded flat over its groups: the
//   tile's tag positions are staged (coalesced), then their span of the
//   stream (16-byte asynchronous copies); each row marks its first group,
//   a block scan of the marks gives every group its row; thread t decodes
//   kValPerThread consecutive groups from shared memory (five aligned words
//   a group), a block scan of the group sums less the scan at the row's
//   first group gives the ids, which are collected in shared memory and
//   stored in order, 16 bytes a store. A long row's block walks it
//   kValLongStep groups at a time the same way, carrying the sum of the
//   groups before. A byte outside the staged span is read from the
//   stream, a slot outside the collected span written directly, and a row
//   whose groups leave the tile's span or hold another row's first group
//   is decoded by its thread from the stream: any table is exact, a good
//   one only faster.
//
// Every byte read is clamped to the stream, so a stream that does not parse
// reads nothing outside it, and the plain versions, which clamp the same
// way, give the same values; sums are taken modulo 2^32 and stored as int32.
// A slot outside the output is not written.

#include <cstdint>

#include <cuda_pipeline.h>
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

// dst[i] = byte_at(s, a + i) for i < n rounded up to 16, a a multiple of
// 16: 16-byte loads where they lie inside the stream, else byte by byte
// (clamped). Every thread of the block takes part.
__device__ __forceinline__ void stage(const Bytes& s, int64_t a, int n,
                                      uint8_t* dst) {
  const bool aligned = (reinterpret_cast<uintptr_t>(s.p) & 15) == 0;
  for (int k = threadIdx.x; 16 * k < n; k += kThreads) {
    const int64_t o = a + 16 * static_cast<int64_t>(k);
    if (aligned && o >= 0 && o + 16 <= s.n) {
      *reinterpret_cast<uint4*>(dst + 16 * k) =
          __ldg(reinterpret_cast<const uint4*>(s.p + o));
    } else {
      for (int i = 0; i < 16; ++i) {
        dst[16 * k + i] = static_cast<uint8_t>(byte_at(s, o + i));
      }
    }
  }
}

// The inclusive prefix sum of x over the warp's lanes, modulo 2^64 or 2^32.
template <typename T>
__device__ __forceinline__ T warp_prefix(T x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// The inclusive prefix sum of x over the block's threads in order, modulo
// 2^32; *total gets the block's sum. Every thread takes part; `sums` holds
// kWarpsPerBlock entries.
__device__ __forceinline__ uint32_t block_prefix(uint32_t x, uint32_t* sums,
                                                 uint32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  x = warp_prefix(x, lane);
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  uint32_t before = 0;
  uint32_t all = 0;
#pragma unroll
  for (int w = 0; w < kWarpsPerBlock; ++w) {
    const uint32_t v = sums[w];
    before += w < warp ? v : 0u;
    all += v;
  }
  *total = all;
  __syncthreads();
  return x + before;
}

// svb_decode's work items. A quad is the up to four values of a row that
// share one key byte. A warp decodes a tile's rows 32 at a time, their
// quads in rounds of kSvbQuads a lane; a block walks a long row in tiles of
// kLongQuads quads a thread. The warps' tiles wait on loads and want the
// warps (kSvbMinBlocks blocks an SM, 40 registers) more than the long rows
// want the registers.
constexpr int kSvbQuads = 2;
constexpr int kSvbMinBlocks = 6;
constexpr int kLongQuads = 2;
constexpr int kLongTile = kThreads * kLongQuads;   // quads a long row's tile

// What a warp keeps of the rows of one batch (at most 32 rows).
struct SvbRows {
  int64_t qs[33];          // each row's first quad within the batch
  int64_t key[32];         // the row's first key byte
  int64_t n[32];           // its values
  int64_t slot[32];        // its first output slot
  int64_t head_off[32];    // the round's byte base, by row
  uint32_t head_id[32];    // the round's id base, by row
  int64_t carry_off;       // where the row crossing into a round stands
  uint32_t carry_id;
};

// The little-endian words of the stream at o, o + 4, o + 8, o + 12 (16
// bytes from any o): from five aligned loads where they lie inside the
// stream, else byte by byte, clamped.
__device__ __forceinline__ void sixteen(const Bytes& s, int64_t o,
                                        uint32_t (&w)[5]) {
  const int64_t a = o & ~int64_t{3};
  if ((reinterpret_cast<uintptr_t>(s.p) & 3) == 0 && a >= 0 &&
      a + 20 <= s.n) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(s.p + a);
    uint32_t x[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) x[k] = __ldg(p + k);
    const int sh = static_cast<int>(o - a) * 8;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t pair = (static_cast<uint64_t>(x[k + 1]) << 32) | x[k];
      w[k] = static_cast<uint32_t>(pair >> sh);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = read_le(s, o + 4 * k, 4);
  }
  w[4] = 0;
}

// The len (1..4) bytes at byte b (0..12) of the sixteen in w.
__device__ __forceinline__ uint32_t word_at(const uint32_t (&w)[5], int b,
                                            int len) {
  const int i = b >> 2;
  const uint32_t lo = i == 0 ? w[0] : i == 1 ? w[1] : i == 2 ? w[2] : w[3];
  const uint32_t hi = i == 0 ? w[1] : i == 1 ? w[2] : i == 2 ? w[3] : w[4];
  const uint64_t pair = (static_cast<uint64_t>(hi) << 32) | lo;
  const uint32_t v = static_cast<uint32_t>(pair >> ((b & 3) * 8));
  return len == 4 ? v : v & ((1u << (8 * len)) - 1u);
}

// Rows [lo, hi) of at most long_values values (the others are skipped), 32
// rows a batch, decoded by a warp (t its lane); a batch's quads in rounds
// of 32 kSvbQuads, the row that crosses from one round into the next
// carrying its byte offset and its id.
__device__ void svb_rows(const Bytes& s, const int32_t* __restrict__ key_start,
                         const int32_t* __restrict__ counts,
                         const int32_t* __restrict__ out_slot, int64_t lo,
                         int64_t hi, int64_t long_values,
                         int32_t* __restrict__ col, int64_t ncol,
                         SvbRows& sm, int t) {
  constexpr int G = 32;
  constexpr int kRound = G * kSvbQuads;
  for (int64_t b0 = lo; b0 < hi; b0 += G) {
    const int nb = hi - b0 < G ? static_cast<int>(hi - b0) : G;
    int64_t n = 0;
    if (t < nb) {
      n = __ldg(counts + b0 + t);
      if (n > long_values) n = 0;
      n = n < 0 ? 0 : n;
      sm.key[t] = __ldg(key_start + b0 + t);
      sm.slot[t] = __ldg(out_slot + b0 + t);
      sm.n[t] = n;
    }
    const int64_t q = (n + 3) >> 2;
    const int64_t incl = warp_prefix(q, t);
    const int64_t total = __shfl_sync(kFull, incl, 31);
    if (t < nb) sm.qs[t] = incl - q;
    __syncwarp();
    for (int64_t r0 = 0; r0 < total; r0 += kRound) {
      int row[kSvbQuads];
      int64_t jq[kSvbQuads];
      int m[kSvbQuads];
      uint32_t key[kSvbQuads];
      uint32_t len4[kSvbQuads];
#pragma unroll
      for (int u = 0; u < kSvbQuads; ++u) {
        const int64_t g = r0 + kSvbQuads * t + u;
        row[u] = 0;
        jq[u] = 0;
        m[u] = 0;
        key[u] = 0;
        len4[u] = 0;
        if (g < total) {
          // the last row whose first quad is at or before g (the rows
          // without values share their first quad with the next row)
          int a = 0, b = nb;
          while (b - a > 1) {
            const int mid = (a + b) >> 1;
            if (sm.qs[mid] <= g) a = mid; else b = mid;
          }
          row[u] = a;
          jq[u] = g - sm.qs[a];
          const int64_t left = sm.n[a] - 4 * jq[u];
          m[u] = left < 4 ? static_cast<int>(left) : 4;
          key[u] = byte_at(s, sm.key[a] + jq[u]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            len4[u] += k < m[u] ? ((key[u] >> (2 * k)) & 3u) + 1u : 0u;
          }
        }
      }
      // byte offsets: a prefix over the round, less the row's base
      uint32_t pair_len = 0;
#pragma unroll
      for (int u = 0; u < kSvbQuads; ++u) pair_len += len4[u];
      uint32_t off = warp_prefix(pair_len, t) - pair_len;
      uint32_t e_off[kSvbQuads];
#pragma unroll
      for (int u = 0; u < kSvbQuads; ++u) {
        e_off[u] = off;
        off += len4[u];
        const int64_t g = r0 + kSvbQuads * t + u;
        if (g < total && (jq[u] == 0 || g == r0)) {
          sm.head_off[row[u]] = static_cast<int64_t>(e_off[u]) -
                                (jq[u] != 0 ? sm.carry_off : 0);
        }
      }
      __syncwarp();
      uint32_t v[kSvbQuads][4];
      uint32_t gsum[kSvbQuads];
#pragma unroll
      for (int u = 0; u < kSvbQuads; ++u) {
        gsum[u] = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) v[u][k] = 0;
        if (m[u] > 0) {
          const int a = row[u];
          const int64_t o = sm.key[a] + ((sm.n[a] + 3) >> 2) +
                            (static_cast<int64_t>(e_off[u]) - sm.head_off[a]);
          uint32_t w[5];
          sixteen(s, o, w);
          int b = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int len = static_cast<int>((key[u] >> (2 * k)) & 3u) + 1;
            if (k < m[u]) {
              v[u][k] = word_at(w, b, len);
              gsum[u] += v[u][k];
              b += len;
            }
          }
        }
      }
      // ids: a prefix of the gaps over the round, less the row's base
      uint32_t pair_gap = 0;
#pragma unroll
      for (int u = 0; u < kSvbQuads; ++u) pair_gap += gsum[u];
      uint32_t id = warp_prefix(pair_gap, t) - pair_gap;
      uint32_t e_id[kSvbQuads];
#pragma unroll
      for (int u = 0; u < kSvbQuads; ++u) {
        e_id[u] = id;
        id += gsum[u];
        const int64_t g = r0 + kSvbQuads * t + u;
        if (g < total && (jq[u] == 0 || g == r0)) {
          sm.head_id[row[u]] = e_id[u] - (jq[u] != 0 ? sm.carry_id : 0u);
        }
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kSvbQuads; ++u) {
        const int a = row[u];
        uint32_t x = e_id[u] - sm.head_id[a];
        const int64_t slot0 = sm.slot[a] + 4 * jq[u];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          x += v[u][k];
          const int64_t slot = slot0 + k;
          if (k < m[u] && slot >= 0 && slot < ncol) {
            col[slot] = static_cast<int32_t>(x);
          }
        }
        // the round's last quad hands its row's place to the next round
        const int64_t g = r0 + kSvbQuads * t + u;
        if (g == r0 + kRound - 1 && g < total) {
          sm.carry_off = static_cast<int64_t>(e_off[u] + len4[u]) -
                         sm.head_off[a];
          sm.carry_id = e_id[u] + gsum[u] - sm.head_id[a];
        }
      }
      __syncwarp();
    }
  }
}

// A long row's tile, staged: its key bytes (two buffers: the next tile's
// keys arrive while this one is decoded) and its span of value bytes (at
// most four bytes a value, and room to read five words from any of them),
// each from the 16-byte line below its first byte.
struct SvbLong {
  alignas(16) uint8_t keys[2][kLongTile + 16];
  alignas(16) uint8_t vals[16 * kLongTile + 32];
  int32_t ids[4 * kLongTile + 4 * kLongTile / 32];  // id i at i + i / 32
  uint32_t sums[kWarpsPerBlock];
};

// Starts copying byte_at(s, a + i), i < n rounded up to 16, a a multiple of
// 16, into dst in shared memory: 16 bytes a copy, not waited for, where
// they lie inside the stream, else byte by byte (clamped). Every thread of
// the block takes part; its copies are one commit group.
__device__ __forceinline__ void stage_async(const Bytes& s, int64_t a, int n,
                                            uint8_t* dst) {
  const bool aligned = (reinterpret_cast<uintptr_t>(s.p) & 15) == 0;
  for (int k = threadIdx.x; 16 * k < n; k += kThreads) {
    const int64_t o = a + 16 * static_cast<int64_t>(k);
    if (aligned && o >= 0 && o + 16 <= s.n) {
      __pipeline_memcpy_async(dst + 16 * k, s.p + o, 16);
    } else {
      for (int i = 0; i < 16; ++i) {
        dst[16 * k + i] = static_cast<uint8_t>(byte_at(s, o + i));
      }
    }
  }
  __pipeline_commit();
}

// Row r's ids into col, by the whole block, a tile of kLongTile quads at a
// time; thread t takes the tile's quads kLongQuads t .. kLongQuads t +
// kLongQuads - 1, so that its value bytes are consecutive, and the tile's
// ids are collected in shared memory and stored in order. Every tile's
// keys start at the same offset in their line (kLongTile is a multiple of
// 16).
__device__ void svb_long_row(const Bytes& s, int64_t k0, int64_t n,
                             int64_t slot0, int32_t* __restrict__ col,
                             int64_t ncol, SvbLong& sm) {
  const int t = threadIdx.x;
  n = n < 0 ? 0 : n;
  const int64_t nq = (n + 3) >> 2;
  const int klead = static_cast<int>(k0 & 15);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(sm.vals);
  int64_t off = k0 + nq;  // the tile's first value byte
  uint32_t carry = 0;     // the row's id before the tile
  if (nq > 0) {
    stage_async(s, k0 - klead,
                klead + static_cast<int>(nq < kLongTile ? nq : kLongTile),
                sm.keys[0]);
  }
  for (int64_t q0 = 0; q0 < nq; q0 += kLongTile) {
    const int tq = nq - q0 < kLongTile ? static_cast<int>(nq - q0) : kLongTile;
    const uint8_t* keys = sm.keys[(q0 / kLongTile) & 1] + klead;
    __pipeline_wait_prior(0);  // this tile's keys
    __syncthreads();
    // this thread's value bytes, and where they start in the tile
    const int j0 = kLongQuads * t;
    uint32_t len = 0;
#pragma unroll
    for (int u = 0; u < kLongQuads; ++u) {
      const int j = j0 + u;
      const int64_t left = n - 4 * (q0 + j);
      const int m = j >= tq ? 0 : (left < 4 ? static_cast<int>(left) : 4);
      const uint32_t key = keys[j];
      for (int k = 0; k < m; ++k) len += ((key >> (2 * k)) & 3u) + 1u;
    }
    uint32_t span;
    const uint32_t b0 = block_prefix(len, sm.sums, &span) - len;
    const int vlead = static_cast<int>(off & 15);
    stage_async(s, off - vlead, vlead + static_cast<int>(span), sm.vals);
    const int64_t q1 = q0 + kLongTile;  // the next tile's keys, meanwhile
    if (q1 < nq) {
      stage_async(s, k0 + q1 - klead,
                  klead + static_cast<int>(nq - q1 < kLongTile ? nq - q1
                                                               : kLongTile),
                  sm.keys[(q1 / kLongTile) & 1]);
    } else {
      __pipeline_commit();  // an empty group, younger than the values
    }
    __pipeline_wait_prior(1);  // the values
    __syncthreads();
    // the gaps: their sum over this thread's values, then the ids
    uint32_t gsum = 0;
    uint32_t gall = 0;  // the tile's gaps
    for (int pass = 0; pass < 2; ++pass) {
      uint32_t x = 0;
      if (pass == 1) x = carry + block_prefix(gsum, sm.sums, &gall) - gsum;
      int p = vlead + static_cast<int>(b0);
#pragma unroll
      for (int u = 0; u < kLongQuads; ++u) {
        const int j = j0 + u;
        const int64_t left = n - 4 * (q0 + j);
        const int m = j >= tq ? 0 : (left < 4 ? static_cast<int>(left) : 4);
        if (m <= 0) continue;
        const uint32_t key = keys[j];
        // the quad's 16 bytes from five aligned words of the staged span
        uint32_t w[5];
        const int sh = (p & 3) * 8;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t pair =
              (static_cast<uint64_t>(words[(p >> 2) + k + 1]) << 32) |
              words[(p >> 2) + k];
          w[k] = static_cast<uint32_t>(pair >> sh);
        }
        w[4] = 0;
        int b = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int l = static_cast<int>((key >> (2 * k)) & 3u) + 1;
          if (k < m) {
            const uint32_t v = word_at(w, b, l);
            b += l;
            if (pass == 0) {
              gsum += v;
            } else {
              x += v;
              const int i = 4 * j + k;
              sm.ids[i + (i >> 5)] = static_cast<int32_t>(x);
            }
          }
        }
        p += b;
      }
    }
    __syncthreads();
    // the tile's ids, consecutive threads writing consecutive slots
    const int64_t left = n - 4 * q0;
    const int nv = left < 4 * tq ? static_cast<int>(left) : 4 * tq;
    for (int i = t; i < nv; i += kThreads) {
      const int64_t slot = slot0 + 4 * q0 + i;
      if (slot >= 0 && slot < ncol) col[slot] = sm.ids[i + (i >> 5)];
    }
    off += span;
    carry += gall;
    __syncthreads();  // before the next tile is staged over this one
  }
}

// A block a long row (widest first) and then a warp a tile, a run of
// consecutive rows whose rows of at most long_values values it decodes,
// kWarpsPerBlock tiles a block.
__global__ void __launch_bounds__(kThreads, kSvbMinBlocks)
svb_decode_kernel(const Bytes s, const int32_t* __restrict__ key_start,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ out_slot, int64_t rows,
                  const int32_t* __restrict__ long_rows, int64_t n_long,
                  const int32_t* __restrict__ tiles, int64_t n_tiles,
                  int64_t long_values, int32_t* __restrict__ col,
                  int64_t ncol) {
  __shared__ union {
    SvbLong block;
    SvbRows warp[kWarpsPerBlock];
  } sm;
  const int64_t b = blockIdx.x;
  if (b < n_long) {
    const int64_t r = __ldg(long_rows + b);
    if (r >= 0 && r < rows) {
      svb_long_row(s, __ldg(key_start + r), __ldg(counts + r),
                   __ldg(out_slot + r), col, ncol, sm.block);
    }
    return;
  }
  const int warp = threadIdx.x >> 5;
  const int64_t k = (b - n_long) * kWarpsPerBlock + warp;
  if (k >= n_tiles) return;
  int64_t lo = __ldg(tiles + k);
  int64_t hi = __ldg(tiles + k + 1);
  lo = lo < 0 ? 0 : lo;
  hi = hi > rows ? rows : hi;
  svb_rows(s, key_start, counts, out_slot, lo, hi, long_values, col,
               ncol, sm.warp[warp], threadIdx.x & 31);
}

// vgb_tags' work items. A group is 5 to 17 bytes (the tag and four values
// of one to four bytes each).
constexpr int kMinGroup = 5;
constexpr int kEntries = 17;                 // the longest group, in bytes
constexpr int kChunk = 64;                   // bytes a thread walks
constexpr int kChunkSteps = (kChunk + kMinGroup - 1) / kMinGroup;
constexpr int kRoundBytes = kThreads * kChunk;
constexpr int kWinBytes = 15872;             // a tile's staged stream
constexpr int kOutSlots = 3200;              // a tile's collected tags
constexpr int kTagBlocksPerSM = 6;           // 6 x 35.4 KB of shared memory
constexpr int kTileCols = 5;                 // a tile table row
// the shared memory of the two kinds of block: a long row's round (the
// stream, the chunks' maps, the warps' maps, the warps' and chunks'
// entries, the carry) and a tile (the stream, the tags, their flags)
constexpr int kLongSmem = (kRoundBytes + 16) + 4 * kThreads * kEntries +
                          4 * kWarpsPerBlock * kEntries + 4 * kWarpsPerBlock +
                          4 * kThreads + 16;
constexpr int kTileSmem = (kWinBytes + 16) + 5 * kOutSlots;
constexpr int kSmemBytes = kLongSmem > kTileSmem ? kLongSmem : kTileSmem;

// A group's byte length from its tag (VGB_GLEN): 5 plus its four 2-bit codes.
__device__ __forceinline__ int group_len(uint32_t t) {
  const uint32_t x = (t & 0x33u) + ((t >> 2) & 0x33u);
  return static_cast<int>(5u + (x & 15u) + (x >> 4));
}

// Every tag of a long row of ng groups, the first at byte p, into
// tagpos[g0 ..], in rounds of up to kThreads chunks.
__device__ void long_row(const Bytes& s, int64_t p, int64_t ng, int64_t g0,
                         int32_t* __restrict__ tagpos, int64_t n_g,
                         unsigned char* sm) {
  uint8_t* buf = sm;
  uint32_t* maps = reinterpret_cast<uint32_t*>(sm + kRoundBytes + 16);
  uint32_t* wmap = maps + kThreads * kEntries;
  uint32_t* wentry = wmap + kWarpsPerBlock * kEntries;
  uint32_t* centry = wentry + kWarpsPerBlock;
  long long* carry = reinterpret_cast<long long*>(centry + kThreads);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int64_t done = 0;  // groups found before this round
  while (done < ng) {
    // this round's chunks start at the next tag, p; the bytes the missing
    // groups can take at most bound how many of them are needed
    const int64_t need = (ng - done) * kEntries;
    const int nch = need >= kRoundBytes
                        ? kThreads
                        : static_cast<int>((need + kChunk - 1) / kChunk);
    const int64_t a = p - (p & 15);
    const int lead = static_cast<int>(p - a);
    stage(s, a, lead + nch * kChunk, buf);
    __syncthreads();
    // 1. the chunk's map: from each entry e, the groups whose tag lies in
    //    the chunk and the offset past its end where the next one lies
    //    (exit | count << 5); chunks past the round's map e to itself. A
    //    walk is its byte index in buf (below 2^15) | its count << 16.
    uint32_t* map = maps + tid * kEntries;
    if (tid < nch) {
      const uint32_t c0 = lead + tid * kChunk;
      const uint32_t cend = c0 + kChunk;
      uint32_t q[kEntries];
#pragma unroll
      for (int e = 0; e < kEntries; ++e) q[e] = c0 + e;
      for (int step = 0; step < kChunkSteps; ++step) {
#pragma unroll
        for (int e = 0; e < kEntries; ++e) {
          const uint32_t i = q[e] & 0xffffu;
          if (i < cend) q[e] += group_len(buf[i]) + 0x10000u;
        }
      }
#pragma unroll
      for (int e = 0; e < kEntries; ++e) {
        map[e] = ((q[e] & 0xffffu) - cend) | ((q[e] >> 16) << 5);
      }
    } else {
      for (int e = 0; e < kEntries; ++e) map[e] = e;
    }
    __syncthreads();
    // 2. lane e of each warp composes the warp's 32 maps from entry e
    if (lane < kEntries) {
      uint32_t x = lane;
      uint32_t acc = 0;
      for (int k = 0; k < 32; ++k) {
        const uint32_t m = maps[(warp * 32 + k) * kEntries + x];
        x = m & 31u;
        acc += m >> 5;
      }
      wmap[warp * kEntries + lane] = x | (acc << 5);
    }
    __syncthreads();
    // 3. the warps in order from the round's entry 0
    if (tid == 0) {
      uint32_t x = 0;
      uint32_t acc = 0;
      for (int w = 0; w < kWarpsPerBlock; ++w) {
        wentry[w] = x | (acc << 5);
        const uint32_t m = wmap[w * kEntries + x];
        x = m & 31u;
        acc += m >> 5;
      }
      carry[0] = p + static_cast<int64_t>(nch) * kChunk + x;
      carry[1] = done + acc;
    }
    __syncthreads();
    // 4. lane 0 of each warp walks its 32 maps from the warp's true entry,
    //    handing each chunk its entry and the groups before it
    if (lane == 0) {
      uint32_t x = wentry[warp];
      for (int k = 0; k < 32; ++k) {
        centry[warp * 32 + k] = x;
        const uint32_t m = maps[(warp * 32 + k) * kEntries + (x & 31u)];
        x = (m & 31u) | (((x >> 5) + (m >> 5)) << 5);
      }
    }
    __syncthreads();
    // 5. the chunk's tags, from its true entry
    if (tid < nch) {
      const uint32_t ce = centry[tid];
      int q = lead + tid * kChunk + static_cast<int>(ce & 31u);
      const int cend = lead + (tid + 1) * kChunk;
      for (int64_t g = done + (ce >> 5); q < cend && g < ng; ++g) {
        const int64_t slot = g0 + g;
        if (slot >= 0 && slot < n_g) {
          tagpos[slot] = static_cast<int32_t>(a + q);
        }
        q += group_len(buf[q]);
      }
    }
    p = carry[0];
    done = carry[1];
    __syncthreads();
  }
}

// The tags of the rows [r_lo, r_hi) of at most long_groups groups. The
// bytes [b_lo, b_lo + b_len) of the stream are staged, the tags of the
// slots [g_lo, g_lo + g_len) collected, both cut to the shared memory.
__device__ void tile_rows(const Bytes& s, const int32_t* __restrict__ pos,
                          const int32_t* __restrict__ ngroups,
                          const int32_t* __restrict__ gbase, int64_t r_lo,
                          int64_t r_hi, int long_groups, int64_t b_lo,
                          int64_t b_len, int64_t g_lo, int64_t g_len,
                          int32_t* __restrict__ tagpos, int64_t n_g,
                          unsigned char* sm) {
  uint8_t* win = sm;
  int32_t* obuf = reinterpret_cast<int32_t*>(sm + kWinBytes + 16);
  uint8_t* oflag = reinterpret_cast<uint8_t*>(obuf + kOutSlots);
  const int tid = threadIdx.x;
  const int64_t a = b_lo - (b_lo & 15);
  const int64_t span = b_len > 0 ? b_lo + b_len - a : 0;
  const int nwin = span > kWinBytes ? kWinBytes : static_cast<int>(span);
  // the collected slots lie inside tagpos
  int64_t gspan = g_lo < 0 ? 0 : (g_len < n_g - g_lo ? g_len : n_g - g_lo);
  const int nout = gspan <= 0 ? 0 : (gspan > kOutSlots ? kOutSlots
                                                         : static_cast<int>(gspan));
  stage(s, a, nwin, win);
  for (int i = tid; i < nout; i += kThreads) oflag[i] = 0;
  __syncthreads();
  const uint32_t a32 = static_cast<uint32_t>(a);
  for (int64_t r = r_lo + tid; r < r_hi; r += kThreads) {
    const int64_t ng = __ldg(ngroups + r);
    if (ng <= 0 || ng > long_groups) continue;
    int64_t p = __ldg(pos + r);
    const int64_t g0 = __ldg(gbase + r);
    const int64_t o0 = g0 - g_lo;
    if (o0 >= 0 && o0 + ng <= nout && p - a >= 0 && p - a < nwin) {
      // the row's tags all collected, its first tag staged: positions as
      // offsets into the window (the last tags may lie past it)
      int q = static_cast<int>(p - a);
      const int o = static_cast<int>(o0);
      for (int j = 0; j < ng; ++j) {
        obuf[o + j] = static_cast<int32_t>(a32 + static_cast<uint32_t>(q));
        oflag[o + j] = 1;
        q += group_len(q < nwin ? win[q] : byte_at(s, a + q));
      }
      continue;
    }
    for (int64_t j = 0; j < ng; ++j) {
      const int64_t slot = g0 + j;
      if (slot >= 0 && slot < n_g) {
        const int64_t o = slot - g_lo;
        if (o >= 0 && o < nout) {
          obuf[o] = static_cast<int32_t>(p);
          oflag[o] = 1;
        } else {
          tagpos[slot] = static_cast<int32_t>(p);
        }
      }
      const int64_t w = p - a;
      p += group_len(w >= 0 && w < nwin ? win[w] : byte_at(s, p));
    }
  }
  __syncthreads();
  for (int i = tid; i < nout; i += kThreads) {
    if (oflag[i]) tagpos[g_lo + i] = obuf[i];
  }
}

__global__ void __launch_bounds__(kThreads, kTagBlocksPerSM)
vgb_tags_kernel(const Bytes s, const int32_t* __restrict__ pos,
                const int32_t* __restrict__ ngroups,
                const int32_t* __restrict__ gbase, int64_t rows,
                const int32_t* __restrict__ long_rows, int64_t n_long,
                const int32_t* __restrict__ tiles, int long_groups,
                int32_t* __restrict__ tagpos, int64_t n_g) {
  __shared__ __align__(16) unsigned char sm[kSmemBytes];
  const int64_t b = blockIdx.x;
  if (b < n_long) {
    const int64_t r = __ldg(long_rows + b);
    if (r >= 0 && r < rows) {
      long_row(s, __ldg(pos + r), __ldg(ngroups + r), __ldg(gbase + r),
               tagpos, n_g, sm);
    }
  } else {
    const int32_t* t = tiles + (b - n_long) * kTileCols;
    int64_t lo = __ldg(t);
    int64_t hi = __ldg(t + kTileCols);
    lo = lo < 0 ? 0 : lo;
    hi = hi > rows ? rows : hi;
    tile_rows(s, pos, ngroups, gbase, lo, hi, long_groups, __ldg(t + 1),
              __ldg(t + 2), __ldg(t + 3), __ldg(t + 4), tagpos, n_g, sm);
  }
}

// vgb_values' work items. A tile's block decodes up to kValGroups groups
// of consecutive rows, kValPerThread consecutive groups a thread; a long
// row's block walks the row kValLongStep groups at a time.
constexpr int kValPerThread = 4;
constexpr int kValGroups = kThreads * kValPerThread;
constexpr int kValSlots = 4 * kValGroups;    // a tile's collected ids
constexpr int kValWin = 12288;               // a tile's staged stream
constexpr int kValCols = 4;                  // a tile table row
// a long row's groups a round: their ids, after the first id's place in
// its quad, fit the collected slots
constexpr int kValLongStep = kValGroups - 1;

// A vgb_values block's shared memory: the staged stream, the collected ids
// and their flags, the groups' tag positions and the prefix of their sums,
// each group's owner (a tile's row + 1, 0 for none), and the tile's rows
// (first group less the tile's, count, first slot, whether flat).
struct VgbValues {
  alignas(16) uint8_t win[kValWin + 32];
  alignas(16) int32_t ids[kValSlots + 4];
  alignas(16) uint8_t flag[kValSlots];
  int32_t tp[kValGroups];
  uint32_t pre[kValGroups];
  uint16_t own[kValGroups];
  int32_t head[kThreads];
  int32_t n[kThreads];
  int32_t slot[kThreads];
  uint8_t flat[kThreads];
  uint32_t sums[kWarpsPerBlock];
};
static_assert(sizeof(VgbValues) <= 48 * 1024,
              "vgb_values' static shared memory is at most 48 KB");

// The prefix within the group (v) of the four values of the group whose tag
// is at o, and their sum: from the staged bytes (win holds the stream's
// bytes a .. a + nwin) where the group's 17 lie inside them, else from the
// stream, clamped.
__device__ __forceinline__ uint32_t vgb_group(const Bytes& s,
                                              const uint8_t* win, int64_t a,
                                              int nwin, int64_t o,
                                              uint32_t (&v)[4]) {
  const int64_t w = o - a;
  uint32_t acc = 0;
  if (w >= 0 && w + 17 <= nwin) {
    const int b = static_cast<int>(w);
    const uint32_t t = win[b];
    const uint32_t* words = reinterpret_cast<const uint32_t*>(win);
    const int i = (b + 1) >> 2;
    const int sh = ((b + 1) & 3) * 8;
    uint32_t x[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) x[k] = words[i + k];
    uint32_t w16[5];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t pair = (static_cast<uint64_t>(x[k + 1]) << 32) | x[k];
      w16[k] = static_cast<uint32_t>(pair >> sh);
    }
    w16[4] = 0;
    int off = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int len = static_cast<int>((t >> (2 * k)) & 3u) + 1;
      acc += word_at(w16, off, len);
      off += len;
      v[k] = acc;
    }
  } else {
    const uint32_t t = byte_at(s, o);
    ++o;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int len = static_cast<int>((t >> (2 * k)) & 3u) + 1;
      acc += read_le(s, o, len);
      o += len;
      v[k] = acc;
    }
  }
  return acc;
}

// The prefix of the maxima of x over the block's threads before this one
// (0 for thread 0). Every thread takes part; `sums` holds kWarpsPerBlock
// entries.
__device__ __forceinline__ uint32_t block_max_before(uint32_t x,
                                                     uint32_t* sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x = x > y ? x : y;
  }
  uint32_t before = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) before = 0;
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = before > sums[w] ? before : sums[w];
  __syncthreads();
  return before;
}

// The collected ids of the slots cbase .. cbase + kValSlots (cbase a
// multiple of 4) whose flags are set, into col: 16 bytes a store where all
// four of an aligned quad are set, else one by one. Every thread takes part.
__device__ __forceinline__ void flush_ids(const int32_t* ids,
                                          const uint8_t* flag, int64_t cbase,
                                          int32_t* __restrict__ col,
                                          int64_t ncol) {
  const bool aligned = (reinterpret_cast<uintptr_t>(col) & 15) == 0;
  for (int i = threadIdx.x; i < kValSlots / 4; i += kThreads) {
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

// A row's ids from a long row's block, kValLongStep groups at a time: the
// groups' tag positions and their span of the stream are staged, thread t
// decodes groups kValPerThread t .., a block scan of the group sums (and
// the carry of the groups before) gives the ids, which are collected in
// shared memory and stored in order.
__device__ void vgb_values_long(const Bytes& s,
                                const int32_t* __restrict__ tagpos,
                                int64_t n_g, int64_t g0, int64_t n,
                                int64_t slot0, int32_t* __restrict__ col,
                                int64_t ncol, VgbValues& sm) {
  const int t = threadIdx.x;
  n = n < 0 ? 0 : n;
  const int64_t ng = (n + 3) >> 2;
  const int lead = static_cast<int>(slot0 & 3);  // the ids' place in a quad
  uint32_t carry = 0;
  for (int64_t j0 = 0; j0 < ng; j0 += kValLongStep) {
    const int m = ng - j0 < kValLongStep ? static_cast<int>(ng - j0)
                                         : kValLongStep;
    for (int i = t; i < m; i += kThreads) {
      const int64_t gi = g0 + j0 + i;
      sm.tp[i] = gi >= 0 && gi < n_g ? __ldg(tagpos + gi) : 0;
    }
    for (int i = t; i < kValSlots / 16; i += kThreads) {
      reinterpret_cast<uint4*>(sm.flag)[i] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    const int64_t b_lo = sm.tp[0];
    const int64_t a = b_lo - (b_lo & 15);
    const int64_t span = static_cast<int64_t>(sm.tp[m - 1]) + 17 - a;
    const int nwin = span <= 0 ? 0 : (span > kValWin ? kValWin
                                                       : static_cast<int>(span));
    stage_async(s, a, nwin, sm.win);
    __pipeline_wait_prior(0);
    __syncthreads();
    uint32_t v[kValPerThread][4];
    uint32_t gsum[kValPerThread];
    uint32_t total = 0;
#pragma unroll
    for (int u = 0; u < kValPerThread; ++u) {
      const int p = kValPerThread * t + u;
      gsum[u] = 0;
      if (p < m) gsum[u] = vgb_group(s, sm.win, a, nwin, sm.tp[p], v[u]);
      total += gsum[u];
    }
    uint32_t all;
    uint32_t x = carry + block_prefix(total, sm.sums, &all) - total;
    const int64_t left = n - 4 * j0;  // the ids still to come
#pragma unroll
    for (int u = 0; u < kValPerThread; ++u) {
      const int p = kValPerThread * t + u;
      if (p < m) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = 4 * p + k;
          if (e < left) {
            sm.ids[lead + e] = static_cast<int32_t>(x + v[u][k]);
            sm.flag[lead + e] = 1;
          }
        }
      }
      x += gsum[u];
    }
    __syncthreads();
    flush_ids(sm.ids, sm.flag, slot0 + 4 * j0 - lead, col, ncol);
    carry += all;
    __syncthreads();  // before the next groups are staged over these
  }
}

// Row r's ids (n of them, groups from g0, slots from slot0) decoded from
// the stream, not from a tile's spans, each stored through put.
template <typename Put>
__device__ __forceinline__ void vgb_values_row(
    const Bytes& s, const int32_t* __restrict__ tagpos, int64_t n_g,
    const uint8_t* win, int64_t a, int nwin, int64_t g0, int64_t n,
    int64_t slot0, Put put) {
  const int64_t ng = n > 0 ? (n + 3) >> 2 : 0;
  uint32_t x = 0;
  for (int64_t j = 0; j < ng; ++j) {
    const int64_t gi = g0 + j;
    const int64_t o = gi >= 0 && gi < n_g ? __ldg(tagpos + gi) : 0;
    uint32_t v[4];
    const uint32_t sum = vgb_group(s, win, a, nwin, o, v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * j + k < n) put(slot0 + 4 * j + k, x + v[k]);
    }
    x += sum;
  }
}

// The ids of the rows [r_lo, r_hi) of at most long_groups groups, decoded
// flat over the tile's groups: the groups g_lo .. g_lo + g_len (cut to
// kValGroups and to tagpos) have their tag positions staged, and their
// span of the stream; a row whose groups all lie there and hold no other
// row's first group (its owner: the largest row whose first group lies at
// or before) is flat. Thread t decodes the flat rows' groups among
// kValPerThread t .. (another group's sum is 0: a flat row's groups are
// its own, so its prefix differences take in no other); a block scan of
// the group sums gives each group's prefix, less the prefix at its row's
// first group; its ids go to the row's slots, collected in shared memory
// from s_lo (rounded down to a quad) and stored in order; a slot outside
// is written directly. A row that is not flat, or past the tile's first
// kThreads rows, is decoded by its thread from the stream.
__device__ void vgb_values_tile(
    const Bytes& s, const int32_t* __restrict__ tagpos, int64_t n_g,
    const int32_t* __restrict__ gbase, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ out_slot, int64_t r_lo, int64_t r_hi,
    int64_t g_lo, int64_t g_len, int64_t s_lo, int long_groups,
    int32_t* __restrict__ col, int64_t ncol, VgbValues& sm) {
  const int t = threadIdx.x;
  g_len = g_len < n_g - g_lo ? g_len : n_g - g_lo;
  const int gspan = g_lo < 0 || g_len <= 0
                        ? 0
                        : (g_len < kValGroups ? static_cast<int>(g_len)
                                              : kValGroups);
  const int64_t cbase = s_lo - (s_lo & 3);
  for (int i = t; i < kValSlots / 16; i += kThreads) {
    reinterpret_cast<uint4*>(sm.flag)[i] = make_uint4(0, 0, 0, 0);
  }
  for (int i = t; i < kValGroups; i += kThreads) sm.own[i] = 0;
  for (int i = t; i < gspan; i += kThreads) sm.tp[i] = __ldg(tagpos + g_lo + i);
  const int64_t r = r_lo + t;
  int64_t n = 0, g0 = 0, slot0 = 0;
  if (r < r_hi) {
    n = __ldg(counts + r);
    g0 = __ldg(gbase + r);
    slot0 = __ldg(out_slot + r);
  }
  const int64_t ng = n > 0 ? (n + 3) >> 2 : 0;
  const bool mine = r < r_hi && ng > 0 && ng <= long_groups;
  const int64_t h = g0 - g_lo;
  const bool in_span = mine && h >= 0 && h + ng <= gspan;
  __syncthreads();
  if (in_span) sm.own[h] = static_cast<uint16_t>(t + 1);
  // the stream's span of the staged groups
  int64_t a = 0;
  int nwin = 0;
  if (gspan > 0) {
    const int64_t b_lo = sm.tp[0];
    a = b_lo - (b_lo & 15);
    const int64_t span = static_cast<int64_t>(sm.tp[gspan - 1]) + 17 - a;
    nwin = span <= 0 ? 0 : (span > kValWin ? kValWin : static_cast<int>(span));
  }
  stage_async(s, a, nwin, sm.win);
  __syncthreads();
  // each group's owner: the largest row whose first group lies at or
  // before it
  uint32_t own[kValPerThread];
  uint32_t m = 0;
#pragma unroll
  for (int u = 0; u < kValPerThread; ++u) {
    const uint32_t o = sm.own[kValPerThread * t + u];
    m = m > o ? m : o;
    own[u] = m;
  }
  const uint32_t before = block_max_before(m, sm.sums);
#pragma unroll
  for (int u = 0; u < kValPerThread; ++u) {
    own[u] = own[u] > before ? own[u] : before;
    sm.own[kValPerThread * t + u] = static_cast<uint16_t>(own[u]);
  }
  __syncthreads();
  const bool flat = in_span && sm.own[h + ng - 1] == t + 1;
  sm.flat[t] = flat;
  sm.head[t] = static_cast<int32_t>(h);
  sm.n[t] = static_cast<int32_t>(n);
  sm.slot[t] = static_cast<int32_t>(slot0);
  __pipeline_wait_prior(0);
  __syncthreads();
  // the flat rows' groups, and the prefix of their sums over the tile
  uint32_t v[kValPerThread][4];
  uint32_t gsum[kValPerThread];
  uint32_t total = 0;
#pragma unroll
  for (int u = 0; u < kValPerThread; ++u) {
    const int p = kValPerThread * t + u;
    const int o = static_cast<int>(own[u]) - 1;
    gsum[u] = 0;
    if (p < gspan && o >= 0 && sm.flat[o] && 4 * (p - sm.head[o]) < sm.n[o]) {
      gsum[u] = vgb_group(s, sm.win, a, nwin, sm.tp[p], v[u]);
    }
    total += gsum[u];
  }
  uint32_t all;
  uint32_t x = block_prefix(total, sm.sums, &all) - total;
#pragma unroll
  for (int u = 0; u < kValPerThread; ++u) {
    sm.pre[kValPerThread * t + u] = x;
    x += gsum[u];
  }
  __syncthreads();
  auto put = [&](int64_t slot, uint32_t id) {
    const int64_t rel = slot - cbase;
    if (rel >= 0 && rel < kValSlots) {
      sm.ids[rel] = static_cast<int32_t>(id);
      sm.flag[rel] = 1;
    } else if (slot >= 0 && slot < ncol) {
      col[slot] = static_cast<int32_t>(id);
    }
  };
#pragma unroll
  for (int u = 0; u < kValPerThread; ++u) {
    const int p = kValPerThread * t + u;
    if (own[u] == 0 || p >= gspan) continue;
    const int w = static_cast<int>(own[u]) - 1;
    if (!sm.flat[w]) continue;
    const int j = p - sm.head[w];
    const int64_t rn = sm.n[w];
    if (4 * static_cast<int64_t>(j) >= rn) continue;
    const uint32_t base = sm.pre[p] - sm.pre[sm.head[w]];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t e = 4 * static_cast<int64_t>(j) + k;
      if (e < rn) put(sm.slot[w] + e, base + v[u][k]);
    }
  }
  if (mine && !flat) {
    vgb_values_row(s, tagpos, n_g, sm.win, a, nwin, g0, n, slot0, put);
  }
  for (int64_t r2 = r + kThreads; r2 < r_hi; r2 += kThreads) {
    const int64_t n2 = __ldg(counts + r2);
    const int64_t ng2 = n2 > 0 ? (n2 + 3) >> 2 : 0;
    if (ng2 <= 0 || ng2 > long_groups) continue;
    vgb_values_row(s, tagpos, n_g, sm.win, a, nwin, __ldg(gbase + r2), n2,
                   __ldg(out_slot + r2), put);
  }
  __syncthreads();
  flush_ids(sm.ids, sm.flag, cbase, col, ncol);
}

// A block a long row (widest first) and then a block a tile: row k of
// tiles (kValCols int32) is the tile's first row, its first group and
// groups, and its first slot; its last row is the next row's first.
__global__ void __launch_bounds__(kThreads)
vgb_values_kernel(const Bytes s, const int32_t* __restrict__ tagpos,
                  int64_t n_g, const int32_t* __restrict__ gbase,
                  const int32_t* __restrict__ counts,
                  const int32_t* __restrict__ out_slot, int64_t rows,
                  const int32_t* __restrict__ long_rows, int64_t n_long,
                  const int32_t* __restrict__ tiles, int long_groups,
                  int32_t* __restrict__ col, int64_t ncol) {
  __shared__ VgbValues sm;
  const int64_t b = blockIdx.x;
  if (b < n_long) {
    const int64_t r = __ldg(long_rows + b);
    if (r >= 0 && r < rows) {
      vgb_values_long(s, tagpos, n_g, __ldg(gbase + r), __ldg(counts + r),
                      __ldg(out_slot + r), col, ncol, sm);
    }
    return;
  }
  const int32_t* t = tiles + (b - n_long) * kValCols;
  int64_t lo = __ldg(t);
  int64_t hi = __ldg(t + kValCols);
  lo = lo < 0 ? 0 : lo;
  hi = hi > rows ? rows : hi;
  vgb_values_tile(s, tagpos, n_g, gbase, counts, out_slot, lo, hi,
                  __ldg(t + 1), __ldg(t + 2), __ldg(t + 3), long_groups, col,
                  ncol, sm);
}

}  // namespace

// Common to every entry: the stream is `bytes` (nbytes of them, at least 1),
// every other array int32, all on CUDA device `device`; `stream` a
// cudaStream_t of that device. The library links its own CUDA runtime, so
// each entry selects `device` before launching. Each returns the first CUDA
// error (0 on success), allocates nothing and does not synchronise; with no
// rows it launches nothing.

// col[out_slot[r] + i] for i < counts[r]: row r's ids, its key bytes from
// byte key_start[r] and its values right after them. The rows of more than
// long_values values are long_rows (n_long of them, widest first: a block
// each); the others are covered by the tiles (a warp each), tiles[k] ..
// tiles[k + 1] the rows of tile k (n_tiles + 1 entries). A row left out of
// both is not written.
extern "C" int gab_svb_decode(const void* bytes, int64_t nbytes,
                              const void* key_start, const void* counts,
                              const void* out_slot, int64_t rows,
                              const void* long_rows, int64_t n_long,
                              const void* tiles, int64_t n_tiles,
                              int64_t long_values, void* col, int64_t ncol,
                              int device, void* stream) {
  if (nbytes < 1 || rows < 0 || n_long < 0 || n_tiles < 0 ||
      n_long + n_tiles > 0x7fffffff || long_values < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = n_long + (n_tiles + kWarpsPerBlock - 1) /
                                    kWarpsPerBlock;
  if (rows > 0 && grid > 0) {
    svb_decode_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        Bytes{static_cast<const uint8_t*>(bytes), nbytes},
        static_cast<const int32_t*>(key_start),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(out_slot), rows,
        static_cast<const int32_t*>(long_rows), n_long,
        static_cast<const int32_t*>(tiles), n_tiles, long_values,
        static_cast<int32_t*>(col), ncol);
  }
  return static_cast<int>(cudaGetLastError());
}

// tagpos[gbase[r] + j] for j < ngroups[r]: the byte of row r's j-th tag, the
// first at byte pos[r]. The rows of more than long_groups groups are
// long_rows (n_long of them, widest first: a block each); the others are
// covered by the tiles (a block each): row k of tiles (n_tiles + 1 rows of
// kTileCols int32) is the tile's first row, the first byte and the number
// of bytes to stage, the first slot and the number of slots to collect;
// its last row is tiles[k + 1][0], so row n_tiles holds the end. A row left
// out of both is not written.
extern "C" int gab_vgb_tags(const void* bytes, int64_t nbytes,
                            const void* pos, const void* ngroups,
                            const void* gbase, int64_t rows,
                            const void* long_rows, int64_t n_long,
                            const void* tiles, int64_t n_tiles,
                            int long_groups, void* tagpos, int64_t n_g,
                            int device, void* stream) {
  if (nbytes < 1 || rows < 0 || n_long < 0 || n_tiles < 0 ||
      n_long + n_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0 && n_long + n_tiles > 0) {
    vgb_tags_kernel<<<static_cast<unsigned>(n_long + n_tiles), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        Bytes{static_cast<const uint8_t*>(bytes), nbytes},
        static_cast<const int32_t*>(pos), static_cast<const int32_t*>(ngroups),
        static_cast<const int32_t*>(gbase), rows,
        static_cast<const int32_t*>(long_rows), n_long,
        static_cast<const int32_t*>(tiles), long_groups,
        static_cast<int32_t*>(tagpos), n_g);
  }
  return static_cast<int>(cudaGetLastError());
}

// col[out_slot[r] + i] for i < counts[r]: row r's ids from its groups
// gbase[r] .. gbase[r] + ceil(counts[r] / 4), whose tags are at tagpos (n_g).
// The rows of more than long_groups groups are long_rows (n_long of them,
// widest first: a block each); the others are covered by the tiles (a
// block each): row k of tiles (n_tiles + 1 rows of kValCols int32) is the
// tile's first row, its first group, the groups to stage and its first
// slot; its last row is tiles[k + 1][0], so row n_tiles holds the end. A
// row left out of both is not written.
extern "C" int gab_vgb_values(const void* bytes, int64_t nbytes,
                              const void* tagpos, int64_t n_g,
                              const void* gbase, const void* counts,
                              const void* out_slot, int64_t rows,
                              const void* long_rows, int64_t n_long,
                              const void* tiles, int64_t n_tiles,
                              int long_groups, void* col, int64_t ncol,
                              int device, void* stream) {
  if (nbytes < 1 || rows < 0 || n_long < 0 || n_tiles < 0 ||
      n_long + n_tiles > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > 0 && n_long + n_tiles > 0) {
    vgb_values_kernel<<<static_cast<unsigned>(n_long + n_tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        Bytes{static_cast<const uint8_t*>(bytes), nbytes},
        static_cast<const int32_t*>(tagpos), n_g,
        static_cast<const int32_t*>(gbase),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(out_slot), rows,
        static_cast<const int32_t*>(long_rows), n_long,
        static_cast<const int32_t*>(tiles), long_groups,
        static_cast<int32_t*>(col), ncol);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gab_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
