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
