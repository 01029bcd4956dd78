// Native host-side kernels for graphaibench_tpu_torch.
//
// The device path is PyTorch and CUDA; the host-side hot loops that feed
// it are native, as in the JAX package's native/src/gab_native.cpp, from
// which these functions are taken unchanged so that both packages build
// bit-equal graphs:
//   * CSR construction from edge lists (counting sort)
//   * degree-ordered DAG orientation (triangle counting)
//   * stable counting sort by key (the transpose-edge permutation)
//   * degree-bucketed ELL packing
//   * the GraphSAINT frontier sampler
//   * the CGR bit codec, encode and decode (same bits as compress/cgr.py)
// All entry points are extern "C" for ctypes; arrays are caller-allocated
// numpy buffers. OpenMP parallelism where profitable.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC gab_native.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// CSR construction: counting-sort edges by (src, dst). Returns 0 on ok.
int build_csr(int64_t ne, const int64_t* src, const int64_t* dst,
              int64_t nv, int64_t* row_ptr /*nv+1*/, int32_t* col_idx /*ne*/,
              int sort_neighbors) {
  std::vector<int64_t> counts(nv + 1, 0);
  for (int64_t e = 0; e < ne; e++) counts[src[e] + 1]++;
  for (int64_t v = 0; v < nv; v++) counts[v + 1] += counts[v];
  std::memcpy(row_ptr, counts.data(), (nv + 1) * sizeof(int64_t));
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t e = 0; e < ne; e++) col_idx[cursor[src[e]]++] = (int32_t)dst[e];
  if (sort_neighbors) {
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t v = 0; v < nv; v++)
      std::sort(col_idx + row_ptr[v], col_idx + row_ptr[v + 1]);
  }
  return 0;
}

// ---------------------------------------------------------------------
// DAG orientation (graph.cc:615-700 semantics): keep (u,v) iff
// deg(v) > deg(u) or (== and v > u). Two-pass: count then fill.
int64_t orient_count(int64_t nv, const int64_t* row_ptr, const int32_t* col_idx,
                     int64_t* new_row_ptr /*nv+1*/) {
  std::vector<int64_t> deg(nv);
#pragma omp parallel for
  for (int64_t v = 0; v < nv; v++) deg[v] = row_ptr[v + 1] - row_ptr[v];
  std::vector<int64_t> nd(nv, 0);
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t u = 0; u < nv; u++) {
    int64_t c = 0;
    for (int64_t e = row_ptr[u]; e < row_ptr[u + 1]; e++) {
      int64_t v = col_idx[e];
      if (deg[v] > deg[u] || (deg[v] == deg[u] && v > u)) c++;
    }
    nd[u] = c;
  }
  new_row_ptr[0] = 0;
  for (int64_t v = 0; v < nv; v++) new_row_ptr[v + 1] = new_row_ptr[v] + nd[v];
  return new_row_ptr[nv];
}

void orient_fill(int64_t nv, const int64_t* row_ptr, const int32_t* col_idx,
                 const int64_t* new_row_ptr, int32_t* new_col_idx) {
  std::vector<int64_t> deg(nv);
#pragma omp parallel for
  for (int64_t v = 0; v < nv; v++) deg[v] = row_ptr[v + 1] - row_ptr[v];
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t u = 0; u < nv; u++) {
    int64_t w = new_row_ptr[u];
    for (int64_t e = row_ptr[u]; e < row_ptr[u + 1]; e++) {
      int64_t v = col_idx[e];
      if (deg[v] > deg[u] || (deg[v] == deg[u] && v > u)) new_col_idx[w++] = (int32_t)v;
    }
  }
}

// ---------------------------------------------------------------------
// Stable counting sort by small integer key: perm[j] = original index of
// the j-th element in key-sorted order, ties in original order.
//
// Host-preprocessing workhorse: the GAT-adjoint transpose permutation
// (lexsort (src,dst) over a src-major COO == stable sort by dst; the
// csr2csc-once analog of gat_aggregator.cu:88-92) and the seg-ELL
// column partition (key = dst >> seg_bits). np.lexsort at rmat20's 62M
// edges costs ~9.4 s; this runs the same permutation in O(ne).
//
// Parallel: per-thread chunk histograms, key-major exclusive prefix over
// (key, thread), then each thread re-scans its chunk placing elements —
// chunk order per thread preserves stability. Histogram memory is
// nthreads*(nkeys+1)*8 B, so threads are capped for large key spaces.
int stable_key_sort(int64_t n, const int32_t* keys, int64_t nkeys,
                    int32_t* perm) {
  if (n <= 0) return 0;
  int nt = 1;
#ifdef _OPENMP
  nt = omp_get_max_threads();
  // cap histogram memory at ~512 MB
  int64_t max_t = (int64_t)((512ll << 20) / ((nkeys + 1) * 8));
  if (max_t < 1) max_t = 1;
  if (nt > max_t) nt = (int)max_t;
  if (nt > 64) nt = 64;
#endif
  std::vector<std::vector<int64_t>> hist(nt);
  int64_t chunk = (n + nt - 1) / nt;
#pragma omp parallel for num_threads(nt) schedule(static, 1)
  for (int t = 0; t < nt; t++) {
    hist[t].assign(nkeys, 0);
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    for (int64_t e = lo; e < hi; e++) {
      int64_t k = keys[e];
      if (k >= 0 && k < nkeys) hist[t][k]++;
    }
  }
  // exclusive prefix in (key, thread) order -> per-thread start cursors
  int64_t run = 0;
  for (int64_t k = 0; k < nkeys; k++) {
    for (int t = 0; t < nt; t++) {
      int64_t c = hist[t][k];
      hist[t][k] = run;
      run += c;
    }
  }
  if (run != n) return -1;  // out-of-range key seen
#pragma omp parallel for num_threads(nt) schedule(static, 1)
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    for (int64_t e = lo; e < hi; e++) perm[hist[t][keys[e]]++] = (int32_t)e;
  }
  return 0;
}

// ---------------------------------------------------------------------
// ELL bucket packing (device_graph._virtual_rows + _pack_buckets in one
// native pass): split each row into <=split-wide virtual rows, class
// each virtual row into the smallest width bucket that fits, and write
// padded (R, W) neighbor/edge-id matrices per bucket.
//
// Two-phase: ell_pack_count fills per-width virtual-row counts (the
// caller allocates flat output buffers from them), ell_pack_fill writes
// row_ids / nbr / edge_id into those buffers at per-width offsets.
// Padding: nbr = 0, edge_id = sentinel. eid == nullptr means identity
// edge ids (the plain CSR packing). Rows with count 0 are skipped.
int64_t ell_pack_count(int64_t nrows, const int64_t* counts,
                       const int32_t* widths, int nw, int64_t split,
                       int64_t* out_counts /* nw */) {
  for (int i = 0; i < nw; i++) out_counts[i] = 0;
  int64_t total = 0;
#pragma omp parallel
  {
    std::vector<int64_t> local(nw, 0);
#pragma omp for schedule(static) nowait
    for (int64_t r = 0; r < nrows; r++) {
      int64_t c = counts[r];
      if (c <= 0) continue;
      int64_t nfull = c / split, rem = c % split;
      local[nw - 1] += nfull;  // full chunks land in the last (==split) class
      if (rem) {
        int wi = 0;
        while (widths[wi] < rem) wi++;
        local[wi]++;
      }
    }
#pragma omp critical
    for (int i = 0; i < nw; i++) out_counts[i] += local[i];
  }
  for (int i = 0; i < nw; i++) total += out_counts[i];
  return total;
}

int ell_pack_fill(int64_t nrows, const int32_t* targets, const int64_t* starts,
                  const int64_t* counts, const int32_t* col,
                  const int64_t* eid /* or nullptr */, int64_t sentinel,
                  const int32_t* widths, int nw, int64_t split,
                  int32_t* rows_flat, int32_t* nbr_flat, int32_t* eid_flat,
                  const int64_t* row_off /* nw+1 */,
                  const int64_t* slot_off /* nw+1 */) {
  std::vector<int64_t> cur(nw, 0);  // virtual-row cursor per width class
  for (int64_t r = 0; r < nrows; r++) {
    int64_t c = counts[r];
    if (c <= 0) continue;
    int64_t s = starts[r];
    for (int64_t off = 0; off < c; off += split) {
      int64_t l = std::min(split, c - off);
      int wi = 0;
      while (widths[wi] < l) wi++;
      int64_t w = widths[wi];
      int64_t k = cur[wi]++;
      rows_flat[row_off[wi] + k] = targets[r];
      int32_t* nb = nbr_flat + slot_off[wi] + k * w;
      int32_t* eb = eid_flat + slot_off[wi] + k * w;
      const int32_t* cp = col + s + off;
      if (eid) {
        const int64_t* ep = eid + s + off;
        for (int64_t j = 0; j < l; j++) { nb[j] = cp[j]; eb[j] = (int32_t)ep[j]; }
      } else {
        int64_t base = s + off;
        for (int64_t j = 0; j < l; j++) { nb[j] = cp[j]; eb[j] = (int32_t)(base + j); }
      }
      for (int64_t j = l; j < w; j++) { nb[j] = 0; eb[j] = (int32_t)sentinel; }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------
// Bit writer matching compress/unary.py (MSB-first).
struct BitWriter {
  std::vector<uint8_t> buf;
  uint32_t cur = 0;
  int nbits = 0;
  inline void write(uint64_t value, int length) {
    for (int i = length - 1; i >= 0; i--) {
      cur = (cur << 1) | ((value >> i) & 1ull);
      if (++nbits == 8) { buf.push_back((uint8_t)cur); cur = 0; nbits = 0; }
    }
  }
  inline int64_t bit_length() const { return (int64_t)buf.size() * 8 + nbits; }
  inline void align(int unit_bits) {
    int64_t pad = (unit_bits - (bit_length() % unit_bits)) % unit_bits;
    if (pad) write(0, (int)pad);
  }
  inline void append(const BitWriter& o) {
    // bitwise append of another writer's stream
    int64_t n = o.bit_length();
    for (int64_t i = 0; i < n; i++) {
      int byte = (int)(i >> 3), bit;
      if (byte < (int)o.buf.size())
        bit = (o.buf[byte] >> (7 - (i & 7))) & 1;
      else
        bit = (o.cur >> (o.nbits - 1 - (i - (int64_t)o.buf.size() * 8))) & 1;
      write(bit, 1);
    }
  }
  void flush_to(uint8_t* out) {
    std::memcpy(out, buf.data(), buf.size());
    if (nbits) out[buf.size()] = (uint8_t)((cur << (8 - nbits)) & 0xFF);
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t pos;
  inline int read1() {
    int bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
    pos++;
    return bit;
  }
  inline uint64_t read(int length) {
    uint64_t v = 0;
    for (int i = 0; i < length; i++) v = (v << 1) | read1();
    return v;
  }
  inline int read_unary_then() {
    int n = 0;
    while (true) { n++; if (read1()) return n; }
  }
};

static inline int bitlen(uint64_t y) { int l = 0; while (y > 1) { y >>= 1; l++; } return l; }
static inline int64_t int2nat(int64_t x) { return x >= 0 ? (x << 1) : -((x << 1) + 1); }
static inline int64_t nat2int(int64_t n) { return (n & 1) == 0 ? (n >> 1) : -((n + 1) >> 1); }
static inline int gamma_len(int64_t x) { return 2 * bitlen((uint64_t)(x + 1)) + 1; }
static inline void write_gamma(BitWriter& w, int64_t x) {
  uint64_t y = (uint64_t)(x + 1);
  int len = bitlen(y);
  w.write(1, len + 1);
  w.write(y, len);
}
static inline int zeta_len(int64_t x, int k) {
  if (k == 1) return gamma_len(x);
  int len = bitlen((uint64_t)(x + 1));
  int h = len / k;
  return (h + 1) * (k + 1);
}
static inline void write_zeta(BitWriter& w, int64_t x, int k) {
  if (k == 1) return write_gamma(w, x);
  uint64_t y = (uint64_t)(x + 1);
  int len = bitlen(y);
  int h = len / k;
  w.write(1, h + 1);
  w.write(y, (h + 1) * k);
}
static inline int64_t read_gamma(BitReader& r) {
  int n = r.read_unary_then();
  int len = n - 1;
  uint64_t y = (1ull << len) | r.read(len);
  return (int64_t)y - 1;
}
static inline int64_t read_zeta(BitReader& r, int k) {
  if (k == 1) return read_gamma(r);
  int n = r.read_unary_then();
  int h = n - 1;
  uint64_t y = r.read((h + 1) * k);
  return (int64_t)y - 1;
}

// CGR encode of one adjacency list into `w`. Residual-only paths
// (use_interval fully supported), matching compress/cgr.py.
static void cgr_encode_vertex(int64_t v, const int32_t* adj, int64_t deg,
                              int zeta_k, int use_interval, int min_itv_len,
                              int itv_seg_len, int res_seg_len, int add_degree,
                              BitWriter& w) {
  if (add_degree || res_seg_len == 0) {
    write_gamma(w, deg);
    if (deg == 0) return;
  }
  std::vector<int64_t> itv_left, itv_len, residuals;
  if (use_interval) {
    int64_t i = 0;
    while (i < deg) {
      int64_t j = i + 1;
      while (j < deg && adj[j - 1] + 1 == adj[j]) j++;
      int64_t run = j - i;
      if (min_itv_len && run >= min_itv_len) {
        itv_left.push_back(adj[i]);
        itv_len.push_back(run);
      } else {
        for (int64_t t = i; t < j; t++) residuals.push_back(adj[t]);
      }
      i = j;
    }
  } else {
    residuals.assign(adj, adj + deg);
  }

  // generic segmented encoder: encode_fn(writer, idx, is_first)
  auto encode_segmented = [&](int64_t count, int seg_len,
                              auto item_len_first, auto item_len_next,
                              auto write_item) {
    std::vector<std::pair<int64_t, int64_t>> segs;  // [start, end)
    int64_t cur_start = 0;
    int64_t cur_bits = 0;
    for (int64_t i = 0; i < count; i++) {
      int64_t cur_n = i - cur_start;
      int64_t add = (cur_n == 0) ? item_len_first(i) : item_len_next(i);
      if (seg_len && cur_n > 0 &&
          gamma_len(cur_n + 1) + cur_bits + add > seg_len) {
        segs.push_back({cur_start, i});
        cur_start = i;
        cur_bits = item_len_first(i);
      } else {
        cur_bits += add;
      }
    }
    // merge trailing partial group into last closed segment (gap-coded)
    int64_t tail_start = cur_start;
    bool merged = !segs.empty();
    if (!merged) segs.push_back({0, count});
    write_gamma(w, (int64_t)segs.size() - 1);
    for (size_t si = 0; si < segs.size(); si++) {
      bool last = (si + 1 == segs.size());
      int64_t s = segs[si].first, e = segs[si].second;
      int64_t n_items = e - s + ((last && merged) ? (count - tail_start) : 0);
      BitWriter sub;
      write_gamma(sub, n_items);
      for (int64_t i = s; i < e; i++) write_item(sub, i, i == s);
      if (last && merged)
        for (int64_t i = tail_start; i < count; i++) write_item(sub, i, false);
      if (seg_len && !last) sub.align(seg_len);
      w.append(sub);
    }
  };

  if (use_interval) {
    auto ilen_first = [&](int64_t i) {
      return gamma_len(int2nat(itv_left[i] - v)) +
             gamma_len(itv_len[i] - min_itv_len);
    };
    auto ilen_next = [&](int64_t i) {
      return gamma_len(itv_left[i] - itv_left[i - 1] - itv_len[i - 1] - 1) +
             gamma_len(itv_len[i] - min_itv_len);
    };
    auto iwrite = [&](BitWriter& sub, int64_t i, bool first) {
      int64_t val = first ? int2nat(itv_left[i] - v)
                          : itv_left[i] - itv_left[i - 1] - itv_len[i - 1] - 1;
      write_gamma(sub, val);
      write_gamma(sub, itv_len[i] - min_itv_len);
    };
    encode_segmented((int64_t)itv_left.size(), itv_seg_len, ilen_first,
                     ilen_next, iwrite);
  }

  if (res_seg_len == 0) {
    if (!residuals.empty()) {
      write_zeta(w, int2nat(residuals[0] - v), zeta_k);
      for (size_t i = 1; i < residuals.size(); i++)
        write_zeta(w, residuals[i] - residuals[i - 1] - 1, zeta_k);
    }
  } else {
    auto rlen_first = [&](int64_t i) {
      return zeta_len(int2nat(residuals[i] - v), zeta_k);
    };
    auto rlen_next = [&](int64_t i) {
      return zeta_len(residuals[i] - residuals[i - 1] - 1, zeta_k);
    };
    auto rwrite = [&](BitWriter& sub, int64_t i, bool first) {
      int64_t val = first ? int2nat(residuals[i] - v)
                          : residuals[i] - residuals[i - 1] - 1;
      write_zeta(sub, val, zeta_k);
    };
    encode_segmented((int64_t)residuals.size(), res_seg_len, rlen_first,
                     rlen_next, rwrite);
  }
}

// Encode the whole graph. Two-phase: caller first calls with out=NULL to
// get the total byte size, then with a big-enough buffer.
// offsets: (nv+1) int64 in alignment units (1=bit, 8=byte, 32=word bits).
int64_t cgr_encode_graph(int64_t nv, const int64_t* row_ptr,
                         const int32_t* col_idx, int zeta_k, int use_interval,
                         int min_itv_len, int itv_seg_len, int res_seg_len,
                         int add_degree, int unit_bits, int64_t* offsets,
                         uint8_t* out, int64_t out_cap) {
  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<std::vector<uint8_t>> chunks(nv);
  std::vector<int64_t> units(nv);
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t v = 0; v < nv; v++) {
    BitWriter w;
    cgr_encode_vertex(v, col_idx + row_ptr[v], row_ptr[v + 1] - row_ptr[v],
                      zeta_k, use_interval, min_itv_len, itv_seg_len,
                      res_seg_len, add_degree, w);
    if (unit_bits > 1) w.align(unit_bits);
    units[v] = (w.bit_length() + unit_bits - 1) / unit_bits;
    chunks[v].resize((w.bit_length() + 7) / 8);
    w.flush_to(chunks[v].data());
    // keep exact bit length in the last element trick: store bits in
    // a side channel via offsets later; here bits are unit-aligned
    // except possibly for unit_bits == 1 (pure bit stream).
  }
  offsets[0] = 0;
  for (int64_t v = 0; v < nv; v++) offsets[v + 1] = offsets[v] + units[v];
  // concatenate bit-exactly
  BitWriter all;
  for (int64_t v = 0; v < nv; v++) {
    int64_t nbits = units[v] * unit_bits;
    BitReader r{chunks[v].data(), 0};
    for (int64_t i = 0; i < nbits; i++) all.write(r.read1(), 1);
  }
  int64_t total_bytes = (all.bit_length() + 7) / 8;
  if (out && out_cap >= total_bytes) all.flush_to(out);
  return total_bytes;
}

// Decode one vertex; returns its degree. out must have room.
int64_t cgr_decode_vertex(const uint8_t* data, int64_t bit_offset, int64_t v,
                          int64_t degree, int zeta_k, int use_interval,
                          int min_itv_len, int itv_seg_len, int res_seg_len,
                          int add_degree, int32_t* out) {
  BitReader r{data, bit_offset};
  if (add_degree || res_seg_len == 0) {
    degree = read_gamma(r);
    if (degree == 0) return 0;
  }
  int64_t n_out = 0;
  std::vector<std::pair<int64_t, int64_t>> intervals;
  if (use_interval) {
    int64_t nseg = read_gamma(r) + 1;
    int64_t base = r.pos;
    for (int64_t si = 0; si < nseg; si++) {
      if (si) {
        int64_t used = r.pos - base;
        r.pos = base + ((used + itv_seg_len - 1) / itv_seg_len) * itv_seg_len;
      }
      int64_t cnt = read_gamma(r);
      int64_t prev_left = 0, prev_len = 0;
      for (int64_t i = 0; i < cnt; i++) {
        int64_t left = (i == 0) ? v + nat2int(read_gamma(r))
                                : prev_left + prev_len + 1 + read_gamma(r);
        int64_t ln = read_gamma(r) + min_itv_len;
        intervals.push_back({left, ln});
        prev_left = left; prev_len = ln;
      }
    }
  }
  std::vector<int64_t> residuals;
  if (res_seg_len == 0) {
    int64_t n_itv = 0;
    for (auto& p : intervals) n_itv += p.second;
    int64_t n_res = degree - n_itv;
    if (n_res > 0) {
      residuals.push_back(v + nat2int(read_zeta(r, zeta_k)));
      for (int64_t i = 1; i < n_res; i++)
        residuals.push_back(residuals.back() + 1 + read_zeta(r, zeta_k));
    }
  } else {
    int64_t nseg = read_gamma(r) + 1;
    int64_t base = r.pos;
    for (int64_t si = 0; si < nseg; si++) {
      if (si) {
        int64_t used = r.pos - base;
        r.pos = base + ((used + res_seg_len - 1) / res_seg_len) * res_seg_len;
      }
      int64_t cnt = read_gamma(r);
      for (int64_t i = 0; i < cnt; i++) {
        if (i == 0) residuals.push_back(v + nat2int(read_zeta(r, zeta_k)));
        else residuals.push_back(residuals.back() + 1 + read_zeta(r, zeta_k));
      }
    }
  }
  for (auto x : residuals) out[n_out++] = (int32_t)x;
  for (auto& p : intervals)
    for (int64_t i = 0; i < p.second; i++) out[n_out++] = (int32_t)(p.first + i);
  std::sort(out, out + n_out);
  return n_out;
}

// Decode the whole graph (parallel over vertices). degrees==NULL is
// allowed only when the stream embeds degrees.
int64_t cgr_decode_graph(int64_t nv, const uint8_t* data,
                         const int64_t* offsets, const int64_t* row_ptr_out,
                         const int64_t* degrees, int zeta_k, int use_interval,
                         int min_itv_len, int itv_seg_len, int res_seg_len,
                         int add_degree, int unit_bits, int32_t* col_out) {
  std::atomic<int64_t> bad{0};
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t v = 0; v < nv; v++) {
    int64_t deg = degrees ? degrees[v] : -1;
    int64_t n = cgr_decode_vertex(data, offsets[v] * unit_bits, v, deg, zeta_k,
                                  use_interval, min_itv_len, itv_seg_len,
                                  res_seg_len, add_degree,
                                  col_out + row_ptr_out[v]);
    if (degrees && n != row_ptr_out[v + 1] - row_ptr_out[v]) bad++;
  }
  return bad.load();
}

// ---------------------------------------------------------------------
// GraphSAINT frontier sampler (sampler.cpp:163-293 distribution):
// m seed frontier slots from train_nodes, then n-m expansions choosing a
// slot weighted by clipped degree, hopping to a uniform neighbor.
// Returns number of unique sampled vertices written to out (sorted).
static inline uint64_t xorshift64(uint64_t& s) {
  s ^= s << 13; s ^= s >> 7; s ^= s << 17; return s;
}

int64_t saint_sample(int64_t nv, const int64_t* row_ptr, const int32_t* col_idx,
                     const int64_t* train_nodes, int64_t n_train, int64_t n,
                     int64_t m, int64_t clip, uint64_t seed, int32_t* out) {
  if (m > n) m = n;
  uint64_t s = seed * 2654435761ull + 1442695040888963407ull;
  std::vector<int64_t> frontier(m);
  std::vector<double> weights(m);
  std::vector<uint8_t> in_sample(nv, 0);
  int64_t n_sampled = 0;
  auto deg = [&](int64_t v) { return row_ptr[v + 1] - row_ptr[v]; };
  for (int64_t i = 0; i < m; i++) {
    int64_t v = train_nodes[xorshift64(s) % (uint64_t)n_train];
    frontier[i] = v;
    if (!in_sample[v]) { in_sample[v] = 1; n_sampled++; }
    weights[i] = (double)std::min(deg(v), clip);
  }
  for (int64_t it = 0; it < n - m; it++) {
    double total = 0;
    for (int64_t i = 0; i < m; i++) total += weights[i];
    if (total <= 0) break;
    double pick = (double)(xorshift64(s) >> 11) / 9007199254740992.0 * total;
    int64_t slot = 0;
    double acc = 0;
    for (; slot < m; slot++) {
      acc += weights[slot];
      if (pick < acc) break;
    }
    if (slot == m) slot = m - 1;
    int64_t v = frontier[slot];
    int64_t d = deg(v);
    if (d > 0) {
      int64_t u = col_idx[row_ptr[v] + (int64_t)(xorshift64(s) % (uint64_t)d)];
      if (!in_sample[u]) { in_sample[u] = 1; n_sampled++; }
      frontier[slot] = u;
      weights[slot] = (double)std::min(deg(u), clip);
    } else {
      weights[slot] = 0.0;
    }
  }
  int64_t k = 0;
  for (int64_t v = 0; v < nv; v++)
    if (in_sample[v]) out[k++] = (int32_t)v;
  return k;
}

}  // extern "C"
