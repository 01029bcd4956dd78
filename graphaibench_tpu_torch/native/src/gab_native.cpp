// Native host-side kernels for graphaibench_tpu_torch.
//
// The device path is PyTorch and CUDA; the host-side hot loops that feed
// it are native, as in the JAX package's native/src/gab_native.cpp, from
// which these functions are taken unchanged so that both packages build
// bit-equal graphs:
//   * CSR construction from edge lists (counting sort)
//   * stable counting sort by key (the transpose-edge permutation)
//   * degree-bucketed ELL packing
// All entry points are extern "C" for ctypes; arrays are caller-allocated
// numpy buffers. OpenMP parallelism where profitable.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC gab_native.cpp

#include <algorithm>
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

}  // extern "C"

