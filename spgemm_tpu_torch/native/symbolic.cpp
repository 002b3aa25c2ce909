// Native symbolic join of the port (the port's copy of the JAX package's
// spgemm_tpu/native/symbolic.cpp, with the same C ABI).
//
// The reference's symbolic join is a hash-map build and probe on the host
// (sparse_matrix_mult.cu:141-156), its "CPU hot loop #1" (SURVEY.md section
// 3.2).  Here the join over sorted block coordinates is a searchsorted range
// per A block followed by a stable LSD radix sort of the fused output keys.
// The numpy join (spgemm_tpu_torch/ops/symbolic.py) is the plain version
// the tests hold this one against.
//
// Contract (that of ops/symbolic.symbolic_join):
//   inputs : a_coords (na, 2) int64 lex-sorted; b_coords (nb, 2) lex-sorted;
//            (max a row + 1) * (max b col + 1) <= 2^64, so that the fused
//            key row * span + col cannot wrap (the caller checks)
//   outputs: keys (nk, 2) int64 lex-sorted, pair_ptr (nk+1) int64,
//            pair_a / pair_b (total) int32 -- per key in ascending inner
//            block-coordinate order (the std::map traversal order parity
//            depends on, SURVEY.md section 2.9).
//
// One change against the JAX package's copy: the radix histogram lives on
// the heap, not in 512 KB of the calling thread's stack (the caller may be
// a worker thread with a small stack).
//
// Build: spgemm_tpu_torch/utils/native.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

void smm_sym_free(void *p) { free(p); }

// Stable LSD radix sort of (key, payload-index) by 64-bit key, 16-bit digits.
// idx is permuted; keys_in is read-only.  Skips passes whose digits are
// constant across the live key range (common: high words are mostly zero).
static int radix_sort_idx(const uint64_t *keys, int64_t *idx, int64_t n,
                          int64_t *scratch) {
  if (n <= 1) return 0;
  int64_t *hist = nullptr;
  uint64_t all_or = 0, all_and = ~0ull;
  for (int64_t i = 0; i < n; ++i) {
    all_or |= keys[i];
    all_and &= keys[i];
  }
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 16;
    const uint64_t varying = (all_or ^ all_and) >> shift & 0xFFFF;
    if (!varying) continue;  // digit constant across all keys: stable no-op
    if (!hist) {
      hist = (int64_t *)malloc(65536 * sizeof(int64_t));
      if (!hist) return -4;
    }
    memset(hist, 0, 65536 * sizeof(int64_t));
    for (int64_t i = 0; i < n; ++i)
      ++hist[(keys[idx[i]] >> shift) & 0xFFFF];
    int64_t sum = 0;
    for (int d = 0; d < 65536; ++d) {
      int64_t c = hist[d];
      hist[d] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i)
      scratch[hist[(keys[idx[i]] >> shift) & 0xFFFF]++] = idx[i];
    memcpy(idx, scratch, (size_t)n * sizeof(int64_t));
  }
  free(hist);
  return 0;
}

// Lower/upper bound over b's sorted row column.
static int64_t lower_bound_row(const int64_t *b_rows, int64_t nb, int64_t v) {
  int64_t lo = 0, hi = nb;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (b_rows[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}
static int64_t upper_bound_row(const int64_t *b_rows, int64_t nb, int64_t v) {
  int64_t lo = 0, hi = nb;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (b_rows[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Returns 0 on success, -4 on allocation failure.
// Outputs are malloc'd; caller frees each with smm_sym_free.
int smm_symbolic_join(const int64_t *a_coords, int64_t na,
                      const int64_t *b_coords, int64_t nb,
                      int64_t **keys_out, int64_t *num_keys_out,
                      int64_t **pair_ptr_out,
                      int32_t **pair_a_out, int32_t **pair_b_out,
                      int64_t *total_out) {
  *keys_out = nullptr;
  *pair_ptr_out = nullptr;
  *pair_a_out = nullptr;
  *pair_b_out = nullptr;
  *num_keys_out = 0;
  *total_out = 0;
  if (na == 0 || nb == 0) {
    *pair_ptr_out = (int64_t *)calloc(1, sizeof(int64_t));
    return *pair_ptr_out ? 0 : -4;
  }

  // b rows as a contiguous array for binary search, and the key span
  int64_t *b_rows = (int64_t *)malloc((size_t)nb * sizeof(int64_t));
  if (!b_rows) return -4;
  int64_t max_c = 0;
  for (int64_t i = 0; i < nb; ++i) {
    b_rows[i] = b_coords[2 * i];
    if (b_coords[2 * i + 1] > max_c) max_c = b_coords[2 * i + 1];
  }
  const uint64_t span = (uint64_t)max_c + 1;

  // per-A-block matching B range; total pair count
  int64_t *lo = (int64_t *)malloc((size_t)na * sizeof(int64_t));
  int64_t *hi = (int64_t *)malloc((size_t)na * sizeof(int64_t));
  if (!lo || !hi) { free(b_rows); free(lo); free(hi); return -4; }
  int64_t total = 0;
  for (int64_t i = 0; i < na; ++i) {
    const int64_t col = a_coords[2 * i + 1];
    lo[i] = lower_bound_row(b_rows, nb, col);
    hi[i] = upper_bound_row(b_rows, nb, col);
    total += hi[i] - lo[i];
  }
  free(b_rows);
  if (total == 0) {
    free(lo); free(hi);
    *pair_ptr_out = (int64_t *)calloc(1, sizeof(int64_t));
    return *pair_ptr_out ? 0 : -4;
  }

  // pair stream in A-traversal order (stable-sort input order)
  uint64_t *fused = (uint64_t *)malloc((size_t)total * sizeof(uint64_t));
  int32_t *sa = (int32_t *)malloc((size_t)total * sizeof(int32_t));
  int32_t *sb = (int32_t *)malloc((size_t)total * sizeof(int32_t));
  int64_t *idx = (int64_t *)malloc((size_t)total * sizeof(int64_t));
  int64_t *scratch = (int64_t *)malloc((size_t)total * sizeof(int64_t));
  if (!fused || !sa || !sb || !idx || !scratch) {
    free(lo); free(hi); free(fused); free(sa); free(sb); free(idx);
    free(scratch);
    return -4;
  }
  int64_t w = 0;
  for (int64_t i = 0; i < na; ++i) {
    const uint64_t row_part = (uint64_t)a_coords[2 * i] * span;
    for (int64_t j = lo[i]; j < hi[i]; ++j, ++w) {
      fused[w] = row_part + (uint64_t)b_coords[2 * j + 1];
      sa[w] = (int32_t)i;
      sb[w] = (int32_t)j;
    }
  }
  free(lo); free(hi);
  for (int64_t i = 0; i < total; ++i) idx[i] = i;
  const int sort_rc = radix_sort_idx(fused, idx, total, scratch);
  free(scratch);
  if (sort_rc != 0) {
    free(fused); free(sa); free(sb); free(idx);
    return sort_rc;
  }

  // count distinct keys, emit outputs in sorted order
  int64_t nk = 0;
  for (int64_t i = 0; i < total; ++i)
    if (i == 0 || fused[idx[i]] != fused[idx[i - 1]]) ++nk;

  int64_t *keys = (int64_t *)malloc((size_t)nk * 2 * sizeof(int64_t));
  int64_t *ptr = (int64_t *)malloc(((size_t)nk + 1) * sizeof(int64_t));
  int32_t *pa = (int32_t *)malloc((size_t)total * sizeof(int32_t));
  int32_t *pb = (int32_t *)malloc((size_t)total * sizeof(int32_t));
  if (!keys || !ptr || !pa || !pb) {
    free(fused); free(sa); free(sb); free(idx);
    free(keys); free(ptr); free(pa); free(pb);
    return -4;
  }
  int64_t kidx = -1;
  for (int64_t i = 0; i < total; ++i) {
    const int64_t src = idx[i];
    if (i == 0 || fused[src] != fused[idx[i - 1]]) {
      ++kidx;
      keys[2 * kidx] = (int64_t)(fused[src] / span);
      keys[2 * kidx + 1] = (int64_t)(fused[src] % span);
      ptr[kidx] = i;
    }
    pa[i] = sa[src];
    pb[i] = sb[src];
  }
  ptr[nk] = total;
  free(fused); free(sa); free(sb); free(idx);

  *keys_out = keys;
  *num_keys_out = nk;
  *pair_ptr_out = ptr;
  *pair_a_out = pa;
  *pair_b_out = pb;
  *total_out = total;
  return 0;
}

}  // extern "C"
