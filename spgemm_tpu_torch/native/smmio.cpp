// Native text-format I/O of the port (the port's copy of the JAX package's
// spgemm_tpu/native/smmio.cpp, with the same C ABI).
//
// The reference parses matrix files with formatted `ifstream >>` reads, one
// OpenMP task per file over 16 threads (sparse_matrix_mult.cu:334-384), and
// writes the result with ofstream << (:595-608).  This library replaces the
// per-element formatted I/O with a single-pass byte tokenizer and a buffer
// formatter, behind a C ABI loaded with ctypes (spgemm_tpu_torch/utils/
// native.py).  ctypes releases the GIL for the whole call, so the loader's
// thread pool parses files in parallel.
//
// Three changes against the JAX package's copy, none visible in the bytes
// of a well-formed file:
//   * a value of 2^64 or more is malformed (-3); the JAX package's copy
//     wraps it mod 2^64;
//   * the parser refuses a block count the file cannot hold before it
//     allocates (each token needs a digit and a separator), so a truncated
//     or corrupt header is a malformed file (-3), not an allocation failure;
//   * the writer formats contiguous runs of tiles on several threads, each
//     into its own buffer, and writes the buffers in order.
//
// Build: spgemm_tpu_torch/utils/native.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Parsing
// ---------------------------------------------------------------------------

static inline const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t' ||
                     *p == '\f' || *p == '\v'))
    ++p;
  return p;
}

// Parse one unsigned decimal token; a value of 2^64 or more is malformed.
static inline const char *parse_u64(const char *p, const char *end,
                                    uint64_t *out, int *ok) {
  const uint64_t kMaxDiv10 = 1844674407370955161ull;  // (2^64 - 1) / 10
  p = skip_ws(p, end);
  if (p >= end || *p < '0' || *p > '9') {
    *ok = 0;
    return p;
  }
  uint64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    const uint64_t d = (uint64_t)(*p - '0');
    if (v > kMaxDiv10 || (v == kMaxDiv10 && d > 5)) {
      *ok = 0;
      return p;
    }
    v = v * 10u + d;
    ++p;
  }
  *out = v;
  *ok = 1;
  return p;
}

// Parse a whole matrix file.
//   header_out: [rows, cols, blocks]
//   coords_out: malloc'd int64[blocks * 2]
//   tiles_out : malloc'd uint64[blocks * k * k]
// Returns 0 on success; caller frees with smm_free.
//   -1 open failure, -2 read failure, -3 malformed/truncated, -4 alloc failure
int smm_parse_matrix(const char *path, int64_t k, int64_t header_out[3],
                     int64_t **coords_out, uint64_t **tiles_out) {
  *coords_out = nullptr;
  *tiles_out = nullptr;
  if (k < 1) return -3;
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return -2;
  }
  long sz = ftell(f);
  if (sz < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return -2;
  }
  char *buf = (char *)malloc((size_t)sz + 1);
  if (!buf) {
    fclose(f);
    return -4;
  }
  if (sz > 0 && fread(buf, 1, (size_t)sz, f) != (size_t)sz) {
    free(buf);
    fclose(f);
    return -2;
  }
  fclose(f);

  const char *p = buf, *end = buf + sz;
  int ok = 1;
  uint64_t rows = 0, cols = 0, blocks = 0;
  p = parse_u64(p, end, &rows, &ok);
  if (ok) p = parse_u64(p, end, &cols, &ok);
  if (ok) p = parse_u64(p, end, &blocks, &ok);
  const uint64_t kk = (uint64_t)k * (uint64_t)k;
  // every token after the header takes at least a separator and a digit
  if (!ok || blocks > (uint64_t)(end - p) / (2 * (2 + kk))) {
    free(buf);
    return -3;
  }

  int64_t *coords = (int64_t *)malloc(sizeof(int64_t) * 2u * blocks);
  uint64_t *tiles = (uint64_t *)malloc(sizeof(uint64_t) * (size_t)blocks * kk);
  if (blocks && (!coords || !tiles)) {
    free(coords);
    free(tiles);
    free(buf);
    return -4;
  }

  for (uint64_t b = 0; b < blocks && ok; ++b) {
    uint64_t r = 0, c = 0;
    p = parse_u64(p, end, &r, &ok);
    if (ok) p = parse_u64(p, end, &c, &ok);
    coords[2 * b] = (int64_t)r;
    coords[2 * b + 1] = (int64_t)c;
    uint64_t *t = tiles + b * kk;
    for (uint64_t i = 0; i < kk && ok; ++i) p = parse_u64(p, end, &t[i], &ok);
  }
  free(buf);
  if (!ok) {
    free(coords);
    free(tiles);
    return -3;
  }
  header_out[0] = (int64_t)rows;
  header_out[1] = (int64_t)cols;
  header_out[2] = (int64_t)blocks;
  *coords_out = coords;
  *tiles_out = tiles;
  return 0;
}

void smm_free(void *p) { free(p); }

// ---------------------------------------------------------------------------
// Writing (byte-identical to the reference writer, sparse_matrix_mult.cu:
// 595-608: "R C\n", "blocks\n", per tile "r c\n" + k space-joined rows with
// no trailing space)
// ---------------------------------------------------------------------------

static inline char *fmt_u64(char *dst, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = (char)('0' + (v % 10u));
    v /= 10u;
  } while (v);
  while (n) *dst++ = tmp[--n];
  return dst;
}

// Format tiles [b0, b1) into dst; returns the end of the written bytes.
static char *fmt_tiles(char *p, int64_t k, const int64_t *coords,
                       const uint64_t *tiles, int64_t b0, int64_t b1) {
  const uint64_t kk = (uint64_t)k * (uint64_t)k;
  for (int64_t b = b0; b < b1; ++b) {
    p = fmt_u64(p, (uint64_t)coords[2 * b]);
    *p++ = ' ';
    p = fmt_u64(p, (uint64_t)coords[2 * b + 1]);
    *p++ = '\n';
    const uint64_t *t = tiles + (uint64_t)b * kk;
    for (int64_t r = 0; r < k; ++r) {
      for (int64_t c = 0; c < k; ++c) {
        if (c) *p++ = ' ';
        p = fmt_u64(p, t[r * k + c]);
      }
      *p++ = '\n';
    }
  }
  return p;
}

// Returns 0 on success, -1 open failure, -2 write failure, -4 alloc failure.
int smm_write_matrix(const char *path, int64_t rows, int64_t cols, int64_t k,
                     int64_t nnzb, const int64_t *coords,
                     const uint64_t *tiles) {
  // Runs of at least kMinRun tiles, one per thread: a run's buffer holds the
  // worst case, 21 bytes per number (20 digits and a separator).
  const int64_t kMinRun = 64;
  int64_t n_runs = (int64_t)std::thread::hardware_concurrency();
  if (n_runs < 1) n_runs = 1;
  if (n_runs > nnzb / kMinRun) n_runs = nnzb / kMinRun > 0 ? nnzb / kMinRun : 1;
  const size_t per_tile = 42 + (size_t)k * k * 21;
  std::vector<char *> bufs(n_runs, nullptr);
  std::vector<char *> ends(n_runs, nullptr);
  bool alloc_ok = true;
  for (int64_t r = 0; r < n_runs; ++r) {
    const int64_t b0 = nnzb * r / n_runs, b1 = nnzb * (r + 1) / n_runs;
    bufs[r] = (char *)malloc((size_t)(b1 - b0) * per_tile + 1);
    if (!bufs[r]) alloc_ok = false;
  }
  if (!alloc_ok) {
    for (char *b : bufs) free(b);
    return -4;
  }
  auto run = [&](int64_t r) {
    ends[r] = fmt_tiles(bufs[r], k, coords, tiles, nnzb * r / n_runs,
                        nnzb * (r + 1) / n_runs);
  };
  std::vector<std::thread> pool;
  for (int64_t r = 1; r < n_runs; ++r) {
    try {
      pool.emplace_back(run, r);
    } catch (...) {  // no thread to be had: format the run here
      run(r);
    }
  }
  run(0);
  for (auto &t : pool) t.join();

  char head[64];
  char *h = head;
  h = fmt_u64(h, (uint64_t)rows);
  *h++ = ' ';
  h = fmt_u64(h, (uint64_t)cols);
  *h++ = '\n';
  h = fmt_u64(h, (uint64_t)nnzb);
  *h++ = '\n';
  int rc = 0;
  FILE *f = fopen(path, "wb");
  if (!f) {
    rc = -1;
  } else {
    size_t len = (size_t)(h - head);
    if (fwrite(head, 1, len, f) != len) rc = -2;
    for (int64_t r = 0; r < n_runs && rc == 0; ++r) {
      len = (size_t)(ends[r] - bufs[r]);
      if (fwrite(bufs[r], 1, len, f) != len) rc = -2;
    }
    if (fclose(f) != 0 && rc == 0) rc = -2;
  }
  for (char *b : bufs) free(b);
  return rc;
}

}  // extern "C"
