// Native full-parity checker of the port (the port's copy of the JAX
// package's spgemm_tpu/native/parityfold.cpp, with the same C ABI): the
// reference's exact wrap-then-mod fold (sparse_matrix_mult.cu:48,59-61;
// SURVEY.md section 2.9) over EVERY output key, in plain uint64 C++.  Given
// the symbolic join's per-key pair lists (in the reference's j-ascending
// order) and a multiply's output slab, it recomputes each output tile and
// counts the keys that differ.  The numeric fold here shares no code with
// the port's kernels or their plain PyTorch versions.
//
// One change against the JAX package's copy: the keys are shared out among
// std::threads (chunks of 16 taken from an atomic counter, as OpenMP's
// schedule(dynamic, 16) would) instead of an OpenMP loop, so the library
// links no OpenMP runtime beside the one PyTorch ships, and the accumulator
// tiles live on the heap, not in 128 KB of each thread's stack, so k is
// not capped at 128.
//
// Build: spgemm_tpu_torch/utils/native.py (g++ -O3 -shared -fPIC).

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Fold keys taken from `next` until none is left; counts bad keys and the
// least bad key index.
void fold_keys(const uint64_t *a_tiles, const uint64_t *b_tiles,
               const int64_t *pair_ptr, const int32_t *pair_a,
               const int32_t *pair_b, int64_t n_keys, int64_t k,
               const uint64_t *out_tiles, std::atomic<int64_t> *next,
               uint64_t *acc, int64_t *bad_out, int64_t *first_out) {
  const uint64_t MAXV = 0xFFFFFFFFFFFFFFFFull;
  const int64_t kk = k * k;
  const int64_t kChunk = 16;
  int64_t bad = 0, first = -1;
  for (;;) {
    const int64_t start = next->fetch_add(kChunk);
    if (start >= n_keys) break;
    const int64_t stop = start + kChunk < n_keys ? start + kChunk : n_keys;
    for (int64_t key = start; key < stop; ++key) {
      for (int64_t i = 0; i < kk; ++i) acc[i] = 0;
      for (int64_t p = pair_ptr[key]; p < pair_ptr[key + 1]; ++p) {
        const uint64_t *A = a_tiles + (int64_t)pair_a[p] * kk;
        const uint64_t *B = b_tiles + (int64_t)pair_b[p] * kk;
        for (int64_t ty = 0; ty < k; ++ty) {
          const uint64_t *Arow = A + ty * k;
          uint64_t *accrow = acc + ty * k;
          for (int64_t j = 0; j < k; ++j) {
            const uint64_t av = Arow[j];
            const uint64_t *Brow = B + j * k;
            // per output element (ty, tx) the fold runs pair-major, then j
            // ascending: the tx loop innermost keeps that order for every
            // tx at once (the reference kernel's :56-62 loop)
            for (int64_t tx = 0; tx < k; ++tx) {
              uint64_t prod = av * Brow[tx];   // wraps mod 2^64
              if (prod == MAXV) prod = 0;      // :59
              uint64_t s = accrow[tx] + prod;  // wraps mod 2^64 first
              if (s == MAXV) s = 0;            // :61
              accrow[tx] = s;
            }
          }
        }
      }
      const uint64_t *want = out_tiles + key * kk;
      for (int64_t i = 0; i < kk; ++i)
        if (acc[i] != want[i]) {
          ++bad;
          if (first < 0 || key < first) first = key;
          break;
        }
    }
  }
  *bad_out = bad;
  *first_out = first;
}

}  // namespace

extern "C" {

// Returns the number of keys whose recomputed tile differs from out_tiles,
// or -4 if the accumulators cannot be allocated.
// first_bad: key index of the first mismatch, or -1.
int64_t smm_parity_fold(const uint64_t *a_tiles, const uint64_t *b_tiles,
                        const int64_t *pair_ptr, const int32_t *pair_a,
                        const int32_t *pair_b, int64_t n_keys, int64_t k,
                        const uint64_t *out_tiles, int64_t *first_bad) {
  *first_bad = -1;
  int64_t n_threads = (int64_t)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > (n_keys + 15) / 16) n_threads = (n_keys + 15) / 16;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int64_t> next(0);
  std::vector<int64_t> bad((size_t)n_threads, 0), first((size_t)n_threads, -1);
  std::vector<uint64_t> acc;
  try {
    acc.resize((size_t)(n_threads * k * k));  // one accumulator tile a thread
  } catch (...) {
    return -4;
  }
  auto run = [&](int64_t t) {
    fold_keys(a_tiles, b_tiles, pair_ptr, pair_a, pair_b, n_keys, k,
              out_tiles, &next, acc.data() + t * k * k, &bad[t], &first[t]);
  };
  std::vector<std::thread> pool;
  for (int64_t t = 1; t < n_threads; ++t) {
    try {
      pool.emplace_back(run, t);
    } catch (...) {  // no thread to be had: the calling thread takes its keys
      break;
    }
  }
  run(0);
  for (auto &th : pool) th.join();
  int64_t n_bad = 0;
  for (int64_t t = 0; t < n_threads; ++t) {
    n_bad += bad[t];
    if (first[t] >= 0 && (*first_bad < 0 || first[t] < *first_bad))
      *first_bad = first[t];
  }
  return n_bad;
}

}  // extern "C"
