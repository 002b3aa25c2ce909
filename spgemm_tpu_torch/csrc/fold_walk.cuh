// The exact fold's device code, shared by kernel 1 (csrc/numeric_round.cu)
// and the segmented fold (csrc/numeric_round_dense.cu): the reference's
// wrap-then-mod step on native u64 (SURVEY.md section 2.9), and the walk of
// one output tile's pair slots with its staging and launch geometry.  The
// design notes, and what bounds the walk, are at the top of
// numeric_round.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

__device__ __forceinline__ u64 collapse_max(u64 x) { return x == ~0ull ? 0ull : x; }

template <bool kNoMod>
__device__ __forceinline__ u64 mac(u64 acc, u64 a, u64 b) {
  if constexpr (kNoMod) {
    return acc + a * b;
  } else {
    return collapse_max(acc + collapse_max(a * b));
  }
}

__device__ __forceinline__ void cp_async16(u64* dst, const u64* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows x cols u64 from src (row stride lds) to shared dst (row stride
// ldd) with cp.async, thread lt of gt; vec: 16-byte copies (cols, lds, ldd
// even and src 16-byte aligned).
__device__ __forceinline__ void stage_copy(u64* dst, int ldd, const u64* src, long long lds,
                                           int rows, int cols, bool vec, int lt, int gt) {
  if (ldd == cols && lds == cols) {  // one contiguous run
    cols *= rows;
    rows = 1;
  }
  const int w = vec ? 2 : 1;
  const int cpr = cols / w;  // copies per row
  const int n = rows * cpr;
  for (int t = lt; t < n; t += gt) {
    const int r = rows == 1 ? 0 : t / cpr;
    const int c = (t - r * cpr) * w;
    if (vec) {
      cp_async16(dst + r * ldd + c, src + r * lds + c);
    } else {
      cp_async8(dst + r * ldd + c, src + r * lds + c);
    }
  }
}

// The launch geometry of one variant at one k, shared by the launch and the
// occupancy query.
struct Geometry {
  int jc;         // columns of A (rows of B) per stage
  int lda;        // row stride of A's stage: jc rounded up to even, plus 2
  int ldb;        // row stride of B's stage: k rounded up to TC
  int rows_a;     // rows of A's stage: k rounded up to TR
  int stage;      // u64 per buffer
  int tiles;      // micro-tiles per key
  int group;      // threads per key
  int keys;       // keys per block
  int passes;     // passes over a key's pairs
  size_t smem;    // dynamic shared memory per block
};

// Each variant's shape: micro-tile TR x TC, NT threads a block, at most E
// u64 of each operand per stage, and MINB blocks per SM for the register cap.
template <bool kNoMod>
struct Shape {
  static constexpr int TR = 2, TC = 4, NT = 128, E = 1024, MINB = 5;
};
template <>
struct Shape<true> {
  static constexpr int TR = 4, TC = 2, NT = 128, E = 1024, MINB = 4;
};

template <bool kNoMod>
__host__ __device__ Geometry geometry(int k) {
  constexpr int TR = Shape<kNoMod>::TR, TC = Shape<kNoMod>::TC;
  constexpr int NT = Shape<kNoMod>::NT, E = Shape<kNoMod>::E;
  Geometry g;
  int jc = k < E / k ? k : E / k;
  if (jc < 1) jc = 1;
  if (jc > 1 && k % 2 == 0) jc &= ~1;  // even: every chunk keeps 16-byte copies
  const int R = (k + TR - 1) / TR, C = (k + TC - 1) / TC;
  g.jc = jc;
  g.lda = ((jc + 1) & ~1) + 2;
  g.ldb = C * TC;
  g.rows_a = R * TR;
  g.stage = g.rows_a * g.lda + jc * g.ldb;
  g.tiles = R * C;
  g.group = g.tiles < NT ? g.tiles : NT;
  g.keys = NT / g.group;
  g.passes = (g.tiles + g.group - 1) / g.group;
  g.smem = (size_t)g.keys * 2 * g.stage * sizeof(u64);
  return g;
}

// The next slot at or after p whose pair is real (P if none).
__device__ __forceinline__ int next_real(const int32_t* pak, const int32_t* pbk, int p, int P,
                                         int a_sent, int b_sent) {
  for (; p < P; ++p) {
    if (__ldg(pak + p) != a_sent && __ldg(pbk + p) != b_sent) break;
  }
  return p;
}

// The fold of K output tiles.  kSeg false (kernel 1): tile `key` folds the
// P slots [key * P, key * P + P) of pa/pb.  kSeg true (the segmented fold):
// tile `key` folds the slots [row_ptr[key], row_ptr[key + 1]), and P is
// unused.  Either way a tile's slots are walked in order, sentinel slots
// skipped, and a tile without a real slot is written as zeros.
template <bool kNoMod, bool kSeg = false>
__global__ void __launch_bounds__(Shape<kNoMod>::NT, Shape<kNoMod>::MINB)
numeric_round_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                     const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                     const long long* __restrict__ row_ptr, u64* __restrict__ out,
                     long long K, int P, int k, int a_sent, int b_sent, bool vec_a,
                     bool vec_b) {
  constexpr int TR = Shape<kNoMod>::TR, TC = Shape<kNoMod>::TC;
  extern __shared__ __align__(16) u64 smem[];
  const Geometry geo = geometry<kNoMod>(k);
  const int R = geo.rows_a / TR, C = geo.ldb / TC;
  const int gt = geo.group;
  const int grp = threadIdx.x / gt, lt = threadIdx.x - grp * gt;
  const long long key = (long long)blockIdx.x * geo.keys + grp;
  const bool valid = key < K;
  const long long kk = (long long)k * k;
  u64* bufs = smem + (size_t)grp * 2 * geo.stage;
  long long first_slot = (valid ? key : 0) * P;
  if constexpr (kSeg) {
    first_slot = valid ? __ldg(row_ptr + key) : 0;
    P = valid ? (int)(__ldg(row_ptr + key + 1) - first_slot) : 0;
  }
  const int32_t* pak = pa + first_slot;
  const int32_t* pbk = pb + first_slot;
  u64* outk = out + (valid ? key : 0) * kk;

  // Where this thread's micro-tile of pass `pass` sits: rows ri + r*R,
  // column pairs ci + c*C; out of range (the last pass's spare threads)
  // reads the last micro-tile and stores nothing.
  auto tile_of = [&](int pass, int& ri, int& ci) {
    int mt = pass * gt + lt;
    if (mt >= geo.tiles) mt = geo.tiles - 1;
    ri = mt / C;
    ci = mt - ri * C;
  };
  auto store = [&](int pass, const u64 (&acc)[TR][TC]) {
    if (pass * gt + lt >= geo.tiles) return;
    int ri, ci;
    tile_of(pass, ri, ci);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int i = ri + r * R;
#pragma unroll
      for (int c = 0; c < TC; ++c) {
        const int n = 2 * (ci + (c / 2) * C) + (c & 1);
        if (i < k && n < k) outk[(long long)i * k + n] = acc[r][c];
      }
    }
  };
  auto issue = [&](u64* buf, int p, int j0) {
    const int jn = min(geo.jc, k - j0);
    const u64* at = a + (long long)__ldg(pak + p) * kk + j0;
    const u64* bt = b + (long long)__ldg(pbk + p) * kk + (long long)j0 * k;
    stage_copy(buf, geo.lda, at, k, k, jn, vec_a, lt, gt);
    stage_copy(buf + geo.rows_a * geo.lda, geo.ldb, bt, k, jn, k, vec_b, lt, gt);
  };

  u64 acc[TR][TC];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[r][c] = 0ull;

  // The unit being folded (p, j0, pass) and the one staged after it (p_n,
  // j0_n, pass_n); has and has_n say whether each exists.
  const int first = valid ? next_real(pak, pbk, 0, P, a_sent, b_sent) : P;
  bool has = first < P;
  if (valid && !has) {
    for (int pass = 0; pass < geo.passes; ++pass) store(pass, acc);  // a pad key
  }
  int p = first, j0 = 0, pass = 0;
  if (has) issue(bufs, p, j0);
  cp_async_commit();
  bool has_n = has;
  int p_n = p, j0_n = j0, pass_n = pass;
  auto advance = [&]() {
    j0_n += geo.jc;
    if (j0_n < k) return;
    j0_n = 0;
    p_n = next_real(pak, pbk, p_n + 1, P, a_sent, b_sent);
    if (p_n < P) return;
    p_n = first;
    if (++pass_n == geo.passes) has_n = false;
  };
  if (has_n) advance();
  int buf = 0;

  while (true) {
    cp_async_wait_all();
    // the current unit is in shared memory, and every thread is done with
    // the other buffer
    if (!__syncthreads_or(has)) break;
    if (has_n) issue(bufs + (buf ^ 1) * geo.stage, p_n, j0_n);
    cp_async_commit();
    if (has) {
      const u64* sa = bufs + buf * geo.stage;
      const u64* sb = sa + geo.rows_a * geo.lda;
      const int jn = min(geo.jc, k - j0);
      int ri, ci;
      tile_of(pass, ri, ci);
      const u64* ap = sa + ri * geo.lda;
      const u64* bp = sb + 2 * ci;
#pragma unroll 8
      for (int j = 0; j < jn; ++j) {
        u64 av[TR], bv[TC];
#pragma unroll
        for (int r = 0; r < TR; ++r) av[r] = ap[r * R * geo.lda + j];
#pragma unroll
        for (int c = 0; c < TC; c += 2) {
          const ulonglong2 v =
              *reinterpret_cast<const ulonglong2*>(bp + j * geo.ldb + (c / 2) * 2 * C);
          bv[c] = v.x;
          bv[c + 1] = v.y;
        }
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[r][c] = mac<kNoMod>(acc[r][c], av[r], bv[c]);
      }
      if (!has_n || pass_n != pass) {  // the last unit of this pass
        store(pass, acc);
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[r][c] = 0ull;
      }
    }
    has = has_n;
    p = p_n;
    j0 = j0_n;
    pass = pass_n;
    if (has_n) advance();
    buf ^= 1;
  }
}

// Launch K tiles' fold on `stream` of `device`; returns cudaGetLastError()
// after the launch (0 = launched).  row_ptr: kSeg's row offsets, else null.
template <bool kNoMod, bool kSeg>
int launch_fold(const void* a, const void* b, const void* pa, const void* pb,
                const void* row_ptr, void* out, long long K, int P, int k, int a_sent,
                int b_sent, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0) return (int)cudaSuccess;
  if (K > 0x7fffffffLL || k < 1 || k > 2048 || P < 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry<kNoMod>(k);
  const long long blocks = (K + g.keys - 1) / g.keys;
  const void* fn = (const void*)numeric_round_kernel<kNoMod, kSeg>;
  if (g.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool even = k % 2 == 0;
  const bool vec_a = even && g.jc % 2 == 0 && (uintptr_t)a % 16 == 0;
  const bool vec_b = even && (uintptr_t)b % 16 == 0;
  const int threads = g.keys * g.group;
  numeric_round_kernel<kNoMod, kSeg>
      <<<(unsigned)blocks, threads, g.smem, (cudaStream_t)stream>>>(
          (const u64*)a, (const u64*)b, (const int32_t*)pa, (const int32_t*)pb,
          (const long long*)row_ptr, (u64*)out, K, P, k, a_sent, b_sent, vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace
