// Exact-fold numeric round of the block-sparse chain product, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel spgemm_tpu/ops/pallas_spgemm.py:numeric_round_pallas
// (mod variant, and its no_mod variant below).  For every output key and
// every element (i, n) of its k x k tile:
//
//   acc = 0
//   for p in 0..P-1:            (the key's pair list, j-ascending, sentinel-padded)
//     if pa[key, p] is a's sentinel or pb[key, p] is b's sentinel: skip
//     for j in 0..k-1:
//       acc = addmod(acc, mulmod(A[pa[key, p]][i, j], B[pb[key, p]][j, n]))
//
// with the reference's wrap-then-mod steps (SURVEY.md section 2.9):
// mulmod(a, b) = (a*b mod 2^64) == 2^64-1 ? 0 : a*b mod 2^64, and addmod
// likewise.  addmod is not associative, so each element folds strictly in
// this order.  The TPU kernel splits u64 into (hi, lo) uint32 planes only
// because the TPU has no 64-bit integers; here the fold is native
// `unsigned long long`.
//
// Skipping a sentinel slot is exact: the sentinel is the all-zero tile the
// planner appends to each slab (the last index), acc is always canonical
// (never 2^64-1), so addmod(acc, mulmod(0, x)) == acc, and in no_mod
// acc + 0 == acc.  The plain version (ops/cuda_spgemm.numeric_round_ref)
// skips the same slots, so the two agree on any slab.
//
// What bounds it: the integer issue rate, not bytes.  In the sm_90a SASS
// each MAC of the mod variant is four IMADs for the 64-bit multiply-low,
// IADD3 + IMAD.X for the 64-bit add, and ISETP + ISETP.EX + SEL + SEL for
// each of the two compares with all-ones: 9 instructions on the integer pipe
// (64 lanes per SM per clock) beside 5 on the FMA pipe, so the integer pipe
// bounds it.  A key's tile pair is read from device memory once per
// micro-tile pass, so bytes are a small share (PERF.md has the numbers).
//
// no_mod variant (kNoMod, its own entry point below): the same fold with
// both compares with all-ones dropped, acc += a*b in plain wrapping u64
// arithmetic.  It equals the mod fold only where every product and partial
// sum stays below 2^64 - 1, which the hybrid router proves per round
// (safe_exact_bound, spgemm_tpu_torch/ops/mxu_spgemm.py) before it picks
// this variant; it replaces numeric_round_pallas(no_mod=True).  A MAC is
// then three IMADs on the FMA pipe beside one IADD3, so the FMA pipe bounds
// it.  The MAC's instruction sequence is the same in both designs of this
// file, so the bounds in PERF.md still hold.
//
// Design:
//   * a group of threads per output key; each thread owns a TR x TC register
//     micro-tile of the k x k output (rows ri + r*R, columns in pairs
//     2*(ci + c*C) + {0, 1}: a warp's shared loads then fall on distinct
//     banks), each element an independent chain, so a thread has TR*TC
//     chains to overlap and loads TR + TC values per j for TR*TC MACs.  Both
//     variants run 128 threads, one key per block at k = 32: mod on 2x4
//     micro-tiles, no_mod on 4x2 (chosen on the card among 2x2, 2x4, 4x2
//     and 4x4 on 64 to 256 threads, the j loop unrolled 8).  Where a key has
//     fewer micro-tiles than the block has threads (small k), one block
//     folds several keys, one group each; where it has more (large k), the
//     group makes several passes over the key's pairs;
//   * the fold walks a key's real pairs only: a slot whose pa or pb is the
//     sentinel is neither staged nor folded, and a key with no real pair
//     writes its zero tile without loading anything;
//   * each unit of work (a pair, or a chunk of jc columns of it when k > 32)
//     is staged into shared memory with cp.async (16-byte copies where k is
//     even and the slabs aligned, else 8) into one of two buffers while the
//     unit before it folds from the other, with one block barrier per unit;
//     a stage holds at most E u64 of each operand (8 KB, so 34 KB a block at
//     k = 32 and 5 blocks per SM for mod, 4 for no_mod by registers), and
//     every k from 1 to 2048 fits (above 48 KB the launch opts in);
//   * A's staged rows are padded by two elements so that the rows a warp
//     reads fall on different banks; tile offsets are 64-bit.
// At k = 32 the short pair lists of a level-1 multiply (about 5 real pairs a
// key) make no_mod wait on tile traffic (16 KB a pair from L2) more than on
// the FMA pipe.  Left for a later PR: loading an A tile once for the keys of
// one output row, TMA (a tile is one contiguous run, which cp.async serves),
// and a shorter instruction sequence per MAC.

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

template <bool kNoMod>
__global__ void __launch_bounds__(Shape<kNoMod>::NT, Shape<kNoMod>::MINB)
numeric_round_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                     const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                     u64* __restrict__ out, long long K, int P, int k, int a_sent, int b_sent,
                     bool vec_a, bool vec_b) {
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
  const int32_t* pak = pa + (valid ? key : 0) * P;
  const int32_t* pbk = pb + (valid ? key : 0) * P;
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

template <bool kNoMod>
int launch_round(const void* a, const void* b, const void* pa, const void* pb, void* out,
                 long long K, int P, int k, int a_sent, int b_sent, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0) return (int)cudaSuccess;
  if (K > 0x7fffffffLL || k < 1 || k > 2048 || P < 0) return (int)cudaErrorInvalidValue;
  const Geometry g = geometry<kNoMod>(k);
  const long long blocks = (K + g.keys - 1) / g.keys;
  const void* fn = (const void*)numeric_round_kernel<kNoMod>;
  if (g.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool even = k % 2 == 0;
  const bool vec_a = even && g.jc % 2 == 0 && (uintptr_t)a % 16 == 0;
  const bool vec_b = even && (uintptr_t)b % 16 == 0;
  const int threads = g.keys * g.group;
  numeric_round_kernel<kNoMod><<<(unsigned)blocks, threads, g.smem, (cudaStream_t)stream>>>(
      (const u64*)a, (const u64*)b, (const int32_t*)pa, (const int32_t*)pb, (u64*)out, K, P, k,
      a_sent, b_sent, vec_a, vec_b);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one round on `stream` (a cudaStream_t) of device `device`.
//   a, b   : (na, k, k) and (nb, k, k) u64 slabs;
//   pa, pb : (K, P) int32 slab indices, every entry in range;
//   a_sent, b_sent : the sentinel indices (na - 1, nb - 1 for the planner's
//            slabs); a slot holding either is skipped;
//   out    : (K, k, k) u64, written whole.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_numeric_round(const void* a, const void* b, const void* pa,
                                    const void* pb, void* out, long long K, int P, int k,
                                    int a_sent, int b_sent, int device, void* stream) {
  return launch_round<false>(a, b, pa, pb, out, K, P, k, a_sent, b_sent, device, stream);
}

// The no_mod variant, same arguments: exact only under the proof above.
extern "C" int spgemm_numeric_round_nomod(const void* a, const void* b, const void* pa,
                                          const void* pb, void* out, long long K, int P, int k,
                                          int a_sent, int b_sent, int device, void* stream) {
  return launch_round<true>(a, b, pa, pb, out, K, P, k, a_sent, b_sent, device, stream);
}

// The launch geometry of a variant at k on `device`: info[0] threads per
// block, info[1] keys per block, info[2] dynamic shared memory per block in
// bytes, info[3] blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns a CUDA error code (0 = success).
extern "C" int spgemm_numeric_round_geometry(int k, int no_mod, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 2048) return (int)cudaErrorInvalidValue;
  const Geometry g = no_mod ? geometry<true>(k) : geometry<false>(k);
  const void* fn = no_mod ? (const void*)numeric_round_kernel<true>
                          : (const void*)numeric_round_kernel<false>;
  if (g.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, g.keys * g.group, g.smem);
  info[0] = g.keys * g.group;
  info[1] = g.keys;
  info[2] = (int)g.smem;
  info[3] = blocks;
  return (int)err;
}
