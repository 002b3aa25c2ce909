// Field-mode numeric round of the block-sparse chain product, by byte limbs
// on the int8 tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel spgemm_tpu/ops/pallas_mxu.py:numeric_round_mxu_pallas
// (with its epilogue, _piece_sums and fold_piece_sums).  For every output key
// and every element (i, n) of its k x k tile:
//
//   out = sum over p in 0..P-1 (skipping sentinel slots), j in 0..k-1 of
//         A[pa[key, p]][i, j] * B[pb[key, p]][j, n]
//
// in clean arithmetic mod 2^64 - 1 ("field mode"), as the canonical residue
// (2^64 - 1 collapses to 0).  Field mode is associative, so any exact
// summation order and any limb split give the same bits; it equals the
// reference's wrap-then-mod fold wherever the hybrid router's proof
// (safe_exact_bound) holds.  A slot whose pa is a's sentinel or whose pb is
// b's sentinel (the planner's all-zero padding tile, the last of each slab)
// is skipped, which on a zero sentinel is exactly adding its zero product;
// the plain version (ops/mxu_spgemm.numeric_round_mxu_ref) skips the same
// slots, so the two agree on any slab.
//
// Method: every u64 value splits into its 8 little-endian bytes, A into
// a_bytes of them and B into b_bytes, where the caller guarantees values
// below 2^(8 * bytes) (ops/mxu_spgemm.bytes_for_limbs7 of the router's 7-bit
// limb counts).  Byte planes multiply on the int8 tensor cores (mma.sync
// m16n8k32 u8 x u8 -> s32).  A product of bytes la and lb weighs
// 2^(8(la + lb)), and 2^(8d) is 2^(8(d mod 8)) mod 2^64 - 1 (2^64 == 1), so
// the products of one rotation class r = (la + lb) mod 8 accumulate in one
// s32 fragment: at most 8 byte pairs fall in a class, so one 32-j step adds
// at most 8 * 32 * 255^2 < 2^24 to an entry, and folding every
// kFlushSteps = 64 steps (at most 128 would do) keeps the fragments exact
// and below 2^31.  A fold multiplies class r by 2^(8r) mod 2^64 - 1, a 64-bit
// rotation, and adds it into a u64 residue with an end-around carry.  (The
// TPU kernel split values into 7-bit limbs because its products ran in
// bf16; 8 bytes instead of 10 limbs take 64 limb products per u64 MAC
// instead of 100.)
//
// Rounds must keep P * k <= 2^17, the TPU kernel's int32-accumulator limit,
// which the wrapper and the hybrid router enforce the same way (the folds
// above would allow more).
//
// What bounds it: operations, a_bytes * b_bytes * k^3 int8 MACs per real tile
// pair on the tensor cores, against the tile bytes; the byte split and the
// folds are the overhead beside them.  mma.sync reaches a fraction of the
// card's int8 rate (wgmma is the way to the rest; PERF.md has the numbers),
// and the kernel gains most from keeping more blocks on an SM, so that one
// block's copy and split overlap another's products.
//
// Design:
//   * one block of 8 warps per output key; the k x k tile goes in regions of
//     32 x 32 (one for k <= 32), each warp owning a 16 x 8 block of the
//     region and one s32 fragment per rotation class (8 at 8 x 8 bytes, so 32
//     registers);
//   * the block walks its key's real slots only; a key with none writes its
//     zero tile without loading anything.  One block holds one key, so the
//     test is uniform across the block;
//   * the unit of work is one (region, pair, 32-j step): 32 x 32 u64 of A and
//     of B, staged raw with cp.async (16-byte copies where k is even and the
//     slabs 16-byte aligned, else 8; zeros past the ragged edge of k) into one
//     of two buffers, rows padded to 34 u64.  The next unit is copied while
//     this one is split and multiplied: a barrier publishes the raw stage,
//     the split writes the planes, a second barrier publishes them;
//   * the split: a u64 held little-endian already is its 8 byte limbs, so
//     four values of one row (four j's) become the 8 plane words a fragment
//     register wants by two 4 x 4 byte transposes, 16 byte permutes (prmt).
//     Each thread splits four j's of one A row and of one B column per unit,
//     into planes [l][row][j] for A and [l][n][j] for B (B transposed), rows
//     padded to 48 bytes so the ldmatrix reads and the split's stores hit
//     distinct banks.  A word's four bytes are the j's 2q, 2q + 1, 2q + 16,
//     2q + 17, the same for A and B, so the split reads 16-byte runs;
//   * byte counts compile in as templates over {1, 2, 3, 5, 8}: a count
//     between two of them runs at the next one up with the planes past it
//     zero, so the result is the byte split's whatever the template;
//   * one set of planes and 256 threads at most 80 registers each, so three
//     keys share an SM at 8 x 8 bytes (58 KB of shared memory a block), four
//     at 3 x 3 and below (at most 64 registers);
//   * tile offsets are computed in 64 bits.
// Left for a later PR: wgmma (a key's region is 32 rows, wgmma takes 64) with
// TMA-fed tiles, and loading an A tile once for the keys of one output row.
// Measured and not kept (PERF.md): a persistent grid whose pipeline runs on
// across keys, producer and consumer warps on named barriers with up to
// eight raw stages, an 8 x 8 path that skips the split by byte-permuting raw
// B values per rotation class, copies issued two units ahead, and B
// fragments built from the raw stage.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRegion = 32;       // output rows and columns of a region
constexpr int kStep = 32;         // j's per unit (the m16n8k32 depth)
constexpr int kRawLd = 34;        // u64 per raw row: 16-byte rows, split reads on distinct banks
constexpr int kRawOperand = kRegion * kRawLd;  // u64 of one operand's raw stage
constexpr int kPlaneLd = 48;      // bytes per byte-plane row of 32 j's
constexpr int kPlaneBytes = kRegion * kPlaneLd;
constexpr int kFlushSteps = 64;   // units between folds; 128 * 8 * 32 * 255^2 < 2^31
constexpr int kMaxPairDepth = 1 << 17;  // P * k
constexpr int kMaxBytes = 8;

// Blocks per SM the LA x LB instance's register cap is set for: 3 at most
// 80 registers (8 fragment classes need 32 of them), 4 at most 64 where the
// fragments are few.
__host__ __device__ constexpr int min_blocks(int la, int lb) { return la + lb <= 6 ? 4 : 3; }

// Dynamic shared memory of the LA x LB instance: two raw stages of A and B,
// then one set of byte planes.
constexpr size_t smem_bytes(int la, int lb) {
  return 2 * (size_t)(2 * kRawOperand * sizeof(u64)) + (size_t)(la + lb) * kPlaneBytes;
}

// x * 2^s mod (2^64 - 1), for s in [0, 64): a rotation, since 2^64 == 1.
__device__ __forceinline__ u64 mul_pow2_field(u64 x, int s) {
  return s == 0 ? x : (x << s) | (x >> (64 - s));
}

// (x + y) mod (2^64 - 1) on representatives in [0, 2^64 - 1]: the carry out
// of bit 63 is worth 2^64 == 1 and comes back in at bit 0.  It cannot carry
// again: a sum that carried has low word <= 2^64 - 2.
__device__ __forceinline__ u64 add_field(u64 x, u64 y) {
  const u64 s = x + y;
  return s + (s < y ? 1ull : 0ull);
}

// The byte planes of four values: w[l] holds byte l of v[c] in its byte c.
// Two 4 x 4 byte transposes, one of the low words and one of the high.
__device__ __forceinline__ void byte_planes(const u64 (&v)[4], u32 (&w)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const u32 x0 = (u32)(v[0] >> (32 * h)), x1 = (u32)(v[1] >> (32 * h));
    const u32 x2 = (u32)(v[2] >> (32 * h)), x3 = (u32)(v[3] >> (32 * h));
    const u32 lo01 = __byte_perm(x0, x1, 0x5140), hi01 = __byte_perm(x0, x1, 0x7362);
    const u32 lo23 = __byte_perm(x2, x3, 0x5140), hi23 = __byte_perm(x2, x3, 0x7362);
    w[4 * h + 0] = __byte_perm(lo01, lo23, 0x5410);
    w[4 * h + 1] = __byte_perm(lo01, lo23, 0x7632);
    w[4 * h + 2] = __byte_perm(hi01, hi23, 0x5410);
    w[4 * h + 3] = __byte_perm(hi01, hi23, 0x7632);
  }
}

// acc += a (16 x 32, row-major) * b (32 x 8, column-major), u8 -> s32.
__device__ __forceinline__ void mma_u8(int (&acc)[4], const u32 (&a)[4], u32 b0, u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(u32 (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2(u32& r0, u32& r1, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(s));
}

// Copy `size` bytes from src to shared dst, then zeros up to 16 (or 8).
__device__ __forceinline__ void cp_async16(u64* dst, const u64* src, int size) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(size)
               : "memory");
}

__device__ __forceinline__ void cp_async8(u64* dst, const u64* src, int size) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src), "r"(size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage a 32 x 32 region of u64 with cp.async into a raw stage (row stride
// kRawLd): the rows x cols at src (row stride lds) and zeros around them, so
// that the ragged edge of k splits as zeros.  vec: 16-byte copies (cols
// even, src rows 16-byte aligned).
__device__ __forceinline__ void stage_copy(u64* dst, const u64* src, long long lds, int rows,
                                           int cols, bool vec) {
  if (vec && rows == kRegion && cols == kStep) {  // a whole tile region, without a division
    for (int t = threadIdx.x; t < kRegion * (kStep / 2); t += kThreads) {
      const int r = t >> 4, c = (t & 15) * 2;
      cp_async16(dst + r * kRawLd + c, src + r * lds + c, 16);
    }
    return;
  }
  const int w = vec ? 2 : 1;
  for (int t = threadIdx.x; t < kRegion * (kStep / w); t += kThreads) {
    const int r = t / (kStep / w);
    const int c = (t - r * (kStep / w)) * w;
    const bool in = r < rows && c < cols;
    const u64* from = in ? src + r * lds + c : src;
    if (vec) {
      cp_async16(dst + r * kRawLd + c, from, in ? 16 : 0);
    } else {
      cp_async8(dst + r * kRawLd + c, from, in ? 8 : 0);
    }
  }
}

// The next slot at or after p whose pair is real (P if none).
__device__ __forceinline__ int next_real(const int32_t* pak, const int32_t* pbk, int p, int P,
                                         int a_sent, int b_sent) {
  for (; p < P; ++p) {
    if (__ldg(pak + p) != a_sent && __ldg(pbk + p) != b_sent) break;
  }
  return p;
}

template <int LA, int LB>
__global__ void __launch_bounds__(kThreads, min_blocks(LA, LB))
numeric_round_mxu_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                         const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                         u64* __restrict__ out, int P, int k, int a_bytes, int b_bytes,
                         int a_sent, int b_sent, bool vec) {
  // one fragment per rotation class r = (la + lb) mod 8: 2^(8d) == 2^(8(d mod 8))
  constexpr int kClasses = LA + LB - 1 < 8 ? LA + LB - 1 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* const raw = reinterpret_cast<u64*>(smem);  // [2][A, B][kRegion][kRawLd]
  unsigned char* const planes = smem + 2 * 2 * kRawOperand * sizeof(u64);  // [LA + LB][kRegion][kPlaneLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // the mma fragments' group and thread-in-group
  const int rb = 16 * (warp >> 2);          // the warp's 16 rows of the region
  const int cb = 8 * (warp & 3);            // and its 8 columns
  const long long key = blockIdx.x;
  const long long kk = (long long)k * k;
  const int32_t* pak = pa + key * P;
  const int32_t* pbk = pb + key * P;
  u64* outk = out + key * kk;

  const int first = next_real(pak, pbk, 0, P, a_sent, b_sent);
  if (first == P) {  // a pad key: its zero tile, nothing loaded
    for (long long e = threadIdx.x; e < kk; e += kThreads) outk[e] = 0ull;
    return;
  }
  const int nr = (k + kRegion - 1) / kRegion;  // regions per side
  const int nreg = nr * nr;

  auto issue = [&](int buf, int reg, int p, int j0) {
    const int r0 = (reg / nr) * kRegion, c0 = (reg % nr) * kRegion;
    u64* ra = raw + buf * 2 * kRawOperand;
    const u64* at = a + (long long)__ldg(pak + p) * kk + (long long)r0 * k + j0;
    const u64* bt = b + (long long)__ldg(pbk + p) * kk + (long long)j0 * k + c0;
    const int jn = min(kStep, k - j0);
    stage_copy(ra, at, k, min(kRegion, k - r0), jn, vec);
    stage_copy(ra + kRawOperand, bt, k, jn, min(kRegion, k - c0), vec);
  };

  int acc[kClasses][4];
#pragma unroll
  for (int r = 0; r < kClasses; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
  u64 res[4] = {0ull, 0ull, 0ull, 0ull};

  // Split the raw stage into byte planes.  Roles: A row sa_r (warp w takes
  // rows 8(w/2) + (w%2) + {0, 2, 4, 6}, so its plane stores hit distinct
  // banks) and B column sb_n, each with plane word q, which holds the j's
  // 2q, 2q + 1, 2q + 16, 2q + 17.  Planes past a_bytes / b_bytes (a count
  // below the template's) are zeros.
  auto split = [&](int buf) {
    const int sa_r = 8 * (warp >> 1) + (warp & 1) + 2 * (lane >> 3), sa_q = lane & 7;
    const int sb_n = 8 * (warp & 3) + (lane >> 2), sb_q = 4 * (warp >> 2) + (lane & 3);
    const u64* ra = raw + buf * 2 * kRawOperand;
    u32 w[8];
    {
      const u64* row = ra + sa_r * kRawLd + 2 * sa_q;
      const ulonglong2 v01 = *reinterpret_cast<const ulonglong2*>(row);
      const ulonglong2 v23 = *reinterpret_cast<const ulonglong2*>(row + 16);
      byte_planes({v01.x, v01.y, v23.x, v23.y}, w);
      unsigned char* dst = planes + sa_r * kPlaneLd + 4 * sa_q;
#pragma unroll
      for (int l = 0; l < LA; ++l)
        *reinterpret_cast<u32*>(dst + l * kPlaneBytes) = a_bytes == LA || l < a_bytes ? w[l] : 0u;
    }
    {
      const u64* col = ra + kRawOperand + 2 * sb_q * kRawLd + sb_n;
      byte_planes({col[0], col[kRawLd], col[16 * kRawLd], col[17 * kRawLd]}, w);
      unsigned char* dst = planes + LA * kPlaneBytes + sb_n * kPlaneLd + 4 * sb_q;
#pragma unroll
      for (int l = 0; l < LB; ++l)
        *reinterpret_cast<u32*>(dst + l * kPlaneBytes) = b_bytes == LB || l < b_bytes ? w[l] : 0u;
    }
  };
  auto multiply = [&]() {
    const unsigned char* plb = planes + LA * kPlaneBytes;
    u32 bf[LB][2];
#pragma unroll
    for (int lb = 0; lb + 1 < LB; lb += 2) {  // two planes a load
      u32 r[4];
      ldsm_x4(r, plb + (lb + (lane >> 4)) * kPlaneBytes + (cb + (lane & 7)) * kPlaneLd +
                     16 * ((lane >> 3) & 1));
      bf[lb][0] = r[0];
      bf[lb][1] = r[1];
      bf[lb + 1][0] = r[2];
      bf[lb + 1][1] = r[3];
    }
    if (LB % 2)
      ldsm_x2(bf[LB - 1][0], bf[LB - 1][1],
              plb + (LB - 1) * kPlaneBytes + (cb + (lane & 7)) * kPlaneLd + 16 * ((lane >> 3) & 1));
#pragma unroll
    for (int la = 0; la < LA; ++la) {
      u32 af[4];
      ldsm_x4(af, planes + la * kPlaneBytes + (rb + (lane & 15)) * kPlaneLd + 16 * (lane >> 4));
#pragma unroll
      for (int lb = 0; lb < LB; ++lb) mma_u8(acc[(la + lb) % 8], af, bf[lb][0], bf[lb][1]);
    }
  };

  auto fold = [&]() {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int r = 0; r < kClasses; ++r) {
        res[c] = add_field(res[c], mul_pow2_field((u32)acc[r][c], 8 * r));
        acc[r][c] = 0;
      }
    }
  };

  // fragment element c sits at row g + 8 (c / 2), column 2t + (c % 2)
  auto store = [&](int reg) {
    const int r0 = (reg / nr) * kRegion, c0 = (reg % nr) * kRegion;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = r0 + rb + g + 8 * (c >> 1), n = c0 + cb + 2 * t + (c & 1);
      if (i < k && n < k) outk[(long long)i * k + n] = res[c] == ~0ull ? 0ull : res[c];
      res[c] = 0ull;
    }
  };

  // The unit in hand (reg, p, j0), its raw stage in buffer buf, and the
  // next one (reg_n, p_n, j0_n; has_n), copied into the other buffer while
  // this one splits and multiplies.
  int reg = 0, p = first, j0 = 0, steps = 0, buf = 0;
  issue(0, reg, p, j0);
  cp_async_commit();
  for (bool has = true; has;) {
    cp_async_wait_all();
    // the unit's raw stage is in shared memory, and every thread is done
    // with the other buffer and with the planes
    __syncthreads();
    int reg_n = reg, p_n = p, j0_n = j0 + kStep;
    bool has_n = true;
    if (j0_n >= k) {
      j0_n = 0;
      p_n = next_real(pak, pbk, p + 1, P, a_sent, b_sent);
      if (p_n == P) {
        p_n = first;
        if (++reg_n == nreg) has_n = false;
      }
    }
    if (has_n) issue(buf ^ 1, reg_n, p_n, j0_n);
    cp_async_commit();
    split(buf);
    __syncthreads();  // the planes are written
    multiply();
    if (!has_n || reg_n != reg) {  // the region's last unit
      fold();
      store(reg);
      steps = 0;
    } else if (++steps == kFlushSteps) {
      fold();
      steps = 0;
    }
    has = has_n;
    reg = reg_n;
    p = p_n;
    j0 = j0_n;
    buf ^= 1;
  }
}

struct Launch {
  const void* a;
  const void* b;
  const void* pa;
  const void* pb;
  void* out;
  long long K;
  int P, k, a_bytes, b_bytes, a_sent, b_sent;
  bool vec;
  cudaStream_t stream;
};

template <int LA, int LB>
const void* kernel_fn() {
  return (const void*)numeric_round_mxu_kernel<LA, LB>;
}

// Above 48 KB of dynamic shared memory a launch must opt in.
template <int LA, int LB>
cudaError_t opt_in() {
  constexpr size_t smem = smem_bytes(LA, LB);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel_fn<LA, LB>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int LA, int LB>
int launch(const Launch& x) {
  cudaError_t err = opt_in<LA, LB>();
  if (err != cudaSuccess) return (int)err;
  numeric_round_mxu_kernel<LA, LB><<<(unsigned)x.K, kThreads, smem_bytes(LA, LB), x.stream>>>(
      (const u64*)x.a, (const u64*)x.b, (const int32_t*)x.pa, (const int32_t*)x.pb,
      (u64*)x.out, x.P, x.k, x.a_bytes, x.b_bytes, x.a_sent, x.b_sent, x.vec);
  return (int)cudaGetLastError();
}

// info[0] threads, info[1] dynamic shared memory per block in bytes, info[2]
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int LA, int LB>
int geometry(int* info) {
  cudaError_t err = opt_in<LA, LB>();
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel_fn<LA, LB>(), kThreads,
                                                      smem_bytes(LA, LB));
  info[0] = kThreads;
  info[1] = (int)smem_bytes(LA, LB);
  info[2] = blocks;
  return (int)err;
}

// The template byte count that runs a count of n: the next of 1, 2, 3, 5, 8.
int byte_class(int n) { return n <= 3 ? n : (n <= 5 ? 5 : 8); }

// Calls F<LA, LB>::run(args...) at the byte classes of a_bytes, b_bytes.
template <template <int, int> class F, int LA, typename... Args>
int dispatch_b(int b_bytes, Args... args) {
  switch (byte_class(b_bytes)) {
    case 1: return F<LA, 1>::run(args...);
    case 2: return F<LA, 2>::run(args...);
    case 3: return F<LA, 3>::run(args...);
    case 5: return F<LA, 5>::run(args...);
    default: return F<LA, 8>::run(args...);
  }
}

template <template <int, int> class F, typename... Args>
int dispatch(int a_bytes, int b_bytes, Args... args) {
  switch (byte_class(a_bytes)) {
    case 1: return dispatch_b<F, 1>(b_bytes, args...);
    case 2: return dispatch_b<F, 2>(b_bytes, args...);
    case 3: return dispatch_b<F, 3>(b_bytes, args...);
    case 5: return dispatch_b<F, 5>(b_bytes, args...);
    default: return dispatch_b<F, 8>(b_bytes, args...);
  }
}

template <int LA, int LB>
struct LaunchF {
  static int run(const Launch& x) { return launch<LA, LB>(x); }
};

template <int LA, int LB>
struct GeometryF {
  static int run(int* info) { return geometry<LA, LB>(info); }
};

}  // namespace

// Launch one field-mode round on `stream` (a cudaStream_t) of device `device`.
//   a, b             : (na, k, k) and (nb, k, k) u64 slabs;
//   pa, pb           : (K, P) int32 slab indices, every entry in range;
//   a_bytes, b_bytes : byte limbs per operand, 1..8, every value below
//                      2^(8 * bytes);
//   a_sent, b_sent   : the sentinel indices (na - 1, nb - 1 for the
//                      planner's slabs); a slot holding either is skipped;
//   out              : (K, k, k) u64 residues mod 2^64 - 1, written whole.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_numeric_round_mxu(const void* a, const void* b, const void* pa,
                                        const void* pb, void* out, long long K, int P,
                                        int k, int a_bytes, int b_bytes, int a_sent, int b_sent,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0) return (int)cudaSuccess;
  if (K > 0x7fffffffLL || k < 1 || k > 2048 || P < 0 || (long long)P * k > kMaxPairDepth ||
      a_bytes < 1 || a_bytes > kMaxBytes || b_bytes < 1 || b_bytes > kMaxBytes)
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 2 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  const Launch x{a, b, pa, pb, out, K, P, k, a_bytes, b_bytes, a_sent, b_sent, vec,
                 (cudaStream_t)stream};
  return dispatch<LaunchF>(a_bytes, b_bytes, x);
}

// The launch geometry of the instance that runs a_bytes x b_bytes on
// `device` (the same at every k): info[0] threads per block, info[1] dynamic
// shared memory per block in bytes, info[2] blocks per SM.  Returns a CUDA
// error code (0 = success).
extern "C" int spgemm_numeric_round_mxu_geometry(int a_bytes, int b_bytes, int device,
                                                 int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a_bytes < 1 || a_bytes > kMaxBytes || b_bytes < 1 || b_bytes > kMaxBytes)
    return (int)cudaErrorInvalidValue;
  return dispatch<GeometryF>(a_bytes, b_bytes, info);
}
