// The field-mode fold by byte limbs on the int8 tensor cores, shared by
// kernel 2 (csrc/numeric_round_mxu.cu) and the field folds of inner and ring
// sharding (csrc/field_fold.cu: F1 and F3).  One block folds one cell's pair
// slots into a k x k tile of canonical residues mod 2^64 - 1; the method, its
// exactness argument and what bounds it are at the top of
// numeric_round_mxu.cu.  Two template choices set what a cell is and where
// its tile goes:
//
//   the pair walk   RowWalk:  block c holds row c of (K, P) pair indices;
//                   CellWalk: block c holds pairs cell_ptr[c] .. cell_ptr[c + 1]
//                             - 1 of flat pa and pb (variable-length cells);
//   the epilogue    StoreTile: the tile is written to out[c], a cell without
//                              a real pair writing zeros;
//                   AddTile:   the tile is added under field addition into
//                              acc[rows[c]] and the canonical residue written
//                              back; a cell without a real pair writes nothing.
//                              Rows must be unique within a launch.
//
// The fragments are folded every kFlushSteps units, so any number of pair
// slots a cell is exact; a limit on P * k belongs to a caller.

#pragma once

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
constexpr int kMaxBytes = 8;
constexpr int kMaxK = 2048;       // the largest tile side a launch takes

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

// The canonical residue: 2^64 - 1 reads 0.
__device__ __forceinline__ u64 canon_field(u64 x) { return x == ~0ull ? 0ull : x; }

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

// Block c's pair slots: row c of (K, P) indices.
struct RowWalk {
  int P;
  __device__ __forceinline__ long long begin(long long c) const { return c * P; }
  __device__ __forceinline__ int count(long long) const { return P; }
};

// Block c's pair slots: cell_ptr[c] .. cell_ptr[c + 1] - 1 of flat indices.
struct CellWalk {
  const int64_t* cell_ptr;
  __device__ __forceinline__ long long begin(long long c) const { return __ldg(cell_ptr + c); }
  __device__ __forceinline__ int count(long long c) const {
    return (int)(__ldg(cell_ptr + c + 1) - __ldg(cell_ptr + c));
  }
};

// Block c's tile goes to out[c].
struct StoreTile {
  static constexpr bool kAdd = false;
  u64* out;
  __device__ __forceinline__ u64* tile(long long c, long long kk) const { return out + c * kk; }
};

// Block c's tile is added into acc[rows[c]].
struct AddTile {
  static constexpr bool kAdd = true;
  u64* acc;
  const int32_t* rows;
  __device__ __forceinline__ u64* tile(long long c, long long kk) const {
    return acc + (long long)__ldg(rows + c) * kk;
  }
};

template <int LA, int LB, class Walk, class Epi>
__global__ void __launch_bounds__(kThreads, min_blocks(LA, LB))
limb_fold_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                 const int32_t* __restrict__ pa, const int32_t* __restrict__ pb, Walk walk,
                 Epi epi, int k, int a_bytes, int b_bytes, int a_sent, int b_sent, bool vec) {
  // one fragment per rotation class r = (la + lb) mod 8: 2^(8d) == 2^(8(d mod 8))
  constexpr int kClasses = LA + LB - 1 < 8 ? LA + LB - 1 : 8;
  extern __shared__ __align__(16) unsigned char smem[];
  u64* const raw = reinterpret_cast<u64*>(smem);  // [2][A, B][kRegion][kRawLd]
  unsigned char* const planes = smem + 2 * 2 * kRawOperand * sizeof(u64);  // [LA + LB][kRegion][kPlaneLd]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // the mma fragments' group and thread-in-group
  const int rb = 16 * (warp >> 2);          // the warp's 16 rows of the region
  const int cb = 8 * (warp & 3);            // and its 8 columns
  const long long cell = blockIdx.x;
  const long long kk = (long long)k * k;
  const long long off = walk.begin(cell);
  const int P = walk.count(cell);
  const int32_t* pak = pa + off;
  const int32_t* pbk = pb + off;
  u64* outk = epi.tile(cell, kk);

  const int first = next_real(pak, pbk, 0, P, a_sent, b_sent);
  if (first == P) {  // a pad cell: its zero tile (nothing to add), nothing loaded
    if (!Epi::kAdd)
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
      if (i < k && n < k) {
        u64* dst = outk + (long long)i * k + n;
        *dst = canon_field(Epi::kAdd ? add_field(*dst, res[c]) : res[c]);
      }
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

template <int LA, int LB, class Walk, class Epi>
const void* limb_fold_fn() {
  return (const void*)limb_fold_kernel<LA, LB, Walk, Epi>;
}

// Above 48 KB of dynamic shared memory a launch must opt in.
template <int LA, int LB, class Walk, class Epi>
cudaError_t limb_fold_opt_in() {
  constexpr size_t smem = smem_bytes(LA, LB);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(limb_fold_fn<LA, LB, Walk, Epi>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One block of kThreads a cell, C cells (1 <= C < 2^31, 1 <= k <= kMaxK,
// checked by the caller).  Returns cudaGetLastError() after the launch.
template <int LA, int LB, class Walk, class Epi>
int limb_fold_launch(const void* a, const void* b, const void* pa, const void* pb, Walk walk,
                     Epi epi, long long C, int k, int a_bytes, int b_bytes, int a_sent,
                     int b_sent, bool vec, cudaStream_t stream) {
  cudaError_t err = limb_fold_opt_in<LA, LB, Walk, Epi>();
  if (err != cudaSuccess) return (int)err;
  limb_fold_kernel<LA, LB, Walk, Epi><<<(unsigned)C, kThreads, smem_bytes(LA, LB), stream>>>(
      (const u64*)a, (const u64*)b, (const int32_t*)pa, (const int32_t*)pb, walk, epi, k,
      a_bytes, b_bytes, a_sent, b_sent, vec);
  return (int)cudaGetLastError();
}

// 16-byte copies: k even and both slabs 16-byte aligned.
inline bool limb_fold_vec(int k, const void* a, const void* b) {
  return k % 2 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
}

}  // namespace
