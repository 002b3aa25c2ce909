// Field-mode numeric round of the block-sparse chain product, by 7-bit limbs
// on the int8 tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel spgemm_tpu/ops/pallas_mxu.py:numeric_round_mxu_pallas
// (with its epilogue, _piece_sums and fold_piece_sums).  For every output key
// and every element (i, n) of its k x k tile:
//
//   out = sum over p in 0..P-1, j in 0..k-1 of A[pa[key, p]][i, j] * B[pb[key, p]][j, n]
//
// in clean arithmetic mod 2^64 - 1 ("field mode"), as the canonical residue
// (2^64 - 1 collapses to 0).  Field mode is associative, so any exact
// summation order gives the same bits; it equals the reference's
// wrap-then-mod fold wherever the hybrid router's proof (safe_exact_bound)
// holds.
//
// Method, the TPU kernel's: every u64 value splits into 7-bit limbs (limb l
// holds bits [7l, 7l + 7); limb 9 is bit 63 alone), A into a_limbs of them
// and B into b_limbs, where the caller guarantees values below
// 2^(7 * limbs) (limbs_for_bound).  A limb is a non-negative int8, so limb
// planes multiply on the int8 tensor cores (mma.sync m16n8k32 s8 x s8 -> s32).
// A product of limbs la and lb weighs 2^(7(la + lb)), so the products of one
// diagonal d = la + lb accumulate in one s32 fragment: one 32-j step adds at
// most 10 * 32 * 127^2 < 2^23 to an entry, so folding every kFlushSteps = 256
// steps keeps the fragments exact.  A fold adds each diagonal into a u64
// residue: d's weight 2^(7d) is 2^(7d mod 64) mod 2^64 - 1 (2^64 == 1), and
// multiplying by 2^s mod 2^64 - 1 is a 64-bit rotation by s; residues add
// with an end-around carry.  The TPU kernel's split between a carry-free
// in-kernel epilogue and a fold outside it exists only because of a Mosaic
// miscompile; here the whole epilogue is fused, so its raw_epilogue variant
// has no counterpart.
//
// Rounds must keep P * k <= 2^17, the TPU kernel's int32-accumulator limit,
// which the wrapper and the hybrid router enforce the same way (the folds
// above would allow more).
//
// What bounds it: operations, a_limbs * b_limbs * k^3 int8 MACs per tile
// pair on the tensor cores, against the tile bytes; the u64 -> limb-byte
// staging is the overhead beside it.
//
// Design:
//   * one block of 8 warps per output key; the k x k tile goes in passes over
//     32 x 32 regions (one pass for k <= 32, zero-padded), each warp owning a
//     16 x 8 block of the region and one s32 fragment per limb diagonal;
//   * per tile pair and 32-j step the block stages the region's A rows and
//     B columns as limb bytes in shared memory, planes [l][row][j] for A and
//     [l][n][j] for B (B transposed, so a fragment register is four
//     consecutive j's), rows padded to 48 bytes so the fragment loads hit 32
//     distinct banks; limbs past a_limbs / b_limbs are staged as zeros;
//   * the limb counts compile in as templates over {1, 2, 3, 5, 10}: a count
//     between two of them runs at the next one up on those zero planes, so
//     the result is the limb split's whatever the template;
//   * tile offsets are computed in 64 bits.
// Left for a later PR: wgmma with TMA-fed shared tiles, prefetching the next
// pair while the current one multiplies, and a cheaper limb split.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;
typedef unsigned int u32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRegion = 32;       // output rows and columns of one pass
constexpr int kStep = 32;         // j's per mma (the m16n8k32 depth)
constexpr int kRowBytes = 48;     // padded shared row of 32 limb bytes
constexpr int kFlushSteps = 256;  // 32-j steps between folds into the residues
constexpr int kMaxPairDepth = 1 << 17;  // P * k

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

// Limb l of the four values, one byte each (v[c] in byte c).
__device__ __forceinline__ u32 pack_limb(const u64 (&v)[4], int l) {
  const int s = 7 * l;
  u32 w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) w |= ((u32)(v[c] >> s) & 0x7fu) << (8 * c);
  return w;
}

// acc += a (16 x 32, row-major) * b (32 x 8, column-major), s8 -> s32.
__device__ __forceinline__ void mma_s8(int (&acc)[4], const u32 (&a)[4], const u32 (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ u32 lds32(const unsigned char* p) {
  return *reinterpret_cast<const u32*>(p);
}

template <int LA, int LB>
__global__ void __launch_bounds__(kThreads)
numeric_round_mxu_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                         const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                         u64* __restrict__ out, int P, int k, int a_limbs, int b_limbs) {
  constexpr int kDiags = LA + LB - 1;
  __shared__ __align__(16) unsigned char sa[LA][kRegion][kRowBytes];  // A[r0 + r][j0 + j]
  __shared__ __align__(16) unsigned char sb[LB][kRegion][kRowBytes];  // B[j0 + j][c0 + n] at [n][j]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;    // the mma fragments' group and thread-in-group
  const int rb = 16 * (warp >> 2);          // the warp's 16 rows of the region
  const int cb = 8 * (warp & 3);            // and its 8 columns
  const long long key = blockIdx.x;
  const int kk = k * k;
  const int32_t* pak = pa + key * P;
  const int32_t* pbk = pb + key * P;
  u64* outk = out + key * kk;

  // staging roles: A row sr, words sq (4 j's each); B column sn, words sq2
  const int sr = threadIdx.x >> 3, sq = threadIdx.x & 7;
  const int sn = threadIdx.x & 31, sq2 = threadIdx.x >> 5;

  for (int r0 = 0; r0 < k; r0 += kRegion) {
    for (int c0 = 0; c0 < k; c0 += kRegion) {
      u64 res[4] = {0ull, 0ull, 0ull, 0ull};
      int acc[kDiags][4];
#pragma unroll
      for (int d = 0; d < kDiags; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0;
      int steps = 0;

      auto fold = [&]() {
#pragma unroll
        for (int d = 0; d < kDiags; ++d) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            res[c] = add_field(res[c], mul_pow2_field((u64)(u32)acc[d][c], (7 * d) % 64));
            acc[d][c] = 0;
          }
        }
      };

      for (int p = 0; p < P; ++p) {
        const u64* at = a + (long long)pak[p] * kk;
        const u64* bt = b + (long long)pbk[p] * kk;
        for (int j0 = 0; j0 < k; j0 += kStep) {
          __syncthreads();  // the previous stage is no longer read
          {
            u64 v[4];
            const int row = r0 + sr;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int jj = j0 + 4 * sq + c;
              v[c] = (row < k && jj < k) ? at[(long long)row * k + jj] : 0ull;
            }
#pragma unroll
            for (int l = 0; l < LA; ++l)
              *reinterpret_cast<u32*>(&sa[l][sr][4 * sq]) = l < a_limbs ? pack_limb(v, l) : 0u;
            const int col = c0 + sn;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int jj = j0 + 4 * sq2 + c;
              v[c] = (col < k && jj < k) ? bt[(long long)jj * k + col] : 0ull;
            }
#pragma unroll
            for (int l = 0; l < LB; ++l)
              *reinterpret_cast<u32*>(&sb[l][sn][4 * sq2]) = l < b_limbs ? pack_limb(v, l) : 0u;
          }
          __syncthreads();
          u32 bf[LB][2];
#pragma unroll
          for (int lb = 0; lb < LB; ++lb) {
            bf[lb][0] = lds32(&sb[lb][cb + g][4 * t]);
            bf[lb][1] = lds32(&sb[lb][cb + g][4 * t + 16]);
          }
#pragma unroll
          for (int la = 0; la < LA; ++la) {
            const u32 af[4] = {lds32(&sa[la][rb + g][4 * t]), lds32(&sa[la][rb + g + 8][4 * t]),
                               lds32(&sa[la][rb + g][4 * t + 16]),
                               lds32(&sa[la][rb + g + 8][4 * t + 16])};
#pragma unroll
            for (int lb = 0; lb < LB; ++lb) mma_s8(acc[la + lb], af, bf[lb]);
          }
          if (++steps == kFlushSteps) {
            fold();
            steps = 0;
          }
        }
      }
      fold();
      // fragment element c sits at row g + 8 (c / 2), column 2t + (c % 2)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = r0 + rb + g + 8 * (c >> 1), n = c0 + cb + 2 * t + (c & 1);
        if (i < k && n < k) outk[(long long)i * k + n] = res[c] == ~0ull ? 0ull : res[c];
      }
    }
  }
}

struct Launch {
  const void* a;
  const void* b;
  const void* pa;
  const void* pb;
  void* out;
  long long K;
  int P, k, a_limbs, b_limbs;
  cudaStream_t stream;
};

template <int LA, int LB>
int launch(const Launch& x) {
  numeric_round_mxu_kernel<LA, LB><<<(unsigned)x.K, kThreads, 0, x.stream>>>(
      (const u64*)x.a, (const u64*)x.b, (const int32_t*)x.pa, (const int32_t*)x.pb,
      (u64*)x.out, x.P, x.k, x.a_limbs, x.b_limbs);
  return (int)cudaGetLastError();
}

// The template limb count that runs a count of l: the next of 1, 2, 3, 5, 10.
int limb_class(int l) { return l <= 3 ? l : (l <= 5 ? 5 : 10); }

template <int LA>
int launch_b(const Launch& x) {
  switch (limb_class(x.b_limbs)) {
    case 1: return launch<LA, 1>(x);
    case 2: return launch<LA, 2>(x);
    case 3: return launch<LA, 3>(x);
    case 5: return launch<LA, 5>(x);
    default: return launch<LA, 10>(x);
  }
}

}  // namespace

// Launch one field-mode round on `stream` (a cudaStream_t) of device `device`.
//   a, b             : (na, k, k) and (nb, k, k) u64 slabs, sentinel zero tile last;
//   pa, pb           : (K, P) int32 slab indices, every entry in range;
//   a_limbs, b_limbs : limbs per operand, 1..10, every value below 2^(7 * limbs);
//   out              : (K, k, k) u64 residues mod 2^64 - 1, written whole.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_numeric_round_mxu(const void* a, const void* b, const void* pa,
                                        const void* pb, void* out, long long K, int P,
                                        int k, int a_limbs, int b_limbs, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0) return (int)cudaSuccess;
  if (K > 0x7fffffffLL || k < 1 || k > 2048 || P < 0 || (long long)P * k > kMaxPairDepth ||
      a_limbs < 1 || a_limbs > 10 || b_limbs < 1 || b_limbs > 10)
    return (int)cudaErrorInvalidValue;
  const Launch x{a, b, pa, pb, out, K, P, k, a_limbs, b_limbs, (cudaStream_t)stream};
  switch (limb_class(a_limbs)) {
    case 1: return launch_b<1>(x);
    case 2: return launch_b<2>(x);
    case 3: return launch_b<3>(x);
    case 5: return launch_b<5>(x);
    default: return launch_b<10>(x);
  }
}
