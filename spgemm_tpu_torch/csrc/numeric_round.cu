// Exact-fold numeric round of the block-sparse chain product, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel spgemm_tpu/ops/pallas_spgemm.py:numeric_round_pallas
// (mod variant, and its no_mod variant below).  For every output key and
// every element (i, n) of its k x k tile:
//
//   acc = 0
//   for p in 0..P-1:            (the key's pair list, j-ascending, sentinel-padded)
//     for j in 0..k-1:
//       acc = addmod(acc, mulmod(A[pa[key, p]][i, j], B[pb[key, p]][j, n]))
//
// with the reference's wrap-then-mod steps (SURVEY.md section 2.9):
// mulmod(a, b) = (a*b mod 2^64) == 2^64-1 ? 0 : a*b mod 2^64, and addmod
// likewise.  addmod is not associative, so each element folds strictly in
// this order.  The TPU kernel splits u64 into (hi, lo) uint32 planes only
// because the TPU has no 64-bit integers; here the fold is native
// `unsigned long long`.  Sentinel pairs point at an all-zero tile and add 0.
//
// What bounds it: the integer issue rate, not bytes.  In the sm_90a SASS
// each MAC is two LDS.64, four IMADs for the 64-bit multiply-low, IADD3 +
// IMAD.X for the 64-bit add, and ISETP + ISETP.EX + SEL + SEL for each of
// the two compares with all-ones: 9 instructions on the integer pipe (64
// lanes per SM per clock) beside 5 on the FMA pipe, so the integer pipe
// bounds it.  A key's tile pair is read from device memory once per element
// group, so bytes are a small share (PERF.md has the numbers).
//
// no_mod variant (template parameter kNoMod, its own entry point below): the
// same fold with both compares with all-ones dropped, acc += a*b in plain
// wrapping u64 arithmetic.  It equals the mod fold only where every product
// and partial sum stays below 2^64 - 1, which the hybrid router proves per
// round (safe_exact_bound, spgemm_tpu_torch/ops/mxu_spgemm.py) before it
// picks this variant; it replaces numeric_round_pallas(no_mod=True).  With
// the ISETP/ISETP.EX/SEL/SEL groups gone, a MAC is IMADs on the FMA pipe
// beside a single IADD3 on the integer pipe, so the FMA pipe bounds it
// (PERF.md has the count from the SASS).  The mod variant is the other
// instantiation of the same template, so its code is what it was.
//
// Design (simple first):
//   * one block per output key on gridDim.x; threads over the k x k output
//     elements (min(k*k, 1024) threads), up to EPT elements per thread per
//     pass, further passes when k*k > 1024 * EPT;
//   * the block stages A[:, j0:j0+jc] and B[j0:j0+jc, :] of the current pair
//     through shared memory, jc = min(k, 2048 / k) columns, so a stage is at
//     most 32 KB and any k up to 2048 fits without opting in to more shared
//     memory; chunking j keeps the order;
//   * tile offsets are computed in 64 bits.
// Left for a later PR: prefetching the next pair with cp.async or TMA while
// the current one folds, and several keys per block for small k (k <= 16
// leaves most of a block's threads idle).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxThreads = 1024;
constexpr int kEpt = 4;  // output elements per thread per pass

__device__ __forceinline__ u64 collapse_max(u64 x) { return x == ~0ull ? 0ull : x; }

template <bool kNoMod>
__global__ void __launch_bounds__(kMaxThreads)
numeric_round_kernel(const u64* __restrict__ a, const u64* __restrict__ b,
                     const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                     u64* __restrict__ out, int P, int k, int jc) {
  extern __shared__ u64 smem[];
  u64* sa = smem;           // k rows x jc columns of the A tile
  u64* sb = smem + k * jc;  // jc rows x k columns of the B tile

  const long long key = blockIdx.x;
  const int kk = k * k;
  const int nt = blockDim.x;
  const int32_t* pak = pa + key * P;
  const int32_t* pbk = pb + key * P;
  u64* outk = out + key * kk;

  for (int base = 0; base < kk; base += nt * kEpt) {
    u64 acc[kEpt];
#pragma unroll
    for (int e = 0; e < kEpt; ++e) acc[e] = 0ull;

    for (int p = 0; p < P; ++p) {
      const u64* at = a + (long long)pak[p] * kk;
      const u64* bt = b + (long long)pbk[p] * kk;
      for (int j0 = 0; j0 < k; j0 += jc) {
        const int jn = min(jc, k - j0);
        __syncthreads();  // the previous stage is no longer read
        for (int t = threadIdx.x; t < k * jn; t += nt) {
          const int i = t / jn, ja = t - i * jn;
          sa[i * jc + ja] = at[(long long)i * k + j0 + ja];
          const int jb = t / k, n = t - jb * k;
          sb[jb * k + n] = bt[(long long)(j0 + jb) * k + n];
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kEpt; ++e) {
          const int idx = base + e * nt + threadIdx.x;
          if (idx < kk) {
            const int i = idx / k, n = idx - i * k;
            const u64* arow = sa + i * jc;
            u64 s = acc[e];
            for (int j = 0; j < jn; ++j) {
              if constexpr (kNoMod) {
                s += arow[j] * sb[j * k + n];
              } else {
                s = collapse_max(s + collapse_max(arow[j] * sb[j * k + n]));
              }
            }
            acc[e] = s;
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < kEpt; ++e) {
      const int idx = base + e * nt + threadIdx.x;
      if (idx < kk) outk[idx] = acc[e];
    }
  }
}

template <bool kNoMod>
int launch_round(const void* a, const void* b, const void* pa, const void* pb, void* out,
                 long long K, int P, int k, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0) return (int)cudaSuccess;
  if (K > 0x7fffffffLL || k < 1 || k > 2048 || P < 0) return (int)cudaErrorInvalidValue;
  const int kk = k * k;
  const int threads = kk < kMaxThreads ? kk : kMaxThreads;
  const int jc = k < 2048 / k ? k : 2048 / k;
  const size_t smem = (size_t)2 * k * jc * sizeof(u64);
  numeric_round_kernel<kNoMod><<<(unsigned)K, threads, smem, (cudaStream_t)stream>>>(
      (const u64*)a, (const u64*)b, (const int32_t*)pa, (const int32_t*)pb, (u64*)out,
      P, k, jc);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one round on `stream` (a cudaStream_t) of device `device`.
//   a, b   : (na, k, k) and (nb, k, k) u64 slabs, sentinel zero tile last;
//   pa, pb : (K, P) int32 slab indices, every entry in range;
//   out    : (K, k, k) u64, written whole.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_numeric_round(const void* a, const void* b, const void* pa,
                                    const void* pb, void* out, long long K, int P,
                                    int k, int device, void* stream) {
  return launch_round<false>(a, b, pa, pb, out, K, P, k, device, stream);
}

// The no_mod variant, same arguments: exact only under the proof above.
extern "C" int spgemm_numeric_round_nomod(const void* a, const void* b, const void* pa,
                                          const void* pb, void* out, long long K, int P,
                                          int k, int device, void* stream) {
  return launch_round<true>(a, b, pa, pb, out, K, P, k, device, stream);
}
