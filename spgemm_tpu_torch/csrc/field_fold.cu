// Field-mode folds of the block-sparse product, for Hopper (sm_90a): clean
// arithmetic mod 2^64 - 1, which is associative, so the inner-sharded and
// ring multiplies may cut one key's pair list across positions and add the
// pieces in any order.
//
// Replaces the JAX package's jitted XLA device code of inner and ring
// sharding (no Pallas kernel):
//   * field_fold (F1): spgemm_tpu/parallel/innershard.py:fold_pairs_field,
//     (K, P) pair indices into the A and B tile slabs -> (K, k, k) partial
//     tiles; its `small` route (u64.mac_field_b32, both operands < 2^32) is
//     the SMALL instance here;
//   * field_fold_scatter (F3): the ring's trip in parallel/ring.py:
//     _ring_fold_jitted, fold_slab: a trip's compacted cells, each of 1 or
//     P_t pairs, folded with F1 and added under field addition into the
//     accumulator rows rows[c];
//   * field_add (F2): u64.addmod_field over (K, k, k), the step of
//     innershard.py:butterfly_allreduce_modadd and of the ordered gather fold
//     in _make_sharded_fold.  NCCL has no mod-(2^64 - 1) reduction, so the
//     exchange is a copy to the partner's device and this kernel.
//
// Arithmetic, per element (i, n) of a cell's tile:
//   acc = 0; for each pair p, skipping sentinel slots, for j in 0..k-1:
//     prod = a * b as 128 bits: low word a*b, high word __umul64hi(a, b);
//            hi + lo with the carry out of bit 63 added back as +1 (2^64 == 1)
//     acc  = acc + prod, with the same carry fold
//   out = acc == 2^64 - 1 ? 0 : acc     (the canonical residue, the JAX bytes)
// A sum that carried has a low word of at most 2^64 - 2, so adding the carry
// back never carries again.  SMALL drops __umul64hi: a product of two values
// below 2^32 is at most 2^64 - 2^33 + 1, its own residue with high word 0, so
// both instances give the same bits where SMALL is legal.  A slot whose pa is
// a_sent or whose pb is b_sent (each slab's zero tile, its last index) adds
// nothing and is skipped.  The scatter skips cells whose row is dummy_row:
// the plan points every padding cell at that one row, and writing it from
// several blocks would race; the plan keeps the other rows of a trip unique.
//
// What bounds it: operations.  Each MAC is about 4 instructions of the 64-bit
// low product and 4 of __umul64hi on the FMA pipe and some 6 adds, compares
// and selects on the integer pipe (SMALL: the low product and the add), against
// 16.75e12 instructions/s a pipe; the tiles are read from L1 and L2.  The
// design is the simple one: one block per cell, its threads striding over the
// cell's k*k elements, each element's chain in one register, the A row read
// by a warp as one broadcast and the B column coalesced.  Left for a later PR:
// tiles staged in shared memory and register micro-tiles, as kernel 1 has.
// field_add is bound by bytes: each element read twice and written once, in
// a grid-stride loop of consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint64_t add_field(uint64_t x, uint64_t y) {
  const uint64_t s = x + y;
  return s + (uint64_t)(s < y);
}

template <bool SMALL>
__device__ __forceinline__ uint64_t mul_field(uint64_t a, uint64_t b) {
  const uint64_t lo = a * b;
  if (SMALL) return lo;
  return add_field(__umul64hi(a, b), lo);
}

__device__ __forceinline__ uint64_t canon(uint64_t x) { return x == ~0ull ? 0ull : x; }

// One block per cell c.  Without SCATTER the cell's tile goes to out[c];
// with it, it is added into out[rows[c]] unless that is dummy_row.
template <bool SMALL, bool SCATTER>
__global__ void field_fold_kernel(const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
                                  const int32_t* __restrict__ pa, const int32_t* __restrict__ pb,
                                  const int32_t* __restrict__ rows, uint64_t* __restrict__ out,
                                  int P, int k, int a_sent, int b_sent, int dummy_row) {
  const long long cell = blockIdx.x;
  long long dst_row = cell;
  if (SCATTER) {
    dst_row = rows[cell];
    if (dst_row == dummy_row) return;
  }
  const int kk = k * k;
  const int32_t* cpa = pa + cell * P;
  const int32_t* cpb = pb + cell * P;
  for (int e = threadIdx.x; e < kk; e += blockDim.x) {
    const int i = e / k;
    const int n = e - i * k;
    uint64_t acc = 0;
    for (int p = 0; p < P; ++p) {
      const int ia = cpa[p];
      const int ib = cpb[p];
      if (ia == a_sent || ib == b_sent) continue;
      const uint64_t* at = a + (long long)ia * kk + (long long)i * k;
      const uint64_t* bt = b + (long long)ib * kk + n;
      for (int j = 0; j < k; ++j) {
        acc = add_field(acc, mul_field<SMALL>(__ldg(at + j), __ldg(bt + (long long)j * k)));
      }
    }
    uint64_t* dst = out + dst_row * kk + e;
    *dst = SCATTER ? canon(add_field(*dst, acc)) : canon(acc);
  }
}

__global__ void field_add_kernel(uint64_t* __restrict__ x, const uint64_t* __restrict__ y,
                                 long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n; v += stride) {
    x[v] = canon(add_field(x[v], y[v]));
  }
}

int fold_threads(int k) {
  const int kk = k * k;
  const int warps = (kk + 31) / 32;
  return warps >= 8 ? 256 : warps * 32;
}

template <bool SCATTER>
int launch_fold(const void* a, const void* b, const void* pa, const void* pb, const void* rows,
                void* out, long long C, int P, int k, int a_sent, int b_sent, int dummy_row,
                int small, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || k <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)C);
  const int threads = fold_threads(k);
  cudaStream_t s = (cudaStream_t)stream;
  if (small) {
    field_fold_kernel<true, SCATTER><<<grid, threads, 0, s>>>(
        (const uint64_t*)a, (const uint64_t*)b, (const int32_t*)pa, (const int32_t*)pb,
        (const int32_t*)rows, (uint64_t*)out, P, k, a_sent, b_sent, dummy_row);
  } else {
    field_fold_kernel<false, SCATTER><<<grid, threads, 0, s>>>(
        (const uint64_t*)a, (const uint64_t*)b, (const int32_t*)pa, (const int32_t*)pb,
        (const int32_t*)rows, (uint64_t*)out, P, k, a_sent, b_sent, dummy_row);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// F1 on `stream` (a cudaStream_t) of device `device`.
//   a, b   : (n_a, k, k), (n_b, k, k) u64 tile slabs;
//   pa, pb : (C, P) int32 slab indices; a_sent, b_sent the sentinel indices;
//   out    : (C, k, k) u64, every tile written.
// small != 0 runs the SMALL instance (caller's proof: every value < 2^32).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_field_fold(const void* a, const void* b, const void* pa, const void* pb,
                                 void* out, long long C, int P, int k, int a_sent, int b_sent,
                                 int small, int device, void* stream) {
  return launch_fold<false>(a, b, pa, pb, nullptr, out, C, P, k, a_sent, b_sent, -1, small,
                            device, stream);
}

// F3: as F1, and each cell's tile added under field addition into
// acc[rows[c]] (acc: (dummy_row + 1, k, k) u64), cells with rows[c] ==
// dummy_row skipped.  rows (C,) int32, unique apart from dummy_row.
extern "C" int spgemm_field_fold_scatter(const void* a, const void* b, const void* pa,
                                         const void* pb, const void* rows, void* acc,
                                         long long C, int P, int k, int a_sent, int b_sent,
                                         int dummy_row, int small, int device, void* stream) {
  return launch_fold<true>(a, b, pa, pb, rows, acc, C, P, k, a_sent, b_sent, dummy_row, small,
                           device, stream);
}

// F2: x <- x + y mod (2^64 - 1), canonical, over n u64 elements in place.
extern "C" int spgemm_field_add(void* x, const void* y, long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const long long cap = (long long)sms * 16;  // 16 blocks of 256 threads fill an SM
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  field_add_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((uint64_t*)x,
                                                                 (const uint64_t*)y, n);
  return (int)cudaGetLastError();
}
