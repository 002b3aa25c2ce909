// Weight gradient of the block-sparse FFN, for Hopper (sm_90a): kernel 5.
//
// Replaces no Pallas kernel: in the JAX package the weight gradients of the
// training step (spgemm_tpu/models/ffn.py:make_sharded_train_step) are XLA's
// transposes of the einsums in bsmm_gather and bsmm_scatter (ffn.py:85,94)
// under jax.value_and_grad (ffn.py:204).  Contract: for every pair p,
//
//   out[p][i, j] = cast(sum over m = 0..M-1 ascending of
//                       A[m, ia[p]*k + i] * B[m, ib[p]*k + j])
//
// with the sum in float32 and cast to the tile dtype: out[p] is the k x k
// product A-strip^T . B-strip of two k-wide column strips over all M rows.
// It serves both weights: dW1[c, r] with A = x, B = dpre (ia = rows1, ib = c)
// and dW2[r, c] with A = h, B = dy (ia = r, ib = cols2).
//
// What bounds it: at the FFN's full width (BlockSparseFFNConfig(), M = 8192,
// bf16, k = 128, P = 384 tiles) each call does 2 M P k^2 = 103.1 GFLOP, 0.104
// ms against 989 TFLOP/s bf16, and must move about 333 MB (one operand's
// referenced strips, the other's whole width, the tiles once), 0.100 ms
// against 3.35 TB/s: operations and bytes about equally, as for kernels 3
// and 4 (csrc/bsmm.cu).
//
// Design (simple first; wgmma, TMA and splitting M across blocks are later
// work):
//   * one block per output tile p, 8 warps; the k x k output is cut into a
//     grid of warps, kWarpsI down (i) by kWarpsJ across (j), each warp owning
//     kMI 16-row i-tiles by kNJ 8-wide j-tiles whose sums stay in registers
//     for the whole of M;
//   * M streams through shared memory in chunks of kBM rows of both strips,
//     double-buffered with cp.async (16 bytes a thread); the rows past M of
//     a ragged last chunk are zero-filled by the copy, so they add nothing;
//   * bf16 on the tensor cores with mma.sync m16n8k16 into f32: the A^T
//     fragment comes from the m-major strip through ldmatrix.trans, the B
//     fragment through ldmatrix.trans as in kernels 3 and 4; float32 on plain
//     FMA (not TF32), m ascending, with the same element ownership.  Each
//     element is owned by one thread, which adds the 16-deep steps (or, in
//     float32, the rows) in ascending m, so its bits depend on neither the
//     chunk nor the grid;
//   * shared rows are padded by 16 bytes, so ldmatrix's 8 row addresses hit
//     distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadBytes = 16;  // each shared row is padded by this much

template <typename T>
__host__ __device__ constexpr int pad_elems() { return kPadBytes / (int)sizeof(T); }

// Rows of M one chunk stages: 4 KB-ish of each strip row-block either way.
template <typename T>
__host__ __device__ constexpr int chunk_rows() { return sizeof(T) == 2 ? 64 : 32; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from src to dst; src_bytes 0 writes 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 -> f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// How the k x k output tile is cut among the 8 warps: kWarpsI x kWarpsJ
// warps own kMI 16-row i-tiles and kNJ 8-wide j-tiles each; warps past
// kWarpsI * kWarpsJ (k = 16 leaves 6) only help the copies.
template <int K>
struct WarpGrid {
  static constexpr int kTilesI = K / 16, kTilesJ = K / 8;
  static constexpr int kWarpsI = kTilesI < 2 ? kTilesI : 2;
  static constexpr int kWarpsJ = kWarps / kWarpsI < kTilesJ ? kWarps / kWarpsI : kTilesJ;
  static constexpr int kMI = kTilesI / kWarpsI;
  static constexpr int kNJ = kTilesJ / kWarpsJ;
};

// Copy rows m0.. (kBM of them, zero past M) of the K-wide strip at column
// col of src (row stride ld) to shared memory (row stride K + pad).
template <typename T, int K>
__device__ __forceinline__ void stage_strip(T* dst, const T* src, long long ld, long long col,
                                            long long m0, long long M) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = K / kVec;
  constexpr int kLd = K + pad_elems<T>();
  constexpr int kBM = chunk_rows<T>();
  for (int q = threadIdx.x; q < kBM * kChunks; q += kThreads) {
    const int i = q / kChunks, v = q - i * kChunks;
    const long long m = m0 + i;
    const bool in = m < M;
    cp_async16(dst + i * kLd + v * kVec, src + (in ? m : 0) * ld + col + v * kVec, in ? 16 : 0);
  }
}

// acc[mi][nj] += the warp's share of As^T . Bs over one chunk (kBM rows), bf16.
// The C fragment's element e of (mi, nj) is out[i0 + 16 mi + g + 8 (e / 2)]
// [j0 + 8 nj + 2 (lane % 4) + e % 2] with g = lane / 4.
template <int K>
__device__ __forceinline__ void accumulate(float (&acc)[WarpGrid<K>::kMI][WarpGrid<K>::kNJ][4],
                                           const bf16* as, const bf16* bs, int i0, int j0) {
  using G = WarpGrid<K>;
  constexpr int kLd = K + pad_elems<bf16>();
  constexpr int kBM = chunk_rows<bf16>();
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4.trans: lane gives row (lane % 8) of matrix lane / 8; the four
  // matrices are A^T's (i 0-7, m 0-7), (i 8-15, m 0-7), (i 0-7, m 8-15),
  // (i 8-15, m 8-15), each stored as 8 rows m of 8 contiguous i
  const int mat = lane >> 3;
  const int a_row = (lane & 7) + 8 * (mat >> 1), a_col = 8 * (mat & 1);
#pragma unroll
  for (int ks = 0; ks < kBM / 16; ++ks) {
    uint32_t a[G::kMI][4];
#pragma unroll
    for (int mi = 0; mi < G::kMI; ++mi)
      ldmatrix_x4_trans(a[mi], as + (16 * ks + a_row) * kLd + i0 + 16 * mi + a_col);
#pragma unroll
    for (int nj = 0; nj < G::kNJ; ++nj) {
      uint32_t b[2];
      ldmatrix_x2_trans(b, bs + (16 * ks + (lane & 15)) * kLd + j0 + 8 * nj);
#pragma unroll
      for (int mi = 0; mi < G::kMI; ++mi) mma_bf16(acc[mi][nj], a[mi], b);
    }
  }
}

// The same for float32, on plain FMA with m ascending, same element ownership.
template <int K>
__device__ __forceinline__ void accumulate(float (&acc)[WarpGrid<K>::kMI][WarpGrid<K>::kNJ][4],
                                           const float* as, const float* bs, int i0, int j0) {
  using G = WarpGrid<K>;
  constexpr int kLd = K + pad_elems<float>();
  constexpr int kBM = chunk_rows<float>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll 2
  for (int m = 0; m < kBM; ++m) {
    const float* ar = as + m * kLd + i0 + g;
    const float* br = bs + m * kLd + j0 + 2 * t4;
    float a_lo[G::kMI], a_hi[G::kMI];
#pragma unroll
    for (int mi = 0; mi < G::kMI; ++mi) {
      a_lo[mi] = ar[16 * mi];
      a_hi[mi] = ar[16 * mi + 8];
    }
#pragma unroll
    for (int nj = 0; nj < G::kNJ; ++nj) {
      const float b0 = br[8 * nj], b1 = br[8 * nj + 1];
#pragma unroll
      for (int mi = 0; mi < G::kMI; ++mi) {
        acc[mi][nj][0] = fmaf(a_lo[mi], b0, acc[mi][nj][0]);
        acc[mi][nj][1] = fmaf(a_lo[mi], b1, acc[mi][nj][1]);
        acc[mi][nj][2] = fmaf(a_hi[mi], b0, acc[mi][nj][2]);
        acc[mi][nj][3] = fmaf(a_hi[mi], b1, acc[mi][nj][3]);
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Kernel 5: block p -> out[p] = A[:, ia[p]*K ..]^T . B[:, ib[p]*K ..].
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
bsmm_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
                  T* __restrict__ out, long long M, long long lda, long long ldb) {
  using G = WarpGrid<K>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLd = K + pad_elems<T>();
  constexpr int kBM = chunk_rows<T>();
  constexpr int kStrip = kBM * kLd;  // elements of one staged strip chunk
  T* buf = reinterpret_cast<T*>(smem);  // [stage][A, B][kBM][kLd]
  const long long p = blockIdx.x;
  const long long col_a = (long long)ia[p] * K, col_b = (long long)ib[p] * K;
  const int warp = threadIdx.x >> 5;
  const bool owns = warp < G::kWarpsI * G::kWarpsJ;
  const int i0 = (warp % G::kWarpsI) * 16 * G::kMI;
  const int j0 = (warp / G::kWarpsI) * 8 * G::kNJ;
  float acc[G::kMI][G::kNJ][4];
#pragma unroll
  for (int mi = 0; mi < G::kMI; ++mi)
#pragma unroll
    for (int nj = 0; nj < G::kNJ; ++nj)
      acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.0f;

  const long long n_chunks = (M + kBM - 1) / kBM;
  if (n_chunks > 0) {
    stage_strip<T, K>(buf, a, lda, col_a, 0, M);
    stage_strip<T, K>(buf + kStrip, b, ldb, col_b, 0, M);
    cp_async_commit();
  }
  for (long long ch = 0; ch < n_chunks; ++ch) {
    T* cur = buf + (ch & 1) * 2 * kStrip;
    if (ch + 1 < n_chunks) {  // the next chunk into the other stage
      T* nxt = buf + ((ch + 1) & 1) * 2 * kStrip;
      stage_strip<T, K>(nxt, a, lda, col_a, (ch + 1) * kBM, M);
      stage_strip<T, K>(nxt + kStrip, b, ldb, col_b, (ch + 1) * kBM, M);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch has landed for every thread
    if (owns) accumulate<K>(acc, cur, cur + kStrip, i0, j0);
    __syncthreads();  // chunk ch's stage is no longer read
  }

  if (!owns) return;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  T* o = out + p * K * K;
#pragma unroll
  for (int mi = 0; mi < G::kMI; ++mi) {
#pragma unroll
    for (int nj = 0; nj < G::kNJ; ++nj) {
      T* o0 = o + (i0 + 16 * mi + g) * K + j0 + 8 * nj + 2 * t4;
      store2(o0, acc[mi][nj][0], acc[mi][nj][1]);
      store2(o0 + 8 * K, acc[mi][nj][2], acc[mi][nj][3]);
    }
  }
}

struct Args {
  const void* a;
  const void* b;
  const void* ia;
  const void* ib;
  void* out;
  long long M, lda, ldb, P;
  cudaStream_t stream;
};

template <typename T, int K>
int launch(const Args& a) {
  const size_t smem = (size_t)2 * 2 * chunk_rows<T>() * (K + pad_elems<T>()) * sizeof(T);
  if (a.P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bsmm_wgrad_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bsmm_wgrad_kernel<T, K><<<(unsigned)a.P, kThreads, smem, a.stream>>>(
      (const T*)a.a, (const T*)a.b, (const int32_t*)a.ia, (const int32_t*)a.ib, (T*)a.out, a.M,
      a.lda, a.ldb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const Args& a, int k) {
  switch (k) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel 5 on `stream` (a cudaStream_t) of device `device`.
//   a   : (M, lda) float32 (dtype 0) or bfloat16 (dtype 1), 16-byte aligned;
//   b   : (M, ldb) in a's dtype, 16-byte aligned;
//   ia  : (P,) int32, every entry below lda / k;  ib : (P,) int32, below ldb / k;
//   out : (P, k, k) in a's dtype, written whole;
//   k in {16, 32, 64, 128}, lda and ldb multiples of k; M >= 0 (out is zero
//   where M is 0).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_bsmm_wgrad(const void* a, const void* b, const void* ia, const void* ib,
                                 void* out, long long M, long long lda, long long ldb,
                                 long long P, int k, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P <= 0) return (int)cudaSuccess;
  if (M < 0 || k < 1 || lda < k || ldb < k || lda % k || ldb % k) return (int)cudaErrorInvalidValue;
  const Args args{a, b, ia, ib, out, M, lda, ldb, P, (cudaStream_t)stream};
  switch (dtype) {
    case 0: return launch_k<float>(args, k);
    case 1: return launch_k<bf16>(args, k);
    default: return (int)cudaErrorInvalidValue;
  }
}
