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
// ms against 989 TFLOP/s bf16, and must move about 348 MB (the strips its
// pairs name, each read once, and the tiles written once), 0.104 ms
// against 3.35 TB/s: operations and bytes about equally, as for kernels 3
// and 4 (csrc/bsmm.cu).
//
// What holds it back in practice is the stream of strips from L2 into
// shared memory: each tile reads both of its strips over all M rows, 1.61 GB
// a call at full width, although dW1's pairs come in runs of rpc = 3 that
// share one dpre strip and dW2's in runs of cpc = 3 that share one h strip.
//
// Two bodies, one element ownership: each output element is owned by one
// thread, which adds the 16-deep steps (float32: the rows) of M in
// ascending order, so the bits depend on neither the body, the chunk, the
// ring, the form nor the grid.  Rows past M of a ragged last chunk are
// zero-filled by the copy, so they add nothing.
//
//   * The wgmma body (redesigned for Hopper; bf16 at k 128): a persistent
//     grid of min(units, blocks the card holds) walks the units; a producer
//     warp's one lane keeps a ring of `stages` stages full by TMA (a full
//     and an empty mbarrier a stage, no __syncthreads in the M loop), each
//     stage bm rows of the strips gathered by 2-D tensor maps of a and b at
//     the pair's columns, as 64-column boxes in the 128-byte swizzle.
//     Consumer warpgroups run wgmma with A the a-strip chunk, stored m by i
//     (M-major: the transposed A operand) and B the b-strip chunk (N-major),
//     both by descriptor; a chunk's group stays in flight while the next
//     chunk's is issued, and its stage is released once it completes.  The
//     epilogue casts into a staged tile in shared memory, which one thread
//     stores by TMA while the producer already streams the next unit.
//     Two forms:
//       - tile: one tile a block, two warpgroups of 64 rows i x 128 j
//         (m64n128k16); 2 strips a tile;
//       - half, for runs of G pairs that share a strip (bsmm_wgrad's run
//         options): one block of G warpgroups over the 64-wide half h of
//         the non-shared dimension of a run's G tiles: rows i in 64h..
//         where b is shared (m64n128k16), columns j in 64h.. where a is
//         (2 x m64n64k16); (G + 2) / G strips a tile.
//     Measured on an NVIDIA H100 80GB HBM3, 700.00 W at full width, in
//     rounds (tools/wgrad_bits_ab.py, PERF.md), dW1 / dW2: half 0.209 /
//     0.223 ms (its strip stream alone 0.218 / 0.213), tile 0.233 / 0.230
//     (0.267 / 0.265), the mma.sync body 0.386 / 0.386 (0.345 / 0.351); so
//     runs take the half form, at bm 64 and 4 stages (bm 48 at 4: 0.240 /
//     0.260; 3 stages 0.240 / 0.248), and the tile form bm 128 at 3 stages
//     (bm 64 at 5: 0.253 / 0.252).  Not kept: a cluster of G blocks over a
//     run, each loading 1/G of the shared strip's chunks and multicasting
//     them (kernel 4's tma_load_multicast): 0.304 / 0.304, its stream alone
//     0.238 / 0.232, since each stage waits for the cluster's slowest
//     block.  96 registers, no spills;
//   * The mma.sync body (the first; float32, k 16 to 64, and a variant): one
//     block per output tile, 8 warps, each owning kMI 16-row i-tiles by kNJ
//     8-wide j-tiles whose sums stay in registers for the whole of M; M
//     streams through shared memory in double-buffered cp.async chunks of
//     kBM rows (16 bytes a thread, rows padded by 16 bytes so ldmatrix's 8
//     row addresses hit distinct banks); mma.sync m16n8k16 into f32 with
//     the A^T fragment through ldmatrix.trans; float32 on plain FMA (not
//     TF32).
//
// Not done: splitting M across blocks (no SM idles at full width, and a
// split would change the bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadBytes = 16;  // each shared row is padded by this much

template <typename T>
__host__ __device__ constexpr int pad_elems() { return kPadBytes / (int)sizeof(T); }

// Rows of M one chunk stages: 4 KB-ish of each strip row-block either way.
template <typename T>
__host__ __device__ constexpr int chunk_rows() { return sizeof(T) == 2 ? 64 : 32; }

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

// Kernel 5's mma.sync body: block p -> out[p] = A[:, ia[p]*K ..]^T .
// B[:, ib[p]*K ..].  stream_only skips the products (a diagnostic of the
// strip stream alone; the output is then zero).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
bsmm_wgrad_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const int32_t* __restrict__ ia, const int32_t* __restrict__ ib,
                  T* __restrict__ out, long long M, long long lda, long long ldb,
                  int stream_only) {
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
    if (owns && !stream_only) accumulate<K>(acc, cur, cur + kStrip, i0, j0);
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

// The wgmma body (bf16, k 128).
constexpr int kWgK = 128;                       // its tile edge
constexpr int kBoxCols = 64;                    // bf16 columns of a 128-byte swizzled box row
constexpr int kWgThreads = 2 * 128 + 32;        // two consumer warpgroups and a producer warp
constexpr int kOutBytes = kWgK * kWgK * 2;      // the staged output tile
constexpr int kMaxWgStages = 8;
constexpr int kSmemBytes = 232448;              // shared memory a Hopper block can use

// The wgmma body's shared memory, mirrored by cuda_bsmm_grad.wgrad_layout:
// `stages` stages of 4 boxes of bm rows x 128 bytes (a's two column boxes,
// then b's), the 128 x 128 staged output tile (two boxes of 128 rows), then
// a full and an empty mbarrier a stage.
__host__ __device__ constexpr size_t wg_stage_bytes(int bm) { return (size_t)4 * bm * 128; }

size_t wg_smem_bytes(int bm, int stages) {
  return (size_t)stages * (wg_stage_bytes(bm) + 2 * sizeof(uint64_t)) + kOutBytes;
}

// The 8 consumer warps (named barrier 1; the producer is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Kernel 5's wgmma body, one tile a block (the "tile" form): a persistent
// grid walks the tiles p = blockIdx.x, + gridDim.x, ...  Each output tile is
// 2 warpgroups x 64 rows i of all 128 columns j; every 16 rows of M are one
// wgmma.m64n128k16 with A the a-strip chunk (m by i: M-major, transposed)
// and B the b-strip chunk (m by j: N-major), both read by descriptor from the
// 128-byte-swizzled stage.  The chunk's wgmma group stays in flight while
// the next chunk's is issued; a stage is released once its group has
// completed.  stream_only skips the products (the output is then zero).
__global__ void __launch_bounds__(kWgThreads, 1)
bsmm_wgrad_wg_kernel(const __grid_constant__ CUtensorMap amap,
                     const __grid_constant__ CUtensorMap bmap,
                     const __grid_constant__ CUtensorMap omap, const int32_t* __restrict__ ia,
                     const int32_t* __restrict__ ib, int M, int P, int bm, int stages,
                     int stream_only) {
  extern __shared__ __align__(1024) unsigned char shm[];
  using Out = Swizzled<bf16, kWgK>;
  const int box = bm * 128;                     // bytes of one 64-column box of bm rows
  const int stage_bytes = 4 * box;
  unsigned char* staged = shm + stages * stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + kOutBytes);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = (M + bm - 1) / bm;

  if (threadIdx.x == 0) {
    if (smem_addr(shm) & 1023) __trap();  // the swizzle needs the stages where the host put them
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer: one lane issues every load
    if (lane == 0) {
      prefetch_tmap(&amap);
      prefetch_tmap(&bmap);
      prefetch_tmap(&omap);
      int n = 0;  // the block's chunk stream
      for (int p = blockIdx.x; p < P; p += gridDim.x) {
        const int col_a = ia[p] * kWgK, col_b = ib[p] * kWgK;
        for (int ch = 0; ch < n_chunks; ++ch, ++n) {
          const int s = n % stages;
          if (n >= stages) mbar_wait(&empty[s], ((n / stages) - 1) & 1);
          mbar_expect_tx(&full[s], (uint32_t)stage_bytes);
          unsigned char* st = shm + s * stage_bytes;
#pragma unroll
          for (int bx = 0; bx < 2; ++bx) {  // a's two column boxes, then b's
            tma_load(st + bx * box, &amap, col_a + bx * kBoxCols, ch * bm, &full[s]);
            tma_load(st + (2 + bx) * box, &bmap, col_b + bx * kBoxCols, ch * bm, &full[s]);
          }
        }
      }
    }
    __syncwarp();
  } else {  // the two consumer warpgroups
    const int wg = warp >> 2;
    // warp w owns rows i = 64 (w / 4) + 16 (w % 4) + g (+ 8) of all 128
    // columns, as the m64 step lays out its accumulators
    const int row0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);
    const Out tile_out{staged, kWgK * Out::kSpan};
    float acc[16][4];
#pragma unroll
    for (int t = 0; t < 16; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
    int n = 0;
    for (int p = blockIdx.x; p < P; p += gridDim.x) {
      for (int ch = 0; ch < n_chunks; ++ch, ++n) {
        const int s = n % stages;
        mbar_wait(&full[s], (n / stages) & 1);
        if (!stream_only) {
          // A: this warpgroup's 64-column box of the a chunk, rows m; B: the
          // b chunk's two boxes, `box` bytes apart along j; each 16 rows of
          // m lie 16 * 128 bytes on, each 8-row group 1024 bytes on
          const unsigned char* a = shm + s * stage_bytes + wg * box;
          const unsigned char* b = shm + s * stage_bytes + 2 * box;
          wgmma_fence();
          for (int ks = 0; ks < bm / 16; ++ks) {
            const uint64_t da = gmma_desc(a + ks * 16 * 128, box, 1024);
            const uint64_t db = gmma_desc(b + ks * 16 * 128, box, 1024);
            wgmma_m64n128<1>(acc, da, db);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous chunk's group has completed
        }
        // release the stage whose products have completed: the previous
        // chunk's (this one's with stream_only)
        const int done = stream_only ? n : n - 1;
        if (done >= 0 && (stream_only || ch > 0)) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[done % stages]);
        }
      }
      wgmma_wait<0>();
      if (!stream_only && n_chunks > 0) {  // the tile's last stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(n - 1) % stages]);
      }
      // the epilogue: the staged tile is free once the previous tile's store
      // has read it; cast into it, then one thread stores it by TMA and no
      // consumer waits for the store
      if (threadIdx.x == 0) bulk_wait_read();
      consumer_sync();
      const int c0 = 2 * (lane & 3);
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        store2(const_cast<bf16*>(tile_out.at(row0, 8 * t + c0)), acc[t][0], acc[t][1]);
        store2(const_cast<bf16*>(tile_out.at(row0 + 8, 8 * t + c0)), acc[t][2], acc[t][3]);
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
      }
      fence_async_shared();
      consumer_sync();
      if (threadIdx.x == 0) {
#pragma unroll
        for (int bx = 0; bx < 2; ++bx)
          tma_store(&omap, staged + bx * kWgK * Out::kSpan, bx * kBoxCols, p * kWgK);
        bulk_commit();
      }
    }
    if (threadIdx.x == 0) bulk_wait_read();  // the last store has read the staged tile
  }
}

// Kernel 5's run form "half": unit u = 2 r + h owns the 64-wide half h of
// the non-shared dimension of run r's `G` tiles p = r G + g, one warpgroup a
// tile.  Where b is shared (dW1) warpgroup g computes tile p's rows i in
// 64h.. of all 128 columns, one m64n128k16 a 16-row step (A its own
// a-strip's half, B the shared b chunk); where a is shared (dW2) its
// columns j in 64h.. of all 128 rows, two m64n64k16 a step (A the shared a
// chunk's two i-halves, B its own b-strip's half).  A stage holds the G own
// half-strip boxes, then the shared strip's two, bm rows each, so a run's
// shared strip is read twice (once a half) and each own strip once: G + 2
// strips a run where one tile a block reads 2 G.  A persistent grid walks
// the units; each warpgroup stages its 64 x 128 share of the tile and one
// of its threads stores it by TMA.  stream_only skips the products.
template <int G, bool kSharedB>
__global__ void __launch_bounds__(128 * G + 32, 1)
bsmm_wgrad_half_kernel(const __grid_constant__ CUtensorMap amap,
                       const __grid_constant__ CUtensorMap bmap,
                       const __grid_constant__ CUtensorMap omap, const int32_t* __restrict__ ia,
                       const int32_t* __restrict__ ib, int M, int P, int bm, int stages,
                       int stream_only) {
  extern __shared__ __align__(1024) unsigned char shm[];
  constexpr int kPiece = 64 * kWgK * 2;  // a warpgroup's staged 64 x 128 share of its tile
  const int box = bm * 128;
  const int stage_bytes = (G + 2) * box;
  unsigned char* staged = shm + stages * stage_bytes;  // G pieces
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + G * kPiece);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = 2 * (P / G);
  const int n_chunks = (M + bm - 1) / bm;

  if (threadIdx.x == 0) {
    if (smem_addr(shm) & 1023) __trap();  // the swizzle needs the stages where the host put them
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * G);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == 4 * G) {  // the producer: one lane issues every load
    if (lane == 0) {
      prefetch_tmap(&amap);
      prefetch_tmap(&bmap);
      prefetch_tmap(&omap);
      const CUtensorMap* own_map = kSharedB ? &amap : &bmap;
      const CUtensorMap* shared_map = kSharedB ? &bmap : &amap;
      const int32_t* own_idx = kSharedB ? ia : ib;
      const int32_t* shared_idx = kSharedB ? ib : ia;
      int n = 0;  // the block's chunk stream
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int r = u >> 1, h = u & 1;
        int own_col[G];
#pragma unroll
        for (int g = 0; g < G; ++g) own_col[g] = own_idx[r * G + g] * kWgK + h * kBoxCols;
        const int shared_col = shared_idx[r * G] * kWgK;
        for (int ch = 0; ch < n_chunks; ++ch, ++n) {
          const int s = n % stages;
          if (n >= stages) mbar_wait(&empty[s], ((n / stages) - 1) & 1);
          mbar_expect_tx(&full[s], (uint32_t)stage_bytes);
          unsigned char* st = shm + s * stage_bytes;
#pragma unroll
          for (int g = 0; g < G; ++g)
            tma_load(st + g * box, own_map, own_col[g], ch * bm, &full[s]);
#pragma unroll
          for (int bx = 0; bx < 2; ++bx)
            tma_load(st + (G + bx) * box, shared_map, shared_col + bx * kBoxCols, ch * bm,
                     &full[s]);
        }
      }
    }
    __syncwarp();
  } else {  // G consumer warpgroups, one a tile of the run
    const int g = warp >> 2, wq = warp & 3;
    const bool leader = wq == 0 && lane == 0;  // stores the warpgroup's piece
    const int row0 = 16 * wq + (lane >> 2), c0 = 2 * (lane & 3);
    unsigned char* piece = staged + g * kPiece;
    float acc[16][4];
#pragma unroll
    for (int t = 0; t < 16; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
    int n = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int r = u >> 1, h = u & 1, p = r * G + g;
      for (int ch = 0; ch < n_chunks; ++ch, ++n) {
        const int s = n % stages;
        mbar_wait(&full[s], (n / stages) & 1);
        if (!stream_only) {
          const unsigned char* own = shm + s * stage_bytes + g * box;
          const unsigned char* sh = shm + s * stage_bytes + G * box;
          wgmma_fence();
          for (int ks = 0; ks < bm / 16; ++ks) {
            if constexpr (kSharedB) {
              wgmma_m64n128<1>(acc, gmma_desc(own + ks * 16 * 128, box, 1024),
                               gmma_desc(sh + ks * 16 * 128, box, 1024));
            } else {
#pragma unroll
              for (int q = 0; q < 2; ++q)
                wgmma_m64n64<1>(*reinterpret_cast<float(*)[8][4]>(&acc[8 * q][0]),
                                gmma_desc(sh + q * box + ks * 16 * 128, box, 1024),
                                gmma_desc(own + ks * 16 * 128, box, 1024));
            }
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous chunk's group has completed
        }
        const int done = stream_only ? n : n - 1;  // the stage whose products completed
        if (done >= 0 && (stream_only || ch > 0)) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[done % stages]);
        }
      }
      wgmma_wait<0>();
      if (!stream_only && n_chunks > 0) {  // the tile's last stage
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[(n - 1) % stages]);
      }
      // the epilogue: the piece is free once its previous store has read it
      if (leader) bulk_wait_read();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
      if constexpr (kSharedB) {  // rows 64h.. of the tile: two 64 x 64 boxes side by side
        const Swizzled<bf16, kWgK> out{piece, 64 * 128};
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          store2(const_cast<bf16*>(out.at(row0, 8 * t + c0)), acc[t][0], acc[t][1]);
          store2(const_cast<bf16*>(out.at(row0 + 8, 8 * t + c0)), acc[t][2], acc[t][3]);
        }
      } else {  // columns 64h.. of the tile: 128 rows of one 64-column box
        const Swizzled<bf16, kBoxCols> out{piece, 0};
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float* v = acc[8 * q + t];
            store2(const_cast<bf16*>(out.at(64 * q + row0, 8 * t + c0)), v[0], v[1]);
            store2(const_cast<bf16*>(out.at(64 * q + row0 + 8, 8 * t + c0)), v[2], v[3]);
          }
      }
#pragma unroll
      for (int t = 0; t < 16; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
      fence_async_shared();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + g) : "memory");
      if (leader) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if constexpr (kSharedB) {
            tma_store(&omap, piece + q * 8192, q * kBoxCols, p * kWgK + 64 * h);
          } else {
            tma_store(&omap, piece + q * 8192, h * kBoxCols, p * kWgK + 64 * q);
          }
        }
        bulk_commit();
      }
    }
    if (leader) bulk_wait_read();  // the last store has read the piece
  }
}

struct Args {
  const void* a;
  const void* b;
  const void* ia;
  const void* ib;
  void* out;
  long long M, lda, ldb, P;
  int form, bm, stages, group, shared_b, grid, stream_only;
  cudaStream_t stream;
};

// The wgmma body's forms (the C entry's `form`).
constexpr int kFormTile = 0;  // one tile a block (group 1)
constexpr int kFormHalf = 1;  // one block over half of each run's `group` tiles

size_t half_smem_bytes(int group, int bm, int stages) {
  return (size_t)stages * ((size_t)(group + 2) * bm * 128 + 2 * sizeof(uint64_t)) +
         (size_t)group * 64 * kWgK * 2;
}

typedef void (*WgKernel)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                           const int32_t*, const int32_t*, int, int, int, int, int);

WgKernel half_kernel(int group, int shared_b) {
  switch (group * 2 + (shared_b ? 1 : 0)) {
    case 4: return bsmm_wgrad_half_kernel<2, false>;
    case 5: return bsmm_wgrad_half_kernel<2, true>;
    case 6: return bsmm_wgrad_half_kernel<3, false>;
    case 7: return bsmm_wgrad_half_kernel<3, true>;
    case 8: return bsmm_wgrad_half_kernel<4, false>;
    case 9: return bsmm_wgrad_half_kernel<4, true>;
    default: return nullptr;
  }
}

template <typename T, int K>
int launch(const Args& a) {
  const size_t smem = (size_t)2 * 2 * chunk_rows<T>() * (K + pad_elems<T>()) * sizeof(T);
  if (a.P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bsmm_wgrad_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bsmm_wgrad_kernel<T, K><<<(unsigned)a.P, kThreads, smem, a.stream>>>(
      (const T*)a.a, (const T*)a.b, (const int32_t*)a.ia, (const int32_t*)a.ib, (T*)a.out, a.M,
      a.lda, a.ldb, a.stream_only);
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

// The wgmma body's shapes: the tile form at group 1, the half form at groups
// 2..4; bm a multiple of 16 in 16..256 (a TMA box is at most 256 rows),
// stages 2..kMaxWgStages within a block's shared memory.
size_t wg_bytes(int form, int bm, int stages, int group) {
  return form == kFormHalf ? half_smem_bytes(group, bm, stages) : wg_smem_bytes(bm, stages);
}

bool wg_takes(int form, int bm, int stages, int group, int shared_b) {
  const bool forms = form == kFormTile ? group == 1
                                       : form == kFormHalf && half_kernel(group, shared_b);
  return forms && bm >= 16 && bm <= 256 && bm % 16 == 0 && stages >= 2 &&
         stages <= kMaxWgStages && wg_bytes(form, bm, stages, group) <= (size_t)kSmemBytes;
}

int wg_threads(const Args& a) { return a.form == kFormHalf ? 128 * a.group + 32 : kWgThreads; }

// The kernel of a's form, with its dynamic shared memory allowed (*err).
const void* wg_kernel(const Args& a, cudaError_t* err) {
  const void* k = a.form == kFormHalf ? (const void*)half_kernel(a.group, a.shared_b)
                                      : (const void*)bsmm_wgrad_wg_kernel;
  *err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)wg_bytes(a.form, a.bm, a.stages, a.group));
  return k;
}

int launch_wg(const Args& a) {
  const long long units = a.form == kFormHalf ? 2 * (a.P / a.group) : a.P;
  if (!wg_takes(a.form, a.bm, a.stages, a.group, a.shared_b) || a.P % a.group || a.M < 1 ||
      a.M > 0x7fffffffLL || a.P * kWgK > 0x7fffffffLL || a.grid < 1 || a.grid > units)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  wg_kernel(a, &err);
  if (err != cudaSuccess) return (int)err;
  // the half form stores a warpgroup's 64 x 128 share in 64-row boxes
  CUtensorMap amap, bmap, omap;
  int enc = encode_rows<bf16, kWgK>(&amap, a.a, a.lda, a.M, a.bm);
  if (enc == 0) enc = encode_rows<bf16, kWgK>(&bmap, a.b, a.ldb, a.M, a.bm);
  if (enc == 0)
    enc = encode_rows<bf16, kWgK>(&omap, a.out, kWgK, a.P * kWgK, a.form == kFormHalf ? 64 : kWgK);
  if (enc != 0) return enc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.grid, 1, 1);
  cfg.blockDim = dim3((unsigned)wg_threads(a), 1, 1);
  cfg.dynamicSmemBytes = wg_bytes(a.form, a.bm, a.stages, a.group);
  cfg.stream = a.stream;
  err = cudaLaunchKernelEx(&cfg, a.form == kFormHalf ? half_kernel(a.group, a.shared_b)
                                                     : bsmm_wgrad_wg_kernel,
                           amap, bmap, omap, (const int32_t*)a.ia, (const int32_t*)a.ib,
                           (int)a.M, (int)a.P, a.bm, a.stages, a.stream_only);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 5 on `stream` (a cudaStream_t) of device `device`.
//   a   : (M, lda) float32 (dtype 0) or bfloat16 (dtype 1), 16-byte aligned;
//   b   : (M, ldb) in a's dtype, 16-byte aligned;
//   ia  : (P,) int32, every entry below lda / k;  ib : (P,) int32, below ldb / k;
//   out : (P, k, k) in a's dtype, written whole;
//   k in {16, 32, 64, 128}, lda and ldb multiples of k; M >= 0 (out is zero
//   where M is 0);
//   body: 0 the mma.sync body (any of those shapes), 1 the wgmma body (bf16,
//   k 128, M >= 1, out 16-byte aligned), which reads
//     form        : 0 one tile a block (group 1); 1 one block over a
//                   64-wide half of the tiles of each run of `group`
//                   consecutive pairs, which share b's strip (shared_b 1) or
//                   a's (shared_b 0); group 2..4 dividing P;
//     bm          : rows of M a ring stage holds, a multiple of 16;
//     stages      : the ring's depth, 2 to 8, within a block's shared memory;
//     grid        : the blocks, 1 to the units (tiles, or halves of runs);
//   stream_only: 1 skips the products (the output is then zero: a diagnostic
//   of the strip stream alone).
// Returns cudaGetLastError() after the launch (0 = launched),
// cudaErrorInvalidValue for shapes it does not take, or kErrEncode + a
// CUresult when a tensor map cannot be encoded.
extern "C" int spgemm_bsmm_wgrad(const void* a, const void* b, const void* ia, const void* ib,
                                 void* out, long long M, long long lda, long long ldb,
                                 long long P, int k, int dtype, int body, int form, int bm,
                                 int stages, int group, int shared_b, int grid, int stream_only,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (P <= 0) return (int)cudaSuccess;
  if (M < 0 || k < 1 || lda < k || ldb < k || lda % k || ldb % k) return (int)cudaErrorInvalidValue;
  const Args args{a,    b,  ia,     ib,    out,      M,    lda,         ldb,
                  P,    form, bm,   stages, group,   shared_b, grid, stream_only,
                  (cudaStream_t)stream};
  if (body == 1) {
    if (dtype != 1 || k != kWgK) return (int)cudaErrorInvalidValue;
    return launch_wg(args);
  }
  if (body != 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_k<float>(args, k);
    case 1: return launch_k<bf16>(args, k);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many blocks of the wgmma body's form an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *n; launches nothing.
extern "C" int spgemm_bsmm_wgrad_occupancy(int form, int bm, int stages, int group,
                                           int shared_b, int device, int* n) {
  *n = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!wg_takes(form, bm, stages, group, shared_b)) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, 1,        kWgK, kWgK,
               group,   form,    bm,      stages,  group,   shared_b, 1,    0,
               (cudaStream_t)0};
  const void* kernel = wg_kernel(a, &err);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, kernel, wg_threads(a), wg_bytes(form, bm, stages, group));
}
