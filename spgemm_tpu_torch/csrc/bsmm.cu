// Block-sparse matmul of the FFN forward, for Hopper (sm_90a): kernels 3 and 4.
//
// Replaces the TPU kernels spgemm_tpu/ops/pallas_bsmm.py:bsmm_pallas (kernel 3,
// streaming; entry spgemm_bsmm) and :bsmm_pallas_resident (kernel 4, the x
// panel held on chip; entry spgemm_bsmm_resident).  Contract of both: x
// (M, d_in) times a column-major block-sparse W whose output block-column c
// owns rpc k x k tiles,
//
//   out[m, c*k + n] = cast(act(sum over r = 0..rpc-1 ascending, j = 0..k-1 of
//                              x[m, rows[c, r]*k + j] * tiles[c, r][j, n]))
//
// with the sum in float32, act the tanh-form gelu (jax.nn.gelu's default) when
// fuse_gelu is set and the identity otherwise, and cast to x's dtype.
//
// What bounds it: at the FFN's full width (BlockSparseFFNConfig(), M = 8192,
// bf16, k = 128) each matmul does 103 GFLOP of useful work and must move about
// 348 MB: 0.104 ms against 989 TFLOP/s bf16 and about the same against
// 3.35 TB/s, so operations and bytes about equally.  The design keeps the
// gathered x blocks out of device memory (the plain version materialises
// them), keeps every sum in registers, and runs bf16 on the tensor cores.
//
// Design:
//   * one device body (accumulate, store_tile) for both kernels, so at the
//     same inputs they give identical bits: each output element is owned by
//     one thread, which adds the pairs r in ascending order, and within a
//     pair the 16-deep steps of mma.sync.m16n8k16 (bf16 x bf16 -> f32) in
//     ascending order.  The element's sum does not depend on which block or
//     warp owns it, so the bits depend on neither the row tile nor block_m.
//     float32 runs the same ownership on plain FMA (j ascending), not TF32;
//   * a block has 8 warps and owns br rows (16, 32, 64 or 128) of one output
//     block-column at a time; warp w owns 16 rows and a run of the column's
//     8-wide n-tiles (br / 16 warps down, 8 / (br / 16) across);
//   * kernel 3: a 1-D grid over (M / br row panels) x nbc columns, column
//     fastest, so neighbouring blocks share their x rows in L2.  Per pair the
//     block stages the x block at column rows[c, r]*k and the tile through
//     shared memory (cp.async, 16 bytes a thread), then multiplies.  br is
//     the wrapper's row_tile, the widest that still gives every SM a block,
//     not block_m: a block of 16 rows would restage each 32 KB tile for 16
//     rows of work;
//   * kernel 4: a block loads its br x d_in x panel into dynamic shared memory
//     once (cp.async, rows padded by 16 bytes) and sweeps a chunk of
//     col_chunk output columns (the wrapper splits the columns only as far
//     as about 2 blocks per SM need); the pair's x slice is read from the
//     panel at rows[c, r]*k.  The tiles stream through a ring of S stages
//     (2 to 4; 3 at the FFN's full width) of unpadded k x k tiles in shared
//     memory after the panel, fed by a tensor map (TMA, swizzled by
//     min(128, k * element bytes) bytes, so ldmatrix reads each row's
//     16-byte chunk at its index XORed with the row).  A ninth warp, the
//     producer, is the only one that issues tile loads; the 8 consumer
//     warps run the same accumulate and store_tile as kernel 3 on the
//     swizzled addresses.  Each stage has a full mbarrier (the tile's bytes
//     as its transaction count) and an empty one (one arrival per consumer
//     warp); the pair loop has no __syncthreads.  With a cluster of C
//     blocks on consecutive panels of one column chunk (C in 1, 2, 4) each
//     block's producer loads 1/C of every tile's rows and multicasts it to
//     all C blocks; every consumer warp then arrives on the empty barrier
//     of all C blocks (mapa), so a slice is rewritten only after all C
//     blocks have read its stage.  cuda_bsmm.resident_layout mirrors the
//     shared-memory layout and cuda_bsmm.cluster_size picks C.
//     Each consumer warp owns NT = warp_ntiles(k, br) n-tiles or none, NT
//     fixed at compile time: the per-n-tile guard kernel 3 keeps in its
//     products' loop doubled kernel 4's time, and the earlier body's loop
//     over all k / 8 n-tiles, guarded, is what held it at 5.5 ms.
//     What bounds it at block_m 16 and full width: 512 blocks of 16 rows,
//     one per SM (the panel fills it), each reading all 384 tiles of W1:
//     6.44 / C GB of tiles from L2 for 103 GFLOP.  Measured on an NVIDIA
//     H100 80GB HBM3, 700.00 W (PERF.md, tools/bsmm_resident_ab.py): 1.06 ms
//     at S = 3, C = 1, the tile stream alone (no products) 0.69 ms, the
//     earlier body 5.48 ms, torch.matmul of x by the dense W1 1.30 ms.
//     Not kept: clusters of 2 and 4 (1.15 and 1.43 ms: multicast did not
//     shorten the stream, and 30 clusters of 4 fit the card against 132
//     single blocks), S = 2 (1.10 ms); earlier, rotating each block's start
//     column, and multicast over clusters of 8 with one tile in flight;
//   * kernel 3's shared rows are padded by 16 bytes, so ldmatrix's 8 row
//     addresses hit distinct banks; kernel 4's tiles get the same from the
//     swizzle;
//   * no masking: M % br == 0 and d_in % k == 0 are checked.
// Left for later: wgmma (for kernels 3 and 4 together, since it changes the
// order inside the 16-deep step), wider warp tiles, a persistent grid.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadBytes = 16;        // each shared row is padded by this much
constexpr int kSmemBytes = 232448;   // shared memory a Hopper block can use
constexpr int kResidentThreads = kThreads + 32;  // kernel 4: 8 consumer warps and a producer
constexpr int kMaxStages = 4;        // kernel 4's deepest tile ring

template <typename T>
__host__ __device__ constexpr int pad_elems() { return kPadBytes / (int)sizeof(T); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// mbarriers, TMA and clusters (kernel 4), in the forms CUTLASS's sm90
// pipelines use.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival, announcing `bytes` more to come from TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive on the barrier at bar's offset in the shared memory of cluster block cta.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(cta)
      : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void prefetch_tmap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// The box at (c0 columns, c1 rows) of the map's view, into dst; its bytes
// count on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// The same box into dst and bar's offsets in every cluster block of mask.
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map, int c0,
                                                   int c1, uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  return rank;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// The 8 consumer warps of kernel 4 (named barrier 1; the producer is not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// Copy n_rows rows of row_elems elements from device memory (row stride
// src_ld) to shared memory (row stride dst_ld), 16 bytes a thread, async.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dst_ld, const T* src, long long src_ld,
                                           int n_rows, int row_elems) {
  constexpr int kVec = 16 / (int)sizeof(T);
  const int chunks = row_elems / kVec;
  for (int q = threadIdx.x; q < n_rows * chunks; q += kThreads) {
    const int i = q / chunks, v = q - i * chunks;
    cp_async16(dst + i * dst_ld + v * kVec, src + i * src_ld + v * kVec);
  }
}

// The warp's share of a br x k output tile: 16 rows from `row`, and n_count
// 8-wide n-tiles from n_first (0 when k / 8 is less than the warps across).
struct WarpTile {
  int row, n_first, n_count;
};

__device__ __forceinline__ WarpTile warp_tile(int br, int k) {
  const int warp = threadIdx.x >> 5;
  const int warps_m = br / 16, warps_n = kWarps / warps_m;
  const int wm = warp % warps_m, wn = warp / warps_m;
  const int ntiles = k / 8, per = (ntiles + warps_n - 1) / warps_n;
  const int first = wn * per;
  return WarpTile{16 * wm, first, max(0, min(ntiles, first + per) - first)};
}

// Where element (j, col) of a k x k tile lies in shared memory.  Kernel 3
// stages tiles with rows padded by 16 bytes.
template <typename T, int K>
struct PaddedTile {
  __device__ static __forceinline__ const T* at(const T* ws, int j, int col) {
    return ws + j * (K + pad_elems<T>()) + col;
  }
};

// Kernel 4's tiles as the tensor map writes them: kBoxes column boxes of
// kSpan bytes a row, each all K rows deep and stored whole one after the
// other; inside a box, row j's 16-byte chunk i lies at chunk i ^ ((j * kSpan
// / 128) % (kSpan / 16)) (CU_TENSOR_MAP_SWIZZLE_32B/64B/128B; the pattern
// repeats every 8 rows, so a box starts on a multiple of 8 * kSpan bytes).
template <typename T, int K>
struct SwizzledTile {
  static constexpr int kRowBytes = K * (int)sizeof(T);
  static constexpr int kSpan = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBoxes = kRowBytes / kSpan;
  static constexpr int kBoxBytes = K * kSpan;
  __device__ static __forceinline__ const T* at(const T* ws, int j, int col) {
    const int cb = col * (int)sizeof(T);
    int off = j * kSpan + cb % kSpan;
    off ^= ((off >> 7) & (kSpan / 16 - 1)) << 4;
    return reinterpret_cast<const T*>(reinterpret_cast<const char*>(ws) +
                                      (cb / kSpan) * kBoxBytes + off);
  }
};

// acc[t] += x slice (the warp's 16 rows, k columns; row stride xs_ld) times the
// tile's n-tile n_first + t, for bf16 on the tensor cores; Tile says where the
// tile's elements lie.  The accumulator element c of n-tile t sits at row g +
// 8 (c / 2), column 8 (n_first + t) + 2 (lane % 4) + c % 2, with g = lane / 4:
// mma's C fragment.  NT n-tiles at most; kGuarded runs only the warp's
// n_count of them (kernel 3), else all NT (kernel 4, whose warps own NT or
// none: a guard in this loop doubled kernel 4's time on the H100).
template <int K, int NT, bool kGuarded, class Tile>
__device__ __forceinline__ void accumulate(float (&acc)[NT][4], const bf16* xs, int xs_ld,
                                           const bf16* ws, const WarpTile& w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, xs + (w.row + (lane & 15)) * xs_ld + 16 * ks + 8 * (lane >> 4));
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (!kGuarded || t < w.n_count) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, Tile::at(ws, 16 * ks + (lane & 15), 8 * (w.n_first + t)));
        mma_bf16(acc[t], a, b);
      }
    }
  }
}

// The same for float32, on plain FMA with j ascending, same element ownership.
template <int K, int NT, bool kGuarded, class Tile>
__device__ __forceinline__ void accumulate(float (&acc)[NT][4], const float* xs, int xs_ld,
                                           const float* ws, const WarpTile& w) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* x0 = xs + (w.row + g) * xs_ld;
  const float* x1 = x0 + 8 * xs_ld;
#pragma unroll 4
  for (int j = 0; j < K; ++j) {
    const float a0 = x0[j], a1 = x1[j];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (!kGuarded || t < w.n_count) {
        const float* wr = Tile::at(ws, j, 8 * (w.n_first + t) + 2 * t4);
        const float b0 = wr[0], b1 = wr[1];
        acc[t][0] = fmaf(a0, b0, acc[t][0]);
        acc[t][1] = fmaf(a0, b1, acc[t][1]);
        acc[t][2] = fmaf(a1, b0, acc[t][2]);
        acc[t][3] = fmaf(a1, b1, acc[t][3]);
      }
    }
  }
}

// gelu, tanh form, in float32: PyTorch's own expression for
// F.gelu(x, approximate="tanh").
__device__ __forceinline__ float gelu_tanh(float v) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float cube = v * v * v;
  return 0.5f * v * (1.0f + tanhf(kBeta * (v + kKappa * cube)));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Epilogue: the optional gelu on the f32 sums, the cast, the store of the
// warp's share of output block-column c for rows m0.. (row stride ldo); then
// the accumulators are zeroed for the next column.
template <typename T, int K, int NT>
__device__ __forceinline__ void store_tile(float (&acc)[NT][4], T* out, long long ldo,
                                           long long m0, int c, const WarpTile& w,
                                           int fuse_gelu) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  T* o0 = out + (m0 + w.row + g) * ldo + (long long)c * K + 2 * t4;
  T* o1 = o0 + 8 * ldo;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < w.n_count) {
      float v[4] = {acc[t][0], acc[t][1], acc[t][2], acc[t][3]};
      if (fuse_gelu) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = gelu_tanh(v[e]);
      }
      store2(o0 + 8 * (w.n_first + t), v[0], v[1]);
      store2(o1 + 8 * (w.n_first + t), v[2], v[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.0f;
  }
}

// Kernel 3: block (panel p, column c) -> out rows p*br.., block-column c.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
bsmm_kernel(const T* __restrict__ x, const int32_t* __restrict__ rows,
            const T* __restrict__ tiles, T* __restrict__ out, int d_in, int nbc, int rpc,
            int br, int fuse_gelu) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLd = K + pad_elems<T>();
  T* xs = reinterpret_cast<T*>(smem);  // br x K: the pair's x block
  T* ws = xs + br * kLd;               // K x K: the pair's tile
  const int c = blockIdx.x % nbc;
  const long long m0 = (long long)(blockIdx.x / nbc) * br;
  const WarpTile w = warp_tile(br, K);
  float acc[K / 8][4];
#pragma unroll
  for (int t = 0; t < K / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

  for (int r = 0; r < rpc; ++r) {
    const long long pair = (long long)c * rpc + r;
    const long long col = (long long)rows[pair] * K;
    stage_rows(xs, kLd, x + m0 * d_in + col, d_in, br, K);
    stage_rows(ws, kLd, tiles + pair * K * K, K, K, K);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    accumulate<K, K / 8, true, PaddedTile<T, K>>(acc, xs, kLd, ws, w);
    __syncthreads();  // the stage is no longer read
  }
  store_tile<T, K, K / 8>(acc, out, (long long)nbc * K, m0, c, w, fuse_gelu);
}

// Kernel 4: block (panel blockIdx.x, column chunk blockIdx.y) loads x rows
// blockIdx.x*br.. whole, then computes block-columns blockIdx.y*col_chunk ..
// from that panel.  Its pairs (c, r) run in order as one stream, c * rpc + r,
// whose tiles the producer warp keeps `stages` deep in the ring: pair n of
// the stream lands in stage n % stages.  Shared memory (cuda_bsmm.
// resident_layout): the padded panel, the ring from ring_off, then a full and
// an empty mbarrier a stage.  cluster blocks (consecutive panels) share every
// tile: each loads rows rank*K/cluster.. of it into all of them.
// stream_only skips the products (a diagnostic of the tile stream alone).
// NT = warp_ntiles(K, br): each consumer warp owns NT n-tiles or none.
template <typename T, int K, int NT>
__global__ void __launch_bounds__(kResidentThreads, 1)
bsmm_resident_kernel(const __grid_constant__ CUtensorMap tmap, const T* __restrict__ x,
                     const int32_t* __restrict__ rows, T* __restrict__ out, int d_in, int nbc,
                     int rpc, int br, int col_chunk, int ring_off, int stages, int cluster,
                     int stream_only, int fuse_gelu) {
  extern __shared__ __align__(1024) unsigned char shm[];
  using Tile = SwizzledTile<T, K>;
  constexpr int kTileBytes = K * K * (int)sizeof(T);
  const int panel_ld = d_in + pad_elems<T>();
  T* panel = reinterpret_cast<T*>(shm);  // br x d_in: the block's x rows
  unsigned char* ring = shm + ring_off;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * kTileBytes);
  uint64_t* empty = full + stages;
  const long long m0 = (long long)blockIdx.x * br;
  const long long p0 = (long long)blockIdx.y * col_chunk * rpc;
  const int n_pairs = (int)((long long)min(nbc, ((int)blockIdx.y + 1) * col_chunk) * rpc - p0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    if (smem_addr(shm) & 1023) __trap();  // the swizzle needs the ring where the host put it
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps * cluster);
    }
    fence_mbarrier_init();
  }
  if (cluster > 1) {
    cluster_sync();  // every block's barriers exist before any is signalled
  } else {
    __syncthreads();
  }

  if (warp == kWarps) {  // the producer: one lane issues every tile load
    if (lane == 0) {
      prefetch_tmap(&tmap);
      const int rank = (int)cluster_ctarank(), slice = K / cluster;
      const uint16_t mask = (uint16_t)((1u << cluster) - 1);
      for (int n = 0; n < n_pairs; ++n) {
        const int s = n % stages;
        if (n >= stages) mbar_wait(&empty[s], ((n / stages) - 1) & 1);
        mbar_expect_tx(&full[s], kTileBytes);  // the whole tile, from every block's slice
        const int row = (int)((p0 + n) * K) + rank * slice;
        unsigned char* dst = ring + s * kTileBytes + rank * slice * Tile::kSpan;
#pragma unroll
        for (int b = 0; b < Tile::kBoxes; ++b) {
          const int col = b * Tile::kSpan / (int)sizeof(T);
          if (cluster == 1) {
            tma_load(dst + b * Tile::kBoxBytes, &tmap, col, row, &full[s]);
          } else {
            tma_load_multicast(dst + b * Tile::kBoxBytes, &tmap, col, row, &full[s], mask);
          }
        }
      }
    }
    __syncwarp();
  } else {  // the 8 consumer warps
    stage_rows(panel, panel_ld, x + m0 * d_in, d_in, br, d_in);
    cp_async_commit();
    cp_async_wait<0>();
    consumer_sync();  // the whole panel has landed
    const WarpTile w = warp_tile(br, K);  // n_count is NT or 0
    const bool products = !stream_only && w.n_count > 0;
    float acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;
    int c = blockIdx.y * col_chunk, r = 0;  // pair p0 + n is (c, r)
    for (int n = 0; n < n_pairs; ++n) {
      const int s = n % stages;
      const T* xs = panel + rows[p0 + n] * K;
      mbar_wait(&full[s], (n / stages) & 1);
      if (products)
        accumulate<K, NT, false, Tile>(acc, xs, panel_ld,
                                       reinterpret_cast<const T*>(ring + s * kTileBytes), w);
      __syncwarp();
      if (lane == 0) {  // this warp is done with stage s, in every block that shares it
        if (cluster == 1) {
          mbar_arrive(&empty[s]);
        } else {
          for (int cta = 0; cta < cluster; ++cta) mbar_arrive_cluster(&empty[s], (uint32_t)cta);
        }
      }
      if (++r == rpc) {
        store_tile<T, K, NT>(acc, out, (long long)nbc * K, m0, c, w, fuse_gelu);
        r = 0;
        ++c;
      }
    }
  }
  if (cluster > 1) {
    __syncwarp();
    cluster_sync();  // no block leaves while another may still signal it
  }
}

struct Args {
  const void* x;
  const void* rows;
  const void* tiles;
  void* out;
  long long M;
  int d_in, nbc, rpc, br, col_chunk, stages, cluster, stream_only, fuse_gelu, device;
  cudaStream_t stream;
};

// Kernel 3.
template <typename T, int K>
int launch_stream(const Args& a) {
  const long long panels = a.M / a.br;
  const size_t tile_bytes = (size_t)K * (K + pad_elems<T>()) * sizeof(T);
  const size_t smem = (size_t)a.br * (K + pad_elems<T>()) * sizeof(T) + tile_bytes;
  const long long blocks = panels * a.nbc;
  if (smem > (size_t)kSmemBytes || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bsmm_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bsmm_kernel<T, K><<<(unsigned)blocks, kThreads, smem, a.stream>>>(
      (const T*)a.x, (const int32_t*)a.rows, (const T*)a.tiles, (T*)a.out, a.d_in, a.nbc,
      a.rpc, a.br, a.fuse_gelu);
  return (int)cudaGetLastError();
}

// Kernel 4's shared memory, mirrored by cuda_bsmm.resident_layout: the
// padded panel, the ring from the first multiple of the swizzle's 8-row
// pattern (1024 bytes wherever rows are 128 bytes or more), then 2 mbarriers
// a stage.
struct Layout {
  size_t ring_off, bytes;
};

template <typename T, int K>
Layout resident_layout(int br, int d_in, int stages) {
  const size_t panel = (size_t)br * (d_in + pad_elems<T>()) * sizeof(T);
  const size_t align = 8 * SwizzledTile<T, K>::kSpan;
  const size_t ring_off = (panel + align - 1) / align * align;
  return {ring_off, ring_off + (size_t)stages * (K * K * sizeof(T) + 2 * sizeof(uint64_t))};
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// does not link libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? (EncodeTiled)p
                                                                      : (EncodeTiled) nullptr;
  }();
  return fn;
}

// Returned as kErrEncode + cuTensorMapEncodeTiled's CUresult when the map cannot
// be encoded (the wrapper names it).
constexpr int kErrEncode = 100000;

// The map of kernel 4's tiles: a 2-D view of nbc * rpc * K rows by K
// columns, boxes of kSpan bytes by K / cluster rows, swizzled by kSpan.
template <typename T, int K>
int encode_tiles(CUtensorMap* map, const Args& a) {
  using Tile = SwizzledTile<T, K>;
  const EncodeTiled fn = encode_tiled();
  if (!fn) return kErrEncode + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)a.nbc * a.rpc * K};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(Tile::kSpan / sizeof(T)), (cuuint32_t)(K / a.cluster)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = Tile::kSpan == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : Tile::kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                         : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r =
      fn(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
         2, const_cast<void*>(a.tiles), dims, strides, box, elem_strides,
         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

// The n-tiles a consumer warp of kernel 4 owns at br rows a block
// (warp_tile's per; every warp owns that many or none).
constexpr int warp_ntiles(int k, int br) {
  return (k / 8 + 128 / br - 1) / (128 / br);
}

template <typename T>
using ResidentKernel = void (*)(const CUtensorMap, const T*, const int32_t*, T*, int, int, int,
                                int, int, int, int, int, int, int);

// Kernel 4's instance for warps of nt n-tiles (nullptr for none it has).
template <typename T, int K, int NT>
ResidentKernel<T> resident_kernel_nt(int nt) {
  if constexpr (NT * 8 < K / 8) {  // fewer than any br gives
    return nullptr;
  } else {
    if (nt == NT) return bsmm_resident_kernel<T, K, NT>;
    if constexpr (NT > 1) return resident_kernel_nt<T, K, NT / 2>(nt);
    return nullptr;
  }
}

// Kernel 4, or (clusters != nullptr) how many of its clusters the card can
// hold at once (cudaOccupancyMaxActiveClusters), launching nothing.
template <typename T, int K>
int launch_resident(const Args& a, int* clusters) {
  const long long panels = a.M / a.br;
  if (a.stages < 2 || a.stages > kMaxStages || a.col_chunk < 1 ||
      (a.cluster != 1 && a.cluster != 2 && a.cluster != 4) || K % (8 * a.cluster) ||
      panels % a.cluster)
    return (int)cudaErrorInvalidValue;
  const Layout lay = resident_layout<T, K>(a.br, a.d_in, a.stages);
  const int col_blocks = (a.nbc + a.col_chunk - 1) / a.col_chunk;
  const ResidentKernel<T> kernel = resident_kernel_nt<T, K, K / 8>(warp_ntiles(K, a.br));
  if (lay.bytes > (size_t)kSmemBytes || panels > 0x7fffffffLL || col_blocks > 65535 || !kernel)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)panels, (unsigned)col_blocks, 1);
  cfg.blockDim = dim3(kResidentThreads, 1, 1);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = a.stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters) {
    cfg.gridDim = dim3((unsigned)a.cluster, 1, 1);
    return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  }
  CUtensorMap map;
  const int enc = encode_tiles<T, K>(&map, a);
  if (enc != 0) return enc;
  err = cudaLaunchKernelEx(&cfg, kernel, map, (const T*)a.x,
                           (const int32_t*)a.rows, (T*)a.out, a.d_in, a.nbc, a.rpc, a.br,
                           a.col_chunk, (int)lay.ring_off, a.stages, a.cluster, a.stream_only,
                           a.fuse_gelu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch(const Args& a, bool resident, int* clusters) {
  return resident ? launch_resident<T, K>(a, clusters) : launch_stream<T, K>(a);
}

template <typename T>
int launch_k(const Args& a, int k, bool resident, int* clusters) {
  switch (k) {
    case 16: return launch<T, 16>(a, resident, clusters);
    case 32: return launch<T, 32>(a, resident, clusters);
    case 64: return launch<T, 64>(a, resident, clusters);
    case 128: return launch<T, 128>(a, resident, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_any(const Args& a, int k, int dtype, bool resident, int* clusters = nullptr) {
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.M <= 0 || a.nbc <= 0) return (int)cudaSuccess;
  if ((a.br != 16 && a.br != 32 && a.br != 64 && a.br != 128) || a.M % a.br || a.rpc < 1 ||
      k < 1 || a.d_in < k || a.d_in % k)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_k<float>(a, k, resident, clusters);
    case 1: return launch_k<bf16>(a, k, resident, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel 3 on `stream` (a cudaStream_t) of device `device`.
//   x      : (M, d_in) float32 (dtype 0) or bfloat16 (dtype 1), 16-byte aligned;
//   rows   : (nbc, rpc) int32, every entry below d_in / k;
//   tiles  : (nbc, rpc, k, k) in x's dtype, 16-byte aligned;
//   out    : (M, nbc * k) in x's dtype, written whole;
//   k in {16, 32, 64, 128}; br, the rows a block owns, in {16, 32, 64, 128}
//   and dividing M.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_bsmm(const void* x, const void* rows, const void* tiles, void* out,
                           long long M, int d_in, int nbc, int rpc, int k, int br, int dtype,
                           int fuse_gelu, int device, void* stream) {
  const Args a{x, rows, tiles, out, M, d_in, nbc, rpc, br, 1, 0, 1, 0, fuse_gelu, device,
               (cudaStream_t)stream};
  return launch_any(a, k, dtype, false);
}

// Kernel 4, the same arguments and
//   col_chunk >= 1 : the output block-columns one block sweeps;
//   stages         : the tile ring's depth, 2 to 4;
//   cluster        : 1, 2 or 4 blocks sharing each tile, dividing M / br and
//                    k / 8;
//   stream_only    : 1 skips the products (the output is then not the
//                    product: a diagnostic of the tile stream alone).
// The br x d_in panel, the ring and its barriers must fit a block's shared
// memory, or it returns cudaErrorInvalidValue; kErrEncode + a CUresult when
// the tensor map of the tiles cannot be encoded.
extern "C" int spgemm_bsmm_resident(const void* x, const void* rows, const void* tiles,
                                    void* out, long long M, int d_in, int nbc, int rpc, int k,
                                    int br, int col_chunk, int stages, int cluster,
                                    int stream_only, int dtype, int fuse_gelu, int device,
                                    void* stream) {
  const Args a{x, rows, tiles, out, M, d_in, nbc, rpc, br, col_chunk, stages, cluster,
               stream_only, fuse_gelu, device, (cudaStream_t)stream};
  return launch_any(a, k, dtype, true);
}

// cudaOccupancyMaxActiveClusters of kernel 4 at these shapes, into *clusters
// (the most clusters of `cluster` blocks the card holds at once).
extern "C" int spgemm_bsmm_resident_clusters(int d_in, int k, int br, int stages, int cluster,
                                             int dtype, int device, int* clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, (long long)br * cluster, d_in, 1, 1, br, 1,
               stages, cluster, 0, 0, device, (cudaStream_t)0};
  *clusters = 0;
  return launch_any(a, k, dtype, true, clusters);
}
