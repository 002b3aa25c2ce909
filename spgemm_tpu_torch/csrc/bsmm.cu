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
// with the sum in float32, act the epilogue, and cast to x's dtype.  The
// epilogue is the identity, the tanh-form gelu (jax.nn.gelu's default;
// fuse_gelu), or, for the FFN's backward, gelu_grad: the sum times gelu'(pre)
// with pre an (M, nbc * k) tensor in x's dtype read at the output element
// (PyTorch's gelu_backward, tanh form).  With x = dy, rows = W2's cols and
// W2's tiles transposed, that is the training step's dpre = (dy . W2^T) *
// gelu'(pre) in one pass, so dh is never written and read back.
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
//     warp owns it, nor on where its operands lie in shared memory
//     (accumulate takes an addressing policy for each), so the bits depend
//     on neither the row tile, the warp tile, the ring, the grid nor
//     block_m.  float32 runs the same ownership on plain FMA (j ascending),
//     not TF32.  Kernel 3's bf16 path at k 128 and br 128 runs the same
//     16-deep steps, ascending, as wgmma.m64n128k16 (A the x block, K-major;
//     B the tile, N-major, both read by descriptor from the 128-byte-swizzled
//     stages), and on the H100 that gives mma.sync's bits: at full width on
//     all three of the FFN's calls, and on inputs whose exponents spread over
//     2^-40..2^40 (tools/bsmm_bits_ab.py, tests/test_torch_cuda.py);
//   * a block has 8 consumer warps and owns br rows (16, 32, 64 or 128) of
//     one output block-column at a time; on mma.sync warp w owns MT x 16
//     rows and NT 8-wide n-tiles of the column, or none (br / (16 MT) warps
//     down, the rest across; NT = warp_ntiles(k, br, MT) fixed at compile
//     time, so the products' loop has no per-n-tile guard: such a guard
//     doubled kernel 4's time); on wgmma each of the two warpgroups owns 64
//     rows of all 128 columns, warp w rows 64 (w / 4) + 16 (w % 4), as the
//     m64 step lays out its accumulators (mma's C fragment per n-tile);
//   * both kernels are fed by a ninth warp, the producer, whose one lane
//     issues every TMA load into a ring of stages in shared memory; each
//     stage has a full mbarrier (the stage's bytes as its transaction count)
//     and an empty one (one arrival per consumer warp), and the pair loop has
//     no __syncthreads.  The tensor maps swizzle by min(128, k * element
//     bytes) bytes, so ldmatrix reads each row's 16-byte chunk at its index
//     XORed with the row and hits distinct banks;
//   * kernel 3 (redesigned for Hopper): a persistent grid of min(items, SMs x
//     blocks an SM) blocks walks the items (row panel, output block-column),
//     column fastest, item += gridDim.x, so neighbouring blocks share their x
//     rows in L2.  Each stage holds the pair's br x k x block, loaded by TMA
//     from a 2-D map of x at column rows[c, r]*k (the gather happens in the
//     copy), and its k x k tile; the block's pairs run as one stream across
//     item boundaries, so the next item's loads are in flight during this
//     item's epilogue.  The epilogue writes the item's output into a staged
//     br x k tile in shared memory (swizzled like the stages) and one thread
//     stores it by TMA without waiting; the gelu_grad instance has the
//     producer load the item's pre into that tile by TMA while the item's
//     later pairs multiply, and overwrites it in place.  br is the wrapper's
//     row_tile (128 at full width), the ring cuda_bsmm.stream_layout's
//     deepest (3 x 64 KB and the 32 KB staged tile at full width), the
//     consumers cuda_bsmm.warp_rows' widest: wgmma's warpgroups where they
//     fit, else warps of 32 x (k / 8 over the warps across), else 16-row
//     warps (br 16, float32).  Measured at full width on an NVIDIA H100
//     80GB HBM3, 700.00 W (PERF.md, tools/bsmm_bits_ab.py), kernel 3 took
//     0.224 / 0.385 / 0.412 ms on matmul 1 / matmul 2 / the dgrad against
//     the earlier body's 0.671 / 1.017 / 0.838 (in turns); in one sweep
//     wgmma took 0.242 / 0.415 / 0.452 against mma.sync's 32 x 64 warp
//     tiles' 0.461 / 0.637 / 0.658, and the pair stream alone 0.29 / 0.42 /
//     0.24, so matmul 2, which also streams its zero pad tiles, and matmul
//     1 are bound by it.  Not kept, on matmul 1 in one sweep where the
//     32 x 64 tiles read 0.42 ms: 16 x 128 warp tiles (0.80 ms: 168
//     registers, the cap at 288 threads, and spills), row tiles 64 and 32
//     (0.47 and 0.57), one ring stage (0.58), one block an item (0.55); and,
//     in earlier calls, the first epilogue, which stored from registers (on
//     matmul 1 the epilogue alone, the pair stream with it against without
//     it, cost 0.18 ms; the staged tile's TMA store 0.05) and read pre into
//     registers before the item's last pair (the dgrad 1.08 ms: 116 bytes
//     of spills);
//   * kernel 4: a block loads its br x d_in x panel into dynamic shared memory
//     once (cp.async, rows padded by 16 bytes) and sweeps a chunk of
//     col_chunk output columns (the wrapper splits the columns only as far
//     as about 2 blocks per SM need); the pair's x slice is read from the
//     panel at rows[c, r]*k.  Only the tiles stream through its ring (2 to
//     4 stages; 3 at the FFN's full width).  With a cluster of C blocks on
//     consecutive panels of one column chunk (C in 1, 2, 4) each block's
//     producer loads 1/C of every tile's rows and multicasts it to all C
//     blocks; every consumer warp then arrives on the empty barrier of all C
//     blocks (mapa), so a slice is rewritten only after all C blocks have
//     read its stage.  cuda_bsmm.resident_layout mirrors the shared-memory
//     layout and cuda_bsmm.cluster_size picks C.  What bounds it at block_m
//     16 and full width: 512 blocks of 16 rows, one per SM (the panel fills
//     it), each reading all 384 tiles of W1: 6.44 / C GB of tiles from L2
//     for 103 GFLOP.  Measured on an NVIDIA H100 80GB HBM3, 700.00 W
//     (PERF.md, tools/bsmm_resident_ab.py): 1.06 ms at S = 3, C = 1, the
//     tile stream alone (no products) 0.69 ms, the earlier body 5.48 ms,
//     torch.matmul of x by the dense W1 1.30 ms.  Not kept: clusters of 2
//     and 4 (1.15 and 1.43 ms: multicast did not shorten the stream, and 30
//     clusters of 4 fit the card against 132 single blocks), S = 2 (1.10
//     ms); earlier, rotating each block's start column, and multicast over
//     clusters of 8 with one tile in flight;
//   * kernel 3's earlier body (one block per item, all 256 threads staging
//     the padded x block and tile by cp.async, then __syncthreads, the
//     products over all k / 8 n-tiles with a per-n-tile guard, __syncthreads
//     again) took 0.769 / 1.096 / 0.979 ms on the three calls in chip_smoke
//     (PERF.md);
//   * no masking: M % br == 0 and d_in % k == 0 are checked.
// Left for later: wgmma for kernel 4 and for kernel 3's other shapes, an
// epilogue that overlaps the next item's products (two accumulator sets,
// which need setmaxnreg), clusters for kernel 3.

#include <cuda.h>  // CUtensorMap and its enums; libcuda is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadBytes = 16;        // each row of kernel 4's panel is padded by this much
constexpr int kSmemBytes = 232448;   // shared memory a Hopper block can use
constexpr int kPipeThreads = kThreads + 32;  // 8 consumer warps and a producer
constexpr int kMaxStages = 4;        // the deepest ring of either kernel
constexpr long long kIntMax = 0x7fffffffLL;

template <typename T>
__host__ __device__ constexpr int pad_elems() { return kPadBytes / (int)sizeof(T); }

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

// The 8 consumer warps (named barrier 1; the producer is not in it).
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

// The warp's share of a br x k output tile: 16 * mt rows from `row`, and
// n_count 8-wide n-tiles from n_first (0 when k / 8 is less than the warps
// across).
struct WarpTile {
  int row, n_first, n_count;
};

__device__ __forceinline__ WarpTile warp_tile(int br, int k, int mt = 1) {
  const int warp = threadIdx.x >> 5;
  const int warps_m = br / (16 * mt), warps_n = kWarps / warps_m;
  const int wm = warp % warps_m, wn = warp / warps_m;
  const int ntiles = k / 8, per = (ntiles + warps_n - 1) / warps_n;
  const int first = wn * per;
  return WarpTile{16 * mt * wm, first, max(0, min(ntiles, first + per) - first)};
}

// The n-tiles a consumer warp of mt x 16 rows owns at br rows a block
// (warp_tile's per; every warp owns that many or none).
constexpr int warp_ntiles(int k, int br, int mt = 1) {
  return (k / 8 + 128 * mt / br - 1) / (128 * mt / br);
}

// Where element (i, j) of an operand lies in shared memory (A: i the row, j
// the k index; B: i the k index, j the output column).

// Kernel 4's x panel: rows of ld elements from base (the pair's column).
template <typename T>
struct PaddedRows {
  const T* base;
  int ld;
  __device__ __forceinline__ const T* at(int i, int j) const { return base + i * ld + j; }
};

// acc[m][t] += x slice (the warp's MT x 16 rows, K columns) times the tile's
// n-tile n_first + t; xs and ws say where the operands' elements lie.  For
// bf16 on the tensor cores: the accumulator element c of (m, t) sits at row
// 16 m + g + 8 (c / 2), column 8 (n_first + t) + 2 (lane % 4) + c % 2, with g
// = lane / 4: mma's C fragment, each 16-deep step in ascending order.  For
// float32 the same ownership on plain FMA, j ascending.  Every warp owns NT
// n-tiles or none, so the loop runs all NT (a guard in it doubled kernel 4's
// time on the H100).
template <typename T, int K, int MT, int NT, class A, class B>
__device__ __forceinline__ void accumulate(float (&acc)[MT][NT][4], const A& xs, const B& ws,
                                           const WarpTile& w) {
  const int lane = threadIdx.x & 31;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int ks = 0; ks < K / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(a[m], xs.at(w.row + 16 * m + (lane & 15), 16 * ks + 8 * (lane >> 4)));
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, ws.at(16 * ks + (lane & 15), 8 * (w.n_first + t)));
#pragma unroll
        for (int m = 0; m < MT; ++m) mma_bf16(acc[m][t], a[m], b);
      }
    }
  } else {
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll 4
    for (int j = 0; j < K; ++j) {
      float a[MT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        a[m][0] = *xs.at(w.row + 16 * m + g, j);
        a[m][1] = *xs.at(w.row + 16 * m + g + 8, j);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const T* wr = ws.at(j, 8 * (w.n_first + t) + 2 * t4);
        const float b0 = wr[0], b1 = wr[1];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][t][0] = fmaf(a[m][0], b0, acc[m][t][0]);
          acc[m][t][1] = fmaf(a[m][0], b1, acc[m][t][1]);
          acc[m][t][2] = fmaf(a[m][1], b0, acc[m][t][2]);
          acc[m][t][3] = fmaf(a[m][1], b1, acc[m][t][3]);
        }
      }
    }
  }
}

// The epilogues (the C entries' `epilogue`).
constexpr int kEpilogueNone = 0;
constexpr int kEpilogueGelu = 1;
constexpr int kEpilogueGeluGrad = 2;

// gelu, tanh form, in float32: PyTorch's own expression for
// F.gelu(x, approximate="tanh").
__device__ __forceinline__ float gelu_tanh(float v) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float cube = v * v * v;
  return 0.5f * v * (1.0f + tanhf(kBeta * (v + kKappa * cube)));
}

// g * gelu'(v), tanh form, in float32: PyTorch's own expression for
// gelu_backward(g, v, approximate="tanh").
__device__ __forceinline__ float gelu_tanh_grad(float g, float v) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float v_sq = v * v;
  const float inner = kBeta * (v + kKappa * v_sq * v);
  const float tanh_inner = tanhf(inner);
  const float left = 0.5f * v;
  const float right = 1.0f + tanh_inner;
  const float left_derivative = 0.5f * right;
  const float tanh_derivative = 1.0f - tanh_inner * tanh_inner;
  const float inner_derivative = kBeta * (1.0f + 3.0f * kKappa * v_sq);
  const float right_derivative = left * tanh_derivative * inner_derivative;
  return g * (left_derivative + right_derivative);
}

// Two neighbouring elements of T, as loaded.
template <typename T>
struct Pair2;
template <>
struct Pair2<float> {
  typedef float2 type;
};
template <>
struct Pair2<bf16> {
  typedef __nv_bfloat162 type;
};

__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }

template <typename T>
__device__ __forceinline__ float2 load2(const T* p) {
  return to_float2(*reinterpret_cast<const typename Pair2<T>::type*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// gelu_grad's pre at the pair of elements at (row, col) of the warp's br x K
// tile, element offset o in pre: read from device memory where the epilogue
// uses it (kernel 4) ...
template <typename T>
struct PreAtUse {
  const T* pre;
  __device__ __forceinline__ float2 get(long long o, int, int) const { return load2(pre + o); }
};

// ... or from kernel 3's staged tile, which the producer loaded by TMA ahead
// of the epilogue (the epilogue then overwrites each pair with its output).
template <typename T, int K>
struct StagedPre {
  Swizzled<T, K> tile;
  __device__ __forceinline__ float2 get(long long, int row, int col) const {
    return load2(tile.at(row, col));
  }
};

// Where the epilogue puts the pair of output elements at (row, col) of the
// warp's br x K tile, element offset o in out: straight to device memory
// (kernel 4) ...
template <typename T>
struct GlobalOut {
  T* out;
  __device__ __forceinline__ void put(long long o, int, int, float a, float b) const {
    store2(out + o, a, b);
  }
};

// ... or to kernel 3's swizzled tile in shared memory, which the TMA unit
// then stores whole.
template <typename T, int K>
struct StagedOut {
  Swizzled<T, K> tile;
  __device__ __forceinline__ void put(long long, int row, int col, float a, float b) const {
    store2(const_cast<T*>(tile.at(row, col)), a, b);
  }
};

// Epilogue: the epilogue on the f32 sums (gelu_grad reads pre at the same
// elements), the cast, the store of the warp's share of output block-column
// c for rows m0.. (row stride ldo) through `dst`; then the accumulators are
// zeroed for the next column.  kGrad compiles the gelu_grad epilogue in (in
// the instances that take it, so that the others keep the body, the
// registers and the time they had without it).
template <typename T, int K, int MT, int NT, bool kGrad, class Pre, class Out>
__device__ __forceinline__ void store_tile(float (&acc)[MT][NT][4], const Out& dst,
                                           const Pre& pre, long long ldo, long long m0, int c,
                                           const WarpTile& w, int epilogue) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int row = w.row + 16 * m + g;
    const long long off = (m0 + row) * ldo + (long long)c * K + 2 * t4;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (t < w.n_count) {
        const int col = 8 * (w.n_first + t) + 2 * t4;
        const long long o = off + 8 * (w.n_first + t);
        float v[4] = {acc[m][t][0], acc[m][t][1], acc[m][t][2], acc[m][t][3]};
        if (epilogue == kEpilogueGelu) {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = gelu_tanh(v[e]);
        } else if (kGrad && epilogue == kEpilogueGeluGrad) {
          const float2 p0 = pre.get(o, row, col);
          const float2 p1 = pre.get(o + 8 * ldo, row + 8, col);
          v[0] = gelu_tanh_grad(v[0], p0.x);
          v[1] = gelu_tanh_grad(v[1], p0.y);
          v[2] = gelu_tanh_grad(v[2], p1.x);
          v[3] = gelu_tanh_grad(v[3], p1.y);
        }
        dst.put(o, row, col, v[0], v[1]);
        dst.put(o + 8 * ldo, row + 8, col, v[2], v[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.0f;
    }
  }
}

// Kernel 3: block b walks the items b, b + gridDim.x, ... below `items`;
// item = p * nbc + c -> out rows p*br.., block-column c.  Its pairs (item,
// r) run in order as one stream whose x block and tile the producer warp
// keeps `stages` deep in the ring: the block's pair n lands in stage n %
// stages.  Shared memory (cuda_bsmm.stream_layout): `stages` stages, each
// the br x K x block then the K x K tile as the tensor maps' swizzled boxes,
// then a full and an empty mbarrier a stage.  stream_only 1 skips the
// products, 2 the epilogue too (diagnostics of the pair stream alone, with
// and without the output's store).  Each consumer warp owns
// MT x 16 rows and NT = warp_ntiles(K, br, MT) n-tiles or none.  kGrad: the
// instance that takes the gelu_grad epilogue, with pre read into registers
// before the item's last pair.
template <typename T, int K, int MT, int NT, bool kGrad, bool kWg = false>
__global__ void __launch_bounds__(kPipeThreads, 1)
bsmm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap tmap,
            const __grid_constant__ CUtensorMap omap, const __grid_constant__ CUtensorMap pmap,
            const int32_t* __restrict__ rows, int nbc, int rpc, int br, int items, int stages,
            int stream_only, int epilogue) {
  extern __shared__ __align__(1024) unsigned char shm[];
  using Sw = Swizzled<T, K>;
  constexpr int kTileBytes = K * K * (int)sizeof(T);
  const int x_bytes = br * K * (int)sizeof(T);
  const int stage_bytes = x_bytes + kTileBytes;
  unsigned char* staged = shm + stages * stage_bytes;  // br x K: the item's pre, then output
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + x_bytes);
  uint64_t* empty = full + stages;
  uint64_t* pre_full = empty + stages;  // gelu_grad: the item's pre has landed in staged
  uint64_t* out_free = pre_full + 1;    // gelu_grad: the last store has read staged
  const bool grad = kGrad && epilogue == kEpilogueGeluGrad && stream_only < 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    if (smem_addr(shm) & 1023) __trap();  // the swizzle needs the stages where the host put them
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    mbar_init(pre_full, 1);
    mbar_init(out_free, 1);
    fence_mbarrier_init();
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer: one lane issues every load
    if (lane == 0) {
      prefetch_tmap(&xmap);
      prefetch_tmap(&tmap);
      prefetch_tmap(&omap);
      if (grad) prefetch_tmap(&pmap);
      int n = 0, j = 0;  // the block's pair stream, and its items
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int c = item % nbc, m0 = (item / nbc) * br;
        for (int r = 0; r < rpc; ++r, ++n) {
          const int s = n % stages, pair = c * rpc + r;
          const int col = rows[pair] * K;  // read before the wait, so its latency hides there
          if (n >= stages) mbar_wait(&empty[s], ((n / stages) - 1) & 1);
          mbar_expect_tx(&full[s], (uint32_t)stage_bytes);
          unsigned char* st = shm + s * stage_bytes;
#pragma unroll
          for (int b = 0; b < Sw::kBoxes; ++b) {
            const int box_col = b * Sw::kSpan / (int)sizeof(T);
            tma_load(st + b * br * Sw::kSpan, &xmap, col + box_col, m0, &full[s]);
            tma_load(st + x_bytes + b * K * Sw::kSpan, &tmap, box_col, pair * K, &full[s]);
          }
        }
        // gelu_grad: after the item's pairs, its pre into staged once the last
        // store has read it (the consumers say so after this item's first
        // pair), so it lands while they multiply the rest
        if (grad) {
          if (j > 0) mbar_wait(out_free, (j - 1) & 1);
          mbar_expect_tx(pre_full, (uint32_t)x_bytes);
#pragma unroll
          for (int b = 0; b < Sw::kBoxes; ++b)
            tma_load(staged + b * br * Sw::kSpan, &pmap, c * K + b * Sw::kSpan / (int)sizeof(T),
                     m0, pre_full);
        }
      }
    }
    __syncwarp();
  } else {  // the 8 consumer warps
    // n_count is NT or 0; with wgmma warp w owns rows 64 (w / 4) + 16 (w % 4).. of
    // all K columns, as the m64 step's accumulator lays them out
    const WarpTile w = kWg ? WarpTile{64 * (warp >> 2) + 16 * (warp & 3), 0, K / 8}
                           : warp_tile(br, K, MT);
    const bool products = !stream_only && w.n_count > 0;
    const long long ldo = (long long)nbc * K;
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[m][t][0] = acc[m][t][1] = acc[m][t][2] = acc[m][t][3] = 0.0f;
    const Sw tile_out{staged, br * Sw::kSpan};
    int n = 0, j = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
      const int c = item % nbc;
      const long long m0 = (long long)(item / nbc) * br;
      for (int r = 0; r < rpc; ++r, ++n) {
        const int s = n % stages;
        mbar_wait(&full[s], (n / stages) & 1);
        const unsigned char* st = shm + s * stage_bytes;
        if constexpr (kWg) {
          if (products) {
            // A: this warpgroup's 64 rows of the x block, K-major; step ks lies
            // 32 bytes on per step in a 128-byte box row (the hardware swizzles
            // the address), and 4 steps a box.  B: the tile's rows 16 ks..,
            // N-major; its two 64-column boxes lie K * 128 bytes apart (the
            // leading offset), and each 8-row group 1024 bytes on (the stride)
            const unsigned char* a = st + (warp >> 2) * 64 * Sw::kSpan;
            const unsigned char* b = st + x_bytes;
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < K / 16; ++ks) {
              const uint64_t da =
                  gmma_desc(a + (ks / 4) * br * Sw::kSpan + (ks % 4) * 32, 16, 1024);
              const uint64_t db = gmma_desc(b + ks * 16 * Sw::kSpan, K * Sw::kSpan, 1024);
              wgmma_m64n128(acc[0], da, db);
            }
            wgmma_commit_wait();
          }
        } else if (products) {
          accumulate<T, K, MT, NT>(acc, Sw{st, br * Sw::kSpan},
                                   Sw{st + x_bytes, K * Sw::kSpan}, w);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
        if (grad && r == 0 && j > 0 && threadIdx.x == 0) {  // staged is free for this item's pre
          bulk_wait_read();
          mbar_arrive(out_free);
        }
      }
      if (stream_only >= 2) continue;
      if (grad) {
        mbar_wait(pre_full, j & 1);  // implies the last store has read staged
      } else {  // the staged tile is free once the previous item's store has read it
        if (threadIdx.x == 0) bulk_wait_read();
        consumer_sync();
      }
      store_tile<T, K, MT, NT, kGrad>(acc, StagedOut<T, K>{tile_out}, StagedPre<T, K>{tile_out},
                                      ldo, m0, c, w, epilogue);
      fence_async_shared();
      consumer_sync();
      if (threadIdx.x == 0) {  // one thread stores the tile, and no consumer waits for it
#pragma unroll
        for (int b = 0; b < Sw::kBoxes; ++b)
          tma_store(&omap, staged + b * br * Sw::kSpan, c * K + b * Sw::kSpan / (int)sizeof(T),
                    (int)m0);
        bulk_commit();
      }
    }
    if (threadIdx.x == 0) bulk_wait_read();  // the last store has read the staged tile
  }
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
// kGrad: the instance that takes the gelu_grad epilogue (store_tile).
template <typename T, int K, int NT, bool kGrad>
__global__ void __launch_bounds__(kPipeThreads, 1)
bsmm_resident_kernel(const __grid_constant__ CUtensorMap tmap, const T* __restrict__ x,
                     const int32_t* __restrict__ rows, T* __restrict__ out,
                     const T* __restrict__ pre, int d_in, int nbc, int rpc, int br,
                     int col_chunk, int ring_off, int stages, int cluster, int stream_only,
                     int epilogue) {
  extern __shared__ __align__(1024) unsigned char shm[];
  using Tile = Swizzled<T, K>;
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
            tma_load(dst + b * K * Tile::kSpan, &tmap, col, row, &full[s]);
          } else {
            tma_load_multicast(dst + b * K * Tile::kSpan, &tmap, col, row, &full[s], mask);
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
    float acc[1][NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[0][t][0] = acc[0][t][1] = acc[0][t][2] = acc[0][t][3] = 0.0f;
    int c = blockIdx.y * col_chunk, r = 0;  // pair p0 + n is (c, r)
    for (int n = 0; n < n_pairs; ++n) {
      const int s = n % stages;
      const T* xs = panel + rows[p0 + n] * K;
      mbar_wait(&full[s], (n / stages) & 1);
      if (products)
        accumulate<T, K, 1, NT>(acc, PaddedRows<T>{xs, panel_ld},
                                Tile{ring + s * kTileBytes, K * Tile::kSpan}, w);
      __syncwarp();
      if (lane == 0) {  // this warp is done with stage s, in every block that shares it
        if (cluster == 1) {
          mbar_arrive(&empty[s]);
        } else {
          for (int cta = 0; cta < cluster; ++cta) mbar_arrive_cluster(&empty[s], (uint32_t)cta);
        }
      }
      if (++r == rpc) {
        store_tile<T, K, 1, NT, kGrad>(acc, GlobalOut<T>{out}, PreAtUse<T>{pre},
                                       (long long)nbc * K, m0, c, w, epilogue);
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
  const void* pre;
  long long M;
  int d_in, nbc, rpc, br;
  int stages, stream_only, epilogue, device;
  int col_chunk, cluster;  // kernel 4's
  int warp_m, grid;        // kernel 3's
  cudaStream_t stream;
};

// The tiles as a 2-D view of nbc * rpc * K rows by K columns, boxes K /
// cluster rows deep (both kernels).
template <typename T, int K>
int encode_tiles(CUtensorMap* map, const Args& a) {
  return encode_rows<T, K>(map, a.tiles, K, (long long)a.nbc * a.rpc * K, K / a.cluster);
}

template <typename T>
using StreamKernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                              const CUtensorMap, const int32_t*, int, int, int, int, int, int,
                              int);

// Kernel 3's instance for warps of mt x 16 rows and nt n-tiles and the
// gelu_grad epilogue or not (nullptr for none it has).
template <typename T, int K, int MT, int NT>
StreamKernel<T> stream_kernel_nt(int nt, bool grad) {
  if constexpr (NT * 8 < K / 8) {  // fewer than any br gives
    return nullptr;
  } else {
    if (nt == NT) return grad ? bsmm_kernel<T, K, MT, NT, true> : bsmm_kernel<T, K, MT, NT, false>;
    if constexpr (NT > 1) return stream_kernel_nt<T, K, MT, NT / 2>(nt, grad);
    return nullptr;
  }
}

// Kernel 3's warps own warp_m rows: 16, or 32 for bf16 at br >= 32; 64: bf16
// warpgroups on wgmma at k 128 and br 128.
template <typename T, int K>
StreamKernel<T> stream_kernel(int warp_m, int br, bool grad) {
  if (warp_m == 16) return stream_kernel_nt<T, K, 1, K / 8>(warp_ntiles(K, br, 1), grad);
  if constexpr (sizeof(T) == 2) {
    if (warp_m == 32 && br >= 32)
      return stream_kernel_nt<T, K, 2, K / 16>(warp_ntiles(K, br, 2), grad);
    if constexpr (K == 128) {
      if (warp_m == 64 && br == 128)
        return grad ? bsmm_kernel<T, K, 1, 16, true, true> : bsmm_kernel<T, K, 1, 16, false, true>;
    }
  }
  return nullptr;
}

// Kernel 3's shared memory, mirrored by cuda_bsmm.stream_layout: `stages`
// stages of the br x K x block and the K x K tile, the br x K staged tile
// (pre, then the output), then 2 mbarriers a stage and 2 for the staged tile.
template <typename T, int K>
size_t stream_bytes(int br, int stages) {
  return (size_t)stages * ((size_t)(br + K) * K * sizeof(T) + 2 * sizeof(uint64_t)) +
         (size_t)br * K * sizeof(T) + 2 * sizeof(uint64_t);
}

// Kernel 3 on a.grid blocks, or (blocks_per_sm != nullptr) how many of its
// blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// launching nothing.
template <typename T, int K>
int launch_stream(const Args& a, int* blocks_per_sm) {
  const long long items = a.M / a.br * a.nbc;
  const size_t bytes = stream_bytes<T, K>(a.br, a.stages);
  const StreamKernel<T> kernel =
      stream_kernel<T, K>(a.warp_m, a.br, a.epilogue == kEpilogueGeluGrad);
  if (a.stages < 1 || a.stages > kMaxStages || bytes > (size_t)kSmemBytes || !kernel ||
      a.M > kIntMax || items * a.rpc > kIntMax || (long long)a.nbc * a.rpc * K > kIntMax)
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  if (blocks_per_sm)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                              kPipeThreads, bytes);
  if (a.grid < 1 || a.grid > items) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, tmap, omap, pmap;
  int enc = encode_rows<T, K>(&xmap, a.x, a.d_in, a.M, a.br);
  if (enc == 0) enc = encode_tiles<T, K>(&tmap, a);
  if (enc == 0) enc = encode_rows<T, K>(&omap, a.out, (long long)a.nbc * K, a.M, a.br);
  if (enc == 0) {  // pre has the output's shape; without gelu_grad the map is not read
    enc = a.pre ? encode_rows<T, K>(&pmap, a.pre, (long long)a.nbc * K, a.M, a.br) : 0;
    if (!a.pre) pmap = omap;
  }
  if (enc != 0) return enc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.grid, 1, 1);
  cfg.blockDim = dim3(kPipeThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = a.stream;
  err = cudaLaunchKernelEx(&cfg, kernel, xmap, tmap, omap, pmap, (const int32_t*)a.rows, a.nbc,
                           a.rpc, a.br, (int)items, a.stages, a.stream_only, a.epilogue);
  if (err != cudaSuccess) return (int)err;
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
  const size_t align = 8 * Swizzled<T, K>::kSpan;
  const size_t ring_off = (panel + align - 1) / align * align;
  return {ring_off, ring_off + (size_t)stages * (K * K * sizeof(T) + 2 * sizeof(uint64_t))};
}

template <typename T>
using ResidentKernel = void (*)(const CUtensorMap, const T*, const int32_t*, T*, const T*, int,
                                int, int, int, int, int, int, int, int, int);

// Kernel 4's instance for warps of nt n-tiles and the gelu_grad epilogue or
// not (nullptr for none it has).
template <typename T, int K, int NT>
ResidentKernel<T> resident_kernel_nt(int nt, bool grad) {
  if constexpr (NT * 8 < K / 8) {  // fewer than any br gives
    return nullptr;
  } else {
    if (nt == NT)
      return grad ? bsmm_resident_kernel<T, K, NT, true> : bsmm_resident_kernel<T, K, NT, false>;
    if constexpr (NT > 1) return resident_kernel_nt<T, K, NT / 2>(nt, grad);
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
  const ResidentKernel<T> kernel =
      resident_kernel_nt<T, K, K / 8>(warp_ntiles(K, a.br), a.epilogue == kEpilogueGeluGrad);
  if (lay.bytes > (size_t)kSmemBytes || panels > kIntMax || col_blocks > 65535 || !kernel)
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
  cfg.blockDim = dim3(kPipeThreads, 1, 1);
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
                           (const int32_t*)a.rows, (T*)a.out, (const T*)a.pre, a.d_in, a.nbc,
                           a.rpc, a.br, a.col_chunk, (int)lay.ring_off, a.stages, a.cluster,
                           a.stream_only, a.epilogue);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int K>
int launch(const Args& a, bool resident, int* query) {
  return resident ? launch_resident<T, K>(a, query) : launch_stream<T, K>(a, query);
}

template <typename T>
int launch_k(const Args& a, int k, bool resident, int* query) {
  switch (k) {
    case 16: return launch<T, 16>(a, resident, query);
    case 32: return launch<T, 32>(a, resident, query);
    case 64: return launch<T, 64>(a, resident, query);
    case 128: return launch<T, 128>(a, resident, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A launch, or (query != nullptr) kernel 4's clusters or kernel 3's blocks an
// SM at these shapes; a query takes no operands, so pre is not checked.
int launch_any(const Args& a, int k, int dtype, bool resident, int* query = nullptr) {
  cudaError_t err = cudaSetDevice(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.M <= 0 || a.nbc <= 0) return (int)cudaSuccess;
  if ((a.br != 16 && a.br != 32 && a.br != 64 && a.br != 128) || a.M % a.br || a.rpc < 1 ||
      k < 1 || a.d_in < k || a.d_in % k || a.epilogue < kEpilogueNone ||
      a.epilogue > kEpilogueGeluGrad ||
      (!query && (a.epilogue == kEpilogueGeluGrad) != (a.pre != nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch_k<float>(a, k, resident, query);
    case 1: return launch_k<bf16>(a, k, resident, query);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Kernel 3 on `stream` (a cudaStream_t) of device `device`.
//   x           : (M, d_in) float32 (dtype 0) or bfloat16 (dtype 1), 16-byte aligned;
//   rows        : (nbc, rpc) int32, every entry below d_in / k;
//   tiles       : (nbc, rpc, k, k) in x's dtype, 16-byte aligned;
//   out         : (M, nbc * k) in x's dtype, written whole;
//   pre         : (M, nbc * k) in x's dtype, 16-byte aligned, for epilogue 2
//                 only (nullptr otherwise);
//   epilogue    : 0 none, 1 gelu, 2 gelu_grad (times gelu'(pre));
//   k in {16, 32, 64, 128}; br, the rows a block owns, in {16, 32, 64, 128}
//   and dividing M;
//   warp_m      : the rows a consumer warp owns, 16, or 32 for bf16 at br >= 32;
//   stages      : the ring's depth, 1 to 4, within a block's shared memory;
//   grid        : the blocks, 1 to (M / br) * nbc (every block walks the items
//                 from its index in steps of grid);
//   stream_only : 1 skips the products, 2 the epilogue too (the output is then
//                 not the product: diagnostics of the pair stream alone).
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for shapes it does not take, or kErrEncode + a
// CUresult when a tensor map cannot be encoded.
extern "C" int spgemm_bsmm(const void* x, const void* rows, const void* tiles, void* out,
                           const void* pre, long long M, int d_in, int nbc, int rpc, int k,
                           int br, int warp_m, int stages, int grid, int stream_only, int dtype,
                           int epilogue, int device, void* stream) {
  const Args a{x,      rows,        tiles,    out,    pre, M, d_in, nbc, rpc, br,
               stages, stream_only, epilogue, device, 1,   1, warp_m, grid, (cudaStream_t)stream};
  return launch_any(a, k, dtype, false);
}

// cudaOccupancyMaxActiveBlocksPerMultiprocessor of kernel 3 at these shapes
// (the instance of epilogue's, gelu_grad or not), into *blocks.
extern "C" int spgemm_bsmm_blocks_per_sm(int k, int br, int warp_m, int stages, int dtype,
                                         int epilogue, int device, int* blocks) {
  const Args a{nullptr, nullptr, nullptr,  nullptr, nullptr, br, k, 1, 1, br,
               stages,  0,       epilogue, device,  1,       1,  warp_m, 1, (cudaStream_t)0};
  *blocks = 0;
  return launch_any(a, k, dtype, false, blocks);
}

// Kernel 4, the same arguments as kernel 3 but warp_m and grid, and
//   col_chunk >= 1 : the output block-columns one block sweeps;
//   stages         : the tile ring's depth, 2 to 4;
//   cluster        : 1, 2 or 4 blocks sharing each tile, dividing M / br and
//                    k / 8.
// The br x d_in panel, the ring and its barriers must fit a block's shared
// memory, or it returns cudaErrorInvalidValue; kErrEncode + a CUresult when
// the tensor map of the tiles cannot be encoded.
extern "C" int spgemm_bsmm_resident(const void* x, const void* rows, const void* tiles,
                                    void* out, const void* pre, long long M, int d_in, int nbc,
                                    int rpc, int k, int br, int col_chunk, int stages,
                                    int cluster, int stream_only, int dtype, int epilogue,
                                    int device, void* stream) {
  const Args a{x,      rows,        tiles,    out,    pre,       M,       d_in, nbc, rpc, br,
               stages, stream_only, epilogue, device, col_chunk, cluster, 16,   1,
               (cudaStream_t)stream};
  return launch_any(a, k, dtype, true);
}

// cudaOccupancyMaxActiveClusters of kernel 4 at these shapes, into *clusters
// (the most clusters of `cluster` blocks the card holds at once).
extern "C" int spgemm_bsmm_resident_clusters(int d_in, int k, int br, int stages, int cluster,
                                             int dtype, int device, int* clusters) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, (long long)br * cluster, d_in, 1, 1,
               br,      stages,  0,       0,       device,  1,       cluster, 16, 1,
               (cudaStream_t)0};
  *clusters = 0;
  return launch_any(a, k, dtype, true, clusters);
}
