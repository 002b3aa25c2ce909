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
//     once and sweeps a chunk of col_chunk output columns (the wrapper splits
//     the columns only as far as about 2 blocks per SM need), staging only
//     the tiles, two buffers deep so the next tile loads while the current
//     one multiplies; the pair's x slice is read from the panel at
//     rows[c, r]*k.  The wrapper's resident_panel_fits keeps panel plus two
//     tiles within a block's 232,448 bytes of shared memory.  At block_m 16
//     and d_in 4096 the panel fills the SM, one tile is in flight per SM, and
//     that latency sets the pace: rotating each block's start column and
//     multicasting the tiles across a cluster of 8 blocks (bulk copies, a
//     cluster barrier per step) were both measured on the H100, the first
//     moved nothing and the second was 1.4x slower (PERF.md);
//   * shared rows are padded by 16 bytes, so ldmatrix's 8 row addresses hit
//     distinct banks;
//   * no masking: M % br == 0 and d_in % k == 0 are checked.
// Left for later: wgmma, tiles fed by tensor-map TMA into swizzled
// buffers (a deeper ring beside kernel 4's panel, then multicast), wider warp
// tiles, a persistent grid.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPadBytes = 16;        // each shared row is padded by this much
constexpr int kSmemBytes = 232448;   // shared memory a Hopper block can use

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

// acc[t] += x slice (the warp's 16 rows, k columns; row stride xs_ld) times the
// tile's n-tile n_first + t, for bf16 on the tensor cores.  The accumulator
// element c of n-tile t sits at row g + 8 (c / 2), column 8 (n_first + t) +
// 2 (lane % 4) + c % 2, with g = lane / 4: mma's C fragment.
template <int K>
__device__ __forceinline__ void accumulate(float (&acc)[K / 8][4], const bf16* xs, int xs_ld,
                                           const bf16* ws, const WarpTile& w) {
  constexpr int kLd = K + pad_elems<bf16>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, xs + (w.row + (lane & 15)) * xs_ld + 16 * ks + 8 * (lane >> 4));
#pragma unroll
    for (int t = 0; t < K / 8; ++t) {
      if (t < w.n_count) {
        uint32_t b[2];
        ldmatrix_x2_trans(b, ws + (16 * ks + (lane & 15)) * kLd + 8 * (w.n_first + t));
        mma_bf16(acc[t], a, b);
      }
    }
  }
}

// The same for float32, on plain FMA with j ascending, same element ownership.
template <int K>
__device__ __forceinline__ void accumulate(float (&acc)[K / 8][4], const float* xs, int xs_ld,
                                           const float* ws, const WarpTile& w) {
  constexpr int kLd = K + pad_elems<float>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float* x0 = xs + (w.row + g) * xs_ld;
  const float* x1 = x0 + 8 * xs_ld;
#pragma unroll 4
  for (int j = 0; j < K; ++j) {
    const float a0 = x0[j], a1 = x1[j];
    const float* wr = ws + j * kLd + 2 * t4;
#pragma unroll
    for (int t = 0; t < K / 8; ++t) {
      if (t < w.n_count) {
        const float b0 = wr[8 * (w.n_first + t)], b1 = wr[8 * (w.n_first + t) + 1];
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
template <typename T, int K>
__device__ __forceinline__ void store_tile(float (&acc)[K / 8][4], T* out, long long ldo,
                                           long long m0, int c, const WarpTile& w,
                                           int fuse_gelu) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  T* o0 = out + (m0 + w.row + g) * ldo + (long long)c * K + 2 * t4;
  T* o1 = o0 + 8 * ldo;
#pragma unroll
  for (int t = 0; t < K / 8; ++t) {
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
    accumulate<K>(acc, xs, kLd, ws, w);
    __syncthreads();  // the stage is no longer read
  }
  store_tile<T, K>(acc, out, (long long)nbc * K, m0, c, w, fuse_gelu);
}

// Kernel 4: block (panel p, column chunk q) loads x rows p*br.. whole, then
// computes block-columns q*col_chunk .. from that panel.  Its pairs (c, r)
// run in order as one stream, c * rpc + r, whose tiles are double-buffered:
// the next pair's tile is in flight while the current one multiplies.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
bsmm_resident_kernel(const T* __restrict__ x, const int32_t* __restrict__ rows,
                     const T* __restrict__ tiles, T* __restrict__ out, int d_in, int nbc,
                     int rpc, int br, int col_blocks, int col_chunk, int fuse_gelu) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kLd = K + pad_elems<T>();
  const int panel_ld = d_in + pad_elems<T>();
  T* panel = reinterpret_cast<T*>(smem);  // br x d_in: the block's x rows
  T* ws[2] = {panel + br * panel_ld,      // K x K each: tiles of alternate pairs
              panel + br * panel_ld + K * kLd};
  const int q = blockIdx.x % col_blocks;
  const long long m0 = (long long)(blockIdx.x / col_blocks) * br;
  const long long p0 = (long long)q * col_chunk * rpc;
  const long long p_end = (long long)min(nbc, (q + 1) * col_chunk) * rpc;
  const WarpTile w = warp_tile(br, K);
  float acc[K / 8][4];
#pragma unroll
  for (int t = 0; t < K / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.0f;

  stage_rows(panel, panel_ld, x + m0 * d_in, d_in, br, d_in);
  stage_rows(ws[0], kLd, tiles + p0 * K * K, K, K, K);
  cp_async_commit();  // group: the panel and the first tile
  for (long long p = p0; p < p_end; ++p) {
    const int buf = (int)((p - p0) & 1);
    if (p + 1 < p_end) {  // its buffer was last read before the previous barrier
      stage_rows(ws[buf ^ 1], kLd, tiles + (p + 1) * K * K, K, K, K);
      cp_async_commit();
      cp_async_wait<1>();  // pair p's group has landed, p + 1's may still fly
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    accumulate<K>(acc, panel + rows[p] * K, panel_ld, ws[buf], w);
    const int c = (int)(p / rpc);
    if (p - (long long)c * rpc == rpc - 1)
      store_tile<T, K>(acc, out, (long long)nbc * K, m0, c, w, fuse_gelu);
    __syncthreads();  // buffer buf is no longer read
  }
}

struct Args {
  const void* x;
  const void* rows;
  const void* tiles;
  void* out;
  long long M;
  int d_in, nbc, rpc, br, col_chunk, fuse_gelu, device;
  cudaStream_t stream;
};

template <typename T, int K>
int launch(const Args& a, bool resident) {
  const long long panels = a.M / a.br;
  const size_t tile_bytes = (size_t)K * (K + pad_elems<T>()) * sizeof(T);
  if (!resident) {
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
  const size_t smem = (size_t)a.br * (a.d_in + pad_elems<T>()) * sizeof(T) + 2 * tile_bytes;
  if (smem > (size_t)kSmemBytes || a.col_chunk < 1) return (int)cudaErrorInvalidValue;
  const int col_blocks = (a.nbc + a.col_chunk - 1) / a.col_chunk;
  const long long blocks = panels * col_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(bsmm_resident_kernel<T, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bsmm_resident_kernel<T, K><<<(unsigned)blocks, kThreads, smem, a.stream>>>(
      (const T*)a.x, (const int32_t*)a.rows, (const T*)a.tiles, (T*)a.out, a.d_in, a.nbc,
      a.rpc, a.br, col_blocks, a.col_chunk, a.fuse_gelu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const Args& a, int k, bool resident) {
  switch (k) {
    case 16: return launch<T, 16>(a, resident);
    case 32: return launch<T, 32>(a, resident);
    case 64: return launch<T, 64>(a, resident);
    case 128: return launch<T, 128>(a, resident);
    default: return (int)cudaErrorInvalidValue;
  }
}

int launch_any(const void* x, const void* rows, const void* tiles, void* out, long long M,
               int d_in, int nbc, int rpc, int k, int br, int col_chunk, int dtype, int fuse_gelu,
               int device, void* stream, bool resident) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M <= 0 || nbc <= 0) return (int)cudaSuccess;
  if ((br != 16 && br != 32 && br != 64 && br != 128) || M % br || rpc < 1 || k < 1 ||
      d_in < k || d_in % k)
    return (int)cudaErrorInvalidValue;
  const Args a{x, rows, tiles, out, M, d_in, nbc, rpc, br, col_chunk, fuse_gelu, device,
               (cudaStream_t)stream};
  switch (dtype) {
    case 0: return launch_k<float>(a, k, resident);
    case 1: return launch_k<bf16>(a, k, resident);
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
  return launch_any(x, rows, tiles, out, M, d_in, nbc, rpc, k, br, 1, dtype, fuse_gelu, device,
                    stream, false);
}

// Kernel 4, the same arguments and col_chunk >= 1, the output block-columns
// one block sweeps; the br x d_in panel plus two padded tiles must fit a
// block's shared memory, or it returns cudaErrorInvalidValue.
extern "C" int spgemm_bsmm_resident(const void* x, const void* rows, const void* tiles,
                                    void* out, long long M, int d_in, int nbc, int rpc, int k,
                                    int br, int col_chunk, int dtype, int fuse_gelu, int device,
                                    void* stream) {
  return launch_any(x, rows, tiles, out, M, d_in, nbc, rpc, k, br, col_chunk, dtype, fuse_gelu,
                    device, stream, true);
}
