// The throughput ceiling of the int8 mma.sync that kernel 2
// (spgemm_tpu_torch/csrc/numeric_round_mxu.cu) issues: m16n8k32 u8 x u8 ->
// s32, eight independent accumulators a warp, 256 threads a block, one to
// three blocks per SM on every SM.  Prints TOPS and SM clocks per mma (at
// the data sheet's 1.98 GHz), the yardstick beside the card's dense int8
// peak for what an mma.sync kernel can reach.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_sync_ceiling \
//        tools/mma_sync_ceiling.cu && build/mma_sync_ceiling

#include <cuda_runtime.h>
#include <stdio.h>

typedef unsigned int u32;

__device__ __forceinline__ void mma_u8(int (&acc)[4], const u32 (&a)[4], u32 b0, u32 b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kAcc = 8;

__global__ void __launch_bounds__(256, 3) bench(int iters, int* out) {
  int acc[kAcc][4] = {};
  const u32 a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const u32 b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int r = 0; r < kAcc; ++r) mma_u8(acc[r], a, b0, b1);
  }
  int s = 0;
#pragma unroll
  for (int r = 0; r < kAcc; ++r) s += acc[r][0] + acc[r][1] + acc[r][2] + acc[r][3];
  if (s == 12345) out[0] = s;  // keeps the products live
}

int main() {
  int* out = nullptr;
  int sms = 0;
  if (cudaMalloc(&out, sizeof(int)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) != cudaSuccess) {
    fprintf(stderr, "no CUDA device\n");
    return 1;
  }
  const int iters = 20000;
  for (int per_sm = 1; per_sm <= 3; ++per_sm) {
    cudaEvent_t start, end;
    cudaEventCreate(&start);
    cudaEventCreate(&end);
    bench<<<sms * per_sm, 256>>>(10, out);  // warm-up
    cudaEventRecord(start);
    bench<<<sms * per_sm, 256>>>(iters, out);
    cudaEventRecord(end);
    if (cudaEventSynchronize(end) != cudaSuccess) {
      fprintf(stderr, "launch failed: %s\n", cudaGetErrorString(cudaGetLastError()));
      return 1;
    }
    float ms = 0;
    cudaEventElapsedTime(&ms, start, end);
    const double mmas = (double)sms * per_sm * 8 * iters * kAcc;  // 8 warps a block
    const double tops = mmas * 16 * 8 * 32 * 2 / (ms * 1e-3) / 1e12;
    printf("blocks/SM %d: %.3f ms, %.1f TOPS int8, %.3f SM clocks per mma at 1.98 GHz\n", per_sm,
           ms, tops, ms * 1e-3 * 1.98e9 / (mmas / sms));
  }
  return 0;
}
