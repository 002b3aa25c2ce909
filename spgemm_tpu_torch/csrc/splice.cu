// Delta splice of the block-sparse chain product, for Hopper (sm_90a).
//
// Replaces the JAX package's jitted XLA splice,
// spgemm_tpu/ops/spgemm.py:_splice_impl:
//
//   out = prev.at[idx].set(sub[take])
//
// over (n, k, k) u64 slabs: the delta path (ops/spgemm._delta_execute)
// re-folds only the dirty output keys into `sub` and puts them into the
// retained previous result.  The previous result was handed to the caller
// as the last multiply's answer, so this kernel never writes it: it builds
// a new slab in one pass, driven by a per-row source map the wrapper makes
// from (idx, take) (ops/cuda_splice.source_map):
//
//   out[r] = src[r] >= 0 ? sub[src[r]] : prev[r]      for r in 0..n-1
//
// Pad slots of the JAX scatter write the sub result's zero row onto the
// sentinel row, which is zero in prev too, so the map leaves that row to
// prev.
//
// What bounds it: bytes.  Every output row is read once (from prev or sub)
// and written once, 2 * n * k * k * 8 bytes plus the 8-byte map entry per
// row, against 3.35e12 B/s; there is no arithmetic.  The design: a
// grid-stride loop over 16-byte vectors (two u64) of the flattened output,
// consecutive threads on consecutive addresses, so loads and stores are
// coalesced at any k; the map entry of a row is read by every thread of it
// and served from L1.  8-byte elements where a row is not a whole number of
// 16-byte vectors (odd k * k) or a pointer is not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void splice_kernel(const V* __restrict__ prev, const V* __restrict__ sub,
                              const int64_t* __restrict__ src, V* __restrict__ out,
                              long long n_rows, long long row_vecs) {
  const long long total = n_rows * row_vecs;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < total; v += stride) {
    const long long row = v / row_vecs;
    const long long s = src[row];
    out[v] = s >= 0 ? sub[s * row_vecs + (v - row * row_vecs)] : prev[v];
  }
}

}  // namespace

// One splice on `stream` (a cudaStream_t) of device `device`.
//   prev, out : (n_rows, row_elems) u64, out a separate allocation;
//   sub       : (n_sub, row_elems) u64, every src entry >= 0 below n_sub;
//   src       : (n_rows,) int64 source map, -1 = keep prev's row.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_delta_splice(const void* prev, const void* sub, const void* src, void* out,
                                   long long n_rows, long long row_elems, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_rows <= 0 || row_elems <= 0) return (int)cudaSuccess;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = row_elems % 2 == 0 && (uintptr_t)prev % 16 == 0 &&
                   (uintptr_t)sub % 16 == 0 && (uintptr_t)out % 16 == 0;
  const long long row_vecs = vec ? row_elems / 2 : row_elems;
  const int threads = 256;
  const long long want = (n_rows * row_vecs + threads - 1) / threads;
  const long long cap = (long long)sms * 16;  // 16 blocks of 256 threads fill an SM
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  if (vec) {
    splice_kernel<longlong2><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const longlong2*)prev, (const longlong2*)sub, (const int64_t*)src, (longlong2*)out,
        n_rows, row_vecs);
  } else {
    splice_kernel<long long><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)prev, (const long long*)sub, (const int64_t*)src, (long long*)out,
        n_rows, row_vecs);
  }
  return (int)cudaGetLastError();
}
