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
//     _ring_fold_jitted, fold_slab: a (position, slab) list of cells, each
//     of one or more pairs, folded as F1 folds a key and added under field
//     addition into the accumulator rows rows[c];
//   * field_add (F2): u64.addmod_field over (K, k, k), the step of
//     innershard.py:butterfly_allreduce_modadd and of the ordered gather fold
//     in _make_sharded_fold.  NCCL has no mod-(2^64 - 1) reduction, so the
//     exchange is a copy to the partner's device and this kernel.
//
// Arithmetic, per element (i, n) of a cell's tile: the sum over the cell's
// pairs p, skipping sentinel slots, and j in 0..k-1 of A[pa[p]][i, j] *
// B[pb[p]][j, n] mod 2^64 - 1, as the canonical residue (2^64 - 1 reads 0),
// the JAX bytes.  A slot whose pa is a_sent or whose pb is b_sent (each
// slab's zero tile, its last index) adds nothing and is skipped.
//
// Design: F1 and F3 are kernel 2's body (limb_fold.cuh; the method is at the
// top of numeric_round_mxu.cu): each u64 split into its bytes, the byte
// planes multiplied on the int8 tensor cores (mma.sync m16n8k32) into one
// s32 fragment per rotation class, folded into a u64 residue every 64 units
// and at a region's end.  Field mode is exact and associative, so its bits
// are the plain fold's.  One block of 256 threads a key (F1) or a cell (F3).
//   * F1 walks fixed-width (K, P) rows and stores each tile.  The full route
//     runs 8 x 8 bytes; SMALL (every value below 2^32) runs 4 x 4, an
//     instance kernel 2 does not have (its byte set is {1, 2, 3, 5, 8}).
//     The fragments are flushed every 64 units, so P has no limit;
//   * F3 walks variable-length cells, cell_ptr (C + 1) into flat pa and pb,
//     and adds each tile into acc[rows[c]].  The ring's (position, slab)
//     list holds every pair of each of its cells, and a (key, slab) cell
//     appears once a slab, so the rows of one launch are unique and the adds
//     never race: one launch a ring step and position;
//   * k runs to 2048, as kernel 2's does (the wrappers raise above it).
// What bounds F1 and F3: operations, 64 (SMALL: 16) int8 byte products per
// u64 MAC on the tensor cores, 2 ops each, against 1979e12 ops/s, beside the
// tile bytes; the byte split and the folds are overhead beside them, and
// mma.sync reaches a fraction of the int8 rate (PERF.md).
// field_add is bound by bytes: each element read twice and written once, in
// a grid-stride loop of consecutive addresses.

#include "limb_fold.cuh"

namespace {

__global__ void field_add_kernel(u64* __restrict__ x, const u64* __restrict__ y, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < n; v += stride) {
    x[v] = canon_field(add_field(x[v], y[v]));
  }
}

// F1 and F3 at the full (8 x 8 bytes) or the SMALL (4 x 4) instance.
template <class Walk, class Epi>
int launch_fold(const void* a, const void* b, const void* pa, const void* pb, Walk walk,
                Epi epi, long long C, int k, int a_sent, int b_sent, int small, int device,
                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0) return (int)cudaSuccess;
  if (C > 0x7fffffffLL || k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  const bool vec = limb_fold_vec(k, a, b);
  cudaStream_t s = (cudaStream_t)stream;
  if (small) return limb_fold_launch<4, 4>(a, b, pa, pb, walk, epi, C, k, 4, 4, a_sent, b_sent,
                                           vec, s);
  return limb_fold_launch<8, 8>(a, b, pa, pb, walk, epi, C, k, 8, 8, a_sent, b_sent, vec, s);
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
  if (P < 0) return (int)cudaErrorInvalidValue;
  return launch_fold(a, b, pa, pb, RowWalk{P}, StoreTile{(u64*)out}, C, k, a_sent, b_sent,
                     small, device, stream);
}

// F3: cell c's pairs are pa, pb [cell_ptr[c], cell_ptr[c + 1]) (cell_ptr
// (C + 1,) int64, nondecreasing), folded as F1 folds a key, and the tile
// added under field addition into acc[rows[c]] (acc (n_rows, k, k) u64,
// rows (C,) int32, unique).  A cell without a real pair writes nothing.
extern "C" int spgemm_field_fold_scatter(const void* a, const void* b, const void* cell_ptr,
                                         const void* pa, const void* pb, const void* rows,
                                         void* acc, long long C, int k, int a_sent, int b_sent,
                                         int small, int device, void* stream) {
  return launch_fold(a, b, pa, pb, CellWalk{(const int64_t*)cell_ptr},
                     AddTile{(u64*)acc, (const int32_t*)rows}, C, k, a_sent, b_sent, small,
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
  field_add_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((u64*)x, (const u64*)y, n);
  return (int)cudaGetLastError();
}
