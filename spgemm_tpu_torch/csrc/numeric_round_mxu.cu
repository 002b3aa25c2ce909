// Field-mode numeric round of the block-sparse chain product, by byte limbs
// on the int8 tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel spgemm_tpu/ops/pallas_mxu.py:numeric_round_mxu_pallas
// (with its epilogue, _piece_sums and fold_piece_sums).  For every output key
// and every element (i, n) of its k x k tile:
//
//   out = sum over p in 0..P-1 (skipping sentinel slots), j in 0..k-1 of
//         A[pa[key, p]][i, j] * B[pb[key, p]][j, n]
//
// in clean arithmetic mod 2^64 - 1 ("field mode"), as the canonical residue
// (2^64 - 1 collapses to 0).  Field mode is associative, so any exact
// summation order and any limb split give the same bits; it equals the
// reference's wrap-then-mod fold wherever the hybrid router's proof
// (safe_exact_bound) holds.  A slot whose pa is a's sentinel or whose pb is
// b's sentinel (the planner's all-zero padding tile, the last of each slab)
// is skipped, which on a zero sentinel is exactly adding its zero product;
// the plain version (ops/mxu_spgemm.numeric_round_mxu_ref) skips the same
// slots, so the two agree on any slab.
//
// Method: every u64 value splits into its 8 little-endian bytes, A into
// a_bytes of them and B into b_bytes, where the caller guarantees values
// below 2^(8 * bytes) (ops/mxu_spgemm.bytes_for_limbs7 of the router's 7-bit
// limb counts).  Byte planes multiply on the int8 tensor cores (mma.sync
// m16n8k32 u8 x u8 -> s32).  A product of bytes la and lb weighs
// 2^(8(la + lb)), and 2^(8d) is 2^(8(d mod 8)) mod 2^64 - 1 (2^64 == 1), so
// the products of one rotation class r = (la + lb) mod 8 accumulate in one
// s32 fragment: at most 8 byte pairs fall in a class, so one 32-j step adds
// at most 8 * 32 * 255^2 < 2^24 to an entry, and folding every
// kFlushSteps = 64 steps (at most 128 would do) keeps the fragments exact
// and below 2^31.  A fold multiplies class r by 2^(8r) mod 2^64 - 1, a 64-bit
// rotation, and adds it into a u64 residue with an end-around carry.  (The
// TPU kernel split values into 7-bit limbs because its products ran in
// bf16; 8 bytes instead of 10 limbs take 64 limb products per u64 MAC
// instead of 100.)
//
// Rounds must keep P * k <= 2^17, the TPU kernel's int32-accumulator limit,
// which the wrapper and the hybrid router enforce the same way (the folds
// above would allow more, and the field folds of csrc/field_fold.cu, which
// share this body, take any P).
//
// What bounds it: operations, a_bytes * b_bytes * k^3 int8 MACs per real tile
// pair on the tensor cores, against the tile bytes; the byte split and the
// folds are the overhead beside them.  mma.sync reaches a fraction of the
// card's int8 rate (wgmma is the way to the rest; PERF.md has the numbers),
// and the kernel gains most from keeping more blocks on an SM, so that one
// block's copy and split overlap another's products.
//
// Design:
//   * one block of 8 warps per output key; the k x k tile goes in regions of
//     32 x 32 (one for k <= 32), each warp owning a 16 x 8 block of the
//     region and one s32 fragment per rotation class (8 at 8 x 8 bytes, so 32
//     registers);
//   * the block walks its key's real slots only; a key with none writes its
//     zero tile without loading anything.  One block holds one key, so the
//     test is uniform across the block;
//   * the unit of work is one (region, pair, 32-j step): 32 x 32 u64 of A and
//     of B, staged raw with cp.async (16-byte copies where k is even and the
//     slabs 16-byte aligned, else 8; zeros past the ragged edge of k) into one
//     of two buffers, rows padded to 34 u64.  The next unit is copied while
//     this one is split and multiplied: a barrier publishes the raw stage,
//     the split writes the planes, a second barrier publishes them;
//   * the split: a u64 held little-endian already is its 8 byte limbs, so
//     four values of one row (four j's) become the 8 plane words a fragment
//     register wants by two 4 x 4 byte transposes, 16 byte permutes (prmt).
//     Each thread splits four j's of one A row and of one B column per unit,
//     into planes [l][row][j] for A and [l][n][j] for B (B transposed), rows
//     padded to 48 bytes so the ldmatrix reads and the split's stores hit
//     distinct banks.  A word's four bytes are the j's 2q, 2q + 1, 2q + 16,
//     2q + 17, the same for A and B, so the split reads 16-byte runs;
//   * byte counts compile in as templates over {1, 2, 3, 5, 8}: a count
//     between two of them runs at the next one up with the planes past it
//     zero, so the result is the byte split's whatever the template;
//   * one set of planes and 256 threads at most 80 registers each, so three
//     keys share an SM at 8 x 8 bytes (58 KB of shared memory a block), four
//     at 3 x 3 and below (at most 64 registers);
//   * tile offsets are computed in 64 bits.
// Left for a later PR: wgmma (a key's region is 32 rows, wgmma takes 64) with
// TMA-fed tiles, and loading an A tile once for the keys of one output row.
// The device code (staging, byte split, mma.sync classes, fold and the walk)
// is in limb_fold.cuh, which csrc/field_fold.cu instantiates too; this file
// runs it with the (K, P) row walk and the store epilogue.
// Measured and not kept (PERF.md): a persistent grid whose pipeline runs on
// across keys, producer and consumer warps on named barriers with up to
// eight raw stages, an 8 x 8 path that skips the split by byte-permuting raw
// B values per rotation class, copies issued two units ahead, and B
// fragments built from the raw stage.

#include "limb_fold.cuh"

namespace {

constexpr int kMaxPairDepth = 1 << 17;  // P * k

struct Launch {
  const void* a;
  const void* b;
  const void* pa;
  const void* pb;
  void* out;
  long long K;
  int P, k, a_bytes, b_bytes, a_sent, b_sent;
  bool vec;
  cudaStream_t stream;
};

template <int LA, int LB>
int launch(const Launch& x) {
  return limb_fold_launch<LA, LB>(x.a, x.b, x.pa, x.pb, RowWalk{x.P}, StoreTile{(u64*)x.out},
                                  x.K, x.k, x.a_bytes, x.b_bytes, x.a_sent, x.b_sent, x.vec,
                                  x.stream);
}

// info[0] threads, info[1] dynamic shared memory per block in bytes, info[2]
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <int LA, int LB>
int geometry(int* info) {
  cudaError_t err = limb_fold_opt_in<LA, LB, RowWalk, StoreTile>();
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, limb_fold_fn<LA, LB, RowWalk, StoreTile>(), kThreads, smem_bytes(LA, LB));
  info[0] = kThreads;
  info[1] = (int)smem_bytes(LA, LB);
  info[2] = blocks;
  return (int)err;
}

// The template byte count that runs a count of n: the next of 1, 2, 3, 5, 8.
int byte_class(int n) { return n <= 3 ? n : (n <= 5 ? 5 : 8); }

// Calls F<LA, LB>::run(args...) at the byte classes of a_bytes, b_bytes.
template <template <int, int> class F, int LA, typename... Args>
int dispatch_b(int b_bytes, Args... args) {
  switch (byte_class(b_bytes)) {
    case 1: return F<LA, 1>::run(args...);
    case 2: return F<LA, 2>::run(args...);
    case 3: return F<LA, 3>::run(args...);
    case 5: return F<LA, 5>::run(args...);
    default: return F<LA, 8>::run(args...);
  }
}

template <template <int, int> class F, typename... Args>
int dispatch(int a_bytes, int b_bytes, Args... args) {
  switch (byte_class(a_bytes)) {
    case 1: return dispatch_b<F, 1>(b_bytes, args...);
    case 2: return dispatch_b<F, 2>(b_bytes, args...);
    case 3: return dispatch_b<F, 3>(b_bytes, args...);
    case 5: return dispatch_b<F, 5>(b_bytes, args...);
    default: return dispatch_b<F, 8>(b_bytes, args...);
  }
}

template <int LA, int LB>
struct LaunchF {
  static int run(const Launch& x) { return launch<LA, LB>(x); }
};

template <int LA, int LB>
struct GeometryF {
  static int run(int* info) { return geometry<LA, LB>(info); }
};

}  // namespace

// Launch one field-mode round on `stream` (a cudaStream_t) of device `device`.
//   a, b             : (na, k, k) and (nb, k, k) u64 slabs;
//   pa, pb           : (K, P) int32 slab indices, every entry in range;
//   a_bytes, b_bytes : byte limbs per operand, 1..8, every value below
//                      2^(8 * bytes);
//   a_sent, b_sent   : the sentinel indices (na - 1, nb - 1 for the
//                      planner's slabs); a slot holding either is skipped;
//   out              : (K, k, k) u64 residues mod 2^64 - 1, written whole.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_numeric_round_mxu(const void* a, const void* b, const void* pa,
                                        const void* pb, void* out, long long K, int P,
                                        int k, int a_bytes, int b_bytes, int a_sent, int b_sent,
                                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K <= 0) return (int)cudaSuccess;
  if (K > 0x7fffffffLL || k < 1 || k > kMaxK || P < 0 || (long long)P * k > kMaxPairDepth ||
      a_bytes < 1 || a_bytes > kMaxBytes || b_bytes < 1 || b_bytes > kMaxBytes)
    return (int)cudaErrorInvalidValue;
  const bool vec = limb_fold_vec(k, a, b);
  const Launch x{a, b, pa, pb, out, K, P, k, a_bytes, b_bytes, a_sent, b_sent, vec,
                 (cudaStream_t)stream};
  return dispatch<LaunchF>(a_bytes, b_bytes, x);
}

// The launch geometry of the instance that runs a_bytes x b_bytes on
// `device` (the same at every k): info[0] threads per block, info[1] dynamic
// shared memory per block in bytes, info[2] blocks per SM.  Returns a CUDA
// error code (0 = success).
extern "C" int spgemm_numeric_round_mxu_geometry(int a_bytes, int b_bytes, int device,
                                                 int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (a_bytes < 1 || a_bytes > kMaxBytes || b_bytes < 1 || b_bytes > kMaxBytes)
    return (int)cudaErrorInvalidValue;
  return dispatch<GeometryF>(a_bytes, b_bytes, info);
}
