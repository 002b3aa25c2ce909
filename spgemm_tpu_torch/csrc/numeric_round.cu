// Exact-fold numeric round of the block-sparse chain product, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel spgemm_tpu/ops/pallas_spgemm.py:numeric_round_pallas
// (mod variant, and its no_mod variant below).  For every output key and
// every element (i, n) of its k x k tile:
//
//   acc = 0
//   for p in 0..P-1:            (the key's pair list, j-ascending, sentinel-padded)
//     if pa[key, p] is a's sentinel or pb[key, p] is b's sentinel: skip
//     for j in 0..k-1:
//       acc = addmod(acc, mulmod(A[pa[key, p]][i, j], B[pb[key, p]][j, n]))
//
// with the reference's wrap-then-mod steps (SURVEY.md section 2.9):
// mulmod(a, b) = (a*b mod 2^64) == 2^64-1 ? 0 : a*b mod 2^64, and addmod
// likewise.  addmod is not associative, so each element folds strictly in
// this order.  The TPU kernel splits u64 into (hi, lo) uint32 planes only
// because the TPU has no 64-bit integers; here the fold is native
// `unsigned long long`.
//
// Skipping a sentinel slot is exact: the sentinel is the all-zero tile the
// planner appends to each slab (the last index), acc is always canonical
// (never 2^64-1), so addmod(acc, mulmod(0, x)) == acc, and in no_mod
// acc + 0 == acc.  The plain version (ops/cuda_spgemm.numeric_round_ref)
// skips the same slots, so the two agree on any slab.
//
// What bounds it: the integer issue rate, not bytes.  In the sm_90a SASS
// each MAC of the mod variant is four IMADs for the 64-bit multiply-low,
// IADD3 + IMAD.X for the 64-bit add, and ISETP + ISETP.EX + SEL + SEL for
// each of the two compares with all-ones: 9 instructions on the integer pipe
// (64 lanes per SM per clock) beside 5 on the FMA pipe, so the integer pipe
// bounds it.  A key's tile pair is read from device memory once per
// micro-tile pass, so bytes are a small share (PERF.md has the numbers).
//
// no_mod variant (kNoMod, its own entry point below): the same fold with
// both compares with all-ones dropped, acc += a*b in plain wrapping u64
// arithmetic.  It equals the mod fold only where every product and partial
// sum stays below 2^64 - 1, which the hybrid router proves per round
// (safe_exact_bound, spgemm_tpu_torch/ops/mxu_spgemm.py) before it picks
// this variant; it replaces numeric_round_pallas(no_mod=True).  A MAC is
// then three IMADs on the FMA pipe beside one IADD3, so the FMA pipe bounds
// it.  The MAC's instruction sequence is the same in both designs of this
// file, so the bounds in PERF.md still hold.
//
// Design:
//   * a group of threads per output key; each thread owns a TR x TC register
//     micro-tile of the k x k output (rows ri + r*R, columns in pairs
//     2*(ci + c*C) + {0, 1}: a warp's shared loads then fall on distinct
//     banks), each element an independent chain, so a thread has TR*TC
//     chains to overlap and loads TR + TC values per j for TR*TC MACs.  Both
//     variants run 128 threads, one key per block at k = 32: mod on 2x4
//     micro-tiles, no_mod on 4x2 (chosen on the card among 2x2, 2x4, 4x2
//     and 4x4 on 64 to 256 threads, the j loop unrolled 8).  Where a key has
//     fewer micro-tiles than the block has threads (small k), one block
//     folds several keys, one group each; where it has more (large k), the
//     group makes several passes over the key's pairs;
//   * the fold walks a key's real pairs only: a slot whose pa or pb is the
//     sentinel is neither staged nor folded, and a key with no real pair
//     writes its zero tile without loading anything;
//   * each unit of work (a pair, or a chunk of jc columns of it when k > 32)
//     is staged into shared memory with cp.async (16-byte copies where k is
//     even and the slabs aligned, else 8) into one of two buffers while the
//     unit before it folds from the other, with one block barrier per unit;
//     a stage holds at most E u64 of each operand (8 KB, so 34 KB a block at
//     k = 32 and 5 blocks per SM for mod, 4 for no_mod by registers), and
//     every k from 1 to 2048 fits (above 48 KB the launch opts in);
//   * A's staged rows are padded by two elements so that the rows a warp
//     reads fall on different banks; tile offsets are 64-bit.
// At k = 32 the short pair lists of a level-1 multiply (about 5 real pairs a
// key) make no_mod wait on tile traffic (16 KB a pair from L2) more than on
// the FMA pipe.  Left for a later PR: loading an A tile once for the keys of
// one output row, TMA (a tile is one contiguous run, which cp.async serves),
// and a shorter instruction sequence per MAC.
//
// The device code (the MAC, the walk, the staging, the geometry and the
// launch) lives in fold_walk.cuh, which the segmented fold shares; this file
// instantiates it with kSeg false.

#include "fold_walk.cuh"

// Launch one round on `stream` (a cudaStream_t) of device `device`.
//   a, b   : (na, k, k) and (nb, k, k) u64 slabs;
//   pa, pb : (K, P) int32 slab indices, every entry in range;
//   a_sent, b_sent : the sentinel indices (na - 1, nb - 1 for the planner's
//            slabs); a slot holding either is skipped;
//   out    : (K, k, k) u64, written whole.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_numeric_round(const void* a, const void* b, const void* pa,
                                    const void* pb, void* out, long long K, int P, int k,
                                    int a_sent, int b_sent, int device, void* stream) {
  return launch_fold<false, false>(a, b, pa, pb, nullptr, out, K, P, k, a_sent, b_sent, device,
                                   stream);
}

// The no_mod variant, same arguments: exact only under the proof above.
extern "C" int spgemm_numeric_round_nomod(const void* a, const void* b, const void* pa,
                                          const void* pb, void* out, long long K, int P, int k,
                                          int a_sent, int b_sent, int device, void* stream) {
  return launch_fold<true, false>(a, b, pa, pb, nullptr, out, K, P, k, a_sent, b_sent, device,
                                  stream);
}

// The launch geometry of a variant at k on `device`: info[0] threads per
// block, info[1] keys per block, info[2] dynamic shared memory per block in
// bytes, info[3] blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
// Returns a CUDA error code (0 = success).
extern "C" int spgemm_numeric_round_geometry(int k, int no_mod, int device, int* info) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (k < 1 || k > 2048) return (int)cudaErrorInvalidValue;
  const Geometry g = no_mod ? geometry<true>(k) : geometry<false>(k);
  const void* fn = no_mod ? (const void*)numeric_round_kernel<true>
                          : (const void*)numeric_round_kernel<false>;
  if (g.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (err != cudaSuccess) return (int)err;
  }
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, g.keys * g.group, g.smem);
  info[0] = g.keys * g.group;
  info[1] = g.keys;
  info[2] = (int)g.smem;
  info[3] = blocks;
  return (int)err;
}
