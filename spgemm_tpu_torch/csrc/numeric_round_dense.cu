// Segmented stream fold of the block-sparse chain product (the dense
// accumulator route, SPGEMM_TPU_ACCUM_ROUTE), for Hopper (sm_90a).
//
// Replaces the JAX package's jitted fold spgemm_tpu/ops/spgemm.py:
// numeric_round_dense_impl.  One class chunk's pair lists arrive as one
// stream (pa, pb) in row order, each row's slots one run [row_ptr[r],
// row_ptr[r + 1]) in the row's j-ascending order.  For every output row r
// and element (i, n):
//
//   acc = 0
//   for s in row_ptr[r] .. row_ptr[r + 1] - 1:
//     if pa[s] is a's sentinel or pb[s] is b's sentinel: skip
//     for j in 0..k-1:
//       acc = addmod(acc, mulmod(A[pa[s]][i, j], B[pb[s]][j, n]))
//
// with the wrap-then-mod steps of SURVEY.md section 2.9.  That is the JAX
// function's left-to-right walk of the stream restricted to row r: its other
// rows' slots never touch r's accumulator, and its pad slots (seg == n_rows)
// fold into the scratch row it drops.  A row with no slot comes out zero.
// Skipping a sentinel slot is exact for the reason kernel 1 gives (the
// sentinel tile is zero and acc is canonical).  The wrapper
// (ops/cuda_dense.py) builds row_ptr from any seg by a stable sort, which
// keeps each row's stream order.
//
// What bounds it: the integer issue rate, as kernel 1 -- the same 9
// integer-pipe instructions per u64 MAC, the same real MACs for a round.
// Design: kernel 1's walk (fold_walk.cuh) with kSeg true: a thread group per
// output row walks the row's run of the stream as kernel 1 walks a key's
// pair list, with the same register micro-tiles, cp.async double buffering
// and geometry.  What the stream saves over the ladder on this card is only
// the pad keys' blocks and the sentinel slots' index reads, since kernel 1
// already skips sentinel slots; the measured gate (ops/crossover.dense_wins)
// decides per round shape whether that pays.  The mod fold only: the dense
// route never runs under the no_mod proof.

#include "fold_walk.cuh"

// Launch one dense round on `stream` (a cudaStream_t) of device `device`.
//   a, b    : (na, k, k) and (nb, k, k) u64 slabs;
//   pa, pb  : (L,) int32 slab indices, the entries row_ptr spans in range;
//   row_ptr : (n_rows + 1,) int64, non-decreasing, row_ptr[n_rows] <= L;
//   a_sent, b_sent : the sentinel indices; a slot holding either is skipped;
//   out     : (n_rows, k, k) u64, written whole.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spgemm_numeric_round_dense(const void* a, const void* b, const void* pa,
                                          const void* pb, const void* row_ptr, void* out,
                                          long long n_rows, int k, int a_sent, int b_sent,
                                          int device, void* stream) {
  return launch_fold<false, true>(a, b, pa, pb, row_ptr, out, n_rows, 0, k, a_sent, b_sent,
                                  device, stream);
}
