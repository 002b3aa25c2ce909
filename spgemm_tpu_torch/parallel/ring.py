"""Ring SpGEMM: B's tile slab cut into n contiguous slabs that rotate one hop
a step around the positions of a device list, output keys range-sharded so
each position folds its slab of C (the port's copy of the JAX package's
`parallel/ring.py`).

After n steps every position has seen all of B while holding one slab of it
(two buffers, see below) and its key range's accumulator.  Arithmetic: field
mode, clean mod-(2^64 - 1) (ops/u64.py): the rotation visits each key's
pairs grouped by slab, not in the reference's j-ascending order, so only an
associative fold is right here; the bytes are the field-mode oracle's
(utils/semantics.field_spgemm_oracle) at any n.  Use parallel/rowshard.py
where the reference's bytes are needed.

It runs in one process over a list of torch devices, as parallel/rowshard.py
does: position d holds devices[d], and a device may repeat (`["cpu"] * n` in
the tests, `[cuda:0] * n` on one card).  The schedule (plan_ring,
RANK_UNROLL_MAX) is the JAX package's, copied in numpy with the same
arrays.  The kernel does not take those arrays as they are: ring_cells
gathers each (position, slab) list's pairs from the rank lists and the
deep-cell tail into one CSR (RingCells), every pair of a cell together and
no padding.  Each step, each position folds its (position, slab) list with
one launch of the F3 kernel (ops/cuda_field.field_fold_scatter) into its
accumulator, so a multiply launches F3 at most n^2 times; a list without
cells launches nothing.  On the CPU the wrapper runs its plain version.

The hop is a tensor copy of the slab into the next position's spare buffer
(the JAX package's ppermute).  Each position holds its slab in two buffers,
so a hop never writes the buffer a fold reads.  SPGEMM_TPU_RING_OVERLAP=1
(the default) issues the hop for step t + 1 before the folds of step t, on
the side streams of the sending and the receiving device, which first wait
for the folds of step t - 1 (the last readers of the buffer it writes); the
folds of step t + 1 wait on the hop's event.  SPGEMM_TPU_RING_OVERLAP=0 folds first and
hops after.  Both give the same bits: each slab's fold is unchanged, only
the copy's issue point moves.  The last step has no hop: nothing reads it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from spgemm_tpu_torch.chain import _to_host
from spgemm_tpu_torch.ops import cuda_field, u64
from spgemm_tpu_torch.ops.spgemm import _upload, pack_tiles
from spgemm_tpu_torch.ops.symbolic import JoinResult, symbolic_join
from spgemm_tpu_torch.parallel.mesh import resolve_devices
from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE


def overlap_enabled() -> bool:
    """SPGEMM_TPU_RING_OVERLAP=0|1 (default 1): issue each hop before the
    folds it runs beside (1) or after them (0).  Bit-identical either way."""
    return knobs.get("SPGEMM_TPU_RING_OVERLAP")


# the JAX package's bound on its unrolled step body: cells deeper than this
# many pairs spill their remainder into ONE dense (cell, pair) tail trip.
# plan_ring keeps it so that its arrays stay the JAX ones; the port's fold
# takes the CSR that ring_cells builds from them, whatever the depth
RANK_UNROLL_MAX = 8


def plan_ring(join: JoinResult, nnzb_b: int, n_dev: int,
              mass_balance: bool | None = None):
    """Host-side schedule: key chunks per device, RANK-COMPACTED pair lists
    per (device, slab) step.

    mass_balance (None = the SPGEMM_TPU_PLAN_ESTIMATE estimator family
    knob, whose default is 0 in the port and 1 in the JAX package): assign
    each device's contiguous key range by cumulative PAIR MASS -- the
    per-key MAC count the estimator's row_mass predicts, exact here since
    the join has landed -- instead of raw key count.  Equal
    key-count ranges under power-law skew hand one device the deep keys
    and pad every other device up to its step shapes (the residual ~1.45x
    padded-MAC skew of the rank-compacted schedule); mass-balanced bounds
    attack exactly that.  Field-mode addition is an abelian group op and
    every key still folds whole on one device, so the split point cannot
    change bits -- the knob is a pure load-balance A/B.

    Pairs land in (key, slab) cells (slab = which contiguous B chunk owns the
    pair's B tile).  A power-law structure makes almost every cell hold ONE
    pair (webbase config: 2812 of 2885 occupied cells), so a dense per-cell
    pair axis pads nearly everything: the old (cell, p_max) layout carried
    4.2x the real MAC work on that config.  Instead the schedule is sliced by
    pair RANK: list r holds the r-th pair of every cell.  Within one rank each
    cell appears at most once, so rows are unique and the fold can scatter-add
    straight into the device accumulator -- and the padded MAC count collapses
    to sum_r max_over_(dev,slab)(cells with >= r+1 pairs) ~= 1.1-1.5x real.
    (Field-mode addition is an abelian group op, so folding a cell's pairs as
    r scatter-adds instead of one pre-reduced tile is bit-identical.)

    Cells deeper than RANK_UNROLL_MAX pairs spill ranks >= RANK_UNROLL_MAX
    into the dense TAIL block (the old (cell, p_max) layout restricted to
    deep cells): rank lists bound the launches a step, the tail bounds the
    pathological depth.

    Returns (key_chunks, slab_bounds, ranks, tail, s_max, k_max):
      key_chunks  : list of n index arrays into join.keys (device d's keys)
      slab_bounds : (n+1,) B tile-slab boundaries (contiguous equal splits)
      ranks       : list over pair rank r < RANK_UNROLL_MAX of
                    (row_idx, pa, pb), each (n, n, C_r) int32
                    [device, slab, compacted cell]:
                    row_idx = local ACC row (padding rows point at the dummy
                    accumulator row == k_max), pa = A-slab indices (sentinel
                    -1), pb = *within-slab* B indices (sentinel == s_max,
                    the slab zero tile)
      tail        : None, or (row_idx, pa, pb) with pa/pb (n, n, C_t, P_t)
                    holding every deep cell's pairs at ranks >=
                    RANK_UNROLL_MAX (same sentinels; rows unique per step)
      s_max       : max slab size
      k_max       : max local key count == the dummy accumulator row baked
                    into row_idx (single-sourced here; the fold's
                    accumulator MUST be allocated k_max + 1 rows)
    """
    if mass_balance is None:
        mass_balance = knobs.get("SPGEMM_TPU_PLAN_ESTIMATE")
    n_keys = join.num_keys
    slab_bounds = np.array([(i * nnzb_b) // n_dev for i in range(n_dev + 1)],
                           dtype=np.int64)
    slab_sizes = np.diff(slab_bounds)
    s_max = int(slab_sizes.max()) if n_dev > 0 else 0

    # contiguous key ranges (keys are sorted by (row, col), so these are
    # row-range slabs of C): equal-count legacy split, or mass-balanced --
    # boundary d lands where the cumulative pair mass crosses d/n of the
    # total, so each device folds ~the same MAC count even when the key
    # fanout distribution is power-law
    if mass_balance and n_keys > 0:
        cum = np.concatenate(([0], np.cumsum(join.fanouts, dtype=np.int64)))
        targets = np.arange(1, n_dev, dtype=np.int64) * cum[-1] // n_dev
        interior = np.searchsorted(cum, targets, side="left").astype(np.int64)
        key_bounds = np.concatenate(
            ([0], np.maximum.accumulate(interior), [n_keys]))
    else:
        key_bounds = np.array([(d * n_keys) // n_dev
                               for d in range(n_dev + 1)], dtype=np.int64)
    key_chunks = [np.arange(key_bounds[d], key_bounds[d + 1])
                  for d in range(n_dev)]
    k_max = max(1, int(np.diff(key_bounds).max()))

    # Pairs -> (key, slab) cells via one stable sort (preserves the original
    # j-ascending order within each cell; order inside a cell is what the
    # field-mode fold contract leaves free, but keep it deterministic).
    pair_ptr = np.asarray(join.pair_ptr, dtype=np.int64)
    key_of_pair = np.repeat(np.arange(n_keys, dtype=np.int64),
                            np.diff(pair_ptr))
    # slab of each pair = which contiguous B chunk owns its B tile index
    slab_of_pair = np.searchsorted(slab_bounds, join.pair_b, side="right") - 1

    cell = key_of_pair * n_dev + slab_of_pair
    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    if cell.size:
        uc, uc_first, uc_counts = np.unique(cell_sorted, return_index=True,
                                            return_counts=True)
    else:
        uc = np.zeros(0, np.int64)
        uc_first = uc_counts = np.zeros(0, np.int64)
    p_max = max(1, int(uc_counts.max())) if uc.size else 1
    # rank of each sorted pair within its cell = position - cell start
    ci_of_pair = np.repeat(np.arange(len(uc), dtype=np.int64), uc_counts)
    pos = np.arange(cell.size, dtype=np.int64) - uc_first[ci_of_pair]

    # cell -> (device, slab, local acc row)
    cell_key = uc // n_dev
    cell_slab = (uc % n_dev).astype(np.int64)
    cell_dev = np.searchsorted(key_bounds, cell_key, side="right") - 1
    cell_local = (cell_key - key_bounds[cell_dev]).astype(np.int32)
    grp = cell_dev * n_dev + cell_slab

    pair_a_sorted = np.asarray(join.pair_a)[order]
    pair_b_sorted = np.asarray(join.pair_b)[order]

    def grp_slots(ci):
        """Compact a set of cells (indices into uc) within their (device,
        slab) groups: returns (slot of each cell in its group, max group
        size)."""
        grp_c = grp[ci]
        counts = np.bincount(grp_c, minlength=n_dev * n_dev)
        c_max = max(1, int(counts.max())) if ci.size else 1
        order_c = np.argsort(grp_c, kind="stable")
        offsets = np.concatenate(([0], np.cumsum(counts)))
        slots = np.empty(len(ci), np.int64)
        slots[order_c] = (np.arange(len(ci), dtype=np.int64)
                          - offsets[grp_c[order_c]])
        return slots, c_max

    ranks = []
    for r in range(min(p_max, RANK_UNROLL_MAX)):
        sel = pos == r            # at most one pair per cell at each rank
        ci = ci_of_pair[sel]
        slots, c_r = grp_slots(ci)
        row_idx = np.full((n_dev, n_dev, c_r), k_max, dtype=np.int32)  # dummy
        pa = np.full((n_dev, n_dev, c_r), -1, dtype=np.int32)
        pb = np.full((n_dev, n_dev, c_r), s_max, dtype=np.int32)
        d_i, s_i = cell_dev[ci], cell_slab[ci]
        row_idx[d_i, s_i, slots] = cell_local[ci]
        pa[d_i, s_i, slots] = pair_a_sorted[sel]
        pb[d_i, s_i, slots] = pair_b_sorted[sel] - slab_bounds[s_i]
        ranks.append((row_idx, pa, pb))

    tail = None
    if p_max > RANK_UNROLL_MAX:
        ci_deep = np.flatnonzero(uc_counts > RANK_UNROLL_MAX)
        slots_deep, c_t = grp_slots(ci_deep)
        p_t = p_max - RANK_UNROLL_MAX
        row_idx = np.full((n_dev, n_dev, c_t), k_max, dtype=np.int32)
        pa = np.full((n_dev, n_dev, c_t, p_t), -1, dtype=np.int32)
        pb = np.full((n_dev, n_dev, c_t, p_t), s_max, dtype=np.int32)
        d_i, s_i = cell_dev[ci_deep], cell_slab[ci_deep]
        row_idx[d_i, s_i, slots_deep] = cell_local[ci_deep]
        slot_of_cell = np.full(len(uc), -1, np.int64)
        slot_of_cell[ci_deep] = slots_deep
        selp = pos >= RANK_UNROLL_MAX     # the deep cells' spilled pairs
        cip = ci_of_pair[selp]
        pa[cell_dev[cip], cell_slab[cip], slot_of_cell[cip],
           pos[selp] - RANK_UNROLL_MAX] = pair_a_sorted[selp]
        pb[cell_dev[cip], cell_slab[cip], slot_of_cell[cip],
           pos[selp] - RANK_UNROLL_MAX] = (
            pair_b_sorted[selp] - slab_bounds[cell_slab[cip]])
        tail = (row_idx, pa, pb)
    return key_chunks, slab_bounds, ranks, tail, s_max, k_max


@dataclass(frozen=True)
class RingCells:
    """The ring's (position, slab) lists of cells in CSR form, for the F3
    kernel: one list a (position d, slab s) group g = d * n + s.

      group_ptr : (n * n + 1,) int64; group g's cells are
                  group_ptr[g] : group_ptr[g + 1]
      rows      : (C,) int32, each cell's local accumulator row; unique
                  within a group, never the dummy row
      cell_ptr  : (C + 1,) int64; cell c's pairs are cell_ptr[c] :
                  cell_ptr[c + 1] of pa and pb, in plan_ring's pair order
      pa, pb    : (N,) int32 A tile indices and within-slab B indices,
                  every pair real (no sentinel)
    """

    n: int
    group_ptr: np.ndarray
    rows: np.ndarray
    cell_ptr: np.ndarray
    pa: np.ndarray
    pb: np.ndarray

    def arrays(self) -> list:
        return [self.group_ptr, self.rows, self.cell_ptr, self.pa, self.pb]

    def position(self, d: int):
        """Position d's lists: (rows, cell_ptr, pa, pb) with cell_ptr
        rebased to the position's own pa and pb, and the (n + 1,) bounds of
        its slabs' cells within them."""
        g0 = self.group_ptr[d * self.n: (d + 1) * self.n + 1]
        c0, c1 = int(g0[0]), int(g0[-1])
        p0, p1 = int(self.cell_ptr[c0]), int(self.cell_ptr[c1])
        return (self.rows[c0:c1], self.cell_ptr[c0: c1 + 1] - p0, self.pa[p0:p1],
                self.pb[p0:p1], g0 - c0)


def ring_cells(ranks: list, tail, n_dev: int, k_max: int) -> RingCells:
    """plan_ring's rank lists and tail as RingCells: every real pair, sorted
    by (position, slab, row) and within a cell by rank (rank list r gives
    rank r of each cell it holds, the tail ranks RANK_UNROLL_MAX and up, in
    slot order).  A padding cell (row k_max) or slot (pa < 0) is dropped."""
    parts = []
    for row_idx, pa, pb in ranks:
        d, s, c = np.nonzero(row_idx != k_max)
        parts.append((d * n_dev + s, row_idx[d, s, c], pa[d, s, c], pb[d, s, c]))
    if tail is not None:
        row_idx, pa, pb = tail
        d, s, c, p = np.nonzero(pa >= 0)
        parts.append((d * n_dev + s, row_idx[d, s, c], pa[d, s, c, p], pb[d, s, c, p]))
    grp, rows, pa, pb = (np.concatenate(x) for x in zip(*parts))  # plan_ring gives a rank list
    # the parts come in rank order, so a stable sort on the cell keeps it
    cell = grp * (k_max + 1) + rows
    order = np.argsort(cell, kind="stable")
    cell, rows, pa, pb = cell[order], rows[order], pa[order], pb[order]
    first = np.flatnonzero(np.diff(cell, prepend=-1))
    cell_ptr = np.append(first, len(cell)).astype(np.int64)
    group_ptr = np.searchsorted(cell[first] // (k_max + 1),
                                np.arange(n_dev * n_dev + 1)).astype(np.int64)
    return RingCells(n=n_dev, group_ptr=group_ptr, rows=rows[first].astype(np.int32),
                     cell_ptr=cell_ptr, pa=pa.astype(np.int32), pb=pb.astype(np.int32))


# one-hop probe times, keyed by (devices, small, slab buffer shape): the first
# spgemm_ring call of a key pays the probe, later ones record its figure
_HOP_PROBE_CACHE: dict = {}


def _sync(devs) -> None:
    """Wait for every distinct card of devs (nothing to wait for on the CPU)."""
    for d in dict.fromkeys(devs):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _hop(bufs: list, cur: int, devs: list, side: dict) -> list:
    """One hop: position d's current slab bufs[d][cur] copied into position
    d + 1's spare buffer.  On a card the copy is queued with the side
    streams of both the sending and the receiving device current: PyTorch
    runs a copy between two cards on the source's current stream and makes
    the destination's current stream wait for it, so with both side streams
    current the folds queued on either device's main stream never wait for
    a hop.  Each side stream first waits for its device's main stream (the
    folds that last read the spare buffer, and the wait on the hop that
    filled the source).  Returns, per receiving position, the event its
    folds wait on (None on the CPU, where the copy is done on return)."""
    n = len(devs)
    events = [None] * n
    for d in range(n):
        p = (d + 1) % n
        dst, src, dev = bufs[p][1 - cur], bufs[d][cur], devs[p]
        stream = side.get(dev)
        if stream is None:
            dst.copy_(src)
            continue
        send = side.get(devs[d])
        stream.wait_stream(torch.cuda.current_stream(dev))
        if send is not None and send is not stream:
            send.wait_stream(torch.cuda.current_stream(devs[d]))
        with torch.cuda.stream(send), torch.cuda.stream(stream):
            dst.copy_(src, non_blocking=True)
        events[p] = stream.record_event()
    return events


def spgemm_ring(a, b, *, devices=None, plan=None, **_ignored) -> BlockSparseMatrix:
    """C = A x B with B's slabs rotating around `devices` (field mode).

    a, b: host BlockSparseMatrix or DeviceBlockMatrix (fetched first; a
    device matrix's value bound decides the small route without a
    reduction).  devices: torch devices or their names, one position each
    (default: every visible card).  plan: an ops/symbolic.SpgemmPlan of this
    operand pair, whose join is reused and whose memoized ring_schedule is
    the schedule; without one the join is built here, as in the JAX
    package.  Other keywords a chain passes (device, backend, folds,
    round_size) are ignored.  Returns a host matrix that keeps all-zero
    tiles.

    ENGINE: `ring_plan` (the schedule), `upload` (A to each distinct device,
    each position's B slab and cell lists), `ring_fold` (the n steps' launches
    and hops queued), `assembly` (the accumulators fetched to the host
    result, which waits for the kernels), `ring_hop` (one hop timed alone,
    once per device list, small and slab shape in this process, then
    recorded on every call; SPGEMM_TPU_RING_HOP_PROBE=0 skips it) and the
    counter `ring_steps` (+n)."""
    overlap = overlap_enabled()  # validate the knob before any work
    small = u64.operands_below_2_32(a, b)
    a, b = _to_host(a), _to_host(b)
    if a.k != b.k:
        raise ValueError(f"tile size mismatch: {a.k} vs {b.k}")
    k = a.k
    devs = resolve_devices(devices)
    n = len(devs)
    if plan is not None:
        plan.check_operands(a, b)
        join = plan.ensure_exact().join  # land a deferred estimated plan
    else:
        join = symbolic_join(a.coords, b.coords)
    if join.num_keys == 0:
        return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k)

    with ENGINE.phase("ring_plan"):
        if plan is not None:
            key_chunks, slab_bounds, _, _, s_max, k_max = plan.ring_schedule(b.nnzb, n)
            cells = plan.ring_cells(b.nnzb, n)
        else:
            key_chunks, slab_bounds, ranks, tail, s_max, k_max = plan_ring(join, b.nnzb, n)
            cells = ring_cells(ranks, tail, n, k_max)

    with ENGINE.phase("upload"):
        a_host = pack_tiles(a, "cpu")
        a_slabs = {d: a_host.to(d) for d in dict.fromkeys(devs)}
        # position d starts with slab d: (s_max + 1, k, k), zero tile at s_max
        b_host = pack_tiles(b, "cpu")
        bufs, pos_lists, accs = [], [], []
        for d, dev in enumerate(devs):
            lo, hi = slab_bounds[d], slab_bounds[d + 1]
            slab = torch.zeros((s_max + 1, k, k), dtype=torch.int64)
            slab[: hi - lo] = b_host[lo:hi]
            slab = slab.to(dev)
            bufs.append([slab, torch.empty_like(slab)])
            *arrays, bounds = cells.position(d)
            rows, cell_ptr, pa, pb = (_upload(np.ascontiguousarray(x), dev) for x in arrays)
            # slab s's list: its cells' rows and cell_ptr, the position's pairs
            pos_lists.append([(rows[c0:c1], cell_ptr[c0: c1 + 1], pa, pb) if c1 > c0 else None
                              for c0, c1 in zip(bounds[:-1].tolist(), bounds[1:].tolist())])
            accs.append(torch.zeros((k_max + 1, k, k), dtype=torch.int64, device=dev))

    if knobs.get("SPGEMM_TPU_RING_HOP_PROBE"):
        probe_key = (tuple(devs), small, tuple(bufs[0][0].shape))
        if probe_key not in _HOP_PROBE_CACHE:
            _sync(devs)
            t0 = time.perf_counter()
            _hop(bufs, 0, devs, {})  # the spare buffers are written again below
            _sync(devs)
            _HOP_PROBE_CACHE[probe_key] = time.perf_counter() - t0
        ENGINE.record("ring_hop", _HOP_PROBE_CACHE[probe_key])

    side = {d: torch.cuda.Stream(device=d) for d in dict.fromkeys(devs) if d.type == "cuda"}
    with ENGINE.phase("ring_fold"):
        cur, events = 0, [None] * n
        for t in range(n):
            for d, ev in enumerate(events):
                if ev is not None:
                    torch.cuda.current_stream(devs[d]).wait_event(ev)
            hop = t < n - 1  # the last step's slabs are read by no one
            if overlap and hop:
                events = _hop(bufs, cur, devs, side)
            for d in range(n):
                lists = pos_lists[d][(d - t) % n]  # the slab position d holds at step t
                if lists is not None:
                    cuda_field.field_fold_scatter(accs[d], a_slabs[devs[d]], bufs[d][cur],
                                                  *lists, small=small)
            if hop and not overlap:
                events = _hop(bufs, cur, devs, side)
            if hop:
                cur = 1 - cur
    ENGINE.incr("ring_steps", n)

    with ENGINE.phase("assembly"):
        out = np.empty((join.num_keys, k, k), dtype=np.uint64)
        for d, chunk in enumerate(key_chunks):
            out[chunk] = u64.t_to_u64(accs[d][: len(chunk)])
    return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k, coords=join.keys, tiles=out)
