"""Symbolic phase on the host: output-structure join + round bucketing (the
port's copy of the JAX package's `ops/symbolic.py`).

The join is a sorted merge-join over the (already sorted) block-coordinate
arrays -- O(nnzb + pairs), no hashing; in C++ (native/symbolic.cpp), with a
numpy plain version -- and "packing" is index arithmetic: the numeric kernel
reads tiles on the device by index, so no staging copy exists.  Rounds are
fixed-shape (K, P) index arrays padded with a sentinel index that points at
an all-zero tile (mulmod(0, x) == 0 and addmod(acc, 0) == acc, so padding is
exact).

Ordering contract (SURVEY.md section 2.9): each output key's pair list is
ordered by ascending inner block-coordinate j, the order the reference's
sorted-map traversal produces.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field

import numpy as np

from spgemm_tpu_torch.obs import events
from spgemm_tpu_torch.utils import failpoints, knobs, native


@dataclass
class JoinResult:
    """Output structure of A x B, in CSR-over-sorted-keys form.

    keys     : (num_keys, 2) int64, sorted lexicographically -- output tile coords.
    pair_ptr : (num_keys + 1,) int64 -- segment boundaries into pair_a/pair_b.
    pair_a   : (total_pairs,) int32 -- A tile slab indices, per key j-ascending.
    pair_b   : (total_pairs,) int32 -- B tile slab indices, aligned with pair_a.
    """

    keys: np.ndarray
    pair_ptr: np.ndarray
    pair_a: np.ndarray
    pair_b: np.ndarray

    @property
    def num_keys(self) -> int:
        return len(self.keys)

    @functools.cached_property
    def fanouts(self) -> np.ndarray:
        """Per-key pair counts."""
        return np.diff(self.pair_ptr)


def _segment_expand(counts: np.ndarray):
    """Ragged expansion: for segments of the given lengths, return
    (segment_id, within_segment_offset) arrays of total length counts.sum()."""
    # spgemm-lint: fld-proof(integer segment-length total for sizing only; exact int64 addition is order-free, no wrap-then-mod values involved)
    total = int(counts.sum())
    seg_id = np.repeat(np.arange(len(counts), dtype=np.int64), counts)
    seg_start = np.concatenate(([0], np.cumsum(counts)[:-1]))
    offs = np.arange(total, dtype=np.int64) - np.repeat(seg_start, counts)
    return seg_id, offs


def symbolic_join(a_coords: np.ndarray, b_coords: np.ndarray) -> JoinResult:
    """Structure join: which (A-tile, B-tile) pairs feed which output tile.

    Both coord arrays must be lexicographically sorted by (row, col) -- the
    BlockSparseMatrix invariant.

    Runs the native join (native/symbolic.cpp through utils/native.py) where
    its fused uint64 key row * span + col cannot wrap, as the JAX package's
    join does (its `native_safe`); the numpy join, symbolic_join_plain,
    elsewhere and under SPGEMM_TPU_NO_NATIVE=1.  The two give the same
    arrays (tests hold them equal)."""
    native_safe = (
        len(a_coords) == 0 or len(b_coords) == 0
        or (int(a_coords[:, 0].max()) + 1) * (int(b_coords[:, 1].max()) + 1) <= 1 << 64)
    if native_safe and native.enabled():
        keys, pair_ptr, pair_a, pair_b = native.symbolic_join_native(a_coords, b_coords)
        return JoinResult(keys=keys, pair_ptr=pair_ptr, pair_a=pair_a, pair_b=pair_b)
    return symbolic_join_plain(a_coords, b_coords)


def symbolic_join_plain(a_coords: np.ndarray, b_coords: np.ndarray) -> JoinResult:
    """The numpy join: searchsorted ranges, then a stable sort by output key
    (a fused uint64 key where it fits, a stable lexsort past it)."""
    empty = JoinResult(
        keys=np.zeros((0, 2), np.int64),
        pair_ptr=np.zeros(1, np.int64),
        pair_a=np.zeros(0, np.int32),
        pair_b=np.zeros(0, np.int32),
    )
    if len(a_coords) == 0 or len(b_coords) == 0:
        return empty

    # For each A block (i, j): B blocks with row == j form the contiguous
    # range [lo, hi) in the sorted B slab.
    b_rows = b_coords[:, 0]
    a_cols = a_coords[:, 1]
    lo = np.searchsorted(b_rows, a_cols, side="left")
    hi = np.searchsorted(b_rows, a_cols, side="right")
    counts = hi - lo
    # spgemm-lint: fld-proof(integer pair-count total for sizing only; exact int64 addition is order-free, no wrap-then-mod values involved)
    total = int(counts.sum())
    if total == 0:
        return empty

    # Pair stream in A-traversal order (sorted (i, j)), each A block
    # contributing its B row-range in ascending-c order.
    a_slot, offs = _segment_expand(counts)
    b_slot = np.repeat(lo, counts) + offs

    out_r = a_coords[a_slot, 0]
    out_c = b_coords[b_slot, 1]

    # Stable sort by output key: within a key the stream order is ascending
    # inner coordinate j, which stability preserves.  One fused uint64 key
    # takes numpy's radix path; past uint64's range, a stable lexsort.
    span = int(b_coords[:, 1].max()) + 1
    max_row = int(a_coords[:, 0].max())
    if (max_row + 1) * span <= 1 << 64:
        fused = out_r.astype(np.uint64) * np.uint64(span) + out_c.astype(np.uint64)
        order = np.argsort(fused, kind="stable")
        fused = fused[order]
        a_slot, b_slot = a_slot[order], b_slot[order]
        key_change = np.empty(total, dtype=bool)
        key_change[0] = True
        key_change[1:] = fused[1:] != fused[:-1]
        key_starts = np.flatnonzero(key_change)
        keys = np.stack(
            [(fused[key_starts] // np.uint64(span)).astype(np.int64),
             (fused[key_starts] % np.uint64(span)).astype(np.int64)], axis=1)
    else:
        order = np.lexsort((out_c, out_r))  # stable, last key primary
        r_s, c_s = out_r[order], out_c[order]
        a_slot, b_slot = a_slot[order], b_slot[order]
        key_change = np.empty(total, dtype=bool)
        key_change[0] = True
        key_change[1:] = (r_s[1:] != r_s[:-1]) | (c_s[1:] != c_s[:-1])
        key_starts = np.flatnonzero(key_change)
        keys = np.stack([r_s[key_starts], c_s[key_starts]], axis=1)
    pair_ptr = np.append(key_starts, total).astype(np.int64)

    return JoinResult(keys=keys, pair_ptr=pair_ptr,
                      pair_a=a_slot.astype(np.int32), pair_b=b_slot.astype(np.int32))


def slice_join(join: JoinResult, keep: np.ndarray) -> tuple[JoinResult, np.ndarray]:
    """The sub-join of the keys the boolean mask `keep` selects, each kept
    key's pair list copied whole and in order (the JAX package's
    slice_join).  The delta path's exactness rests on it: a kept key folds
    the same tiles in the same j-ascending order under the sub-plan as
    under the full plan.  Returns (sub_join, kept_key_indices), the
    indices mapping the sub-join's keys back into the full key list."""
    kept = np.flatnonzero(keep)
    lens = join.fanouts[kept]
    ptr = np.zeros(len(kept) + 1, np.int64)
    np.cumsum(lens, out=ptr[1:])
    _, offs = _segment_expand(lens)
    src = np.repeat(join.pair_ptr[kept], lens) + offs
    return JoinResult(keys=join.keys[kept], pair_ptr=ptr, pair_a=join.pair_a[src],
                      pair_b=join.pair_b[src]), kept


@dataclass
class Round:
    """One numeric launch: up to key_cap keys of one fanout class, in one of
    two layouts (SPGEMM_TPU_ACCUM_ROUTE):

      ladder (route 'ladder'): pa/pb are (K_pad, P), each key's pair list
        sentinel-padded to the class width P (kernel 1);
      dense (route 'dense'): pa/pb are (L,), the chunk's pair lists
        concatenated in key order and sentinel-padded to the stream ladder
        (_stream_pad); seg gives each slot its output row (pad slots the
        scratch row n_rows) and row_ptr each row's slots, [row_ptr[r],
        row_ptr[r + 1]) (the segmented-fold kernel).

    Both fold each output row's pairs in the same j-ascending order, so
    they give the same bits.  An 'auto' round keeps the ladder layout and
    carries its dense twin in dense_alt; execute picks one per round."""

    key_index: np.ndarray  # (n,) int64 -- positions into JoinResult.keys
    pa: np.ndarray         # ladder: (K_pad, P) int32; dense: (L,) int32
    pb: np.ndarray         # same shape as pa
    max_fanout: int = 0    # real (unpadded) max fanout among the round's keys
                           # -- what the hybrid proof reads (sentinel pairs add 0)
    route: str = "ladder"  # 'ladder' | 'dense'
    seg: np.ndarray | None = None      # dense: (L,) int32 output row per slot
    row_ptr: np.ndarray | None = None  # dense: (n_rows + 1,) int64 row offsets
    n_rows: int = 0        # dense: output rows, the ladder twin's K_pad
    real_pairs: int = 0    # unpadded pair count
    dense_alt: "Round | None" = None   # auto: the dense twin

    @property
    def out_rows(self) -> int:
        """Output rows this round's launch produces (padded key count), the
        same for both layouts."""
        return self.pa.shape[0] if self.pa.ndim == 2 else self.n_rows

    @property
    def shipped_macs(self) -> int:
        """Pair slots shipped to the kernel, padding included."""
        return int(self.pa.size)

    def padded_mac_ratio(self) -> float:
        """Shipped over real pair slots (>= 1): the ladder layout's ratio on
        an auto round, the stream's on a dense one."""
        return self.shipped_macs / self.real_pairs if self.real_pairs else 1.0

    def arrays(self) -> list:
        """Every index array of the round and of its twin."""
        out = [x for x in (self.key_index, self.pa, self.pb, self.seg, self.row_ptr)
               if x is not None]
        return out + (self.dense_alt.arrays()[1:] if self.dense_alt is not None else [])


def _floor_pow2(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def _ladder_floor(x: int) -> int:
    """Largest pow2-or-3/4-pow2 ladder value <= x."""
    p = _floor_pow2(x)
    c = 3 * p // 2  # = 3/4 of the next pow2 rung
    return c if p >= 2 and c <= x else p


def _shape_class_vec(f: np.ndarray) -> np.ndarray:
    """Round up to {1, 2, 3, 4, 6, 8, 12, 16, ...}: pow2 plus 3/4-pow2,
    which caps padding waste at 25%.  np.log2 of an exact power of two is
    exact in f64, so the ceil is safe."""
    p = 1 << np.ceil(np.log2(np.maximum(f, 1))).astype(np.int64)
    c34 = (3 * p) // 4
    return np.where((p >= 4) & (f <= c34), c34, p)


def _shape_class(x: int) -> int:
    return int(_shape_class_vec(np.array([x]))[0])


# The accumulator routes (SPGEMM_TPU_ACCUM_ROUTE), and the smallest fanout
# class that the auto route gives a dense twin (the JAX package's): below it
# the ladder's padding is at most a third of its slots.
ROUTES = ("auto", "ladder", "dense")
DENSE_MIN_CLASS = 256


def _stream_pad(n: int) -> int:
    """Smallest m * 2^e >= n with m in 8..15 and e >= 3: the dense stream's
    length (the JAX package's ladder, waste under 1/8 past 64 pairs; every
    rung a multiple of 8)."""
    n = max(int(n), 1)
    if n <= 8:
        return 8
    e = max((n - 1).bit_length() - 4, 3)
    return -(-n // (1 << e)) << e


def _dense_round(join: JoinResult, chunk: np.ndarray, lens: np.ndarray, rows: np.ndarray,
                 src: np.ndarray, n_rows: int, a_sentinel: int, b_sentinel: int) -> Round:
    """The dense layout of one class chunk: its pair lists in key order
    (rows/src as the ladder scatter uses them), sentinel-padded to
    _stream_pad, pad slots on the scratch row n_rows.  seg is
    non-decreasing over the real slots, so each row's slots are one run
    and row_ptr is a searchsorted over them."""
    real = len(src)
    L = _stream_pad(real)
    spa = np.full(L, a_sentinel, np.int32)
    spb = np.full(L, b_sentinel, np.int32)
    seg = np.full(L, n_rows, np.int32)
    spa[:real] = join.pair_a[src]
    spb[:real] = join.pair_b[src]
    seg[:real] = rows
    row_ptr = np.searchsorted(seg[:real], np.arange(n_rows + 1)).astype(np.int64)
    return Round(key_index=chunk, pa=spa, pb=spb, max_fanout=int(lens.max()), route="dense",
                 seg=seg, row_ptr=row_ptr, n_rows=n_rows, real_pairs=real)


def assembly_permutation(rounds: list[Round], num_keys: int) -> np.ndarray:
    """Inverse permutation for the assembly gather.

    inv[key] = row of that key in the padded concatenation of the rounds'
    outputs; the extra last entry maps the sentinel slot to a zero row
    appended after the concatenation, so the assembly is one gather."""
    total = sum(r.out_rows for r in rounds)
    inv = np.full(num_keys + 1, total, np.int64)
    off = 0
    for r in rounds:
        inv[r.key_index] = off + np.arange(len(r.key_index))
        off += r.out_rows
    return inv


def stack_round_indices(idx: np.ndarray, sentinel: int, jobs: int) -> np.ndarray:
    """One round's index array stacked for a `jobs`-wide cross-job launch
    (the JAX package's function of the same name; ops/spgemm.stack_on_card
    computes the same on the device for execute_batched).  The jobs' operand slabs are concatenated tiles only -- job j's
    tile t lands at j * sentinel + t -- with ONE shared zero tile appended
    at jobs * sentinel.  So job j's copy shifts every real index by
    j * sentinel and maps the per-job sentinel onto the shared one: a
    uniform offset would alias job j's sentinel onto job j + 1's tile 0
    (wrong bits).  The shared zero tile is the stacked slab's last row, the
    slot kernel 1 and kernel 2 skip.

    (K, P) stacks to (jobs, K, P), an already stacked (R, K, P) to
    (jobs * R, K, P).  The kernels and their plain versions flatten every
    leading axis into the key axis (cuda_spgemm.numeric_round), so the JAX
    package's accept_round_stack has no counterpart here: each key keeps
    its own pair list and fold order, and the stacked launch gives each
    job its solo bits."""
    base = idx[None] if idx.ndim == 2 else idx
    copies = [np.where(base == sentinel, jobs * sentinel, base + j * sentinel)
              for j in range(jobs)]
    return np.concatenate(copies, axis=0).astype(idx.dtype)


@dataclass
class SpgemmPlan:
    """Everything the host decides about one C = A x B before device work:
    the structure join, the rounds and the assembly permutation.  Valid for
    any operand pair with the planned block structures; check_operands
    refuses any other pair before an out-of-bounds read can happen.

    key_cap: the most keys one round holds (ops/spgemm.plan's launch cap or
    round_size); a sub-plan rebuilds its rounds under the same cap and route.
    fingerprint: the plan-cache key the plan was stored under, None when the
    cache was off (ops/spgemm's delta path needs one).
    estimate / plan_route: the sampled estimate that steered the plan
    (ops/estimate) and 'estimated' (exact join deferred) or 'exact'.
    join, rounds and take are None on a deferred plan until ensure_exact()
    builds them; every consumer calls it first."""

    k: int
    join: JoinResult | None
    rounds: list[Round] | None
    take: np.ndarray | None  # assembly permutation
    a_coords: np.ndarray
    b_coords: np.ndarray
    backend: str = "exact"            # exact | mxu | hybrid (ops/spgemm.BACKENDS)
    route: str = "ladder"             # accumulator route the rounds were planned on
    split_fanout: int | None = None   # hybrid proof partition threshold
    key_cap: int = 8192
    fingerprint: str | None = None
    estimate: object | None = None    # ops/estimate.StructureEstimate
    plan_route: str = "exact"
    # fills join/rounds/take in place on a deferred plan; dropped once run
    _exact_builder: object | None = field(default=None, repr=False)
    _frozen: bool = field(default=False, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    # rowshard_rounds' schedules, by round size
    _rowshard: dict = field(default_factory=dict, repr=False)
    # ring_schedule's schedules and their ring_cells, by (B's nnzb, positions,
    # mass balance)
    _ring: dict = field(default_factory=dict, repr=False)

    def _arrays(self) -> list:
        arrays = [self.a_coords, self.b_coords]
        if self.join is not None:
            arrays += [self.join.keys, self.join.pair_ptr, self.join.pair_a,
                       self.join.pair_b, self.join.fanouts, self.take]
            for r in self.rounds:
                arrays += r.arrays()
        return arrays

    def freeze(self) -> "SpgemmPlan":
        """Make the plan's arrays read-only before the plan cache shares it:
        one plan then serves several multiplies, and a result's coords
        alias its join.keys.  The operand coords are copied first, so the
        caller's own arrays stay writable.  A deferred plan freezes the
        arrays ensure_exact adds when it adds them."""
        with self._lock:
            self.a_coords, self.b_coords = np.array(self.a_coords), np.array(self.b_coords)
            self._frozen = True
            for x in self._arrays():
                x.flags.writeable = False
        return self

    @property
    def is_deferred(self) -> bool:
        """True while the exact join has not been built (estimated route)."""
        with self._lock:
            return self._exact_builder is not None

    def ensure_exact(self) -> "SpgemmPlan":
        """Build a deferred plan's join, rounds and permutation in place and
        return self; a no-op on a plan built inline.  Under the plan's lock,
        so two threads that force one cached plan build it once, and a
        frozen plan's new arrays are frozen before any other thread sees
        them.  A build emits `plan_exact_landed` (the thread that paid for
        it rides along)."""
        with self._lock:
            if self._exact_builder is None:
                return self
            failpoints.check("plan.ensure_exact")
            self._exact_builder(self)
            self._exact_builder = None
            if self._frozen:
                for x in self._arrays():
                    x.flags.writeable = False
        events.emit("plan_exact_landed", thread=threading.current_thread().name,
                    fingerprint=(self.fingerprint or "")[:16] or None)
        return self

    def rowshard_rounds(self, round_size: int | None = None) -> list[Round]:
        """The ladder rounds of this plan's join for parallel/rowshard,
        memoized per round size: at most round_size keys a round, within
        the card's launch cap (ops/spgemm.launch_key_cap, also the default:
        the JAX package's 512 is its own TPU budget).  Always ladder, since
        kernel 1 takes (K, P) index arrays; no bit depends on the chunking.
        A ladder plan with no proof split, at the same cap, has these rounds
        already (ops/spgemm.plan(route="ladder"), parallel/rowshard's
        default plan): they are reused.  A frozen plan's schedule is frozen
        too."""
        from spgemm_tpu_torch.ops.spgemm import launch_key_cap  # noqa: PLC0415 -- a cycle

        cap = launch_key_cap(self.k)
        rs = cap if round_size is None else min(round_size, cap)
        join = self.ensure_exact().join
        with self._lock:
            if rs not in self._rowshard and self.route == "ladder" \
                    and self.split_fanout is None and rs == self.key_cap:
                self._rowshard[rs] = self.rounds
            if rs not in self._rowshard:
                rounds = plan_rounds(join, a_sentinel=len(self.a_coords),
                                     b_sentinel=len(self.b_coords), key_cap=rs, route="ladder")
                if self._frozen:
                    for r in rounds:
                        for x in r.arrays():
                            x.flags.writeable = False
                self._rowshard[rs] = rounds
            return self._rowshard[rs]

    def ring_schedule(self, nnzb_b: int, n_dev: int):
        """parallel/ring.plan_ring over this plan's join, memoized.  The
        resolved mass-balance flag (SPGEMM_TPU_PLAN_ESTIMATE) is part of the
        key, so an in-process A/B that flips it is never served the other
        leg's schedule.  A frozen plan's schedule is frozen too."""
        return self._ring_entry(nnzb_b, n_dev)[0]

    def ring_cells(self, nnzb_b: int, n_dev: int):
        """parallel/ring.ring_cells of ring_schedule(nnzb_b, n_dev): the F3
        kernel's CSR, memoized with the schedule (and frozen with it)."""
        return self._ring_entry(nnzb_b, n_dev)[1]

    def _ring_entry(self, nnzb_b: int, n_dev: int) -> tuple:
        from spgemm_tpu_torch.parallel.ring import plan_ring, ring_cells  # noqa: PLC0415 -- a cycle

        mb = bool(knobs.get("SPGEMM_TPU_PLAN_ESTIMATE"))
        key = (nnzb_b, n_dev, mb)
        join = self.ensure_exact().join
        with self._lock:
            if key not in self._ring:
                sched = plan_ring(join, nnzb_b, n_dev, mass_balance=mb)
                key_chunks, slab_bounds, ranks, tail, _, k_max = sched
                cells = ring_cells(ranks, tail, n_dev, k_max)
                if self._frozen:
                    for x in [*key_chunks, slab_bounds, *(y for trip in ranks for y in trip),
                              *(tail or ()), *cells.arrays()]:
                        x.flags.writeable = False
                self._ring[key] = (sched, cells)
            return self._ring[key]

    def check_operands(self, a, b) -> None:
        """Refuse to drive a mismatched operand pair: the pa/pb indices
        were built from the planned block structures."""
        if (a.k, b.k) != (self.k, self.k):
            raise ValueError(
                f"plan built for k={self.k}, operands have k={a.k}/{b.k}")
        if not (np.array_equal(a.coords, self.a_coords)
                and np.array_equal(b.coords, self.b_coords)):
            raise ValueError(
                "plan built for a different block structure: operand coords "
                "do not match the coords this plan was planned from")


def plan_rounds(join: JoinResult, a_sentinel: int, b_sentinel: int,
                key_cap: int = 8192, split_fanout: int | None = None,
                route: str | None = None) -> list[Round]:
    """Bucket output keys by fanout class; one round per class, chopped at
    key_cap keys.

    split_fanout: if set, each class's keys are partitioned into fanout <=
    split_fanout and > split_fanout before chopping -- the hybrid router's
    exactness proof is a fanout threshold, so routing stays per key while
    each (class, kernel) part is still one launch.

    route: the accumulator route (None reads SPGEMM_TPU_ACCUM_ROUTE).
    'ladder' pads the pair axis to the class width P (3/4-pow-2 ladder) and
    the key axis of each chunk to the same ladder, capped at the chunk cap
    (key_cap floored onto the ladder); 'dense' ships each chunk as one pair
    stream (_dense_round) with the ladder's row count; 'auto' plans ladder
    and gives chunks of class >= DENSE_MIN_CLASS their dense twin.  The
    choice reads the exact join's fanouts, never an estimate.  Keys are
    disjoint across rounds and each key's fold order lives inside its own
    pair list, so any chunking and any route is bit-exact.  The default
    key_cap is the JAX package's round-batched ceiling; ops/spgemm.py passes
    the card's own cap."""
    if route is None:
        route = knobs.get("SPGEMM_TPU_ACCUM_ROUTE")
    if route not in ROUTES:
        raise ValueError(f"unknown accumulator route {route!r}")
    if key_cap < 1:
        raise ValueError(f"key_cap must be >= 1, got {key_cap}")
    rounds: list[Round] = []
    if join.num_keys == 0:
        return rounds
    fan = join.fanouts
    classes = _shape_class_vec(fan)
    chunk_cap = max(1, _ladder_floor(key_cap))
    for cls in np.unique(classes):
        members_all = np.flatnonzero(classes == cls)
        P = int(cls)
        parts = [members_all]
        if split_fanout is not None:
            f = fan[members_all]
            parts = [part for part in (members_all[f <= split_fanout],
                                       members_all[f > split_fanout]) if len(part)]
        for members in parts:
            for start in range(0, len(members), chunk_cap):
                chunk = members[start : start + chunk_cap]
                K_pad = min(_shape_class(len(chunk)), chunk_cap)
                lens = fan[chunk]
                rows, cols = _segment_expand(lens)
                src = np.repeat(join.pair_ptr[chunk], lens) + cols
                if route == "dense":
                    rounds.append(_dense_round(join, chunk, lens, rows, src, K_pad,
                                               a_sentinel, b_sentinel))
                    continue
                pa = np.full((K_pad, P), a_sentinel, dtype=np.int32)
                pb = np.full((K_pad, P), b_sentinel, dtype=np.int32)
                # scatter each key's pair list into its row
                pa[rows, cols] = join.pair_a[src]
                pb[rows, cols] = join.pair_b[src]
                rnd = Round(key_index=chunk, pa=pa, pb=pb, max_fanout=int(lens.max()),
                            real_pairs=len(src))
                if route == "auto" and P >= DENSE_MIN_CLASS:
                    rnd.dense_alt = _dense_round(join, chunk, lens, rows, src, K_pad,
                                                 a_sentinel, b_sentinel)
                rounds.append(rnd)
    return rounds


# ------------------------------------------------------ plan <-> arrays codec --
# The port's own flat-array plan encoding (ops/warmstore's plan tier).  Its
# plans carry key_cap and not the JAX package's batch flag, so a file of
# either package is never the other's: the payload names its format, and a
# mismatch of format or version raises.
# v2: the accumulator route (the plan's route; each round's layout, row
# count, real pair count, seg and row_ptr, and the auto route's dense twin),
# after the JAX package's v2 layout.
PLAN_CODEC_FORMAT = "spgemm_tpu_torch"
PLAN_CODEC_VERSION = 2

_SCALAR_FIELDS = ("k", "key_cap", "split_fanout", "num_rounds")


def plan_to_arrays(plan: SpgemmPlan) -> dict | None:
    """An exact plan as a dict of numpy arrays (npz-ready): the join, every
    round's index arrays (and its twin's), the assembly permutation and the
    operand coords, so a reloaded plan replays the same folds.  None for a
    deferred plan."""
    if plan.is_deferred:
        return None
    out = {
        "codec_format": np.array(PLAN_CODEC_FORMAT),
        "codec": np.int64(PLAN_CODEC_VERSION),
        "backend": np.array(plan.backend),
        "route": np.array(plan.route),
        "scalars": np.array([plan.k, plan.key_cap,
                             -1 if plan.split_fanout is None else plan.split_fanout,
                             len(plan.rounds)], np.int64),
        "join_keys": plan.join.keys, "join_pair_ptr": plan.join.pair_ptr,
        "join_pair_a": plan.join.pair_a, "join_pair_b": plan.join.pair_b,
        "take": plan.take, "a_coords": plan.a_coords, "b_coords": plan.b_coords,
        "round_max_fanout": np.array([r.max_fanout for r in plan.rounds], np.int64),
    }
    for i, r in enumerate(plan.rounds):
        out[f"r{i}_key_index"], out[f"r{i}_pa"], out[f"r{i}_pb"] = r.key_index, r.pa, r.pb
        out[f"r{i}_route"] = np.array([int(r.route == "dense"), r.n_rows, r.real_pairs,
                                       int(r.dense_alt is not None)], np.int64)
        dense = r if r.route == "dense" else r.dense_alt
        if dense is not None:
            prefix = f"r{i}_" if dense is r else f"r{i}_alt_"
            if dense is not r:
                out[f"{prefix}pa"], out[f"{prefix}pb"] = dense.pa, dense.pb
                out[f"{prefix}meta"] = np.array([dense.n_rows, dense.real_pairs], np.int64)
            out[f"{prefix}seg"], out[f"{prefix}row_ptr"] = dense.seg, dense.row_ptr
    return out


def _dense_from(d, prefix: str, key_index, max_fanout: int, n_rows: int,
                real_pairs: int) -> Round:
    rnd = Round(key_index=key_index, pa=np.asarray(d[f"{prefix}pa"], np.int32),
                pb=np.asarray(d[f"{prefix}pb"], np.int32), max_fanout=max_fanout,
                route="dense", seg=np.asarray(d[f"{prefix}seg"], np.int32),
                row_ptr=np.asarray(d[f"{prefix}row_ptr"], np.int64), n_rows=n_rows,
                real_pairs=real_pairs)
    if (rnd.pa.ndim != 1 or rnd.pb.shape != rnd.pa.shape or rnd.seg.shape != rnd.pa.shape
            or rnd.row_ptr.shape != (n_rows + 1,)):
        raise ValueError("malformed dense-round stream arrays")
    return rnd


def plan_from_arrays(d, fingerprint: str | None = None) -> SpgemmPlan:
    """The plan plan_to_arrays encoded (from the dict or a loaded npz).
    Raises ValueError on another format or version and KeyError or
    ValueError on a missing or malformed field; the warm store counts
    either as a cold miss."""
    fmt = str(d["codec_format"]) if "codec_format" in d else None
    version = int(d["codec"])
    if fmt != PLAN_CODEC_FORMAT or version != PLAN_CODEC_VERSION:
        raise ValueError(f"plan codec {fmt!r} v{version}, expected "
                         f"{PLAN_CODEC_FORMAT!r} v{PLAN_CODEC_VERSION}")
    s = dict(zip(_SCALAR_FIELDS, (int(v) for v in np.asarray(d["scalars"]))))
    join = JoinResult(keys=np.asarray(d["join_keys"], np.int64),
                      pair_ptr=np.asarray(d["join_pair_ptr"], np.int64),
                      pair_a=np.asarray(d["join_pair_a"], np.int32),
                      pair_b=np.asarray(d["join_pair_b"], np.int32))
    max_fan = np.asarray(d["round_max_fanout"], np.int64)
    if len(max_fan) != s["num_rounds"] or len(join.pair_ptr) != join.num_keys + 1:
        raise ValueError("plan arrays do not match their header")
    rounds = []
    for i in range(s["num_rounds"]):
        is_dense, n_rows, real_pairs, has_alt = (int(v) for v in np.asarray(d[f"r{i}_route"]))
        key_index = np.asarray(d[f"r{i}_key_index"], np.int64)
        if is_dense:
            rnd = _dense_from(d, f"r{i}_", key_index, int(max_fan[i]), n_rows, real_pairs)
        else:
            rnd = Round(key_index=key_index, pa=np.asarray(d[f"r{i}_pa"], np.int32),
                        pb=np.asarray(d[f"r{i}_pb"], np.int32), max_fanout=int(max_fan[i]),
                        real_pairs=real_pairs)
        if has_alt:
            alt_rows, alt_real = (int(v) for v in np.asarray(d[f"r{i}_alt_meta"]))
            rnd.dense_alt = _dense_from(d, f"r{i}_alt_", key_index, int(max_fan[i]),
                                        alt_rows, alt_real)
        rounds.append(rnd)
    take = np.asarray(d["take"], np.int64)
    if len(take) != join.num_keys + 1:
        raise ValueError("assembly permutation does not match the join")
    return SpgemmPlan(k=s["k"], join=join, rounds=rounds, take=take,
                      a_coords=np.asarray(d["a_coords"], np.int64).reshape(-1, 2),
                      b_coords=np.asarray(d["b_coords"], np.int64).reshape(-1, 2),
                      backend=str(d["backend"]), route=str(d["route"]),
                      split_fanout=None if s["split_fanout"] < 0 else s["split_fanout"],
                      key_cap=s["key_cap"], fingerprint=fingerprint)
