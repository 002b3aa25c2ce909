"""SpGEMM engine: one C = A x B, tiles staying on the device (the port's
counterpart of the JAX package's `ops/spgemm.py`).

Two phases:

  1. plan (host, ops/symbolic.py): sorted merge-join -> output structure,
     fanout-class rounds of (K, P) pair indices, assembly permutation;
     memoized by operand structure (ops/plancache.py).
  2. execute (device): one numeric launch per round, then one gather that
     puts the round outputs in key order with the sentinel zero tile last.

spgemm_outofcore runs the same rounds with both operands and the result in
host memory, staging each round's tiles to the card through a pipeline.

Backends (BACKENDS), each a choice of numeric kernel per round:

  * exact  -- the reference's wrap-then-mod fold, kernel 1
              (ops/cuda_spgemm.py + csrc/numeric_round.cu), on every round;
  * mxu    -- field mode (clean mod 2^64 - 1) end to end, the limb kernel
              (ops/cuda_mxu.py + csrc/numeric_round_mxu.cu) on every round;
  * hybrid -- per round: the limb kernel where the exactness proof
              (ops/mxu_spgemm.safe_exact_bound at the round's real max
              fanout) holds, P * k <= 2^17 and the speed gate
              (ops/crossover.py) picks it; kernel 1's no_mod variant on
              the other proven rounds; kernel 1's mod variant on unproven
              rounds.  Its result is byte-identical to exact's.  When every
              round of a multiply is proven, the proven output bound
              becomes the result's val_bound and feeds the next multiply's
              proof.

Round budget on the card: the kernels read tiles through the indices and
copy none, so neither of the JAX package's budgets (TPU SMEM for the index
arrays, XLA gather materialization) binds here.  The only cap is on the
output slab of one launch: at most 2^25 int64 elements (256 MiB), so one
launch's output -- and the plain versions' temporaries -- stay a small,
fixed share of device memory whatever the size of the multiply.
"""

from __future__ import annotations

import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from spgemm_tpu_torch.ops import crossover, plancache, u64
from spgemm_tpu_torch.ops.cuda_mxu import limbs_for_bound, numeric_round_mxu
from spgemm_tpu_torch.ops.cuda_spgemm import numeric_round
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix, ensure_device, resolve_device
from spgemm_tpu_torch.ops.mxu_spgemm import MAX_PAIR_DEPTH, safe_exact_bound
from spgemm_tpu_torch.ops.symbolic import (SpgemmPlan, _shape_class, assembly_permutation,
                                           plan_rounds, symbolic_join)
from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE

log = logging.getLogger("spgemm_tpu_torch.spgemm")

LAUNCH_OUT_ELEMENTS = 1 << 25
OOC_ROUND_SIZE = 512  # keys per out-of-core round by default (the JAX package's)
BACKENDS = ("exact", "mxu", "hybrid")
MAX_BOUND = (1 << 64) - 2  # any result is a canonical residue, at most 2^64 - 2

# Rounds dispatched to each kernel, counted per round in execute, beside the
# wrappers' launch counters: "mod" and "no_mod" are kernel 1's variants,
# "mxu" the limb kernel.
rounds_by_kernel = {"mod": 0, "no_mod": 0, "mxu": 0}


@dataclass(frozen=True)
class Folds:
    """The numeric-round functions execute dispatches to: `exact` takes
    (a, b, pa, pb, no_mod=...), `mxu` takes (a, b, pa, pb, a_limbs=...,
    b_limbs=...).  KERNELS are the CUDA kernels' wrappers; chip_smoke.py
    substitutes timed wrappers and the plain PyTorch versions."""

    exact: Callable = numeric_round
    mxu: Callable = numeric_round_mxu


KERNELS = Folds()


def launch_key_cap(k: int) -> int:
    """Most output keys one launch may write (the round budget above)."""
    return max(1, LAUNCH_OUT_ELEMENTS // (k * k))


def pack_tiles(m: BlockSparseMatrix, device) -> torch.Tensor:
    """Tile slab -> (nnzb + 1, k, k) int64 bit-view slab on `device`, with
    the all-zero sentinel tile appended at index nnzb (the padding target
    of the round planner)."""
    tiles = np.concatenate([m.tiles, np.zeros((1, m.k, m.k), np.uint64)])
    return u64.u64_to_t(tiles, resolve_device(device))


def _proof_fanout_cap(a_bound: int, b_bound: int, k: int) -> int | None:
    """Largest fanout at which safe_exact_bound holds for these operand
    bounds (None: every fanout proves).  The planner partitions each fanout
    class at it, so that routing stays per key."""
    denom = a_bound * b_bound * k
    if denom == 0:
        return None  # zero operands: every product is 0, any fanout proves
    cap = ((1 << 64) - 2) // denom
    # safe_exact_bound reads fanout 0 as 1; a cap of 0 still partitions
    # correctly (every key lands in the unproven part)
    return cap if cap < (1 << 63) else None


def _bound(m) -> int:
    """The value bound the hybrid and mxu backends read: a device matrix's
    bound(), a host matrix's exact tile max."""
    if isinstance(m, BlockSparseMatrix):
        return int(m.tiles.max()) if m.nnzb else 0
    return m.bound()


def _freeze(p: SpgemmPlan) -> SpgemmPlan:
    """Make a plan's arrays read-only before the plan cache shares it: one
    plan then serves several multiplies, and a result's coords alias its
    join.keys.  The operand coords are copied first, so the caller's own
    arrays stay writable."""
    p.a_coords, p.b_coords = np.array(p.a_coords), np.array(p.b_coords)
    arrays = [p.join.keys, p.join.pair_ptr, p.join.pair_a, p.join.pair_b, p.join.fanouts,
              p.take, p.a_coords, p.b_coords]
    for r in p.rounds:
        arrays += [r.key_index, r.pa, r.pb]
    for x in arrays:
        x.flags.writeable = False
    return p


def _build_plan(a, b, backend: str, key_cap: int, split: int | None) -> SpgemmPlan:
    join = symbolic_join(a.coords, b.coords)
    rounds = plan_rounds(join, a_sentinel=a.nnzb, b_sentinel=b.nnzb,
                         key_cap=key_cap, split_fanout=split)
    return SpgemmPlan(k=a.k, join=join,
                      rounds=rounds, take=assembly_permutation(rounds, join.num_keys),
                      a_coords=np.asarray(a.coords), b_coords=np.asarray(b.coords),
                      backend=backend, split_fanout=split)


def plan(a, b, *, backend: str = "exact", round_size: int | None = None) -> SpgemmPlan:
    """Host planning half: join + rounds + assembly permutation, timed as
    ENGINE's `plan`, memoized by structure (ops/plancache; hits and misses
    are ENGINE's `plan_cache_hits` and `plan_cache_misses`).  Operands need
    only rows/cols/coords/nnzb/k, and under `hybrid` a value bound for the
    proof split: bound() of a DeviceBlockMatrix, the tile max of a host
    BlockSparseMatrix.  Host-only when those bounds are already resolved
    (chain.py's planner thread relies on it).

    round_size: at most this many keys per launch (the reference's
    small_size), within launch_key_cap(k); None = the card's cap.  Each
    key's fold order lives in its own pair list, so the bytes never depend
    on it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if a.k != b.k:
        raise ValueError(f"tile size mismatch: {a.k} vs {b.k}")
    if round_size is not None and round_size < 1:
        raise ValueError(f"round_size must be >= 1, got {round_size}")
    k = a.k
    key_cap = launch_key_cap(k) if round_size is None else min(round_size, launch_key_cap(k))
    with ENGINE.phase("plan"):
        split = _proof_fanout_cap(_bound(a), _bound(b), k) if backend == "hybrid" else None
        if not plancache.enabled():
            return _build_plan(a, b, backend, key_cap, split)
        # everything the plan depends on, and the operand dims, which it
        # does not: a result must never come back under another shape
        meta = (k, a.nnzb, b.nnzb, backend, key_cap, split, a.rows, a.cols, b.rows, b.cols)
        key = plancache.fingerprint(a.coords, b.coords, meta)
        p, hit = plancache.get_or_build(
            key, lambda: _freeze(_build_plan(a, b, backend, key_cap, split)))
        ENGINE.incr("plan_cache_hits" if hit else "plan_cache_misses")
        return p


_plan = plan  # spgemm_device's `plan` argument shadows the name

_TORCH_INT = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host index array on `dev` without blocking the host: on CUDA it is
    staged in pinned memory and copied with non_blocking=True.  PyTorch's
    caching host allocator records the copy on the stream and reuses the
    pinned block only after the copy has run, so the block stays alive
    however soon the tensor is dropped.  x may be read-only (a cached
    plan's); torch.from_numpy takes only writable arrays."""
    if dev.type != "cuda":
        return torch.from_numpy(np.require(x, requirements="W")).to(dev)
    buf = torch.empty(x.shape, dtype=_TORCH_INT[x.dtype], pin_memory=True)
    buf.numpy()[...] = x
    return buf.to(dev, non_blocking=True)


def _assemble(outs: list[torch.Tensor], take: torch.Tensor) -> torch.Tensor:
    """Concatenate the (padded) round outputs plus one zero row and gather
    through the assembly permutation: every real key reads its own output
    row, the sentinel slot reads the zero row."""
    zero = outs[0].new_zeros((1, *outs[0].shape[1:]))
    return torch.cat(outs + [zero]).index_select(0, take)


def _hybrid_router(a_bound: int, b_bound: int, k: int, device, folds: Folds):
    """choose(rnd) -> (kernel name, fold, proven) for the hybrid backend,
    from the operands' value bounds and the device the rounds run on.

    proven says whether the exactness proof held at the round's real max
    fanout: the proven bound is then valid whichever kernel runs (they give
    the same bits), so bound propagation reads proven, not the kernel."""
    a_limbs, b_limbs = limbs_for_bound(a_bound), limbs_for_bound(b_bound)
    no_mod = partial(folds.exact, no_mod=True)
    mxu = partial(folds.mxu, a_limbs=a_limbs, b_limbs=b_limbs)
    policy = crossover.gate_policy(device)

    def choose(rnd):
        if safe_exact_bound(a_bound, b_bound, rnd.max_fanout, k) is None:
            return "mod", folds.exact, False
        P = rnd.pa.shape[1]
        # the padded width limits only the limb kernel's accumulators; the
        # proof, and so the no_mod fold and the bound, hold regardless
        if P * k > MAX_PAIR_DEPTH:
            return "no_mod", no_mod, True
        if policy == "auto":
            K = min(_shape_class(rnd.pa.shape[0]), crossover.MEASURE_KEYS)
            key = crossover.cache_key(device, a_limbs, b_limbs, k, K, P)
            if not crossover.mxu_wins(no_mod, mxu, key=key, k=k, K=K, P=P, device=device):
                return "no_mod", no_mod, True
        return "mxu", mxu, True

    return choose


def _router(backend: str, k: int, device, folds: Folds, bounds: Callable):
    """choose(rnd) for `backend`; bounds() gives the operands' value bounds
    and is called only by the backends that read them (hybrid and mxu)."""
    if backend == "hybrid":
        return _hybrid_router(*bounds(), k, device, folds)
    if backend == "mxu":
        a_bound, b_bound = bounds()
        mxu = partial(folds.mxu, a_limbs=limbs_for_bound(a_bound),
                      b_limbs=limbs_for_bound(b_bound))
        return lambda rnd: ("mxu", mxu, False)
    return lambda rnd: ("mod", folds.exact, False)


def _count_rounds(backend: str, used: dict, n_rounds: int, keys: int) -> None:
    for name, n in used.items():
        rounds_by_kernel[name] += n
    if backend == "hybrid":
        log.info("spgemm[hybrid mxu=%d/%d no_mod=%d]: keys=%d", used["mxu"],
                 n_rounds, used["no_mod"], keys)


def execute(p: SpgemmPlan, a: DeviceBlockMatrix, b: DeviceBlockMatrix,
            folds: Folds = KERNELS) -> DeviceBlockMatrix:
    """Device half: the rounds' indices and the assembly permutation queued
    to the card from pinned memory (ENGINE's `upload`), one launch per round
    on the kernel p.backend picks for it, then the assembly gather.  On the
    exact backend nothing here waits for the stream, so the host goes on to
    the next multiply while the card works; under hybrid and mxu an
    operand's first bound() (one reduction) and the `auto` gate's one
    measurement per shape do.  folds: the functions dispatched to (the CUDA
    kernels' wrappers by default)."""
    p.check_operands(a, b)
    if a.device != b.device:
        raise ValueError(f"operands lie on {a.device} and {b.device}")
    dev = a.device
    k = p.k
    if p.join.num_keys == 0:
        return DeviceBlockMatrix.empty(a.rows, b.cols, k, dev)
    choose = _router(p.backend, k, dev, folds, lambda: (a.bound(), b.bound()))
    with ENGINE.phase("upload"):
        indices = [(_upload(rnd.pa, dev), _upload(rnd.pb, dev)) for rnd in p.rounds]
        take = _upload(p.take, dev)
    outs, proven_rounds, used = [], 0, dict.fromkeys(rounds_by_kernel, 0)
    for rnd, (pa, pb) in zip(p.rounds, indices):
        name, fold, proven = choose(rnd)
        outs.append(fold(a.slab, b.slab, pa, pb))
        proven_rounds += proven
        used[name] += 1
    _count_rounds(p.backend, used, len(p.rounds), p.join.num_keys)
    slab = _assemble(outs, take)
    out_bound = MAX_BOUND
    if p.backend == "hybrid" and proven_rounds == len(p.rounds):
        proven = safe_exact_bound(a.bound(), b.bound(), int(p.join.fanouts.max()), k)
        if proven is not None:
            out_bound = min(proven, MAX_BOUND)
    return DeviceBlockMatrix(rows=a.rows, cols=b.cols, k=k, coords=p.join.keys,
                             slab=slab, val_bound=out_bound)


def spgemm_device(a, b, *, device="cuda", backend: str = "exact",
                  folds: Folds = KERNELS, plan: SpgemmPlan | None = None,
                  round_size: int | None = None) -> DeviceBlockMatrix:
    """C = A x B, tiles staying on the device.

    a, b: DeviceBlockMatrix, or host BlockSparseMatrix (uploaded to
    `device` on entry).  backend: one of BACKENDS; exact and hybrid give the
    reference's bytes, mxu field mode.  plan: a prepared plan of this pair
    for this backend (chain.py's plan-ahead worker), or None to plan here,
    timed as ENGINE's `plan_wait`; the bytes are the same either way.
    round_size: keys per launch at most (see plan).  The result keeps
    all-zero output tiles (pruning happens only at final output,
    sparse_matrix_mult.cu:577-592) and carries rows=a.rows, cols=b.cols
    (:281-282)."""
    a = ensure_device(a, device)
    b = ensure_device(b, device)
    if plan is None:
        with ENGINE.phase("plan_wait"):
            plan = _plan(a, b, backend=backend, round_size=round_size)
    elif plan.backend != backend:
        raise ValueError(f"plan built for backend {plan.backend!r}, asked for {backend!r}")
    return execute(plan, a, b, folds=folds)


def spgemm(a: BlockSparseMatrix, b: BlockSparseMatrix, *, device="cuda",
           backend: str = "exact", round_size: int | None = None,
           folds: Folds = KERNELS) -> BlockSparseMatrix:
    """C = A x B host-to-host: upload, multiply on `device`, fetch (the CLI's
    --stream multiply: chain partials stay in host memory)."""
    return spgemm_device(a, b, device=device, backend=backend, folds=folds,
                         round_size=round_size).to_host()


def spgemm_outofcore(a, b, *, device="cuda", round_size: int | None = None,
                     backend: str = "exact", folds: Folds = KERNELS) -> BlockSparseMatrix:
    """C = A x B without either operand slab on the device (the JAX
    package's spgemm_outofcore, ops/spgemm.py:1305-1550).

    The reference keeps its matrices in host RAM and stages one round at a
    time to the GPU (sparse_matrix_mult.cu:167-257); so does this.  Each
    round of at most round_size keys (default OOC_ROUND_SIZE, the JAX
    package's 512) uploads only the tiles it references, so the card holds
    at most SPGEMM_TPU_OOC_DEPTH rounds' sub-slabs and outputs whatever the
    operands' size.  At depth >= 2 three stages overlap:

      staging thread -- np.unique / searchsorted / the gather of the
                        round's tiles into pinned host memory (ENGINE
                        `stage_prep`);
      main thread    -- the host-to-device copy on a copy stream and the
                        numeric launch on the current stream (`dispatch`);
                        the hybrid router, whose gate may measure on the
                        card, runs here;
      landing thread -- waits on the round's event, then scatters its
                        device-to-host copy into the host result
                        (`assembly`).

    Depth 1 runs the three in turn, one round at a time.  A round's sub-slab
    holds exactly its referenced tiles plus the zero tile last: the kernels
    skip a slot whose index is the slab's last row, so padding the slab (as
    the JAX package does for its jit cache) would fold pad slots instead of
    skipping them.  The bytes are the resident path's at any depth and
    round size.  a, b: host BlockSparseMatrix (a DeviceBlockMatrix is fetched
    first); hybrid and mxu read the host tiles' exact maxima as bounds."""
    if isinstance(a, DeviceBlockMatrix):
        a = a.to_host()
    if isinstance(b, DeviceBlockMatrix):
        b = b.to_host()
    dev = resolve_device(device)
    depth = knobs.get("SPGEMM_TPU_OOC_DEPTH")
    p = plan(a, b, backend=backend,
             round_size=OOC_ROUND_SIZE if round_size is None else round_size)
    k = p.k
    if p.join.num_keys == 0:
        return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k)
    choose = _router(backend, k, dev, folds, lambda: (_bound(a), _bound(b)))
    on_card = dev.type == "cuda"
    # host tensors over the operands' and the result's memory: torch's
    # gather and scatter run on the host's cores, numpy's on one
    a_tiles, b_tiles = (torch.from_numpy(np.require(m.tiles, requirements="W").view(np.int64))
                        for m in (a, b))
    out_tiles = np.zeros((p.join.num_keys, k, k), np.int64)
    out_t = torch.from_numpy(out_tiles)
    used = dict.fromkeys(rounds_by_kernel, 0)
    if on_card:
        compute = torch.cuda.current_stream(dev)
        copy_stream, land_stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)

    def stage(rnd):
        """Stage 1, host only: (a_sub, sub_pa, b_sub, sub_pb), pinned on
        the card's host."""
        staged = []
        for idx, nnzb, tiles in ((rnd.pa, a.nnzb, a_tiles), (rnd.pb, b.nnzb, b_tiles)):
            u = np.unique(idx)
            u = u[u < nnzb]  # the operand's sentinel is not a tile
            sub = torch.empty((len(u) + 1, k, k), dtype=torch.int64, pin_memory=on_card)
            torch.index_select(tiles, 0, torch.from_numpy(u), out=sub[:-1])
            sub[-1] = 0
            ix = torch.empty(idx.shape, dtype=torch.int32, pin_memory=on_card)
            # the sentinel, past every real index, lands on len(u): the zero tile
            ix.numpy()[...] = np.searchsorted(u, idx)
            staged += [sub, ix]
        ENGINE.incr("ooc_upload_bytes", sum(t.nbytes for t in staged))
        return staged

    def launch(rnd, staged):
        """Stage 2, main thread: upload, one launch, queue the fetch.
        Returns (host rows, event the landing waits on, key_index)."""
        name, fold, _ = choose(rnd)
        used[name] += 1
        ENGINE.incr("ooc_rounds")
        n = len(rnd.key_index)
        if not on_card:
            return fold(*staged[0::2], *staged[1::2])[:n], None, rnd.key_index
        with torch.cuda.stream(copy_stream):
            a_sub, pa, b_sub, pb = (t.to(dev, non_blocking=True) for t in staged)
        compute.wait_stream(copy_stream)
        for t in (a_sub, pa, b_sub, pb):
            t.record_stream(compute)  # allocated on the copy stream, read here
        out = fold(a_sub, b_sub, pa, pb)
        land_stream.wait_stream(compute)
        with torch.cuda.stream(land_stream):
            host = torch.empty((n, k, k), dtype=torch.int64, pin_memory=True)
            host.copy_(out[:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(land_stream)
        out.record_stream(land_stream)
        return host, done, rnd.key_index

    def land(host, done, key_index):
        """Stage 3: wait for this round's copy only, then scatter."""
        if done is not None:
            done.synchronize()
        out_t.index_copy_(0, torch.tensor(key_index), host)

    _pipeline(p.rounds, stage, launch, land, depth)
    _count_rounds(backend, used, len(p.rounds), p.join.num_keys)
    return BlockSparseMatrix(rows=a.rows, cols=b.cols, k=k, coords=p.join.keys,
                             tiles=out_tiles.view(np.uint64))


def _pipeline(rounds, stage, launch, land, depth: int) -> None:
    """Run stage on a staging thread, launch here and land on a landing
    thread, with at most `depth` rounds staged ahead and at most `depth`
    launched and not yet landed (on the card).  The staging of round
    i + depth is submitted once round i has launched and the oldest landing
    beyond depth - 1 has been awaited, so depth 1 runs the three stages in
    turn.  A failure in any stage is raised here by .result(); the queued
    work is cancelled and both threads joined."""
    def staged(rnd):
        with ENGINE.phase("stage_prep"):
            return stage(rnd)

    def landed(item):
        with ENGINE.phase("assembly"):
            land(*item)

    stager = ThreadPoolExecutor(1, thread_name_prefix="ooc-staging")
    lander = ThreadPoolExecutor(1, thread_name_prefix="ooc-landing")
    try:
        ahead = deque(stager.submit(staged, rnd) for rnd in rounds[:depth])
        landing: deque = deque()
        for i, rnd in enumerate(rounds):
            item = ahead.popleft().result()
            with ENGINE.phase("dispatch"):
                item = launch(rnd, item)
            landing.append(lander.submit(landed, item))
            if len(landing) == depth:
                landing.popleft().result()
            if i + depth < len(rounds):
                ahead.append(stager.submit(staged, rounds[i + depth]))
        for fut in landing:
            fut.result()
    finally:
        stager.shutdown(cancel_futures=True)
        lander.shutdown(cancel_futures=True)
