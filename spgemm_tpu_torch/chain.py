"""Chain scheduler: order-preserving pairwise reduction of a matrix chain.

The reference's helper2() (sparse_matrix_mult.cu:287-327) halves the array
each pass, multiplying adjacent pairs left to right and carrying the odd
trailing element.  The arithmetic is not associative (SURVEY.md section 2.9),
so parity needs this exact reduction tree, not just any ordered fold.

Plan-ahead (SPGEMM_TPU_PLAN_AHEAD, default 2; the JAX package's chain.py:
32-134): the pairs of a pass are independent, so while the main thread
dispatches pair i a host worker thread plans pairs i+1..i+ahead.  Planning
is deterministic and the dispatch order does not change, so the bytes are
the same at any depth; 0 plans inline.  Plans stay within a pass, as in the
JAX package, and the worker runs only for the default multiply.  The worker
also builds a deferred (estimator-routed) plan's exact join and, where the
multiply will take the delta path (delta and the plan cache on), computes
both operands' row digests (ops/delta.stash_digests), so neither lands on
the dispatching thread; the digests go with the plan to that multiply
alone.

The multiply is spgemm_device by default (partials stay on the card); the
CLI's --stream and --out-of-core pass ops/spgemm.spgemm and
spgemm_outofcore, whose partials stay in host memory.  checkpoint_dir
snapshots each pass (utils/checkpoint.py), tagged with the inputs and the
arithmetic, and resumes from the newest written for both.
failover=True is for a lost card: when a multiply of a chain that runs on
a card raises, the card is probed in a subprocess
(utils/backend_probe.py), and only if the probe finds no working card is
the pass restarted on the host, in the backend's arithmetic
(oracle_multiply, or field_oracle_multiply under mxu), from host copies of
the pass's input fetched while the card still worked (after a sticky CUDA
error nothing on the card can be read).  On a card that still computes, or
on a chain that runs on the CPU (no card to lose), the error is the
program's and is raised as it is.  Failover happens only when asked for,
and only an Exception triggers it: a BaseException (an abort) passes
through.

chain_products_batched reduces several chains of one block structure in
lockstep (spgemmd's cross-job batching): the same pairing, each multiply
planned once and run for every chain by ops/spgemm.execute_batched.
"""

from __future__ import annotations

import logging
import queue
import sys
import threading

import torch

from spgemm_tpu_torch.obs import events
from spgemm_tpu_torch.ops import delta, plancache
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix, ensure_device, resolve_device
from spgemm_tpu_torch.ops.spgemm import KERNELS, Folds, execute_batched, plan, spgemm_device
from spgemm_tpu_torch.utils import backend_probe, checkpoint, knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.semantics import field_spgemm_oracle, spgemm_oracle
from spgemm_tpu_torch.utils.timers import ENGINE

log = logging.getLogger("spgemm_tpu_torch.chain")


class _PlanAheadWorker:
    """Bounded host planner for one reduction pass.

    Plans come out strictly in pair order; the semaphore bounds the plans
    made and not yet taken to `ahead` (each holds its padded index arrays
    in host memory).  The worker is host-only: the planner it runs is numpy,
    the native join and hashlib, and never calls into torch, so it neither
    touches the card nor launches anything."""

    def __init__(self, pairs, planner, ahead: int):
        self._outq: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._sem = threading.Semaphore(ahead)
        # taken on the calling thread: the worker's plan phases and plan-cache
        # counters belong to the calling thread's open scopes (a daemon job's),
        # and its plan spans carry that thread's job and trace tags
        self._attr = ENGINE.attribution()
        self._thread = threading.Thread(target=self._work, args=(list(pairs), planner),
                                        name="chain-planner", daemon=True)
        self._thread.start()

    @backend_probe.host_only
    def _work(self, pairs, planner):
        try:
            with ENGINE.attributed(self._attr):
                for i, (a, b) in enumerate(pairs):
                    while not self._sem.acquire(timeout=0.2):
                        if self._stop.is_set():
                            return
                    if self._stop.is_set():
                        return
                    self._outq.put((i, planner(a, b), None))
                    pairs[i] = None  # drop operand references once planned
        except Exception as e:  # noqa: BLE001 -- re-raised on the consumer (get)
            self._outq.put((None, None, e))
        except BaseException as e:  # an abort: the consumer sees it too
            self._outq.put((None, None, e))
            raise

    def get(self):
        """The next pair's (index, plan); re-raises a worker failure.  The
        time blocked here is ENGINE's `plan_wait`: the planner was late."""
        with ENGINE.phase("plan_wait"):
            i, p, err = self._outq.get()
        self._sem.release()
        if err is not None:
            raise err
        return i, p

    def close(self):
        """Stop the worker and wait for it, on every exit path: a planner
        left running would keep the pass's operands alive.  It sees the stop
        flag within 0.2 s unless it is inside planner()."""
        self._stop.set()
        self._thread.join(timeout=30.0)


def _plan_ahead_depth() -> int:
    """SPGEMM_TPU_PLAN_AHEAD (default 2): 0 = inline planning."""
    return knobs.get("SPGEMM_TPU_PLAN_AHEAD")


def _make_planner(backend: str, round_size: int | None):
    """The (a, b) -> SpgemmPlan function the worker runs: the plan, its
    exact join built if it was deferred (JAX chain.py:121-135).  Host-only."""
    def planner(a, b):
        return plan(a, b, backend=backend, round_size=round_size).ensure_exact()

    return planner


def _with_digests(planner):
    """planner extended to (plan, digests): both operands' row digests
    (delta.stash_digests) where the multiply will take the delta path
    (delta and the plan cache on, read as the pass starts), else None."""
    if not (delta.enabled() and plancache.enabled()):
        return lambda a, b: (planner(a, b), None)
    return lambda a, b: (planner(a, b), delta.stash_digests(a, b))


def _with_bound(m, device):
    """Under hybrid, plan() reads each operand's bound(): resolve it here,
    on the dispatching thread (uploading a host operand and reducing its
    tiles on the card), so that the worker's planning stays host-only."""
    m = ensure_device(m, device)
    m.bound()
    return m


def _to_host(m) -> BlockSparseMatrix:
    return m.to_host() if isinstance(m, DeviceBlockMatrix) else m


def oracle_multiply(a, b, **_ignored) -> BlockSparseMatrix:
    """The host-only multiply with the reference's semantics
    (utils/semantics.spgemm_oracle): failover's multiply under exact and
    hybrid, which needs no card.  Slow by design."""
    a, b = _to_host(a), _to_host(b)
    return BlockSparseMatrix.from_dict(a.rows, b.cols, a.k,
                                       spgemm_oracle(a.to_dict(), b.to_dict(), a.k))


def field_oracle_multiply(a, b, **_ignored) -> BlockSparseMatrix:
    """The host-only multiply in field mode, clean arithmetic mod 2^64 - 1
    (utils/semantics.field_spgemm_oracle): failover's multiply under mxu.
    The JAX package fails over to the reference's fold whatever the
    backend; the port keeps the backend's arithmetic."""
    a, b = _to_host(a), _to_host(b)
    return BlockSparseMatrix.from_dict(a.rows, b.cols, a.k,
                                       field_spgemm_oracle(a.to_dict(), b.to_dict(), a.k))


_HOST_MULTIPLIES = (oracle_multiply, field_oracle_multiply)


def _host_multiply(backend: str):
    """Failover's host multiply for backend: the arithmetic stays its own."""
    return field_oracle_multiply if backend == "mxu" else oracle_multiply


def _on_card(device) -> bool:
    """Whether the chain's multiplies run on a card: only then can a failed
    multiply be a lost card."""
    return device is not None and torch.device(device).type == "cuda"


def _reduce_pass(arr: list, multiply, kwargs: dict, ahead: int, heartbeat=None) -> list:
    """One helper2 pass over arr: the products of adjacent pairs, the odd
    element carried, heartbeat() called after each multiply.  Consumed
    entries of arr are set to None."""
    odd_carry = arr[-1] if len(arr) % 2 == 1 else None
    pairs = [(arr[i], arr[i + 1]) for i in range(0, len(arr) - 1, 2)]
    worker = None
    if ahead > 0 and len(pairs) > 1 and multiply is spgemm_device:
        if kwargs["backend"] == "hybrid":
            pairs = [(_with_bound(a, kwargs["device"]), _with_bound(b, kwargs["device"]))
                     for a, b in pairs]
        planner = _make_planner(kwargs["backend"], kwargs["round_size"])
        worker = _PlanAheadWorker(pairs, _with_digests(planner), ahead)
    nxt = []
    try:
        for p, (a, b) in enumerate(pairs):
            i = 2 * p
            # the reference's :301 progress line, printed unconditionally
            print(f"multiplying {i} {i + 1}", flush=True)
            extra = {}
            if worker is not None:
                got, (extra["plan"], extra["digests"]) = worker.get()
                if got != p:
                    raise RuntimeError(f"planner returned pair {got} for pair {p}")
            nxt.append(multiply(a, b, **kwargs, **extra))
            if heartbeat is not None:
                heartbeat()
            arr[i] = arr[i + 1] = pairs[p] = None  # free consumed partials early
    finally:
        if worker is not None:
            worker.close()
    if odd_carry is not None:
        nxt.append(odd_carry)  # odd element carried (:315-321)
    return nxt


def chain_product(matrices: list, *, device="cuda", keep_device: bool = False,
                  backend: str = "exact", folds: Folds = KERNELS, multiply=None,
                  round_size: int | None = None, checkpoint_dir: str | None = None,
                  resume: bool = True, failover: bool = False, heartbeat=None):
    """Reduce [M1, ..., MN] to M1 x M2 x ... x MN with helper2's pairing.

    matrices: host BlockSparseMatrix or DeviceBlockMatrix.  multiply: the
    binary op, called as multiply(a, b, device=, backend=, folds=,
    round_size=) (default ops/spgemm.spgemm_device: host matrices are
    uploaded when first multiplied, or under hybrid with plan-ahead when
    their pass starts, and every partial stays on the card, carrying its
    value bound to the next multiply).  Returns the host result, or with
    keep_device=True the default multiply's DeviceBlockMatrix (another
    multiply's host result as it is).

    checkpoint_dir: after each pass the surviving partials are fetched and
    written as pass_<i>.npz, tagged with a fingerprint of `matrices` and the
    backend's arithmetic (checkpoint.arithmetic); with resume=True a run
    starts from the newest pass there whose tags are not another chain's or
    another arithmetic's.  failover: when a multiply of a chain on a card
    raises an Exception and the probe then finds no working card, the pass
    restarts from host copies of its input on the backend's host multiply
    (_host_multiply), after one line on stderr, and the rest of the chain
    runs there too; with a working card, or on the CPU, the error is
    raised.

    heartbeat: a zero-argument callable run after every multiply, the
    daemon's liveness signal (serve/daemon.py: its watchdog tells a slow
    job from an executor stuck in a call that never returns).  A
    BaseException it raises (the daemon's JobAbandoned) ends the chain and
    passes through failover."""
    if not matrices:
        raise ValueError("empty chain")
    if multiply is None:
        multiply = spgemm_device
    if multiply not in _HOST_MULTIPLIES:
        device = resolve_device(device)
    ahead = _plan_ahead_depth()  # read once: an invalid value raises before any multiply
    arr = list(matrices)
    pass_idx = 0
    inputs_fp = None
    arith = checkpoint.arithmetic(backend)
    if checkpoint_dir:
        inputs_fp = checkpoint.inputs_fingerprint([_to_host(m) for m in matrices])
    if checkpoint_dir and resume:
        found = checkpoint.latest_pass(checkpoint_dir, inputs_fp, arith)
        if found is not None:
            pass_idx, arr = found
            log.info("resumed from checkpoint pass %d (%d partials)", pass_idx, len(arr))
    need_host = failover or bool(checkpoint_dir)
    # the failover restart point: host copies of the current pass's input
    arr_host = [_to_host(m) for m in arr] if failover else None
    kwargs = {"device": device, "backend": backend, "folds": folds, "round_size": round_size}
    while len(arr) > 1:
        try:
            nxt = _reduce_pass(arr, multiply, kwargs, ahead, heartbeat)
            nxt_host = [_to_host(m) for m in nxt] if need_host else None
        except Exception as e:  # noqa: BLE001 -- device loss is the use case
            if not failover or multiply in _HOST_MULTIPLIES or not _on_card(device):
                raise  # no card to lose
            probe = backend_probe.probe_default_backend()
            if probe == "ok":
                raise  # the card still computes: not a lost card
            multiply, keep_device = _host_multiply(backend), False
            print(f"chain failover: a multiply of pass {pass_idx + 1} failed ({e!r}); "
                  f"CUDA probe: {probe}; restarting the pass on the host "
                  f"{'field-mode oracle' if multiply is field_oracle_multiply else 'oracle'}",
                  file=sys.stderr, flush=True)
            events.emit("chain_failover", error=repr(e), pass_idx=pass_idx, probe=probe)
            # a copy: the retry sets consumed entries of its list to None
            arr = list(arr_host)
            continue
        arr, arr_host = nxt, nxt_host
        pass_idx += 1
        if checkpoint_dir:
            checkpoint.save_pass(checkpoint_dir, pass_idx, arr_host, inputs_fp, arith)
    if not keep_device:
        return arr_host[0] if arr_host is not None else _to_host(arr[0])
    return ensure_device(arr[0], device) if multiply is spgemm_device else arr[0]


def chain_products_batched(chains: list[list], *, backend: str = "exact",
                           round_size: int | None = None, folds: Folds = KERNELS,
                           heartbeat=None) -> list[DeviceBlockMatrix]:
    """The products of J chains of one block structure, reduced in lockstep
    with chain_product's pairing (adjacent pairs each pass, the odd one
    carried): each multiply is planned once (ops/spgemm.plan, through the
    plan cache) and run for all J by ops/spgemm.execute_batched, so each
    round is one launch over the J jobs' stacked indices.  One `multiplying
    i j` line per step; heartbeat() after each multiply.  The chains hold
    DeviceBlockMatrix on one device; returns the J products there, each
    with its solo chain's bits (no delta path: batching runs with
    SPGEMM_TPU_DELTA=0)."""
    arrs = [list(c) for c in chains]
    while len(arrs[0]) > 1:
        nxt: list[list] = [[] for _ in arrs]
        width = len(arrs[0])
        for i in range(0, width - 1, 2):
            print(f"multiplying {i} {i + 1}", flush=True)  # once per batched step
            p = plan(arrs[0][i], arrs[0][i + 1], backend=backend, round_size=round_size)
            outs = execute_batched(p, [(arr[i], arr[i + 1]) for arr in arrs], folds=folds)
            for out, row in zip(outs, nxt):
                row.append(out)
            if heartbeat is not None:
                heartbeat()
            for arr in arrs:
                arr[i] = arr[i + 1] = None  # free consumed partials
        if width % 2 == 1:
            for arr, row in zip(arrs, nxt):
                row.append(arr[-1])  # the odd element carried
        arrs = nxt
    return [arr[0] for arr in arrs]
