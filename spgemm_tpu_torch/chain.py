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
JAX package.

A multiply that fails raises: there is no failover to the host oracle.
"""

from __future__ import annotations

import queue
import threading
from functools import partial

from spgemm_tpu_torch.ops.device import ensure_device, resolve_device
from spgemm_tpu_torch.ops.spgemm import KERNELS, Folds, plan, spgemm_device
from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.timers import ENGINE


class _PlanAheadWorker:
    """Bounded host planner for one reduction pass.

    Plans come out strictly in pair order; the semaphore bounds the plans
    made and not yet taken to `ahead` (each holds its padded index arrays
    in host memory).  The worker is host-only: the planner it runs is numpy
    and the native join, and never calls into torch, so it neither touches
    the card nor launches anything."""

    def __init__(self, pairs, planner, ahead: int):
        self._outq: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._sem = threading.Semaphore(ahead)
        self._thread = threading.Thread(target=self._work, args=(list(pairs), planner),
                                        name="chain-planner", daemon=True)
        self._thread.start()

    def _work(self, pairs, planner):
        try:
            for i, (a, b) in enumerate(pairs):
                while not self._sem.acquire(timeout=0.2):
                    if self._stop.is_set():
                        return
                if self._stop.is_set():
                    return
                self._outq.put((i, planner(a, b), None))
                pairs[i] = None  # drop operand references once planned
        except BaseException as e:  # re-raised on the consumer
            self._outq.put((None, None, e))
            if not isinstance(e, Exception):
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


def _make_planner(backend: str):
    """The (a, b) -> SpgemmPlan function the worker runs."""
    return partial(plan, backend=backend)


def _with_bound(m, device):
    """Under hybrid, plan() reads each operand's bound(): resolve it here,
    on the dispatching thread (uploading a host operand and reducing its
    tiles on the card), so that the worker's planning stays host-only."""
    m = ensure_device(m, device)
    m.bound()
    return m


def chain_product(matrices: list, *, device="cuda", keep_device: bool = False,
                  backend: str = "exact", folds: Folds = KERNELS):
    """Reduce [M1, ..., MN] to M1 x M2 x ... x MN with helper2's pairing.

    matrices: host BlockSparseMatrix or DeviceBlockMatrix; host matrices
    are uploaded to `device` when first multiplied (under hybrid with
    plan-ahead, when their pass starts), and every partial product stays on
    the device, carrying its value bound to the next multiply.  Returns the
    host result, or the DeviceBlockMatrix with keep_device=True.  backend
    and folds are forwarded to every multiply (ops/spgemm.spgemm_device)."""
    if not matrices:
        raise ValueError("empty chain")
    device = resolve_device(device)
    ahead = _plan_ahead_depth()  # read once: an invalid value raises before any multiply
    arr = list(matrices)
    while len(arr) > 1:
        odd_carry = arr[-1] if len(arr) % 2 == 1 else None
        pairs = [(arr[i], arr[i + 1]) for i in range(0, len(arr) - 1, 2)]
        worker = None
        if ahead > 0 and len(pairs) > 1:
            if backend == "hybrid":
                pairs = [(_with_bound(a, device), _with_bound(b, device)) for a, b in pairs]
            worker = _PlanAheadWorker(pairs, _make_planner(backend), ahead)
        nxt = []
        try:
            for p, (a, b) in enumerate(pairs):
                i = 2 * p
                # the reference's :301 progress line, printed unconditionally
                print(f"multiplying {i} {i + 1}", flush=True)
                pln = None
                if worker is not None:
                    got, pln = worker.get()
                    if got != p:
                        raise RuntimeError(f"planner returned pair {got} for pair {p}")
                nxt.append(spgemm_device(a, b, device=device, backend=backend,
                                         folds=folds, plan=pln))
                arr[i] = arr[i + 1] = pairs[p] = None  # free consumed partials early
        finally:
            if worker is not None:
                worker.close()
        if odd_carry is not None:
            nxt.append(odd_carry)  # odd element carried (:315-321)
        arr = nxt
    result = ensure_device(arr[0], device)
    return result if keep_device else result.to_host()
