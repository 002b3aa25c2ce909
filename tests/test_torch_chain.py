"""The port's chain with plan-ahead (spgemm_tpu_torch/chain.py) on the CPU
against the JAX package's chain_product (SPGEMM_TPU_DELTA=0: its delta store
keys results without the operand dims, ROADMAP.md faults) and the port's
own inline planning; the planner worker's order, bound, failure and
shutdown; and the port's knob registry against the JAX package's.
Tolerance: exact."""

import sys
import threading
import time

import numpy as np
import pytest

from spgemm_tpu.chain import chain_product as jax_chain_product
from spgemm_tpu.utils import knobs as jax_knobs
from spgemm_tpu.utils.gen import random_chain
from spgemm_tpu_torch import chain
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.timers import ENGINE


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")


def _same(m, w) -> bool:
    return (m.rows, m.cols, m.k) == (w.rows, w.cols, w.k) \
        and np.array_equal(m.coords, w.coords) and np.array_equal(m.tiles, w.tiles)


@pytest.mark.parametrize("n", [5, 6])
@pytest.mark.parametrize("ahead", ["0", "1", "2", "8"])
def test_plan_ahead_matches_jax_chain(n, ahead, monkeypatch, capsys):
    mats = random_chain(n, 6, 2, 0.5, np.random.default_rng(60 + n), "adversarial")
    want = jax_chain_product(mats, backend="xla")
    jax_lines = capsys.readouterr().out
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", ahead)
    got = chain_product([BlockSparseMatrix.from_reference(m) for m in mats], device="cpu")
    assert _same(got, want)
    assert capsys.readouterr().out == jax_lines  # the same `multiplying i j` lines


@pytest.mark.parametrize("backend", ["hybrid", "mxu"])
def test_plan_ahead_other_backends_match_inline(backend, monkeypatch, capsys):
    """Under hybrid the operands' bounds are resolved before the worker
    starts; the bytes and the routed rounds match inline planning."""
    mats = [BlockSparseMatrix.from_reference(m)
            for m in random_chain(7, 6, 2, 0.5, np.random.default_rng(70), "small")]
    results = {}
    for ahead in ("0", "2"):
        monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", ahead)
        for name in engine.rounds_by_kernel:
            engine.rounds_by_kernel[name] = 0
        results[ahead] = (chain_product(mats, device="cpu", backend=backend),
                          dict(engine.rounds_by_kernel))
    assert _same(results["0"][0], results["2"][0])
    assert results["0"][1] == results["2"][1]
    assert results["2"][1]["mxu"] > 0


def test_plans_arrive_in_order_and_bounded():
    made, lock = [], threading.Lock()
    rng = np.random.default_rng(1)
    delays = rng.uniform(0, 0.004, size=12)

    def planner(a, b):
        with lock:
            made.append(a)
        time.sleep(delays[a])
        return ("plan", a, b)

    ahead = 3
    worker = chain._PlanAheadWorker([(i, -i) for i in range(12)], planner, ahead)
    try:
        for p in range(12):
            time.sleep(delays[11 - p])
            with lock:
                assert len(made) - p <= ahead  # never more than `ahead` plans not yet taken
            assert worker.get() == (p, ("plan", p, -p))
    finally:
        worker.close()
    assert made == list(range(12))
    assert not worker._thread.is_alive()


def test_failing_planner_reraises_and_worker_closes(monkeypatch, capsys):
    def planner(a, b):
        if planner.calls == 2:
            raise ValueError("planner failed on the third pair")
        planner.calls += 1
        return engine.plan(a, b)

    planner.calls = 0
    worker = chain._PlanAheadWorker([(1, 2)] * 2, lambda a, b: 1 / 0, 2)
    with pytest.raises(ZeroDivisionError):
        worker.get()
    worker.close()
    assert not worker._thread.is_alive()

    monkeypatch.setattr(chain, "_make_planner", lambda backend, round_size: planner)
    mats = [BlockSparseMatrix.from_reference(m)
            for m in random_chain(8, 5, 2, 0.5, np.random.default_rng(2))]
    with pytest.raises(ValueError, match="third pair"):
        chain_product(mats, device="cpu")
    # the progress line of the failed pair is printed before its plan is taken
    assert capsys.readouterr().out.splitlines() == ["multiplying 0 1", "multiplying 2 3",
                                                    "multiplying 4 5"]
    assert not [t for t in threading.enumerate() if t.name == "chain-planner"]


class _Abort(BaseException):
    """A control signal that is not an Exception (as serve.queue.JobAbandoned)."""


def test_planner_abort_reaches_the_consumer_and_ends_the_worker(monkeypatch):
    """A BaseException that is not an Exception (an abort) in the planner is
    handed to the consumer like a failure, and also re-raised on the worker
    thread, so it ends there and is not swallowed; an Exception is handed
    over only (the worker's thread ends quietly)."""
    seen = []
    monkeypatch.setattr(threading, "excepthook", lambda args: seen.append(args.exc_type))

    def abort(a, b):
        raise _Abort()

    worker = chain._PlanAheadWorker([(1, 2)] * 2, abort, 2)
    with pytest.raises(_Abort):
        worker.get()
    worker.close()
    assert not worker._thread.is_alive()
    assert seen == [_Abort]

    seen.clear()
    worker = chain._PlanAheadWorker([(1, 2)] * 2, lambda a, b: 1 / 0, 2)
    with pytest.raises(ZeroDivisionError):
        worker.get()
    worker.close()
    assert seen == []


def test_close_stops_a_worker_that_is_ahead():
    worker = chain._PlanAheadWorker([(i, i) for i in range(50)], lambda a, b: a, 2)
    assert worker.get() == (0, 0)
    worker.close()
    assert not worker._thread.is_alive()


@pytest.mark.parametrize("value", ["-1", "two", "1.5"])
def test_invalid_plan_ahead_raises_before_any_multiply(value, monkeypatch, capsys):
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", value)
    mats = [BlockSparseMatrix.from_reference(m)
            for m in random_chain(3, 4, 2, 0.5, np.random.default_rng(3))]
    with pytest.raises(ValueError, match="SPGEMM_TPU_PLAN_AHEAD"):
        chain_product(mats, device="cpu")
    assert capsys.readouterr().out == ""


def test_planner_thread_never_calls_torch(monkeypatch, capsys):
    """The worker plans with numpy and the native join only: a profile hook
    on every new thread records any call into torch from the planner."""
    seen = []

    def hook(frame, event, arg):
        if threading.current_thread().name != "chain-planner":
            return
        module = frame.f_globals.get("__name__", "")
        if event == "c_call":
            module = getattr(arg, "__module__", None) or ""
        if module.split(".")[0] == "torch":
            seen.append((event, module, frame.f_code.co_name))

    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", "2")
    mats = [BlockSparseMatrix.from_reference(m)
            for m in random_chain(6, 6, 2, 0.5, np.random.default_rng(4))]
    planned = []
    real = chain._make_planner

    def spy(backend, round_size):
        fn = real(backend, round_size)
        return lambda a, b: planned.append(threading.current_thread().name) or fn(a, b)

    monkeypatch.setattr(chain, "_make_planner", spy)
    threading.setprofile(hook)
    try:
        chain_product(mats, device="cpu")
    finally:
        threading.setprofile(None)
        sys.setprofile(None)
    assert planned == ["chain-planner"] * 3  # pass 1 (3 pairs); later passes plan inline
    assert not seen, seen[:5]


def test_engine_phases(monkeypatch, capsys):
    mats = [BlockSparseMatrix.from_reference(m)
            for m in random_chain(5, 5, 2, 0.5, np.random.default_rng(6))]
    for ahead in ("2", "0"):
        monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", ahead)
        ENGINE.reset()
        chain_product(mats, device="cpu")
        assert ENGINE.counts["plan"] == 4  # one plan per multiply
        assert ENGINE.counts["plan_wait"] == 4  # taken from the worker or planned inline
        assert ENGINE.counts["upload"] == 4
        assert ENGINE.counts["numeric_dispatch"] == 4  # each multiply's launches
        assert set(ENGINE.snapshot()) == {"plan", "plan_wait", "upload", "numeric_dispatch"}
    ENGINE.reset()
    assert ENGINE.snapshot() == {}


@pytest.mark.parametrize("name,values", [
    ("SPGEMM_TPU_PLAN_AHEAD", [None, "", " 3 ", "0", "-1", "x", "2.0"]),
    ("SPGEMM_TPU_NO_NATIVE", [None, "", "1", "0", " "]),
    ("SPGEMM_TPU_HYBRID_GATE", [None, "", "auto", " proof ", "fast", "AUTO"]),
    ("SPGEMM_TPU_CROSSOVER_CACHE", [None, "", "/tmp/x", " /tmp/y "]),
    ("SPGEMM_TPU_OOC_DEPTH", [None, "", " 4 ", "1", "0", "-2", "x", "2.5"]),
    ("SPGEMM_TPU_PLAN_CACHE", [None, "", "0", " 1 ", "2", "yes", "-1"]),
    ("SPGEMM_TPU_PLAN_CACHE_CAP", [None, "", "1", " 64 ", "0", "x"]),
    ("SPGEMM_TPU_PROBE_TIMEOUT", [None, "", "0", " 2.5 ", "30", "-1", "-0.5", "x", "1e3"]),
])
def test_knobs_parse_like_jax(name, values, monkeypatch):
    for value in values:
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
        try:
            want = jax_knobs.get(name)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                knobs.get(name)
            assert str(got.value) == str(e)
            continue
        assert knobs.get(name) == want, value
    with pytest.raises(KeyError):
        knobs.get("SPGEMM_TPU_NOT_A_KNOB")
