"""The port's SLO engine (spgemm_tpu_torch/obs/slo.py) against the JAX
package's (spgemm_tpu/obs/slo.py), on the CPU: the same record stream, with
`now` injected wherever a clock enters, fed into one engine of each
package; every read (report, samples, the families rendered by each
package's obs/metrics) and every burn event must be equal.  The cases are
tests/test_slo.py's: quantiles, queue-wait share and the slice merge,
age-out, burn and its trace id, clear on age-out, the fast-window gate, the
latency target, the unset-objective mode, tenant eviction (a burning tenant
too), the record ring's bound, rendering, and the master knob at 0; then
random streams from numpy seeds.  Tolerance: exact equality."""

import numpy as np
import pytest

from spgemm_tpu.obs import events as jax_events
from spgemm_tpu.obs import metrics as jax_metrics
from spgemm_tpu.obs import slo as jax_slo
from spgemm_tpu_torch.obs import events, metrics, slo
from spgemm_tpu_torch.utils import knobs

SLO_KNOBS = ("SPGEMM_TPU_SLO_TARGET_S", "SPGEMM_TPU_SLO_ERROR_PCT", "SPGEMM_TPU_SLO_WINDOW_S",
             "SPGEMM_TPU_OBS_TRACE")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in SLO_KNOBS + ("SPGEMM_TPU_OBS_EVENTS",):
        monkeypatch.delenv(name, raising=False)
    events.LOG.clear()
    jax_events.LOG.clear()
    yield
    events.LOG.clear()
    jax_events.LOG.clear()


def _arm(target="1", error_pct="10", window="120"):
    return {"SPGEMM_TPU_SLO_TARGET_S": target, "SPGEMM_TPU_SLO_ERROR_PCT": error_pct,
            "SPGEMM_TPU_SLO_WINDOW_S": window}


def _obs(tenant, slice_name, wall, qw, error, now, trace=None):
    return ("obs", tenant, slice_name, wall, qw, error, trace, now)


# each case: (env, module constants, ops); ops are observations and
# ("read", now) points where both engines are read
CASES = {
    "quantiles": ({}, {}, [_obs("t", "s0", 0.02, 0.0, False, 1000.0 + i) for i in range(50)]
                  + [_obs("t", "s0", 3.0, 0.0, False, 1050.0 + i) for i in range(50)]
                  + [("read", 1100.0)]),
    "queue_wait_share_and_slice_merge": ({}, {}, [
        _obs("t", "s0", 0.9, 0.1, False, 10.0), _obs("t", "s1", 0.9, 0.1, False, 11.0),
        ("read", 12.0)]),
    "window_ages_out": (_arm(window="100"), {}, [
        _obs("t", "s0", 0.1, 0.0, False, 0.0), _obs("t", "s0", 0.1, 0.0, False, 99.0),
        ("read", 99.5), ("read", 150.0), ("read", 500.0)]),
    "burn_with_trace": (_arm(error_pct="10", window="120"), {},
                        [_obs("t", "s0", 0.1, 0.0, False, 1000.0 + i) for i in range(8)]
                        + [_obs("t", "s0", 0.1, 0.0, True, 1008.0, "aa" * 16),
                           _obs("t", "s0", 0.1, 0.0, True, 1009.0, "bb" * 16),
                           ("read", 1010.0)]),
    "burn_clears_on_age_out": (_arm(error_pct="10", window="100"), {}, [
        _obs("t", "s0", 0.1, 0.0, True, 1000.0, "aa" * 16), ("read", 1001.0),
        ("read", 1200.0)]),
    "fast_window_gate": (_arm(error_pct="10", window="120"), {},
                         [_obs("t", "s0", 0.1, 0.0, True, 1000.0),
                          _obs("t", "s0", 0.1, 0.0, True, 1001.0)]
                         + [_obs("t", "s0", 0.1, 0.0, False, 1100.0 + i) for i in range(3)]
                         + [("read", 1103.0)]),
    "latency_target": (_arm(target="1", error_pct="10", window="120"), {}, [
        _obs("t", "s0", 5.0, 0.0, False, 1000.0, "cc" * 16), ("read", 1001.0)]),
    "unset_objectives": ({}, {}, [_obs("t", "s0", 30.0, 0.0, True, 1000.0 + i)
                                  for i in range(5)] + [("read", 1005.0)]),
    "tenant_eviction": ({}, {"TENANT_RETAIN": 3},
                        [_obs(f"t{i}", "s0", 0.1, 0.0, False, 1000.0 + i) for i in range(6)]
                        + [("read", 1010.0), _obs("t3", "s0", 0.1, 0.0, False, 1011.0),
                           _obs("t9", "s0", 0.1, 0.0, False, 1012.0), ("read", 1013.0)]),
    "evicting_a_burning_tenant": (_arm(error_pct="10", window="120"), {"TENANT_RETAIN": 2}, [
        _obs("a", "s0", 0.1, 0.0, True, 1000.0, "aa" * 16), ("read", 1000.5),
        _obs("b", "s0", 0.1, 0.0, False, 1001.0), _obs("c", "s0", 0.1, 0.0, False, 1002.0),
        ("read", 1003.0)]),
    "record_ring_bound": ({}, {"RECORD_RETAIN": 16},
                          [_obs("t", "s0", 0.1, 0.0, False, 1000.0 + i * 1e-3)
                           for i in range(100)] + [("read", 1001.0)]),
    "rendering": (_arm(), {}, [_obs("t", "s0", 0.1, 0.05, True, 1000.0), ("read", 1001.0)]),
    "master_knob_zero": ({**_arm(), "SPGEMM_TPU_OBS_TRACE": "0"}, {}, [
        _obs("t", "s0", 99.0, 0.0, True, 1000.0), ("read", 1001.0)]),
}


def _burn_events(log) -> list:
    """The burn transitions in the log, without the record's own clock,
    sequence and thread fields."""
    return [{k: v for k, v in r.items() if k not in ("seq", "ts", "mono_us")}
            for r in log.tail(1000) if r["kind"].startswith("slo_burn")]


def _drive(mod, metrics_mod, ops) -> list:
    """Run ops through a fresh engine of mod; what each read gave."""
    eng = mod.SloEngine()
    reads = []
    for op in ops:
        if op[0] == "obs":
            _, tenant, slice_name, wall, qw, error, trace, now = op
            eng.observe(tenant, slice_name, wall, qw, error, trace_id=trace, now=now)
        else:
            rep = eng.report(now=op[1])
            samples = eng.samples(now=op[1])
            reads.append((rep, samples, metrics_mod.render(samples)))
    return reads


def _parity(ops, env: dict, constants: dict, monkeypatch) -> list:
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for name, value in constants.items():
        monkeypatch.setattr(slo, name, value)
        monkeypatch.setattr(jax_slo, name, value)
    ours = _drive(slo, metrics, ops)
    theirs = _drive(jax_slo, jax_metrics, ops)
    assert ours == theirs
    assert _burn_events(events.LOG) == _burn_events(jax_events.LOG)
    return ours


def test_the_constants_are_the_jax_packages():
    for name in ("QUANTILES", "LATENCY_BUCKETS", "FAST_WINDOW_DIV", "BURN_THRESHOLD",
                 "TENANT_RETAIN", "RECORD_RETAIN"):
        assert getattr(slo, name) == getattr(jax_slo, name), name


@pytest.mark.parametrize("name, values", [
    ("SPGEMM_TPU_SLO_TARGET_S", (None, "0", "2.5", "-1", "x", "")),
    ("SPGEMM_TPU_SLO_ERROR_PCT", (None, "0", "1", "50", "-0.5", "y")),
    ("SPGEMM_TPU_SLO_WINDOW_S", (None, "1", "3600", "0.5", "z")),
])
def test_slo_knobs_parse_like_jax(name, values, monkeypatch):
    from spgemm_tpu.utils import knobs as jax_knobs

    mine, theirs = knobs.REGISTRY[name], jax_knobs.REGISTRY[name]
    assert (mine.kind, mine.default, mine.minimum) == (theirs.kind, theirs.default,
                                                       theirs.minimum)
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


@pytest.mark.parametrize("case", list(CASES))
def test_the_engine_judges_a_stream_as_the_jax_engine(case, monkeypatch):
    env, constants, ops = CASES[case]
    reads = _parity(ops, env, constants, monkeypatch)
    kinds = [e["kind"] for e in _burn_events(events.LOG)]
    rep, samples, text = reads[-1]
    # each case shows what it is named for (tests/test_slo.py's checks)
    if case == "quantiles":
        assert rep["tenants"]["t"]["latency_s"] == {"p50": 0.025, "p95": 5.0, "p99": 5.0}
    elif case == "queue_wait_share_and_slice_merge":
        assert rep["tenants"]["t"]["jobs"] == 2 and len(rep["burn"]) == 2
    elif case == "window_ages_out":
        assert [r[0]["tenants"].get("t", {}).get("jobs") for r in reads] == [2, 1, None]
    elif case == "burn_with_trace":
        assert rep["burn"][0]["active"] and rep["burn"][0]["trace_id"] == "bb" * 16
        assert kinds == ["slo_burn"] and _burn_events(events.LOG)[0]["trace_id"] == "aa" * 16
    elif case == "burn_clears_on_age_out":
        assert kinds == ["slo_burn", "slo_burn_clear"]
    elif case == "fast_window_gate":
        assert not rep["burn"][0]["active"] and kinds[-1] == "slo_burn_clear"
    elif case == "latency_target":
        assert rep["burn"][0]["active"] and rep["burn"][0]["trace_id"] == "cc" * 16
    elif case == "unset_objectives":
        assert rep["objectives"]["enabled"] is False and kinds == []
        assert rep["tenants"]["t"]["error_ratio"] == 1.0
    elif case == "tenant_eviction":
        assert set(reads[0][0]["tenants"]) == {"t3", "t4", "t5"}
        assert set(rep["tenants"]) == {"t3", "t5", "t9"} and rep["tenants_evicted"] == 4
    elif case == "evicting_a_burning_tenant":
        assert kinds == ["slo_burn", "slo_burn_clear"]
        assert _burn_events(events.LOG)[1]["reason"] == "tenant-evicted"
    elif case == "record_ring_bound":
        assert rep["tenants"]["t"]["jobs"] == 16
    elif case == "rendering":
        assert 'spgemm_slo_burn_active{slice="s0",tenant="t"} 1' in text
        assert "spgemm_slo_tenants_evicted_total 0" in text
    elif case == "master_knob_zero":
        assert rep["records"] == 0 and rep["tenants"] == {} and kinds == []


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_streams_are_judged_alike(seed, monkeypatch):
    """Five tenants over two slices against a cap of three, walls around
    the target, one error in ten, trace ids on every record, time moving
    unevenly across a 50 s window, reads between observations."""
    rng = np.random.default_rng(seed)
    ops, now = [], 1000.0
    for i in range(400):
        now += float(rng.exponential(0.5))
        if i % 17 == 0:
            ops.append(("read", now))
        ops.append(_obs(f"t{int(rng.integers(5))}", f"s{int(rng.integers(2))}",
                        float(rng.lognormal(0.0, 1.0)), float(rng.exponential(0.2)),
                        bool(rng.random() < 0.1), now, rng.bytes(16).hex()))
    ops.append(("read", now + 30.0))
    reads = _parity(ops, _arm(target="2", error_pct="5", window="50"), {"TENANT_RETAIN": 3},
                    monkeypatch)
    assert any(r[0]["burn_active"] for r in reads)  # the stream burns somewhere
    assert reads[-1][0]["tenants_evicted"] > 0


def test_concurrent_records_and_reads_lose_nothing(monkeypatch):
    """More threads than cores observe and read at once, with a short
    switch interval: every record is counted once."""
    import sys
    import threading

    monkeypatch.setattr(slo, "RECORD_RETAIN", 100_000)
    eng = slo.SloEngine()
    n_threads, per = 16, 300

    def work(t):
        for i in range(per):
            eng.observe(f"t{t % 4}", f"s{t % 2}", 0.01 * (i % 7), 0.0, i % 11 == 0,
                        now=1000.0 + i * 1e-3)
            if i % 50 == 0:
                eng.report(now=1000.5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    rep = eng.report(now=1001.0)
    assert rep["records"] == n_threads * per
    assert sum(row["jobs"] for row in rep["tenants"].values()) == n_threads * per
