"""Each metric module on a small recorded trace, and the trace's reduction."""

import pytest
from _tiny import REPO  # noqa: F401  (puts the checkout on sys.path)

from portbench import devtrace, harness, roofline

K1 = "void numeric_round_kernel<false, false>"
DENSE = "void numeric_round_kernel<false, true>"
MS = 1_000_000  # ns


def _record(**over):
    rec = harness.Record(
        chains=2, window_ns=(0, 100 * MS),
        phases={"plan": 0.004, "plan_wait": 0.002, "upload": 0.5},
        counters={"launches_numeric_round": 140, "launches_dense_fold": 8,
                  "plan_cache_hits": 18},
        device_ops=[(K1, 5 * MS, 45 * MS), ("Memcpy HtoD (Pageable -> Device)", 40 * MS, 50 * MS),
                    (DENSE, 60 * MS, 70 * MS), (K1, 95 * MS, 120 * MS)],
        work=roofline.Work(pairs=1_000_000, bytes=10 ** 9, k=32),
        # the main thread: an inline plan (plan inside plan_wait), then a
        # wait for the plan-ahead worker, one plan_wait running past the window
        host_spans=[("portbench.request", 0, 90 * MS), ("plan_wait", 1 * MS, 4 * MS),
                    ("plan", 1 * MS, 4 * MS), ("upload", 4 * MS, 5 * MS),
                    ("plan_wait", 10 * MS, 12 * MS), ("plan_wait", 99 * MS, 103 * MS)])
    for key, value in over.items():
        setattr(rec, key, value)
    return rec


def _read(name, rec):
    return harness._module("metrics", name).read(rec)


def test_plan_ms():
    # (3 + 2 + 1) ms of the main thread held up by the planner, over 2 chains
    assert _read("plan_ms", _record()) == pytest.approx(3.0)
    assert _read("plan_ms", _record(host_spans=[("upload", 0, MS)])) is None
    assert _read("plan_ms", _record(chains=0)) is None


def test_plan_ms_counts_an_inline_plan_once():
    # chain_product plans a pass of one pair inline: ENGINE `plan` inside
    # `plan_wait` on the main thread; the sum of the two phases reads double
    inline = [("plan_wait", 0, 20 * MS), ("plan", 1 * MS, 19 * MS)]
    rec = _record(chains=1, host_spans=inline, phases={"plan": 0.018, "plan_wait": 0.020})
    assert _read("plan_ms", rec) == pytest.approx(20.0)
    assert (rec.phases["plan"] + rec.phases["plan_wait"]) * 1e3 == pytest.approx(38.0)


def test_plan_ms_reads_an_inline_plan_without_a_wait():
    # chain_products_batched plans on the main thread with no plan_wait
    rec = _record(chains=4, host_spans=[("plan", 0, 2 * MS), ("plan", 5 * MS, 7 * MS)])
    assert _read("plan_ms", rec) == pytest.approx(1.0)


def test_launches_per_chain():
    assert _read("launches_per_chain", _record()) == 74
    assert _read("launches_per_chain", _record(counters={"plan_cache_hits": 9})) is None


def test_fold_roofline_clips_kernels_to_the_window():
    # kernel time inside [0, 100 ms]: 40 + 10 + 5 = 55 ms
    least, bound = roofline.least_seconds(roofline.Work(2_000_000, 2 * 10 ** 9, 32))
    assert bound == "ops"
    assert _read("fold_roofline", _record()) == pytest.approx(least / 0.055 * 100)
    assert _read("fold_roofline", _record(device_ops=[("Memcpy", 0, MS)])) is None


def test_device_idle_is_one_minus_the_union():
    # busy: [5, 50] and [60, 70] and [95, 100] -> 60 ms of 100
    assert _read("device_idle", _record()) == pytest.approx(40.0)
    assert _read("device_idle", _record(device_ops=[])) is None


def test_every_metric_of_the_benchmark_has_a_module():
    import json
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert callable(harness._module("metrics", m["name"]).read)
    for m in bench["end_to_end"]:
        assert callable(harness._module("e2e", m["name"]).read)


def test_a_dotted_name_is_read_by_the_module_of_its_stem():
    assert harness._module("e2e", "chain_s.batch").__file__ == str(harness.ROOT / "e2e" / "chain_s.py")
    assert harness._module("metrics", "plan_ms.x").__file__ == str(harness.ROOT / "metrics" / "plan_ms.py")


def test_end_to_end_modules():
    win = harness.Window(seconds=10.0, chains=400,
                         latencies=[0.1 + i / 1000 for i in range(100)], setup_s=12.5,
                         peak_bytes=3 * 2 ** 30)
    read = lambda name: harness._module("e2e", name).read(win)  # noqa: E731
    assert read("chain_s") == pytest.approx(0.025)
    assert read("chain_p95_s") == pytest.approx(0.194)  # the 95th of 100, nearest rank
    assert read("device_peak_gib") == 3.0
    assert read("setup_s") == 12.5


def test_gaps_and_breakdown_name_the_host_span_at_each_gap():
    ops = [("k", 10, 20), ("k", 15, 30), ("c", 50, 60)]
    assert devtrace.merged(ops, 0, 100) == [(10, 30), (50, 60)]
    assert devtrace.busy_ns(ops, 0, 100) == 30
    assert devtrace.gaps(ops, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    spans = [("portbench.request", 0, 70), ("plan_wait", 2, 8), ("upload", 32, 48),
             ("portbench.wait", 70, 90)]
    out = devtrace.breakdown(ops, spans, 0, 100)
    assert out["device_ops"] == [["k", 25 / 1e9], ["c", 10 / 1e9]]  # each op its own time
    assert dict(out["idle_gaps"]) == {"upload": 20 / 1e9, "portbench.wait": 40 / 1e9,
                                      "plan_wait": 10 / 1e9}


def test_doing_takes_the_innermost_open_span():
    spans = [("a", 0, 100), ("b", 10, 20), ("c", 30, 60), ("d", 40, 50)]
    assert devtrace.doing(spans, [5, 15, 25, 35, 45, 55, 99, 150]) == [
        "a", "b", "a", "c", "d", "c", "a", "portbench.between"]


def test_recorder_spans_keep_one_thread_on_the_profiler_clock():
    snap = [{"name": "plan", "ph": "X", "ts": 10.0, "dur": 5.0, "tid": 1},
            {"name": "plan", "ph": "X", "ts": 10.0, "dur": 5.0, "tid": 2},
            {"name": "mark", "ph": "i", "ts": 1.0, "dur": 0.0, "tid": 1}]
    assert devtrace.recorder_spans(snap, 1000.0, 1) == [("plan", 1_010_000, 1_015_000)]


def test_short_name_drops_the_argument_list():
    assert devtrace.short_name(K1 + "(unsigned long const*, int)") == K1
    assert devtrace.short_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"
    # the names torch 2.11's profiler gives kernel 1 and the dense fold
    assert devtrace.short_name("void (anonymous namespace)::numeric_round_kernel<false, false>"
                               "(unsigned long const*, int)") == K1
    assert devtrace.short_name("void (anonymous namespace)::numeric_round_kernel<false, true>"
                               "(unsigned long const*)") == DENSE
    assert devtrace.short_name("void at::native::(anonymous namespace)::f<1>(int)") == \
        "void at::native::f<1>"


def test_kind_of_reads_events_with_and_without_activity_type():
    class New:
        def activity_type(self):
            return "kernel"

    class Old:
        def __init__(self, note):
            self.note = note

        def is_user_annotation(self):
            return self.note

        def device_type(self):
            return "DeviceType.CUDA"

    assert devtrace.kind_of(New()) == "kernel"
    assert devtrace.kind_of(Old(True)) == "annotation"
    assert devtrace.kind_of(Old(False)) == "DeviceType.CUDA"
