"""The port's obs layer (spgemm_tpu_torch/obs/) against the JAX package's
spgemm_tpu/obs/, on the CPU: the flight recorder (ring bound and drops, the
knob off, nesting, tags, instants, the Perfetto export), the metrics
renderer (the same text as the JAX renderer on the same samples for every
family both registries declare), the event kinds (each a JAX kind), the
ENGINE names the port's source passes (every literal declared, found by an
AST scan), follow_file through a rotation and a restart, trace and event
files read across the packages in both directions, the obs knobs, and the
timers' spans and attribution tokens.  Tolerance: equality everywhere."""

import ast
import json
import os
import threading

import pytest

from spgemm_tpu.obs import events as jax_events
from spgemm_tpu.obs import metrics as jax_metrics
from spgemm_tpu.obs import trace as jax_trace
from spgemm_tpu.utils import knobs as jax_knobs
from spgemm_tpu_torch.obs import events, metrics, trace
from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.timers import ENGINE, PhaseTimers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "spgemm_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for name in ("SPGEMM_TPU_OBS_TRACE", "SPGEMM_TPU_OBS_RING_CAP", "SPGEMM_TPU_OBS_EVENTS",
                 "SPGEMM_TPU_OBS_EVENTS_MAX_KB"):
        monkeypatch.delenv(name, raising=False)
    trace.RECORDER.clear()
    events.LOG.clear()
    yield
    trace.RECORDER.clear()
    events.LOG.clear()


# ------------------------------------------------------------------ knobs --
@pytest.mark.parametrize("name, values", [
    ("SPGEMM_TPU_OBS_TRACE", (None, "0", "1", "2", " 1 ", "")),
    ("SPGEMM_TPU_OBS_RING_CAP", (None, "1", "4096", "0", "-3", "x")),
    ("SPGEMM_TPU_OBS_EVENTS", (None, "0", "1", "yes")),
    ("SPGEMM_TPU_OBS_EVENTS_MAX_KB", (None, "1", "256", "0", "1.5")),
])
def test_obs_knobs_parse_like_jax(name, values, monkeypatch):
    assert knobs.REGISTRY[name].default == jax_knobs.REGISTRY[name].default
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


# -------------------------------------------------------- flight recorder --
def _names(spans):
    return [s["name"] for s in spans]


def test_the_ring_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_OBS_RING_CAP", "5")
    for i in range(12):
        trace.RECORDER.end(trace.RECORDER.begin(f"s{i}"))
    st = trace.RECORDER.stats()
    assert st == {"spans": 5, "emitted": 12, "dropped": 7, "capacity": 5, "enabled": True}
    assert _names(trace.RECORDER.snapshot()) == [f"s{i}" for i in range(7, 12)]


def test_the_knob_off_emits_nothing_and_the_timers_still_count(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_OBS_TRACE", "0")
    t = PhaseTimers()
    with t.phase("plan"):
        pass
    t.record("plan_wait", 0.25)
    trace.RECORDER.instant("serve_reap")
    assert trace.RECORDER.snapshot() == [] and trace.RECORDER.stats()["emitted"] == 0
    assert t.counts == {"plan": 1, "plan_wait": 1}
    assert t.snapshot()["plan_wait"] == 0.25


def test_phases_nest_and_carry_their_tags():
    t = PhaseTimers()
    with trace.RECORDER.tagged(job_id="job-1", trace_id="a" * 32, slice="s0", batch_id=None):
        with t.phase("serve_execute"):
            with t.phase("upload"):
                pass
            t.record("plan_wait", 0.001)
    with t.phase("warm_flush"):
        pass
    spans = {s["name"]: s for s in trace.RECORDER.snapshot()}
    outer = spans["serve_execute"]
    assert spans["upload"]["parent"] == outer["id"]
    assert spans["plan_wait"]["parent"] == outer["id"] and spans["plan_wait"]["dur"] == 1000.0
    assert outer["parent"] is None
    for name in ("serve_execute", "upload", "plan_wait"):
        assert spans[name]["tags"] == {"job_id": "job-1", "trace_id": "a" * 32, "slice": "s0"}
    assert "tags" not in spans["warm_flush"]  # the tags ended with their block
    assert spans["upload"]["ts"] >= outer["ts"]
    assert spans["upload"]["ts"] + spans["upload"]["dur"] <= outer["ts"] + outer["dur"] + 1e-3


def test_tags_nest_and_restore_as_in_the_jax_recorder():
    for rec in (trace.RECORDER, jax_trace.RECORDER):
        with rec.tagged(job_id="j1", slice="s"):
            with rec.tagged(job_id="j2", trace_id=None):
                inner = rec.current_tags()
            outer = rec.current_tags()
        assert (inner, outer, rec.current_tags()) == (
            {"job_id": "j2", "slice": "s"}, {"job_id": "j1", "slice": "s"}, {})


def test_instants_are_zero_length_markers():
    trace.RECORDER.instant("serve_degrade", job_id=None, slice="s0")
    (span,) = trace.RECORDER.snapshot()
    assert span["ph"] == "i" and span["dur"] == 0.0 and span["tags"] == {"slice": "s0"}


def test_the_perfetto_export_is_the_jax_format(tmp_path):
    t = PhaseTimers()
    with trace.RECORDER.tagged(job_id="job-3"):
        with t.phase("serve_execute"):
            with t.phase("numeric_dispatch"):
                pass
    trace.RECORDER.instant("serve_reap", job_id="job-3")
    spans = trace.RECORDER.snapshot()
    mine = trace.to_trace_events(spans, process_name="port")
    theirs = jax_trace.to_trace_events(spans, process_name="port")
    # the wall-clock anchors differ (each module's own origin); nothing else

    def strip(evs):
        return [e for e in evs if e["name"] != trace.CLOCK_ORIGIN_META]

    assert strip(mine) == strip(theirs)
    path = trace.dump_json(str(tmp_path / "sub" / "d.trace.json"), spans)
    loaded = json.load(open(path))
    assert {e["ph"] for e in loaded} == {"M", "X", "i"}
    x = [e for e in loaded if e["ph"] == "X"]
    assert all(e["cat"] == "spgemm" and "dur" in e and e["args"]["job_id"] == "job-3" for e in x)
    assert not os.path.exists(path + ".tmp")


def test_the_timers_attribution_token_carries_scopes_and_tags():
    t = PhaseTimers()
    with trace.RECORDER.tagged(job_id="job-42", trace_id="b" * 32):
        scope = t.scope()
        token = t.attribution()

    def worker():
        with t.attributed(token):
            with t.phase("plan"):
                pass
            t.incr("plan_cache_hits")
        with t.phase("plan"):  # after the block: neither the scope's nor tagged
            pass

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    scope.close()
    assert scope.counts == {"plan": 1} and scope.counter_snapshot() == {"plan_cache_hits": 1}
    plans = [s for s in trace.RECORDER.snapshot() if s["name"] == "plan"]
    assert [s.get("tags") for s in plans] == [{"job_id": "job-42", "trace_id": "b" * 32}, None]
    assert t.count_snapshot() == {"plan": 2}


# ---------------------------------------------------------------- metrics --
def _shared_samples() -> list:
    """One sample (or two) of every family both registries declare."""
    hist = {"buckets": {0.1: 1, 1.0: 2, 10.0: 3, 60.0: 3, 600.0: 3, 3600.0: 3}, "sum": 4.5,
            "count": 3}
    out = []
    for name, m in metrics.REGISTRY.items():
        labels = {label: f'v"{i}\\\n' for i, label in enumerate(m.labels)}
        if m.kind == "histogram":
            value = hist
        elif m.kind == "gauge":
            value = 0.1 + len(name) / 7
        else:
            value = len(name)
        out.append((name, labels, value))
        if m.labels:  # a second series; a histogram's value stays a histogram
            out.append((name, {label: "b" for label in m.labels},
                        value if m.kind == "histogram" else 3))
    return out


def test_every_port_family_is_a_jax_family_with_its_declaration():
    for name, m in metrics.REGISTRY.items():
        j = jax_metrics.REGISTRY[name]
        assert (j.kind, j.doc, j.module, j.labels) == (m.kind, m.doc, m.module, m.labels), name


def test_render_gives_the_jax_text_on_shared_families():
    samples = _shared_samples()
    assert metrics.render(samples) == jax_metrics.render(samples)
    assert metrics.render([]) == jax_metrics.render([]) == "\n"


def test_render_refuses_undeclared_families_and_wrong_labels():
    with pytest.raises(ValueError, match="undeclared metric"):
        metrics.render([("spgemm_no_such_family", {"backend": "b"}, 1)])
    with pytest.raises(ValueError, match="declares labels"):
        metrics.render([("spgemm_slice_busy", {}, 1)])
    assert metrics.escape_label('a"b\\c\nd') == jax_metrics.escape_label('a"b\\c\nd')
    assert metrics.escape_help("x\\y\nz") == jax_metrics.escape_help("x\\y\nz")


def test_collect_engine_renders_the_engine_state(monkeypatch):
    ENGINE.incr("launches_numeric_round", 2)
    with ENGINE.phase("upload"):
        pass
    events.emit("daemon_start")
    text = metrics.render(metrics.collect_engine())
    assert 'spgemm_engine_events_total{event="launches_numeric_round"}' in text
    assert 'spgemm_phase_entries_total{phase="upload"}' in text
    assert "spgemm_trace_spans_emitted_total" in text
    assert "spgemm_events_emitted_total 1" in text
    assert "spgemm_plan_cache_capacity 32" in text
    monkeypatch.setenv("SPGEMM_TPU_PLAN_CACHE_CAP", "0")
    assert "spgemm_plan_cache_capacity" not in metrics.render(metrics.collect_engine())


def test_the_metrics_table_lists_every_family_and_name():
    table = metrics.metrics_table_md()
    for name in (*metrics.REGISTRY, *metrics.ENGINE_PHASES, *metrics.ENGINE_COUNTERS):
        assert f"`{name}`" in table, name


def _engine_literals() -> list:
    """(file, line, method, names) of every ENGINE.phase/record/incr call in
    the port's source; names None where the first argument is not a string
    literal (or a conditional choice between literals)."""
    found = []
    for root, _, files in os.walk(PORT):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(root, fname)
            tree = ast.parse(open(path, encoding="utf-8").read(), path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("phase", "record", "incr")
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "ENGINE" and node.args):
                    continue
                arg = node.args[0]
                choices = [arg.body, arg.orelse] if isinstance(arg, ast.IfExp) else [arg]
                names = [c.value for c in choices
                         if isinstance(c, ast.Constant) and isinstance(c.value, str)]
                found.append((os.path.relpath(path, REPO), node.lineno, node.func.attr,
                              names if len(names) == len(choices) else None))
    return found


def test_every_engine_name_in_the_port_is_declared():
    found = _engine_literals()
    assert len(found) > 40  # the scan sees the package
    bad = []
    for path, line, method, names in found:
        table = metrics.ENGINE_COUNTERS if method == "incr" else metrics.ENGINE_PHASES
        if names is None or any(n not in table for n in names):
            bad.append((path, line, method, names))
    assert not bad, bad
    used = {n for *_, names in found for n in names}
    # and every declared name is used somewhere (serve_queue_wait goes
    # through a PhaseScope's own record)
    assert set(metrics.ENGINE_PHASES) - used == {"serve_queue_wait"}
    assert set(metrics.ENGINE_COUNTERS) - used == set(), set(metrics.ENGINE_COUNTERS) - used


def test_the_scan_catches_an_undeclared_name(tmp_path, monkeypatch):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "m.py").write_text('ENGINE.incr("not_a_counter")\nENGINE.phase(name)\n')
    monkeypatch.setattr(__import__(__name__), "PORT", str(pkg))
    found = _engine_literals()
    assert [(m, n) for _, _, m, n in found] == [("incr", ["not_a_counter"]), ("phase", None)]


# ----------------------------------------------------------------- events --
def test_every_port_event_kind_is_a_jax_kind():
    assert set(events.EVENT_KINDS) <= set(jax_events.EVENT_KINDS)
    table = events.event_table_md()
    assert all(f"`{k}`" in table for k in events.EVENT_KINDS)


def test_every_emitted_kind_is_declared_and_every_declared_kind_emitted():
    emitted = set()
    for root, _, files in os.walk(PORT):
        for fname in files:
            path = os.path.join(root, fname)
            if not fname.endswith(".py") or path == events.__file__:  # emit() itself
                continue
            for node in ast.walk(ast.parse(open(path, encoding="utf-8").read(), path)):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "emit" and node.args:
                    arg = node.args[0]
                    assert isinstance(arg, ast.Constant), (path, node.lineno)
                    emitted.add(arg.value)
    assert emitted == set(events.EVENT_KINDS)


def test_an_event_carries_seq_time_and_the_threads_tags():
    with trace.RECORDER.tagged(job_id="job-7", trace_id="c" * 32):
        events.emit("job_start", folder="/f", batch_id=None, job_id="job-8")
    (rec,) = events.LOG.tail(5)
    assert rec["seq"] == 1 and rec["kind"] == "job_start" and rec["folder"] == "/f"
    assert rec["job_id"] == "job-8" and rec["trace_id"] == "c" * 32  # explicit wins
    assert "batch_id" not in rec and rec["mono_us"] > 0 and rec["ts"] > 0


def test_the_knob_off_emits_no_event(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_OBS_EVENTS", "0")
    events.emit("job_done", job_id="x")
    assert events.LOG.tail(5) == [] and events.LOG.stats()["emitted"] == 0


def test_the_event_file_rotates_at_its_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_OBS_EVENTS_MAX_KB", "1")
    log = events.EventLog()
    path = str(tmp_path / "e.jsonl")
    log.configure(path)
    for i in range(40):
        log.emit("job_submit", job_id=f"job-{i}", folder="x" * 40)
    assert log.flush(10.0)
    st = log.stats()
    assert st["rotations"] >= 1 and st["emitted"] == 40 and st["write_errors"] == 0
    assert os.path.getsize(path) <= 1024 and os.path.exists(path + ".1")
    seqs = [json.loads(line)["seq"] for p in (path + ".1", path) for line in open(p)]
    assert seqs == sorted(seqs) and seqs[-1] == 40
    log.configure(None)


def _write(path, recs):
    with open(path, "a", encoding="utf-8") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def test_follow_file_survives_a_rotation(tmp_path):
    path = str(tmp_path / "e.jsonl")
    _write(path, [{"seq": i, "kind": "a"} for i in range(1, 4)])
    gen = events.follow_file(path, last_seq=0, poll_s=0.01)
    assert [next(gen)["seq"] for _ in range(3)] == [1, 2, 3]
    _write(path, [{"seq": 4}, {"seq": 5}])
    os.replace(path, path + ".1")
    _write(path, [{"seq": 6, "pad": "x" * 200}, {"seq": 7}])  # past the old offset
    assert [next(gen)["seq"] for _ in range(4)] == [4, 5, 6, 7]


def test_follow_file_survives_a_restart(tmp_path):
    path = str(tmp_path / "e.jsonl")
    _write(path, [{"seq": i, "ts": 1000.0 + i} for i in range(1, 4)])
    gen = events.follow_file(path, last_seq=2, last_ts=1002.0, poll_s=0.01)
    assert next(gen)["seq"] == 3
    _write(path, [{"seq": i, "ts": 2000.0 + i} for i in range(1, 3)])  # seq starts again
    assert [(r["seq"], r["ts"]) for r in (next(gen), next(gen))] == [(1, 2001.0), (2, 2002.0)]


def test_read_records_leaves_a_torn_tail(tmp_path):
    path = str(tmp_path / "e.jsonl")
    with open(path, "w") as f:
        f.write('{"seq": 1}\n{"seq": 2')
    off, recs = events._read_records(path, 0)
    assert recs == [{"seq": 1}] and off == len('{"seq": 1}\n')


# ------------------------------------------------------- across packages --
def test_event_files_read_across_the_packages(tmp_path):
    port_path, jax_path = str(tmp_path / "port.jsonl"), str(tmp_path / "jax.jsonl")
    port_log, jax_log = events.EventLog(), jax_events.EventLog()
    port_log.configure(port_path)
    jax_log.configure(jax_path)
    for log in (port_log, jax_log):
        for i in range(3):
            log.emit("job_done", job_id=f"job-{i}")
        assert log.flush(10.0)
    stop = threading.Event()
    for reader, path in ((jax_events, port_path), (events, jax_path)):
        got = []
        for rec in reader.follow_file(path, poll_s=0.01, stop=stop.is_set):
            got.append(rec)
            if len(got) == 3:
                break
        assert [(r["seq"], r["kind"], r["job_id"]) for r in got] == \
            [(i + 1, "job_done", f"job-{i}") for i in range(3)]
    port_log.configure(None)
    jax_log.configure(None)


def test_trace_files_merge_across_the_packages(tmp_path):
    t = PhaseTimers()
    with trace.RECORDER.tagged(trace_id="d" * 32):
        with t.phase("serve_execute"):
            pass
    port_dump = trace.dump_json(str(tmp_path / "port.trace.json"), process_name="port")
    with jax_trace.RECORDER.tagged(trace_id="d" * 32):
        jax_trace.RECORDER.end(jax_trace.RECORDER.begin("serve_execute"))
    jax_dump = jax_trace.dump_json(str(tmp_path / "jax.trace.json"), process_name="jax")
    paths = [port_dump, jax_dump]
    mine = trace.merge_trace_files(paths, trace_id="d" * 32)
    theirs = jax_trace.merge_trace_files(paths, trace_id="d" * 32)
    assert mine == theirs
    spans = [e for e in mine if e["ph"] == "X"]
    assert len(spans) == 2 and len({e["pid"] for e in spans}) == 2  # one track each
    names = {e["pid"]: e["args"]["name"] for e in mine if e["name"] == "process_name"}
    assert sorted(names[e["pid"]] for e in spans) == ["jax", "port"]
