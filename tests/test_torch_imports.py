"""The PyTorch/CUDA port (spgemm_tpu_torch) and chip_smoke.py import neither
jax nor anything of the JAX package spgemm_tpu, checked in a fresh
interpreter that imports every port module; and the CLI module, the
daemon's client side (serve/client, protocol, queue, placement, and
serve/daemon before it runs, serve/obs_smoke, serve/chaos_smoke), the obs layer (obs/trace,
events, metrics, profile, slo, also in use), the autotuner (tune/, also
running a leg) and the fleet router (fleet/router, pricebook) import neither
torch nor numpy; the `knobs` and `tune` subcommands load no torch, and
`route` loads neither torch nor numpy.  The fleet's event kinds, metric
families and knobs are held to the JAX registries."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import importlib, pkgutil, sys
import spgemm_tpu_torch
names = [m.name for m in pkgutil.walk_packages(spgemm_tpu_torch.__path__,
                                               "spgemm_tpu_torch.")]
for name in names:
    importlib.import_module(name)
importlib.import_module("chip_smoke")
for name in ("cli", "ops.crossover", "ops.cuda_mxu", "ops.mxu_spgemm",
             "models.ffn", "ops.cuda_bsmm", "ops.cuda_bsmm_grad", "utils.native", "utils.knobs", "utils.mtx",
             "ops.plancache", "utils.checkpoint", "utils.backend_probe", "parallel",
             "parallel.chainpart", "ops.delta", "ops.estimate", "ops.warmstore",
             "ops.cuda_splice", "ops.cuda_dense", "utils.failpoints", "parallel.mesh",
             "serve", "serve.protocol", "serve.queue", "serve.placement", "serve.client",
             "serve.daemon", "serve.smoke", "serve.obs_smoke", "obs", "obs.trace", "obs.events",
             "obs.metrics", "obs.profile", "obs.slo", "tune", "tune.tuner", "fleet",
             "fleet.router", "fleet.pricebook", "fleet.fleet_smoke", "parallel.rowshard",
             "serve.chaos_smoke", "ops.cuda_field", "parallel.innershard", "parallel.ring",
             "parallel.multihost"):
    assert f"spgemm_tpu_torch.{name}" in names, names
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print(len(names))
"""


def test_port_imports_neither_jax_nor_spgemm_tpu():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 31  # every module was walked


_LIGHT_CHILD = """
import importlib, sys
importlib.import_module(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print("light")
"""


@pytest.mark.parametrize("module", ["spgemm_tpu_torch.cli",
                                    "spgemm_tpu_torch.serve.client",
                                    "spgemm_tpu_torch.serve.protocol",
                                    "spgemm_tpu_torch.serve.queue",
                                    "spgemm_tpu_torch.serve.placement",
                                    "spgemm_tpu_torch.serve.daemon",
                                    "spgemm_tpu_torch.obs",
                                    "spgemm_tpu_torch.obs.trace",
                                    "spgemm_tpu_torch.obs.events",
                                    "spgemm_tpu_torch.obs.metrics",
                                    "spgemm_tpu_torch.obs.profile",
                                    "spgemm_tpu_torch.obs.slo",
                                    "spgemm_tpu_torch.serve.obs_smoke",
                                    "spgemm_tpu_torch.tune",
                                    "spgemm_tpu_torch.tune.tuner",
                                    "spgemm_tpu_torch.fleet",
                                    "spgemm_tpu_torch.fleet.router",
                                    "spgemm_tpu_torch.fleet.pricebook",
                                    "spgemm_tpu_torch.fleet.fleet_smoke",
                                    "spgemm_tpu_torch.serve.chaos_smoke"])
def test_the_serve_front_loads_neither_torch_nor_numpy(module):
    """A submitting process must not pay the cold torch import the daemon
    exists to amortize; the daemon module loads the engine lazily."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _LIGHT_CHILD, module], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split() == ["light"], proc.stderr


_OBS_CHILD = """
import json, os, sys, tempfile
from spgemm_tpu_torch.obs import events, metrics, profile, slo, trace
from spgemm_tpu_torch.utils.timers import ENGINE
os.environ["SPGEMM_TPU_SLO_TARGET_S"] = "1"
d = tempfile.mkdtemp()
with trace.RECORDER.tagged(job_id="job-1"):
    with ENGINE.phase("serve_execute"):
        ENGINE.incr("launches_numeric_round")
        profile.observe_memory({"bytes_in_use": 5})
events.LOG.configure(os.path.join(d, "e.jsonl"))
events.emit("job_done", job_id="job-1")
profile.record_build("native", 0.1, False, "lib.so", None)
profile.observe_estimate(1, 2, 3, 1, 2, 4)
profile.observe_delta(2, 2, 10)
slo.SLO.observe("t", "s0", 5.0, 0.1, False, trace_id="ab" * 16)
assert slo.SLO.report()["burn_active"] == 1 and profile.memory_job_peak("job-1") == 5
assert events.LOG.flush(10.0)
text = metrics.render([("spgemm_engine_events_total", {"event": n}, v)
                       for n, v in ENGINE.counter_snapshot().items()]
                      + metrics._collect_profile() + slo.SLO.samples())
assert 'spgemm_phase_seconds_count{phase="serve_execute"} 1' in text
json.dumps(profile.report())
path = trace.dump_json(os.path.join(d, "t.trace.json"))
merged = trace.merge_trace_files([path])
rec = next(events.follow_file(os.path.join(d, "e.jsonl"), poll_s=0.01))
assert rec["kind"] == "job_done" and "launches_numeric_round" in text and merged
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print("obs")
"""


def test_the_obs_layer_in_use_loads_neither_torch_nor_numpy():
    """Spans, events, the profiling accounts, the SLO engine, a render, a
    dump, a merge and a follow: what a client process and the daemon's
    watchdog run."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _OBS_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "obs", proc.stderr


_TUNE_CHILD = """
import sys
from spgemm_tpu_torch.obs import events, metrics
from spgemm_tpu_torch.tune import TUNER, run_trial_leg, trial_vectors
from spgemm_tpu_torch.utils.timers import ENGINE
TUNER.note_job("ck@cpu", "cpu")
for _ in trial_vectors():
    assert run_trial_leg(lambda folder: "d0", lambda key: "/x", extra={"SPGEMM_TPU_DELTA": "0"})
assert TUNER.stats()["classes"][0]["state"] == "settled", TUNER.stats()
text = metrics.render(
    [("spgemm_phase_entries_total", {"phase": n}, c) for n, c in ENGINE.count_snapshot().items()]
    + [("spgemm_engine_events_total", {"event": n}, c)
       for n, c in ENGINE.counter_snapshot().items()])
assert 'spgemm_phase_entries_total{phase="tune_trial"} 4' in text, text
assert 'spgemm_engine_events_total{event="tune_trials"} 4' in text, text
assert [e["kind"] for e in events.LOG.tail(10)] == ["tune_trial"] * 4
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print("tune")
"""


def test_the_tuner_running_legs_loads_neither_torch_nor_numpy():
    """The tuner's state machine, a leg's bookkeeping and the scrape of its
    phase and counter: the daemon's idle tick pays no engine import until a
    leg's run_fn reads a chain."""
    # walls of an empty run_fn are noise: nothing may promote on them
    env = {**os.environ, "PYTHONPATH": REPO, "SPGEMM_TPU_TUNE_MIN_WIN": "1000"}
    proc = subprocess.run([sys.executable, "-c", _TUNE_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "tune", proc.stderr


_SUBCOMMAND_CHILD = """
import runpy, sys
sys.argv = ["spgemm_tpu_torch.cli", *sys.argv[1:]]
try:
    runpy.run_module("spgemm_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "spgemm_tpu"))
assert not bad, bad
print("no-torch", file=sys.stderr)
"""


@pytest.mark.parametrize("argv", [["knobs", "--json"], ["knobs"], ["tune", "--status", "--json"],
                                  ["tune"]])
def test_the_knobs_and_tune_subcommands_load_no_torch(argv, tmp_path):
    """`python -m spgemm_tpu_torch.cli knobs|tune ...` answers without the
    cold torch import (numpy reads the tune tier's entries)."""
    env = {**os.environ, "PYTHONPATH": REPO, "SPGEMM_TPU_WARM_DIR": str(tmp_path)}
    proc = subprocess.run([sys.executable, "-c", _SUBCOMMAND_CHILD, *argv], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stderr.split()[-1] == "no-torch", proc.stderr
    assert proc.stdout


_ROUTE_CHILD = """
import runpy, sys
sys.argv = ["spgemm_tpu_torch.cli", *sys.argv[1:]]
try:
    runpy.run_module("spgemm_tpu_torch.cli", run_name="__main__")
except SystemExit as e:
    print("exit", e.code, file=sys.stderr)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "numpy", "jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
assert "spgemm_tpu_torch.fleet.router" in sys.modules
print("light", file=sys.stderr)
"""


@pytest.mark.parametrize("argv, code", [(["route", "--help"], 0),
                                        (["route", "--backends", ""], 1)])
def test_the_route_subcommand_loads_neither_torch_nor_numpy(argv, code, tmp_path):
    """`python -m spgemm_tpu_torch.cli route` runs the router, which owns
    only sockets: neither torch nor numpy is loaded."""
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("SPGEMM_TPU_ROUTER_BACKENDS", None)
    proc = subprocess.run([sys.executable, "-c", _ROUTE_CHILD, *argv], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stderr.split()[-3:] == ["exit", str(code), "light"], \
        proc.stderr
    if code == 0:
        assert "--backends" in proc.stdout and "--listen" in proc.stdout


_FLEET_KINDS = ("router_start", "router_backend_down", "router_backend_up", "router_failover")
_FLEET_FAMILIES = ("spgemm_router_backend_up", "spgemm_router_backend_queue_depth",
                   "spgemm_router_jobs_total", "spgemm_router_failovers_total")


def test_the_fleet_kinds_and_families_are_the_jax_ones():
    from spgemm_tpu.obs import events as jax_events
    from spgemm_tpu.obs import metrics as jax_metrics
    from spgemm_tpu_torch.obs import events, metrics

    for kind in _FLEET_KINDS:
        assert kind in events.EVENT_KINDS and kind in jax_events.EVENT_KINDS
        assert events.EVENT_KINDS[kind] == jax_events.EVENT_KINDS[kind]
    for name in _FLEET_FAMILIES:
        m, j = metrics.REGISTRY[name], jax_metrics.REGISTRY[name]
        assert (m.kind, m.doc, m.module, m.labels) == (j.kind, j.doc, j.module, j.labels)
    samples = [(n, {"backend": "tcp:h:1"} if metrics.REGISTRY[n].labels else {}, 3)
               for n in _FLEET_FAMILIES]
    assert metrics.render(samples) == jax_metrics.render(samples)
    # every family of the JAX registry is now the port's too
    assert set(jax_metrics.REGISTRY) == set(metrics.REGISTRY)


@pytest.mark.parametrize("name, values", [
    ("SPGEMM_TPU_ROUTER_BACKENDS", (None, "", "tcp:127.0.0.1:1,/tmp/b.sock", "  x  ")),
    ("SPGEMM_TPU_ROUTER_POLL_S", (None, "", "2", "0.1", "0.05", "0", "-1", "x", " 0.5 ")),
])
def test_the_router_knobs_parse_like_jax(name, values, monkeypatch):
    from spgemm_tpu.utils import knobs as jax_knobs
    from spgemm_tpu_torch.utils import knobs

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


def test_the_package_data_ships_every_port_source():
    """An installed port builds its kernels (csrc/*.cu, which include
    csrc/*.cuh) and its host library (native/*.cpp) from sources it must
    carry."""
    import fnmatch
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    shipped = [f"{pkg.replace('.', '/')}/{pat}" for pkg, pats in data.items() for pat in pats]
    port = os.path.join(REPO, "spgemm_tpu_torch")
    sources = [f"spgemm_tpu_torch/{d}/{name}" for d in ("csrc", "native")
               for name in os.listdir(os.path.join(port, d))]
    assert sources and all(any(fnmatch.fnmatch(s, pat) for pat in shipped) for s in sources), \
        (sources, shipped)


_BATCH_CHILD = """
import os, sys, tempfile
import numpy as np
from spgemm_tpu_torch.ops import plancache
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.serve import placement
from spgemm_tpu_torch.serve.daemon import run_chain_jobs
from spgemm_tpu_torch.serve.queue import Job
from spgemm_tpu_torch.utils import io_text
from spgemm_tpu_torch.utils.gen import random_chain

mats = random_chain(3, 4, 2, 0.5, np.random.default_rng(1), "full")
dev = [DeviceBlockMatrix.from_host(m, "cpu") for m in mats[:2]]
p = engine.plan(*dev)
engine.execute_batched(p, [tuple(dev), tuple(dev)])
folder = tempfile.mkdtemp()
io_text.write_chain_dir(folder, mats, 2)
jobs = []
for i in range(2):
    job = Job(f"job-{i}", folder, os.path.join(folder, f"out{i}"), {})
    job.device = "cpu"
    job.group_key = "fp"
    jobs.append(job)
run_chain_jobs(jobs)
assert open(jobs[0].output, "rb").read() == open(jobs[1].output, "rb").read()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print("batched")
"""


def test_the_batched_path_imports_neither_jax_nor_spgemm_tpu():
    """The code cross-job batching runs (execute_batched, run_chain_jobs and
    what they load lazily) imports no jax and nothing of the JAX package."""
    env = {**os.environ, "PYTHONPATH": REPO, "SPGEMM_TPU_DELTA": "0"}
    proc = subprocess.run([sys.executable, "-c", _BATCH_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "batched", proc.stderr


_TRAIN_CHILD = """
import sys
import torch
from spgemm_tpu_torch.models import ffn
from spgemm_tpu_torch.parallel.mesh import train_mesh

cfg = ffn.BlockSparseFFNConfig(32, 64, 8, 0.5, "float32")
params = ffn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
x = torch.randn((2, 4, 32), generator=torch.Generator().manual_seed(1))
step = ffn.make_sharded_train_step(train_mesh(device="cpu"), cfg, block_m=8)
params, loss = step(params, x, x)
ffn.train_step_ref(params, x, x, cfg)
assert torch.isfinite(loss)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print("trained")
"""


def test_the_training_step_imports_neither_jax_nor_spgemm_tpu():
    """The FFN training step (models/ffn.make_sharded_train_step on a 1 x 1
    parallel/mesh.train_mesh, kernel 5's wrapper, the plain step) run on
    the CPU imports no jax and nothing of the JAX package."""
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", _TRAIN_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "trained", proc.stderr


_ROWSHARD_CHILD = """
import os, sys, tempfile
import numpy as np
from spgemm_tpu_torch.parallel.rowshard import spgemm_sharded
from spgemm_tpu_torch.serve import client
from spgemm_tpu_torch.serve.daemon import Daemon
from spgemm_tpu_torch.utils import io_text
from spgemm_tpu_torch.utils.gen import random_chain

mats = random_chain(3, 8, 2, 0.5, np.random.default_rng(1), "full")
spgemm_sharded(mats[0], mats[1], devices=["cpu"] * 3)
d = tempfile.mkdtemp()
io_text.write_chain_dir(os.path.join(d, "c"), mats, 2)
daemon = Daemon(os.path.join(d, "s.sock"), slices="1x2", device="cpu")
daemon.start()
try:
    j = client.submit(os.path.join(d, "c"), daemon.socket_path, {"output": os.path.join(d, "o")})
    job = client.wait(j["id"], daemon.socket_path, timeout=120)["job"]
    assert job["state"] == "done" and job["detail"]["rowshard_round"] > 0, job
finally:
    daemon.stop()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "spgemm_tpu"))
assert not bad, bad
print("sharded")
"""


def test_the_sharded_multiply_and_a_wide_slice_import_neither_jax_nor_spgemm_tpu():
    """parallel/rowshard and a daemon's wide slice running it on the CPU
    import no jax and nothing of the JAX package."""
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("SPGEMM_TPU_WARM_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _ROWSHARD_CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.split()[-1] == "sharded", proc.stderr
