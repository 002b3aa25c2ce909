"""The benchmark's harness: one cell, one seed, one run.

A cell (BENCHMARK.json `workloads`) names a configuration
(configs/<name>.json: the structure, the backend, the program's knobs, the
reference) and a traffic mix (traffic/<name>.json: the parameters of its
loop and of its requests).  Everything of one configuration, mix or metric
lives in files of its own, found by name:

  configs/<config>.json        structure, backend, env, reference
  structures/<kind>.py         build(params) -> the leaves' coordinates
  traffic/<traffic>.json       names its `loop` and its `request`, with their parameters
  loops/<loop>.py              run(driver, seed, seconds, reservoir, spans) -> Loop
  requests/<request>.py        make(config, mix, device) -> the inputs;
                               call(inputs, device, backend) -> the results
  reference/<reference>.py     chain_product(leaves) -> (coords, tiles)
  e2e/<metric>.py              read(Window) -> float
  metrics/<metric>.py          read(Record) -> float | None

A metric whose name holds a dot (`chain_s.batch`) is read by the module of
the part before it (`e2e/chain_s.py`): one quantity, split by the cells that
report it.  Set-up warms every shape with requests of the cell's own mix,
so the window runs on warm plans and built kernels.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from importlib.util import module_from_spec, spec_from_file_location
from pathlib import Path

from portbench import check, devtrace, roofline

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "spgemm_tpu")
WARM_REQUESTS = 2
WARM_BASE = 1 << 62  # request indices of the warm-up draws, apart from the window's
# the caches a run may write besides the port's own build/ directories, at
# fixed paths in the checkout
CACHES = {"SPGEMM_TPU_CROSSOVER_CACHE": "build/portbench/crossover"}
TRACE_ENV = {"SPGEMM_TPU_OBS_RING_CAP": "2000000"}  # the window's spans all kept


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    units: dict


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: Path | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration and mix
    loaded, and the metrics it reports."""
    bench = json.loads((bench_path or CHECKOUT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json "
                         f"(has {', '.join(sorted(cells))})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((CHECKOUT / conf["file"]).read_text())
    traffic = json.loads((ROOT / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic,
                [m["name"] for m in bench["end_to_end"] if _applies(m, name)],
                [m["name"] for m in bench["per_layer"] if _applies(m, name)],
                {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]})


def program_env(config: dict, trace: bool) -> dict:
    """The environment the program runs under: the configuration's knobs,
    the caches inside the checkout, and for a traced run a span ring that
    holds the whole window."""
    env = {k: str(v["value"]) for k, v in config.get("env", {}).items()}
    env.update({k: str(CHECKOUT / v) for k, v in CACHES.items()})
    if trace:
        env.update(TRACE_ENV)
    return env


def _module(kind: str, name: str):
    """ROOT/kind/<name up to its first dot>.py, loaded from its path."""
    stem = name.split(".")[0]
    spec = spec_from_file_location(f"portbench.{kind}.{stem.replace('-', '_')}",
                                   ROOT / kind / f"{stem}.py")
    mod = module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules of JAX, Flax or the JAX package, by whole top-level
    name (the port's name begins with the JAX package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def process_start_epoch() -> float:
    """When this process started, in epoch seconds (to 10 ms, from /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    """What the untraced run's end-to-end metrics read."""

    seconds: float
    chains: int
    latencies: list
    setup_s: float
    peak_bytes: int
    extra: dict = field(default_factory=dict)  # a loop's own readings


@dataclass
class Record:
    """What the traced run's per-layer metrics read: the window on the
    profiler's clock, ENGINE's phase and counter deltas over it, the
    device's operations, the main thread's host spans (the program's and
    the harness's), and the Work of one chain."""

    chains: int
    window_ns: tuple
    phases: dict
    counters: dict
    device_ops: list
    work: roofline.Work | None
    host_spans: list = field(default_factory=list)  # (name, start_ns, end_ns)
    extra: dict = field(default_factory=dict)  # a loop's own readings


@dataclass
class Loop:
    """One window's requests."""

    start: float = 0.0
    end: float = 0.0
    attempted: int = 0
    completed: int = 0
    failed: int = 0
    latencies: list = field(default_factory=list)
    spans: list = field(default_factory=list)  # (name, perf_counter s, perf_counter s)
    extra: dict = field(default_factory=dict)  # a loop's own readings, for its metrics


class Driver:
    """A cell's traffic: its mix's request (requests/<request>.py) over the
    configuration, driven by the mix's loop (loops/<loop>.py)."""

    def __init__(self, cell: Cell, device, backend: str | None = None):
        self.cell = cell
        self.device = device
        self.backend = backend or cell.config["backend"]
        self.mix = cell.traffic
        self._loop = _module("loops", self.mix["loop"])
        self._request = _module("requests", self.mix["request"])
        self.inputs = self._request.make(cell.config, self.mix, device)
        self.jobs = self.inputs.jobs  # chains a request completes

    def draw(self, seed: int, request: int) -> None:
        """Make request `request`'s inputs from the seed."""
        self.inputs.draw(seed, request)

    def request(self) -> list:
        """One call into the program over the drawn inputs; the results as
        [(coords, tiles without the sentinel)], one a chain."""
        return self._request.call(self.inputs, self.device, self.backend)

    def warm(self, seed: int) -> None:
        for i in range(WARM_REQUESTS):
            self.draw(seed, WARM_BASE + i)
            self.request()
            sync(self.device)

    def window(self, seed: int, seconds: float, reservoir: check.Reservoir,
               spans: bool = False) -> Loop:
        """The mix's loop for `seconds`; each completed request offered to
        the reservoir."""
        return self._loop.run(self, seed, seconds, reservoir, spans)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, started: float,
        backend: str | None = None) -> tuple[dict, list[str]]:
    """One run of the cell: set-up, the window, the check.  Returns the
    result line's object and the lines for standard error, the check's
    last.  `started` is the process's start in epoch seconds."""
    import torch
    from spgemm_tpu_torch.obs import trace as obs_trace
    from spgemm_tpu_torch.ops import plancache
    from spgemm_tpu_torch.utils.timers import ENGINE

    cuda = device.type == "cuda"
    with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
        driver = Driver(cell, device, backend)
        driver.warm(seed)
        reservoir = check.Reservoir(seed)
        capture = devtrace.Capture(device) if trace else None
        if capture is not None:
            capture.start()
        sync(device)
        phases0, counters0 = ENGINE.snapshot(), ENGINE.counter_snapshot()
        obs_trace.RECORDER.clear()
        offset = devtrace.clock_offset_ns()
        setup_s = time.time() - started
        loop = driver.window(seed, seconds, reservoir, spans=trace)
        if capture is not None:
            capture.stop()
        phases1, counters1 = ENGINE.snapshot(), ENGINE.counter_snapshot()
        recorded = obs_trace.RECORDER.snapshot() if trace else []
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    chains = loop.completed * driver.jobs
    result = {"correct": False, "attempted": loop.attempted, "failed": loop.failed,
              "metrics": {}, "device": device_info(device, cell.chips, peak)}
    if trace:
        lo = int(loop.start * 1e9) + offset
        hi = int(loop.end * 1e9) + offset
        ops, kinds = capture.device_ops()
        print(f"portbench: traced {len(ops)} device ops; activity types {kinds}", file=sys.stderr)
        host = [(n, int(s * 1e9) + offset, int(e * 1e9) + offset) for n, s, e in loop.spans]
        host += devtrace.recorder_spans(recorded, obs_trace.wall_origin_us(),
                                        threading.main_thread().ident)
        rec = Record(chains, (lo, hi),
                     {k: v - phases0.get(k, 0.0) for k, v in phases1.items()},
                     {k: v - counters0.get(k, 0) for k, v in counters1.items()},
                     ops, driver.inputs.work(), host, loop.extra)
        for name in cell.per_layer:
            value = _module("metrics", name).read(rec)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": cell.units[name]}
        result["device"]["busy_s"] = devtrace.busy_ns(ops, lo, hi) / 1e9
        result["device"]["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = devtrace.breakdown(ops, host, lo, hi)
    elif loop.completed:
        win = Window(loop.end - loop.start, chains, loop.latencies, setup_s, peak, loop.extra)
        for name in cell.end_to_end:
            result["metrics"][name] = {"value": _module("e2e", name).read(win),
                                       "unit": cell.units[name]}
    # the program's state goes before the reference runs: only the sampled
    # request's results stay on the device
    plancache.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    results = reservoir.results
    if results is not None:
        driver.draw(seed, reservoir.request)
    numbers = check.judge(cell.config, driver.inputs, results, loop.failed)
    result["correct"] = check.passed(numbers) and loop.completed > 0
    result["checks"] = {name: {"value": numbers[name], "limit": limit}
                        for name, limit in check.LIMITS.items()}
    return result, [host_line(phases0, phases1, chains)] + check.lines(numbers)


def host_line(before: dict, after: dict, chains: int) -> str:
    """The program's ENGINE phases over the window, host milliseconds a
    chain, all threads (a phase of the plan-ahead worker runs beside the
    main thread's): what a run-to-run spread on the host's clock is read
    against."""
    per = {k: (v - before.get(k, 0.0)) * 1e3 / max(chains, 1) for k, v in after.items()}
    return "portbench: host ms a chain: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(per.items()) if v >= 0.0005)


def device_info(device, count: int, peak: int) -> dict:
    import torch
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": count, "memory_peak_bytes": peak}

