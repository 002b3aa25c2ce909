"""The traced run's device record: torch.profiler over the measured window,
reduced to device operations, the card's busy time, its idle gaps and what
the host was doing in each.

Only CUDA activity is traced (kernels, copies, fills): no CPU operator is
recorded, so the host pays for the trace little beyond CUPTI's callbacks.
Host activity comes from spans instead: the harness's own (`portbench.*`,
around the draw, the call into the program and the wait for the card) and
the program's ENGINE phases from its flight recorder (main thread only).
All times are put on the profiler's clock, nanoseconds since the epoch.
"""

from __future__ import annotations

import time
from collections import defaultdict

TOP = 10  # entries of each breakdown list


class Capture:
    """torch.profiler started and stopped around the window: CUDA activity
    only on a card; on the CPU (a rehearsal of the harness, never a
    measurement) the CPU operators stand in for the device's."""

    def __init__(self, device):
        self._cuda = device.type == "cuda"
        self._prof = None

    def start(self) -> None:
        import torch
        act = torch.profiler.ProfilerActivity
        self._prof = torch.profiler.profile(activities=[act.CUDA if self._cuda else act.CPU])
        self._prof.__enter__()

    def stop(self) -> None:
        self._prof.__exit__(None, None, None)

    def device_ops(self) -> tuple[list, dict]:
        """([(name, start_ns, end_ns)] of every operation that ran on the
        device, {activity type: count} of everything traced)."""
        ops, kinds = [], defaultdict(int)
        for e in self._prof.profiler.kineto_results.events():
            kind = kind_of(e)
            kinds[kind] += 1
            on_device = (str(e.device_type()).endswith("CUDA") if self._cuda
                         else kind == "cpu_op")
            if on_device and "annotation" not in kind and e.duration_ns() > 0:
                ops.append((short_name(e.name()), e.start_ns(), e.start_ns() + e.duration_ns()))
        return ops, dict(kinds)


def kind_of(event) -> str:
    """An event's activity type ("kernel", "gpu_memcpy", "cpu_op", ...);
    where this torch has no activity_type() (2.11), "annotation" for a user
    annotation, else the device type."""
    if hasattr(event, "activity_type"):
        return str(event.activity_type())
    if getattr(event, "is_user_annotation", lambda: False)():
        return "annotation"
    return str(event.device_type())


def short_name(name: str) -> str:
    """A kernel's name without its argument list or anonymous namespaces
    ("void (anonymous namespace)::numeric_round_kernel<false, false>(...)"
    -> "void numeric_round_kernel<false, false>")."""
    bare = name.replace("(anonymous namespace)::", "")
    cut = bare.find("(")
    return (bare[:cut] if cut > 0 else bare).strip()


def clock_offset_ns() -> int:
    """Epoch ns minus perf_counter ns, now: adds to a perf_counter reading
    to put it on the profiler's clock."""
    return time.time_ns() - time.perf_counter_ns()


def merged(ops: list, lo: int, hi: int) -> list[tuple[int, int]]:
    """The union of the operations' intervals, clipped to [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in ops)
    out: list[list[int]] = []
    for s, e in spans:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_ns(ops: list, lo: int, hi: int) -> int:
    return sum(e - s for s, e in merged(ops, lo, hi))


def gaps(ops: list, lo: int, hi: int) -> list[tuple[int, int]]:
    """The intervals of [lo, hi] in which nothing ran on the device."""
    out, at = [], lo
    for s, e in merged(ops, lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def doing(spans: list, times: list[int]) -> list[str]:
    """For each of the sorted times, the innermost host span [(name,
    start_ns, end_ns)] open then; the spans nest, as one thread's do."""
    order = sorted(spans, key=lambda x: (x[1], -x[2]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(order) and order[i][1] <= t:
            stack.append(order[i])
            i += 1
            while len(stack) > 1 and stack[-2][2] <= stack[-1][1]:
                stack.pop(-2)  # a closed span under a newer one
        while stack and stack[-1][2] <= t:
            stack.pop()
        out.append(stack[-1][0] if stack else "portbench.between")
    return out


def breakdown(ops: list, spans: list, lo: int, hi: int) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing at each gap's middle; seconds, TOP of each."""
    by_op: dict[str, float] = defaultdict(float)
    for name, s, e in ops:
        if e > lo and s < hi:
            by_op[name] += (min(e, hi) - max(s, lo)) / 1e9
    idle = gaps(ops, lo, hi)
    by_host: dict[str, float] = defaultdict(float)
    for (s, e), name in zip(idle, doing(spans, [(s + e) // 2 for s, e in idle])):
        by_host[name] += (e - s) / 1e9

    def top(d: dict) -> list:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}


def recorder_spans(snapshot: list[dict], origin_us: float, tid: int) -> list:
    """The program's flight-recorder spans of thread tid, on the profiler's
    clock: ts and dur are microseconds since the recorder's origin, which
    lies at origin_us since the epoch."""
    out = []
    for sp in snapshot:
        if sp.get("tid") != tid or sp.get("ph") != "X":
            continue
        s = int((origin_us + sp["ts"]) * 1e3)
        out.append((sp["name"], s, s + int(sp["dur"] * 1e3)))
    return out
