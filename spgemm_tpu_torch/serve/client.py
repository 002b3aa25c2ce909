"""spgemmd client: library calls and the CLI's `submit`, `status`,
`metrics`, `events`, `trace-dump`, `profile` and `slo` (the port's copy of
the JAX package's `serve/client.py`).

Imports neither torch nor numpy: a submitting process must not pay the cold
torch import the daemon exists to amortize, and never touches the card (the
daemon owns it; a client owns only the socket).  Relative paths are made
absolute here, since the daemon's working directory is not the caller's.
A submit records a `client_submit` span in this process's flight recorder
under the job's trace id, so `trace-dump --merge` can stitch the client's
dump with the daemon's.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

from spgemm_tpu_torch.obs import events as obs_events
from spgemm_tpu_torch.obs import trace as obs_trace
from spgemm_tpu_torch.serve import protocol

# one server-side wait is bounded (Daemon.MAX_WAIT_SLICE_S), so wait() polls
# in slices, backing off between them from WAIT_BACKOFF_S to
# WAIT_BACKOFF_MAX_S
WAIT_SLICE_S = 15.0
WAIT_BACKOFF_S = 0.05
WAIT_BACKOFF_MAX_S = 2.0

# connect retry through a daemon restart: ECONNREFUSED and ENOENT retry with
# capped exponential backoff for at most CONNECT_RETRY_TOTAL_S, then a
# structured daemon-unavailable ServeError
CONNECT_BACKOFF_S = 0.05
CONNECT_BACKOFF_MAX_S = 1.0
CONNECT_RETRY_TOTAL_S = 5.0


class ServeError(Exception):
    """A structured error answer; carries the wire code."""

    def __init__(self, code: str, message: str):
        super().__init__(f"[{code}] {message}")
        self.code = code
        self.message = message


def _connect(path: str, timeout: float | None, retry_total_s: float) -> socket.socket:
    """Connect to the daemon at path (a socket path, `unix:PATH` or
    `tcp:HOST:PORT`), riding out a restart window."""
    parsed = protocol.parse_addr(path)
    deadline = time.time() + retry_total_s
    backoff = 0.0
    while True:
        if parsed[0] == "tcp":
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            target = (parsed[1], parsed[2])
        else:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            target = parsed[1]
        sock.settimeout(timeout)
        try:
            sock.connect(target)
        except (ConnectionRefusedError, ConnectionResetError, FileNotFoundError) as e:
            sock.close()
            now = time.time()
            if now >= deadline:
                raise ServeError(protocol.E_UNAVAILABLE,
                                 f"no daemon reachable at {path} after "
                                 f"{retry_total_s:g}s of connect retries ({e})") from e
            backoff = min(CONNECT_BACKOFF_MAX_S, backoff * 2 if backoff else CONNECT_BACKOFF_S)
            time.sleep(min(backoff, max(0.0, deadline - now)))
        except BaseException:
            sock.close()
            raise
        else:
            return sock


def request(msg: dict, socket_path: str | None = None, timeout: float | None = None,
            retry_total_s: float | None = None) -> dict:
    """One request, one answer; ServeError on an error answer.  The request
    carries protocol.version_for(msg); after an older daemon's
    version-mismatch answer it is sent once more at the best version both
    speak, with the newer fields stripped."""
    path = socket_path or protocol.default_addr()
    if retry_total_s is None:
        retry_total_s = CONNECT_RETRY_TOTAL_S
    version = protocol.version_for(msg)
    try:
        return _request_once(msg, version, path, timeout, retry_total_s)
    except ServeError as e:
        if e.code != protocol.E_BAD_REQUEST:
            raise
        accepted = protocol.accepted_from_error(e.message)
        best = max((a for a in accepted if a in protocol.ACCEPTED_VERSIONS and a < version),
                   default=None)
        if best is None:
            raise
        return _request_once(protocol.strip_for_version(msg, best), best, path, timeout,
                             retry_total_s)


def _request_once(msg: dict, version: int, path: str, timeout: float | None,
                  retry_total_s: float) -> dict:
    with _connect(path, timeout, retry_total_s) as sock:
        sock.sendall(protocol.encode({"v": version, **msg}))
        for line in protocol.read_lines(sock):
            resp = json.loads(line)
            if not resp.get("ok"):
                err = resp.get("error") or {}
                raise ServeError(err.get("code", "error"), err.get("message", "unknown error"))
            return resp
    raise ConnectionError(f"daemon at {path} closed the connection without responding")


def submit(folder: str, socket_path: str | None = None, options: dict | None = None,
           timeout: float | None = None, tenant: str | None = None,
           trace: str | None = None) -> dict:
    """Enqueue a chain job.  folder, output and checkpoint_dir are made
    absolute here; the trace context is the caller's or a fresh one, and
    the request's round trip is this process's `client_submit` span under
    it."""
    options = dict(options or {})
    for key in ("output", "checkpoint_dir"):
        if options.get(key):
            options[key] = os.path.abspath(options[key])
    trace = trace or protocol.mint_trace()
    msg = {"op": "submit", "folder": os.path.abspath(folder), "options": options,
           "trace": trace}
    if tenant is not None:
        msg["tenant"] = tenant
    t0 = time.perf_counter()
    with obs_trace.RECORDER.tagged(trace_id=trace):
        try:
            return request(msg, socket_path, timeout=timeout)
        finally:
            obs_trace.RECORDER.point("client_submit", time.perf_counter() - t0)


def status(job_id: str, socket_path: str | None = None) -> dict:
    return request({"op": "status", "id": job_id}, socket_path)


def wait(job_id: str, socket_path: str | None = None, timeout: float | None = None) -> dict:
    """Block until the job is terminal or timeout passes (None = until
    terminal), in server-side waits of WAIT_SLICE_S with growing client-side
    backoff between them; past the timeout the snapshot is not terminal."""
    deadline = None if timeout is None else time.time() + timeout
    backoff = 0.0
    while True:
        slice_s = WAIT_SLICE_S if deadline is None else \
            min(WAIT_SLICE_S, max(0.0, deadline - time.time()))
        # the socket read must outlive the daemon-side wait
        resp = request({"op": "wait", "id": job_id, "timeout": slice_s}, socket_path,
                       timeout=slice_s + 5.0)
        if resp["job"]["state"] in ("done", "failed"):
            return resp
        if deadline is not None and time.time() >= deadline:
            return resp
        backoff = min(WAIT_BACKOFF_MAX_S, backoff * 2 if backoff else WAIT_BACKOFF_S)
        sleep_s = backoff if deadline is None else \
            min(backoff, max(0.0, deadline - time.time()))
        if sleep_s > 0:
            time.sleep(sleep_s)


def stats(socket_path: str | None = None) -> dict:
    return request({"op": "stats"}, socket_path)


def metrics(socket_path: str | None = None) -> str:
    """The daemon's Prometheus text-format 0.0.4 scrape."""
    return request({"op": "metrics"}, socket_path)["text"]


def trace(socket_path: str | None = None) -> list[dict]:
    """The daemon's flight recorder as trace_event JSON events."""
    return request({"op": "trace"}, socket_path)["trace_events"]


def profile(socket_path: str | None = None) -> dict:
    """The daemon's profiling report (obs/profile.py): build records, the
    device memory watermark, estimator and delta accountability."""
    return request({"op": "profile"}, socket_path)["profile"]


def slo(socket_path: str | None = None) -> dict:
    """The daemon's SLO report (obs/slo.py): objectives, per-tenant rolling
    latency quantiles, error ratio and queue-wait share, per-(tenant,
    slice) burn state."""
    return request({"op": "slo"}, socket_path)["slo"]


def events(n: int = 50, socket_path: str | None = None) -> list[dict]:
    """The newest n records of the daemon's event log."""
    return request({"op": "events", "n": n}, socket_path)["events"]


def events_info(n: int = 50, socket_path: str | None = None) -> dict:
    """The `events` op's whole answer: {events: [...], log: the log's
    stats}, whose `path` is the JSONL file --follow tails."""
    return request({"op": "events", "n": n}, socket_path)


def shutdown(socket_path: str | None = None) -> dict:
    return request({"op": "shutdown"}, socket_path)


# ------------------------------------------------------------- CLI glue --
def _add_addr_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="daemon socket (default: SPGEMM_TPU_SERVE_SOCKET or "
                        "<tmpdir>/spgemmd-<uid>.sock)")
    p.add_argument("--addr", default=None, metavar="ADDR",
                   help="daemon address: tcp:HOST:PORT or a unix socket path (wins over "
                        "--socket; default: SPGEMM_TPU_SERVE_ADDR, then the unix socket)")


def main_submit(argv: list[str] | None = None) -> int:
    """`submit <folder>`: enqueue a chain job on the running daemon."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch submit",
                                description="submit a chain job to the running spgemmd")
    p.add_argument("folder", help="input directory containing `size` and matrix1..N")
    _add_addr_args(p)
    p.add_argument("--output", default=None, help="result path (default: <folder>/matrix)")
    p.add_argument("--backend", choices=list(protocol.CHAIN_BACKENDS), default=None)
    p.add_argument("--round-size", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="per-pass chain snapshots; a daemon restart resumes the job "
                        "from the newest complete pass")
    p.add_argument("--timeout", type=float, default=None, metavar="S",
                   help="per-job deadline (default: SPGEMM_TPU_SERVE_JOB_TIMEOUT)")
    p.add_argument("--tenant", default=None, metavar="NAME",
                   help="fair-queuing tenant (SPGEMM_TPU_SERVE_TENANT_INFLIGHT caps "
                        "its jobs in flight)")
    p.add_argument("--trace", default=None, metavar="HEX32",
                   help="the job's 128-bit trace context, 32 lowercase hex chars "
                        "(default: a fresh one)")
    p.add_argument("--failover", action="store_true",
                   help="run the job with chain failover (a lost card)")
    p.add_argument("--wait", action="store_true",
                   help="block until the job is terminal and print its final status")
    args = p.parse_args(argv)
    options = {k: v for k, v in (
        ("output", args.output), ("backend", args.backend), ("round_size", args.round_size),
        ("checkpoint_dir", args.checkpoint_dir), ("timeout_s", args.timeout),
        ("failover", args.failover or None)) if v is not None}
    addr = args.addr or args.socket
    try:
        resp = submit(args.folder, addr, options, tenant=args.tenant, trace=args.trace)
        if args.wait:
            resp = wait(resp["id"], addr)
    except (ServeError, OSError) as e:
        print(f"submit failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(resp, indent=2))
    if args.wait and resp.get("job", {}).get("state") != "done":
        return 1
    return 0


def main_status(argv: list[str] | None = None) -> int:
    """`status [job_id]`: a job's status, the daemon's stats, or shutdown."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch status",
                                description="query the running spgemmd: one job's status "
                                            "(with its phases_s and counters), or the "
                                            "daemon's stats with no job id")
    p.add_argument("job_id", nargs="?", default=None)
    _add_addr_args(p)
    p.add_argument("--wait", action="store_true", help="block until the job is terminal")
    p.add_argument("--shutdown", action="store_true", help="ask the daemon to shut down")
    args = p.parse_args(argv)
    addr = args.addr or args.socket
    try:
        if args.shutdown:
            resp = shutdown(addr)
        elif args.job_id is None:
            resp = stats(addr)
        elif args.wait:
            resp = wait(args.job_id, addr)
        else:
            resp = status(args.job_id, addr)
    except (ServeError, OSError) as e:
        print(f"status failed: {e}", file=sys.stderr)
        return 1
    print(json.dumps(resp, indent=2))
    return 0


def main_metrics(argv: list[str] | None = None) -> int:
    """`metrics`: the running daemon's Prometheus scrape on stdout."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch metrics",
                                description="scrape the running spgemmd's metrics (Prometheus "
                                            "text-format 0.0.4: engine phases and counters, "
                                            "kernel launches, plan cache, queue, degrade "
                                            "state, job outcomes and walls)")
    _add_addr_args(p)
    args = p.parse_args(argv)
    try:
        sys.stdout.write(metrics(args.addr or args.socket))
    except (ServeError, OSError) as e:
        print(f"metrics failed: {e}", file=sys.stderr)
        return 1
    return 0


def main_profile(argv: list[str] | None = None) -> int:
    """`profile [--json]`: the running daemon's profiling accounts."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch profile",
                                description="report the running spgemmd's profiling accounts: "
                                            "build records of its kernel and host libraries "
                                            "(wall, built or reused, ptxas registers and "
                                            "spills), the device memory watermark, estimator "
                                            "and delta prediction accuracy")
    _add_addr_args(p)
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="the whole report (the build records and every account)")
    args = p.parse_args(argv)
    try:
        rep = profile(args.addr or args.socket)
    except (ServeError, OSError) as e:
        print(f"profile failed: {e}", file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(rep, indent=2))
        return 0
    for rec in rep.get("compiles", []):
        kernels = rec.get("ptxas") or {}
        regs = sorted({k["registers"] for k in kernels.values()})
        spills = sum(k["spill_stores"] + k["spill_loads"] for k in kernels.values())
        print(f"build {rec['site']}: {'built' if rec.get('built') else 'reused'} "
              f"wall={rec['wall_s']:.3f}s lib={rec['signature']}"
              + (f" kernels={len(kernels)} registers={regs} spill_bytes={spills}"
                 if kernels else ""))
    if not rep.get("compiles"):
        print("no build records yet")
    mem = rep.get("memory", {})
    if mem.get("available"):
        print(f"device memory: in_use={mem['bytes_in_use']} peak={mem['peak_bytes']} "
              f"samples={mem['samples']}")
    else:
        print("device memory: not reported (the CPU; gauges omitted)")
    est = rep.get("estimator", {})
    if est.get("count"):
        errs = {q: f"{h['sum'] / h['count']:.4f}"
                for q, h in est["rel_error"].items() if h["count"]}
        print(f"estimator: x{est['count']} mean_rel_error={errs}")
    dlt = rep.get("delta", {})
    if dlt.get("count"):
        frac = dlt["dirty_fraction"]
        mean = frac["sum"] / frac["count"] if frac["count"] else 0.0
        print(f"delta: x{dlt['count']} predicted={dlt['predicted_rows']} "
              f"executed={dlt['executed_rows']} mispredictions={dlt['mispredictions']} "
              f"mean_dirty_fraction={mean:.4f}")
    ev = rep.get("events", {})
    print(f"events: emitted={ev.get('emitted', 0)} bytes={ev.get('bytes', 0)} "
          f"path={ev.get('path')}")
    return 0


def main_slo(argv: list[str] | None = None) -> int:
    """`slo [--json]`: the running daemon's SLO report."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch slo",
                                description="report the running spgemmd's SLO engine: "
                                            "objectives, per-tenant rolling-window latency "
                                            "quantiles (p50/p95/p99), error ratio, queue-wait "
                                            "share, and multi-window burn-rate state")
    _add_addr_args(p)
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="the whole report")
    args = p.parse_args(argv)
    try:
        rep = slo(args.addr or args.socket)
    except (ServeError, OSError) as e:
        print(f"slo failed: {e}", file=sys.stderr)
        return 1
    if args.as_json:
        print(json.dumps(rep, indent=2))
        return 0
    obj = rep.get("objectives", {})
    if obj.get("enabled"):
        print(f"objectives: target_s={obj['target_s']:g} error_pct={obj['error_pct']:g} "
              f"window_s={obj['window_s']:g}")
    else:
        print("objectives: none declared (accounting only; set SPGEMM_TPU_SLO_TARGET_S "
              "to arm burn-rate evaluation)")
    for tenant, row in rep.get("tenants", {}).items():
        lat = row["latency_s"]
        print(f"tenant {tenant}: jobs={row['jobs']} p50={lat['p50']:g}s p95={lat['p95']:g}s "
              f"p99={lat['p99']:g}s error_ratio={row['error_ratio']:g} "
              f"queue_share={row['queue_wait_share']:g}")
    for b in rep.get("burn", []):
        if not b.get("active") and not b.get("bad"):
            continue
        print(f"burn {b['tenant']}/{b['slice']}: {'BURNING' if b.get('active') else 'ok'} "
              f"fast={b.get('fast_burn', 0):g} slow={b.get('slow_burn', 0):g} "
              f"bad={b.get('bad', 0)}/{b.get('jobs', 0)} trace={b.get('trace_id')}")
    print(f"tenants_evicted={rep.get('tenants_evicted', 0)} records={rep.get('records', 0)}")
    return 0


def main_events(argv: list[str] | None = None) -> int:
    """`events [--tail N] [--follow]`: the daemon's newest event records,
    one JSON object a line; --follow then streams new records from the
    rotating <socket>.events.jsonl (a rotation neither drops nor repeats a
    line; Ctrl-C exits 0)."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch events",
                                description="print the running spgemmd's newest event-log "
                                            "records (job lifecycle, watchdog reap, wedge and "
                                            "degrade, the card probe, fallbacks) as JSONL")
    _add_addr_args(p)
    p.add_argument("--tail", type=int, default=50, metavar="N",
                   help="newest N records (default 50; the daemon's ring holds "
                        f"{obs_events.EventLog.RING_RETAIN}, <socket>.events.jsonl the "
                        "longer history)")
    p.add_argument("--follow", "-f", action="store_true",
                   help="after the tail, stream records as the daemon appends them")
    args = p.parse_args(argv)
    try:
        resp = events_info(args.tail, args.addr or args.socket)
    except (ServeError, OSError) as e:
        print(f"events failed: {e}", file=sys.stderr)
        return 1
    last_seq, last_ts = 0, 0.0
    for rec in resp["events"]:
        last_seq = max(last_seq, rec.get("seq", 0))
        last_ts = max(last_ts, rec.get("ts", 0.0))
        print(json.dumps(rec, separators=(",", ":")))
    if not args.follow:
        return 0
    path = (resp.get("log") or {}).get("path")
    if not path:
        print("events --follow: the daemon has no event file to tail "
              "(SPGEMM_TPU_OBS_EVENTS=0?)", file=sys.stderr)
        return 1
    try:
        for rec in obs_events.follow_file(path, last_seq=last_seq, last_ts=last_ts):
            print(json.dumps(rec, separators=(",", ":")), flush=True)
    except KeyboardInterrupt:
        return 0
    return 0


def main_trace_dump(argv: list[str] | None = None) -> int:
    """`trace-dump [--merge DIR] [--trace ID] [-o FILE]`: the daemon's
    flight recorder as trace_event JSON (ui.perfetto.dev or
    chrome://tracing open it), or, with --merge, every *.json dump under
    DIR (a client's own, the daemon's, <socket>.flight/ postmortems, the
    JAX package's) stitched into one trace with a track per process on a
    shared wall clock; --trace keeps one trace context's events."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch trace-dump",
                                description="dump the running spgemmd's flight recorder as "
                                            "trace_event JSON, or (--merge) stitch dumps of "
                                            "several processes into one trace")
    _add_addr_args(p)
    p.add_argument("--merge", default=None, metavar="DIR",
                   help="instead of asking a daemon, merge every *.json dump under DIR")
    p.add_argument("--trace", default=None, metavar="ID",
                   help="keep only the events of this 128-bit trace context (and the "
                        "metadata tracks that back them)")
    p.add_argument("--output", "-o", default=None, metavar="FILE",
                   help="write the trace_event array here (default: stdout)")
    args = p.parse_args(argv)
    if args.merge:
        import glob  # noqa: PLC0415

        paths = sorted(glob.glob(os.path.join(args.merge, "*.json")))
        if not paths:
            print(f"trace-dump --merge: no *.json dumps under {args.merge}", file=sys.stderr)
            return 1
        try:
            events = obs_trace.merge_trace_files(paths, trace_id=args.trace)
        except (OSError, ValueError) as e:
            print(f"trace-dump --merge failed: {e}", file=sys.stderr)
            return 1
    else:
        try:
            events = trace(args.addr or args.socket)
        except (ServeError, OSError) as e:
            print(f"trace-dump failed: {e}", file=sys.stderr)
            return 1
        if args.trace:
            events = obs_trace.filter_trace(events, args.trace)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(events, f, separators=(",", ":"))
        print(f"wrote {len(events)} trace events to {args.output}", file=sys.stderr)
    else:
        json.dump(events, sys.stdout, separators=(",", ":"))
        sys.stdout.write("\n")
    return 0
