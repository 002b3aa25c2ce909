"""spgemmd client: library calls and the CLI's `submit` and `status` (the
port's copy of the JAX package's `serve/client.py`, without the obs ops).

Imports neither torch nor numpy: a submitting process must not pay the cold
torch import the daemon exists to amortize, and never touches the card (the
daemon owns it; a client owns only the socket).  Relative paths are made
absolute here, since the daemon's working directory is not the caller's.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

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
    absolute here; the trace context is the caller's or a fresh one."""
    options = dict(options or {})
    for key in ("output", "checkpoint_dir"):
        if options.get(key):
            options[key] = os.path.abspath(options[key])
    msg = {"op": "submit", "folder": os.path.abspath(folder), "options": options,
           "trace": trace or protocol.mint_trace()}
    if tenant is not None:
        msg["tenant"] = tenant
    return request(msg, socket_path, timeout=timeout)


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
