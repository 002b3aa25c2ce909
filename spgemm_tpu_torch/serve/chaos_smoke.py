"""Failpoint chaos proof for the port's spgemmd (the port's copy of the JAX
package's `serve/chaos_smoke.py`):

    python -m spgemm_tpu_torch.serve.chaos_smoke [--device cuda|cpu]
        [--seed S] [--jobs N] [--job-timeout S] [--chain DIR=EXPECTED ...]

A seeded fault schedule (utils/failpoints.py, armed through
SPGEMM_TPU_FAILPOINTS) runs against a live daemon, `python -m
spgemm_tpu_torch.cli serve --device D`: on `cuda` (the default; a daemon
that cannot see a card exits and fails the smoke) the one-card pool, one
slice on cuda:0; on `cpu` a pool of 2 slices (SPGEMM_TPU_SERVE_SLICES=2).
It checks:

  * every job ends with its bytes equal to the expected ones (the host
    oracle's, utils/semantics.chain_oracle, for the generated chains; the
    EXPECTED file of a --chain) or fails with a structured error (a wire
    code), and on the card every job that ran undegraded ran on cuda:0;
  * no wait passes its bound, the job deadline plus the wedge grace plus a
    margin;
  * the pool heals: the schedule always arms `serve.executor:1:1`, so the
    first pickup hangs, is reaped, its slice degrades and is probed; the
    probe finds the device working and reinstates the slice behind the
    canary gate (SPGEMM_TPU_SERVE_RECOVER_S re-probes a card found dead).
    The slice rows must report `recoveries >= 1` and none degraded, the
    scrape must carry spgemm_failpoints_triggered_total, and a submit after
    the heal ends bit-exact.  On one card the wedge degrades the whole
    pool; queued jobs wait for the probe's outcome there (a port
    difference: the JAX daemon serves them on the host oracle meanwhile);
  * the journal survives a write cut midway: the schedule arms
    `serve.journal:1:1` (one torn record), the harness appends half a
    frame after shutdown, and a second daemon on the same socket replays
    it, counts the tear (stats journal.torn >= 1) and serves a submit
    bit-exact;
  * SIGTERM drains the second daemon, which exits 0 and unlinks its socket.

Any failed check exits 1.  This process loads no torch: only the daemons
touch the device.
"""

from __future__ import annotations

import argparse
import os
import random
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the watchdog window the no-hang check is derived from
JOB_TIMEOUT_S = 45.0
WEDGE_GRACE_S = 2.0
RECOVER_S = 0.5
# margin on the watchdog window: a daemon's cold first job and the probe
WAIT_MARGIN_S = 120.0
# a daemon binds its socket within this (torch import, the engine's load,
# on the card the probe and the kernels' build)
START_S = 600.0

# the seeded schedule's draws (the wedge and the torn record are always
# armed: the heal and replay checks need them)
CANDIDATES = (
    ("plan.build", (0.1, 0.3)),
    ("plan.ensure_exact", (0.1, 0.3)),
    ("kernel.dispatch", (0.1, 0.3)),
    ("delta.diff", (0.3, 0.7)),
    ("delta.splice", (0.1, 0.3)),
    ("warm.load", (0.3, 0.7)),
    ("warm.flush", (0.3, 0.7)),
    ("serve.accept", (0.1, 0.3)),
    ("serve.readline", (0.05, 0.15)),
)


def _fail(procs, msg: str) -> int:
    print(f"chaos-smoke: FAIL: {msg}", file=sys.stderr)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            continue
        with open(proc.log_path, errors="replace") as f:
            sys.stderr.write(f"--- {proc.log_path}\n" + f.read()[-6000:])
    return 1


def _start_daemon(sock: str, env: dict, device: str, log_path: str, procs: list):
    """(process, None) once the daemon bound its socket, else (None, why)."""
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen([sys.executable, "-m", "spgemm_tpu_torch.cli", "serve",
                                 "--socket", sock, "--device", device, "-v"],
                                env=env, stdout=log_f, stderr=subprocess.STDOUT)
    proc.log_path = log_path
    procs.append(proc)
    deadline = time.time() + START_S
    while not os.path.exists(sock):
        if proc.poll() is not None:
            return None, "daemon exited before binding its socket"
        if time.time() > deadline:
            return None, "daemon never bound its socket"
        time.sleep(0.1)
    return proc, None


def _transient(client, e) -> bool:
    """Weather, not an outcome: a busy answer (an accept stall) or the
    client's connect retry giving up.  Any other ServeError is a result."""
    from spgemm_tpu_torch.serve import protocol  # noqa: PLC0415

    return isinstance(e, client.ServeError) and \
        e.code in (protocol.E_BUSY, protocol.E_UNAVAILABLE)


def _retrying(client, fn, *args, **kw):
    """fn(*args, **kw), riding out a connection a failpoint killed before
    it answered (the request never reached admission, so a resend cannot
    submit twice) and transient answers; the last error after 6 tries."""
    last = None
    for _ in range(6):
        try:
            return fn(*args, **kw)
        except ConnectionError as e:
            last = e
        except client.ServeError as e:
            if not _transient(client, e):
                raise
            last = e
        time.sleep(0.1)
    raise last


def _wait_terminal(client, job_id: str, sock: str, bound_s: float):
    """The terminal answer within bound_s, else None (a hang)."""
    deadline = time.time() + bound_s
    last = None
    while time.time() < deadline:
        try:
            resp = client.wait(job_id, sock, timeout=max(1.0, deadline - time.time()))
        except ConnectionError as e:
            last = e
            time.sleep(0.1)
            continue
        except client.ServeError as e:
            if not _transient(client, e):
                raise
            last = e
            time.sleep(0.1)
            continue
        if resp["job"]["state"] in ("done", "failed"):
            return resp
        break  # a non-terminal snapshot: the bound ran out
    if last is not None and time.time() >= deadline:
        raise last
    return None


def _run_job(client, sock: str, folder: str, out: str, bound_s: float):
    """Submit and wait: the terminal job snapshot, or None on a hang."""
    resp = _retrying(client, client.submit, folder, sock, {"output": out})
    resp = _wait_terminal(client, resp["id"], sock, bound_s)
    return None if resp is None else resp["job"]


def _served(client, sock: str, chain: tuple, out: str, bound_s: float, tries: int = 8):
    """Why a submit of chain did not end bit-exact, or None once one did.
    The schedule stays armed, so a structured failure is tried again (up to
    `tries` submits); wrong bytes or a hang end the check at once."""
    why = None
    for _ in range(tries):
        job = _run_job(client, sock, chain[0], out, bound_s)
        if job is None:
            return f"not terminal within {bound_s:g} s"
        if job["state"] == "done":
            return None if _same_bytes(out, chain[1]) else "WRONG BYTES"
        why = f"failed {job.get('error')}"
    return why


def _same_bytes(path: str, want) -> bool:
    """Whether the file at path holds want: bytes, or (for a --chain) the
    path of a file of the expected bytes, compared in chunks."""
    if isinstance(want, bytes):
        with open(path, "rb") as f:
            return f.read() == want
    if os.path.getsize(path) != os.path.getsize(want):
        return False
    with open(path, "rb") as f, open(want, "rb") as g:
        while True:
            x, y = f.read(64 << 20), g.read(64 << 20)
            if x != y:
                return False
            if not x:
                return True


def _generated_chains(tmp: str) -> list:
    """Two small chains and their oracle bytes."""
    import numpy as np  # noqa: PLC0415

    from spgemm_tpu_torch.utils import io_text  # noqa: PLC0415
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix  # noqa: PLC0415
    from spgemm_tpu_torch.utils.gen import random_chain  # noqa: PLC0415
    from spgemm_tpu_torch.utils.semantics import chain_oracle  # noqa: PLC0415

    chains = []
    for i, seed in enumerate((31, 32)):
        folder = os.path.join(tmp, f"chain_{i}")
        mats = random_chain(4, 6, 4, 0.5, np.random.default_rng(seed), "full")
        io_text.write_chain_dir(folder, mats, 4)
        want = chain_oracle([m.to_dict() for m in mats], 4)
        chains.append((folder, io_text.format_matrix(BlockSparseMatrix.from_dict(
            mats[0].rows, mats[-1].cols, 4, want).prune_zeros())))
    return chains


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m spgemm_tpu_torch.serve.chaos_smoke",
                                description="seeded failpoint chaos proof against a live "
                                            "spgemmd of the port")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the daemon's device (default cuda: the card, one slice; cpu: "
                        "a pool of 2 slices)")
    p.add_argument("--seed", type=int, default=20260804,
                   help="the schedule's seed (default 20260804; the schedule is printed, "
                        "so a failure replays)")
    p.add_argument("--jobs", type=int, default=10, help="submits in the chaos leg (default 10)")
    p.add_argument("--job-timeout", type=float, default=JOB_TIMEOUT_S,
                   help=f"the daemon's job deadline in seconds (default {JOB_TIMEOUT_S:g}): "
                        "the wedged job's wait")
    p.add_argument("--chain", action="append", default=[], metavar="DIR=EXPECTED",
                   help="a chain directory and the file of its expected ./matrix bytes, "
                        "used in place of the two generated chains (repeatable)")
    args = p.parse_args(argv)

    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    rng = random.Random(args.seed)
    tmp = tempfile.mkdtemp(prefix="spgemmd-chaos-")
    sock = os.path.join(tmp, "d.sock")
    procs: list = []
    if args.chain:
        chains = []
        for spec in args.chain:
            folder, sep, expected = spec.partition("=")
            if not sep or not os.path.isfile(os.path.join(folder, "size")) \
                    or not os.path.isfile(expected):
                print(f"chaos-smoke: --chain {spec!r} is not DIR=EXPECTED with a chain "
                      "directory and a file", file=sys.stderr)
                return 2
            chains.append((folder, expected))
    else:
        chains = _generated_chains(tmp)

    drawn = rng.sample(CANDIDATES, 3)
    terms = [f"{name}:{rng.uniform(lo, hi):.2f}" for name, (lo, hi) in drawn]
    terms += ["serve.executor:1:1", "serve.journal:1:1"]
    schedule = ",".join(terms)
    n_slices = 1 if args.device == "cuda" else 2
    print(f"chaos-smoke: seed={args.seed} device={args.device} slices={n_slices} "
          f"schedule={schedule}", flush=True)

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SPGEMM_TPU_WARM", "SPGEMM_TPU_SERVE"))
           and k != "SPGEMM_TPU_FAILPOINTS"}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, *(q for q in env.get("PYTHONPATH", "").split(os.pathsep) if q)])
    env.update({
        "SPGEMM_TPU_FAILPOINTS": schedule,
        "SPGEMM_TPU_SERVE_SLICES": str(n_slices),
        "SPGEMM_TPU_SERVE_JOB_TIMEOUT": f"{args.job_timeout:g}",
        "SPGEMM_TPU_SERVE_WEDGE_GRACE_S": f"{WEDGE_GRACE_S:g}",
        "SPGEMM_TPU_SERVE_RECOVER_S": f"{RECOVER_S:g}",
    })
    t0 = time.perf_counter()
    proc, err = _start_daemon(sock, env, args.device, os.path.join(tmp, "d1.log"), procs)
    if err:
        return _fail(procs, err)
    start_s = time.perf_counter() - t0
    want_device = "cuda:0" if args.device == "cuda" else "cpu"

    # ---- chaos leg: every job bit-exact or structured, no hangs ----
    bound_s = args.job_timeout + WEDGE_GRACE_S + WAIT_MARGIN_S
    done = failed = 0
    codes: set = set()
    t0 = time.perf_counter()
    for i in range(args.jobs):
        pick = rng.randrange(len(chains))
        out = os.path.join(tmp, f"out.{i}")
        try:
            job = _run_job(client, sock, chains[pick][0], out, bound_s)
        except client.ServeError as e:
            return _fail(procs, f"job {i} answered a structured error at submit or wait: {e}")
        if job is None:
            return _fail(procs, f"job {i} not terminal within {bound_s:g} s: a hang past "
                                "the watchdog's window")
        if job["state"] == "done":
            done += 1
            if not _same_bytes(out, chains[pick][1]):
                return _fail(procs, f"job {i} completed with WRONG BYTES")
            det = job.get("detail") or {}
            if not det.get("degraded") and det.get("device") != want_device:
                return _fail(procs, f"job {i} ran on {det.get('device')}, want {want_device}")
            os.remove(out)
        else:
            code = (job.get("error") or {}).get("code")
            if not code or not isinstance(code, str):
                return _fail(procs, f"job {i} failed without a structured error: "
                                    f"{job.get('error')!r}")
            failed += 1
            codes.add(code)
    chaos_s = time.perf_counter() - t0
    if done == 0:
        return _fail(procs, "no job completed: the schedule starved the check")

    # ---- heal leg: the wedged slice is reinstated and serves again ----
    t0 = time.perf_counter()
    deadline = time.time() + 120
    recoveries = 0
    while time.time() < deadline:
        try:
            st = _retrying(client, client.stats, sock)
        except client.ServeError as e:
            return _fail(procs, f"stats answered a structured error mid-heal: {e}")
        recoveries = sum(s.get("recoveries", 0) for s in st["slices"])
        if recoveries >= 1 and not any(s["degraded"] for s in st["slices"]):
            break
        time.sleep(0.25)
    else:
        return _fail(procs, f"the pool never healed: recoveries {recoveries}, slices "
                            f"{[(s['name'], s['degraded']) for s in st['slices']]}")
    try:
        scrape = _retrying(client, client.metrics, sock)
    except client.ServeError as e:
        return _fail(procs, f"metrics answered a structured error: {e}")
    if "spgemm_failpoints_triggered_total{" not in scrape:
        return _fail(procs, "the failpoint triggers are missing from the scrape")
    try:
        why = _served(client, sock, chains[0], os.path.join(tmp, "out.heal"), bound_s)
    except client.ServeError as e:
        why = f"a structured error at submit or wait: {e}"
    if why is not None:
        return _fail(procs, f"the submit after the heal did not end bit-exact: {why}")
    heal_s = time.perf_counter() - t0
    try:
        _retrying(client, client.shutdown, sock)
    except client.ServeError as e:
        return _fail(procs, f"shutdown answered a structured error: {e}")
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        return _fail(procs, "the chaos daemon did not exit after shutdown")
    if rc != 0:
        return _fail(procs, f"the chaos daemon exited {rc} after shutdown")

    # ---- torn-journal leg: a second daemon replays a cut write ----
    t0 = time.perf_counter()
    with open(sock + ".journal", "a", encoding="utf-8") as f:
        # half a frame with no newline: what a kill in mid-append leaves
        f.write('89abcdef 57 {"event":"submit","id":"job-torn","fold')
    env2 = {k: v for k, v in env.items() if k != "SPGEMM_TPU_FAILPOINTS"}
    proc2, err = _start_daemon(sock, env2, args.device, os.path.join(tmp, "d2.log"), procs)
    if err:
        return _fail(procs, f"restart over the torn journal: {err}")
    torn = _retrying(client, client.stats, sock)["journal"].get("torn", 0)
    if torn < 1:
        return _fail(procs, f"the restarted daemon did not count the torn journal (torn={torn})")
    try:
        why = _served(client, sock, chains[-1], os.path.join(tmp, "out.replay"), bound_s,
                      tries=1)
    except client.ServeError as e:
        why = f"a structured error at submit or wait: {e}"
    if why is not None:
        return _fail(procs, f"the submit after the replay did not end bit-exact: {why}")

    # ---- SIGTERM drains and exits 0 ----
    proc2.send_signal(signal.SIGTERM)
    try:
        rc = proc2.wait(timeout=120)
    except subprocess.TimeoutExpired:
        return _fail(procs, "the daemon did not exit on SIGTERM (the drain hung)")
    if rc != 0:
        return _fail(procs, f"the daemon exited {rc} on SIGTERM (want 0)")
    if os.path.exists(sock):
        return _fail([], "the socket is left after the SIGTERM drain")
    replay_s = time.perf_counter() - t0
    print(f"chaos-smoke: OK on {args.device} (seed {args.seed}, {n_slices} slice(s); daemon up "
          f"in {start_s:.3f} s; {done} done bit-exact and {failed} failed structured of "
          f"{args.jobs} chaos jobs in {chaos_s:.3f} s, codes {sorted(codes)}; recoveries "
          f"{recoveries}, healed and served in {heal_s:.3f} s; torn journal counted {torn} and "
          f"replayed, submit served and SIGTERM drained to exit 0 in {replay_s:.3f} s)",
          flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
