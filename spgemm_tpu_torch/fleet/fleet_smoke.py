"""End-to-end proof of the fleet layer on the port (the port's copy of the JAX
package's `fleet/fleet_smoke.py`):

    python -m spgemm_tpu_torch.fleet.fleet_smoke [--device cuda|cpu]

starts two spgemmd daemons of the port, each `python -m spgemm_tpu_torch.cli
serve --socket S --addr tcp:127.0.0.1:P --device D` (`cuda`, the default,
needs a card: a daemon that cannot see one exits and fails the smoke), and
one `cli route` subprocess in front of both, then checks:

  * the router's poll marks both backends healthy (its stats `backends`
    block), and a burst of six submits from three tenants spreads over both
    backends, every answer naming its `backend`, every result byte-equal
    to the host oracle's (utils/semantics.chain_oracle), every job run on
    the device asked for (on the card, kernel 1 launched by every job that
    recomputed a row, and by both backends);
  * one scrape through the router carries its own families
    (spgemm_router_backend_up per backend) and every backend's series with
    `backend=` injected;
  * the trace leg: a submit's client-minted trace context passes through
    the router untouched, and `cli trace-dump --merge` over this process's
    ring dump, the router's and the serving backend's resolves that id to
    spans of all three processes (client_submit, router_submit, the job's
    spans);
  * the kill leg: SIGKILL one backend under a burst of six jobs; every job
    ends with its bytes exact (re-submitted once to the survivor) or with
    a structured error (backend-lost), none hangs; the router marks the
    dead backend down and places the next submit on the survivor;
  * a clean drain: SIGTERM to the router and a shutdown of the survivor,
    both exit 0.

Any failed check exits 1.  This process loads no torch: only the daemons
touch the device, the deployment this smoke stands for.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fail(procs, msg: str) -> int:
    print(f"fleet-smoke: FAIL: {msg}", file=sys.stderr)
    for proc in procs:
        if proc is not None and proc.poll() is None:
            proc.kill()
    for proc in procs:
        if proc is not None:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                continue
            with open(proc.log_path, errors="replace") as f:
                sys.stderr.write(f"--- {proc.log_path}\n" + f.read()[-3000:])
    return 1


def _spawn(cmd: list, env: dict, log_path: str) -> subprocess.Popen:
    """cmd with its output to log_path (a pipe nobody reads could fill and
    stall a verbose daemon)."""
    with open(log_path, "w") as log_f:
        proc = subprocess.Popen(cmd, env=env, stdout=log_f, stderr=subprocess.STDOUT)
    proc.log_path = log_path
    return proc


def _free_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_tcp(port: int, proc, procs, what: str, deadline_s: float = 300.0) -> int | None:
    """None once something listens on the port; _fail's 1 if the process
    exits first or the deadline passes."""
    deadline = time.time() + deadline_s
    while True:
        if proc.poll() is not None:
            return _fail(procs, f"{what} exited before listening on port {port}")
        try:
            probe = socket.create_connection(("127.0.0.1", port), timeout=1.0)
        except OSError:
            if time.time() > deadline:
                return _fail(procs, f"{what} never listened on port {port}")
            time.sleep(0.1)
            continue
        probe.close()
        return None


def _ran_on(job: dict, device: str) -> str | None:
    """Why the done job did not run on the device asked for, or None: its
    detail names the device, undegraded, and on the card a job that
    recomputed any row launched kernel 1 (a resubmit of unchanged content
    is served whole by delta recompute, with no launch)."""
    det = job.get("detail") or {}
    want = "cuda:0" if device == "cuda" else "cpu"
    if det.get("device") != want or det.get("degraded") is not False:
        return f"ran on {det.get('device')} (degraded {det.get('degraded')}), want {want}"
    if device == "cuda" and det.get("delta_rows", 1) > 0 \
            and det.get("launches_numeric_round", 0) < 1:
        return f"launched no kernel 1 on the card: {det}"
    return None


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m spgemm_tpu_torch.fleet.fleet_smoke",
                                description="end-to-end proof of the fleet router in front of "
                                            "two spgemmd daemons of the port")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the daemons' device (default cuda: the card)")
    args = p.parse_args(argv)

    import numpy as np  # noqa: PLC0415

    from spgemm_tpu_torch.obs import trace as obs_trace  # noqa: PLC0415
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415
    from spgemm_tpu_torch.utils import io_text  # noqa: PLC0415
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix  # noqa: PLC0415
    from spgemm_tpu_torch.utils.gen import random_chain  # noqa: PLC0415
    from spgemm_tpu_torch.utils.semantics import chain_oracle  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="spgemm-fleet-smoke-")
    k = 8
    folder = os.path.join(tmp, "chain_in")
    mats = random_chain(4, 12, k, 0.4, np.random.default_rng(11), "full")
    io_text.write_chain_dir(folder, mats, k)
    want = chain_oracle([m.to_dict() for m in mats], k)
    want_bytes = io_text.format_matrix(BlockSparseMatrix.from_dict(
        mats[0].rows, mats[-1].cols, k, want).prune_zeros())

    # the smoke owns every serve, warm and router knob it checks against
    env = {key: v for key, v in os.environ.items()
           if not key.startswith(("SPGEMM_TPU_WARM", "SPGEMM_TPU_SERVE", "SPGEMM_TPU_ROUTER"))}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, *(q for q in env.get("PYTHONPATH", "").split(os.pathsep) if q)])
    ports = [_free_port(), _free_port()]
    router_port = _free_port()
    socks = [os.path.join(tmp, f"b{i}.sock") for i in (0, 1)]
    backend_names = [f"tcp:127.0.0.1:{port}" for port in ports]
    router_addr = f"tcp:127.0.0.1:{router_port}"

    backends = []
    procs: list[subprocess.Popen | None] = []
    for i in (0, 1):
        proc = _spawn([sys.executable, "-m", "spgemm_tpu_torch.cli", "serve", "--socket",
                       socks[i], "--addr", backend_names[i], "--device", args.device, "-v"],
                      env, os.path.join(tmp, f"b{i}.log"))
        backends.append(proc)
        procs.append(proc)
    router = None
    try:
        for i in (0, 1):
            rc = _wait_tcp(ports[i], backends[i], procs, f"backend {i}")
            if rc is not None:
                return rc

        router = _spawn([sys.executable, "-m", "spgemm_tpu_torch.cli", "route", "--listen",
                         router_addr, "--backends", ",".join(backend_names), "--poll-s", "0.5",
                         "-v"], env, os.path.join(tmp, "router.log"))
        procs.append(router)
        rc = _wait_tcp(router_port, router, procs, "router")
        if rc is not None:
            return rc
        deadline = time.time() + 60
        while True:
            st = client.stats(router_addr)
            up = [name for name, b in (st.get("backends") or {}).items() if b.get("up")]
            if len(up) == 2:
                break
            if time.time() > deadline:
                return _fail(procs, f"router never saw both backends healthy (up: {up})")
            time.sleep(0.2)
        if st.get("daemon") != "spgemm-router":
            return _fail(procs, f"stats daemon={st.get('daemon')!r} (want spgemm-router)")

        # ---- a mixed-tenant burst through the front door ----
        jobs = []
        for i in range(6):
            out = os.path.join(tmp, f"matrix.{i}")
            resp = client.submit(folder, router_addr, {"output": out}, tenant=f"team-{i % 3}")
            if not resp.get("backend"):
                return _fail(procs, f"submit {i} answer carries no `backend` field")
            jobs.append((resp["id"], resp["backend"], out))
        served, launched = set(), {}
        for jid, backend, out in jobs:
            r = client.wait(jid, router_addr, timeout=300)
            if r["job"]["state"] != "done":
                return _fail(procs, f"job {jid} ended {r['job']['state']}: "
                                    f"{r['job'].get('error')}")
            if r["job"]["id"] != jid:
                return _fail(procs, f"wait answered job {r['job']['id']} for fleet id {jid}")
            if open(out, "rb").read() != want_bytes:
                return _fail(procs, f"job {jid} output does not match the oracle bytes")
            why = _ran_on(r["job"], args.device)
            if why:
                return _fail(procs, f"job {jid} {why}")
            served.add(backend)
            launched[backend] = launched.get(backend, 0) \
                + r["job"]["detail"].get("launches_numeric_round", 0)
        if len(served) != 2:
            return _fail(procs, f"the burst did not spread across both backends (served by "
                                f"{served})")
        if args.device == "cuda" and min(launched.values()) < 1:
            return _fail(procs, f"a backend launched no kernel 1 on the card: {launched}")

        # ---- one scrape: the router's families and the relabeled backends ----
        scrape = client.metrics(router_addr)
        for name in backend_names:
            needle = f'spgemm_router_backend_up{{backend="{name}"}} 1'
            if needle not in scrape:
                return _fail(procs, f"scrape lacks {needle!r}")
        if not any('backend="' in ln and not ln.startswith("spgemm_router_")
                   for ln in scrape.splitlines()):
            return _fail(procs, "scrape carries no backend-relabeled passthrough series")

        # ---- the trace leg: client -> router -> backend in one trace ----
        out_t = os.path.join(tmp, "matrix.trace")
        resp = client.submit(folder, router_addr, {"output": out_t}, tenant="tracer")
        trace_id = resp.get("trace")
        t_backend = resp["backend"]
        if not isinstance(trace_id, str) or len(trace_id) != 32:
            return _fail(procs, f"submit returned no 128-bit trace context through the router "
                                f"(got {trace_id!r})")
        r = client.wait(resp["id"], router_addr, timeout=300)
        if r["job"]["state"] != "done":
            return _fail(procs, f"trace-leg job ended {r['job']['state']}: "
                                f"{r['job'].get('error')}")
        stitch = os.path.join(tmp, "stitch")
        obs_trace.dump_json(os.path.join(stitch, "client.trace.json"),
                            process_name="fleet-smoke-client")
        for addr, fname in ((router_addr, "router.trace.json"),
                            (t_backend, "backend.trace.json")):
            rc = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", "trace-dump",
                                 "--addr", addr, "-o", os.path.join(stitch, fname)],
                                env=env, capture_output=True, text=True, timeout=60)
            if rc.returncode != 0:
                return _fail(procs, f"trace-dump --addr {addr} failed: {rc.stderr[-500:]}")
        merged_path = os.path.join(tmp, "merged.trace.json")
        rc = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", "trace-dump",
                             "--merge", stitch, "--trace", trace_id, "-o", merged_path],
                            env=env, capture_output=True, text=True, timeout=60)
        if rc.returncode != 0:
            return _fail(procs, f"cli trace-dump --merge failed: {rc.stderr[-500:]}")
        with open(merged_path, encoding="utf-8") as f:
            merged = json.load(f)
        spans = [ev for ev in merged if ev.get("ph") != "M"]
        pids = {ev["pid"] for ev in spans}
        names = {ev["name"] for ev in spans}
        if len(pids) < 3:
            return _fail(procs, f"merge did not stitch client AND router AND backend tracks "
                                f"(pids {pids}, names {sorted(names)})")
        for span in ("client_submit", "router_submit"):
            if span not in names:
                return _fail(procs, f"merged trace lacks the {span} span (saw {sorted(names)})")

        # ---- the kill leg: one backend dies under load ----
        kill_jobs = []
        for i in range(6):
            out = os.path.join(tmp, f"matrix.k{i}")
            resp = client.submit(folder, router_addr, {"output": out}, tenant=f"team-{i % 3}")
            kill_jobs.append((resp["id"], out))
        backends[0].kill()  # SIGKILL: no drain, its jobs die with it
        completed = structured = 0
        for jid, out in kill_jobs:
            try:
                r = client.wait(jid, router_addr, timeout=300)
            except client.ServeError as e:
                if e.code not in ("backend-lost", "no-backend", "job-error", "unknown-job"):
                    return _fail(procs, f"job {jid} failed with an undeclared code after the "
                                        f"kill: [{e.code}] {e.message}")
                structured += 1
                continue
            if r["job"]["state"] == "done":
                if open(out, "rb").read() != want_bytes:
                    return _fail(procs, f"post-kill job {jid} output does not match the "
                                        "oracle bytes")
                completed += 1
            elif r["job"]["state"] == "failed":
                structured += 1  # terminal with a structured error
            else:
                return _fail(procs, f"post-kill job {jid} still {r['job']['state']} after "
                                    "its wait's deadline")
        if completed + structured != len(kill_jobs):
            return _fail(procs, "some post-kill job neither completed nor failed structured")

        # the router benches the dead backend and lands new submits on the
        # survivor
        deadline = time.time() + 30
        while True:
            st = client.stats(router_addr)
            if not (st.get("backends") or {}).get(backend_names[0], {}).get("up"):
                break
            if time.time() > deadline:
                return _fail(procs, "router still reports the killed backend up")
            time.sleep(0.2)
        out_s = os.path.join(tmp, "matrix.survivor")
        resp = client.submit(folder, router_addr, {"output": out_s})
        if resp["backend"] != backend_names[1]:
            return _fail(procs, f"post-kill submit landed on {resp['backend']} (want the "
                                f"survivor {backend_names[1]})")
        r = client.wait(resp["id"], router_addr, timeout=300)
        if r["job"]["state"] != "done":
            return _fail(procs, f"survivor job ended {r['job']['state']}: "
                                f"{r['job'].get('error')}")
        if open(out_s, "rb").read() != want_bytes:
            return _fail(procs, "survivor output does not match the oracle bytes")
        failovers = (client.stats(router_addr).get("jobs") or {}).get("failovers", 0)

        # ---- a clean drain: the router, then the survivor ----
        router.send_signal(signal.SIGTERM)
        try:
            rc_router = router.wait(timeout=30)
        except subprocess.TimeoutExpired:
            return _fail(procs, "router did not exit after SIGTERM")
        if rc_router != 0:
            return _fail(procs, f"router exited {rc_router} after SIGTERM")
        client.shutdown(socks[1])
        try:
            rc_b = backends[1].wait(timeout=60)
        except subprocess.TimeoutExpired:
            return _fail(procs, "surviving daemon did not exit after shutdown")
        if rc_b != 0:
            return _fail(procs, f"surviving daemon exited {rc_b} after shutdown")
    finally:
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    print(f"fleet-smoke: OK on {args.device} (6 mixed-tenant jobs bit-exact across "
          f"{sorted(served)}, kernel-1 launches per backend {launched}; aggregated scrape "
          f"labeled per backend; trace {trace_id} stitched across {len(pids)} processes; "
          f"kill leg: {completed} completed / {structured} structured of {len(kill_jobs)} with "
          f"{failovers} failover(s), survivor took the rest; router + survivor drained clean)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
