"""End-to-end proof of the obs layer on the port's spgemmd (the port's copy of
the JAX package's `serve/obs_smoke.py`):

    python -m spgemm_tpu_torch.serve.obs_smoke [--device cuda|cpu]

starts `python -m spgemm_tpu_torch.cli serve` on a temporary socket
(`--device cuda`, the default, needs a card) with the estimator on and
declared objectives, scrapes its `metrics` op before and after one chain
job, and checks:

  * the scrape is text-format 0.0.4 with HELP and TYPE headers;
  * the engine's phase and plan-cache series move across the submit;
  * the profiling families appear and move: a build record per library the
    daemon loaded (`spgemm_compiles_total{site=...}` for `native` and, on
    the card, `numeric_round`), the span-fed phase histogram
    (`spgemm_phase_seconds_count{phase="plan"}`), the estimator's accuracy
    (`spgemm_est_rel_error_count`: the chain has more tile rows than the
    estimator's row-sample budget, so the plans take the estimated route
    and are scored when their exact joins land), the delta accountability
    (`spgemm_delta_dirty_fraction_count`) and the event-log counters; the
    device memory gauges render on the card and are absent on the CPU;
  * `cli profile --json` lists at least one build record for each library
    the daemon loaded, with `built` and a wall, through the real CLI;
  * `cli events --tail` gives the job's job_submit, job_start and job_done,
    and the JSONL file lies next to the journal;
  * the terminal-outcome counter counts the job, and the `trace` op and
    `cli trace-dump -o F` give trace_event JSON whose spans carry its id;
  * the SLO families render: the tenant's p50 is above 0, its error ratio
    0, and `cli slo --json` reports the job;
  * a clean shutdown.

Then the burn leg: a second daemon with an armed `serve.executor:1:1`
failpoint (the first pickup hangs: a wedged card), a one-second job
deadline, a short wedge grace and declared objectives.  Its first job is
reaped, `spgemm_slo_burn_active{tenant="default",slice=...}` flips to 1, one
`slo_burn` event carries exactly the trace id the client minted at submit,
the `slo` op's burning window names it too, and `cli trace-dump --merge`
over this process's ring dump and the daemon's dump stitches one trace in
which that id holds spans of both processes (client_submit here, the
wedged job's spans in the daemon).  Any failed check exits 1.  This
process loads no torch: only the daemon touches the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from spgemm_tpu_torch.serve.smoke import _start, _stop

# the daemon's estimator row-sample budget (SPGEMM_TPU_EST_SAMPLE_ROWS) is
# 48 by default: 64 tile rows take the estimated route
CHAIN = {"n": 4, "block_dim": 64, "k": 4, "bandwidth": 1}


def _fail(proc: subprocess.Popen | None, msg: str) -> int:
    print(f"obs-smoke: FAIL: {msg}", file=sys.stderr)
    if proc is not None:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        with open(proc.log_path) as f:
            sys.stderr.write(f.read()[-4000:])
    return 1


def parse_prometheus(text: str) -> dict[str, float]:
    """{name{labels}: value} for every sample line (HELP and TYPE skipped);
    a malformed value line raises: the smoke's format check."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def _cli(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=120)


def _env(**extra) -> dict:
    """The daemon's environment: this one's, without serve, failpoint, SLO
    or obs settings, plus extra."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SPGEMM_TPU_SERVE", "SPGEMM_TPU_FAILPOINTS", "SPGEMM_TPU_SLO",
                                "SPGEMM_TPU_OBS", "SPGEMM_TPU_WARM", "SPGEMM_TPU_PLAN_ESTIMATE",
                                "SPGEMM_TPU_EST_"))}
    env.update(extra)
    return env


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m spgemm_tpu_torch.serve.obs_smoke",
                                description="end-to-end proof of the obs layer on the port's "
                                            "spgemmd")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import numpy as np  # noqa: PLC0415

    from spgemm_tpu_torch.serve import client  # noqa: PLC0415
    from spgemm_tpu_torch.utils import io_text  # noqa: PLC0415
    from spgemm_tpu_torch.utils.gen import banded_block_sparse  # noqa: PLC0415

    tmp = tempfile.mkdtemp(prefix="spgemmd-obs-smoke-")
    sock = os.path.join(tmp, "d.sock")
    folder = os.path.join(tmp, "chain_in")
    rng = np.random.default_rng(7)
    mats = [banded_block_sparse(CHAIN["block_dim"], CHAIN["k"], CHAIN["bandwidth"], rng, "full")
            for _ in range(CHAIN["n"])]
    io_text.write_chain_dir(folder, mats, CHAIN["k"])

    # a generous objective: this leg's job must land good
    env = _env(SPGEMM_TPU_SLO_TARGET_S="60", SPGEMM_TPU_SLO_WINDOW_S="600",
               SPGEMM_TPU_PLAN_ESTIMATE="1")
    proc, why = _start(sock, args.device, env)
    if why:
        return _fail(proc, why)
    try:
        before = parse_prometheus(client.metrics(sock))
        if "spgemmd_uptime_seconds" not in before:
            return _fail(proc, "the first scrape lacks the daemon's gauges")
        out = os.path.join(tmp, "matrix.1")
        job_id = client.submit(folder, sock, {"output": out})["id"]
        job = client.wait(job_id, sock, timeout=600)["job"]
        if job["state"] != "done":
            return _fail(proc, f"job ended {job['state']}: {job['error']}")

        text = client.metrics(sock)
        if "# TYPE spgemm_phase_seconds_total counter" not in text:
            return _fail(proc, "the scrape lacks the TYPE header of the phase series")
        after = parse_prometheus(text)
        moved = [s for s in ('spgemm_phase_seconds_total{phase="plan"}',
                             'spgemm_phase_seconds_count{phase="plan"}',
                             "spgemm_events_emitted_total")
                 if after.get(s, 0.0) <= before.get(s, 0.0)]
        cache = sum(after.get(f"spgemm_plan_cache_{s}_total", 0) for s in ("hits", "misses"))
        if moved or cache <= sum(before.get(f"spgemm_plan_cache_{s}_total", 0)
                                 for s in ("hits", "misses")):
            return _fail(proc, f"series did not move across the submit: {moved}, plan cache")
        if after.get('spgemmd_jobs_terminal_total{outcome="done"}') != 1.0:
            return _fail(proc, "the terminal-outcome counter did not count the job")
        sites = ["native"] + (["numeric_round"] if args.device == "cuda" else [])
        missing = [s for s in sites if after.get(f'spgemm_compiles_total{{site="{s}"}}', 0) < 1]
        if missing:
            return _fail(proc, f"no build record for {missing}")
        if after.get('spgemm_est_rel_error_count{quantity="keys"}', 0) <= 0:
            return _fail(proc, "the estimator's accuracy series has no observations after "
                               "an estimator-routed submit")
        if after.get("spgemm_delta_dirty_fraction_count", 0) <= 0 \
                or after.get("spgemm_delta_mispredictions_total") != 0:
            return _fail(proc, "the delta accountability series: "
                               f"{after.get('spgemm_delta_dirty_fraction_count')} observations, "
                               f"{after.get('spgemm_delta_mispredictions_total')} "
                               "mispredictions")
        if ("spgemm_hbm_peak_bytes" in after) != (args.device == "cuda"):
            return _fail(proc, "the device memory gauges: present on the card, absent on "
                               f"the CPU; got {after.get('spgemm_hbm_peak_bytes')}")
        if after.get('spgemm_slo_latency_seconds{quantile="0.5",tenant="default"}', 0) <= 0 \
                or after.get('spgemm_slo_error_ratio{tenant="default"}') != 0.0:
            return _fail(proc, "the SLO families did not judge the done job")

        r = _cli("profile", "--socket", sock, "--json")
        if r.returncode != 0:
            return _fail(proc, f"cli profile failed: {r.stderr[-500:]}")
        recs = json.loads(r.stdout)["compiles"]
        for site in sites:
            if not any(x["site"] == site and isinstance(x.get("built"), bool)
                       and x["wall_s"] > 0 for x in recs):
                return _fail(proc, f"cli profile --json lists no build record for {site}: "
                                   f"{recs}")
        r = _cli("slo", "--socket", sock, "--json")
        if r.returncode != 0:
            return _fail(proc, f"cli slo failed: {r.stderr[-500:]}")
        row = json.loads(r.stdout)["tenants"].get("default", {})
        if row.get("jobs") != 1 or row.get("error_ratio") != 0:
            return _fail(proc, f"cli slo --json: the default tenant's row {row}")

        r = _cli("events", "--socket", sock, "--tail", "200")
        if r.returncode != 0:
            return _fail(proc, f"cli events failed: {r.stderr[-500:]}")
        kinds = {rec["kind"] for rec in map(json.loads, r.stdout.splitlines())
                 if rec.get("job_id") == job_id}
        if not {"job_submit", "job_start", "job_done"} <= kinds:
            return _fail(proc, f"the event log lacks {job_id}'s lifecycle: {sorted(kinds)}")
        if not os.path.exists(sock + ".events.jsonl"):
            return _fail(proc, "the event log's JSONL is not next to the journal")
        evs = client.trace(sock)
        for ev in evs:
            need = {"name", "ph", "pid", "tid"} | ({"ts"} if ev.get("ph") != "M" else set())
            if not need <= set(ev):
                return _fail(proc, f"a malformed trace event: {ev}")
        tagged = [ev for ev in evs if ev.get("args", {}).get("job_id") == job_id]
        if not tagged:
            return _fail(proc, f"no span carries job_id={job_id}")
        dump = os.path.join(tmp, "flight.trace.json")
        r = _cli("trace-dump", "--socket", sock, "-o", dump)
        if r.returncode != 0 or not json.load(open(dump, encoding="utf-8")):
            return _fail(proc, f"cli trace-dump failed: {r.stderr[-500:]}")
        why = _stop(proc, sock, client)
        if why:
            return _fail(proc, why)
    finally:
        if proc.poll() is None:
            proc.kill()
    rc = _slo_burn_leg(tmp, folder, args.device)
    if rc != 0:
        return rc
    print(f"obs-smoke: OK (phase, plan-cache, build, accuracy and SLO series moved; profile, "
          f"slo and events CLIs answered; {len(evs)} trace events, {len(tagged)} tagged "
          f"{job_id}; burn leg stitched; clean shutdown)")
    return 0


def _slo_burn_leg(tmp: str, folder: str, device: str) -> int:
    """A wedged pickup's reap flips spgemm_slo_burn_active, lands a slo_burn
    event carrying the client-minted trace id, and that id resolves through
    `cli trace-dump --merge` to one trace with spans of both processes."""
    from spgemm_tpu_torch.obs import trace as obs_trace  # noqa: PLC0415
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    sock = os.path.join(tmp, "d2.sock")
    env = _env(SPGEMM_TPU_SLO_TARGET_S="60", SPGEMM_TPU_SLO_WINDOW_S="600",
               SPGEMM_TPU_SERVE_WEDGE_GRACE_S="2",
               SPGEMM_TPU_FAILPOINTS="serve.executor:1:1")
    proc, why = _start(sock, device, env)
    if why:
        return _fail(proc, why)
    try:
        resp = client.submit(folder, sock, {"output": os.path.join(tmp, "matrix.wedge"),
                                            "timeout_s": 1.0})
        job_id, trace_id = resp["id"], resp.get("trace")
        if not isinstance(trace_id, str) or len(trace_id) != 32:
            return _fail(proc, f"the submit returned no 128-bit trace id ({trace_id!r})")
        job = client.wait(job_id, sock, timeout=120)["job"]
        if job["state"] != "failed" or job["error"]["code"] != "job-timeout":
            return _fail(proc, f"the wedged job was not reaped job-timeout: {job}")
        burning = None
        deadline = time.time() + 60
        while burning is None and time.time() < deadline:
            burning = next((s for s, v in parse_prometheus(client.metrics(sock)).items()
                            if s.startswith("spgemm_slo_burn_active{") and v == 1.0), None)
            if burning is None:
                time.sleep(0.2)
        if burning is None or 'tenant="default"' not in burning:
            return _fail(proc, f"spgemm_slo_burn_active did not flip for the default tenant "
                               f"after the reap ({burning})")
        active = [b for b in client.slo(sock)["burn"] if b["active"]]
        if not active or active[0].get("trace_id") != trace_id:
            return _fail(proc, f"the slo report's burning window does not name the submit's "
                               f"trace {trace_id}: {active}")
        burns = [r for r in client.events(200, sock) if r.get("kind") == "slo_burn"]
        if len(burns) != 1 or burns[0].get("trace_id") != trace_id:
            return _fail(proc, f"want one slo_burn event with trace {trace_id}, got {burns}")
        stitch = os.path.join(tmp, "stitch")
        obs_trace.dump_json(os.path.join(stitch, "client.trace.json"),
                            process_name="obs-smoke-client")
        r = _cli("trace-dump", "--socket", sock, "-o", os.path.join(stitch, "daemon.trace.json"))
        if r.returncode != 0:
            return _fail(proc, f"the burn leg's trace-dump failed: {r.stderr[-500:]}")
        merged_path = os.path.join(tmp, "merged.trace.json")
        r = _cli("trace-dump", "--merge", stitch, "--trace", trace_id, "-o", merged_path)
        if r.returncode != 0:
            return _fail(proc, f"cli trace-dump --merge failed: {r.stderr[-500:]}")
        spans = [ev for ev in json.load(open(merged_path, encoding="utf-8"))
                 if ev.get("ph") != "M"]
        pids = {ev["pid"] for ev in spans}
        names = {ev["name"] for ev in spans}
        if len(pids) < 2 or "client_submit" not in names \
                or not any((ev.get("args") or {}).get("job_id") == job_id for ev in spans):
            return _fail(proc, f"the merge did not stitch the client's and the daemon's spans "
                               f"of {job_id} (pids {pids}, names {sorted(names)})")
        why = _stop(proc, sock, client)
        if why:
            return _fail(proc, why)
    finally:
        if proc.poll() is None:
            proc.kill()
    print(f"obs-smoke: burn leg OK ({burning} -> slo_burn trace {trace_id} stitched across "
          f"{len(pids)} processes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
