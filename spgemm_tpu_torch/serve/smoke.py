"""End-to-end proof of the port's spgemmd (the port's copy of the JAX
package's `serve/smoke.py`, without its two-slice leg):

    python -m spgemm_tpu_torch.serve.smoke [--device cuda|cpu]

starts `python -m spgemm_tpu_torch.cli serve` on a temporary socket
(`--device cuda`, the default, needs a card) and checks:

  * two submits of one small chain: both equal to the host oracle's bytes,
    and the second job's detail reports plan_cache_hits >= 1;
  * a third submit after one tile of one input changed: the oracle's bytes
    of the edited chain, and 0 < delta_rows < total_rows (delta recompute);
  * a healthy `stats` (not degraded, no degrade counted) and a clean
    shutdown (exit 0, socket removed);
  * a restart on the same socket and warm directory: the edited chain again,
    warm_hits >= 1, no delta full fallback, delta_rows == 0 < total_rows (the
    rehydrated retained result answers), the oracle's bytes, clean shutdown;
  * the batching leg: a third daemon on its own socket with
    SPGEMM_TPU_SERVE_BATCH_WINDOW_S=0.5, SPGEMM_TPU_SERVE_BATCH_K=8 and
    SPGEMM_TPU_DELTA=0; one warm-up submit (it runs solo and records the
    chain's structure), then three back-to-back submits: one shared `batch`
    id, `stats` with serve_batches >= 1, every output the oracle's bytes,
    and on the card kernel-1 launches in each member's detail; clean
    shutdown.

Every job must report degraded false and, on the card, the first and the
edited job kernel-1 launches (`launches_numeric_round`) > 0; the unchanged
resubmits are answered by delta and launch nothing.  Any failed check
exits 1.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time


def _fail(proc: subprocess.Popen | None, msg: str) -> int:
    print(f"serve-smoke: FAIL: {msg}", file=sys.stderr)
    if proc is not None:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        with open(proc.log_path) as f:
            sys.stderr.write(f.read()[-4000:])
    return 1


def _start(sock: str, device: str, env: dict) -> tuple[subprocess.Popen, str | None]:
    """The daemon as a subprocess, its output to <sock>.log; (proc, None)
    once its socket is bound, or (proc, why not)."""
    with open(sock + ".log", "a") as log_f:
        proc = subprocess.Popen([sys.executable, "-m", "spgemm_tpu_torch.cli", "serve",
                                 "--socket", sock, "--device", device, "-v"],
                                env=env, stdout=log_f, stderr=subprocess.STDOUT)
    proc.log_path = sock + ".log"
    deadline = time.time() + 300
    while not os.path.exists(sock):
        if proc.poll() is not None:
            return proc, "the daemon exited before binding its socket"
        if time.time() > deadline:
            return proc, "the daemon never bound its socket"
        time.sleep(0.1)
    return proc, None


def _stop(proc: subprocess.Popen, sock: str, client) -> str | None:
    """Shut the daemon down; None when it exited 0 and removed its socket."""
    client.shutdown(sock)
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        return "the daemon did not exit after shutdown"
    if rc != 0:
        return f"the daemon exited {rc} after shutdown"
    if os.path.exists(sock):
        return "the socket was not removed at shutdown"
    return None


def _run(client, folder: str, sock: str, out: str, want: bytes, device: str,
         launches: bool = True):
    """One submit, waited for; (job snapshot, None) or (job, why it failed).
    launches: on the card, kernel 1 must have run (a resubmit that delta
    answers in full launches nothing)."""
    resp = client.wait(client.submit(folder, sock, {"output": out})["id"], sock, timeout=600)
    job = resp["job"]
    if job["state"] != "done":
        return job, f"job {job['id']} ended {job['state']}: {job['error']}"
    if open(out, "rb").read() != want:
        return job, f"job {job['id']}'s output differs from the oracle's bytes"
    det = job["detail"]
    if det.get("degraded") is not False:
        return job, f"job {job['id']} ran degraded"
    if launches and device == "cuda" and det.get("launches_numeric_round", 0) < 1:
        return job, f"job {job['id']} launched kernel 1 no time on the card"
    return job, None


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python -m spgemm_tpu_torch.serve.smoke",
                                description="end-to-end proof of the port's spgemmd")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)

    import numpy as np  # noqa: PLC0415

    from spgemm_tpu_torch.serve import client  # noqa: PLC0415
    from spgemm_tpu_torch.utils import io_text  # noqa: PLC0415
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix  # noqa: PLC0415
    from spgemm_tpu_torch.utils.gen import random_chain  # noqa: PLC0415
    from spgemm_tpu_torch.utils.semantics import chain_oracle  # noqa: PLC0415

    def oracle_bytes(mats, k):
        blocks = chain_oracle([m.to_dict() for m in mats], k)
        return io_text.format_matrix(
            BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, k, blocks).prune_zeros())

    tmp = tempfile.mkdtemp(prefix="spgemmd-smoke-")
    sock = os.path.join(tmp, "d.sock")
    folder = os.path.join(tmp, "chain_in")
    n, k = 4, 4
    mats = random_chain(n, 6, k, 0.5, np.random.default_rng(7), "full")
    io_text.write_chain_dir(folder, mats, k)
    want = oracle_bytes(mats, k)
    # the restart leg reads the socket's own warm directory
    env = {name: v for name, v in os.environ.items() if not name.startswith("SPGEMM_TPU_WARM")}
    proc = None
    try:
        proc, err = _start(sock, args.device, env)
        if err:
            return _fail(proc, err)
        jobs = []
        for i in (1, 2):
            job, err = _run(client, folder, sock, os.path.join(tmp, f"matrix.{i}"), want,
                            args.device, launches=i == 1)
            if err:
                return _fail(proc, err)
            jobs.append(job)
        hits = jobs[1]["detail"].get("plan_cache_hits", 0)
        if hits < 1:
            return _fail(proc, f"the second submit reported plan_cache_hits={hits}")

        # one tile of one input changes value (structure kept)
        m0 = mats[0]
        tiles = m0.tiles.copy()
        tiles[0] = tiles[0] + np.uint64(1)
        mats[0] = BlockSparseMatrix(rows=m0.rows, cols=m0.cols, k=k, coords=m0.coords,
                                    tiles=tiles)
        io_text.write_matrix(os.path.join(folder, "matrix1"), mats[0])
        want3 = oracle_bytes(mats, k)
        job3, err = _run(client, folder, sock, os.path.join(tmp, "matrix.3"), want3,
                         args.device)
        if err:
            return _fail(proc, err)
        delta_rows = job3["detail"].get("delta_rows", 0)
        total_rows = job3["detail"].get("total_rows", 0)
        if not 0 < delta_rows < total_rows:
            return _fail(proc, f"the edited submit recomputed delta_rows={delta_rows} of "
                               f"total_rows={total_rows} (want 0 < delta_rows < total_rows)")
        st = client.stats(sock)
        if st.get("degraded") or st["serve"]["serve_degrades"]:
            return _fail(proc, f"the daemon degraded: {st.get('degrade_reason')}")
        err = _stop(proc, sock, client)
        if err:
            return _fail(proc, err)

        # restart on the same warm directory
        if not any(name.endswith(".npz") for name in os.listdir(sock + ".warm")):
            return _fail(None, "the first daemon left no warm entries")
        proc, err = _start(sock, args.device, env)
        if err:
            return _fail(proc, err)
        job4, err = _run(client, folder, sock, os.path.join(tmp, "matrix.4"), want3,
                         args.device, launches=False)
        if err:
            return _fail(proc, err)
        det = job4["detail"]
        if det.get("warm_hits", 0) < 1:
            return _fail(proc, f"the restarted daemon's job reported warm_hits="
                               f"{det.get('warm_hits', 0)}")
        if det.get("delta_full_fallbacks", 0) or not (
                det.get("delta_rows", -1) == 0 < det.get("total_rows", 0)):
            return _fail(proc, "the restarted daemon did not answer from the rehydrated "
                               f"result: delta_rows={det.get('delta_rows')} total_rows="
                               f"{det.get('total_rows')} fallbacks="
                               f"{det.get('delta_full_fallbacks')}")
        err = _stop(proc, sock, client)
        if err:
            return _fail(proc, err)

        # the batching leg
        sock_b = os.path.join(tmp, "batch.sock")
        env_b = {**env, "SPGEMM_TPU_SERVE_BATCH_WINDOW_S": "0.5",
                 "SPGEMM_TPU_SERVE_BATCH_K": "8", "SPGEMM_TPU_DELTA": "0"}
        proc, err = _start(sock_b, args.device, env_b)
        if err:
            return _fail(proc, err)
        _, err = _run(client, folder, sock_b, os.path.join(tmp, "matrix.warmup"), want3,
                      args.device)
        if err:
            return _fail(proc, err)
        outs = [os.path.join(tmp, f"matrix.b{i}") for i in range(3)]
        ids = [client.submit(folder, sock_b, {"output": o})["id"] for o in outs]
        bjobs = [client.wait(j, sock_b, timeout=600)["job"] for j in ids]
        for job, out in zip(bjobs, outs):
            if job["state"] != "done":
                return _fail(proc, f"batch job {job['id']} ended {job['state']}: "
                                   f"{job['error']}")
            if open(out, "rb").read() != want3:
                return _fail(proc, f"batch job {job['id']}'s output differs from the "
                                   "oracle's bytes")
            if args.device == "cuda" and job["detail"].get("launches_numeric_round", 0) < 1:
                return _fail(proc, f"batch job {job['id']} saw no kernel-1 launch")
        batch_ids = {job["batch"] for job in bjobs}
        if None in batch_ids or len(batch_ids) != 1:
            return _fail(proc, f"the three submits did not share one batch (ids {batch_ids})")
        batches = client.stats(sock_b)["serve"]["serve_batches"]
        if batches < 1:
            return _fail(proc, f"stats reports serve_batches={batches} (want >= 1)")
        err = _stop(proc, sock_b, client)
        if err:
            return _fail(proc, err)
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"serve-smoke: OK on {args.device} (8 jobs equal to the oracle; plan_cache_hits="
          f"{hits}; delta rows {delta_rows}/{total_rows}; restart: warm_hits="
          f"{det['warm_hits']}, delta rows 0/{det['total_rows']}; batching leg: 3 jobs in "
          f"batch {batch_ids.pop()}, serve_batches={batches}, the oracle's bytes; three "
          "clean shutdowns)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
