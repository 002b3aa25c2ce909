"""The port's multi-process chain distribution (spgemm_tpu_torch/parallel/
multihost.py, `cli --distributed`) on gloo CPU ranks, against the JAX
package: P real processes of tests/_torch_multihost_worker.py (torch, numpy
and the port only) against JAX's chain_product_partitioned at the same P,
and at P = 2 against the JAX `--distributed` run itself (the unchanged
tests/_multihost_worker.py); the chunked exchange against the padded one on
skewed partials, its logged peak within P x SPGEMM_TPU_DCN_CHUNK_MB; a
partner that dies or stops failing the survivor within the heartbeat window
with PartnerLostError and no output, and a slow one waited for; budget skew
and a budget below one tile raising ValueError on every rank; the CLI's --distributed (P = 1 without the coordinator variables,
P = 2 as processes against --ranks 2, mxu refused, the flags it ignores
noted); the knobs and ENGINE names against the JAX registries.  The JAX side
runs with SPGEMM_TPU_DELTA=0 (ROADMAP.md faults).  Tolerance: byte equality
of the written matrices and equality of the gathered arrays.

Every subprocess has its own timeout.  The JAX test's retry on gloo's
`EnforceNotMet ... preamble` race is not copied: it has not shown up under
torch's gloo."""

import contextlib
import io
import logging
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from spgemm_tpu import cli as jax_cli
from spgemm_tpu.obs import metrics as jax_metrics
from spgemm_tpu.parallel.chainpart import chain_product_partitioned as jax_partitioned
from spgemm_tpu.utils import io_text as jax_io_text
from spgemm_tpu.utils import knobs as jax_knobs
from spgemm_tpu.utils.gen import random_chain as jax_random_chain
from spgemm_tpu_torch import cli
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.obs import metrics
from spgemm_tpu_torch.obs import trace as obs_trace
from spgemm_tpu_torch.parallel import multihost
from spgemm_tpu_torch.utils import io_text, knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain
from spgemm_tpu_torch.utils.timers import ENGINE

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_multihost_worker.py")
JAX_WORKER = os.path.join(HERE, "_multihost_worker.py")
TIMEOUT_S = 150  # each worker process's own limit

LEDGER = re.compile(
    r"dcn exchange: (\d+) ranks, max partial (\d+) tiles -> (\d+) chunk "
    r"rounds of <=(\d+) tiles; peak exchange buffer ([\d.]+) MiB "
    r"\(bound: P x SPGEMM_TPU_DCN_CHUNK_MB = ([\d.]+) MiB\)")


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    for name in ("JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "SPGEMM_TPU_DCN_CHUNK_MB", "SPGEMM_TPU_DCN_HEARTBEAT_S"):
        monkeypatch.delenv(name, raising=False)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(argvs: list[list[str]], envs: list[dict], cwds=None) -> tuple[list, list[str], float]:
    """Start one process per argv at once; (return codes, outputs, seconds
    until the last ended).  Each has TIMEOUT_S; on a timeout all are killed
    and the test fails."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                              cwd=(cwds or [None] * len(argvs))[i])
             for i, (argv, env) in enumerate(zip(argvs, envs))]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT_S)
            outs.append(out.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait(timeout=30)
        pytest.fail("multi-process workers timed out")
    return [p.returncode for p in procs], outs, time.perf_counter() - t0


def _workers(tmp_path, num_procs: int, n_mats: int, *mode, env_of=None):
    """num_procs port workers on one coordinator; env_of(rank) adds to a
    rank's environment."""
    coord = f"127.0.0.1:{_free_port()}"
    base = {k: v for k, v in os.environ.items() if not k.startswith("SPGEMM_TPU_DCN")}
    return _spawn(
        [[sys.executable, WORKER, coord, str(num_procs), str(r), str(tmp_path), str(n_mats),
          *mode] for r in range(num_procs)],
        [{**base, **(env_of(r) if env_of else {})} for r in range(num_procs)])


def _jax_bytes(mats, num_procs: int, path) -> bytes:
    jax_io_text.write_matrix(str(path), jax_partitioned(mats, num_procs))
    return path.read_bytes()


# ---------------------------------------------------------- (a) processes --
@pytest.mark.parametrize("num_procs,n_mats", [
    (2, 5),   # two ranks
    (4, 7),   # P = 4, every rank active
    (4, 3),   # N < P: ranks 1-3 idle (the reference's q == 0 branch)
])
def test_multi_process_chain_matches_jax_partitioned(tmp_path, num_procs, n_mats):
    rcs, outs, _ = _workers(tmp_path, num_procs, n_mats)
    for rc, out in zip(rcs, outs):
        assert rc == 0, out[-2000:]
    mats = jax_random_chain(n_mats, 4, 2, 0.5, np.random.default_rng(777), "full")
    assert (tmp_path / "out").read_bytes() == _jax_bytes(mats, num_procs, tmp_path / "jax")
    owners = [re.search(r"process (\d+)/(\d+) owns chain\[(.*)\]", out).groups() for out in outs]
    assert [o[:2] for o in owners] == [(str(r), str(num_procs)) for r in range(num_procs)]
    if n_mats < num_procs:
        assert [o[2] for o in owners[1:]] == ["None"] * (num_procs - 1)
    # every rank's spans carry its rank and world: the merged dump shows who did what
    merged = obs_trace.merge_trace_files(
        [str(tmp_path / f"trace_{r}.json") for r in range(num_procs)])
    tagged = {(e["args"].get("rank"), e["args"].get("world")) for e in merged
              if e.get("name") == "dcn_exchange"}
    assert tagged == {(r, num_procs) for r in range(num_procs)}


def test_p2_matches_the_jax_distributed_run(tmp_path):
    """The port's two processes and the JAX package's own two (the unchanged
    tests/_multihost_worker.py on jax.distributed) write the same bytes."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}  # the worker pins cpu
    coord = f"127.0.0.1:{_free_port()}"
    rcs, outs, _ = _spawn([[sys.executable, JAX_WORKER, coord, "2", str(r),
                            str(tmp_path / "jax"), "5"] for r in range(2)], [env, env])
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    rcs, outs, _ = _workers(tmp_path / "port", 2, 5)
    assert rcs == [0, 0], outs[0][-2000:]
    assert (tmp_path / "port" / "out").read_bytes() == (tmp_path / "jax" / "out").read_bytes()


# ------------------------------------------------------- (c) the exchange --
def test_skewed_partials_chunked_exchange(tmp_path):
    """Rank 0's partial holds 600 tiles, rank 1's 7, and the chunk budget
    (0.01 MiB: 72 tiles of 144 B at k 4) is below the big partial: both
    flavours gather every rank's partial exactly, the logged peak is within
    P x budget over several rounds, and the padded path says so loudly."""
    rcs, outs, _ = _workers(tmp_path, 2, 600, "exchange",
                            env_of=lambda r: {"SPGEMM_TPU_DCN_CHUNK_MB": "0.01"})
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    ledger = LEDGER.search(outs[0])
    assert ledger, f"missing exchange ledger line in:\n{outs[0][-2000:]}"
    p, max_nnzb, n_chunks, chunk_tiles, peak_mb, bound_mb = ledger.groups()
    assert (int(p), int(max_nnzb), int(chunk_tiles), int(n_chunks)) == (2, 600, 72, 9)
    assert float(peak_mb) <= float(bound_mb) == 2 * 0.01
    assert "LEGACY PADDED" in outs[0]
    sys.path.insert(0, HERE)
    try:
        from _torch_multihost_worker import skewed_partial
    finally:
        sys.path.remove(HERE)
    for flavour in ("chunked", "padded"):
        got = np.load(tmp_path / f"exchange_{flavour}.npz")
        assert len(got.files) == 5  # coords and tiles of both ranks, their dims
        for r in range(2):
            want = skewed_partial(r, 600)
            assert np.array_equal(got[f"coords{r}"], want.coords), (flavour, r)
            assert np.array_equal(got[f"tiles{r}"], want.tiles), (flavour, r)
            assert got["dims"][r].tolist() == [want.rows, want.cols]


# ----------------------------------------------------- (d) partner loss --
def test_partner_loss_fails_fast(tmp_path):
    """The last rank dies hard right after joining; the survivor, waiting at
    the exchange, sees its heartbeat stand still and fails with
    PartnerLostError once the 5 s window lapses, far inside the timeout, and
    writes nothing."""
    rcs, outs, seconds = _workers(tmp_path, 2, 5, "die",
                                  env_of=lambda r: {"SPGEMM_TPU_DCN_HEARTBEAT_S": "5"})
    assert rcs[1] == 17, outs[1][-500:]
    assert rcs[0] not in (0, None), outs[0][-2000:]
    assert "PartnerLostError" in outs[0], outs[0][-2000:]
    assert "DCN partner lost during partial-product exchange" in outs[0]
    assert seconds < 60
    assert not (tmp_path / "out").exists(), "no output after partner loss"


def test_a_slow_partner_outlasts_the_window(tmp_path):
    """The last rank's sub-chain runs three 2 s windows past its partner's.
    The survivor waits at the exchange while the slow rank beats, so the run
    ends as the JAX package's does, with JAX's bytes; a window that bounded
    every wait would have failed it."""
    rcs, outs, seconds = _workers(tmp_path, 2, 5, "slow",
                                  env_of=lambda r: {"SPGEMM_TPU_DCN_HEARTBEAT_S": "2"})
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    assert seconds > 6
    mats = jax_random_chain(5, 4, 2, 0.5, np.random.default_rng(777), "full")
    assert (tmp_path / "out").read_bytes() == _jax_bytes(mats, 2, tmp_path / "jax")


def test_a_silent_partner_fails_the_survivor(tmp_path):
    """The last rank stops (SIGSTOP) in its loader: its sockets stay open and
    its heartbeat stands still.  The survivor fails with PartnerLostError
    naming it within the 3 s window and some slack, and writes nothing."""
    coord = f"127.0.0.1:{_free_port()}"
    base = {k: v for k, v in os.environ.items() if not k.startswith("SPGEMM_TPU_DCN")}
    procs = [subprocess.Popen([sys.executable, WORKER, coord, "2", str(r), str(tmp_path), "5",
                               "stop"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              env={**base, "SPGEMM_TPU_DCN_HEARTBEAT_S": "3"})
             for r in range(2)]
    try:
        out, _ = procs[0].communicate(timeout=TIMEOUT_S)
        out = out.decode()
        stopped = procs[1].poll() is None
    finally:
        for proc in procs:
            proc.kill()
            proc.communicate(timeout=30)
    assert stopped, "the silent rank ended on its own"
    assert procs[0].returncode != 0, out[-2000:]
    assert "PartnerLostError" in out and "Rank(s) [1] neither reached the exchange" in out, \
        out[-2000:]
    assert not (tmp_path / "out").exists()


# ----------------------------------------------------- (e) config errors --
@pytest.mark.parametrize("case", ["skew", "tiny"])
def test_budget_errors_raise_value_error_on_every_rank(tmp_path, case):
    """A budget that differs across ranks, or one below a tile, is a config
    error on every rank, not partner loss and not a hang."""
    if case == "skew":
        env_of = lambda r: {"SPGEMM_TPU_DCN_CHUNK_MB": "64" if r == 0 else "32"}  # noqa: E731
        want = "SPGEMM_TPU_DCN_CHUNK_MB differs across ranks"
    else:
        env_of = lambda r: {"SPGEMM_TPU_DCN_CHUNK_MB": "0.00001"}  # noqa: E731
        want = "SPGEMM_TPU_DCN_CHUNK_MB=1e-05 cannot fit even one k=2 tile"
    rcs, outs, _ = _workers(tmp_path, 2, 5, env_of=env_of)
    for rc, out in zip(rcs, outs):
        assert rc != 0
        assert "ValueError: " + want in out, out[-2000:]
        assert "PartnerLostError" not in out
    assert not (tmp_path / "out").exists()


# ------------------------------------------------ in-process, no group --
def _partial(seed: int, nnzb: int, k: int = 2) -> BlockSparseMatrix:
    """nnzb random tiles at random coords of a 32 x 32 tile grid."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(32 * 32, size=nnzb, replace=False))
    coords = np.stack(np.divmod(idx, 32), axis=1).astype(np.int64)
    tiles = rng.integers(0, 1 << 64, size=(nnzb, k, k), dtype=np.uint64)
    return BlockSparseMatrix(rows=32 * k, cols=32 * k, k=k, coords=coords, tiles=tiles)


@pytest.mark.parametrize("chunk_mb, rounds", [("64", 1), ("0.0005", 9)])
def test_one_process_exchange_in_rounds(monkeypatch, caplog, chunk_mb, rounds):
    """P = 1 without a group: the chunked exchange gives the partial back
    exactly, in ceil(nnzb / chunk_tiles) rounds (0.0005 MiB: 10 tiles of
    48 B), with its ledger line."""
    monkeypatch.setenv("SPGEMM_TPU_DCN_CHUNK_MB", chunk_mb)
    part = _partial(1, 90)
    ENGINE.reset()
    with caplog.at_level(logging.INFO, logger="spgemm_tpu_torch.multihost"):
        got = multihost._allgather_partials(part, 2)
    assert len(got) == 1 and got[0] == part
    assert ENGINE.counter_snapshot()["dcn_chunks"] == rounds
    assert "dcn_exchange" in ENGINE.snapshot()
    assert LEDGER.search(caplog.text).group(3) == str(rounds)


def test_one_process_padded_and_idle(monkeypatch, caplog):
    monkeypatch.setenv("SPGEMM_TPU_DCN_CHUNK_MB", "0")
    part = _partial(2, 5)
    with caplog.at_level(logging.WARNING, logger="spgemm_tpu_torch.multihost"):
        assert multihost._allgather_partials(part, 2) == [part]
    assert "LEGACY PADDED" in caplog.text
    assert multihost._allgather_partials(None, 2) == []  # an idle rank's own view
    monkeypatch.setenv("SPGEMM_TPU_DCN_CHUNK_MB", "64")
    assert multihost._allgather_partials(None, 2) == []


@pytest.mark.parametrize("value, match", [("0.00001", "cannot fit even one k=2 tile"),
                                          ("-1", "must be a number >= 0"),
                                          ("x", "must be a number >= 0")])
def test_a_bad_budget_raises_naming_the_knob(monkeypatch, value, match):
    monkeypatch.setenv("SPGEMM_TPU_DCN_CHUNK_MB", value)
    with pytest.raises(ValueError, match="SPGEMM_TPU_DCN_CHUNK_MB") as e:
        multihost._allgather_partials(_partial(3, 4), 2)
    assert match in str(e.value)


@pytest.mark.parametrize("err, lost", [
    (dist.DistBackendError("backend gone"), True),
    (RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection closed by peer [127.0.0.1]:1"),
     True),
    (RuntimeError("[gloo/transport/tcp/unbound_buffer.cc:129] Timed out waiting 5000ms for "
                  "recv operation to complete"), True),
    (RuntimeError("Connection reset by peer"), True),
    (RuntimeError("shape mismatch"), False),
    (ValueError("Connection closed by peer"), False),
    (multihost.PartnerLostError("Connection closed by peer"), False),
])
def test_partner_loss_is_matched_narrowly(err, lost):
    assert multihost._partner_lost(err) is lost


@pytest.mark.parametrize("err, raised", [
    (RuntimeError("Connection closed by peer [127.0.0.1]:9"), multihost.PartnerLostError),
    (RuntimeError("out of memory"), RuntimeError),
    (ValueError("SPGEMM_TPU_DCN_CHUNK_MB differs across ranks"), ValueError),
])
def test_chain_product_multihost_wraps_only_partner_loss(monkeypatch, capsys, err, raised):
    def exchange(partial, k):
        raise err

    monkeypatch.setattr(multihost, "_allgather_partials", exchange)
    mats = random_chain(3, 4, 2, 0.5, np.random.default_rng(5), "full")
    with pytest.raises(raised) as e:
        multihost.chain_product_multihost(mats, 2, device="cpu")
    assert type(e.value) is raised
    if raised is multihost.PartnerLostError:
        assert e.value.__cause__ is err


def test_run_distributed_without_a_group_is_the_chain(capsys):
    assert not dist.is_initialized()
    multihost.init_from_env()  # JAX_COORDINATOR unset: a no-op
    assert not dist.is_initialized() and multihost.world() == (1, 0)
    mats = random_chain(5, 4, 2, 0.5, np.random.default_rng(6), "adversarial")
    obs_trace.RECORDER.clear()
    got = multihost.run_distributed("unused", 2, 5, lambda s, e: mats[s:e + 1], device="cpu")
    assert got == chain_product(mats, device="cpu")
    spans = [s for s in obs_trace.RECORDER.snapshot() if s["name"] == "dcn_chain"]
    assert spans and all(s["tags"] == {"rank": 0, "world": 1} for s in spans)


# ------------------------------------------------------------ (f) the CLI --
def _chain_dir(tmp_path, n: int = 5, dist_name: str = "adversarial") -> str:
    folder = str(tmp_path / "chain")
    io_text.write_chain_dir(folder, random_chain(n, 4, 2, 0.5, np.random.default_rng(44),
                                                 dist_name), 2)
    return folder


def _run(fn, folder, out, *extra) -> tuple[bytes, list[str], str]:
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        assert fn([folder, "--device", "cpu", "--output", out, *extra]) == 0
    with open(out, "rb") as f:
        return f.read(), buf.getvalue().splitlines(), err.getvalue()


def test_cli_distributed_without_the_variables_is_p1(tmp_path):
    """No coordinator: one process, P = 1, the plain run's bytes and lines,
    and the JAX CLI's --distributed run's."""
    folder = _chain_dir(tmp_path)
    got, lines, err = _run(cli.run, folder, str(tmp_path / "d"), "--distributed")
    want, want_lines, _ = _run(cli.run, folder, str(tmp_path / "p1"))
    jax_got, jax_lines, _ = _run(jax_cli.run, folder, str(tmp_path / "jax"), "--distributed")
    assert got == want == jax_got
    assert lines[:-1] == want_lines[:-1] == jax_lines[:-1]
    assert lines[-1].startswith("time taken ") and err == ""


def test_cli_distributed_refuses_mxu(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.run([_chain_dir(tmp_path), "--device", "cpu", "--distributed", "--backend", "mxu"])
    assert e.value.code == 2
    assert "--distributed runs the exact fold" in capsys.readouterr().err


@pytest.mark.parametrize("extra, note", [
    (["--ranks", "2"], "--ranks ignored with --distributed"),
    (["--shard", "chain"], "--shard chain ignored with --distributed"),
    (["--shard", "keys"], "--shard keys ignored with --distributed"),
    (["--checkpoint-dir", "CK"], "--checkpoint-dir ignored with --distributed"),
    (["--failover"], "--failover ignored with --distributed"),
    (["--stream"], "--stream/--out-of-core ignored: the oracle backend is host-only"),
    (["--out-of-core"], "--stream/--out-of-core ignored: the oracle backend is host-only"),
    (["--backend", "hybrid"], "--backend hybrid with --distributed runs the exact fold"),
    (["--backend", "oracle"], "--backend oracle with --distributed runs the exact fold"),
])
def test_cli_distributed_notes_each_flag_it_ignores(tmp_path, extra, note):
    folder = _chain_dir(tmp_path)
    extra = [str(tmp_path / "ck") if a == "CK" else a for a in extra]
    got, _, err = _run(cli.run, folder, str(tmp_path / "d"), "--distributed", *extra)
    want, _, _ = _run(cli.run, folder, str(tmp_path / "p1"))
    assert got == want
    assert err.splitlines() == [line for line in err.splitlines() if line.startswith(note)]
    assert len(err.splitlines()) == 1
    assert not (tmp_path / "ck").exists()


def test_cli_distributed_without_a_card_fails_before_joining(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("JAX_COORDINATOR", f"127.0.0.1:{_free_port()}")  # nobody serves it
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cli.run([_chain_dir(tmp_path), "--distributed"])
    assert not dist.is_initialized() and not (tmp_path / "matrix").exists()


def test_cli_distributed_processes_match_ranks(tmp_path):
    """`python -m spgemm_tpu_torch.cli <folder> --distributed --device cpu`
    as two processes, each in its own directory: rank 0's ./matrix is
    --ranks 2's, rank 1 writes none, and each rank prints its own
    `multiplying` lines and `time taken`."""
    folder = _chain_dir(tmp_path)
    want, _, _ = _run(cli.run, folder, str(tmp_path / "ranks2"), "--ranks", "2")
    p1, _, _ = _run(cli.run, folder, str(tmp_path / "p1"))
    assert want != p1  # adversarial values: P = 2 changes the bytes
    coord = f"127.0.0.1:{_free_port()}"
    cwds = [tmp_path / f"r{r}" for r in range(2)]
    for d in cwds:
        d.mkdir()
    envs = [{**os.environ, "PYTHONPATH": REPO, "JAX_COORDINATOR": coord,
             "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(r)} for r in range(2)]
    rcs, outs, _ = _spawn([[sys.executable, "-m", "spgemm_tpu_torch.cli", folder,
                            "--distributed", "--device", "cpu"]] * 2, envs, cwds)
    assert rcs == [0, 0], outs[0][-2000:] + outs[1][-2000:]
    assert (cwds[0] / "matrix").read_bytes() == want
    assert not (cwds[1] / "matrix").exists()
    # rank 0 owns matrices 0-1 (one multiply), rank 1 2-4 (two); two in the combine
    lines = [[ln for ln in out.splitlines() if not ln.startswith("[")] for out in outs]
    assert lines[0][:-1] == ["multiplying 0 1"] * 2
    assert lines[1][:-1] == ["multiplying 0 1"] * 3
    assert all(ls[-1].startswith("time taken ") for ls in lines)


# ------------------------------------------------------- the registries --
@pytest.mark.parametrize("name, values", [
    ("SPGEMM_TPU_DCN_CHUNK_MB", (None, "", "64", "0", "0.01", " 2 ", "-1", "x")),
    ("SPGEMM_TPU_DCN_HEARTBEAT_S", (None, "", "5", "1", "0", "1.5", "x")),
])
def test_the_dcn_knobs_parse_like_jax(name, values, monkeypatch):
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


def test_the_heartbeat_default_is_jax_s_window_not_gloo_s(monkeypatch):
    """Unset, the window is 100 s (the JAX package's documented window), not
    gloo's 30 minutes: the group's timeout and the heartbeat's; the knob's
    help says so."""
    seen = {}
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **kw: seen.update(kw, args=a))
    monkeypatch.setenv("JAX_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "3")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    multihost.init_from_env()
    assert seen["args"] == ("gloo",) and seen["init_method"] == "tcp://127.0.0.1:1"
    assert (seen["world_size"], seen["rank"]) == (3, 2)
    assert seen["timeout"].total_seconds() == 100
    monkeypatch.setenv("SPGEMM_TPU_DCN_HEARTBEAT_S", "7")
    multihost.init_from_env()
    assert seen["timeout"].total_seconds() == 7
    assert multihost._heartbeat_s() == 7 and multihost._period(7) == 0.35
    monkeypatch.delenv("SPGEMM_TPU_DCN_HEARTBEAT_S")
    assert multihost._heartbeat_s() == 100 and multihost._period(100) == 1.0
    assert "100 s" in knobs.REGISTRY["SPGEMM_TPU_DCN_HEARTBEAT_S"].doc


def test_the_dcn_engine_names_keep_jax_s_help():
    assert metrics.ENGINE_PHASES["dcn_exchange"] == jax_metrics.ENGINE_PHASES["dcn_exchange"]
    assert metrics.ENGINE_COUNTERS["dcn_chunks"] == jax_metrics.ENGINE_COUNTERS["dcn_chunks"]
    assert {"dcn_chain", "dcn_combine"} <= set(metrics.ENGINE_PHASES)

