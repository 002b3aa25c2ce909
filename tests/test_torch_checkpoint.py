"""The port's checkpoint and resume (spgemm_tpu_torch/utils/checkpoint.py
and chain_product's checkpoint_dir): the JAX package's test_checkpoint.py
cases for the port, and checkpoint directories written by either package
resumed in the other (JAX side with SPGEMM_TPU_DELTA=0).  Tolerance: exact."""

import os

import numpy as np
import pytest

from spgemm_tpu.chain import chain_product as jax_chain_product
from spgemm_tpu.utils import checkpoint as jax_checkpoint
from spgemm_tpu.utils.gen import random_chain as jax_random_chain
from spgemm_tpu_torch.chain import chain_product as port_chain_product
from spgemm_tpu_torch.utils import checkpoint
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain


def chain_product(mats, **kw):
    return port_chain_product(mats, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _jax_delta_off(monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")


def _same(m, w) -> bool:
    return (m.rows, m.cols, m.k) == (w.rows, w.cols, w.k) \
        and np.array_equal(m.coords, w.coords) and np.array_equal(m.tiles, w.tiles)


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(400)
    mats = random_chain(3, 4, 2, 0.5, rng, "full")
    path = checkpoint.save_pass(str(tmp_path), 2, mats)
    assert os.path.exists(path)
    idx, loaded = checkpoint.latest_pass(str(tmp_path))
    assert idx == 2
    assert loaded == mats


def test_latest_pass_picks_newest(tmp_path):
    rng = np.random.default_rng(401)
    checkpoint.save_pass(str(tmp_path), 1, random_chain(2, 3, 2, 0.5, rng))
    mats3 = random_chain(1, 3, 2, 0.5, rng)
    checkpoint.save_pass(str(tmp_path), 3, mats3)
    idx, loaded = checkpoint.latest_pass(str(tmp_path))
    assert idx == 3 and loaded == mats3


def test_latest_pass_empty(tmp_path):
    assert checkpoint.latest_pass(str(tmp_path / "nope")) is None
    assert checkpoint.latest_pass(str(tmp_path)) is None


def test_latest_pass_falls_back_past_truncated_newest(tmp_path, caplog):
    rng = np.random.default_rng(404)
    mats2 = random_chain(2, 3, 2, 0.5, rng, "full")
    checkpoint.save_pass(str(tmp_path), 2, mats2)
    path3 = checkpoint.save_pass(str(tmp_path), 3, random_chain(1, 3, 2, 0.5, rng, "full"))
    with open(path3, "r+b") as f:  # tear the newest file mid-archive
        f.truncate(os.path.getsize(path3) // 2)
    with caplog.at_level("WARNING", logger="spgemm_tpu_torch.checkpoint"):
        idx, loaded = checkpoint.latest_pass(str(tmp_path))
    assert idx == 2 and loaded == mats2
    assert any("pass_3.npz" in r.getMessage() for r in caplog.records)


def test_latest_pass_all_corrupt_returns_none(tmp_path):
    (tmp_path / "pass_1.npz").write_bytes(b"not an npz at all")
    (tmp_path / "pass_2.npz").write_bytes(b"")
    assert checkpoint.latest_pass(str(tmp_path)) is None


def test_chain_resume_survives_truncated_newest(tmp_path, capsys):
    rng = np.random.default_rng(405)
    mats = random_chain(5, 4, 2, 0.5, rng, "full")
    want = chain_product(mats)
    arr = [chain_product(mats[i : i + 2]) for i in range(0, 4, 2)] + [mats[4]]
    ckdir = str(tmp_path / "ck")
    checkpoint.save_pass(ckdir, 1, arr)
    bad = checkpoint.save_pass(ckdir, 2, arr)  # pose as a newer, torn pass
    with open(bad, "r+b") as f:
        f.truncate(16)
    garbage = random_chain(5, 4, 2, 0.5, np.random.default_rng(998))
    assert chain_product(garbage, checkpoint_dir=ckdir) == want


@pytest.mark.parametrize("multiply", ["resident", "stream", "ooc"])
def test_chain_with_checkpointing_matches_plain(multiply, tmp_path, capsys):
    from spgemm_tpu_torch.ops import spgemm as engine
    fn = {"resident": None, "stream": engine.spgemm, "ooc": engine.spgemm_outofcore}[multiply]
    rng = np.random.default_rng(402)
    mats = random_chain(5, 4, 2, 0.5, rng, "full")
    plain = chain_product(mats)
    ckpt = chain_product(mats, checkpoint_dir=str(tmp_path / "ck"), multiply=fn)
    assert ckpt == plain
    # passes for n=5: 5 -> 3 -> 2 -> 1 (three snapshots)
    assert sorted(os.listdir(tmp_path / "ck")) == ["pass_1.npz", "pass_2.npz", "pass_3.npz"]


def test_chain_resume_from_partial(tmp_path, capsys):
    """Kill after pass 1, restart: the same result, passes 2..3 recomputed
    (their progress lines only)."""
    rng = np.random.default_rng(403)
    mats = random_chain(5, 4, 2, 0.5, rng, "full")
    want = chain_product(mats)
    arr = [chain_product(mats[i : i + 2]) for i in range(0, 4, 2)] + [mats[4]]
    ckdir = str(tmp_path / "ck")
    checkpoint.save_pass(ckdir, 1, arr)
    capsys.readouterr()
    # the inputs are garbage: the resume alone must produce the result
    garbage = random_chain(5, 4, 2, 0.5, np.random.default_rng(999))
    assert chain_product(garbage, checkpoint_dir=ckdir) == want
    assert capsys.readouterr().out.splitlines() == ["multiplying 0 1", "multiplying 0 1"]
    assert chain_product(garbage, checkpoint_dir=ckdir, resume=False) != want


def test_jax_checkpoint_resumes_in_port_and_back(tmp_path, capsys):
    """A pass_1.npz written by the JAX package's chain resumes in the port,
    and one written by the port resumes in the JAX package, each giving the
    JAX package's bytes for the whole chain."""
    mats = jax_random_chain(6, 5, 2, 0.5, np.random.default_rng(406), "adversarial")
    want = jax_chain_product(mats, backend="xla")
    garbage = jax_random_chain(6, 5, 2, 0.5, np.random.default_rng(997), "adversarial")

    jax_dir = str(tmp_path / "from_jax")
    jax_chain_product(mats, backend="xla", checkpoint_dir=jax_dir)
    for name in ("pass_2.npz", "pass_3.npz"):
        os.remove(os.path.join(jax_dir, name))  # leave pass 1 only
    got = chain_product([BlockSparseMatrix.from_reference(m) for m in garbage],
                        checkpoint_dir=jax_dir)
    assert _same(got, want)

    port_dir = str(tmp_path / "from_port")
    chain_product([BlockSparseMatrix.from_reference(m) for m in mats], checkpoint_dir=port_dir)
    for name in ("pass_2.npz", "pass_3.npz"):
        os.remove(os.path.join(port_dir, name))
    idx, loaded = jax_checkpoint.latest_pass(port_dir)
    _, ours = checkpoint.latest_pass(port_dir)
    assert idx == 1 and len(ours) == len(loaded) == 3
    assert all(_same(x, y) for x, y in zip(ours, loaded))
    assert _same(jax_chain_product(garbage, backend="xla", checkpoint_dir=port_dir), want)


def test_resume_skips_passes_written_for_other_inputs(tmp_path, caplog, capsys):
    """A directory reused for another chain: the port's passes carry a
    fingerprint of their chain's inputs, so the other chain skips them (with
    a warning), runs every pass, and leaves passes that resume it."""
    mats = random_chain(5, 4, 2, 0.5, np.random.default_rng(407), "full")
    other = random_chain(5, 4, 2, 0.5, np.random.default_rng(996), "full")
    ckdir = str(tmp_path / "ck")
    chain_product(mats, checkpoint_dir=ckdir)
    os.remove(os.path.join(ckdir, "pass_3.npz"))
    want = chain_product(other)
    capsys.readouterr()
    with caplog.at_level("WARNING", logger="spgemm_tpu_torch.checkpoint"):
        assert chain_product(other, checkpoint_dir=ckdir) == want
    assert "written for other inputs" in caplog.text
    assert capsys.readouterr().out.splitlines() == [
        "multiplying 0 1", "multiplying 2 3", "multiplying 0 1", "multiplying 0 1"]
    os.remove(os.path.join(ckdir, "pass_3.npz"))
    assert chain_product(other, checkpoint_dir=ckdir) == want
    assert capsys.readouterr().out.splitlines() == ["multiplying 0 1"]
    assert checkpoint.inputs_fingerprint(other) != checkpoint.inputs_fingerprint(mats)


def _arith_chain():
    """Values where the reference's fold and field mode differ."""
    mats = random_chain(5, 4, 2, 0.6, np.random.default_rng(408), "adversarial")
    want = {b: chain_product(mats, backend=b) for b in ("exact", "mxu")}
    assert want["exact"] != want["mxu"]
    return mats, want


@pytest.mark.parametrize("first,second", [("mxu", "exact"), ("exact", "mxu"),
                                          ("mxu", "hybrid")])
def test_resume_keeps_the_arithmetic(first, second, tmp_path, caplog, capsys):
    """A pass carries its arithmetic (field for mxu, exact otherwise): a run
    in the other arithmetic on the same directory skips it and gives its own
    bytes, even after the first run finished."""
    mats, want = _arith_chain()
    want["hybrid"] = want["exact"]
    ckdir = str(tmp_path / "ck")
    assert chain_product(mats, backend=first, checkpoint_dir=ckdir) == want[first]
    with caplog.at_level("WARNING", logger="spgemm_tpu_torch.checkpoint"):
        assert chain_product(mats, backend=second, checkpoint_dir=ckdir) == want[second]
    assert "written for other arithmetic" in caplog.text
    capsys.readouterr()
    # the second run's passes now resume the second arithmetic
    os.remove(os.path.join(ckdir, "pass_3.npz"))
    assert chain_product(mats, backend=second, checkpoint_dir=ckdir) == want[second]
    assert capsys.readouterr().out.splitlines() == ["multiplying 0 1"]


def test_exact_passes_resume_under_hybrid(tmp_path, capsys):
    """exact and hybrid give the same bytes, so they share the tag."""
    mats, want = _arith_chain()
    ckdir = str(tmp_path / "ck")
    chain_product(mats, backend="exact", checkpoint_dir=ckdir)
    os.remove(os.path.join(ckdir, "pass_3.npz"))
    capsys.readouterr()
    assert chain_product(mats, backend="hybrid", checkpoint_dir=ckdir) == want["exact"]
    assert capsys.readouterr().out.splitlines() == ["multiplying 0 1"]
    assert [checkpoint.arithmetic(b) for b in ("exact", "hybrid", "mxu")] == \
        ["exact", "exact", "field"]


def test_cli_resume_keeps_the_arithmetic(tmp_path, capsys):
    """The CLI: an mxu run's checkpoint directory, reused by an exact run,
    gives exact's ./matrix, and the other way round."""
    from spgemm_tpu_torch import cli
    from spgemm_tpu_torch.utils import io_text

    mats, _ = _arith_chain()
    folder = str(tmp_path / "in")
    io_text.write_chain_dir(folder, mats, mats[0].k)
    outs = {}
    for backend in ("exact", "mxu"):
        outs[backend] = str(tmp_path / f"plain_{backend}")
        assert cli.run([folder, "--device", "cpu", "--backend", backend,
                        "--output", outs[backend]]) == 0
    for order in (("mxu", "exact"), ("exact", "mxu")):
        ckdir = str(tmp_path / f"ck_{order[0]}")
        for backend in order:
            out = str(tmp_path / f"{order[0]}_then_{backend}")
            assert cli.run([folder, "--device", "cpu", "--backend", backend,
                            "--checkpoint-dir", ckdir, "--output", out]) == 0
            with open(out, "rb") as f, open(outs[backend], "rb") as g:
                assert f.read() == g.read(), (order, backend)
    capsys.readouterr()
