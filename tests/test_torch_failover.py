"""Failover in the port: chain_product(failover=True) restarting a failed
pass on the host oracle (under mxu the field-mode oracle) when the
subprocess CUDA probe (spgemm_tpu_torch/utils/backend_probe.py) finds no
working card, and raising when it finds one or when the chain runs on the
CPU; the CLI's --failover with the same probe.  Failover happens only when
asked for.  These tests run on the CPU: where a test stands for a chain on a
card that is then lost, it stubs chain._on_card (the chain's device) as it
stubs the probe.  Results are held against the port's and the JAX package's
python-int oracles.  Tolerance: exact."""

import io
import os
import contextlib

import numpy as np
import pytest
import torch

from spgemm_tpu.utils.semantics import chain_oracle as jax_chain_oracle
from spgemm_tpu_torch import chain, cli
from spgemm_tpu_torch.ops import delta
from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops.cuda_mxu import numeric_round_mxu
from spgemm_tpu_torch.ops.cuda_spgemm import numeric_round
from spgemm_tpu_torch.ops.spgemm import Folds, spgemm_device, spgemm_outofcore
from spgemm_tpu_torch.utils import backend_probe
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import random_chain
from spgemm_tpu_torch.utils.semantics import chain_oracle, field_spgemm_oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_chain")


@pytest.fixture(autouse=True)
def _fresh_delta_store():
    """The port's delta store is process-wide: a chain another test ran on
    the same inputs would be answered from it, and the failing folds below
    would not run."""
    delta.clear()


class DeviceLost(RuntimeError):
    pass


class Abort(BaseException):
    pass


class _NotLost(ValueError):
    def __init__(self, msg):
        super().__init__(f"{msg}: not a lost card")


def _failing_fold(n: int, exc=DeviceLost):
    """Kernel 1's fold that raises on its n-th call (1-based) and after."""
    calls = []

    def fold(*args, **kw):
        calls.append(1)
        if len(calls) >= n:
            raise exc("the card was lost")
        return numeric_round(*args, **kw)

    return Folds(exact=fold)


def _failing_mxu_fold(n: int):
    """The limb kernel's fold that raises on its n-th call and after."""
    calls = []

    def fold(*args, **kw):
        calls.append(1)
        if len(calls) >= n:
            raise DeviceLost("the card was lost")
        return numeric_round_mxu(*args, **kw)

    return Folds(mxu=fold)


def _on_a_card(monkeypatch) -> None:
    """The chain runs on the CPU here; stand it in for a chain on a card,
    which failover may find lost.  raising=False: the check is what the
    field-mode and CPU fixes added."""
    monkeypatch.setattr(chain, "_on_card", lambda device: True, raising=False)


def _mats(n=5, seed=30):
    return random_chain(n, 5, 2, 0.5, np.random.default_rng(seed), "adversarial")


def _oracle(mats):
    blocks = chain_oracle([m.to_dict() for m in mats], mats[0].k)
    jax_blocks = jax_chain_oracle([m.to_dict() for m in mats], mats[0].k)
    assert blocks.keys() == jax_blocks.keys()
    assert all(np.array_equal(blocks[key], jax_blocks[key]) for key in blocks)
    return BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, mats[0].k, blocks)


def _probe(monkeypatch, outcome: str | None) -> list:
    """Stand in for the subprocess probe: it reports `outcome`, or with
    None it must not run.  Returns the list of its calls."""
    calls = []

    def probe():
        if outcome is None:
            raise AssertionError("the probe ran")
        calls.append(outcome)
        return outcome

    monkeypatch.setattr(backend_probe, "probe_default_backend", probe)
    return calls


@pytest.mark.parametrize("multiply", [None, spgemm_outofcore], ids=["resident", "ooc"])
@pytest.mark.parametrize("nth", [1, 2, 4, 8])
def test_failing_fold_fails_over_to_the_oracle(nth, multiply, monkeypatch, capsys):
    """A fold that raises on its nth call (one call a round), on a card the
    probe finds lost, gives the oracle's bytes, with one line on stderr."""
    probes = _probe(monkeypatch, "error")
    _on_a_card(monkeypatch)
    mats = _mats()
    got = chain_product(mats, device="cpu", folds=_failing_fold(nth), failover=True,
                        multiply=multiply)
    assert got == _oracle(mats)
    assert probes == ["error"]
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].startswith("chain failover:") and "DeviceLost" in err[0]
    assert "CUDA probe: error" in err[0]


@pytest.mark.parametrize("multiply", [None, spgemm_outofcore], ids=["resident", "ooc"])
def test_a_fault_on_a_working_card_is_raised(multiply, monkeypatch, capsys):
    """failover=True is for a lost card: when the probe finds the card
    working, the failing fold's error is the program's and is raised."""
    probes = _probe(monkeypatch, "ok")
    _on_a_card(monkeypatch)
    with pytest.raises(DeviceLost):
        chain_product(_mats(), device="cpu", folds=_failing_fold(2), failover=True,
                      multiply=multiply)
    assert probes == ["ok"]
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("multiply", [None, spgemm_outofcore], ids=["resident", "ooc"])
def test_a_fault_on_the_cpu_is_raised(multiply, monkeypatch, capsys):
    """A chain on the CPU has no card to lose: a failing multiply raises
    and the probe never runs, whatever it would report."""
    _probe(monkeypatch, None)
    with pytest.raises(ValueError, match="not a lost card"):
        chain_product(_mats(), device="cpu", folds=_failing_fold(2, _NotLost), failover=True,
                      multiply=multiply)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("nth", [1, 3])
def test_mxu_failover_stays_in_field_mode(nth, monkeypatch, capsys):
    """Under mxu a lost card fails over to the field-mode oracle: the chain
    equals mxu without a failure and the field oracle's chain, not the
    reference's fold (these values make the two differ)."""
    probes = _probe(monkeypatch, "error")
    _on_a_card(monkeypatch)
    mats = _mats(seed=32)
    k = mats[0].k
    field = BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, k, chain_oracle(
        [m.to_dict() for m in mats], k, multiply=field_spgemm_oracle))
    assert field != _oracle(mats)
    assert chain_product(mats, device="cpu", backend="mxu") == field
    delta.clear()  # the failing fold must run, not the retained results
    got = chain_product(mats, device="cpu", backend="mxu", folds=_failing_mxu_fold(nth),
                        failover=True)
    assert got == field
    assert probes == ["error"]
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "field-mode oracle" in err[0]


def test_without_failover_it_raises(monkeypatch, capsys):
    _probe(monkeypatch, None)
    with pytest.raises(DeviceLost):
        chain_product(_mats(), device="cpu", folds=_failing_fold(2))
    assert capsys.readouterr().err == ""


def test_base_exception_passes_through(monkeypatch, capsys):
    """An abort is not device loss: failover must not catch it."""
    _probe(monkeypatch, None)
    with pytest.raises(Abort):
        chain_product(_mats(), device="cpu", folds=_failing_fold(2, Abort), failover=True)
    assert capsys.readouterr().err == ""


def _oracle_spy(monkeypatch):
    calls = []
    real = chain.oracle_multiply

    def spy(a, b, **kw):
        calls.append((a.nnzb, b.nnzb))
        return real(a, b, **kw)

    monkeypatch.setattr(chain, "oracle_multiply", spy)
    return calls


def _failing_multiply(n: int):
    """spgemm_device that raises on its n-th multiply (1-based) and after."""
    calls = []

    def multiply(a, b, **kw):
        calls.append(1)
        if len(calls) >= n:
            raise DeviceLost("the card was lost")
        return spgemm_device(a, b, **kw)

    return multiply


def test_failover_with_checkpoint_restarts_from_the_newest_pass(tmp_path, monkeypatch, capsys):
    _probe(monkeypatch, "timeout")
    _on_a_card(monkeypatch)
    mats = _mats()
    want = _oracle(mats)
    calls = _oracle_spy(monkeypatch)
    ck = str(tmp_path / "ck")
    # 5 -> 3 -> 2 -> 1: the third multiply is pass 2's only one
    got = chain_product(mats, device="cpu", multiply=_failing_multiply(3), failover=True,
                        checkpoint_dir=ck)
    assert got == want
    assert len(calls) == 2  # pass 2 and pass 3 on the oracle; pass 1 was kept
    assert sorted(os.listdir(ck)) == ["pass_1.npz", "pass_2.npz", "pass_3.npz"]
    # a resumed run whose first multiply fails restarts at the resumed pass
    calls.clear()
    os.remove(os.path.join(ck, "pass_3.npz"))
    assert chain_product(mats, device="cpu", multiply=_failing_multiply(1), failover=True,
                         checkpoint_dir=ck) == want
    assert len(calls) == 1  # pass 3 alone
    assert capsys.readouterr().err.count("chain failover:") == 2
    # other inputs skip the passes written for these and start from pass 1
    calls.clear()
    other = _mats(seed=31)
    assert chain_product(other, device="cpu", multiply=_failing_multiply(1), failover=True,
                         checkpoint_dir=ck) == _oracle(other)
    assert len(calls) == 4  # 5 -> 3 -> 2 -> 1, every multiply on the oracle


def _cli(argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.run(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("outcome,probes", [("error", 2), ("timeout", 1), ("cpu", 1)])
def test_cli_failover_probe_falls_back_to_cpu(outcome, probes, tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(backend_probe, "probe_default_backend",
                        lambda: seen.append(1) or outcome)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "matrix")
    rc, stdout, stderr = _cli([GOLDEN, "--failover", "--output", out])
    assert rc == 0 and len(seen) == probes
    assert stderr.splitlines() == [
        f"--failover: CUDA device unusable (probe: {outcome}); falling back to cpu"]
    with open(out, "rb") as f, open(GOLDEN + "_expected_matrix", "rb") as g:
        assert f.read() == g.read()
    assert stdout.splitlines()[:-1] == ["multiplying 0 1", "multiplying 0 1"]


def test_failover_to_cpu_keeps_a_live_card(monkeypatch, capsys):
    monkeypatch.setattr(backend_probe, "probe_default_backend", lambda: "ok")
    assert backend_probe.failover_to_cpu("--failover") is False
    assert capsys.readouterr().err == ""


def test_without_failover_the_probe_never_runs(tmp_path, monkeypatch):
    def refuse():
        raise AssertionError("probe ran without --failover")

    monkeypatch.setattr(backend_probe, "probe_default_backend", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "matrix")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _cli([GOLDEN, "--output", out])
    assert not os.path.exists(out)
    rc, _, stderr = _cli([GOLDEN, "--device", "cpu", "--failover", "--output", out])
    assert rc == 0 and stderr == ""  # --device cpu: nothing to probe
    rc, _, _ = _cli([GOLDEN, "--backend", "oracle", "--failover", "--output", out])
    assert rc == 0  # the oracle is host-only: nothing to probe


def test_probe_outcomes_in_a_subprocess(monkeypatch):
    """The real probe: this machine's torch has no card ('cpu' here, 'ok'
    on a card); a crash is 'error', a hang past the limit 'timeout'."""
    assert backend_probe.probe_default_backend() == \
        ("ok" if torch.cuda.is_available() else "cpu")
    monkeypatch.setattr(backend_probe, "_PROBE", "raise SystemExit(3)")
    assert backend_probe.probe_default_backend() == "error"
    monkeypatch.setattr(backend_probe, "_PROBE", "import time; time.sleep(30)")
    assert backend_probe.probe_default_backend(timeout_s=0.5) == "timeout"
    monkeypatch.setenv("SPGEMM_TPU_PROBE_TIMEOUT", "-1")
    with pytest.raises(ValueError, match="SPGEMM_TPU_PROBE_TIMEOUT"):
        backend_probe.probe_default_backend()
