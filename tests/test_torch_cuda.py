"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (kernel 1 in
both variants, the limb kernel) against their plain PyTorch versions on the
card, and the hybrid chain against the exact one.  Tolerance: exact
(torch.equal).

Imports torch, numpy and the port only, so it runs on a machine without JAX.
There, the shared tests/conftest.py (which imports jax) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card each test skips."""

import numpy as np
import pytest
import torch

from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import cuda_mxu, cuda_spgemm, mxu_spgemm
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.utils.gen import random_chain, random_values


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _case(rng, k, lead, P, n_tiles, device, dist="adversarial"):
    tiles = [random_values((n_tiles + 1, k, k), rng, dist) for _ in range(2)]
    for t in tiles:
        t[-1] = 0
    pa = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pb = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pad = np.arange(P) >= rng.integers(0, P + 1, size=lead)[..., None]
    pa[pad] = n_tiles
    pb[pad] = n_tiles
    return [torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64 else x).to(device)
            for x in (*tiles, pa, pb)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,lead,P", [(1, (37,), 5), (8, (3, 9), 3), (32, (40,), 7),
                                      (64, (5,), 4), (32, (4,), 300), (16, (0,), 4)])
def test_kernel_matches_plain_version(cuda, k, lead, P):
    args = _case(np.random.default_rng(k + P), k, lead, P, 30, cuda)
    before = cuda_spgemm.launches
    got = cuda_spgemm.numeric_round(*args)
    want = cuda_spgemm.numeric_round_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cuda_spgemm.launches == before + (1 if np.prod(lead) else 0)


@pytest.mark.cuda
def test_chain_on_card_matches_cpu(cuda):
    mats = random_chain(5, 6, 8, 0.4, np.random.default_rng(3), "adversarial")
    got = chain_product(mats, device=cuda)
    want = chain_product(mats, device="cpu")
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("k,lead,P", [(1, (37,), 5), (8, (3, 9), 3), (32, (40,), 7),
                                      (64, (5,), 4), (32, (4,), 300), (16, (0,), 4)])
def test_no_mod_kernel_matches_plain_version(cuda, k, lead, P):
    args = _case(np.random.default_rng(k + P + 1), k, lead, P, 30, cuda)
    before = cuda_spgemm.launches_no_mod
    got = cuda_spgemm.numeric_round(*args, no_mod=True)
    want = cuda_spgemm.numeric_round_ref(*args, no_mod=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cuda_spgemm.launches_no_mod == before + (1 if np.prod(lead) else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k,lead,P,limbs,dist", [
    (1, (37,), 5, 10, "adversarial"), (8, (3, 9), 3, 10, "adversarial"),
    (32, (40,), 7, 10, "adversarial"), (64, (5,), 4, 3, "small"),
    (32, (6,), 300, 3, "small"), (4, (9,), 6, 1, "small"), (16, (0,), 4, 5, "small")])
def test_mxu_kernel_matches_plain_version(cuda, k, lead, P, limbs, dist):
    args = _case(np.random.default_rng(k + P + 2), k, lead, P, 30, cuda, dist)
    before = cuda_mxu.launches
    got = cuda_mxu.numeric_round_mxu(*args, a_limbs=limbs, b_limbs=limbs)
    want = mxu_spgemm.numeric_round_mxu_ref(*args, a_limbs=limbs, b_limbs=limbs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cuda_mxu.launches == before + (1 if np.prod(lead) else 0)


@pytest.mark.cuda
def test_mxu_kernel_refuses_deep_rounds(cuda):
    args = _case(np.random.default_rng(4), 32, (2,), 4097, 30, cuda, "small")
    with pytest.raises(ValueError, match="2\\^17"):
        cuda_mxu.numeric_round_mxu(*args)


@pytest.mark.cuda
def test_hybrid_chain_on_card_matches_exact(cuda, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_HYBRID_GATE", "proof")
    mats = random_chain(4, 6, 8, 0.4, np.random.default_rng(6), "small")
    before = dict(engine.rounds_by_kernel)
    got = chain_product(mats, device=cuda, backend="hybrid")
    assert engine.rounds_by_kernel["mxu"] > before["mxu"]
    assert got == chain_product(mats, device=cuda)
