"""Tests of the port that need an NVIDIA GPU: the CUDA kernels (kernel 1 in
both variants, the limb kernel, the two bsmm kernels) against their plain
PyTorch versions on the card (the limb kernel also on sentinel slots, every
limb count, the deepest rounds at full range, ragged k and unaligned
slabs; kernel 3 at every ring depth, warp tile, row tile and grid), the
hybrid chain against the exact one, out-of-core and --ranks on the card
against the resident and CPU results, failover with a failing fold
(falling back when the probe reports a lost card, raising when the real
probe finds the card working), the FFN forward against its plain
version, the delta splice against splice_ref and a delta chain against
the full one, the port's daemon (`cli serve` without --device) serving a
chain on the card, and the segmented fold of the dense route against its plain
version (any seg, sentinel and pad slots, no rows), against kernel 1 on a
planner's round, raising on what it does not take, and a hub multiply on
every route; the FFN training step's kernels (the gelu_grad epilogue of
kernels 3 and 4, kernel 5 of csrc/bsmm_grad.cu at any M; its wgmma body
bit-equal to its mma.sync body in both forms (one tile a block, a block
over half a run) and at every ring depth, stage depth and grid, over runs
of 1 to 4 pairs sharing a strip) against their
plain versions and one step against the plain autograd step; the output-sharded
multiply (parallel/rowshard) over [cuda:0] * n against spgemm_device on
banded and random chains, and `--shard keys` on the golden data; the
field-mode kernels of inner and ring sharding (csrc/field_fold.cu: F1 in
both instances, F3, F2) against their plain versions on edge values at k 1
to 64 with 31 and 33, sentinel-heavy lists, P = 0, K = 0, P * k > 2^17 and
F3 cells of 1 to 300 pairs with every other row untouched, spgemm_inner and
spgemm_ring over [cuda:0] * n (overlap on and off; F3 at most n^2 launches
a multiply) against the same on ["cpu"] * n, chain_product_on_devices against
chain_product_partitioned, and `--shard inner|ring|chain` on the golden
data.  Tolerance: exact (torch.equal)
for the integer kernels and between the two bsmm kernels; for bsmm against
bsmm_ref 1e-5 in float32 and one bf16 ulp (2^-7 relative) in bfloat16, since
both sum the same products in float32 in another order and round once.

Imports torch, numpy and the port only, so it runs on a machine without JAX.
There, the shared tests/conftest.py (which imports jax) is skipped:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card each test skips."""

import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.models import ffn
from spgemm_tpu_torch.ops import (cuda_bsmm, cuda_bsmm_grad, cuda_dense, cuda_field, cuda_mxu,
                                  cuda_splice, cuda_spgemm)
from spgemm_tpu_torch.ops import delta, mxu_spgemm
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.parallel.mesh import train_mesh
from spgemm_tpu_torch.parallel.chainpart import (chain_product_on_devices,
                                                 chain_product_partitioned)
from spgemm_tpu_torch.parallel.innershard import spgemm_inner
from spgemm_tpu_torch.parallel.ring import spgemm_ring
from spgemm_tpu_torch.parallel.rowshard import spgemm_sharded
from spgemm_tpu_torch.utils.gen import banded_block_sparse, random_chain, random_values
from spgemm_tpu_torch.utils.timers import ENGINE


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _launches(kernel: str) -> int:
    """The kernel's ENGINE launch counter, bumped by its wrapper where it
    launches and nowhere else."""
    return ENGINE.counter_snapshot().get(f"launches_{kernel}", 0)


@pytest.fixture(autouse=True)
def _fresh_delta_store():
    """The port's delta store is process-wide: a chain an earlier test ran
    on the same inputs would be answered from it."""
    delta.clear()


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
    before = _launches("numeric_round")
    got = cuda_spgemm.numeric_round(*args)
    want = cuda_spgemm.numeric_round_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _launches("numeric_round") == before + (1 if np.prod(lead) else 0)


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
    before = _launches("numeric_round_no_mod")
    got = cuda_spgemm.numeric_round(*args, no_mod=True)
    want = cuda_spgemm.numeric_round_ref(*args, no_mod=True)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _launches("numeric_round_no_mod") == before + (1 if np.prod(lead) else 0)


def _sentinel_case(rng, k, K, P, n_tiles, pattern, device, dist):
    """A round whose sentinel slots are laid out by `pattern`: "pad_keys"
    (every third key all sentinel), "one_sided" (pa or pb alone a sentinel),
    "between" (both, between real slots), "dirty" (the same with a last tile
    that is not zero: the kernel must skip it as the plain version does)."""
    a, b, pa, pb = _case(rng, k, (K,), P, n_tiles, "cpu", dist)
    pa, pb = pa.numpy(), pb.numpy()
    pa[:] = rng.integers(0, n_tiles, size=pa.shape)
    pb[:] = rng.integers(0, n_tiles, size=pb.shape)
    hole = rng.random(pa.shape) < 0.4
    if pattern == "pad_keys":
        pa[::3] = n_tiles
        pb[::3] = n_tiles
    elif pattern == "one_sided":
        pa[hole] = n_tiles
        pb[(~hole) & (rng.random(pa.shape) < 0.4)] = n_tiles
    else:
        pa[hole] = n_tiles
        pb[hole] = n_tiles
    if pattern == "dirty":
        a[-1] = a[0]
        b[-1] = b[1]
    return [t.to(device) for t in (a, b, torch.from_numpy(pa), torch.from_numpy(pb))]


@pytest.mark.cuda
@pytest.mark.parametrize("no_mod", [False, True], ids=["mod", "no_mod"])
@pytest.mark.parametrize("pattern", ["pad_keys", "one_sided", "between", "dirty"])
@pytest.mark.parametrize("k,K,P", [(1, 300, 9), (2, 200, 7), (4, 90, 6), (8, 70, 5),
                                   (16, 40, 5), (32, 30, 6), (64, 6, 4), (128, 3, 3),
                                   (32, 3, 384), (33, 5, 4)])
def test_kernel_skips_sentinel_slots(cuda, no_mod, pattern, k, K, P):
    rng = np.random.default_rng(k * 1000 + P + len(pattern))
    args = _sentinel_case(rng, k, K, P, 20, pattern, cuda,
                          "small" if no_mod else "adversarial")
    got = cuda_spgemm.numeric_round(*args, no_mod=no_mod)
    want = cuda_spgemm.numeric_round_ref(*args, no_mod=no_mod)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("no_mod", [False, True], ids=["mod", "no_mod"])
def test_kernel_on_a_hub_round_and_empty_rounds(cuda, no_mod):
    """Two keys of 4500 real pairs each at k = 32, then K = 0 and P = 0."""
    rng = np.random.default_rng(5)
    dist = "small" if no_mod else "adversarial"
    args = _case(rng, 32, (2,), 4500, 300, cuda, dist)
    args[2][:] = torch.arange(4500, device=cuda, dtype=torch.int32) % 300
    args[3][:] = torch.arange(4500, device=cuda, dtype=torch.int32).flip(0) % 300
    got = cuda_spgemm.numeric_round(*args, no_mod=no_mod)
    assert torch.equal(got, cuda_spgemm.numeric_round_ref(*args, no_mod=no_mod))
    for lead, P in (((0,), 4), ((3,), 0)):
        args = _case(rng, 16, lead, P, 5, cuda, dist)
        got = cuda_spgemm.numeric_round(*args, no_mod=no_mod)
        torch.cuda.synchronize()
        assert torch.equal(got, cuda_spgemm.numeric_round_ref(*args, no_mod=no_mod))
        assert tuple(got.shape) == (*lead, 16, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("no_mod", [False, True], ids=["mod", "no_mod"])
def test_kernel_geometry_at_k32(cuda, no_mod):
    """At k = 32 the design keeps at least four keys on each SM."""
    g = cuda_spgemm.geometry(32, no_mod=no_mod, device=cuda)
    assert g["blocks_per_sm"] * g["keys_per_block"] >= 4
    assert g["threads"] <= 256 and g["smem_bytes"] <= 48 * 1024


@pytest.mark.cuda
@pytest.mark.parametrize("k,lead,P,limbs,dist", [
    (1, (37,), 5, 10, "adversarial"), (8, (3, 9), 3, 10, "adversarial"),
    (32, (40,), 7, 10, "adversarial"), (64, (5,), 4, 3, "small"),
    (32, (6,), 300, 3, "small"), (4, (9,), 6, 1, "small"), (16, (0,), 4, 5, "small"),
    (16, (3,), 0, 5, "small")])
def test_mxu_kernel_matches_plain_version(cuda, k, lead, P, limbs, dist):
    args = _case(np.random.default_rng(k + P + 2), k, lead, P, 30, cuda, dist)
    before = _launches("numeric_round_mxu")
    got = cuda_mxu.numeric_round_mxu(*args, a_limbs=limbs, b_limbs=limbs)
    want = mxu_spgemm.numeric_round_mxu_ref(*args, a_limbs=limbs, b_limbs=limbs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _launches("numeric_round_mxu") == before + (1 if np.prod(lead) else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["pad_keys", "one_sided", "between", "dirty"])
@pytest.mark.parametrize("k,K,P", [(1, 300, 9), (2, 200, 7), (4, 90, 6), (8, 70, 5),
                                   (16, 40, 5), (32, 30, 6), (64, 6, 4), (128, 3, 3),
                                   (32, 3, 384), (33, 5, 4)])
def test_mxu_kernel_skips_sentinel_slots(cuda, pattern, k, K, P):
    rng = np.random.default_rng(k * 1000 + P + len(pattern) + 7)
    args = _sentinel_case(rng, k, K, P, 20, pattern, cuda, "adversarial")
    got = cuda_mxu.numeric_round_mxu(*args)
    want = mxu_spgemm.numeric_round_mxu_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


MAX = (1 << 64) - 1
EDGE = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                 (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX], dtype=np.uint64)
LIMB_GRID = sorted({(a, b) for a in range(1, 11) for b in (1, 5, 10)}
                   | {(a, b) for a in (1, 5, 10) for b in range(1, 11)})


def _range_tiles(rng, n_tiles, k, n_limbs):
    """(n_tiles + 1, k, k) uint64 below 2^(7 * n_limbs), sentinel zero tile
    last: a third the range's top, a third EDGE values in range, a third
    uniform in range."""
    top = min(MAX, (1 << (7 * n_limbs)) - 1)
    shape = (n_tiles + 1, k, k)
    edge = EDGE[EDGE <= top]
    pick = rng.integers(0, 3, size=shape)
    tiles = np.where(pick == 0, np.uint64(top), edge[rng.integers(0, len(edge), size=shape)])
    tiles = np.where(pick == 2, rng.integers(0, top, size=shape, dtype=np.uint64,
                                             endpoint=True), tiles)
    tiles[-1] = 0
    return tiles


def _to_card(device, *arrays):
    return [torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64 else x).to(device)
            for x in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("a_limbs,b_limbs", LIMB_GRID)
def test_mxu_kernel_at_every_limb_count(cuda, k, a_limbs, b_limbs):
    """Each byte count and the template classes between them, mixed, at the
    top of each limb count's range."""
    rng = np.random.default_rng(1000 * a_limbs + 10 * b_limbs + k)
    n_tiles, K, P = 9, 11, 4
    a, b = _range_tiles(rng, n_tiles, k, a_limbs), _range_tiles(rng, n_tiles, k, b_limbs)
    pa = rng.integers(0, n_tiles + 1, size=(K, P)).astype(np.int32)  # sentinels too
    pb = rng.integers(0, n_tiles + 1, size=(K, P)).astype(np.int32)
    args = _to_card(cuda, a, b, pa, pb)
    got = cuda_mxu.numeric_round_mxu(*args, a_limbs=a_limbs, b_limbs=b_limbs)
    want = mxu_spgemm.numeric_round_mxu_ref(*args, a_limbs=a_limbs, b_limbs=b_limbs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 64])
def test_mxu_kernel_flushes_at_full_depth_and_range(cuda, k):
    """P * k = 2^17 real pairs of values whose bytes are almost all 255: the
    s32 fragments must fold before they overflow."""
    rng = np.random.default_rng(k)
    n_tiles, K, P = 40, 2, (1 << 17) // k
    tiles = [MAX - rng.integers(0, 256, size=(n_tiles + 1, k, k), dtype=np.uint64)
             for _ in range(2)]
    pa = rng.integers(0, n_tiles, size=(K, P)).astype(np.int32)
    pb = rng.integers(0, n_tiles, size=(K, P)).astype(np.int32)
    args = _to_card(cuda, *tiles, pa, pb)
    got = cuda_mxu.numeric_round_mxu(*args)
    want = mxu_spgemm.numeric_round_mxu_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got != 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 31, 33, 64, 128])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
def test_mxu_kernel_ragged_k_and_unaligned_slabs(cuda, k, aligned):
    """k that is not a multiple of 32 (odd k takes 8-byte copies), and slabs
    that start 8 bytes past a 16-byte boundary (8-byte copies at any k)."""
    rng = np.random.default_rng(k + 5 * aligned)
    a, b, pa, pb = _case(rng, k, (6,), 5, 12, cuda)
    if not aligned:
        a, b = [torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape) for x in (a, b)]
        assert a.data_ptr() % 16 == 8 and b.data_ptr() % 16 == 8
    got = cuda_mxu.numeric_round_mxu(a, b, pa, pb)
    want = mxu_spgemm.numeric_round_mxu_ref(a, b, pa, pb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("limbs", [10, 3])
def test_mxu_kernel_geometry(cuda, limbs):
    """Three keys share an SM at 8 x 8 bytes, four at 3 x 3."""
    g = cuda_mxu.geometry(32, limbs, limbs, device=cuda)
    assert g["bytes"] == (mxu_spgemm.bytes_for_limbs7(limbs),) * 2
    assert g["threads"] == 256 and g["blocks_per_sm"] >= (3 if limbs == 10 else 4)


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


@pytest.mark.cuda
@pytest.mark.parametrize("ahead", ["0", "2"])
def test_execute_makes_no_stream_synchronization(cuda, monkeypatch, ahead):
    """On the exact backend, execute queues its index uploads (pinned,
    non_blocking) and launches without waiting for the stream: no call of
    torch.cuda.synchronize or Stream.synchronize, and no synchronizing CUDA
    operation under torch's sync debug mode "error", during a whole chain.
    The result equals the CPU chain's."""
    monkeypatch.setenv("SPGEMM_TPU_PLAN_AHEAD", ahead)
    mats = random_chain(6, 8, 8, 0.4, np.random.default_rng(8), "adversarial")
    want = chain_product(mats, device="cpu")
    dev_mats = [DeviceBlockMatrix.from_host(m, cuda) for m in mats]
    chain_product(dev_mats, device=cuda, keep_device=True)  # builds the kernel
    torch.cuda.synchronize()
    calls, inside = [], []
    real_execute = engine.execute

    def execute(*args, **kw):
        inside.append(1)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_execute(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            inside.pop()

    monkeypatch.setattr(engine, "execute", execute)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **kw: calls.append("synchronize") if inside else None)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        lambda self: calls.append("Stream.synchronize") if inside else None)
    got = chain_product(dev_mats, device=cuda, keep_device=True)
    monkeypatch.undo()
    assert calls == []
    assert got.to_host() == want


BSMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-4)}


def _bsmm_case(seed, M, nb_in, nbc, rpc, k, dtype, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, nb_in * k)).astype(np.float32)
    rows = np.stack([rng.permutation(nb_in)[:rpc] for _ in range(nbc)]).astype(np.int32)
    tiles = (rng.standard_normal((nbc, rpc, k, k)) / np.sqrt(rpc * k)).astype(np.float32)
    return (torch.from_numpy(x).to(device, dtype), torch.from_numpy(rows).to(device),
            torch.from_numpy(tiles).to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("fuse_gelu", [False, True], ids=["plain", "gelu"])
@pytest.mark.parametrize("k,M,nb_in,nbc,rpc,block_m", [
    (16, 96, 8, 6, 3, 32), (32, 128, 6, 5, 4, 64), (64, 64, 4, 3, 2, 64),
    (128, 256, 8, 4, 3, 16)])
def test_bsmm_kernels_match_plain_version(cuda, dtype, fuse_gelu, k, M, nb_in, nbc, rpc,
                                          block_m):
    x, rows, tiles = _bsmm_case(k + M, M, nb_in, nbc, rpc, k, dtype, cuda)
    before = (_launches("bsmm"), _launches("bsmm_resident"))
    got = cuda_bsmm.bsmm(x, rows, tiles, block_m=block_m, fuse_gelu=fuse_gelu)
    got_res = cuda_bsmm.bsmm_resident(x, rows, tiles, block_m=block_m, fuse_gelu=fuse_gelu)
    want = cuda_bsmm.bsmm_ref(x, rows, tiles, fuse_gelu=fuse_gelu)
    torch.cuda.synchronize()
    assert (_launches("bsmm"), _launches("bsmm_resident")) == (before[0] + 1, before[1] + 1)
    assert got.dtype == dtype and got.shape == (M, nbc * k)
    rtol, atol = BSMM_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    assert torch.equal(got, got_res)  # one device body: the same bits
    # nor do the bits depend on block_m
    assert torch.equal(got, cuda_bsmm.bsmm(x, rows, tiles, block_m=M, fuse_gelu=fuse_gelu))


@pytest.mark.cuda
def test_bsmm_kernels_refuse_what_they_do_not_take(cuda):
    x, rows, tiles = _bsmm_case(1, 32, 8, 2, 2, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="k in"):
        cuda_bsmm.bsmm(x, rows, tiles, block_m=16)
    x, rows, tiles = _bsmm_case(2, 16, 128, 1, 1, 128, torch.bfloat16, cuda)  # d_in 16384
    with pytest.raises(ValueError, match="shared memory"):
        cuda_bsmm.bsmm_resident(x, rows, tiles, block_m=16)
    x, rows, tiles = _bsmm_case(3, 32, 4, 2, 2, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_bsmm.bsmm(x, rows, tiles, block_m=8)
    with pytest.raises(TypeError):
        cuda_bsmm.bsmm(x.half(), rows, tiles.half(), block_m=16)


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [False, True, None], ids=["stream", "resident", "auto"])
def test_ffn_forward_kernels_on_card(cuda, resident):
    cfg = ffn.BlockSparseFFNConfig(d_model=512, d_ff=1024, k=32, block_density=0.3,
                                   dtype="float32")
    params = ffn.init_params(cfg, torch.Generator().manual_seed(4), device=cuda)
    x = torch.randn((2, 40, cfg.d_model), generator=torch.Generator().manual_seed(5)).to(cuda)
    before = _launches("bsmm") + _launches("bsmm_resident")
    got = ffn.BlockSparseFFN(params, cfg, device=cuda, block_m=16, resident=resident)(x)
    torch.cuda.synchronize()
    assert _launches("bsmm") + _launches("bsmm_resident") == before + 2
    torch.testing.assert_close(got, ffn.ffn_forward(params, x, cfg), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,k", [(torch.bfloat16, 128), (torch.float32, 64)],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("M", [16, 32, 64, 128, 208, 2048, 8192])
def test_bsmm_resident_panel_counts(cuda, dtype, k, M):
    """Kernel 4 at 1 to 512 row panels of 16 rows: one column a block where
    the panels are few, uneven chunks of columns at M = 2048 (on 132 SMs),
    the whole sweep a block at M = 8192."""
    x, rows, tiles = _bsmm_case(M + k, M, 4, 6, 3, k, dtype, cuda)
    before = _launches("bsmm_resident")
    got = cuda_bsmm.bsmm_resident(x, rows, tiles, block_m=16)
    torch.cuda.synchronize()
    assert _launches("bsmm_resident") == before + 1
    rtol, atol = BSMM_TOL[dtype]
    torch.testing.assert_close(got.float(), cuda_bsmm.bsmm_ref(x, rows, tiles).float(),
                               rtol=rtol, atol=atol)
    assert torch.equal(got, cuda_bsmm.bsmm(x, rows, tiles, block_m=M))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [208, 1024])
def test_bsmm_row_tile_at_block_m_16(cuda, dtype, M):
    """Kernel 3 at block_m 16 takes row_tile's rows; launched at every row
    tile of 16, 32, 64 and 128 that divides M, it gives the same bits."""
    x, rows, tiles = _bsmm_case(M, M, 8, 5, 3, 128, dtype, cuda)
    got = cuda_bsmm.bsmm(x, rows, tiles, block_m=16)
    rtol, atol = BSMM_TOL[dtype]
    torch.testing.assert_close(got.float(), cuda_bsmm.bsmm_ref(x, rows, tiles).float(),
                               rtol=rtol, atol=atol)
    for br in (16, 32, 64, 128):
        if M % br == 0:
            other = cuda_bsmm._launch(x, rows, tiles, 16, False, resident=False, br=br)
            assert torch.equal(got, other), br


@pytest.mark.cuda
@pytest.mark.parametrize("fuse_gelu", [False, True], ids=["plain", "gelu"])
@pytest.mark.parametrize("M", [16, 208, 256, 8192])
@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bsmm_resident_at_every_ring_and_cluster(cuda, dtype, k, M, fuse_gelu):
    """Kernel 4 forced to every ring depth from 2 to resident_layout's
    deepest and every cluster it can take (cluster_sizes: 1 alone at 13
    panels, M = 208, and at one panel) gives kernel 3's bits, and its
    default launch is within tolerance of bsmm_ref."""
    x, rows, tiles = _bsmm_case(M + k, M, 4, 6, 3, k, dtype, cuda)
    want = cuda_bsmm.bsmm(x, rows, tiles, block_m=16, fuse_gelu=fuse_gelu)
    deepest = cuda_bsmm.resident_layout(x.shape[1], 16, x.element_size(), k).stages
    clusters = cuda_bsmm.cluster_sizes(M // 16, k)
    assert 1 in clusters and (M // 16 not in (1, 13) or clusters == (1,))
    before = _launches("bsmm_resident")
    for stages in range(2, deepest + 1):
        for cluster in clusters:
            got = cuda_bsmm._launch(x, rows, tiles, 16, fuse_gelu, resident=True,
                                    cluster=cluster, stages=stages)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (stages, cluster)
    assert _launches("bsmm_resident") == before + (deepest - 1) * len(clusters)
    rtol, atol = BSMM_TOL[dtype]
    got = cuda_bsmm.bsmm_resident(x, rows, tiles, block_m=16, fuse_gelu=fuse_gelu)
    torch.testing.assert_close(got.float(), cuda_bsmm.bsmm_ref(
        x, rows, tiles, fuse_gelu=fuse_gelu).float(), rtol=rtol, atol=atol)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bsmm_resident_refuses_a_ring_or_cluster_it_cannot_take(cuda):
    x, rows, tiles = _bsmm_case(5, 208, 32, 2, 3, 128, torch.bfloat16, cuda)  # 13 panels
    with pytest.raises(ValueError, match="cluster"):
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=True, cluster=2)
    with pytest.raises(ValueError, match="stages"):  # d_in 4096: 3 stages at most
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=True, stages=4)
    x, rows, tiles = _bsmm_case(6, 64, 4, 2, 3, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="cluster"):  # k 16: 16 / 4 rows a block
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=True, cluster=4)


@pytest.mark.cuda
def test_bsmm_resident_clusters_fit_the_card(cuda):
    """cudaOccupancyMaxActiveClusters at full width (d_in 4096, bf16, k 128,
    block_m 16): one block an SM, so at most the SMs at cluster 1, and a
    cluster of C holds C SMs."""
    sms = cuda_bsmm.sm_count(cuda.index or 0)
    got = {c: cuda_bsmm.max_active_clusters(4096, 128, 16, torch.bfloat16, c, cuda.index or 0)
           for c in cuda_bsmm.CLUSTER_SIZES}
    assert got[1] == sms
    for c, n in got.items():
        assert 0 < n * c <= sms, got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k,M", [(16, 96), (32, 208), (64, 64), (128, 256)])
def test_bsmm_gelu_grad_epilogue_matches_plain_version(cuda, dtype, k, M):
    """Kernels 3 and 4 with the gelu_grad epilogue (the FFN backward's
    dpre) against bsmm_ref with it, the same bits in both kernels, at every
    row tile of kernel 3 and every ring depth of kernel 4."""
    x, rows, tiles = _bsmm_case(3 * k + M, M, 4, 6, 3, k, dtype, cuda)
    pre = (2 * torch.randn((M, 6 * k), generator=torch.Generator().manual_seed(k))).to(
        cuda, dtype)
    before = (_launches("bsmm"), _launches("bsmm_resident"))
    got = cuda_bsmm.bsmm(x, rows, tiles, block_m=16, gelu_grad=pre)
    got_res = cuda_bsmm.bsmm_resident(x, rows, tiles, block_m=16, gelu_grad=pre)
    want = cuda_bsmm.bsmm_ref(x, rows, tiles, gelu_grad=pre)
    torch.cuda.synchronize()
    assert (_launches("bsmm"), _launches("bsmm_resident")) == (before[0] + 1, before[1] + 1)
    rtol, atol = BSMM_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    assert torch.equal(got, got_res)
    for br in (16, 32, 64, 128):
        if M % br == 0:
            assert torch.equal(got, cuda_bsmm._launch(x, rows, tiles, 16, False, resident=False,
                                                      br=br, gelu_grad=pre)), br
    deepest = cuda_bsmm.resident_layout(x.shape[1], 16, x.element_size(), k).stages
    for stages in range(2, deepest + 1):
        assert torch.equal(got, cuda_bsmm._launch(x, rows, tiles, 16, False, resident=True,
                                                  stages=stages, gelu_grad=pre)), stages
    # the other epilogues keep their bits beside it
    assert torch.equal(cuda_bsmm.bsmm(x, rows, tiles, block_m=16),
                       cuda_bsmm.bsmm_resident(x, rows, tiles, block_m=16))


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["none", "gelu", "gelu_grad"])
@pytest.mark.parametrize("M", [16, 208, 256, 1024])
@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bsmm_stream_at_every_ring_warp_tile_and_grid(cuda, dtype, k, M, epilogue):
    """Kernel 3 forced to every ring depth stream_layout takes, every
    consumer tile warp_row_options gives (mma.sync warps, and wgmma's
    warpgroups at k 128 and row tile 128) and one block an item in place of
    the persistent grid, at every row tile dividing M, gives the default
    launch's bits; the default is within tolerance of bsmm_ref."""
    x, rows, tiles = _bsmm_case(5 * k + M, M, 4, 6, 3, k, dtype, cuda)
    pre = None if epilogue != "gelu_grad" else (2 * torch.randn(
        (M, 6 * k), generator=torch.Generator().manual_seed(M))).to(cuda, dtype)
    gelu = epilogue == "gelu"
    want = cuda_bsmm.bsmm(x, rows, tiles, block_m=16, fuse_gelu=gelu, gelu_grad=pre)
    rtol, atol = BSMM_TOL[dtype]
    torch.testing.assert_close(want.float(), cuda_bsmm.bsmm_ref(
        x, rows, tiles, fuse_gelu=gelu, gelu_grad=pre).float(), rtol=rtol, atol=atol)
    es = x.element_size()
    before, n = _launches("bsmm"), 0
    for br in (16, 32, 64, 128):
        if M % br:
            continue
        for stages in range(1, cuda_bsmm.stream_layout(br, k, es).stages + 1):
            for warp_m in cuda_bsmm.warp_row_options(br, k, es):
                for persistent in (True, False):
                    got = cuda_bsmm._launch(x, rows, tiles, 16, gelu, resident=False, br=br,
                                            stages=stages, warp_m=warp_m,
                                            persistent=persistent, gelu_grad=pre)
                    torch.cuda.synchronize()
                    n += 1
                    assert torch.equal(got, want), (br, stages, warp_m, persistent)
    assert _launches("bsmm") == before + n


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", ["none", "gelu", "gelu_grad"])
@pytest.mark.parametrize("spread", [0, 8, 40])
def test_bsmm_stream_wgmma_gives_mma_sync_bits(cuda, epilogue, spread):
    """Kernel 3's wgmma warpgroups (bf16, k 128, row tile 128) against its
    mma.sync warps of 32 and 16 rows, bit for bit, on x and tiles whose
    entries are scaled by 2^e, e uniform in [-spread, spread], so each
    16-deep step adds terms of very different sizes and some cancel."""
    M, k = 1024, 128
    x, rows, tiles = _bsmm_case(spread + 11, M, 8, 6, 3, k, torch.bfloat16, cuda)
    gen = torch.Generator().manual_seed(spread)
    x, tiles = ((t.float() * torch.exp2(torch.randint(-spread, spread + 1, t.shape,
                                                      generator=gen).float()).to(cuda))
                .to(torch.bfloat16) for t in (x, tiles))
    pre = None if epilogue != "gelu_grad" else torch.randn(
        (M, 6 * k), generator=gen).to(cuda, torch.bfloat16)
    gelu = epilogue == "gelu"
    got = {warp_m: cuda_bsmm._launch(x, rows, tiles, 128, gelu, resident=False, br=128,
                                     warp_m=warp_m, gelu_grad=pre) for warp_m in (64, 32, 16)}
    torch.cuda.synchronize()
    assert cuda_bsmm.warp_rows(128, k, 2) == 64
    assert torch.equal(got[64], got[32]) and torch.equal(got[64], got[16])


@pytest.mark.cuda
def test_bsmm_stream_refuses_what_it_cannot_take(cuda):
    x, rows, tiles = _bsmm_case(7, 256, 4, 2, 3, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="stages"):  # 4 x 64 KB at row tile 128
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=False, br=128, stages=4)
    with pytest.raises(ValueError, match="rows"):  # a 16-row block holds no 32-row warp
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=False, br=16, warp_m=32)
    with pytest.raises(ValueError, match="rows"):
        cuda_bsmm._launch(x.float(), rows, tiles.float(), 16, False, resident=False,
                          warp_m=32)
    with pytest.raises(ValueError, match="rows"):  # wgmma's warpgroups want row tile 128
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=False, br=64, warp_m=64)
    with pytest.raises(ValueError, match="kernel 4"):
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=False, cluster=1)


@pytest.mark.cuda
def test_bsmm_stream_blocks_per_sm_fit_the_card(cuda):
    """At the FFN's full width (bf16, k 128, row tile 128, 3 stages: 196,656
    bytes) one block of kernel 3 fits an SM, and its persistent grid is the
    SMs."""
    sms = cuda_bsmm.sm_count(cuda.index or 0)
    lay = cuda_bsmm.stream_layout(128, 128, 2)
    for epilogue in (0, 1, 2):
        n = cuda_bsmm.stream_blocks_per_sm(128, 128, cuda_bsmm.warp_rows(128, 128, 2), lay.stages,
                                           torch.bfloat16, epilogue, cuda.index or 0)
        assert n == 1
        assert cuda_bsmm.stream_grid(64 * 128, sms, n) == sms


# kernel 5 against bsmm_wgrad_ref, (rtol, atol): the operands are scaled by
# M^-1/4 so each sum is about one; both sum the same products in float32 in
# another order, and bfloat16 rounds once (one bf16 ulp)
WGRAD_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-4)}


def _wgrad_case(seed, M, nA, nB, P, k, dtype, device):
    rng = np.random.default_rng(seed)
    scale = max(M, 1) ** -0.25
    a = (rng.standard_normal((M, nA * k)) * scale).astype(np.float32)
    b = (rng.standard_normal((M, nB * k)) * scale).astype(np.float32)
    ia = rng.integers(0, nA, P).astype(np.int32)
    ib = rng.integers(0, nB, P).astype(np.int32)
    return (torch.from_numpy(a).to(device, dtype), torch.from_numpy(b).to(device, dtype),
            torch.from_numpy(ia).to(device), torch.from_numpy(ib).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k", [16, 32, 64, 128])
@pytest.mark.parametrize("M", [1, 17, 64, 100, 1000])
def test_wgrad_kernel_matches_plain_version(cuda, dtype, k, M):
    """Kernel 5 at every k it takes and any M: a ragged last chunk (1, 17,
    100, 1000 rows), whole chunks (64)."""
    a, b, ia, ib = _wgrad_case(k + M, M, 5, 3, 11, k, dtype, cuda)
    before = _launches("bsmm_wgrad")
    got = cuda_bsmm_grad.bsmm_wgrad(a, b, ia, ib, k=k)
    want = cuda_bsmm_grad.bsmm_wgrad_ref(a, b, ia, ib, k=k)
    torch.cuda.synchronize()
    assert _launches("bsmm_wgrad") == before + 1
    assert got.dtype == dtype and got.shape == (11, k, k)
    rtol, atol = WGRAD_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_wgrad_kernel_edges(cuda):
    """No rows gives zero tiles; no pairs launches nothing; what the kernel
    does not take raises."""
    a, b, ia, ib = _wgrad_case(1, 0, 2, 2, 4, 32, torch.bfloat16, cuda)
    got = cuda_bsmm_grad.bsmm_wgrad(a, b, ia, ib, k=32)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))
    before = _launches("bsmm_wgrad")
    assert cuda_bsmm_grad.bsmm_wgrad(a, b, ia[:0], ib[:0], k=32).shape == (0, 32, 32)
    assert _launches("bsmm_wgrad") == before
    a, b, ia, ib = _wgrad_case(2, 16, 2, 2, 4, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="k in"):
        cuda_bsmm_grad.bsmm_wgrad(a, b, ia, ib, k=8)
    with pytest.raises(TypeError):
        cuda_bsmm_grad.bsmm_wgrad(a.half(), b.half(), ia, ib, k=16)


def _wgrad_runs(seed, M, G, shared, runs, device, spread=0):
    """bf16 operands at k 128 whose pairs come in `runs` runs of G sharing
    their `shared` strip; spread > 0 scales each entry by 2^e, e uniform in
    -spread..spread, so each 16-deep step adds terms of very different
    sizes."""
    rng = np.random.default_rng(seed)
    k, n_shared, n_own = 128, runs + 1, 5
    nA, nB = (n_own, n_shared) if shared == "b" else (n_shared, n_own)
    scale = max(M, 1) ** -0.25
    a = rng.standard_normal((M, nA * k)) * scale
    b = rng.standard_normal((M, nB * k)) * scale
    if spread:
        a = a * np.exp2(rng.integers(-spread, spread + 1, a.shape))
        b = b * np.exp2(rng.integers(-spread, spread + 1, b.shape))
    own = rng.integers(0, n_own, runs * G).astype(np.int32)
    common = np.repeat(rng.permutation(n_shared)[:runs], G).astype(np.int32)
    ia, ib = (own, common) if shared == "b" else (common, own)
    return (torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16),
            torch.from_numpy(b.astype(np.float32)).to(device, torch.bfloat16),
            torch.from_numpy(ia).to(device), torch.from_numpy(ib).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 17, 64, 100, 1000])
@pytest.mark.parametrize("form,shared", [("tile", "b"), ("half", "b"), ("half", "a")])
def test_wgrad_wgmma_gives_the_mma_sync_bits(cuda, M, form, shared):
    """Kernel 5's wgmma body (bf16, k 128) gives the bits of its mma.sync
    body at every M, one tile a block and one block over half of each run
    of 3 pairs that share their a or b strip, on operands whose exponents
    spread over 2^-40..2^40."""
    a, b, ia, ib = _wgrad_runs(M, M, 3, shared, 4, cuda, spread=40)
    kw = {"form": "tile"} if form == "tile" else {"run": 3, "shared": shared, "form": form}
    got = cuda_bsmm_grad._launch(a, b, ia, ib, 128, **kw)
    old = cuda_bsmm_grad._launch(a, b, ia, ib, 128, body="mma_sync")
    torch.cuda.synchronize()
    assert torch.equal(got, old)


@pytest.mark.cuda
@pytest.mark.parametrize("G,shared", [(2, "a"), (3, "b"), (4, "a"), (4, "b")])
def test_wgrad_wgmma_variants_give_the_default_bits(cuda, G, shared):
    """Every form, ring depth, rows a stage and grid gives the default's
    bits; stream_only (products skipped) gives zeros and counts its
    launch."""
    a, b, ia, ib = _wgrad_runs(G, 300, G, shared, 5, cuda)
    kw = {"run": G, "shared": shared}
    want = cuda_bsmm_grad._launch(a, b, ia, ib, 128, **kw)
    variants = []
    for form in ("tile", "half"):
        group = 1 if form == "tile" else G
        for bm in (16, 32, 48, 64, 128):
            try:
                depth = cuda_bsmm_grad.wgrad_layout(bm, None, form, group).stages
            except ValueError:  # not even 2 stages fit
                continue
            variants += [{"form": form, "bm": bm, "stages": s} for s in range(2, depth + 1)]
        variants.append({"form": form, "persistent": False})
    for v in variants:
        got = cuda_bsmm_grad._launch(a, b, ia, ib, 128, **kw, **v)
        torch.cuda.synchronize()
        assert torch.equal(got, want), v
    for form in ("tile", "half"):
        before = _launches("bsmm_wgrad")
        zero = cuda_bsmm_grad._launch(a, b, ia, ib, 128, **kw, form=form, stream_only=True)
        torch.cuda.synchronize()
        assert _launches("bsmm_wgrad") == before + 1
        assert torch.equal(zero, torch.zeros_like(zero))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("shared", ["a", "b"])
def test_wgrad_runs_match_plain_version(cuda, G, shared):
    """Runs of G = 1..4 through bsmm_wgrad's run options against
    bsmm_wgrad_ref at WGRAD_TOL (the ungrouped random lists:
    test_wgrad_kernel_matches_plain_version)."""
    a, b, ia, ib = _wgrad_runs(10 * G, 1000, G, shared, 6, cuda)
    got = cuda_bsmm_grad.bsmm_wgrad(a, b, ia, ib, k=128, run=G, shared=shared)
    want = cuda_bsmm_grad.bsmm_wgrad_ref(a, b, ia, ib, k=128)
    torch.cuda.synchronize()
    rtol, atol = WGRAD_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_wgrad_wgmma_refuses_what_it_cannot_take(cuda):
    a, b, ia, ib = _wgrad_runs(5, 64, 3, "b", 2, cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_bsmm_grad._launch(a, b, ia, ib, 128, run=3, shared="b", bm=40)
    with pytest.raises(ValueError, match="runs"):
        cuda_bsmm_grad._launch(a, b, ia, ib, 128, form="half")
    with pytest.raises(ValueError, match="stages"):
        cuda_bsmm_grad._launch(a, b, ia, ib, 128, bm=128, stages=4)
    with pytest.raises(ValueError, match="wgmma"):
        cuda_bsmm_grad._launch(a.float(), b.float(), ia, ib, 128, body="wgmma")
    with pytest.raises(ValueError, match="divide"):
        cuda_bsmm_grad.bsmm_wgrad(a, b, ia, ib, k=128, run=4, shared="b")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("block_m,resident", [(128, None), (16, None), (16, False)])
def test_ffn_train_step_on_card(cuda, dtype, block_m, resident):
    """One training step through the kernels against the plain autograd
    step: forward 2 launches, dgrad 1 (kernels 3 and 4 as the resident gate
    picks), kernel 5 twice.  Tolerance: float32 1e-4 (the kernels sum in
    another order); bf16 rtol 2^-5, atol 2^-5 of each gradient's largest
    entry (the plain version rounds its partial sums and dh to bf16 at
    other places)."""
    cfg = ffn.BlockSparseFFNConfig(d_model=512, d_ff=1024, k=32, block_density=0.3,
                                   dtype=str(dtype).removeprefix("torch."))
    params = ffn.init_params(cfg, torch.Generator().manual_seed(7), device=cuda)
    gen = torch.Generator().manual_seed(8)
    x = torch.randn((2, 40, cfg.d_model), generator=gen).to(cuda, dtype)
    y = torch.randn((2, 40, cfg.d_model), generator=gen).to(cuda, dtype)
    step = ffn.make_sharded_train_step(train_mesh(device=cuda), cfg, lr=1.0,
                                       block_m=block_m, resident=resident)
    torch.cuda.synchronize()
    ENGINE.zero("launches_")
    loss, grads = step.loss_and_grads(params, x, y)
    torch.cuda.synchronize()
    counts = ENGINE.counter_snapshot()
    es = x.element_size()
    fits = [resident if resident is not None else
            cuda_bsmm.resident_panel_fits(d_in, block_m, es, cfg.k)
            for d_in in (cfg.d_model, cfg.d_ff, cfg.d_model)]  # matmul 1, matmul 2, dgrad
    assert counts.get("launches_bsmm_resident", 0) == sum(fits)
    assert counts.get("launches_bsmm", 0) == 3 - sum(fits)
    assert counts.get("launches_bsmm_wgrad", 0) == 2
    want_loss, want = ffn.loss_and_grads_ref(params, x, y, cfg)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -5
    torch.testing.assert_close(loss, want_loss, rtol=tol, atol=0)
    for name in ("w1", "w2"):
        scale = float(want[name].float().abs().max())
        torch.testing.assert_close(grads[name].float(), want[name].float(), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("round_size", [None, 3])
@pytest.mark.parametrize("depth", ["1", "2", "4"])
@pytest.mark.parametrize("backend,dist", [("exact", "adversarial"), ("hybrid", "small"),
                                          ("mxu", "small")])
def test_outofcore_on_card_matches_resident(cuda, backend, dist, depth, round_size,
                                            monkeypatch, capsys):
    """Out-of-core on the card: its pinned staging, copy stream and landing
    events give the resident chain's bytes at every depth and round size."""
    monkeypatch.setenv("SPGEMM_TPU_OOC_DEPTH", depth)
    mats = random_chain(5, 8, 8, 0.4, np.random.default_rng(90), dist)
    want = chain_product(mats, device=cuda, backend=backend)
    got = chain_product(mats, device=cuda, backend=backend, round_size=round_size,
                        multiply=engine.spgemm_outofcore)
    assert got == want
    assert chain_product(mats, device="cpu", backend=backend) == want


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 2, 3, 8])
def test_ranks_on_card_match_cpu(cuda, p, tmp_path, capsys):
    from spgemm_tpu_torch import cli
    from spgemm_tpu_torch.parallel.chainpart import chain_product_partitioned
    from spgemm_tpu_torch.utils import io_text

    mats = random_chain(9, 6, 8, 0.4, np.random.default_rng(91), "adversarial")
    want = chain_product_partitioned(mats, p, device="cpu")
    assert chain_product_partitioned(mats, p, device=cuda) == want
    assert chain_product_partitioned(mats, p, device=cuda,
                                     multiply=engine.spgemm_outofcore) == want
    folder = str(tmp_path / "chain")
    io_text.write_chain_dir(folder, mats, 8)
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = str(tmp_path / device)
        assert cli.run([folder, "--device", device, "--ranks", str(p), "--output",
                        outs[device]]) == 0
    with open(outs["cuda"], "rb") as f, open(outs["cpu"], "rb") as g:
        assert f.read() == g.read()


def _failing_kernel1(n: int):
    """Kernel 1's fold raising on its n-th call and after."""
    calls = []

    def fold(*args, **kw):
        calls.append(1)
        if len(calls) >= n:
            raise RuntimeError("fold failure injected")
        return cuda_spgemm.numeric_round(*args, **kw)

    return engine.Folds(exact=fold)


@pytest.mark.cuda
def test_failover_on_card_gives_the_oracle_bytes(cuda, capsys, monkeypatch):
    """With the probe standing in for a lost card, the pass restarts on
    the oracle."""
    from spgemm_tpu_torch.utils import backend_probe
    from spgemm_tpu_torch.utils.semantics import chain_oracle
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

    monkeypatch.setattr(backend_probe, "probe_default_backend", lambda: "error")
    mats = random_chain(5, 6, 8, 0.4, np.random.default_rng(92), "adversarial")
    got = chain_product(mats, device=cuda, failover=True, folds=_failing_kernel1(3))
    want = BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, 8,
                                       chain_oracle([m.to_dict() for m in mats], 8))
    assert got == want
    assert capsys.readouterr().err.startswith("chain failover:")


@pytest.mark.cuda
def test_failover_on_a_working_card_raises(cuda, capsys):
    """The real probe finds the card working: the injected fold error is
    raised, not answered by the oracle."""
    mats = random_chain(5, 6, 8, 0.4, np.random.default_rng(92), "adversarial")
    with pytest.raises(RuntimeError, match="fold failure injected"):
        chain_product(mats, device=cuda, failover=True, folds=_failing_kernel1(3))
    assert "chain failover:" not in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n,n_sub,k", [(0, 0, 32), (100, 7, 32), (1000, 1000, 32),
                                       (57, 20, 3), (300, 45, 1), (64, 10, 64)])
def test_splice_kernel_matches_plain_version(cuda, n, n_sub, k, aligned):
    rng = np.random.default_rng(n + k)

    def slab(rows):
        """(rows + 1, k, k), the last row zero; unaligned: 8 bytes past a
        16-byte boundary, so the kernel takes its 8-byte path."""
        flat = rng.integers(-2**63, 2**63, (rows + 1) * k * k + 1, dtype=np.int64)
        x = torch.from_numpy(flat).to(cuda)[(0 if aligned else 1):]
        x = x[:(rows + 1) * k * k].view(rows + 1, k, k)
        x[-1] = 0
        return x

    prev, sub = slab(n), slab(n_sub)
    kept = np.sort(rng.choice(n, n_sub, replace=False)) if n_sub else np.zeros(0, np.int64)
    src = torch.from_numpy(cuda_splice.source_map(kept, np.arange(n_sub), n + 1)).to(cuda)
    before, kept_prev = _launches("splice"), prev.clone()
    got = cuda_splice.splice(prev, sub, src)
    want = cuda_splice.splice_ref(prev, sub, src)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(prev, kept_prev)
    assert _launches("splice") == before + 1


@pytest.mark.cuda
def test_delta_chain_on_card_matches_the_full_chain(cuda, monkeypatch):
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
    from spgemm_tpu_torch.utils.gen import banded_block_sparse

    rng = np.random.default_rng(93)
    mats = []
    for i in range(6):
        m = banded_block_sparse(60, 8, 2, rng)
        keep = m.coords[:, 1] + i < 60
        mats.append(BlockSparseMatrix(rows=m.rows, cols=m.cols, k=8,
                                      coords=m.coords[keep] + np.array([0, i]),
                                      tiles=m.tiles[keep]))
    edited = list(mats)
    t = mats[3].tiles.copy()
    t[mats[3].coords[:, 0] == 30] ^= np.uint64(5)
    edited[3] = BlockSparseMatrix(rows=mats[3].rows, cols=mats[3].cols, k=8,
                                  coords=mats[3].coords, tiles=t)
    before = _launches("splice")
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "1")
    got = [chain_product(ms, device=cuda) for ms in (mats, mats, edited)]
    assert _launches("splice") > before
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    assert got == [chain_product(ms, device=cuda) for ms in (mats, mats, edited)]


def _dense_case(rng, k, n_rows, L, real, layout, device, n_tiles=20):
    """Slabs of EDGE-heavy values with the zero sentinel last, and an (L,)
    stream: `real` slots on rows (contiguous runs, or cycling), a fifth of
    them sentinel pairs, the rest pad slots on the scratch row n_rows."""
    tiles = [random_values((n_tiles + 1, k, k), rng, "adversarial") for _ in range(2)]
    for t in tiles:
        t[-1] = 0
    pa = np.full(L, n_tiles, np.int32)
    pb = np.full(L, n_tiles, np.int32)
    seg = np.full(L, n_rows, np.int32)
    pa[:real] = rng.integers(0, n_tiles, size=real)
    pb[:real] = rng.integers(0, n_tiles, size=real)
    side = rng.integers(0, 5, size=real)
    pa[:real][side == 0] = n_tiles
    pb[:real][side == 1] = n_tiles
    if n_rows:
        seg[:real] = (np.sort(rng.integers(0, n_rows, size=real)) if layout == "contiguous"
                      else np.arange(real) % n_rows)
    return [torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64 else x).to(device)
            for x in (*tiles, pa, pb, seg)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "cycling"])
@pytest.mark.parametrize("k,n_rows,L,real", [(1, 300, 2048, 2000), (2, 50, 512, 500),
                                             (8, 20, 256, 250), (32, 30, 640, 600),
                                             (64, 4, 64, 60), (32, 2, 3000, 3000),
                                             (33, 5, 40, 33), (16, 7, 16, 0), (16, 0, 8, 0)])
def test_dense_kernel_matches_plain_version(cuda, layout, k, n_rows, L, real):
    rng = np.random.default_rng(k * 1000 + n_rows + real)
    a, b, pa, pb, seg = _dense_case(rng, k, n_rows, L, real, layout, cuda)
    before = _launches("dense_fold")
    got = cuda_dense.numeric_round_dense(a, b, pa, pb, seg, n_rows)
    want = cuda_dense.numeric_round_dense_ref(a, b, pa, pb, seg, n_rows)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (n_rows, k, k) and torch.equal(got, want)
    assert _launches("dense_fold") == before + (1 if n_rows else 0)
    if layout == "contiguous":  # the planner's layout, its row offsets given
        row_ptr = torch.searchsorted(seg[:real], torch.arange(n_rows + 1, device=cuda,
                                                              dtype=torch.int32))
        got = cuda_dense.numeric_round_dense(a, b, pa, pb, seg, n_rows, row_ptr)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 32])
def test_dense_kernel_equals_kernel_1_on_planner_rounds(cuda, k, monkeypatch):
    """Every auto round's dense twin against kernel 1 on its ladder layout:
    the same rows, the same bits."""
    from spgemm_tpu_torch.ops.spgemm import pack_tiles, plan
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

    rng = np.random.default_rng(k)
    fanout, keys = 300, 5
    a_c = np.array([(i, i * fanout + j) for i in range(keys) for j in range(fanout)], np.int64)
    b_c = np.array([(m, c) for m in range(keys * fanout) for c in (0, 1)], np.int64)
    a = BlockSparseMatrix(rows=keys * k, cols=keys * fanout * k, k=k, coords=a_c,
                          tiles=random_values((len(a_c), k, k), rng, "adversarial"))
    b = BlockSparseMatrix(rows=keys * fanout * k, cols=2 * k, k=k, coords=b_c,
                          tiles=random_values((len(b_c), k, k), rng, "adversarial"))
    monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", "auto")
    p = plan(a, b)
    twins = [r for r in p.rounds if r.dense_alt is not None]
    assert twins
    sa, sb = pack_tiles(a, cuda), pack_tiles(b, cuda)
    for r in twins:
        d = r.dense_alt
        ladder = cuda_spgemm.numeric_round(sa, sb, *(torch.from_numpy(x).to(cuda)
                                                     for x in (r.pa, r.pb)))
        dense = cuda_dense.numeric_round_dense(
            sa, sb, *(torch.from_numpy(x).to(cuda) for x in (d.pa, d.pb, d.seg)), d.n_rows,
            torch.from_numpy(d.row_ptr).to(cuda))
        torch.cuda.synchronize()
        assert torch.equal(ladder, dense)


@pytest.mark.cuda
def test_dense_kernel_refuses_what_it_does_not_take(cuda):
    ix = torch.zeros(8, dtype=torch.int32, device=cuda)
    big = torch.zeros((2, 2049, 2049), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="k <= 2048"):
        cuda_dense.numeric_round_dense(big, big, ix, ix, ix, 1)
    del big
    a = torch.zeros((3, 4, 4), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        cuda_dense.numeric_round_dense(a, a, ix.cpu(), ix.cpu(), ix.cpu(), 2)
    with pytest.raises(ValueError, match="several devices"):
        cuda_dense.numeric_round_dense(a, a.cpu(), ix, ix, ix, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["exact", "hybrid"])
def test_hub_multiply_on_card_is_the_same_on_every_route(cuda, backend, monkeypatch, tmp_path):
    from spgemm_tpu_torch.ops import plancache
    from spgemm_tpu_torch.ops.spgemm import spgemm
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

    rng = np.random.default_rng(17)
    k, fanout = 8, 600
    a_c = np.stack([np.zeros(fanout, np.int64), np.arange(fanout)], 1)
    b_c = np.stack([np.repeat(np.arange(fanout), 2), np.tile([0, 1], fanout)], 1)
    dist = "small" if backend == "hybrid" else "adversarial"
    a = BlockSparseMatrix(rows=k, cols=fanout * k, k=k, coords=a_c,
                          tiles=random_values((len(a_c), k, k), rng, dist))
    b = BlockSparseMatrix(rows=fanout * k, cols=2 * k, k=k, coords=b_c,
                          tiles=random_values((len(b_c), k, k), rng, dist))
    monkeypatch.setenv("SPGEMM_TPU_CROSSOVER_CACHE", str(tmp_path))
    out = {}
    for route in ("ladder", "dense", "auto"):
        monkeypatch.setenv("SPGEMM_TPU_ACCUM_ROUTE", route)
        plancache.clear()
        before = _launches("dense_fold")
        out[route] = spgemm(a, b, device=cuda, backend=backend)
        assert (_launches("dense_fold") > before) == (route == "dense") or route == "auto"
    assert out["ladder"] == out["dense"] == out["auto"] == spgemm(a, b, device="cpu")


@pytest.mark.cuda
def test_the_daemon_serves_a_chain_on_the_card(cuda, tmp_path):
    """`cli serve` with no --device runs on the card: one small chain through
    the daemon's client, kernel 1 launched, not degraded, the oracle's
    bytes, and `stats` naming the card."""
    import os
    import subprocess
    import sys
    import time

    from spgemm_tpu_torch.serve import client
    from spgemm_tpu_torch.utils import io_text
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
    from spgemm_tpu_torch.utils.semantics import chain_oracle

    mats = random_chain(4, 6, 8, 0.5, np.random.default_rng(31), "adversarial")
    folder = str(tmp_path / "chain")
    io_text.write_chain_dir(folder, mats, 8)
    want = io_text.format_matrix(BlockSparseMatrix.from_dict(
        mats[0].rows, mats[-1].cols, 8, chain_oracle([m.to_dict() for m in mats], 8)
    ).prune_zeros())
    sock = str(tmp_path / "d.sock")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if not k.startswith("SPGEMM_TPU_")}
    env["PYTHONPATH"] = repo
    proc = subprocess.Popen([sys.executable, "-m", "spgemm_tpu_torch.cli", "serve", "--socket",
                             sock], env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.time() + 300
        while not os.path.exists(sock):
            assert proc.poll() is None and time.time() < deadline, "the daemon never bound"
            time.sleep(0.1)
        out = str(tmp_path / "out")
        job = client.wait(client.submit(folder, sock, {"output": out})["id"], sock,
                          timeout=300)["job"]
        assert job["state"] == "done", job["error"]
        assert job["detail"]["degraded"] is False and job["detail"]["device"] == "cuda:0"
        assert job["detail"]["launches_numeric_round"] > 0
        assert open(out, "rb").read() == want
        st = client.stats(sock)
        assert st["device"] == {"type": "cuda", "name": torch.cuda.get_device_name(0)}
        assert st["degraded"] is False and st["serve"]["serve_degrades"] == 0
        assert client.shutdown(sock)["stopping"] is True
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["exact", "hybrid", "mxu"])
def test_execute_batched_on_card_equals_solo_executes(cuda, backend, monkeypatch):
    """Four jobs of one structure, different values: execute_batched on the
    card gives each job its solo execute's bits and val_bound, with one
    kernel launch per round (every round's four copies fit one launch)."""
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix

    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    monkeypatch.setenv("SPGEMM_TPU_HYBRID_GATE", "proof")  # no measurement here
    base = random_chain(2, 12, 8, 0.4, np.random.default_rng(41), "full")
    pairs = []
    for j in range(4):
        rng = np.random.default_rng(50 + j)
        pairs.append(tuple(DeviceBlockMatrix.from_host(BlockSparseMatrix(
            rows=m.rows, cols=m.cols, k=m.k, coords=m.coords,
            tiles=random_values(m.tiles.shape, rng, "small" if backend == "hybrid" else "full")),
            cuda) for m in base))
    p = engine.plan(*pairs[0], backend=backend)
    solo = [engine.execute(p, a, b) for a, b in pairs]
    kernel = "numeric_round_mxu" if backend == "mxu" else "numeric_round"
    before = _launches(kernel)
    got = engine.execute_batched(p, pairs)
    torch.cuda.synchronize()
    assert _launches(kernel) - before == len(p.rounds)
    for g, s in zip(got, solo):
        assert torch.equal(g.slab, s.slab) and np.array_equal(g.coords, s.coords)
        assert g.val_bound == s.val_bound


def _rowshard_chain(kind: str, k: int) -> list:
    rng = np.random.default_rng(70 + k)
    if kind == "banded":
        return [banded_block_sparse(40, k, 3, rng, "adversarial") for _ in range(4)]
    return random_chain(4, 24, k, 0.3, rng, "adversarial")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("kind,k", [("banded", 8), ("banded", 32), ("random", 8), ("random", 32)])
def test_sharded_multiply_on_card_equals_spgemm_device(cuda, kind, k, n):
    """Each shard is one kernel-1 launch on cuda:0; the bytes are
    spgemm_device's, multiply by multiply and over the chain."""
    mats = _rowshard_chain(kind, k)
    devices = [torch.device("cuda:0")] * n
    for a, b in zip(mats[:-1], mats[1:]):
        launches, shards = _launches("numeric_round"), ENGINE.counter_snapshot().get(
            "rowshard_round", 0)
        got = spgemm_sharded(a, b, devices=devices)
        want = engine.spgemm_device(a, b, device=cuda).to_host()
        assert np.array_equal(got.coords, want.coords) and np.array_equal(got.tiles, want.tiles)
        sharded = ENGINE.counter_snapshot().get("rowshard_round", 0) - shards
        assert sharded > 0 and sharded % n == 0
        assert _launches("numeric_round") - launches >= sharded  # spgemm_device's launch too
    got = chain_product(mats, device=cuda, multiply=partial(spgemm_sharded, devices=devices))
    assert got == chain_product(mats, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["golden_chain", "golden_wrap"])
def test_cli_shard_keys_on_card_writes_the_golden_bytes(cuda, name, tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data = os.path.join(repo, "tests", "data")
    proc = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", os.path.join(data, name),
                           "--shard", "keys", "-v"], cwd=tmp_path,
                          env={**os.environ, "PYTHONPATH": repo}, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr
    with open(os.path.join(data, f"{name}_expected_matrix"), "rb") as f:
        assert (tmp_path / "matrix").read_bytes() == f.read()
    assert "launches_numeric_round" in proc.stderr and "rowshard_round" in proc.stderr


FIELD_EDGE = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 63) - 1, 1 << 63,
              (1 << 64) - 3, (1 << 64) - 2, (1 << 64) - 1]


def _field_tiles(rng, n: int, k: int, small: bool) -> np.ndarray:
    """n + 1 tiles (the zero sentinel last): edge values and uniform ones,
    all below 2^32 when small."""
    pool = np.array([v for v in FIELD_EDGE if not small or v < 1 << 32], np.uint64)
    hi = 1 << 32 if small else 1 << 64
    tiles = np.where(rng.random((n + 1, k, k)) < 0.5,
                     pool[rng.integers(0, len(pool), (n + 1, k, k))],
                     rng.integers(0, hi, (n + 1, k, k), dtype=np.uint64))
    tiles[-1] = 0
    return tiles


def _field_indices(rng, n: int, K: int, P: int) -> np.ndarray:
    x = rng.integers(0, n + 1, (K, P)).astype(np.int32)  # n: the sentinel
    x[::3] = n                                            # all-sentinel keys
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("k,K,P", [(1, 300, 9), (2, 300, 9), (8, 60, 7), (31, 40, 8),
                                   (32, 40, 8), (33, 30, 5), (64, 8, 5), (32, 4, 384),
                                   (32, 3, 4100), (16, 0, 4), (16, 3, 0)])
def test_field_fold_on_card_equals_plain_version(cuda, k, K, P, small):
    """EDGE values, every third key of sentinel slots only; (32, 3, 4100)
    has P * k > 2^17, which kernel 2's wrapper refuses and F1 takes."""
    rng = np.random.default_rng(900 + k + P)
    a, b = (torch.from_numpy(_field_tiles(rng, 30, k, small).view(np.int64)).to(cuda)
            for _ in range(2))
    pa, pb = (torch.from_numpy(_field_indices(rng, 30, K, P)).to(cuda) for _ in range(2))
    launches = _launches("field_fold")
    got = cuda_field.field_fold(a, b, pa, pb, small=small)
    assert _launches("field_fold") - launches == int(K > 0)
    want = cuda_field.field_fold_ref(a, b, pa, pb, small=small)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if small:  # the full instance gives the same bits where SMALL is legal
        assert torch.equal(cuda_field.field_fold(a, b, pa, pb), want)


@pytest.mark.cuda
def test_field_fold_on_card_collapses_a_sum_of_2_64_minus_1(cuda):
    """(2^32 - 1)^2 + (2^32 - 1) * 2 = 2^64 - 1, which reads 0; every
    operand below 2^32, so the SMALL route may take it too."""
    a = torch.tensor([[[(1 << 32) - 1]], [[(1 << 32) - 1]], [[0]]], dtype=torch.int64,
                     device=cuda)
    b = torch.tensor([[[(1 << 32) - 1]], [[2]], [[0]]], dtype=torch.int64, device=cuda)
    pa = torch.tensor([[0, 1]], dtype=torch.int32, device=cuda)
    for small in (False, True):
        assert cuda_field.field_fold(a, b, pa, pa.clone(), small=small).tolist() == [[[0]]]


@pytest.mark.cuda
@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("k,C,most", [(1, 500, 1), (8, 300, 1), (31, 60, 40), (32, 200, 1),
                                      (32, 12, 300), (33, 40, 6), (64, 30, 3), (16, 0, 1)])
def test_field_fold_scatter_on_card_equals_plain_version(cuda, k, C, most, small):
    """CSR cells of 1 to `most` pairs (one of them `most`, the first of
    sentinel slots only) on distinct rows; every other accumulator row is
    left as it was."""
    rng = np.random.default_rng(950 + k + C)
    a, b = (torch.from_numpy(_field_tiles(rng, 25, k, small).view(np.int64)).to(cuda)
            for _ in range(2))
    counts = rng.integers(1, most + 1, C)
    counts[-1:] = most
    cell_ptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    pa, pb = (_field_indices(rng, 25, int(cell_ptr[-1]), 1)[:, 0].copy() for _ in range(2))
    if C:
        pa[: counts[0]] = 25
    rows_acc = C + 5
    rows = rng.permutation(rows_acc)[:C].astype(np.int32)
    rows, cell_ptr, pa, pb = (torch.from_numpy(x).to(cuda) for x in (rows, cell_ptr, pa, pb))
    start = torch.from_numpy(_field_tiles(rng, rows_acc - 1, k, False).view(np.int64)).to(cuda)
    start[start == -1] = 0  # an accumulator holds canonical residues
    launches = _launches("field_fold_scatter")
    got = cuda_field.field_fold_scatter(start.clone(), a, b, rows, cell_ptr, pa, pb, small=small)
    assert _launches("field_fold_scatter") - launches == int(C > 0)
    want = cuda_field.field_fold_scatter_ref(start.clone(), a, b, rows, cell_ptr, pa, pb,
                                             small=small)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    untouched = torch.ones(rows_acc, dtype=torch.bool, device=cuda)
    untouched[rows[1:].long()] = False
    assert torch.equal(got[untouched], start[untouched])


@pytest.mark.cuda
def test_field_add_on_card_equals_plain_version(cuda):
    rng = np.random.default_rng(960)
    x, y = (torch.from_numpy(_field_tiles(rng, 99, 8, False).view(np.int64)).to(cuda)
            for _ in range(2))
    x[0, 0, 0], y[0, 0, 0] = -2, 1  # 2^64 - 2 + 1 reads 0
    got = cuda_field.addmod_field_(x.clone(), y)
    want = cuda_field.addmod_field_ref_(x.clone(), y)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and int(got[0, 0, 0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("overlap", ["0", "1"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("dist", ["small", "adversarial"])
def test_inner_and_ring_on_card_equal_the_cpu(cuda, n, overlap, dist, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_RING_OVERLAP", overlap)
    rng = np.random.default_rng(970 + n)
    mats = [banded_block_sparse(40, 8, 3, rng, dist) for _ in range(2)] \
        + random_chain(2, 40, 8, 0.3, rng, dist)
    devices = [torch.device("cuda:0")] * n
    for fn, kernel in ((spgemm_inner, "field_fold"), (spgemm_ring, "field_fold_scatter")):
        for a, b in ((mats[0], mats[1]), (mats[2], mats[3])):
            launches = _launches(kernel)
            got = fn(a, b, devices=devices)
            assert _launches(kernel) > launches
            if kernel == "field_fold_scatter":  # one launch a step and position at most
                assert _launches(kernel) - launches <= n * n
            want = fn(a, b, devices=["cpu"] * n)
            assert np.array_equal(got.coords, want.coords) and np.array_equal(got.tiles, want.tiles)


@pytest.mark.cuda
def test_chain_on_devices_on_card_equals_partitioned(cuda):
    mats = random_chain(9, 24, 8, 0.3, np.random.default_rng(980), "adversarial")
    want = chain_product_partitioned(mats, 8, device=cuda)
    assert chain_product_on_devices(mats, [cuda], num_parts=8) == want
    assert chain_product_on_devices(mats, ["cpu"], num_parts=8) == want


@pytest.mark.cuda
@pytest.mark.parametrize("shard", ["inner", "ring", "chain"])
@pytest.mark.parametrize("name", ["golden_chain", "golden_wrap"])
def test_cli_shard_inner_ring_chain_on_card(cuda, shard, name, tmp_path):
    """The card's bytes are the CPU's: field mode's for inner and ring (the
    mxu chain's), the reference's for chain at one card (P = 1)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    folder = os.path.join(repo, "tests", "data", name)
    env = {**os.environ, "PYTHONPATH": repo}
    outs = {}
    for dev in ("cuda", "cpu"):
        extra = ["--shard", shard] if dev == "cuda" else \
            (["--backend", "mxu"] if shard != "chain" else [])
        proc = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", folder,
                               "--device", dev, "--output", dev, *extra], cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        outs[dev] = (tmp_path / dev).read_bytes()
    assert outs["cuda"] == outs["cpu"]
