"""Kernel 5's host side (spgemm_tpu_torch/ops/cuda_bsmm_grad.py), on the CPU:
the Python mirrors of the wgmma body's layout (stage bytes, ring depth, rows
a stage at each cluster), its persistent grid and walk, the launch plan at
the FFN's full width, StepIndex's run fields, and the run options of
bsmm_wgrad, which on CPU tensors run the plain version after their checks.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from spgemm_tpu_torch.models import ffn
from spgemm_tpu_torch.ops import cuda_bsmm, cuda_bsmm_grad as k5

FULL = ffn.BlockSparseFFNConfig()   # M 8192 at full width: x (8, 1024, 4096)
FULL_M, FULL_P = 8192, FULL.nb_ff * FULL.rpc


@pytest.mark.parametrize("bm", [16, 32, 48, 64, 96, 128, 160, 192])
def test_wgrad_layout_takes_the_deepest_ring_that_fits(bm):
    lay = k5.wgrad_layout(bm)
    assert lay.box_bytes == bm * 128 and lay.stage_bytes == 4 * lay.box_bytes
    assert lay.out_bytes == 128 * 128 * 2 and lay.barrier_bytes == 16 * lay.stages
    assert lay.total == lay.stages * lay.stage_bytes + lay.out_bytes + lay.barrier_bytes
    assert lay.total <= cuda_bsmm.SMEM_BYTES
    # every box, and the staged tile after the ring, starts on the swizzle's
    # 8-row pattern (1024 bytes)
    assert lay.box_bytes % 1024 == 0
    deeper = lay.stages + 1
    assert deeper not in k5.WGRAD_STAGES or (
        deeper * lay.stage_bytes + lay.out_bytes + 16 * deeper > cuda_bsmm.SMEM_BYTES)


@pytest.mark.parametrize("bm,stages", [(64, 6), (96, 4), (128, 3), (48, 8), (32, 8)])
def test_wgrad_layout_depths_at_the_ffn_shapes(bm, stages):
    assert k5.wgrad_layout(bm).stages == stages
    for s in range(2, stages + 1):
        assert k5.wgrad_layout(bm, s).stages == s


@pytest.mark.parametrize("bm,stages", [(64, 7), (128, 4), (64, 1), (64, 9), (24, 2), (0, 2),
                                       (272, 2), (256, 2), (256, None)])
def test_wgrad_layout_refuses_what_the_kernel_cannot_take(bm, stages):
    with pytest.raises(ValueError):
        k5.wgrad_layout(bm, stages)


@pytest.mark.parametrize("group,bm,stages", [(2, 64, 6), (3, 64, 4), (4, 64, 3), (3, 128, 2),
                                             (3, 32, 8)])
def test_the_half_forms_layout(group, bm, stages):
    """The half form's stage: the run's G own half-strip boxes and the
    shared strip's two; its staged output: G 64 x 128 pieces."""
    lay = k5.wgrad_layout(bm, None, "half", group)
    assert lay.stage_bytes == (group + 2) * bm * 128 and lay.out_bytes == group * 16384
    assert lay.stages == stages and lay.total <= cuda_bsmm.SMEM_BYTES
    assert lay.total == stages * lay.stage_bytes + lay.out_bytes + 16 * stages
    assert lay.stage_bytes % 1024 == 0  # each stage starts on the swizzle's pattern


@pytest.mark.parametrize("P,form,group,resident", [(384, "tile", 1, 132), (384, "half", 3, 132),
                                                   (384, "half", 3, 500), (12, "half", 4, 2),
                                                   (7, "tile", 1, 3), (384, "half", 2, 132)])
def test_the_persistent_grid_walks_every_unit_once(P, form, group, resident):
    units = k5.wgrad_units(P, form, group)
    assert units == (P if form == "tile" else 2 * P // group)
    grid = k5.wgrad_grid(units, resident)
    assert grid == min(units, resident)
    walks = [k5.wgrad_walk(blk, grid, units) for blk in range(grid)]
    assert sorted(u for w in walks for u in w) == list(range(units))
    if form == "half" and grid % 2 == 0:  # a run's two halves: one round, neighbouring blocks
        where = {u: (blk, i) for blk, w in enumerate(walks) for i, u in enumerate(w)}
        for r in range(units // 2):
            (b0, i0), (b1, i1) = where[2 * r], where[2 * r + 1]
            assert i0 == i1 and b1 == b0 + 1
    assert k5.wgrad_grid(units, resident, persistent=False) == units


def test_the_launch_plan_at_full_width():
    bf = torch.bfloat16
    plan = k5.launch_plan(FULL_M, FULL_P, 128, bf, FULL.rpc, resident=lambda f, bm, s, g: 132)
    assert plan == {"body": "wgmma", "form": "half", "group": 3, "bm": 64, "stages": 4,
                    "grid": 132, "smem_bytes": k5.wgrad_layout(64, None, "half", 3).total}
    plan = k5.launch_plan(FULL_M, FULL_P, 128, bf, resident=lambda f, bm, s, g: 132)
    assert plan == {"body": "wgmma", "form": "tile", "group": 1, "bm": 128, "stages": 3,
                    "grid": 132, "smem_bytes": k5.wgrad_layout(128).total}
    assert k5.launch_plan(FULL_M, FULL_P, 128, bf, 3, form="tile")["grid"] == FULL_P
    assert k5.launch_plan(FULL_M, FULL_P, 128, bf, 3)["grid"] == 2 * FULL_P // 3
    assert k5.launch_plan(FULL_M, FULL_P, 128, bf, 3, form="half", bm=48,
                          stages=5)["smem_bytes"] == 5 * 5 * 48 * 128 + 3 * 16384 + 80


@pytest.mark.parametrize("dtype,k,M,body", [(torch.float32, 128, 64, "mma_sync"),
                                            (torch.bfloat16, 64, 64, "mma_sync"),
                                            (torch.bfloat16, 128, 0, "mma_sync"),
                                            (torch.bfloat16, 128, 1, "wgmma")])
def test_the_body_each_shape_takes(dtype, k, M, body):
    assert k5.wgrad_body(dtype, k, None, M) == body
    assert k5.launch_plan(M, 6, k, dtype)["body"] == body
    assert k5.wgrad_body(dtype, k, "mma_sync", M) == "mma_sync"
    if body == "mma_sync":
        with pytest.raises(ValueError):
            k5.wgrad_body(dtype, k, "wgmma", M)


@pytest.mark.parametrize("run,kw", [(3, {"form": "cluster"}), (3, {"form": "quarter"}),
                                    (3, {"body": "tma"}), (1, {"form": "half"}),
                                    (5, {"form": "half"}), (4, {"form": "half", "bm": 128}),
                                    (3, {"bm": 40})])
def test_the_launch_plan_refuses_what_the_kernel_cannot_take(run, kw):
    with pytest.raises(ValueError):
        k5.launch_plan(FULL_M, FULL_P, 128, torch.bfloat16, run, **kw)


@pytest.mark.parametrize("form,group,gb", [("tile", 1, 1.610612736), ("half", 3, 1.34217728)])
def test_strip_bytes_at_full_width(form, group, gb):
    """Every tile streams both strips (tile form), or each run of 3 its own
    strips and the shared one once a half (half form): 1.61 GB -> 1.34 GB a
    call."""
    assert k5.strip_bytes(FULL_M, FULL_P, 128, form, group) == int(gb * 1e9)


@pytest.mark.parametrize("nbf,rpc,cpc,nb_model", [(8, 3, 3, 32), (5, 1, 2, 4), (16, 4, 1, 8),
                                                  (3, 2, 4, 6)])
def test_step_index_run_fields(nbf, rpc, cpc, nb_model):
    rng = np.random.default_rng(nbf * 100 + rpc)
    rows1 = torch.from_numpy(np.stack([rng.choice(nb_model, rpc, replace=False)
                                       for _ in range(nbf)]).astype(np.int32))
    cols2 = torch.from_numpy(np.stack([rng.choice(nb_model, cpc, replace=False)
                                       for _ in range(nbf)]).astype(np.int32))
    idx = ffn.step_index(rows1, cols2, nb_model)
    assert (idx.run1, idx.shared1, idx.run2, idx.shared2) == (rpc, "b", cpc, "a")
    assert torch.equal(idx.ia1, rows1.reshape(-1)) and torch.equal(idx.ib2, cols2.reshape(-1))
    assert torch.equal(idx.ib1.reshape(nbf, rpc),
                       torch.arange(nbf, dtype=torch.int32)[:, None].expand(nbf, rpc))
    assert torch.equal(idx.ia2.reshape(nbf, cpc),
                       torch.arange(nbf, dtype=torch.int32)[:, None].expand(nbf, cpc))
    assert k5.check_runs(idx.ia1, idx.ib1, idx.run1, idx.shared1) == (rpc, 1)
    assert k5.check_runs(idx.ia2, idx.ib2, idx.run2, idx.shared2) == (cpc, 0)


def _operands(G: int, shared: str, seed: int, runs: int = 4, k: int = 16, M: int = 40,
              dtype=torch.float32):
    """a, b and (ia, ib) in runs of G pairs sharing their `shared` strip."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((M, 6 * k)).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.standard_normal((M, 4 * k)).astype(np.float32)).to(dtype)
    n_shared, n_own = (4, 6) if shared == "b" else (6, 4)
    own = rng.integers(0, n_own, runs * G).astype(np.int32)
    common = np.repeat(rng.permutation(n_shared)[:runs], G).astype(np.int32)  # distinct
    ia, ib = (own, common) if shared == "b" else (common, own)
    return a, b, torch.from_numpy(ia), torch.from_numpy(ib)


@pytest.mark.parametrize("G", [1, 2, 3, 4])
@pytest.mark.parametrize("shared", ["a", "b"])
def test_run_options_on_the_cpu_give_the_plain_version(G, shared):
    a, b, ia, ib = _operands(G, shared, seed=G)
    want = k5.bsmm_wgrad_ref(a, b, ia, ib, k=16)
    got = k5.bsmm_wgrad(a, b, ia, ib, k=16, run=G, shared=shared)
    assert torch.equal(got, want)
    assert torch.equal(got, k5.bsmm_wgrad(a, b, ia, ib, k=16))
    ga = a.double().reshape(40, 6, 16)[:, ia.long()]
    gb = b.double().reshape(40, 4, 16)[:, ib.long()]
    np.testing.assert_allclose(got.double().numpy(),
                               torch.einsum("mpi,mpj->pij", ga, gb).numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("run,shared", [(5, "b"), (2, "b"), (4, "b"), (3, "a"), (0, "b"),
                                        (3, None), (None, "b"), (3, "c")])
def test_runs_that_do_not_hold_raise(run, shared):
    """Four runs of 3 sharing b: a run length that does not divide P (5),
    ones whose runs do not share their strip (2, 4), the wrong side, and
    options half given or misnamed all raise."""
    a, b, ia, ib = _operands(3, "b", seed=9)
    with pytest.raises(ValueError):
        k5.bsmm_wgrad(a, b, ia, ib, k=16, run=run, shared=shared)


def test_a_wrong_run_length_raises_in_step_index(monkeypatch):
    """step_index checks its own runs on the host: a run length its shared
    side does not follow raises there, before any launch."""
    rows1 = torch.zeros((4, 3), dtype=torch.int32)
    cols2 = torch.zeros((4, 2), dtype=torch.int32)
    ffn.step_index(rows1, cols2, 4)
    with pytest.raises(ValueError):
        k5.check_run_side(torch.arange(4, dtype=torch.int32).repeat_interleave(3), 2, "b")
    bad = torch.tensor([0, 0, 1, 1, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError):
        k5.check_run_side(bad, 3)


def test_the_card_only_queries_are_not_reached_on_the_cpu(monkeypatch):
    """On CPU tensors no occupancy query or build runs."""
    def boom(*_a, **_k):
        raise AssertionError("reached the card")

    monkeypatch.setattr(k5, "wgrad_resident", boom)
    monkeypatch.setattr(k5._build, "load", boom)
    a, b, ia, ib = _operands(3, "a", seed=4)
    assert k5.bsmm_wgrad(a, b, ia, ib, k=16, run=3, shared="a").shape == (12, 16, 16)


def test_the_entry_argtypes_follow_the_c_signature():
    """The ctypes argument list of kernel 5's entry against its declaration
    in csrc/bsmm_grad.cu (a mismatch would only show on the card)."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(k5.__file__).resolve().parents[1] / "csrc" / "bsmm_grad.cu").read_text()
    decl = re.search(r'extern "C" int spgemm_bsmm_wgrad\(([^)]*)\)', src).group(1)
    kinds = {"void*": ctypes.c_void_p, "long long": ctypes.c_longlong, "int": ctypes.c_int}
    want = []
    for param in decl.split(","):
        words = " ".join(param.replace("const ", "").split()).rsplit(" ", 1)[0]
        want.append(kinds[words.replace(" *", "*")])
    assert k5.ENTRY_ARGTYPES == want
