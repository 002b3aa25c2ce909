"""The port's numeric round (ops/cuda_spgemm.py) against the JAX package's
TPU kernel (numeric_round_pallas in interpret mode) and its XLA twin
(numeric_round_impl).  Operands cross from the JAX package's (hi, lo)
uint32 planes through DeviceBlockMatrix.from_hilo.  Tolerance: exact.

On the CPU the wrapper runs the plain version; the kernel itself is checked
on the card by chip_smoke.py and tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_tpu.ops import u64 as jax_u64
from spgemm_tpu.ops.pallas_spgemm import numeric_round_pallas
from spgemm_tpu.ops.spgemm import numeric_round_impl
from spgemm_tpu_torch.ops import _build, cuda_spgemm
from spgemm_tpu_torch.ops import u64
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix

MAX = (1 << 64) - 1
EDGE = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                 (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX], dtype=np.uint64)


def _slab_planes(rng, n_tiles: int, k: int):
    """(n_tiles + 1, k, k) uint64 tiles (half EDGE values, half uniform),
    sentinel zero tile last, as JAX (hi, lo) planes."""
    edge = EDGE[rng.integers(0, len(EDGE), size=(n_tiles + 1, k, k))]
    full = rng.integers(0, 1 << 64, size=(n_tiles + 1, k, k), dtype=np.uint64)
    tiles = np.where(rng.random((n_tiles + 1, k, k)) < 0.5, edge, full)
    tiles[-1] = 0
    return jax_u64.u64_to_hilo(tiles)


def _port_slab(hi, lo, k):
    n = hi.shape[0] - 1
    coords = np.stack([np.arange(n), np.zeros(n, np.int64)], axis=1)
    return DeviceBlockMatrix.from_hilo(n * k, k, k, coords, hi, lo, "cpu").slab


def _indices(rng, lead, P, n_tiles):
    """Sentinel-padded (…, P) int32 index arrays: each key's real fanout is
    random, its tail points at the sentinel tile n_tiles."""
    pa = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pb = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pad = np.arange(P) >= rng.integers(0, P + 1, size=lead)[..., None]
    pa[pad] = n_tiles
    pb[pad] = n_tiles
    return pa, pb


def _case(seed, k, lead, P, n_tiles=9):
    rng = np.random.default_rng(seed)
    a_hi, a_lo = _slab_planes(rng, n_tiles, k)
    b_hi, b_lo = _slab_planes(rng, n_tiles, k)
    pa, pb = _indices(rng, lead, P, n_tiles)
    port = (_port_slab(a_hi, a_lo, k), _port_slab(b_hi, b_lo, k),
            torch.from_numpy(pa), torch.from_numpy(pb))
    jax_args = tuple(map(jnp.asarray, (a_hi, a_lo, b_hi, b_lo, pa, pb)))
    return port, jax_args


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("lead", [(12,), (3, 5)], ids=["round", "stacked"])
def test_ref_matches_pallas_interpret_and_xla(k, lead):
    port, jax_args = _case(100 * k + len(lead), k, lead, P=5)
    got = u64.t_to_u64(cuda_spgemm.numeric_round_ref(*port))
    assert got.shape == (*lead, k, k)
    pallas = jax_u64.hilo_to_u64(*numeric_round_pallas(*jax_args, interpret=True))
    xla = jax_u64.hilo_to_u64(*numeric_round_impl(*jax_args))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)


def test_hub_fanout_matches_xla():
    port, jax_args = _case(7, 4, (3,), P=96, n_tiles=40)
    got = u64.t_to_u64(cuda_spgemm.numeric_round_ref(*port))
    assert np.array_equal(got, jax_u64.hilo_to_u64(*numeric_round_impl(*jax_args)))


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    port, _ = _case(3, 4, (6,), P=3)
    before = cuda_spgemm.launches
    got = cuda_spgemm.numeric_round(*port)
    assert torch.equal(got, cuda_spgemm.numeric_round_ref(*port))
    assert cuda_spgemm.launches == before


def test_empty_round():
    port, _ = _case(4, 8, (0,), P=4)
    for fn in (cuda_spgemm.numeric_round, cuda_spgemm.numeric_round_ref):
        assert tuple(fn(*port).shape) == (0, 8, 8)


def test_wrapper_rejects_bad_operands():
    a, b, pa, pb = _case(5, 2, (4,), P=3)[0]
    with pytest.raises(TypeError):
        cuda_spgemm.numeric_round(a.int(), b, pa, pb)
    with pytest.raises(TypeError):
        cuda_spgemm.numeric_round(a, b, pa.long(), pb)
    with pytest.raises(ValueError):
        cuda_spgemm.numeric_round(a, b, pa, pb[:2])
    with pytest.raises(ValueError):
        cuda_spgemm.numeric_round(a, b, pa.t(), pb.t())  # not contiguous
    meta = [t.to("meta") for t in (a, b, pa, pb)]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        cuda_spgemm.numeric_round(*meta)


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")  # no cached library
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("numeric_round")


def test_from_hilo_rejects_nonzero_sentinel():
    hi = np.ones((2, 2, 2), np.uint32)
    with pytest.raises(ValueError, match="sentinel"):
        DeviceBlockMatrix.from_hilo(2, 2, 2, [[0, 0]], hi, hi, "cpu")
