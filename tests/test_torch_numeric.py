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
from spgemm_tpu_torch.utils.timers import ENGINE

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
    before = ENGINE.counter_snapshot().get("launches_numeric_round", 0)
    got = cuda_spgemm.numeric_round(*port)
    assert torch.equal(got, cuda_spgemm.numeric_round_ref(*port))
    assert ENGINE.counter_snapshot().get("launches_numeric_round", 0) == before


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


# Rounds heavy with sentinel slots.  The kernel and its plain version skip a
# slot whose pa or pb is the slab's last index; the JAX kernels fold it
# against the all-zero sentinel tile.  Both give the same bits, because the
# accumulator is canonical and adding 0 leaves it as it was.
SENTINEL_PATTERNS = ["pad_keys", "pa_sentinel", "pb_sentinel", "between", "stacked",
                     "edge_then_pad"]


def _sentinel_case(pattern, k, seed, n_tiles=9, P=6):
    """Slabs as (hi, lo) planes and (…, P) indices with sentinel slots laid
    out by `pattern`."""
    rng = np.random.default_rng(seed)
    a_hi, a_lo = _slab_planes(rng, n_tiles, k)
    b_hi, b_lo = _slab_planes(rng, n_tiles, k)
    lead = (3, 4) if pattern == "stacked" else (8,)
    pa = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pb = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    s = n_tiles  # the sentinel index of both slabs
    if pattern == "pad_keys":       # whole pad keys between real ones
        pa[1::2] = s
        pb[1::2] = s
    elif pattern == "pa_sentinel":  # pa sentinel, pb a real tile
        pa[:, 1::2] = s
    elif pattern == "pb_sentinel":  # pb sentinel, pa a real tile
        pb[:, ::2] = s
    elif pattern in ("between", "stacked"):  # both, scattered between real slots
        hole = rng.random(pa.shape) < 0.4
        pa[hole] = s
        pb[hole] = s
        pa[..., 0, :] = s  # and one whole pad key
        pb[..., 0, :] = s
    elif pattern == "edge_then_pad":
        # tile 0 of A: column 0 is 2^64 - 2, the rest 0; tile 1 of B: row 0
        # is 1.  Slot 0 takes every acc to 2^64 - 2, pad slots follow, and
        # the last slot adds 1: 2^64 - 1 collapses to 0 under mod.
        a = jax_u64.hilo_to_u64(a_hi, a_lo)
        b = jax_u64.hilo_to_u64(b_hi, b_lo)
        a[0] = 0
        a[0, :, 0] = MAX - 1
        a[1] = 0
        a[1, :, 0] = 1
        b[1] = 0
        b[1, 0, :] = 1
        a_hi, a_lo = jax_u64.u64_to_hilo(a)
        b_hi, b_lo = jax_u64.u64_to_hilo(b)
        pa[:] = s
        pb[:] = s
        pa[:, 0], pb[:, 0] = 0, 1
        pa[:, -1], pb[:, -1] = 1, 1
        pa[1::2, 2] = 0  # one-sided sentinels among the pads
        pb[::2, 3] = 1
    port = (_port_slab(a_hi, a_lo, k), _port_slab(b_hi, b_lo, k),
            torch.from_numpy(pa), torch.from_numpy(pb))
    jax_args = tuple(map(jnp.asarray, (a_hi, a_lo, b_hi, b_lo, pa, pb)))
    return port, jax_args


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("pattern", SENTINEL_PATTERNS)
def test_ref_skips_sentinel_slots_like_pallas_and_xla(pattern, k):
    port, jax_args = _sentinel_case(pattern, k, seed=len(pattern) * 10 + k)
    got = u64.t_to_u64(cuda_spgemm.numeric_round_ref(*port))
    pallas = jax_u64.hilo_to_u64(*numeric_round_pallas(*jax_args, interpret=True))
    xla = jax_u64.hilo_to_u64(*numeric_round_impl(*jax_args))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, xla)
    if pattern == "edge_then_pad":
        assert np.all(got == 0)  # 2^64 - 2, pads, then + 1 collapses


@pytest.mark.parametrize("pattern", SENTINEL_PATTERNS)
def test_ref_no_mod_skips_sentinel_slots_like_pallas(pattern):
    """The no_mod fold on values below 2^16 (the proof holds) against the
    Pallas kernel's no_mod variant and the mod fold."""
    port, jax_args = _sentinel_case(pattern, 2, seed=len(pattern) + 7)
    small = tuple(t & 0xFFFF for t in port[:2]) + port[2:]
    hi, lo = (jax_args[0] * 0, jax_args[1] & 0xFFFF), (jax_args[2] * 0, jax_args[3] & 0xFFFF)
    got = u64.t_to_u64(cuda_spgemm.numeric_round_ref(*small, no_mod=True))
    pallas = jax_u64.hilo_to_u64(*numeric_round_pallas(*hi, *lo, *jax_args[4:], interpret=True,
                                                       no_mod=True))
    assert np.array_equal(got, pallas)
    assert np.array_equal(got, u64.t_to_u64(cuda_spgemm.numeric_round_ref(*small)))


@pytest.mark.parametrize("no_mod", [False, True], ids=["mod", "no_mod"])
@pytest.mark.parametrize("pattern", ["pa_sentinel", "pb_sentinel", "between"])
def test_ref_skips_sentinel_slots_of_a_nonzero_last_tile(pattern, no_mod):
    """The contract keeps the sentinel tile zero; where it is not, the plain
    version (like the kernel) still skips sentinel slots, one-sided ones
    included: it equals the JAX kernel on the same slabs with the last tile
    zeroed."""
    port, jax_args = _sentinel_case(pattern, 4, seed=31)
    a, b, pa, pb = port
    dirty = [t.clone() for t in (a, b)]
    for t in dirty:
        t[-1] = torch.arange(1, 17, dtype=torch.int64).reshape(4, 4) * 0x1000193
    if no_mod:
        dirty = [t & 0xFFFF for t in dirty]
        jax_args = (jax_args[0] * 0, jax_args[1] & 0xFFFF, jax_args[2] * 0,
                    jax_args[3] & 0xFFFF, *jax_args[4:])
    got = u64.t_to_u64(cuda_spgemm.numeric_round_ref(*dirty, pa, pb, no_mod=no_mod))
    want = jax_u64.hilo_to_u64(*numeric_round_pallas(*jax_args, interpret=True, no_mod=no_mod))
    assert np.array_equal(got, want)
    # the wrapper on the CPU is the plain version
    assert np.array_equal(u64.t_to_u64(cuda_spgemm.numeric_round(*dirty, pa, pb, no_mod=no_mod)),
                          got)
