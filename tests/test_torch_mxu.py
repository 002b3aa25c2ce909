"""The port's field-mode limb round and its no_mod exact fold against the JAX
package: the 7-bit limb split (ops/mxu_spgemm.limbs7) and the byte count
that holds it (bytes_for_limbs7), the plain version of the limb kernel
(numeric_round_mxu_ref, which splits into bytes) against the XLA
formulation numeric_round_mxu and the TPU kernel numeric_round_mxu_pallas in
interpret mode, over every limb count and at the top of each count's range,
its skipping of sentinel slots against a python-int field sum, the no_mod
plain version against numeric_round_pallas(no_mod=True) in interpret mode,
and the proof helpers against their JAX twins.  Operands cross from the JAX
package's (hi, lo) uint32 planes.  Tolerance: exact.

On the CPU the wrappers run the plain versions; the kernels themselves are
checked on the card by chip_smoke.py and tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_tpu.ops import u64 as jax_u64
from spgemm_tpu.ops.mxu_spgemm import limbs7 as jax_limbs7
from spgemm_tpu.ops.mxu_spgemm import numeric_round_mxu as jax_numeric_round_mxu
from spgemm_tpu.ops.mxu_spgemm import safe_exact_bound as jax_safe_exact_bound
from spgemm_tpu.ops.pallas_mxu import limbs_for_bound as jax_limbs_for_bound
from spgemm_tpu.ops.pallas_mxu import numeric_round_mxu_pallas
from spgemm_tpu.ops.pallas_spgemm import numeric_round_pallas
from spgemm_tpu.ops.spgemm import _proof_fanout_cap as jax_proof_fanout_cap
from spgemm_tpu.utils.gen import ADVERSARIAL_VALUES
from spgemm_tpu_torch.ops import cuda_mxu, cuda_spgemm, mxu_spgemm, u64
from spgemm_tpu_torch.ops.spgemm import _proof_fanout_cap
from spgemm_tpu_torch.utils.timers import ENGINE

MAX = (1 << 64) - 1
EDGE = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
                 (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX], dtype=np.uint64)


def _tiles(rng, n_tiles: int, k: int, small: bool) -> np.ndarray:
    """(n_tiles + 1, k, k) uint64, sentinel zero tile last: values below
    2^16, or half EDGE values and half uniform."""
    shape = (n_tiles + 1, k, k)
    if small:
        tiles = rng.integers(0, 1 << 16, size=shape, dtype=np.uint64)
    else:
        edge = EDGE[rng.integers(0, len(EDGE), size=shape)]
        full = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
        tiles = np.where(rng.random(shape) < 0.5, edge, full)
    tiles[-1] = 0
    return tiles


def _case(seed, k, lead, P, small, n_tiles=7):
    """The same seeded round for both packages: (port args, JAX args)."""
    rng = np.random.default_rng(seed)
    a, b = _tiles(rng, n_tiles, k, small), _tiles(rng, n_tiles, k, small)
    pa = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pb = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pad = np.arange(P) >= rng.integers(0, P + 1, size=lead)[..., None]
    pa[pad] = n_tiles
    pb[pad] = n_tiles
    port = (u64.u64_to_t(a), u64.u64_to_t(b), torch.from_numpy(pa), torch.from_numpy(pb))
    jax_args = tuple(map(jnp.asarray, (*jax_u64.u64_to_hilo(a), *jax_u64.u64_to_hilo(b), pa, pb)))
    return port, jax_args


@pytest.mark.parametrize("n_limbs", [10, 5, 3, 1])
def test_limb_split_matches_jax(n_limbs):
    x = np.concatenate([ADVERSARIAL_VALUES, EDGE])
    got = mxu_spgemm.limbs7(u64.u64_to_t(x), n_limbs)
    want = jax_limbs7(*jax_u64.u64_to_hilo(x), n_limbs)
    assert len(got) == len(want) == n_limbs
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    if n_limbs == 10:  # limb 9 is bit 63 alone
        assert set(got[9].tolist()) == {0, 1}


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("lead", [(6,), (2, 3)], ids=["round", "stacked"])
@pytest.mark.parametrize("limbs,small", [(10, False), (3, True)], ids=["10x10-edge", "3x3-small"])
def test_mxu_ref_matches_xla_and_pallas_interpret(k, lead, limbs, small):
    port, jax_args = _case(10 * k + len(lead) + limbs, k, lead, 3, small)
    got = u64.t_to_u64(mxu_spgemm.numeric_round_mxu_ref(*port, a_limbs=limbs, b_limbs=limbs))
    assert got.shape == (*lead, k, k)
    pallas = jax_u64.hilo_to_u64(*numeric_round_mxu_pallas(
        *jax_args, interpret=True, a_limbs=limbs, b_limbs=limbs))
    assert np.array_equal(got, pallas)
    # the XLA formulation always splits into 10 limbs, exact for any value
    xla = jax_u64.hilo_to_u64(*jax_numeric_round_mxu(*jax_args))
    got10 = u64.t_to_u64(mxu_spgemm.numeric_round_mxu_ref(*port))
    assert np.array_equal(got10, xla)
    if small:  # 3 limbs hold values below 2^16: the limb count changes nothing
        assert np.array_equal(got, got10)


@pytest.mark.parametrize("n_limbs,n_bytes", [(1, 1), (2, 2), (3, 3), (4, 4), (5, 5), (6, 6),
                                             (7, 7), (8, 7), (9, 8), (10, 8)])
def test_bytes_for_limbs7(n_limbs, n_bytes):
    assert mxu_spgemm.bytes_for_limbs7(n_limbs) == n_bytes
    top = min(MAX, (1 << (7 * n_limbs)) - 1)  # the largest value of n_limbs limbs
    x = u64.u64_to_t(np.array([top], np.uint64))
    parts = mxu_spgemm.limbs8(x, n_bytes)
    assert sum(int(p) << (8 * i) for i, p in enumerate(parts)) == top
    if n_bytes < 8:  # one byte fewer drops the top
        assert top >> (8 * (n_bytes - 1)) > 0


def _range_tiles(rng, n_tiles: int, k: int, n_limbs: int) -> np.ndarray:
    """(n_tiles + 1, k, k) uint64 below 2^(7 * n_limbs), sentinel zero tile
    last: a third the range's top, a third EDGE values in range, a third
    uniform in range."""
    top = min(MAX, (1 << (7 * n_limbs)) - 1)
    shape = (n_tiles + 1, k, k)
    edge = EDGE[EDGE <= top]
    pick = rng.integers(0, 3, size=shape)
    tiles = np.where(pick == 0, np.uint64(top), edge[rng.integers(0, len(edge), size=shape)])
    uniform = rng.integers(0, top, size=shape, dtype=np.uint64, endpoint=True)
    tiles = np.where(pick == 2, uniform, tiles)
    tiles[-1] = 0
    return tiles


LIMB_GRID = sorted({(a, b) for a in range(1, 11) for b in (1, 5, 10)}
                   | {(a, b) for a in (1, 5, 10) for b in range(1, 11)})


@pytest.mark.parametrize("k", [1, 8, 32])
@pytest.mark.parametrize("a_limbs,b_limbs", LIMB_GRID)
def test_byte_split_matches_jax_at_every_limb_count(k, a_limbs, b_limbs, monkeypatch):
    monkeypatch.setenv("SPGEMM_TPU_DELTA", "0")
    rng = np.random.default_rng(1000 * a_limbs + 10 * b_limbs + k)
    n_tiles, K, P = 5, 3, 3
    a, b = _range_tiles(rng, n_tiles, k, a_limbs), _range_tiles(rng, n_tiles, k, b_limbs)
    pa = rng.integers(0, n_tiles + 1, size=(K, P)).astype(np.int32)  # sentinels too
    pb = rng.integers(0, n_tiles + 1, size=(K, P)).astype(np.int32)
    got = u64.t_to_u64(mxu_spgemm.numeric_round_mxu_ref(
        u64.u64_to_t(a), u64.u64_to_t(b), torch.from_numpy(pa), torch.from_numpy(pb),
        a_limbs=a_limbs, b_limbs=b_limbs))
    want = jax_u64.hilo_to_u64(*jax_numeric_round_mxu(*map(jnp.asarray, (
        *jax_u64.u64_to_hilo(a), *jax_u64.u64_to_hilo(b), pa, pb))))
    assert np.array_equal(got, want)


def _field_sum_skipping_sentinels(a, b, pa, pb) -> np.ndarray:
    """The python-int field sum of each key's real slots (neither index its
    slab's last tile), canonical residues mod 2^64 - 1."""
    K, P = pa.shape
    k = a.shape[-1]
    out = np.zeros((K, k, k), np.uint64)
    for key in range(K):
        acc = np.zeros((k, k), dtype=object)
        for p in range(P):
            if pa[key, p] == len(a) - 1 or pb[key, p] == len(b) - 1:
                continue
            acc = acc + a[pa[key, p]].astype(object).dot(b[pb[key, p]].astype(object))
        out[key] = np.array([[x % MAX for x in row] for row in acc], dtype=np.uint64)
    return out


@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("limbs", [10, 3])
@pytest.mark.parametrize("sentinel", ["dirty", "zero"])
def test_mxu_ref_skips_sentinel_slots(k, limbs, sentinel):
    """One-sided and two-sided sentinel slots: with a last tile that is not
    zero the plain version still adds nothing for them, as the kernel skips
    them; with the planner's zero sentinel it also equals JAX."""
    rng = np.random.default_rng(30 * k + limbs)
    n_tiles, K, P = 6, 7, 5
    a, b = _range_tiles(rng, n_tiles, k, limbs), _range_tiles(rng, n_tiles, k, limbs)
    pa = rng.integers(0, n_tiles, size=(K, P)).astype(np.int32)
    pb = rng.integers(0, n_tiles, size=(K, P)).astype(np.int32)
    hole = rng.random((K, P))
    pa[hole < 0.4] = n_tiles
    pb[(hole > 0.2) & (hole < 0.6)] = n_tiles
    pa[0], pb[1] = n_tiles, n_tiles  # a whole pad key on each side
    if sentinel == "dirty":
        a[-1], b[-1] = a[0], b[1]
    got = u64.t_to_u64(mxu_spgemm.numeric_round_mxu_ref(
        u64.u64_to_t(a), u64.u64_to_t(b), torch.from_numpy(pa), torch.from_numpy(pb),
        a_limbs=limbs, b_limbs=limbs))
    assert np.array_equal(got, _field_sum_skipping_sentinels(a, b, pa, pb))
    assert not got[:2].any()
    if sentinel == "zero":
        want = jax_u64.hilo_to_u64(*jax_numeric_round_mxu(*map(jnp.asarray, (
            *jax_u64.u64_to_hilo(a), *jax_u64.u64_to_hilo(b), pa, pb))))
        assert np.array_equal(got, want)


def test_mxu_ref_chunks_keys_exactly(monkeypatch):
    port, _ = _case(3, 4, (9,), 5, False)
    whole = mxu_spgemm.numeric_round_mxu_ref(*port)
    monkeypatch.setattr(mxu_spgemm, "REF_CHUNK_ELEMENTS", 1)  # one key per chunk
    assert torch.equal(mxu_spgemm.numeric_round_mxu_ref(*port), whole)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("lead", [(6,), (2, 3)], ids=["round", "stacked"])
def test_no_mod_ref_matches_pallas_interpret(k, lead):
    port, jax_args = _case(20 * k + len(lead), k, lead, 4, False)
    got = u64.t_to_u64(cuda_spgemm.numeric_round_ref(*port, no_mod=True))
    want = jax_u64.hilo_to_u64(*numeric_round_pallas(*jax_args, interpret=True, no_mod=True))
    assert np.array_equal(got, want)


def test_no_mod_equals_mod_and_field_under_the_proof():
    port, _ = _case(5, 4, (8,), 4, True)
    no_mod = cuda_spgemm.numeric_round_ref(*port, no_mod=True)
    assert torch.equal(no_mod, cuda_spgemm.numeric_round_ref(*port))
    assert torch.equal(no_mod, mxu_spgemm.numeric_round_mxu_ref(*port, a_limbs=3, b_limbs=3))


BOUNDS = [0, 1, 127, 128, (1 << 16) - 1, (1 << 32) - 1, 1 << 32, (1 << 63) - 1,
          MAX - 1, MAX, 1 << 70]


def test_proof_helpers_match_jax():
    for bound in [None, *BOUNDS]:
        assert cuda_mxu.limbs_for_bound(bound) == jax_limbs_for_bound(bound)
    assert cuda_mxu.limbs_for_bound((1 << 16) - 1) == 3
    for a in BOUNDS:
        for b in BOUNDS:
            for k in (1, 4, 32):
                assert _proof_fanout_cap(a, b, k) == jax_proof_fanout_cap(a, b, k)
                for fan in (0, 1, 9, 4500):
                    assert mxu_spgemm.safe_exact_bound(a, b, fan, k) == \
                        jax_safe_exact_bound(a, b, fan, k)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    port, _ = _case(6, 4, (5,), 3, True)
    def launches():
        counters = ENGINE.counter_snapshot()
        return (counters.get("launches_numeric_round_mxu", 0),
                counters.get("launches_numeric_round_no_mod", 0))

    before = launches()
    assert torch.equal(cuda_mxu.numeric_round_mxu(*port, a_limbs=3, b_limbs=3),
                       mxu_spgemm.numeric_round_mxu_ref(*port, a_limbs=3, b_limbs=3))
    assert torch.equal(cuda_spgemm.numeric_round(*port, no_mod=True),
                       cuda_spgemm.numeric_round_ref(*port, no_mod=True))
    assert launches() == before


def test_empty_round():
    port, _ = _case(7, 8, (0,), 4, False)
    for fn in (cuda_mxu.numeric_round_mxu, mxu_spgemm.numeric_round_mxu_ref):
        assert tuple(fn(*port).shape) == (0, 8, 8)
    a, b = _case(7, 8, (3,), 4, False)[0][:2]
    none = torch.zeros((3, 0), dtype=torch.int32)  # P = 0: every key's tile is zero
    for fn in (cuda_mxu.numeric_round_mxu, mxu_spgemm.numeric_round_mxu_ref):
        assert torch.equal(fn(a, b, none, none), torch.zeros((3, 8, 8), dtype=torch.int64))


def test_mxu_rejects_deep_rounds_bad_limbs_and_other_devices():
    port, _ = _case(8, 2, (2,), 3, True)
    a, b = port[0], port[1]
    deep = torch.full((1, (1 << 16) + 1), 7, dtype=torch.int32)  # P*k > 2^17 at k=2
    for fn in (cuda_mxu.numeric_round_mxu, mxu_spgemm.numeric_round_mxu_ref):
        with pytest.raises(ValueError, match="2\\^17"):
            fn(a, b, deep, deep)
        for limbs in (0, 11):
            with pytest.raises(ValueError, match="limbs"):
                fn(*port, a_limbs=limbs)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        cuda_mxu.numeric_round_mxu(*[t.to("meta") for t in port])
