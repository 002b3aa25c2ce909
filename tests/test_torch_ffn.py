"""The port's block-sparse FFN forward (spgemm_tpu_torch/models/ffn.py,
ops/cuda_bsmm.py) against the JAX package's (spgemm_tpu/models/ffn.py,
ops/pallas_bsmm.py, the Pallas kernels in interpret mode).  Inputs come from
a numpy seed or from the JAX init_params, cross as numpy arrays, and go
through both packages on the CPU.

Tolerances, all float32: the plain version of kernels 3 and 4 (bsmm_ref)
and the gather at rtol = atol = 1e-5 (the products are the same, summed in
another order); the scatter and whole forwards at 1e-4 (index_add_ and
segment_sum sum in another order too); the layout conversions and
params_from_jax exactly; the gelu at 1e-6.

On the CPU the wrappers run the plain version; the kernels themselves are
checked on the card by chip_smoke.py and tests/test_torch_cuda.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_tpu.models import ffn as jffn
from spgemm_tpu.ops import pallas_bsmm
from spgemm_tpu_torch.models import ffn
from spgemm_tpu_torch.ops import cuda_bsmm
from spgemm_tpu_torch.utils.timers import ENGINE

# the configs of tests/test_ffn.py: the main one and the ragged-fan-in one
CFG = dict(d_model=64, d_ff=128, k=8, block_density=0.5, dtype="float32")
RAGGED = dict(d_model=32, d_ff=64, k=8, block_density=0.3, dtype="float32")
SMALL_K = dict(d_model=32, d_ff=64, k=4, block_density=0.5, dtype="float32")


def _params(cfg: dict, seed: int):
    """The same weights for both packages: (jax cfg, jax params, port cfg,
    port params on the CPU)."""
    jcfg = jffn.BlockSparseFFNConfig(**cfg)
    jp = jffn.init_params(jcfg, jax.random.key(seed))
    tp = ffn.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, jp, ffn.BlockSparseFFNConfig(**cfg), tp


def _bsmm_case(seed: int, M: int, nb_in: int, nbc: int, rpc: int, k: int):
    """x (M, nb_in*k), rows (nbc, rpc) distinct per column, tiles, float32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, nb_in * k)).astype(np.float32)
    rows = np.stack([rng.permutation(nb_in)[:rpc] for _ in range(nbc)]).astype(np.int32)
    tiles = (rng.standard_normal((nbc, rpc, k, k)) / np.sqrt(rpc * k)).astype(np.float32)
    return x, rows, tiles


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("cfg,seed", [(CFG, 1), (RAGGED, 22), (SMALL_K, 3)],
                         ids=["main", "ragged", "k4"])
def test_w2_to_column_major_matches_jax(cfg, seed):
    jcfg, jp, tcfg, tp = _params(cfg, seed)
    want_rows, want_tiles = pallas_bsmm.w2_to_column_major(
        np.asarray(jp["w2"]["cols"]), np.asarray(jp["w2"]["tiles"]), jcfg.nb_model)
    rows, tiles = cuda_bsmm.w2_to_column_major(tp["w2"]["cols"], tp["w2"]["tiles"],
                                               tcfg.nb_model)
    assert rows.dtype == torch.int32 and tiles.is_contiguous()
    assert np.array_equal(rows.numpy(), np.asarray(want_rows))
    assert np.array_equal(tiles.numpy(), np.asarray(want_tiles))
    fan = np.bincount(np.asarray(jp["w2"]["cols"]).ravel(), minlength=jcfg.nb_model)
    if cfg is RAGGED:  # ragged fan-in: some columns end in zero pad tiles
        assert fan.min() < fan.max() == rows.shape[1]
        assert not tiles[fan.argmin(), -1].any()


@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
@pytest.mark.parametrize("fuse_gelu", [False, True], ids=["plain", "gelu"])
@pytest.mark.parametrize("k,M,block_m", [(8, 16, 8), (4, 24, 8), (8, 32, 16)])
def test_bsmm_ref_matches_pallas_interpret(resident, fuse_gelu, k, M, block_m):
    x, rows, tiles = _bsmm_case(10 * k + M, M, nb_in=6, nbc=5, rpc=3, k=k)
    fn = pallas_bsmm.bsmm_pallas_resident if resident else pallas_bsmm.bsmm_pallas
    want = fn(jnp.asarray(x), jnp.asarray(rows), jnp.asarray(tiles), block_m=block_m,
              fuse_gelu=fuse_gelu)
    args = tuple(map(torch.from_numpy, (x, rows, tiles)))
    _close(cuda_bsmm.bsmm_ref(*args, fuse_gelu=fuse_gelu), want, 1e-5)
    wrapper = cuda_bsmm.bsmm_resident if resident else cuda_bsmm.bsmm
    before = ENGINE.counter_snapshot()
    _close(wrapper(*args, block_m=block_m, fuse_gelu=fuse_gelu), want, 1e-5)
    after = ENGINE.counter_snapshot()
    for name in ("launches_bsmm", "launches_bsmm_resident"):  # no kernel on the CPU
        assert after.get(name, 0) == before.get(name, 0)


@pytest.mark.parametrize("cfg,seed", [(CFG, 5), (RAGGED, 6)], ids=["main", "ragged"])
def test_plain_forward_matches_jax(cfg, seed):
    jcfg, jp, tcfg, tp = _params(cfg, seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, jcfg.d_model)).astype(np.float32)
    y = rng.standard_normal((2, 4, jcfg.d_model)).astype(np.float32)
    xb = x.reshape(8, jcfg.nb_model, jcfg.k)
    _close(ffn.bsmm_gather(torch.from_numpy(xb), tp["w1"]),
           jffn.bsmm_gather(jnp.asarray(xb), jp["w1"]), 1e-5)
    hb = rng.standard_normal((8, jcfg.nb_ff, jcfg.k)).astype(np.float32)
    _close(ffn.bsmm_scatter(torch.from_numpy(hb), tp["w2"], tcfg.nb_model),
           jffn.bsmm_scatter(jnp.asarray(hb), jp["w2"], jcfg.nb_model), 1e-4)
    _close(ffn.ffn_forward(tp, torch.from_numpy(x), tcfg),
           jffn.ffn_forward(jp, jnp.asarray(x), jcfg), 1e-4)
    got = ffn.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y), tcfg)
    assert abs(float(got) - float(jffn.loss_fn(jp, jnp.asarray(x), jnp.asarray(y), jcfg))) < 1e-4


@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
@pytest.mark.parametrize("fuse_gelu", [False, True], ids=["plain", "gelu"])
@pytest.mark.parametrize("cfg,shape", [(CFG, (2, 4)), (CFG, (1, 3)), (RAGGED, (1, 3))],
                         ids=["main", "padded-M", "ragged"])
def test_ffn_forward_kernels_matches_pallas(resident, fuse_gelu, cfg, shape):
    jcfg, jp, tcfg, tp = _params(cfg, 20)
    x = np.random.default_rng(21).standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    want = jffn.ffn_forward_pallas(jffn.prepare_pallas_params(jp, jcfg), jnp.asarray(x), jcfg,
                                   block_m=8, fuse_gelu=fuse_gelu, resident=resident)
    got = ffn.ffn_forward_kernels(ffn.prepare_kernel_params(tp, tcfg), torch.from_numpy(x),
                                  tcfg, block_m=8, fuse_gelu=fuse_gelu, resident=resident)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got, want, 1e-5)
    module = ffn.BlockSparseFFN(tp, tcfg, device="cpu", block_m=8, fuse_gelu=fuse_gelu,
                                resident=resident)
    assert {b.device.type for b in module.buffers()} == {"cpu"}
    assert torch.equal(module(torch.from_numpy(x)), got)


def test_params_from_jax_keeps_bf16_bits():
    jcfg = jffn.BlockSparseFFNConfig(d_model=64, d_ff=128, k=8, block_density=0.5)
    np_params = jax.tree.map(np.asarray, jffn.init_params(jcfg, jax.random.key(7)))
    assert np_params["w1"]["tiles"].dtype.name == "bfloat16"
    tp = ffn.params_from_jax(np_params, device="cpu")
    for name, key in (("w1", "tiles"), ("w2", "tiles")):
        assert tp[name][key].dtype == torch.bfloat16
        assert np.array_equal(tp[name][key].view(torch.int16).numpy(),
                              np_params[name][key].view(np.int16))
    assert np.array_equal(tp["w1"]["rows"].numpy(), np_params["w1"]["rows"])
    assert np.array_equal(tp["w2"]["cols"].numpy(), np_params["w2"]["cols"])


def test_gelu_is_jax_tanh_form():
    v = (np.random.default_rng(8).standard_normal(4096) * 4).astype(np.float32)
    _close(cuda_bsmm.gelu(torch.from_numpy(v)), jax.nn.gelu(jnp.asarray(v)), 1e-6)


@pytest.mark.parametrize("d_in,block_m,dtype_bytes,k,fits", [
    (4096, 16, 2, 128, True),     # W1 at full width: 131,328 + 2 x 34,816 bytes
    (4096, 32, 2, 128, False),
    (4096, 128, 2, 128, False),
    (16384, 16, 2, 128, False),   # W2 at full width never fits
    (16384, 128, 2, 128, False),
    (4096, 16, 4, 128, False),    # float32 doubles the panel
    (1024, 64, 2, 64, True),
    (4096, 16, 2, 8, False),      # k = 8 is not a kernel tile edge
    (4096, 8, 2, 128, False),     # block_m not a multiple of 16
])
def test_resident_panel_fits_on_hopper(d_in, block_m, dtype_bytes, k, fits):
    assert cuda_bsmm.resident_panel_fits(d_in, block_m, dtype_bytes, k) is fits


def test_block_rows():
    assert [cuda_bsmm.block_rows(b) for b in (16, 32, 48, 64, 96, 128, 256)] == \
        [16, 32, 16, 64, 32, 128, 128]


@pytest.mark.parametrize("M,nbc,sms,br", [
    (8192, 32, 132, 128),   # matmul 2 at full width: the block_m-128 grid at any block_m
    (8192, 128, 132, 128),  # matmul 1 at full width
    (256, 32, 132, 32),     # run (iv)'s matmul 2: 8 x 32 blocks
    (256, 128, 132, 128),
    (208, 128, 132, 16),    # 208 = 13 x 16: no wider tile divides it
    (64, 1, 132, 16),       # too few blocks at any tile
])
def test_row_tile(M, nbc, sms, br):
    assert cuda_bsmm.row_tile(M, nbc, sms) == br


@pytest.mark.parametrize("M,nbc,col_chunk,col_blocks", [
    (8192, 128, 128, 1),   # matmul 1 at full width: 512 panels, each block sweeps every column
    (256, 128, 8, 16),     # run (iv): 16 panels, 16 chunks of 8 columns
    (2048, 5, 2, 3),       # 128 panels: uneven chunks of 2, 2 and 1 columns
    (16, 6, 1, 6),         # one panel: one column a block
])
def test_resident_column_chunks(M, nbc, col_chunk, col_blocks):
    """Kernel 4 splits the columns only as far as about 2 blocks per SM need."""
    g = cuda_bsmm.launch_geometry(M, nbc, 16, True, sms=132)
    assert (g.br, g.panels, g.col_chunk, g.col_blocks) == (16, M // 16, col_chunk, col_blocks)


def test_launch_geometry_at_full_width():
    cfg = ffn.BlockSparseFFNConfig()
    geo = functools.partial(cuda_bsmm.launch_geometry, sms=132)
    for block_m in (16, 128):  # kernel 3: the row tile does not follow block_m
        assert geo(8192, cfg.nb_ff, block_m, False) == cuda_bsmm.Geometry(128, 64, 1, 128)
        assert geo(8192, cfg.nb_model, block_m, False) == cuda_bsmm.Geometry(128, 64, 1, 32)
    # kernel 4 at block_m 16: 512 panels of 16 rows, every block sweeps all 128 columns
    assert geo(8192, cfg.nb_ff, 16, True) == cuda_bsmm.Geometry(16, 512, 128, 1)
    # run (iv), M = 256: 16 panels, 16 chunks of 8 columns; matmul 2 in 32-row blocks
    assert geo(256, cfg.nb_ff, 16, True) == cuda_bsmm.Geometry(16, 16, 8, 16)
    assert geo(256, cfg.nb_model, 16, False) == cuda_bsmm.Geometry(32, 8, 1, 32)


@pytest.mark.parametrize("M", [16, 32, 64, 128, 208, 256, 1024, 8192])
@pytest.mark.parametrize("nbc", [1, 5, 32, 128])
@pytest.mark.parametrize("resident", [False, True], ids=["stream", "resident"])
def test_launch_geometry_covers_the_output(M, nbc, resident):
    g = cuda_bsmm.launch_geometry(M, nbc, 16, resident, sms=132)
    assert g.br in (16, 32, 64, 128) and g.panels * g.br == M
    assert (g.col_blocks - 1) * g.col_chunk < nbc <= g.col_blocks * g.col_chunk
    if resident:  # the panel is block_m's
        assert g.br == 16
    else:
        assert g.col_chunk == 1


def test_stream_layout_at_full_width():
    """Kernel 3 at the FFN's full width (bf16, k 128, row tile 128): three
    stages of a 32 KB x block and a 32 KB tile, the 32 KB staged tile and
    eight mbarriers; at row tile 64 four stages of 16 KB and 32 KB."""
    lay = cuda_bsmm.stream_layout(128, 128, 2)
    assert lay == cuda_bsmm.StreamLayout(x_bytes=32_768, tile_bytes=32_768, stage_bytes=65_536,
                                         stages=3, out_bytes=32_768, barrier_bytes=64,
                                         total=229_440)
    assert lay.total <= cuda_bsmm.SMEM_BYTES
    assert cuda_bsmm.stream_layout(64, 128, 2).total == 4 * 49_152 + 16_384 + 80


@pytest.mark.parametrize("stages,total", [(1, 98_336), (2, 163_888), (3, 229_440)])
def test_stream_layout_at_a_given_depth(stages, total):
    lay = cuda_bsmm.stream_layout(128, 128, 2, stages=stages)
    assert (lay.stages, lay.total, lay.barrier_bytes) == (stages, total, 16 * stages + 16)


@pytest.mark.parametrize("br,k,dtype_bytes,stages", [
    (128, 128, 2, 4),   # 4 x 64 KB
    (128, 128, 2, 0),
    (128, 128, 2, 5),
    (128, 128, 4, 2),   # float32: 128 KB a stage
    (16, 16, 2, 8),
])
def test_stream_layout_refuses_a_depth_it_cannot_take(br, k, dtype_bytes, stages):
    with pytest.raises(ValueError, match="stages"):
        cuda_bsmm.stream_layout(br, k, dtype_bytes, stages=stages)


@pytest.mark.parametrize("dtype_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", cuda_bsmm.KERNEL_KS)
@pytest.mark.parametrize("br", [16, 32, 64, 128])
def test_stream_layout_fits_every_row_tile(dtype_bytes, k, br):
    """Kernel 3's ring and staged tile fit a block's shared memory at every
    k, dtype and row tile: the deepest ring of STREAM_STAGES that fits, at
    least 2 deep for bf16, and every box starts on the swizzle's 8-row
    pattern."""
    lay = cuda_bsmm.stream_layout(br, k, dtype_bytes)
    span = cuda_bsmm.swizzle_span(k, dtype_bytes)
    assert lay.total <= cuda_bsmm.SMEM_BYTES
    assert lay.stages >= (2 if dtype_bytes == 2 else 1)
    assert (lay.x_bytes, lay.tile_bytes) == (br * k * dtype_bytes, k * k * dtype_bytes)
    assert lay.out_bytes == lay.x_bytes
    assert lay.total == lay.stages * lay.stage_bytes + lay.out_bytes + lay.barrier_bytes
    assert lay.x_bytes % (8 * span) == 0 and lay.stage_bytes % (8 * span) == 0
    if lay.stages < max(cuda_bsmm.STREAM_STAGES):  # the deepest ring that fits
        assert lay.total + lay.stage_bytes + 16 > cuda_bsmm.SMEM_BYTES
    for stages in cuda_bsmm.STREAM_STAGES:
        if stages <= lay.stages:
            assert cuda_bsmm.stream_layout(br, k, dtype_bytes, stages=stages).stages == stages


@pytest.mark.parametrize("br,k,dtype_bytes,given,want", [
    (128, 128, 2, None, 64),   # the FFN's full width: wgmma's warpgroups
    (128, 64, 2, None, 32),    # wgmma only at k 128
    (64, 128, 2, None, 32),    # and row tile 128
    (32, 128, 2, None, 32),
    (16, 128, 2, None, 16),    # a 16-row block holds no 32-row warp
    (128, 128, 4, None, 16),   # float32 runs 16-row warps on FMA
    (128, 128, 2, 16, 16),
    (128, 128, 2, 32, 32),
    (32, 16, 2, 32, 32),
])
def test_warp_rows(br, k, dtype_bytes, given, want):
    assert cuda_bsmm.warp_rows(br, k, dtype_bytes, given) == want
    assert want in cuda_bsmm.warp_row_options(br, k, dtype_bytes)
    assert set(cuda_bsmm.warp_row_options(br, k, dtype_bytes)) <= set(cuda_bsmm.WARP_ROWS)


@pytest.mark.parametrize("br,k,dtype_bytes,given", [(16, 128, 2, 32), (128, 128, 4, 32),
                                                    (128, 64, 2, 64), (64, 128, 2, 64),
                                                    (128, 128, 4, 64), (64, 128, 2, 8)])
def test_warp_rows_refuses_what_the_launch_cannot_take(br, k, dtype_bytes, given):
    with pytest.raises(ValueError, match="rows"):
        cuda_bsmm.warp_rows(br, k, dtype_bytes, given)


@pytest.mark.parametrize("k,br,rows,want", [
    (128, 128, 64, 16),   # wgmma: each warp of a warpgroup 16 rows x 128
    (128, 128, 16, 16),   # 16 x 128 warp tiles
    (128, 128, 32, 8),    # 32 x 64
    (128, 64, 32, 4),
    (128, 32, 32, 2),
    (128, 16, 16, 2),     # kernel 4 at block_m 16
    (16, 16, 16, 1),      # 2 n-tiles over 8 warps across: 2 warps own one
    (16, 128, 32, 1),
    (64, 64, 16, 4),
])
def test_warp_ntiles(k, br, rows, want):
    """Each consumer warp owns this many n-tiles or none, and the warps that
    own them cover the k / 8 n-tiles of the column exactly (on wgmma every
    warp owns 16 rows of all of them)."""
    nt = cuda_bsmm.warp_ntiles(k, br, rows)
    assert nt == want
    across = 1 if rows == 64 else 8 * rows // br
    assert min(across, k // 8 // nt) * nt == k // 8


@pytest.mark.parametrize("items,sms,per_sm,persistent,want", [
    (8192, 132, 1, True, 132),    # matmul 1 at full width
    (2048, 132, 1, True, 132),    # matmul 2
    (8192, 132, 1, False, 8192),  # one block an item
    (100, 132, 2, True, 100),     # fewer items than the card holds
    (1000, 132, 3, True, 396),
])
def test_stream_grid(items, sms, per_sm, persistent, want):
    assert cuda_bsmm.stream_grid(items, sms, per_sm, persistent) == want


@pytest.mark.parametrize("M", [16, 32, 64, 128, 208, 256, 1024, 8192])
@pytest.mark.parametrize("nbc", [1, 5, 32, 128])
@pytest.mark.parametrize("per_sm,persistent", [(1, True), (2, True), (1, False)],
                         ids=["persistent", "persistent2", "per_item"])
def test_stream_walk_covers_every_item(M, nbc, per_sm, persistent):
    """Kernel 3's blocks, on launch_geometry's row tile and stream_grid's
    grid, walk every (row panel, column) exactly once; each block's walk is
    column fastest, its items ascending in steps of the grid, so the blocks
    in flight at once hold neighbouring items."""
    g = cuda_bsmm.launch_geometry(M, nbc, 16, False, sms=132)
    items = g.panels * nbc
    grid = cuda_bsmm.stream_grid(items, 132, per_sm, persistent)
    assert 1 <= grid <= items
    seen = []
    for block in range(grid):
        walk = cuda_bsmm.stream_walk(block, grid, g.panels, nbc)
        flat = [p * nbc + c for p, c in walk]
        assert flat == list(range(block, items, grid))
        assert all(0 <= c < nbc and 0 <= p < g.panels for p, c in walk)
        seen += walk
    assert sorted(seen) == [(p, c) for p in range(g.panels) for c in range(nbc)]
    # the first wave: blocks 0..grid-1 take items 0..grid-1, column fastest
    assert [cuda_bsmm.stream_walk(b, grid, g.panels, nbc)[0] for b in range(min(grid, 3))] == \
        [divmod(i, nbc) for i in range(min(grid, 3))]


def test_resident_layout_at_full_width():
    """Kernel 4 on W1 at full width (d_in 4096, bf16, k 128, block_m 16): the
    panel, the ring at the next 1024 bytes, three 32 KB stages and six
    mbarriers."""
    lay = cuda_bsmm.resident_layout(4096, 16, 2, 128)
    assert lay == cuda_bsmm.ResidentLayout(panel_bytes=131_328, ring_offset=132_096,
                                           stage_bytes=32_768, stages=3, barrier_bytes=48,
                                           total=230_448)
    assert lay.ring_offset % 1024 == 0 and lay.total <= cuda_bsmm.SMEM_BYTES


@pytest.mark.parametrize("stages,total", [(2, 197_664), (3, 230_448)])
def test_resident_layout_at_a_given_depth(stages, total):
    lay = cuda_bsmm.resident_layout(4096, 16, 2, 128, stages=stages)
    assert (lay.stages, lay.total, lay.barrier_bytes) == (stages, total, 16 * stages)


@pytest.mark.parametrize("stages", [1, 4, 5])
def test_resident_layout_refuses_a_depth_it_cannot_take(stages):
    with pytest.raises(ValueError, match="stages"):
        cuda_bsmm.resident_layout(4096, 16, 2, 128, stages=stages)


def test_resident_layout_where_no_ring_fits():
    assert cuda_bsmm.resident_layout(16384, 16, 2, 128) is None  # W2 at full width
    assert not cuda_bsmm.resident_panel_fits(16384, 16, 2, 128)


@pytest.mark.parametrize("dtype_bytes", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("k", cuda_bsmm.KERNEL_KS)
def test_resident_layout_fits_wherever_the_gate_holds(dtype_bytes, k):
    """Wherever resident_panel_fits lets kernel 4 run, its ring is 2 to 4
    stages deep within a block's shared memory, and every stage starts on
    the swizzle's 8-row pattern: 1024 bytes wherever a row is 128 bytes or
    more (the panel's end is rounded up to it)."""
    span = cuda_bsmm.swizzle_span(k, dtype_bytes)
    assert span == min(128, k * dtype_bytes) and span in (32, 64, 128)
    seen = 0
    for block_m in range(16, 272, 16):
        for d_in in range(k, 32_768 + 1, k):
            if not cuda_bsmm.resident_panel_fits(d_in, block_m, dtype_bytes, k):
                continue
            seen += 1
            lay = cuda_bsmm.resident_layout(d_in, block_m, dtype_bytes, k)
            assert lay is not None and 2 <= lay.stages <= 4, (d_in, block_m)
            assert lay.total <= cuda_bsmm.SMEM_BYTES, (d_in, block_m)
            assert lay.panel_bytes <= lay.ring_offset < lay.panel_bytes + 8 * span
            assert lay.stage_bytes == k * k * dtype_bytes
            assert lay.total == lay.ring_offset + lay.stages * lay.stage_bytes \
                + lay.barrier_bytes
            for stage in range(lay.stages):
                start = lay.ring_offset + stage * lay.stage_bytes
                assert start % (8 * span) == 0
                if span == 128:
                    assert start % 1024 == 0
            if lay.stages < 4:  # the deepest ring that fits
                deeper = lay.ring_offset + (lay.stages + 1) * (lay.stage_bytes + 16)
                assert deeper > cuda_bsmm.SMEM_BYTES
    assert seen > 0


@pytest.mark.parametrize("panels,k,fastest,want", [
    (512, 128, 4, 4),   # matmul 1 at full width
    (512, 128, 2, 2),
    (512, 128, 1, 1),
    (16, 128, 4, 4),    # run (iv), M = 256
    (1, 128, 4, 1),     # a single panel
    (13, 128, 4, 1),    # M = 208: 13 panels, which no C > 1 divides
    (6, 128, 4, 2),
    (512, 16, 4, 2),    # k 16: a block's slice of 16 / C rows stays 8 deep
    (512, 32, 4, 4),
])
def test_cluster_size(panels, k, fastest, want):
    c = cuda_bsmm.cluster_size(panels, k, fastest=fastest)
    assert c == want and panels % c == 0 and k % (8 * c) == 0
    assert c in cuda_bsmm.cluster_sizes(panels, k)


@pytest.mark.parametrize("M", [16, 208, 256, 8192])
def test_cluster_size_divides_the_panels(M):
    panels = M // cuda_bsmm.block_rows(16)
    c = cuda_bsmm.cluster_size(panels, 128)
    assert c in cuda_bsmm.CLUSTER_SIZES and panels % c == 0
    assert c <= cuda_bsmm.FASTEST_CLUSTER
    if M in (16, 208):  # one panel; 13 panels
        assert c == 1


def test_kernel_4_options_on_the_cpu():
    """On CPU tensors the kernels' options change nothing (bsmm_ref runs):
    kernel 4's cluster and ring, kernel 3's ring, row tile, warp tile, grid
    and stream_only; kernel 3 refuses a cluster and kernel 4 refuses a row
    tile, a warp tile and kernel 3's grid."""
    x, rows, tiles = map(torch.from_numpy, _bsmm_case(11, 32, nb_in=4, nbc=3, rpc=2, k=8))
    want = cuda_bsmm.bsmm_ref(x, rows, tiles)
    got = cuda_bsmm._launch(x, rows, tiles, 16, False, resident=True, cluster=2, stages=2)
    assert torch.equal(got, want)
    got = cuda_bsmm._launch(x, rows, tiles, 16, False, resident=False, stages=3, br=32,
                            warp_m=32, persistent=False, stream_only=True)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="kernel 4"):
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=False, cluster=2)
    with pytest.raises(ValueError, match="row tile"):
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=True, br=32)
    with pytest.raises(ValueError, match="kernel 3"):
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=True, warp_m=16)
    with pytest.raises(ValueError, match="kernel 3"):
        cuda_bsmm._launch(x, rows, tiles, 16, False, resident=True, persistent=False)


def test_full_width_config_matches_jax():
    got, want = ffn.BlockSparseFFNConfig(), jffn.BlockSparseFFNConfig()
    assert got.__dict__ == want.__dict__
    assert (got.nb_model, got.nb_ff, got.rpc, got.cpc) == \
        (want.nb_model, want.nb_ff, want.rpc, want.cpc) == (32, 128, 3, 3)


def test_init_params_layout():
    cfg = ffn.BlockSparseFFNConfig(d_model=64, d_ff=128, k=8, block_density=0.5)
    p = ffn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    q = ffn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["w1"]["rows"].shape == (cfg.nb_ff, cfg.rpc) and p["w1"]["rows"].dtype == torch.int32
    assert p["w2"]["cols"].shape == (cfg.nb_ff, cfg.cpc)
    assert p["w1"]["tiles"].shape == (cfg.nb_ff, cfg.rpc, cfg.k, cfg.k)
    assert p["w2"]["tiles"].dtype == torch.bfloat16
    for idx in (p["w1"]["rows"], p["w2"]["cols"]):  # distinct per list, in range
        assert all(len(set(r.tolist())) == r.numel() for r in idx)
        assert int(idx.min()) >= 0 and int(idx.max()) < cfg.nb_model
    assert all(torch.equal(p[w][key], q[w][key]) for w in p for key in p[w])  # seeded
    s1 = float(p["w1"]["tiles"].float().std())
    assert abs(s1 * np.sqrt(cfg.rpc * cfg.k) - 1) < 0.1


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")


def test_entry_points_default_to_cuda(no_card):
    cfg = ffn.BlockSparseFFNConfig(d_model=32, d_ff=64, k=8, block_density=0.5,
                                   dtype="float32")
    params = ffn.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    np_params = {w: {key: t.numpy() for key, t in p.items()} for w, p in params.items()}
    with pytest.raises(RuntimeError, match="cuda"):
        ffn.init_params(cfg, torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="cuda"):
        ffn.params_from_jax(np_params)
    with pytest.raises(RuntimeError, match="cuda"):
        ffn.BlockSparseFFN(params, cfg)
    x = torch.randn((1, 2, cfg.d_model), generator=torch.Generator().manual_seed(2))
    got = ffn.BlockSparseFFN(ffn.params_from_jax(np_params, device="cpu"), cfg,
                             device="cpu", block_m=8)(x)
    assert torch.allclose(got, ffn.ffn_forward(params, x, cfg), rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_bad_operands():
    x, rows, tiles = map(torch.from_numpy, _bsmm_case(9, 16, nb_in=4, nbc=3, rpc=2, k=8))
    with pytest.raises(TypeError):
        cuda_bsmm.bsmm(x, rows.long(), tiles)
    with pytest.raises(TypeError):
        cuda_bsmm.bsmm(x, rows, tiles.double())
    with pytest.raises(ValueError):
        cuda_bsmm.bsmm(x, rows[:2], tiles)
    with pytest.raises(ValueError):
        cuda_bsmm.bsmm(x[:, :20], rows, tiles)  # d_in not a multiple of k
    with pytest.raises(ValueError):
        cuda_bsmm.bsmm(x, rows, tiles, block_m=32)  # M % block_m
    with pytest.raises(ValueError):
        cuda_bsmm.bsmm(x.t().contiguous().t(), rows, tiles, block_m=8)  # not contiguous
    meta = [t.to("meta") for t in (x, rows, tiles)]
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no silent fallback
        cuda_bsmm.bsmm_resident(*meta, block_m=8)
