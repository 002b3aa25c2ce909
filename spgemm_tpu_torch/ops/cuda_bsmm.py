"""The block-sparse matmul of the FFN forward: two hand-written CUDA kernels
for Hopper (csrc/bsmm.cu) beside their plain PyTorch version (bsmm_ref).

Replaces the TPU kernels spgemm_tpu/ops/pallas_bsmm.py:bsmm_pallas
(kernel 3, streaming) and :bsmm_pallas_resident (kernel 4, the x panel held
on chip).  Contract of both: x (M, d_in) times a column-major block-sparse
W, whose output block-column c owns rpc k x k tiles; out[:, c*k:(c+1)*k] is
the f32 sum over r ascending of x[:, rows[c, r]*k : +k] @ tiles[c, r], with
an optional epilogue on that f32 sum, cast to x.dtype: the tanh-form gelu
(fuse_gelu), or gelu_grad=pre, the sum times gelu'(pre) at the same element,
which is the FFN backward's dpre = (dy . W2^T) * gelu'(pre) when x = dy,
rows = W2's cols and tiles = W2's tiles transposed (models/ffn.py).

Both kernels run one device body (bf16 on the tensor cores with
mma.sync m16n8k16, float32 on plain FMA), so at the same inputs they give
identical bits, whatever the block_m, the row tile, the warp tile, the ring
depth, the grid or the cluster.  Both are fed by a producer warp that keeps
TMA loads in flight into a ring of swizzled stages (a full and an empty
mbarrier a stage, no __syncthreads in the pair loop), and every consumer
warp owns a compile-time count of n-tiles or none, so the products run
unguarded.  What bounds kernel 3 at the FFN's full width is operations and
bytes about equally (PERF.md).

Kernel 3 (redesigned for Hopper) streams each pair's x block (gathered by a
2-D tensor map of x at column rows[c, r] * k) and its tile through a ring
of stream_layout's stages, on a persistent grid (stream_grid: min(items,
SMs x blocks an SM) blocks, each walking the items (row panel, column)
column fastest in steps of the grid, stream_walk), so the next item's
loads are in flight during an item's epilogue.  The epilogue writes the
item's output into a staged tile in shared memory, which one thread stores
by TMA; for gelu_grad the producer first loads the item's pre into that
tile by TMA.  Its consumers are two warpgroups on wgmma m64n128k16 at k
128 and row tile 128 (64 rows x 128 columns each, which gives mma.sync's
bits), else 8 warps on mma.sync (warp_rows).  At full width it takes
0.224, 0.385 and 0.412 ms on matmul 1, matmul 2 and the dgrad, where its
earlier body (one block per item, cp.async then __syncthreads around each
pair, the products guarded per n-tile) took 0.671, 1.017 and 0.838 ms in
the same call (NVIDIA H100 80GB HBM3, 700.00 W; tools/bsmm_bits_ab.py,
PERF.md).

Kernel 4 (redesigned for Hopper) holds a block's x panel in shared memory
and streams only the tiles through a ring of `stages` swizzled stages after
it; a cluster of `cluster` blocks on consecutive panels shares each tile by
TMA multicast.  resident_layout mirrors its shared memory and picks the
ring's depth (3 at full width); cluster_size picks the cluster.  At block_m
16 every block sweeps every tile of its column chunk, so the tile stream
from L2 (6.44 / cluster GB for matmul 1 at full width) bounds it.  The
earlier body (two padded buffers filled by every thread, the products
guarded per n-tile) took 5.48 ms; the redesign 1.06 ms, the stream alone
0.69 ms, torch.matmul 1.30 ms, clusters of 2 and 4 1.15 and 1.43 ms, so
FASTEST_CLUSTER is 1 (NVIDIA H100 80GB HBM3, 700.00 W;
tools/bsmm_resident_ab.py, PERF.md).

block_m is the TPU's row tile (the BlockSpec's); here it says what M is a
multiple of and where kernel 4 may run.  launch_geometry derives each grid
from the shapes: kernel 3 takes row_tile's rows per block, kernel 4
block_rows(block_m) rows (its panel must fit shared memory).

The resident gate changes its verdict from the TPU's.  The JAX gate
(spgemm_tpu/ops/pallas_bsmm.py:149) takes a 4 MB VMEM panel budget and
needs k % 128 == 0.  A Hopper thread block has 232,448 bytes of shared
memory, so here the block's panel (block_rows(block_m) x d_in, each row
padded by 16 bytes) plus two padded k x k tiles must fit that, and k must
be one the kernel takes.  At the FFN's full width (bf16, k = 128) W1's
panel (d_in = 4096) fits at block_m = 16 and not at 32, and W2's (d_in =
16384) never fits: with resident=None, block_m = 128 streams both matmuls
and block_m = 16 takes kernel 4 for matmul 1 only.  Wherever the gate
holds, resident_layout fits a ring of at least 2 unpadded stages.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from spgemm_tpu_torch.ops import _build
from spgemm_tpu_torch.utils.timers import ENGINE

_KERNEL = "bsmm"
KERNEL_KS = (16, 32, 64, 128)      # tile edges the kernel takes
SMEM_BYTES = 232_448               # shared memory a Hopper block can use
_ROW_PAD_BYTES = 16                # each shared row is padded by this much
_MBARRIER_BYTES = 8
RESIDENT_STAGES = (2, 3, 4)        # depths of kernel 4's tile ring
STREAM_STAGES = (1, 2, 3, 4)       # depths of kernel 3's ring (1 only where 2 do not fit)
# Rows of kernel 3's consumer tile: 16 or 32, a warp's on mma.sync; 64, a
# warpgroup's on wgmma.  Measured on the H100 at the FFN's full width, 64 was
# fastest, then 32, then 16 (PERF.md), so warp_rows takes the widest a launch
# allows.
WARP_ROWS = (16, 32, 64)
CLUSTER_SIZES = (1, 2, 4)          # blocks of kernel 4 that share each tile
# The cluster that measured fastest for kernel 4 at the FFN's full width on
# the H100 (PERF.md, kernel table); cluster_size takes the largest size up
# to it that a launch allows.
FASTEST_CLUSTER = 1
_ERR_ENCODE = 100_000              # csrc/bsmm.cu's kErrEncode
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_EPILOGUE_GELU, _EPILOGUE_GELU_GRAD = 1, 2  # csrc/bsmm.cu's kEpilogue*; 0 is none


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh form (torch's default is the erf form)."""
    return F.gelu(x, approximate="tanh")


def block_rows(block_m: int) -> int:
    """Rows of x one thread block owns: 16 times the largest power of two,
    at most 8, that divides block_m / 16 (one warp per 16 rows down, 8
    warps)."""
    groups = block_m // 16
    return 16 * max(d for d in (1, 2, 4, 8) if groups % d == 0)


def resident_panel_fits(d_in: int, block_m: int, dtype_bytes: int = 2,
                        k: int = 128) -> bool:
    """Whether kernel 4 takes these shapes on Hopper: k is a kernel tile
    edge, block_m a positive multiple of 16, and the block's x panel plus
    two weight tiles fit one block's shared memory.  Counterpart of
    spgemm_tpu/ops/pallas_bsmm.py:149, re-derived (module docstring)."""
    if k not in KERNEL_KS or block_m <= 0 or block_m % 16:
        return False
    panel = block_rows(block_m) * (d_in * dtype_bytes + _ROW_PAD_BYTES)
    tile = k * (k * dtype_bytes + _ROW_PAD_BYTES)
    return panel + 2 * tile <= SMEM_BYTES


def swizzle_span(k: int, dtype_bytes: int) -> int:
    """Bytes of a tile row that kernel 4's tensor map swizzles as one span:
    min(128, k * dtype_bytes).  The swizzle's pattern repeats every 8 rows,
    8 * span bytes."""
    return min(128, k * dtype_bytes)


@dataclass(frozen=True)
class ResidentLayout:
    """Kernel 4's shared memory, in bytes (csrc/bsmm.cu:resident_layout):
    the padded x panel from 0, the ring of `stages` unpadded k x k tiles
    from ring_offset, then barrier_bytes of mbarriers (a full and an empty
    one a stage); `total` is what the launch asks for."""
    panel_bytes: int
    ring_offset: int
    stage_bytes: int
    stages: int
    barrier_bytes: int
    total: int


def resident_layout(d_in: int, block_m: int, dtype_bytes: int = 2, k: int = 128,
                    stages: int | None = None) -> ResidentLayout | None:
    """Kernel 4's shared memory at these shapes.  The ring starts at the
    first multiple of the swizzle's pattern (8 * swizzle_span bytes: 1024
    wherever a tile row is 128 bytes or more) after the panel; every stage
    is a whole number of patterns.  stages=None takes the deepest ring of
    RESIDENT_STAGES that fits a block's SMEM_BYTES and gives None where not
    even 2 stages fit; a given depth that does not fit raises ValueError."""
    panel = block_rows(block_m) * (d_in * dtype_bytes + _ROW_PAD_BYTES)
    align = 8 * swizzle_span(k, dtype_bytes)
    ring = -(-panel // align) * align
    tile = k * k * dtype_bytes

    def layout(s: int) -> ResidentLayout:
        barriers = 2 * _MBARRIER_BYTES * s
        return ResidentLayout(panel, ring, tile, s, barriers, ring + s * tile + barriers)

    if stages is None:
        fits = [layout(s) for s in RESIDENT_STAGES if layout(s).total <= SMEM_BYTES]
        return fits[-1] if fits else None
    if stages not in RESIDENT_STAGES or layout(stages).total > SMEM_BYTES:
        raise ValueError(f"kernel 4 takes a ring of {RESIDENT_STAGES} stages within "
                         f"{SMEM_BYTES} bytes of shared memory; {stages} stages of {tile} "
                         f"bytes after a {panel}-byte panel need {layout(stages).total}")
    return layout(stages)


def cluster_sizes(panels: int, k: int) -> tuple[int, ...]:
    """The clusters kernel 4 can launch with: C of CLUSTER_SIZES dividing
    the row panels (a cluster's blocks sit on consecutive panels of one
    column chunk) and k / 8 (each block loads k / C rows of every tile, a
    whole number of the swizzle's 8-row patterns)."""
    return tuple(c for c in CLUSTER_SIZES if panels % c == 0 and k % (8 * c) == 0)


def cluster_size(panels: int, k: int, fastest: int = FASTEST_CLUSTER) -> int:
    """The cluster kernel 4 launches with: the largest of cluster_sizes
    that is at most `fastest`, the size that measured fastest (1 where no
    other divides the panels)."""
    return max(c for c in cluster_sizes(panels, k) if c <= fastest)


@dataclass(frozen=True)
class StreamLayout:
    """Kernel 3's shared memory, in bytes (csrc/bsmm.cu:stream_bytes):
    `stages` stages of stage_bytes from 0, each the pair's br x k x block
    (x_bytes) then its k x k tile (tile_bytes), both as the tensor maps'
    swizzled boxes; then the item's br x k staged tile (out_bytes, swizzled
    the same way: gelu_grad's pre loaded by TMA, then the output, which a
    TMA store writes out); then barrier_bytes of mbarriers (a full and an
    empty one a stage, and two for the staged tile).  `total` is what the
    launch asks for."""
    x_bytes: int
    tile_bytes: int
    stage_bytes: int
    stages: int
    out_bytes: int
    barrier_bytes: int
    total: int


def stream_layout(br: int, k: int, dtype_bytes: int = 2,
                  stages: int | None = None) -> StreamLayout:
    """Kernel 3's shared memory at a row tile of br.  Every stage and the
    staged tile are whole numbers of the swizzle's 8-row patterns, so each
    box starts on one.  stages=None takes the deepest ring of STREAM_STAGES
    that fits a block's SMEM_BYTES (3 at bf16, k 128, br 128); a given depth
    that does not fit raises ValueError."""
    x, tile = br * k * dtype_bytes, k * k * dtype_bytes

    def layout(s: int) -> StreamLayout:
        barriers = 2 * _MBARRIER_BYTES * (s + 1)
        return StreamLayout(x, tile, x + tile, s, x, barriers, s * (x + tile) + x + barriers)

    if stages is None:
        return [layout(s) for s in STREAM_STAGES if layout(s).total <= SMEM_BYTES][-1]
    if stages not in STREAM_STAGES or layout(stages).total > SMEM_BYTES:
        raise ValueError(f"kernel 3 takes a ring of {STREAM_STAGES} stages within "
                         f"{SMEM_BYTES} bytes of shared memory; {stages} stages of "
                         f"{x + tile} bytes and a {x}-byte staged tile need "
                         f"{layout(stages).total}")
    return layout(stages)


def warp_row_options(br: int, k: int, dtype_bytes: int) -> tuple[int, ...]:
    """The WARP_ROWS kernel 3 takes at a row tile of br: 16 always; 32, a
    warp's 32 x (k / 8 over the warps across) on mma.sync, for bf16 where
    br >= 32; 64, a warpgroup's 64 x 128 on wgmma (two warpgroups a block),
    for bf16 at k 128 and br 128."""
    out = (16,)
    if dtype_bytes == 2 and br >= 32:
        out += (32,)
    if dtype_bytes == 2 and br == 128 and k == 128:
        out += (64,)
    return out


def warp_rows(br: int, k: int, dtype_bytes: int, rows: int | None = None) -> int:
    """Rows of kernel 3's consumer tile: rows=None takes the widest of
    warp_row_options (the fastest measured); a given count the launch
    cannot take raises ValueError."""
    allowed = warp_row_options(br, k, dtype_bytes)
    if rows is None:
        return allowed[-1]
    if rows not in allowed:
        raise ValueError(f"kernel 3 takes consumer tiles of {allowed} rows at br {br}, k {k} "
                         f"and {dtype_bytes}-byte elements, not {rows}")
    return rows


def warp_ntiles(k: int, br: int, rows: int = 16) -> int:
    """The 8-wide n-tiles each consumer warp owns (or none) with tiles of
    `rows` rows in a block of br rows: k / 8 over the warps across, 8 /
    (br / rows), rounded up (csrc/bsmm.cu:warp_ntiles); with wgmma (rows
    64) each warp owns 16 rows of all k / 8."""
    if rows == 64:
        return k // 8
    across = 8 * rows // br
    return -(-(k // 8) // across)


def stream_grid(items: int, sms: int, blocks_per_sm: int, persistent: bool = True) -> int:
    """Kernel 3's blocks: as many as the card holds at once (sms x
    blocks_per_sm) and at most one an item; persistent=False gives one
    block an item."""
    return min(items, sms * blocks_per_sm) if persistent else items


def stream_walk(block: int, grid: int, panels: int, nbc: int) -> list[tuple[int, int]]:
    """The (row panel, output block-column) items block `block` of a grid
    of `grid` computes, in its order: item = panel * nbc + column (column
    fastest) from the block's index in steps of the grid, so the blocks in
    flight at once hold neighbouring items and share their x rows in L2."""
    return [divmod(item, nbc) for item in range(block, panels * nbc, grid)]


def row_tile(M: int, nbc: int, sms: int) -> int:
    """Rows of x one block of kernel 3 owns: the largest of 128, 64, 32 and
    16 that divides M and still gives every SM a block ((M / br) * nbc >=
    sms), and 16 where none does.  It does not depend on block_m: no bit of
    the output depends on which block owns a row."""
    for br in (128, 64, 32, 16):
        if M % br == 0 and (M // br) * nbc >= sms:
            return br
    return 16


@dataclass(frozen=True)
class Geometry:
    """One launch of kernel 3 or 4: br rows per block, `panels` row panels,
    and the output block-columns cut into col_blocks chunks of col_chunk."""
    br: int
    panels: int
    col_chunk: int
    col_blocks: int


def launch_geometry(M: int, nbc: int, block_m: int, resident: bool, sms: int) -> Geometry:
    """The row panels and columns each kernel covers on a card with `sms`
    SMs.  Kernel 3: br = row_tile, items (panel, column), walked by
    stream_grid's blocks (stream_walk).  Kernel 4: br =
    block_rows(block_m) (the panel must fit shared memory), the columns
    split only as far as about 2 blocks per SM need (each extra chunk loads
    the panel once more)."""
    if not resident:
        br = row_tile(M, nbc, sms)
        return Geometry(br, M // br, 1, nbc)
    br = block_rows(block_m)
    panels = M // br
    want = min(nbc, max(1, -(-2 * sms // panels)))
    col_chunk = -(-nbc // want)
    return Geometry(br, panels, col_chunk, -(-nbc // col_chunk))


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device `device_index`."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check_operands(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor,
                   block_m: int) -> tuple[int, int, int, int, int]:
    """Validate the operands; returns (M, d_in, nbc, rpc, k)."""
    if x.dim() != 2 or tiles.dim() != 4 or rows.dim() != 2:
        raise ValueError(f"want x (M, d_in), rows (nbc, rpc), tiles (nbc, rpc, k, k); got "
                         f"{tuple(x.shape)}, {tuple(rows.shape)}, {tuple(tiles.shape)}")
    M, d_in = x.shape
    nbc, rpc, k, k2 = tiles.shape
    if k2 != k or tuple(rows.shape) != (nbc, rpc) or rpc < 1 or k < 1:
        raise ValueError(f"tiles must be (nbc, rpc >= 1, k, k) with rows (nbc, rpc); got "
                         f"{tuple(tiles.shape)} and {tuple(rows.shape)}")
    if d_in % k:
        raise ValueError(f"d_in={d_in} is not a multiple of k={k}")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if tiles.dtype != x.dtype:
        raise TypeError(f"tiles must have x's dtype {x.dtype}, got {tiles.dtype}")
    if block_m <= 0 or M % block_m:
        raise ValueError(f"M={M} is not a multiple of block_m={block_m}")
    devices = {t.device for t in (x, rows, tiles)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (x, rows, tiles)):
        raise ValueError("operands must be contiguous")
    return M, d_in, nbc, rpc, k


def check_pre(pre: torch.Tensor | None, x: torch.Tensor, nbc: int, k: int,
              fuse_gelu: bool) -> None:
    """gelu_grad's pre: (M, nbc * k) in x's dtype, contiguous, on x's
    device; not together with fuse_gelu."""
    if pre is None:
        return
    if fuse_gelu:
        raise ValueError("fuse_gelu and gelu_grad are two epilogues; pass one")
    if tuple(pre.shape) != (x.shape[0], nbc * k) or pre.dtype != x.dtype:
        raise ValueError(f"gelu_grad must be ({x.shape[0]}, {nbc * k}) {x.dtype}, got "
                         f"{tuple(pre.shape)} {pre.dtype}")
    if pre.device != x.device or not pre.is_contiguous():
        raise ValueError("gelu_grad must be contiguous and on x's device")


def bsmm_ref(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor, *,
             fuse_gelu: bool = False, gelu_grad: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of kernels 3 and 4, on any device: gather
    the x blocks, take the products in float32 (a float32 matmul on the card
    is TF32 only if torch.backends.cuda.matmul.allow_tf32 is set), apply the
    optional epilogue to the f32 sum (gelu, or the sum times gelu'(pre) with
    pre = gelu_grad read in float32), cast to x.dtype."""
    M, d_in = x.shape
    nbc, rpc, k, _ = tiles.shape
    check_pre(gelu_grad, x, nbc, k, fuse_gelu)
    gathered = x.reshape(M, d_in // k, k).float()[:, rows.long()]   # (M, nbc, rpc, k)
    acc = torch.einsum("mcrk,crkj->mcj", gathered, tiles.float())
    if fuse_gelu:
        acc = gelu(acc)
    elif gelu_grad is not None:
        # autograd's own backward of the tanh-form gelu
        acc = torch.ops.aten.gelu_backward(acc, gelu_grad.float().reshape(M, nbc, k),
                                           approximate="tanh")
    return acc.reshape(M, nbc * k).to(x.dtype)


def _launch(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor, block_m: int,
            fuse_gelu: bool, resident: bool, br: int | None = None,
            cluster: int | None = None, stages: int | None = None,
            stream_only: int = 0, gelu_grad: torch.Tensor | None = None,
            warp_m: int | None = None, persistent: bool = True) -> torch.Tensor:
    """Launch kernel 3 or 4.  stages replaces the ring depth of
    stream_layout (kernel 3) or resident_layout (kernel 4); stream_only 1
    skips the products, and 2 (kernel 3) the epilogue too (diagnostics: the
    output is then not the product).  For kernel 3 only: br replaces
    row_tile's rows per block, warp_m warp_rows' consumer tile, and
    persistent=False launches one block an item in place of stream_grid's
    persistent grid.  For kernel 4 only:
    cluster replaces cluster_size's cluster.  The checks that no bit
    depends on these give them.  gelu_grad (pre) takes the gelu_grad
    epilogue."""
    M, d_in, nbc, rpc, k = check_operands(x, rows, tiles, block_m)
    check_pre(gelu_grad, x, nbc, k, fuse_gelu)
    if not resident and cluster is not None:
        raise ValueError("cluster is kernel 4's")
    if resident and (br is not None or warp_m is not None or not persistent):
        raise ValueError("br, warp_m and persistent are kernel 3's; kernel 4's row tile is "
                         "block_rows(block_m)")
    if x.device.type == "cpu":
        return bsmm_ref(x, rows, tiles, fuse_gelu=fuse_gelu, gelu_grad=gelu_grad)
    if x.device.type != "cuda":
        raise ValueError(f"no bsmm for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    if k not in KERNEL_KS:
        raise ValueError(f"the kernel takes k in {KERNEL_KS}, got k={k}")
    if block_m % 16:
        raise ValueError(f"the kernel takes block_m a multiple of 16, got {block_m}")
    if resident and not resident_panel_fits(d_in, block_m, x.element_size(), k):
        raise ValueError(f"the resident x panel ({block_rows(block_m)} x {d_in} "
                         f"{x.dtype}) and two tiles do not fit {SMEM_BYTES} bytes of "
                         f"shared memory (k={k}, block_m={block_m})")
    if any(t.data_ptr() % 16 for t in (x, tiles, *([] if gelu_grad is None else [gelu_grad]))):
        raise ValueError("x, tiles and gelu_grad must start on a 16-byte boundary")
    out = torch.empty((M, nbc * k), dtype=x.dtype, device=x.device)
    if M == 0 or nbc == 0:
        return out
    geo = launch_geometry(M, nbc, block_m, resident, sm_count(x.device.index))
    if br is not None:
        geo = Geometry(br, M // br, 1, nbc)
    epilogue = (_EPILOGUE_GELU if fuse_gelu else
                _EPILOGUE_GELU_GRAD if gelu_grad is not None else 0)
    if resident:  # column chunk, ring depth, cluster, stream_only
        layout = resident_layout(d_in, block_m, x.element_size(), k, stages)
        if cluster is None:
            cluster = cluster_size(geo.panels, k)
        elif cluster not in cluster_sizes(geo.panels, k):
            raise ValueError(f"kernel 4 takes a cluster of {cluster_sizes(geo.panels, k)} "
                             f"blocks at {geo.panels} panels and k={k}, not {cluster}")
        extra = {"col_chunk": geo.col_chunk, "stages": layout.stages, "cluster": cluster,
                 "stream_only": int(stream_only)}
    else:  # warp rows, ring depth, grid, stream_only
        layout = stream_layout(geo.br, k, x.element_size(), stages)
        rows_per_warp = warp_rows(geo.br, k, x.element_size(), warp_m)
        blocks = stream_blocks_per_sm(k, geo.br, rows_per_warp, layout.stages, x.dtype,
                                      epilogue, x.device.index)
        extra = {"warp_m": rows_per_warp, "stages": layout.stages,
                 "grid": stream_grid(geo.panels * nbc, sm_count(x.device.index), blocks,
                                     persistent),
                 "stream_only": int(stream_only)}
    lib = _build.load(_KERNEL)
    fn = lib.spgemm_bsmm_resident if resident else lib.spgemm_bsmm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
        + [ctypes.c_int] * (8 + len(extra)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), rows.data_ptr(), tiles.data_ptr(), out.data_ptr(),
             None if gelu_grad is None else gelu_grad.data_ptr(), M, d_in, nbc, rpc, k,
             geo.br, *extra.values(), _DTYPE_CODES[x.dtype], epilogue, x.device.index, stream)
    if err != 0:
        what = (f"a tensor map could not be encoded: CUresult {err - _ERR_ENCODE}"
                if err >= _ERR_ENCODE else f"CUDA error {err}")
        raise RuntimeError(f"bsmm kernel launch failed: {what} (M={M}, d_in={d_in}, "
                           f"nbc={nbc}, rpc={rpc}, k={k}, block_m={block_m}, {x.dtype}, "
                           f"resident={resident}, epilogue {epilogue}, {geo}, {extra})")
    # the launch counters, bumped here and nowhere else
    ENGINE.incr("launches_bsmm_resident" if resident else "launches_bsmm")
    return out


@functools.cache
def stream_blocks_per_sm(k: int, br: int, rows_per_warp: int, stages: int, dtype: torch.dtype,
                         epilogue: int, device: int) -> int:
    """cudaOccupancyMaxActiveBlocksPerMultiprocessor of kernel 3's instance
    for these shapes and epilogue (0, 1 or 2; the gelu_grad instance is
    another) on CUDA device `device`: how many of its blocks an SM holds at
    once (card only; raises where the runtime refuses or none fits)."""
    fn = _build.load(_KERNEL).spgemm_bsmm_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(k, br, rows_per_warp, stages, _DTYPE_CODES[dtype], epilogue, device,
             ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor of kernel 3 "
                           f"failed or gave {n.value}: CUDA error {err} (k={k}, br={br}, "
                           f"warp rows {rows_per_warp}, stages={stages}, {dtype}, "
                           f"epilogue {epilogue})")
    return n.value


def max_active_clusters(d_in: int, k: int, block_m: int, dtype: torch.dtype, cluster: int,
                        device: int, stages: int | None = None) -> int:
    """cudaOccupancyMaxActiveClusters of kernel 4 at these shapes on CUDA
    device `device`: how many clusters of `cluster` blocks the card holds
    at once (card only; raises where the runtime refuses)."""
    layout = resident_layout(d_in, block_m, torch.empty((), dtype=dtype).element_size(), k,
                             stages)
    if layout is None:
        raise ValueError(f"kernel 4's panel and ring do not fit at d_in={d_in}, k={k}, "
                         f"block_m={block_m}, {dtype}")
    fn = _build.load(_KERNEL).spgemm_bsmm_resident_clusters
    fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(d_in, k, block_rows(block_m), layout.stages, cluster, _DTYPE_CODES[dtype],
             device, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {err} "
                           f"(d_in={d_in}, k={k}, block_m={block_m}, {dtype}, "
                           f"cluster={cluster}, {layout})")
    return n.value


def bsmm(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor, *,
         block_m: int = 128, fuse_gelu: bool = False,
         gelu_grad: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 3, streaming: x (M, d_in) @ column-major block-sparse W ->
    (M, nbc * k) in x.dtype.  rows (nbc, rpc) int32, every entry below
    d_in / k (not checked on the card: a check would synchronise); tiles
    (nbc, rpc, k, k) in x.dtype; M a multiple of block_m.  fuse_gelu or
    gelu_grad (pre, (M, nbc * k) in x.dtype) picks the epilogue.  On CUDA
    tensors it launches the kernel on the current stream or raises; on CPU
    tensors it runs bsmm_ref."""
    return _launch(x, rows, tiles, block_m, fuse_gelu, resident=False, gelu_grad=gelu_grad)


def bsmm_resident(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor, *,
                  block_m: int = 128, fuse_gelu: bool = False,
                  gelu_grad: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 4: bsmm with each thread block's x panel read once into shared
    memory and held across its sweep of output block-columns.  The same
    contract and bits as bsmm; on CUDA tensors it raises ValueError where
    resident_panel_fits is false."""
    return _launch(x, rows, tiles, block_m, fuse_gelu, resident=True, gelu_grad=gelu_grad)


def w2_column_major_index(cols, nb_out: int) -> tuple[np.ndarray, np.ndarray]:
    """The bookkeeping of w2_to_column_major, on the host with numpy: rows
    (nb_out, rpc) int32, the x block-row each output block-col reads, and
    tile_idx (nb_out, rpc) int64 into W2's tiles flattened to (nbr * cpc,
    k, k) with one zero tile appended (index nbr * cpc, the pad of a ragged
    fan-in).  It depends on cols alone, so a training step computes it once."""
    cols_np = cols.cpu().numpy() if isinstance(cols, torch.Tensor) else np.asarray(cols)
    nbr, cpc = cols_np.shape
    fan = np.bincount(cols_np.reshape(-1), minlength=nb_out)
    rpc = max(1, int(fan.max()))
    rows_out = np.zeros((nb_out, rpc), np.int32)             # x block-row to read
    tile_idx = np.full((nb_out, rpc), nbr * cpc, np.int64)   # pad tile by default
    fill = np.zeros(nb_out, np.int64)
    for r in range(nbr):
        for ci, c in enumerate(cols_np[r]):
            rows_out[c, fill[c]] = r
            tile_idx[c, fill[c]] = r * cpc + ci
            fill[c] += 1
    return rows_out, tile_idx


def gather_column_major(tiles: torch.Tensor, tile_idx: torch.Tensor) -> torch.Tensor:
    """W2's tiles (nbr, cpc, k, k) in the column-major order of tile_idx
    (w2_column_major_index's, on the tiles' device), the pad tile zero."""
    nbr, cpc, k, _ = tiles.shape
    flat = torch.cat([tiles.reshape(nbr * cpc, k, k),
                      torch.zeros((1, k, k), dtype=tiles.dtype, device=tiles.device)])
    return flat[tile_idx].contiguous()


def w2_to_column_major(cols, tiles: torch.Tensor, nb_out: int):
    """Row-major W2 (each input block-row owns cpc block-cols) -> column-major
    (each output block-col owns rpc block-rows): (rows int32, tiles) on the
    tiles' device.  Ragged fan-in is padded with an appended zero tile,
    exactly as spgemm_tpu/ops/pallas_bsmm.py:160 does.  The bookkeeping
    runs on the host with numpy, the tile gather where the tiles lie; once
    per weight."""
    rows_out, tile_idx = w2_column_major_index(cols, nb_out)
    idx = torch.from_numpy(tile_idx).to(tiles.device)
    return torch.from_numpy(rows_out).to(tiles.device), gather_column_major(tiles, idx)
