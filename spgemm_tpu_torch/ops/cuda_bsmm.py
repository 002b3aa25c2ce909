"""The block-sparse matmul of the FFN forward: two hand-written CUDA kernels
for Hopper (csrc/bsmm.cu) beside their plain PyTorch version (bsmm_ref).

Replaces the TPU kernels spgemm_tpu/ops/pallas_bsmm.py:bsmm_pallas
(kernel 3, streaming) and :bsmm_pallas_resident (kernel 4, the x panel held
on chip).  Contract of both: x (M, d_in) times a column-major block-sparse
W, whose output block-column c owns rpc k x k tiles; out[:, c*k:(c+1)*k] is
the f32 sum over r ascending of x[:, rows[c, r]*k : +k] @ tiles[c, r], with
an optional tanh-form gelu on that f32 sum, cast to x.dtype.

Both kernels run one device body (bf16 on the tensor cores with
mma.sync m16n8k16, float32 on plain FMA), so at the same inputs they give
identical bits, whatever the block_m, the ring depth or the cluster.  What
bounds kernel 3 at the FFN's full width is operations and bytes about
equally (PERF.md).

Kernel 4 (redesigned for Hopper) holds a block's x panel in shared memory
and streams the tiles through a ring of `stages` swizzled stages after it,
fed by a tensor map (TMA) from a producer warp, with a full and an empty
mbarrier a stage; a cluster of `cluster` blocks on consecutive panels
shares each tile by TMA multicast.  resident_layout mirrors its shared
memory and picks the ring's depth (3 at full width); cluster_size picks the
cluster.  At block_m 16 every block sweeps every tile of its column chunk,
so the tile stream from L2 (6.44 / cluster GB for matmul 1 at full width)
bounds it once each warp's products run unguarded over its compile-time
n-tiles.  The earlier body (two padded buffers filled by every thread, the
products guarded per n-tile) took 5.48 ms; the redesign 1.06 ms, the
stream alone 0.69 ms, torch.matmul 1.30 ms, clusters of 2 and 4 1.15 and
1.43 ms, so FASTEST_CLUSTER is 1 (NVIDIA H100 80GB HBM3, 700.00 W;
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
CLUSTER_SIZES = (1, 2, 4)          # blocks of kernel 4 that share each tile
# The cluster that measured fastest for kernel 4 at the FFN's full width on
# the H100 (PERF.md, kernel table); cluster_size takes the largest size up
# to it that a launch allows.
FASTEST_CLUSTER = 1
_ERR_ENCODE = 100_000              # csrc/bsmm.cu's kErrEncode
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    """The grid each kernel launches on a card with `sms` SMs.  Kernel 3:
    br = row_tile, one block per (panel, column).  Kernel 4: br =
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


def bsmm_ref(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor, *,
             fuse_gelu: bool = False) -> torch.Tensor:
    """The plain PyTorch version of kernels 3 and 4, on any device: gather
    the x blocks, take the products in float32 (a float32 matmul on the card
    is TF32 only if torch.backends.cuda.matmul.allow_tf32 is set), apply the
    optional gelu to the f32 sum, cast to x.dtype."""
    M, d_in = x.shape
    nbc, rpc, k, _ = tiles.shape
    gathered = x.reshape(M, d_in // k, k).float()[:, rows.long()]   # (M, nbc, rpc, k)
    acc = torch.einsum("mcrk,crkj->mcj", gathered, tiles.float())
    if fuse_gelu:
        acc = gelu(acc)
    return acc.reshape(M, nbc * k).to(x.dtype)


def _launch(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor, block_m: int,
            fuse_gelu: bool, resident: bool, br: int | None = None,
            cluster: int | None = None, stages: int | None = None,
            stream_only: bool = False) -> torch.Tensor:
    """Launch kernel 3 or 4 on launch_geometry's grid.  br, for kernel 3
    only, replaces row_tile's rows per block; cluster, stages and
    stream_only, for kernel 4 only, replace cluster_size's cluster and
    resident_layout's ring depth, and skip the products (a diagnostic: the
    output is then not the product).  The checks that no bit depends on
    these give them."""
    M, d_in, nbc, rpc, k = check_operands(x, rows, tiles, block_m)
    if not resident and (cluster is not None or stages is not None or stream_only):
        raise ValueError("cluster, stages and stream_only are kernel 4's")
    if resident and br is not None:
        raise ValueError("kernel 4's row tile is block_rows(block_m)")
    if x.device.type == "cpu":
        return bsmm_ref(x, rows, tiles, fuse_gelu=fuse_gelu)
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
    if any(t.data_ptr() % 16 for t in (x, tiles)):
        raise ValueError("x and tiles must start on a 16-byte boundary")
    out = torch.empty((M, nbc * k), dtype=x.dtype, device=x.device)
    if M == 0 or nbc == 0:
        return out
    geo = launch_geometry(M, nbc, block_m, resident, sm_count(x.device.index))
    if br is not None:
        geo = Geometry(br, M // br, 1, nbc)
    extra = []  # kernel 4's: column chunk, ring depth, cluster, stream_only
    if resident:
        layout = resident_layout(d_in, block_m, x.element_size(), k, stages)
        if cluster is None:
            cluster = cluster_size(geo.panels, k)
        elif cluster not in cluster_sizes(geo.panels, k):
            raise ValueError(f"kernel 4 takes a cluster of {cluster_sizes(geo.panels, k)} "
                             f"blocks at {geo.panels} panels and k={k}, not {cluster}")
        extra = [geo.col_chunk, layout.stages, cluster, int(stream_only)]
    lib = _build.load(_KERNEL)
    fn = lib.spgemm_bsmm_resident if resident else lib.spgemm_bsmm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * (8 + len(extra)) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), rows.data_ptr(), tiles.data_ptr(), out.data_ptr(), M, d_in,
             nbc, rpc, k, geo.br, *extra, _DTYPE_CODES[x.dtype], int(fuse_gelu),
             x.device.index, stream)
    if err != 0:
        what = (f"the tiles' tensor map could not be encoded: CUresult {err - _ERR_ENCODE}"
                if err >= _ERR_ENCODE else f"CUDA error {err}")
        raise RuntimeError(f"bsmm kernel launch failed: {what} (M={M}, d_in={d_in}, "
                           f"nbc={nbc}, rpc={rpc}, k={k}, block_m={block_m}, {x.dtype}, "
                           f"resident={resident}, {geo}, ring/cluster {extra[1:3]})")
    # the launch counters, bumped here and nowhere else
    ENGINE.incr("launches_bsmm_resident" if resident else "launches_bsmm")
    return out


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
         block_m: int = 128, fuse_gelu: bool = False) -> torch.Tensor:
    """Kernel 3, streaming: x (M, d_in) @ column-major block-sparse W ->
    (M, nbc * k) in x.dtype.  rows (nbc, rpc) int32, every entry below
    d_in / k (not checked on the card: a check would synchronise); tiles
    (nbc, rpc, k, k) in x.dtype; M a multiple of block_m.  On CUDA tensors
    it launches the kernel on the current stream or raises; on CPU tensors
    it runs bsmm_ref."""
    return _launch(x, rows, tiles, block_m, fuse_gelu, resident=False)


def bsmm_resident(x: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor, *,
                  block_m: int = 128, fuse_gelu: bool = False) -> torch.Tensor:
    """Kernel 4: bsmm with each thread block's x panel read once into shared
    memory and held across its sweep of output block-columns.  The same
    contract and bits as bsmm; on CUDA tensors it raises ValueError where
    resident_panel_fits is false."""
    return _launch(x, rows, tiles, block_m, fuse_gelu, resident=True)


def w2_to_column_major(cols, tiles: torch.Tensor, nb_out: int):
    """Row-major W2 (each input block-row owns cpc block-cols) -> column-major
    (each output block-col owns rpc block-rows): (rows int32, tiles) on the
    tiles' device.  Ragged fan-in is padded with an appended zero tile,
    exactly as spgemm_tpu/ops/pallas_bsmm.py:160 does.  The bookkeeping
    runs on the host with numpy, the tile gather where the tiles lie; once
    per weight."""
    cols_np = cols.cpu().numpy() if isinstance(cols, torch.Tensor) else np.asarray(cols)
    nbr, cpc, k, _ = tiles.shape
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
    flat = torch.cat([tiles.reshape(nbr * cpc, k, k),
                      torch.zeros((1, k, k), dtype=tiles.dtype, device=tiles.device)])
    idx = torch.from_numpy(tile_idx).to(tiles.device)
    return torch.from_numpy(rows_out).to(tiles.device), flat[idx].contiguous()
