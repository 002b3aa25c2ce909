"""Device-resident block-sparse matrix: tiles stay on the card between
multiplies, only the block coordinates live on the host.

Representation: one (nnzb + 1, k, k) int64 bit-view slab (ops/u64.py) on an
explicit torch device, with an all-zero sentinel tile at index nnzb -- the
padding target the round planner (ops/symbolic.plan_rounds) points dead pair
slots at.  Native 64-bit integers replace the JAX package's (hi, lo) uint32
planes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spgemm_tpu_torch.ops import u64
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's `device` argument; refuses CUDA
    when this process has no usable card (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for but torch.cuda.is_available() "
            "is false; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


@dataclass
class DeviceBlockMatrix:
    """Block-sparse matrix with host coords and a device-resident tile slab.

    rows, cols : element dimensions (carried through, like the reference's).
    k          : tile edge.
    coords     : (nnzb, 2) int64 on the host, sorted lexicographically.
    slab       : (nnzb + 1, k, k) int64 bit-views on the device; sentinel
                 zero tile last.
    val_bound  : inclusive upper bound on the element values (python int),
                 which the hybrid and mxu backends read through bound().
                 None until first read: bound() then takes the tile max on
                 the device, so the exact backend, which never reads it,
                 pays nothing.  A multiply sets it on its result
                 (ops/spgemm.execute).

    Two attributes ride along outside the fields, as in the JAX package:
    `_host`, the BlockSparseMatrix a from_host matrix was uploaded from
    (ops/delta digests it, so a digest never copies from the card), and
    `_delta_tag`, the provenance ops/delta puts on a result it served.
    """

    rows: int
    cols: int
    k: int
    coords: np.ndarray
    slab: torch.Tensor
    val_bound: int | None = None

    @property
    def nnzb(self) -> int:
        return len(self.coords)

    @property
    def device(self) -> torch.device:
        return self.slab.device

    def bound(self) -> int:
        """val_bound, taken as the tile max (one reduction on the device)
        when nothing set it."""
        if self.val_bound is None:
            self.val_bound = u64.max_unsigned(self.slab)
        return self.val_bound

    @classmethod
    def from_host(cls, m: BlockSparseMatrix, device) -> "DeviceBlockMatrix":
        """Upload a host matrix: one host-to-device copy of tiles + sentinel;
        the result keeps m as `_host`."""
        from spgemm_tpu_torch.ops.spgemm import pack_tiles  # noqa: PLC0415 -- import cycle

        out = cls(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords,
                  slab=pack_tiles(m, device))
        out._host = m
        return out

    @classmethod
    def from_hilo(cls, rows: int, cols: int, k: int, coords, hi: np.ndarray,
                  lo: np.ndarray, device) -> "DeviceBlockMatrix":
        """Build from the JAX package's (hi, lo) uint32 planes of shape
        (nnzb + 1, k, k), sentinel tile last -- how tests hand both
        packages the same operands."""
        coords = np.asarray(coords, np.int64).reshape(-1, 2)
        hi = np.asarray(hi, np.uint32)
        lo = np.asarray(lo, np.uint32)
        shape = (len(coords) + 1, k, k)
        if hi.shape != shape or lo.shape != shape:
            raise ValueError(f"hi/lo planes must be {shape}, got {hi.shape}/{lo.shape}")
        if hi[-1].any() or lo[-1].any():
            raise ValueError("the sentinel tile (last) of the hi/lo planes is not zero")
        tiles = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
        return cls(rows=rows, cols=cols, k=k, coords=coords,
                   slab=u64.u64_to_t(tiles, resolve_device(device)))

    @classmethod
    def empty(cls, rows: int, cols: int, k: int, device) -> "DeviceBlockMatrix":
        return cls(rows=rows, cols=cols, k=k, coords=np.zeros((0, 2), np.int64),
                   slab=torch.zeros((1, k, k), dtype=torch.int64,
                                    device=resolve_device(device)),
                   val_bound=0)

    def to_host(self) -> BlockSparseMatrix:
        """Fetch the tiles to the host (one device-to-host copy)."""
        return BlockSparseMatrix(rows=self.rows, cols=self.cols, k=self.k,
                                 coords=self.coords,
                                 tiles=u64.t_to_u64(self.slab[: self.nnzb]))


def ensure_device(m, device) -> DeviceBlockMatrix:
    """Upload a host matrix to `device`; a device matrix passes through."""
    if isinstance(m, BlockSparseMatrix):
        return DeviceBlockMatrix.from_host(m, device)
    return m
