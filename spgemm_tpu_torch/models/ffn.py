"""Block-sparse Transformer FFN, forward pass: the port of
spgemm_tpu/models/ffn.py (BASELINE.json config 5).

A two-layer FFN whose weights are block-sparse, dense k x k tiles at about
10% block density, against dense activations:

  * W1 (d_model -> d_ff) is column-major block-sparse: each output
    block-column owns `rpc` nonzero block-rows;
  * W2 (d_ff -> d_model) is row-major block-sparse: each input block-row
    owns `cpc` nonzero block-columns.

Two forwards, as in the JAX package: the plain one (ffn_forward: gather and
einsum, index_add_ for the scatter) and the kernel one (ffn_forward_kernels:
both matmuls through the hand-written kernels of ops/cuda_bsmm.py, W2 first
turned column-major).  Tensors keep the JAX package's layouts.  The sharded
training step of the JAX module is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from spgemm_tpu_torch.ops.cuda_bsmm import (
    bsmm, bsmm_resident, gelu, resident_panel_fits, w2_to_column_major)
from spgemm_tpu_torch.ops.device import resolve_device


@dataclass(frozen=True)
class BlockSparseFFNConfig:
    """spgemm_tpu/models/ffn.py:38, the same fields, defaults and properties."""
    d_model: int = 4096
    d_ff: int = 16384
    k: int = 128            # tile edge
    block_density: float = 0.1
    dtype: str = "bfloat16"

    @property
    def nb_model(self) -> int:  # block count along d_model
        return self.d_model // self.k

    @property
    def nb_ff(self) -> int:     # block count along d_ff
        return self.d_ff // self.k

    @property
    def rpc(self) -> int:       # nonzero block-rows per W1 block-column
        return max(1, int(round(self.nb_model * self.block_density)))

    @property
    def cpc(self) -> int:       # nonzero block-cols per W2 block-row
        return max(1, int(round(self.nb_model * self.block_density)))


def init_params(cfg: BlockSparseFFNConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random weights in the layout and scales of spgemm_tpu/models/ffn.py:62,
    drawn from `generator` on its own device and moved to `device`:
    w1 {rows (nb_ff, rpc) int32, distinct per list; tiles (nb_ff, rpc, k, k)},
    w2 {cols (nb_ff, cpc) int32, distinct per list; tiles}.  The numbers are
    not JAX's (params_from_jax carries those across)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    gdev = generator.device

    def choice_rows(n_lists, n_from, m):
        keys = torch.rand((n_lists, n_from), generator=generator, device=gdev)
        return keys.argsort(dim=1)[:, :m].to(dev, torch.int32)

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=gdev) * scale).to(dev, dtype)

    s1 = 1.0 / np.sqrt(cfg.rpc * cfg.k)
    s2 = 1.0 / np.sqrt(cfg.block_density * cfg.nb_ff * cfg.k)
    return {
        "w1": {"rows": choice_rows(cfg.nb_ff, cfg.nb_model, cfg.rpc),
               "tiles": normal((cfg.nb_ff, cfg.rpc, cfg.k, cfg.k), s1)},
        "w2": {"cols": choice_rows(cfg.nb_ff, cfg.nb_model, cfg.cpc),
               "tiles": normal((cfg.nb_ff, cfg.cpc, cfg.k, cfg.k), s2)},
    }


def _tensor(arr, dev: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy
    if arr.dtype.name == "bfloat16":  # ml_dtypes' type, which torch.from_numpy refuses
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def params_from_jax(np_params: dict, device="cuda") -> dict:
    """The JAX package's params (spgemm_tpu/models/ffn.init_params), as a
    nested dict of numpy arrays, as the port's params on `device`, bit for
    bit; bf16 goes through an int16 view."""
    dev = resolve_device(device)
    return {name: {key: _tensor(arr, dev) for key, arr in w.items()}
            for name, w in np_params.items()}


def bsmm_gather(x_blocks: torch.Tensor, w: dict) -> torch.Tensor:
    """Column-parallel block-sparse matmul, (B, nbr, k) -> (B, nbc, k):
    spgemm_tpu/models/ffn.py:85.  Gathers each output block-column's nonzero
    input block-rows and contracts them: (B, nbc, rpc, k) x (nbc, rpc, k, k)."""
    gathered = x_blocks[:, w["rows"].long(), :]
    return torch.einsum("bcrk,crkj->bcj", gathered, w["tiles"])


def bsmm_scatter(x_blocks: torch.Tensor, w: dict, n_out_blocks: int) -> torch.Tensor:
    """Row-parallel block-sparse matmul, (B, nbr, k) -> (B, n_out_blocks, k):
    spgemm_tpu/models/ffn.py:94.  Each input block-row adds into its cpc
    output block-columns with index_add_ (jax.ops.segment_sum there)."""
    B, _, k = x_blocks.shape
    contrib = torch.einsum("brk,rckj->brcj", x_blocks, w["tiles"])  # (B, R, C, k)
    R, C = w["cols"].shape
    flat = contrib.reshape(B, R * C, k).transpose(0, 1)              # (R*C, B, k)
    out = torch.zeros((n_out_blocks, B, k), dtype=flat.dtype, device=flat.device)
    out.index_add_(0, w["cols"].reshape(R * C).long(), flat)
    return out.transpose(0, 1)


def ffn_forward(params: dict, x: torch.Tensor, cfg: BlockSparseFFNConfig) -> torch.Tensor:
    """The plain forward, x (batch, seq, d_model) -> (batch, seq, d_model):
    spgemm_tpu/models/ffn.py:109."""
    B, S, D = x.shape
    xb = x.reshape(B * S, cfg.nb_model, cfg.k)
    h = gelu(bsmm_gather(xb, params["w1"]))          # (B*S, nb_ff, k)
    y = bsmm_scatter(h, params["w2"], cfg.nb_model)  # (B*S, nb_model, k)
    return y.reshape(B, S, D).to(x.dtype)


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor,
            cfg: BlockSparseFFNConfig) -> torch.Tensor:
    """Mean squared error of the plain forward: spgemm_tpu/models/ffn.py:168."""
    pred = ffn_forward(params, x, cfg)
    return torch.mean(torch.square(pred.float() - y.float()))


def prepare_kernel_params(params: dict, cfg: BlockSparseFFNConfig) -> dict:
    """One-time prep for the kernel forward, W2 turned column-major:
    spgemm_tpu/models/ffn.py:118 (prepare_pallas_params)."""
    rows2, tiles2 = w2_to_column_major(params["w2"]["cols"], params["w2"]["tiles"],
                                       cfg.nb_model)
    return {"w1": params["w1"], "w2cm": {"rows": rows2, "tiles": tiles2}}


def ffn_forward_kernels(pparams: dict, x: torch.Tensor, cfg: BlockSparseFFNConfig,
                        block_m: int = 128, fuse_gelu: bool = False,
                        resident: bool | None = None) -> torch.Tensor:
    """ffn_forward with both matmuls through kernels 3 and 4:
    spgemm_tpu/models/ffn.py:128 (ffn_forward_pallas).

    pparams: output of prepare_kernel_params.  The batch*seq axis is padded
    to a block_m multiple.  fuse_gelu moves the activation into the first
    matmul's epilogue.  resident picks kernel 4 (True) or kernel 3 (False)
    for both matmuls; None picks kernel 4 per matmul where
    resident_panel_fits holds.  On CUDA tensors every matmul launches a
    kernel; on CPU tensors the wrappers run the plain version."""
    B, S, D = x.shape
    M = B * S
    M_pad = -(-M // block_m) * block_m
    xf = x.reshape(M, D)
    if M_pad != M:
        xf = torch.cat([xf, xf.new_zeros((M_pad - M, D))])

    def mm(xin, w, fused):
        use_res = resident
        if use_res is None:
            use_res = resident_panel_fits(xin.shape[1], block_m, xin.element_size(), cfg.k)
        fn = bsmm_resident if use_res else bsmm
        return fn(xin, w["rows"], w["tiles"], block_m=block_m, fuse_gelu=fused)

    h = mm(xf, pparams["w1"], fuse_gelu)
    if not fuse_gelu:
        h = gelu(h)
    y = mm(h, pparams["w2cm"], False)
    return y[:M].reshape(B, S, D).to(x.dtype)


class BlockSparseFFN(nn.Module):
    """The kernel forward as a module: the prepared weights are buffers on
    an explicit device (default cuda, which raises without a card), and
    forward(x) runs ffn_forward_kernels."""

    def __init__(self, params: dict, cfg: BlockSparseFFNConfig, device="cuda",
                 block_m: int = 128, fuse_gelu: bool = False,
                 resident: bool | None = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.block_m, self.fuse_gelu, self.resident = block_m, fuse_gelu, resident
        pp = prepare_kernel_params(params, cfg)
        for name, w in (("w1", pp["w1"]), ("w2cm", pp["w2cm"])):
            self.register_buffer(f"{name}_rows", w["rows"].to(dev))
            self.register_buffer(f"{name}_tiles", w["tiles"].to(dev))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pparams = {name: {"rows": getattr(self, f"{name}_rows"),
                          "tiles": getattr(self, f"{name}_tiles")}
                   for name in ("w1", "w2cm")}
        return ffn_forward_kernels(pparams, x, self.cfg, block_m=self.block_m,
                                   fuse_gelu=self.fuse_gelu, resident=self.resident)
