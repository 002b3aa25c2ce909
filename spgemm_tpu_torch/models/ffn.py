"""Block-sparse Transformer FFN, forward pass and training step: the port of
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
turned column-major).  Tensors keep the JAX package's layouts.

The training step (make_sharded_train_step, shard_params; the JAX module's
:177 and :227) runs on a (dp, tp) mesh (parallel/mesh.train_mesh; 1 x 1 on
one card) through the kernels, forward and backward.  With M = B * S rows:

  forward   pre = x . W1 (kernel 3 or 4), h = gelu(pre), y = h . W2 (kernel
            3 or 4 on W2 turned column-major), loss = mean((y - t)^2);
  backward  dpre = (dy . W2^T) * gelu'(pre): kernel 3 or 4 with x = dy, rows
            = W2's cols, W2's tiles transposed, and the gelu_grad epilogue;
            dW2[r, c] = h-strip r ^T . dy-strip cols2[r, c] and dW1[c, r] =
            x-strip rows1[c, r] ^T . dpre-strip c: kernel 5
            (ops/cuda_bsmm_grad.py).  No gradient is taken for x.

Its gradient is the single-device one, jax.grad(loss_fn) on the whole batch,
at every mesh: the JAX step's weight gradient comes out multiplied by tp
(its check_vma=False makes the transpose of psum(y_part, "tp") a psum), a
fault of the reference that the port does not copy (ROADMAP.md section 3).
loss_and_grads_ref and train_step_ref are the plain autograd versions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from spgemm_tpu_torch.ops.cuda_bsmm import (
    bsmm, bsmm_resident, gather_column_major, gelu, resident_panel_fits,
    w2_column_major_index, w2_to_column_major)
from spgemm_tpu_torch.ops.cuda_bsmm_grad import bsmm_wgrad
from spgemm_tpu_torch.ops.device import resolve_device
from spgemm_tpu_torch.parallel.mesh import TrainMesh


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

    w1, w2 = pparams["w1"], pparams["w2cm"]
    h = _matmul(xf, w1["rows"], w1["tiles"], block_m, resident, fuse_gelu=fuse_gelu)
    if not fuse_gelu:
        h = gelu(h)
    y = _matmul(h, w2["rows"], w2["tiles"], block_m, resident)
    return y[:M].reshape(B, S, D).to(x.dtype)


def _matmul(xin: torch.Tensor, rows: torch.Tensor, tiles: torch.Tensor, block_m: int,
            resident: bool | None, **epilogue) -> torch.Tensor:
    """One matmul through kernel 4 (resident True), kernel 3 (False) or,
    with resident None, kernel 4 where resident_panel_fits holds."""
    use_res = resident
    if use_res is None:
        use_res = resident_panel_fits(xin.shape[1], block_m, xin.element_size(),
                                      tiles.shape[-1])
    fn = bsmm_resident if use_res else bsmm
    return fn(xin, rows, tiles, block_m=block_m, **epilogue)


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


# ---------------------------------------------------------------------------
# The training step.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StepIndex:
    """The index bookkeeping of one weight structure, on the weights'
    device, computed once per ShardedTrainStep (rows and cols never change
    during training; only the W2 tile gather runs per step).

    rows1, cols2    : W1's rows and W2's cols as given (the cache key);
    rows2, tile_idx2: W2 column-major (cuda_bsmm.w2_column_major_index);
    ia1, ib1        : kernel 5's pairs for dW1, (x-strip rows1[c, r], dpre-strip c);
    ia2, ib2        : kernel 5's pairs for dW2, (h-strip r, dy-strip cols2[r, c])."""

    rows1: torch.Tensor
    cols2: torch.Tensor
    rows2: torch.Tensor
    tile_idx2: torch.Tensor
    ia1: torch.Tensor
    ib1: torch.Tensor
    ia2: torch.Tensor
    ib2: torch.Tensor


def step_index(rows1: torch.Tensor, cols2: torch.Tensor, nb_model: int) -> StepIndex:
    """StepIndex of W1's rows and W2's cols (one host round trip, for W2's
    column-major bookkeeping)."""
    dev = rows1.device
    rows2, tile_idx2 = w2_column_major_index(cols2, nb_model)
    nbf1, rpc = rows1.shape
    nbf2, cpc = cols2.shape

    def owners(n: int, per: int) -> torch.Tensor:
        return torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(per)

    return StepIndex(rows1, cols2, torch.from_numpy(rows2).to(dev),
                     torch.from_numpy(tile_idx2).to(dev),
                     rows1.reshape(-1).contiguous(), owners(nbf1, rpc),
                     owners(nbf2, cpc), cols2.reshape(-1).contiguous())


class _KernelFFN(torch.autograd.Function):
    """y = gelu(x . W1) . W2 over x rows padded to block_m, through the
    kernels both ways (module docstring).  forward(xf, w1_tiles, w2_tiles,
    index, block_m, resident); gradients for the two tile tensors only."""

    @staticmethod
    def forward(ctx, xf, w1_tiles, w2_tiles, index, block_m, resident):
        pre = _matmul(xf, index.rows1, w1_tiles, block_m, resident)
        h = gelu(pre)
        y = _matmul(h, index.rows2, gather_column_major(w2_tiles, index.tile_idx2), block_m,
                    resident)
        ctx.save_for_backward(xf, pre, h, w2_tiles)
        ctx.index, ctx.block_m, ctx.resident = index, block_m, resident
        return y

    @staticmethod
    def backward(ctx, dy):
        xf, pre, h, w2_tiles = ctx.saved_tensors
        index, k = ctx.index, w2_tiles.shape[-1]
        dy = dy.to(xf.dtype).contiguous()
        # W2^T in gather form: rows = W2's cols, each tile transposed (a copy
        # of the tiles once a step; the kernel reads them as given)
        w2t = w2_tiles.transpose(-1, -2).contiguous()
        dpre = _matmul(dy, index.cols2, w2t, ctx.block_m, ctx.resident, gelu_grad=pre)
        dw2 = bsmm_wgrad(h, dy, index.ia2, index.ib2, k=k).view(w2_tiles.shape)
        dw1 = bsmm_wgrad(xf, dpre, index.ia1, index.ib1, k=k)
        return None, dw1.view(index.rows1.shape + (k, k)), dw2, None, None, None


class _SumOverGroup(torch.autograd.Function):
    """all_reduce (sum) over a process group, with an identity backward:
    every rank of the group goes on with the same sum and so the same loss,
    and the gradient of that loss with respect to each rank's part is the
    gradient with respect to the sum.  torch.distributed.nn.functional.
    all_reduce sums the gradient again in its backward, which multiplies
    every weight gradient by the group's size (the JAX step's fault)."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over group in place (no autograd), or t where group is None."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _gather_seq(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The n sequence shards of t along axis 1, in group-rank order
    (jax.lax.all_gather(t, "tp", axis=1, tiled=True))."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=1)


def sgd(params: dict, grads: dict, lr: float) -> dict:
    """p - lr * g in the tiles' dtype (spgemm_tpu/models/ffn.py:207), into
    new tensors; the index arrays are passed through as they are."""
    def update(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return p - lr * g.to(p.dtype)

    return {"w1": {"rows": params["w1"]["rows"],
                   "tiles": update(params["w1"]["tiles"], grads["w1"])},
            "w2": {"cols": params["w2"]["cols"],
                   "tiles": update(params["w2"]["tiles"], grads["w2"])}}


class ShardedTrainStep:
    """The training step of make_sharded_train_step: step(params, x, y) ->
    (params, loss) on this rank's shards, and loss_and_grads(params, x, y)
    -> (loss, {"w1": dW1, "w2": dW2}) without the update.  The StepIndex of
    the first params' rows and cols is kept and reused while later calls
    pass the same index tensors (the step returns them unchanged)."""

    def __init__(self, mesh: TrainMesh, cfg: BlockSparseFFNConfig, lr: float,
                 block_m: int, resident: bool | None):
        self.mesh, self.cfg, self.lr = mesh, cfg, lr
        self.block_m, self.resident = block_m, resident
        self._index: StepIndex | None = None

    def index(self, params: dict) -> StepIndex:
        rows1, cols2 = params["w1"]["rows"], params["w2"]["cols"]
        idx = self._index
        if idx is None or idx.rows1 is not rows1 or idx.cols2 is not cols2:
            idx = self._index = step_index(rows1, cols2, self.cfg.nb_model)
        return idx

    def loss_and_grads(self, params: dict, x: torch.Tensor,
                       y: torch.Tensor) -> tuple[torch.Tensor, dict]:
        mesh, cfg = self.mesh, self.cfg
        index = self.index(params)
        # enter the FFN: gather the sequence shards (SP -> full activations)
        x_full = _gather_seq(x, mesh.tp_group, mesh.tp)
        y_full = _gather_seq(y, mesh.tp_group, mesh.tp)
        B, S, D = x_full.shape
        M = B * S
        M_pad = -(-M // self.block_m) * self.block_m
        xf = x_full.reshape(M, D)
        if M_pad != M:
            xf = torch.cat([xf, xf.new_zeros((M_pad - M, D))])
        xf = xf.contiguous()
        w1 = params["w1"]["tiles"].detach().requires_grad_()
        w2 = params["w2"]["tiles"].detach().requires_grad_()
        with torch.enable_grad():
            y_part = _KernelFFN.apply(xf, w1, w2, index, self.block_m, self.resident)
            # the padded rows are zero and fall away here, so they add no gradient
            pred = y_part[:M].reshape(B, S, D)
            if mesh.tp_group is not None:
                pred = _SumOverGroup.apply(pred, mesh.tp_group)  # row-parallel reduce
            sq_sum = torch.square(pred.float() - y_full.float()).sum()
            count = pred.numel() * mesh.dp  # the dp shards are equal (shard_data)
            # this rank's share of the loss: its squares over the global count
            g1, g2 = torch.autograd.grad(sq_sum / count, (w1, w2))
        grads = {"w1": _all_reduce(g1, mesh.dp_group), "w2": _all_reduce(g2, mesh.dp_group)}
        loss = _all_reduce(sq_sum.detach(), mesh.dp_group) / count
        return loss, grads

    def __call__(self, params: dict, x: torch.Tensor, y: torch.Tensor) -> tuple[dict, torch.Tensor]:
        loss, grads = self.loss_and_grads(params, x, y)
        return sgd(params, grads, self.lr), loss


def make_sharded_train_step(mesh: TrainMesh, cfg: BlockSparseFFNConfig, lr: float = 1e-3,
                            block_m: int = 128,
                            resident: bool | None = None) -> ShardedTrainStep:
    """train_step(params, x, y) -> (params, loss): spgemm_tpu/models/ffn.py:177.

    Every weight array is tp-sharded on axis 0 (shard_params); x and y are
    this rank's shard, dp on batch and tp on sequence (shard_data).  The
    loss, equal on every rank, is the squares summed over dp over the global
    count; the gradient is the single-device one (module docstring), the sum
    over dp of each rank's.  The update is SGD in the tiles' dtype into new
    tensors.  block_m and resident pick the forward's and the dgrad's
    kernels as in ffn_forward_kernels."""
    return ShardedTrainStep(mesh, cfg, lr, block_m, resident)


def shard_params(params: dict, mesh: TrainMesh) -> dict:
    """This rank's tp shard of every weight array, axis 0 (W1's block-cols,
    W2's block-rows: both the d_ff axis), on the mesh's device:
    spgemm_tpu/models/ffn.py:227."""
    def shard(a: torch.Tensor) -> torch.Tensor:
        if a.shape[0] % mesh.tp:
            raise ValueError(f"axis 0 of {tuple(a.shape)} does not split over tp={mesh.tp}")
        return a.reshape(mesh.tp, -1, *a.shape[1:])[mesh.tp_index].contiguous().to(mesh.device)

    return {name: {key: shard(a) for key, a in w.items()} for name, w in params.items()}


def shard_data(t: torch.Tensor, mesh: TrainMesh) -> torch.Tensor:
    """This rank's shard of a global (batch, seq, d_model) array, batch over
    dp and sequence over tp (PartitionSpec("dp", "tp")), on the mesh's
    device."""
    B, S, _ = t.shape
    if B % mesh.dp or S % mesh.tp:
        raise ValueError(f"(batch {B}, seq {S}) does not split over ({mesh.dp}, {mesh.tp})")
    b, s = B // mesh.dp, S // mesh.tp
    return t[mesh.dp_index * b:(mesh.dp_index + 1) * b,
             mesh.tp_index * s:(mesh.tp_index + 1) * s].contiguous().to(mesh.device)


def loss_and_grads_ref(params: dict, x: torch.Tensor, y: torch.Tensor,
                       cfg: BlockSparseFFNConfig) -> tuple[torch.Tensor, dict]:
    """The plain version of the step's gradient: torch autograd through
    loss_fn (the plain forward) on the whole batch, one device."""
    w1 = params["w1"]["tiles"].detach().requires_grad_()
    w2 = params["w2"]["tiles"].detach().requires_grad_()
    with torch.enable_grad():
        loss = loss_fn({"w1": {"rows": params["w1"]["rows"], "tiles": w1},
                        "w2": {"cols": params["w2"]["cols"], "tiles": w2}}, x, y, cfg)
        g1, g2 = torch.autograd.grad(loss, (w1, w2))
    return loss.detach(), {"w1": g1, "w2": g2}


def train_step_ref(params: dict, x: torch.Tensor, y: torch.Tensor, cfg: BlockSparseFFNConfig,
                   lr: float = 1e-3) -> tuple[dict, torch.Tensor]:
    """The plain training step on one device: loss_and_grads_ref, then sgd."""
    loss, grads = loss_and_grads_ref(params, x, y, cfg)
    return sgd(params, grads, lr), loss
