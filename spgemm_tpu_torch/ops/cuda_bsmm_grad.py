"""The weight gradient of the block-sparse FFN: kernel 5, a hand-written CUDA
kernel for Hopper (csrc/bsmm_grad.cu), beside its plain PyTorch version
(bsmm_wgrad_ref).

Replaces no Pallas kernel.  In the JAX package the training step's weight
gradients are XLA's transposes of the einsums of bsmm_gather and
bsmm_scatter (spgemm_tpu/models/ffn.py:85,94) under jax.value_and_grad
(:204).  Contract: out[p] = A[:, ia[p]*k : +k]^T . B[:, ib[p]*k : +k], the
k x k product of two column strips summed over all M rows in float32 and
rounded once to the dtype.  dW1[c, r] is x-strip rows1[c, r] against
dpre-strip c; dW2[r, c] is h-strip r against dy-strip cols2[r, c]
(models/ffn.py).

Two bodies, one element ownership: each output element is owned by one
thread, which adds the 16-deep steps of M (float32: the rows) in ascending
order, so both give the same bits.

  * "wgmma" (redesigned for Hopper; bf16 at k 128, the FFN's shapes): a
    persistent grid (wgrad_grid) walks the tiles; a producer warp keeps a
    ring of wgrad_layout's stages filled by TMA, each stage bm rows of the
    pair's two strips gathered by 2-D tensor maps at columns ia[p]*k and
    ib[p]*k; two consumer warpgroups run wgmma.m64n128k16 (A the a-strip
    chunk, M-major; B the b-strip chunk, N-major), 64 rows of the tile
    each; the epilogue stages the tile in shared memory and stores it by
    TMA (the "tile" form).  With a run length G and the shared side (run=,
    shared=: G consecutive pairs share one strip, as StepIndex's pairs
    do), the "half" form: one block of G warpgroups over a 64-wide half of
    the non-shared dimension of all G tiles, so the shared strip is read
    once a half and not once a tile.  A cluster of G blocks multicasting
    the shared strip measured slower and was not kept (PERF.md).
  * "mma_sync" (the first body; float32, k 16, 32 and 64): one block per
    tile, double-buffered cp.async chunks, mma.sync m16n8k16 with the A^T
    fragments through ldmatrix.trans, float32 on plain FMA.  It stays
    reachable as body="mma_sync" for the bit checks and the A/B tool.

What bounds it at the FFN's full width (P = 384 tiles, M = 8192, k = 128,
bf16): 103.1 GFLOP, 0.104 ms on the tensor cores, about as long as its
bytes take (0.104 ms); in practice the stream of strips from L2 into shared
memory (strip_bytes: 1.61 GB a call one tile a block, 1.34 GB in the half
form).  On an NVIDIA H100 80GB HBM3, 700.00 W, in rounds against the first
body (tools/wgrad_bits_ab.py, PERF.md): dW1 / dW2 0.209 / 0.223 ms in the
half form, 0.233 / 0.230 one tile a block, the mma.sync body 0.386 / 0.386.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from spgemm_tpu_torch.ops import _build
from spgemm_tpu_torch.ops.cuda_bsmm import KERNEL_KS, SMEM_BYTES, sm_count
from spgemm_tpu_torch.utils.timers import ENGINE

_KERNEL = "bsmm_grad"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ERR_ENCODE = 100_000              # csrc/hopper.cuh's kErrEncode
_BODY_CODES = {"mma_sync": 0, "wgmma": 1}
WGRAD_BODIES = tuple(_BODY_CODES)
# the wgmma body's forms (csrc/bsmm_grad.cu's kForm*): one tile a block, and
# one block over half of a run's tiles
_FORM_CODES = {"tile": 0, "half": 1}
WGMMA_K = 128                      # the tile edge the wgmma body takes (bf16)
WGRAD_STAGES = tuple(range(2, 9))  # depths of the wgmma body's ring
WGRAD_GROUPS = (2, 3, 4)           # run lengths the half form takes
# rows of M a stage holds by default in each form (the fastest measured at
# the FFN's full width on the H100, PERF.md)
WGRAD_DEPTH = {"tile": 128, "half": 64}
_BOX_ROW_BYTES = 128               # a swizzled box row: 64 bf16 columns
_PIECE_BYTES = 64 * WGMMA_K * 2    # a warpgroup's staged 64 x 128 share of a tile
_MBARRIER_BYTES = 8
# csrc/bsmm_grad.cu's spgemm_bsmm_wgrad: a, b, ia, ib, out; M, lda, ldb, P; k,
# dtype, body, form, bm, stages, group, shared_b, grid, stream_only, device;
# stream
ENTRY_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 11 \
    + [ctypes.c_void_p]


@dataclass(frozen=True)
class WgradLayout:
    """The wgmma body's shared memory, in bytes (csrc/bsmm_grad.cu:
    wg_smem_bytes, half_smem_bytes): `stages` stages of stage_bytes from 0,
    each swizzled boxes of bm rows x 128 bytes (box_bytes): in the tile
    form a-strip columns 0-63 and 64-127, then b-strip's; in the half form
    the run's G own half-strips, then the shared strip's two boxes.  Then
    the staged output (out_bytes: a 128 x 128 tile, or the half
    form's G 64 x 128 pieces), then barrier_bytes of mbarriers (a full and an
    empty one a stage).  `total` is what the launch asks for."""
    form: str
    bm: int
    box_bytes: int
    stage_bytes: int
    stages: int
    out_bytes: int
    barrier_bytes: int
    total: int


def wgrad_layout(bm: int, stages: int | None = None, form: str = "tile",
                 group: int = 1) -> WgradLayout:
    """The wgmma body's shared memory at bm rows a stage in `form` at runs
    of `group`.  stages=None takes the deepest ring of WGRAD_STAGES that
    fits a block's SMEM_BYTES (tile form: 6 at bm 64, 4 at 96, 3 at 128;
    half form at group 3: 4 at bm 64); a depth that does not fit, or a bm
    that is no positive multiple of 16 up to 256, raises ValueError."""
    if bm < 16 or bm > 256 or bm % 16:
        raise ValueError(f"the wgmma body takes bm a multiple of 16 in 16..256, not {bm}")
    if form not in _FORM_CODES:
        raise ValueError(f"the wgmma body's forms are {tuple(_FORM_CODES)}, not {form!r}")
    box = bm * _BOX_ROW_BYTES
    half = form == "half"
    stage = (group + 2 if half else 4) * box
    out = group * _PIECE_BYTES if half else WGMMA_K * WGMMA_K * 2

    def layout(s: int) -> WgradLayout:
        barriers = 2 * _MBARRIER_BYTES * s
        return WgradLayout(form, bm, box, stage, s, out, barriers, s * stage + out + barriers)

    fits = [layout(s) for s in WGRAD_STAGES if layout(s).total <= SMEM_BYTES]
    if stages is None:
        if not fits:
            raise ValueError(f"no ring of {WGRAD_STAGES} stages of {stage} bytes fits")
        return fits[-1]
    if stages not in WGRAD_STAGES or layout(stages).total > SMEM_BYTES:
        raise ValueError(f"the wgmma body takes a ring of {WGRAD_STAGES} stages within "
                         f"{SMEM_BYTES} bytes of shared memory; {stages} stages of "
                         f"{stage} bytes need {layout(stages).total}")
    return layout(stages)


def wgrad_body(dtype: torch.dtype, k: int, body: str | None = None, M: int = 1) -> str:
    """The body a launch runs: body=None takes "wgmma" for bf16 at k 128 and
    M >= 1 (the FFN's shapes), else "mma_sync"; a named body the shapes do
    not allow raises ValueError."""
    fits = dtype == torch.bfloat16 and k == WGMMA_K and M >= 1
    if body is None:
        return "wgmma" if fits else "mma_sync"
    if body not in WGRAD_BODIES:
        raise ValueError(f"kernel 5's bodies are {WGRAD_BODIES}, not {body!r}")
    if body == "wgmma" and not fits:
        raise ValueError(f"the wgmma body takes bf16 at k {WGMMA_K} and M >= 1, not {dtype} "
                         f"at k {k}, M {M}")
    return body


def wgrad_units(P: int, form: str = "tile", group: int = 1) -> int:
    """The units the wgmma body's blocks walk: the P tiles (tile form), or
    the 2 P / group halves of runs (half form), one block each."""
    return P if form == "tile" else 2 * (P // group)


def wgrad_grid(units: int, resident: int, persistent: bool = True) -> int:
    """The wgmma body's blocks: as many as the card holds at once
    (`resident`) and at most one a unit; persistent=False gives every unit
    its block."""
    return min(units, resident) if persistent else units


def wgrad_walk(block: int, grid: int, units: int) -> list[int]:
    """The units block `block` of a grid of `grid` computes, in order: block,
    block + grid, ...  A half-form unit u is run u // 2's half u % 2, so a
    run's two halves run side by side and share its strips in L2."""
    return list(range(block, units, grid))


def check_runs(ia: torch.Tensor, ib: torch.Tensor, run: int | None,
               shared: str | None) -> tuple[int, int]:
    """The run options: run G and shared "a" or "b" (both or neither), G
    dividing P.  Returns (G, 1 where b is shared else 0); (1, 1) without
    them.  On CPU tensors it also checks that every run of G consecutive
    pairs names one strip on the shared side (raising where not); on the
    card that is not checked, since a check would synchronise."""
    if (run is None) != (shared is None):
        raise ValueError("pass run and shared together, or neither")
    if run is None:
        return 1, 1
    if shared not in ("a", "b"):
        raise ValueError(f"shared must be 'a' or 'b', not {shared!r}")
    P = ia.shape[0]
    if run < 1 or P % run:
        raise ValueError(f"the run length {run} does not divide the {P} pairs")
    if ia.device.type == "cpu":
        check_run_side(ib if shared == "b" else ia, run, shared)
    return run, int(shared == "b")


def check_run_side(side: torch.Tensor, run: int, shared: str = "shared") -> None:
    """Raise ValueError unless every run of `run` consecutive entries of the
    shared side's strip list (a CPU tensor) names one strip."""
    runs = side.reshape(-1, run)
    if not bool((runs == runs[:, :1]).all()):
        raise ValueError(f"runs of {run} pairs do not each share one {shared}-strip")


def check_wgrad_operands(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor,
                         ib: torch.Tensor, k: int) -> tuple[int, int]:
    """Validate the operands; returns (M, P)."""
    if a.dim() != 2 or b.dim() != 2 or ia.dim() != 1 or ib.dim() != 1:
        raise ValueError(f"want a (M, nA*k), b (M, nB*k), ia (P,), ib (P,); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(ia.shape)}, "
                         f"{tuple(ib.shape)}")
    if a.shape[0] != b.shape[0] or ia.shape != ib.shape:
        raise ValueError(f"a and b must share M and ia and ib P: {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(ia.shape)}, {tuple(ib.shape)}")
    if k < 1 or a.shape[1] % k or b.shape[1] % k or not a.shape[1] or not b.shape[1]:
        raise ValueError(f"the widths {a.shape[1]} and {b.shape[1]} must be positive "
                         f"multiples of k={k}")
    if ia.dtype != torch.int32 or ib.dtype != torch.int32:
        raise TypeError(f"ia and ib must be int32, got {ia.dtype} and {ib.dtype}")
    if b.dtype != a.dtype:
        raise TypeError(f"b must have a's dtype {a.dtype}, got {b.dtype}")
    devices = {t.device for t in (a, b, ia, ib)}
    if len(devices) != 1:
        raise ValueError(f"operands lie on several devices: {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in (a, b, ia, ib)):
        raise ValueError("operands must be contiguous")
    return a.shape[0], ia.shape[0]


def bsmm_wgrad_ref(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                   *, k: int) -> torch.Tensor:
    """The plain PyTorch version of kernel 5, on any device: gather the two
    strips of every pair, take the products in float32 (a float32 matmul on
    the card is TF32 only if torch.backends.cuda.matmul.allow_tf32 is set),
    cast to a.dtype.  (P, k, k)."""
    M, _ = check_wgrad_operands(a, b, ia, ib, k)
    ga = a.reshape(M, a.shape[1] // k, k).float()[:, ia.long()]   # (M, P, k)
    gb = b.reshape(M, b.shape[1] // k, k).float()[:, ib.long()]
    return torch.einsum("mpi,mpj->pij", ga, gb).to(a.dtype)


def bsmm_wgrad(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
               *, k: int, run: int | None = None, shared: str | None = None) -> torch.Tensor:
    """Kernel 5: out (P, k, k) in a.dtype, out[p] = a[:, ia[p]*k : +k]^T .
    b[:, ib[p]*k : +k] over every row.  a (M, nA*k) and b (M, nB*k) in one
    dtype, ia and ib (P,) int32 below nA and nB (not checked on the card: a
    check would synchronise); any M.  run G and shared "a" or "b" say that
    each G consecutive pairs share one strip of that side (check_runs), so
    the wgmma body reads it once a run; without them any (ia, ib) list
    runs, one tile a block.  On CUDA tensors it launches the kernel on the
    current stream or raises; on CPU tensors it runs bsmm_wgrad_ref."""
    return _launch(a, b, ia, ib, k, run=run, shared=shared)


@functools.cache
def wgrad_resident(form: str, bm: int, stages: int, group: int, shared_b: int,
                   device: int) -> int:
    """How many blocks of the wgmma body's form CUDA device `device` holds
    at once: its SMs times cudaOccupancyMaxActiveBlocksPerMultiprocessor.
    Card only; raises where the runtime refuses or none fits."""
    fn = _build.load(_KERNEL).spgemm_bsmm_wgrad_occupancy
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(_FORM_CODES[form], bm, stages, group, shared_b, device, ctypes.byref(n))
    if err != 0 or n.value < 1:
        raise RuntimeError(f"the occupancy query of kernel 5's wgmma body failed or gave "
                           f"{n.value}: CUDA error {err} ({form} form, bm {bm}, stages "
                           f"{stages}, group {group})")
    return n.value * sm_count(device)


def launch_plan(M: int, P: int, k: int, dtype: torch.dtype, run: int = 1, *,
                body: str | None = None, form: str | None = None, bm: int | None = None,
                stages: int | None = None, persistent: bool = True, resident=None) -> dict:
    """What a launch of kernel 5 runs at these shapes: {"body", "grid"}, and
    for the wgmma body "form", "group", "bm", "stages" and "smem_bytes".
    run is the run length check_runs gave (1: none); form=None takes "half"
    for runs of WGRAD_GROUPS, else "tile"; the keywords are _launch's.
    resident(form, bm, stages, group) answers wgrad_resident's question
    (None: as many as there are units, so the grid is one unit a block)."""
    body = wgrad_body(dtype, k, body, M)
    if body != "wgmma":
        return {"body": body, "grid": P}
    if form is None:
        form = "half" if run in WGRAD_GROUPS else "tile"
    if form not in _FORM_CODES or (form == "half" and run not in WGRAD_GROUPS):
        raise ValueError(f"the wgmma body's forms are {tuple(_FORM_CODES)}; the half form "
                         f"takes runs of {WGRAD_GROUPS} pairs: not {form!r} at runs of {run}")
    group = run if form == "half" else 1
    bm = WGRAD_DEPTH[form] if bm is None else bm
    layout = wgrad_layout(bm, stages, form, group)
    units = wgrad_units(P, form, group)
    held = units if resident is None else resident(form, bm, layout.stages, group)
    return {"body": body, "form": form, "group": group, "bm": bm, "stages": layout.stages,
            "grid": wgrad_grid(units, held, persistent), "smem_bytes": layout.total}


def strip_bytes(M: int, P: int, k: int, form: str = "tile", group: int = 1,
                dtype_bytes: int = 2) -> int:
    """Bytes of strips a launch streams into shared memory: both strips of
    every tile (tile form, 2 P strips of M x k), or each run of `group` tiles
    its own strips whole and the shared one once a half (half form, (P /
    group) (group + 2))."""
    strips = 2 * P if form == "tile" else (P // group) * (group + 2)
    return M * k * dtype_bytes * strips


def _launch(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor, k: int, *,
            run: int | None = None, shared: str | None = None, stream_only: bool = False,
            **kw) -> torch.Tensor:
    """Launch kernel 5.  The keywords (launch_plan's) override the defaults:
    body "wgmma" or "mma_sync"; for the wgmma body, form "tile" or "half"
    (which needs the run options), bm the rows a stage holds, stages the
    ring depth, persistent=False a block for every unit in place of the
    persistent grid.  stream_only skips the
    products (a diagnostic of the strip stream: the output is then zero).
    The checks that no bit depends on these give them."""
    M, P = check_wgrad_operands(a, b, ia, ib, k)
    G, shared_b = check_runs(ia, ib, run, shared)
    if a.device.type == "cpu":
        return bsmm_wgrad_ref(a, b, ia, ib, k=k)
    if a.device.type != "cuda":
        raise ValueError(f"no bsmm_wgrad for device {a.device}")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"the kernel takes float32 or bfloat16, got {a.dtype}")
    if k not in KERNEL_KS:
        raise ValueError(f"the kernel takes k in {KERNEL_KS}, got k={k}")
    if any(t.data_ptr() % 16 for t in (a, b)):
        raise ValueError("a and b must start on a 16-byte boundary")
    dev = a.device.index
    plan = launch_plan(M, P, k, a.dtype, G, resident=lambda form, bm, s, g: wgrad_resident(
        form, bm, s, g, shared_b, dev), **kw)
    out = torch.empty((P, k, k), dtype=a.dtype, device=a.device)
    if P == 0:
        return out
    fn = _build.load(_KERNEL).spgemm_bsmm_wgrad
    fn.argtypes = ENTRY_ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = fn(a.data_ptr(), b.data_ptr(), ia.data_ptr(), ib.data_ptr(), out.data_ptr(), M,
             a.shape[1], b.shape[1], P, k, _DTYPE_CODES[a.dtype], _BODY_CODES[plan["body"]],
             _FORM_CODES[plan.get("form", "tile")], plan.get("bm", 0), plan.get("stages", 0),
             plan.get("group", 1), shared_b, plan["grid"], int(stream_only), dev, stream)
    if err != 0:
        what = (f"a tensor map could not be encoded: CUresult {err - _ERR_ENCODE}"
                if err >= _ERR_ENCODE else f"CUDA error {err}")
        raise RuntimeError(f"bsmm_wgrad kernel launch failed: {what} (M={M}, a "
                           f"{tuple(a.shape)}, b {tuple(b.shape)}, P={P}, k={k}, {a.dtype}, "
                           f"{plan})")
    ENGINE.incr("launches_bsmm_wgrad")  # the launch counter, bumped here and nowhere else
    return out
