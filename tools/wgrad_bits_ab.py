"""Kernel 5 (csrc/bsmm_grad.cu) of this tree against an earlier tree's, on
the card: bits first, then times in turns.

Bits: the training step's two weight gradients of the block-sparse FFN at
full width (BlockSparseFFNConfig(), M 8192, bf16, k 128): dW1 (x against
dpre, runs of rpc pairs sharing the dpre strip) and dW2 (h against dy,
runs of cpc sharing the h strip), each with the run options and without
them; the same at M 256 and at M 8192 - 40 (a ragged last chunk); on
operands whose exponents spread over 2^-40..2^40, so each 16-deep step adds
terms of very different sizes; and float32 and k 64 cases (the mma.sync
body).  Each against the parent's kernel 5 on the same inputs, and this
tree's mma.sync body (body="mma_sync") against it too.  --variants holds
every wgmma variant (form: one tile a block, a block over half a run; ring
depth, rows a stage, the grid) to the default's bits and times it, and each
form's strip stream alone (stream_only).

Times: dW1 and dW2 at full width in rounds: each round launches the
parent, this tree in each form (one tile a block, a block over half a run)
and each one's strip stream alone (stream_only;
the parent's body's is this tree's mma.sync body), the order reversed every
other round (CUDA events; before each launch 400 MB are zeroed, which
overwrites the L2 cache and outlasts the launch's host work); medians of
--repeats rounds.  --variants times its variants in rounds the same way.

    python tools/wgrad_bits_ab.py --parent DIR [--repeats N] [--check-only]
                                  [--variants] [--step]

--step also times the full-width training step (block_m 128 and 16) in
rounds with its weight gradients on the parent's kernel 5 and on this
tree's, all else equal.

DIR holds an earlier checkout's spgemm_tpu_torch/csrc/bsmm_grad.cu (and
hopper.cuh, where that source includes it), e.g. `mkdir -p build/parent;
git archive eac909a spgemm_tpu_torch/csrc/bsmm_grad.cu | tar -x -C
build/parent`; its entry is eac909a's spgemm_bsmm_wgrad(a, b, ia, ib, out,
M, lda, ldb, P, k, dtype, device, stream) or this tree's.  It is built with
nvcc into build/wgrad_bits_ab/.  Prints the card's nvidia-smi line, kernel
5's ptxas figures, then one JSON line; exits 1 where any bits differ.
Needs an NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from spgemm_tpu_torch.models import ffn  # noqa: E402
from spgemm_tpu_torch.obs import profile  # noqa: E402
from spgemm_tpu_torch.ops import _build  # noqa: E402
from spgemm_tpu_torch.ops import cuda_bsmm_grad as k5  # noqa: E402
from spgemm_tpu_torch.parallel.mesh import train_mesh  # noqa: E402

SEED = 20261
L2_BYTES = 50 << 20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _parent_lib(parent: Path) -> ctypes.CDLL:
    src = parent / "spgemm_tpu_torch" / "csrc" / "bsmm_grad.cu"
    out = REPO / "build" / "wgrad_bits_ab" / "libbsmm_grad_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.bodies = "int body" in " ".join(src.read_text().split())
    lib.spgemm_bsmm_wgrad.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 \
        + [ctypes.c_int] * (10 if lib.bodies else 3) + [ctypes.c_void_p]
    lib.spgemm_bsmm_wgrad.restype = ctypes.c_int
    return lib


def _parent(lib, a, b, ia, ib, k: int, **_):
    """The parent's kernel 5 on the same call (its default body)."""
    M, P = a.shape[0], ia.shape[0]
    out = torch.empty((P, k, k), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    head = (a.data_ptr(), b.data_ptr(), ia.data_ptr(), ib.data_ptr(), out.data_ptr(), M,
            a.shape[1], b.shape[1], P, k, _DTYPES[a.dtype])
    if lib.bodies:  # this tree's form: the mma.sync body, one tile a block
        err = lib.spgemm_bsmm_wgrad(*head, 0, 0, 0, 1, 1, P, 0, a.device.index, stream)
    else:
        err = lib.spgemm_bsmm_wgrad(*head, a.device.index, stream)
    if err:
        raise RuntimeError(f"the parent's launch failed: {err}")
    return out


def _tree(a, b, ia, ib, k: int, run=None, shared=None, **kw):
    return k5._launch(a, b, ia, ib, k, run=run, shared=shared, **kw)


def _time(fn, flush: torch.Tensor) -> float:
    flush.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _median(runs: list) -> float:
    return sorted(runs)[len(runs) // 2]


def ptxas() -> dict:
    """Registers and spill bytes of this tree's kernel 5: the wgmma body and
    the mma.sync body's bf16 instance at k 128."""
    log = _build.build("bsmm_grad").with_suffix(".log").read_text()
    out = {}
    for entry, stats in profile.parse_ptxas(log).items():
        name = ("wgmma" if re.search(r"bsmm_wgrad_wg_kernel", entry) else
                "mma_sync" if re.search(r"bsmm_wgrad_kernelI13__nv_bfloat16Li128E", entry)
                else None)
        if name:
            out[name] = {key: stats[key] for key in ("registers", "spill_stores", "spill_loads")}
    return out


def variants(run: int) -> dict:
    """name -> _launch keywords of this tree's wgmma body for a call with runs
    of `run`: each form (one tile a block; a block over half a run) at each
    of bm 16, 32, 48, 64, 96 and 128 and each ring depth that fits there,
    each form with a block a unit, and each form's default with stream_only
    (the strip stream alone)."""
    out = {}
    for form in ("tile", "half"):
        group = 1 if form == "tile" else run
        if form == "half" and run not in k5.WGRAD_GROUPS:
            continue
        for bm in (16, 32, 48, 64, 96, 128):
            try:
                depth = k5.wgrad_layout(bm, None, form, group).stages
            except ValueError:  # not even 2 stages fit
                continue
            for s in range(2, depth + 1):
                out[f"{form}_bm{bm}_s{s}"] = {"form": form, "bm": bm, "stages": s}
        out[f"{form}_per_unit"] = {"form": form, "persistent": False}
        out[f"{form}_stream"] = {"form": form, "stream_only": True}
    return out


def spread(t: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """t with each entry scaled by 2^e, e uniform in -40..40."""
    e = torch.randint(-40, 41, t.shape, generator=gen).float().to(t.device)
    return (t.float() * torch.exp2(e)).to(t.dtype)


def cases(dev: torch.device, gen: torch.Generator) -> dict:
    """name -> (a, b, ia, ib, k, run, shared): the full-width dW1 and dW2 with
    and without their run options, at M 256, with a ragged last chunk, on
    spread exponents, and the float32 and k 64 cases."""
    cfg = ffn.BlockSparseFFNConfig()
    params = ffn.init_params(cfg, gen, device=dev)
    index = ffn.step_index(params["w1"]["rows"], params["w2"]["cols"], cfg.nb_model)
    M = 8192
    x = torch.randn((M, cfg.d_model), generator=gen).to(dev, torch.bfloat16)
    dpre = (torch.randn((M, cfg.d_ff), generator=gen) / 64).to(dev, torch.bfloat16)
    h = torch.randn((M, cfg.d_ff), generator=gen).to(dev, torch.bfloat16)
    dy = (torch.randn((M, cfg.d_model), generator=gen) / 64).to(dev, torch.bfloat16)
    k = cfg.k
    dw1 = (index.ia1, index.ib1, k, index.run1, index.shared1)
    dw2 = (index.ia2, index.ib2, k, index.run2, index.shared2)
    out = {
        "dw1": (x, dpre, *dw1), "dw2": (h, dy, *dw2),
        "dw1_no_runs": (x, dpre, *dw1[:3], None, None),
        "dw2_no_runs": (h, dy, *dw2[:3], None, None),
        "dw1_m256": (x[:256], dpre[:256], *dw1), "dw2_m256": (h[:256], dy[:256], *dw2),
        "dw1_ragged": (x[:M - 40], dpre[:M - 40], *dw1),
        "dw2_ragged": (h[:M - 40], dy[:M - 40], *dw2),
        "dw1_spread": (spread(x, gen), spread(dpre, gen), *dw1),
        "dw2_spread": (spread(h, gen), spread(dy, gen), *dw2),
    }
    # the mma.sync body's shapes: float32 at k 128, bf16 and float32 at k 64
    small = ffn.BlockSparseFFNConfig(d_model=1024, d_ff=2048, k=64, block_density=0.2)
    sp = ffn.init_params(small, gen, device=dev)
    si = ffn.step_index(sp["w1"]["rows"], sp["w2"]["cols"], small.nb_model)
    xs = torch.randn((512, small.d_model), generator=gen).to(dev)
    ds = torch.randn((512, small.d_ff), generator=gen).to(dev)
    out["dw1_k64_f32"] = (xs, ds, si.ia1, si.ib1, 64, si.run1, si.shared1)
    out["dw1_k64_bf16"] = (xs.bfloat16(), ds.bfloat16(), si.ia1, si.ib1, 64, si.run1,
                           si.shared1)
    out["dw1_k128_f32"] = (x[:512].float(), dpre[:512].float(), *dw1)
    return out


def step_times(lib, dev: torch.device, gen: torch.Generator, flush: torch.Tensor,
               repeats: int) -> dict:
    """The full-width FFN training step (x (8, 1024, 4096) bf16, block_m 128
    and 16) timed in rounds with its two weight gradients on the parent's
    kernel 5 and on this tree's, everything else the same: median ms of each
    and the runs."""
    cfg = ffn.BlockSparseFFNConfig()
    params = ffn.init_params(cfg, gen, device=dev)
    x = torch.randn((8, 1024, cfg.d_model), generator=gen).to(dev, torch.bfloat16)
    target = torch.randn((8, 1024, cfg.d_model), generator=gen).to(dev, torch.bfloat16)
    mesh = train_mesh(device=dev)
    steps = {bm: ffn.make_sharded_train_step(mesh, cfg, lr=1e-3, block_m=bm) for bm in (128, 16)}
    tree = ffn.bsmm_wgrad

    def parent(a, b, ia, ib, *, k, run=None, shared=None):
        return _parent(lib, a, b, ia, ib, k)

    runs = {f"{who}_{bm}": [] for who in ("parent", "tree") for bm in (128, 16)}
    try:
        for i in range(repeats):
            for who in (("parent", "tree") if i % 2 == 0 else ("tree", "parent")):
                ffn.bsmm_wgrad = parent if who == "parent" else tree
                for bm, step in steps.items():
                    step(params, x, target)
                    runs[f"{who}_{bm}"].append(_time(lambda: step(params, x, target), flush))
    finally:
        ffn.bsmm_wgrad = tree
    return {"median_ms": {name: _median(r) for name, r in runs.items()}, "runs_ms": runs}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--step", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = _parent_lib(args.parent)
    print(f"kernel 5 ptxas: {ptxas()}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    calls = cases(dev, gen)
    equal, mine, plans = {}, {}, {}
    for name, (a, b, ia, ib, k, run, shared) in calls.items():
        mine[name] = _tree(a, b, ia, ib, k, run, shared)
        theirs = _parent(lib, a, b, ia, ib, k)
        old = _tree(a, b, ia, ib, k, body="mma_sync")
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(mine[name], theirs))
        equal[f"{name}_mma_sync"] = bool(torch.equal(old, theirs))
        plans[name] = k5.launch_plan(
            a.shape[0], ia.shape[0], k, a.dtype, run or 1,
            resident=lambda f, bm, s, g, sb=int(shared == "b"): k5.wgrad_resident(
                f, bm, s, g, sb, 0))
        if not equal[name]:
            diff = (mine[name].float() - theirs.float()).abs()
            print(f"{name}: {int((mine[name] != theirs).sum())} entries differ, max "
                  f"{float(diff.max())}", flush=True)
    print(json.dumps({"equal": equal, "plans": plans}), flush=True)
    if args.check_only:
        return 0 if all(equal.values()) else 1
    # 8 x L2: zeroing it takes longer than a launch's host work, so no idle
    # gap before the kernel falls inside the timed window
    flush = torch.empty(8 * L2_BYTES // 4, dtype=torch.float32, device=dev)
    timed = {"parent": {}, "stream_parent": {"body": "mma_sync", "stream_only": True}}
    for form in ("tile", "half"):
        timed[form] = {"form": form}
        timed[f"stream_{form}"] = {"form": form, "stream_only": True}
    runs = {f"{who}_{name}": [] for who in timed for name in ("dw1", "dw2")}
    order = list(timed)
    for i in range(args.repeats):  # every launch once a round, the order reversed every other
        for who in (order if i % 2 == 0 else order[::-1]):
            for name in ("dw1", "dw2"):
                a, b, ia, ib, k, run, shared = calls[name]
                fn = (lambda: _parent(lib, a, b, ia, ib, k)) if who == "parent" else \
                    (lambda kw=timed[who]: _tree(a, b, ia, ib, k, run, shared, **kw))
                fn()
                runs[f"{who}_{name}"].append(_time(fn, flush))
    result = {"equal": equal, "median_ms": {name: _median(r) for name, r in runs.items()},
              "runs_ms": runs}
    if args.variants:
        found = {}
        jobs = [(name, tag, kw) for name in ("dw1", "dw2")
                for tag, kw in variants(calls[name][5]).items()]
        for name, tag, kw in jobs:
            a, b, ia, ib, k, run, shared = calls[name]
            got = _tree(a, b, ia, ib, k, run, shared, **kw)
            torch.cuda.synchronize()
            found[f"{name}_{tag}"] = {"kw": kw, "runs_ms": []}
            if not kw.get("stream_only") and not torch.equal(got, mine[name]):
                equal[f"{name}_{tag}"] = False
                found[f"{name}_{tag}"]["differing"] = int((got != mine[name]).sum())
        for i in range(args.repeats):  # in rounds, as above
            for name, tag, kw in (jobs if i % 2 == 0 else jobs[::-1]):
                a, b, ia, ib, k, run, shared = calls[name]
                found[f"{name}_{tag}"]["runs_ms"].append(
                    _time(lambda: _tree(a, b, ia, ib, k, run, shared, **kw), flush))
        for v in found.values():
            v["median_ms"] = _median(v["runs_ms"])
        result["variants"] = found
    if args.step:
        result["step_ms"] = step_times(lib, dev, gen, flush, args.repeats)
    print(json.dumps(result))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
