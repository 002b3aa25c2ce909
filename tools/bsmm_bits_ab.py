"""Kernels 3 and 4 (csrc/bsmm.cu) of this tree against an earlier tree's, on
the card: the same bits at every epilogue on the block-sparse FFN's
full-width matmuls (BlockSparseFFNConfig(), x (8192, 4096) bf16; matmul 1
plain and with gelu on kernel 3 at block_m 128 and on kernel 4 at block_m
16, matmul 2 on kernel 3, the training step's dgrad with the gelu_grad
epilogue on kernel 3 at block_m 128 and on kernel 4 at block_m 16), at M
256, on x and tiles with exponents spread over 2^-24..2^24, and on float32
cases; this tree's kernel 4 against its kernel 3; then each full-width call
timed in turns (parent, this tree, this tree, parent; CUDA events, the L2
cache overwritten before each launch), medians of the runs.

    python tools/bsmm_bits_ab.py --parent DIR [--repeats N] [--check-only]
                                 [--variants]

DIR holds an earlier checkout's spgemm_tpu_torch/csrc/bsmm.cu whose entries
take `pre` and an `epilogue` (0 none, 1 gelu, 2 gelu_grad):
spgemm_bsmm(x, rows, tiles, out, pre, M, d_in, nbc, rpc, k, br, dtype,
epilogue, device, stream) and spgemm_bsmm_resident(x, rows, tiles, out, pre,
M, d_in, nbc, rpc, k, br, col_chunk, stages, cluster, stream_only, dtype,
epilogue, device, stream), as at commit ac9528f; or kernel 3's entry with
warp_m, stages, grid and stream_only after br, and
spgemm_bsmm_blocks_per_sm, as in this tree.  E.g. `git archive <commit>
spgemm_tpu_torch/csrc/bsmm.cu | tar -x -C build/parent`, with
spgemm_tpu_torch/csrc/hopper.cuh too where that bsmm.cu includes it.  It is built with
nvcc into build/bsmm_bits_ab/ and launched at this tree's row tile
(launch_geometry), and in the second form also at this tree's consumer
tile, ring depth and persistent grid.  --check-only stops after the bits;
--variants also times this tree's kernel 3 at row tiles 128, 64 and 32,
forced to each consumer tile and ring depth, one block an item and the pair
stream alone, each held to the default's bits.  Prints the card's
nvidia-smi line, kernel 3's ptxas figures, then one JSON line; exits 1
where any bits differ.  Needs an NVIDIA GPU; imports no JAX.
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
from spgemm_tpu_torch.ops import _build, cuda_bsmm  # noqa: E402

SEED = 20260
L2_BYTES = 50 << 20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TIMED = ("k3_mm1", "k3_mm2", "k3_dgrad", "k4_mm1", "k4_dgrad")


# kernel 3's entry as this tree has it: four more ints after br
_STREAM_ENTRY = "int br, int warp_m, int stages, int grid, int stream_only"


def _parent_lib(parent: Path) -> ctypes.CDLL:
    src = parent / "spgemm_tpu_torch" / "csrc" / "bsmm.cu"
    out = REPO / "build" / "bsmm_bits_ab" / "libbsmm_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.stream_entry = _STREAM_ENTRY in " ".join(src.read_text().split())
    lib.spgemm_bsmm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
        + [ctypes.c_int] * (12 if lib.stream_entry else 8) + [ctypes.c_void_p]
    if lib.stream_entry:
        lib.spgemm_bsmm_blocks_per_sm.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
    lib.spgemm_bsmm_resident.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.spgemm_bsmm.restype = lib.spgemm_bsmm_resident.restype = ctypes.c_int
    return lib


def _epilogue(fuse_gelu: bool, pre) -> int:
    return 1 if fuse_gelu else 2 if pre is not None else 0


def _parent(lib, x, rows, tiles, block_m: int, fuse_gelu: bool, pre, resident: bool):
    """The parent's kernel 3 or 4 at this tree's row tile for the same call."""
    M, d_in = x.shape
    nbc, rpc, k, _ = tiles.shape
    geo = cuda_bsmm.launch_geometry(M, nbc, block_m, resident,
                                    cuda_bsmm.sm_count(x.device.index))
    out = torch.empty((M, nbc * k), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), rows.data_ptr(), tiles.data_ptr(), out.data_ptr(),
            None if pre is None else pre.data_ptr(), M, d_in, nbc, rpc, k, geo.br)
    tail = (_DTYPES[x.dtype], _epilogue(fuse_gelu, pre), x.device.index, stream)
    if resident:
        layout = cuda_bsmm.resident_layout(d_in, block_m, x.element_size(), k)
        err = lib.spgemm_bsmm_resident(*head, geo.col_chunk, layout.stages,
                                       cuda_bsmm.cluster_size(geo.panels, k), 0, *tail)
    elif lib.stream_entry:  # this tree's consumer tile, ring and persistent grid
        es, dtype, epilogue = x.element_size(), _DTYPES[x.dtype], _epilogue(fuse_gelu, pre)
        layout = cuda_bsmm.stream_layout(geo.br, k, es)
        rows_per_warp = cuda_bsmm.warp_rows(geo.br, k, es)
        per_sm = ctypes.c_int(0)
        lib.spgemm_bsmm_blocks_per_sm(k, geo.br, rows_per_warp, layout.stages, dtype, epilogue,
                                      x.device.index, ctypes.byref(per_sm))
        grid = cuda_bsmm.stream_grid(geo.panels * nbc, cuda_bsmm.sm_count(x.device.index),
                                     per_sm.value)
        err = lib.spgemm_bsmm(*head, rows_per_warp, layout.stages, grid, 0, *tail)
    else:
        err = lib.spgemm_bsmm(*head, *tail)
    if err:
        raise RuntimeError(f"the parent's launch failed: {err}")
    return out


def _tree(x, rows, tiles, block_m: int, fuse_gelu: bool, pre, resident: bool, **kw):
    return cuda_bsmm._launch(x, rows, tiles, block_m, fuse_gelu, resident, gelu_grad=pre, **kw)


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


def _ptxas() -> dict:
    """Registers and spill bytes of this tree's kernel 3 instances at bf16, k
    128 (mma.sync warps of MT x 16 rows and NT n-tiles, or wgmma's
    warpgroups; the gelu_grad instance or not)."""
    log = _build.build("bsmm").with_suffix(".log").read_text()
    out = {}
    for entry, stats in profile.parse_ptxas(log).items():
        m = re.search(r"bsmm_kernelI13__nv_bfloat16Li128ELi(\d)ELi(\d+)ELb([01])ELb([01])E",
                      entry)
        if m:
            name = "wgmma" if m.group(4) == "1" else f"mt{m.group(1)} nt{m.group(2)}"
            out[name + (" gelu_grad" if m.group(3) == "1" else "")] = {
                key: stats[key] for key in ("registers", "spill_stores", "spill_loads")}
    return out


def _variants(x, tiles) -> dict:
    """name -> _launch keywords of this tree's kernel 3 for one call: row
    tiles 128, 64 and 32, each consumer tile (warp_row_options) and ring
    depth the launch takes there, one block an item, the pair stream alone with the epilogue
    (stream_only 1) and without it (2)."""
    M, k, es = x.shape[0], tiles.shape[-1], x.element_size()
    out = {}
    for br in (128, 64, 32):
        if M % br:
            continue
        for rows_per_warp in cuda_bsmm.warp_row_options(br, k, es):
            for s in range(1, cuda_bsmm.stream_layout(br, k, es).stages + 1):
                out[f"br{br}_w{rows_per_warp}_s{s}"] = {"br": br, "warp_m": rows_per_warp,
                                                        "stages": s}
        out[f"br{br}_per_item"] = {"br": br, "persistent": False}
        out[f"br{br}_stream1"] = {"br": br, "stream_only": 1}
        out[f"br{br}_stream2"] = {"br": br, "stream_only": 2}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = _parent_lib(args.parent)
    print(f"kernel 3 ptxas (bf16, k 128): {_ptxas()}", flush=True)
    dev = torch.device("cuda")
    cfg = ffn.BlockSparseFFNConfig()
    gen = torch.Generator().manual_seed(SEED)
    params = ffn.init_params(cfg, gen, device=dev)
    pp = ffn.prepare_kernel_params(params, cfg)
    x = torch.randn((8192, cfg.d_model), generator=gen).to(dev, torch.bfloat16)
    pre = cuda_bsmm.bsmm(x, pp["w1"]["rows"], pp["w1"]["tiles"])
    h = cuda_bsmm.gelu(pre)
    dy = (torch.randn((8192, cfg.d_model), generator=gen) / 64).to(dev, torch.bfloat16)
    w2t = params["w2"]["tiles"].transpose(-1, -2).contiguous()
    small = ffn.BlockSparseFFNConfig(d_model=1024, d_ff=2048, k=64, block_density=0.2,
                                     dtype="float32")
    sp = ffn.init_params(small, gen, device=dev)
    xs = torch.randn((256, small.d_model), generator=gen).to(dev)
    pre_s = cuda_bsmm.bsmm(xs, sp["w1"]["rows"], sp["w1"]["tiles"])
    dys = torch.randn((256, small.d_model), generator=gen).to(dev)
    w2ts = sp["w2"]["tiles"].transpose(-1, -2).contiguous()
    w1, w2, s1 = pp["w1"], pp["w2cm"], sp["w1"]
    mm1, mm2 = (x, w1["rows"], w1["tiles"]), (h, w2["rows"], w2["tiles"])
    # exponents spread over 2^-24..2^24 in x and the tiles, so each 16-deep
    # step adds terms of very different sizes: where kernel 3's wgmma summed
    # otherwise than mma.sync, these bits would show it
    x_sp, w1_sp, w2_sp = (
        (t.float() * torch.exp2(torch.randint(-24, 25, t.shape, generator=gen).float()).to(dev))
        .to(torch.bfloat16) for t in (x, w1["tiles"], w2["tiles"]))
    dgrad = (dy, params["w2"]["cols"], w2t)
    cases = {  # name: (x, rows, tiles, block_m, fuse_gelu, pre, resident)
        "k3_mm1": (*mm1, 128, False, None, False),
        "k3_mm1_gelu": (*mm1, 128, True, None, False),
        "k4_mm1": (*mm1, 16, False, None, True),
        "k4_mm1_gelu": (*mm1, 16, True, None, True),
        "k3_mm2": (*mm2, 128, False, None, False),
        "k3_dgrad": (*dgrad, 128, False, pre, False),
        "k4_dgrad": (*dgrad, 16, False, pre, True),
        "k3_mm1_m256": (x[:256], w1["rows"], w1["tiles"], 16, False, None, False),
        "k3_mm2_m256": (h[:256], w2["rows"], w2["tiles"], 16, False, None, False),
        "k3_dgrad_m256": (dy[:256], params["w2"]["cols"], w2t, 16, False, pre[:256], False),
        "k3_mm1_spread": (x_sp, w1["rows"], w1_sp, 128, False, None, False),
        "k3_mm2_spread": (h, w2["rows"], w2_sp, 128, False, None, False),
        "k3_f32": (xs, s1["rows"], s1["tiles"], 16, True, None, False),
        "k4_f32": (xs, s1["rows"], s1["tiles"], 16, True, None, True),
        "k3_f32_dgrad": (dys, sp["w2"]["cols"], w2ts, 16, False, pre_s, False),
    }
    equal, mine = {}, {}
    for name, case in cases.items():
        mine[name] = _tree(*case)
        theirs = _parent(lib, *case)
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(mine[name], theirs))
    for k4, k3 in (("k4_mm1", "k3_mm1"), ("k4_mm1_gelu", "k3_mm1_gelu"),
                   ("k4_dgrad", "k3_dgrad"), ("k4_f32", "k3_f32")):
        equal[f"{k4}=={k3}"] = bool(torch.equal(mine[k4], mine[k3]))
    print(json.dumps({"equal": equal}), flush=True)
    if args.check_only:
        return 0 if all(equal.values()) else 1
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device=dev)
    runs = {f"{who}_{name}": [] for who in ("parent", "tree") for name in TIMED}
    for _ in range(args.repeats):
        for order in (("parent", "tree"), ("tree", "parent")):
            for who in order:
                for name in TIMED:
                    case = cases[name]
                    fn = (lambda: _parent(lib, *case)) if who == "parent" else \
                        (lambda: _tree(*case))
                    fn()
                    runs[f"{who}_{name}"].append(_time(fn, flush))
    result = {"equal": equal, "median_ms": {name: _median(r) for name, r in runs.items()},
              "runs_ms": runs}
    if args.variants:
        variants = {}
        for name in ("k3_mm1", "k3_mm2", "k3_dgrad"):
            case = cases[name]
            for tag, kw in _variants(case[0], case[2]).items():
                got = _tree(*case, **kw)
                torch.cuda.synchronize()
                record = {"kw": kw}
                if not kw.get("stream_only") and not torch.equal(got, mine[name]):
                    equal[f"{name}_{tag}"] = False
                    diff = (got.float() - mine[name].float()).abs()
                    record["differing"] = int((got != mine[name]).sum())
                    record["max_abs_diff"] = float(diff.max())
                timed = [_time(lambda: _tree(*case, **kw), flush) for _ in range(args.repeats)]
                variants[f"{name}_{tag}"] = {**record, "median_ms": _median(timed),
                                             "runs_ms": timed}
        result["variants"] = variants
    print(json.dumps(result))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
