"""Kernels 3 and 4 (csrc/bsmm.cu) of this tree against an earlier tree's, on
the card: the same bits at the forward's epilogues (none, gelu) on the
block-sparse FFN's full-width matmuls (BlockSparseFFNConfig(), x (8192,
4096) bf16; matmul 1 on kernel 3 at block_m 128 and on kernel 4 at block_m
16, matmul 2 on kernel 3) and on a float32 case, then each timed in turns
(parent, this tree, this tree, parent; CUDA events, the L2 cache overwritten
before each launch), medians of the runs.

    python tools/bsmm_bits_ab.py --parent DIR [--repeats N]

DIR holds an earlier checkout's spgemm_tpu_torch/csrc/bsmm.cu whose entries
take no `pre` and a `fuse_gelu` flag: spgemm_bsmm(x, rows, tiles, out, M,
d_in, nbc, rpc, k, br, dtype, fuse_gelu, device, stream) and
spgemm_bsmm_resident(x, rows, tiles, out, M, d_in, nbc, rpc, k, br,
col_chunk, stages, cluster, stream_only, dtype, fuse_gelu, device, stream),
e.g. `git archive <commit> spgemm_tpu_torch/csrc/bsmm.cu | tar -x -C
build/parent`.  It is built with nvcc into build/bsmm_bits_ab/ and launched
on this tree's launch_geometry.  Prints the card's nvidia-smi line, then one
JSON line; exits 1 where any bits differ.  Needs an NVIDIA GPU; imports no
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from spgemm_tpu_torch.models import ffn  # noqa: E402
from spgemm_tpu_torch.ops import _build, cuda_bsmm  # noqa: E402

SEED = 20260
L2_BYTES = 50 << 20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _parent_lib(parent: Path) -> ctypes.CDLL:
    src = parent / "spgemm_tpu_torch" / "csrc" / "bsmm.cu"
    out = REPO / "build" / "bsmm_bits_ab" / "libbsmm_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.spgemm_bsmm.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.spgemm_bsmm_resident.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.spgemm_bsmm.restype = lib.spgemm_bsmm_resident.restype = ctypes.c_int
    return lib


def _parent(lib, x, rows, tiles, block_m: int, fuse_gelu: bool, resident: bool):
    """The parent's kernel 3 or 4 on this tree's grid for the same call."""
    M, d_in = x.shape
    nbc, rpc, k, _ = tiles.shape
    geo = cuda_bsmm.launch_geometry(M, nbc, block_m, resident,
                                    cuda_bsmm.sm_count(x.device.index))
    out = torch.empty((M, nbc * k), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    head = (x.data_ptr(), rows.data_ptr(), tiles.data_ptr(), out.data_ptr(), M, d_in, nbc,
            rpc, k, geo.br)
    tail = (_DTYPES[x.dtype], int(fuse_gelu), x.device.index, stream)
    if resident:
        layout = cuda_bsmm.resident_layout(d_in, block_m, x.element_size(), k)
        err = lib.spgemm_bsmm_resident(*head, geo.col_chunk, layout.stages,
                                       cuda_bsmm.cluster_size(geo.panels, k), 0, *tail)
    else:
        err = lib.spgemm_bsmm(*head, *tail)
    if err:
        raise RuntimeError(f"the parent's launch failed: {err}")
    return out


def _time(fn, flush: torch.Tensor) -> float:
    flush.zero_()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = _parent_lib(args.parent)
    dev = torch.device("cuda")
    cfg = ffn.BlockSparseFFNConfig()
    gen = torch.Generator().manual_seed(SEED)
    params = ffn.init_params(cfg, gen, device=dev)
    pp = ffn.prepare_kernel_params(params, cfg)
    x = torch.randn((8192, cfg.d_model), generator=gen).to(dev, torch.bfloat16)
    h = cuda_bsmm.gelu(cuda_bsmm.bsmm(x, pp["w1"]["rows"], pp["w1"]["tiles"]))
    small = ffn.BlockSparseFFNConfig(d_model=1024, d_ff=2048, k=64, block_density=0.2,
                                     dtype="float32")
    sp = ffn.init_params(small, gen, device=dev)
    xs = torch.randn((256, small.d_model), generator=gen).to(dev)
    w1, w2, s1 = pp["w1"], pp["w2cm"], sp["w1"]
    cases = {  # name: (x, rows, tiles, block_m, fuse_gelu, resident)
        "k3_mm1": (x, w1["rows"], w1["tiles"], 128, False, False),
        "k3_mm1_gelu": (x, w1["rows"], w1["tiles"], 128, True, False),
        "k4_mm1": (x, w1["rows"], w1["tiles"], 16, False, True),
        "k4_mm1_gelu": (x, w1["rows"], w1["tiles"], 16, True, True),
        "k3_mm2": (h, w2["rows"], w2["tiles"], 128, False, False),
        "k3_f32": (xs, s1["rows"], s1["tiles"], 16, True, False),
        "k4_f32": (xs, s1["rows"], s1["tiles"], 16, True, True),
    }
    equal = {}
    for name, (xin, rows, tiles, bm, gelu, res) in cases.items():
        mine = cuda_bsmm._launch(xin, rows, tiles, bm, gelu, res)
        theirs = _parent(lib, xin, rows, tiles, bm, gelu, res)
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(mine, theirs))
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device=dev)
    runs = {f"{who}_{name}": [] for who in ("parent", "tree")
            for name in ("k3_mm1", "k4_mm1", "k3_mm2")}
    for _ in range(args.repeats):
        for order in (("parent", "tree"), ("tree", "parent")):
            for who in order:
                for name in ("k3_mm1", "k4_mm1", "k3_mm2"):
                    xin, rows, tiles, bm, gelu, res = cases[name]
                    fn = (lambda: _parent(lib, xin, rows, tiles, bm, gelu, res)) \
                        if who == "parent" else \
                        (lambda: cuda_bsmm._launch(xin, rows, tiles, bm, gelu, res))
                    fn()
                    runs[f"{who}_{name}"].append(_time(fn, flush))
    median = {name: sorted(r)[len(r) // 2] for name, r in runs.items()}
    print(json.dumps({"equal": equal, "median_ms": median, "runs_ms": runs}))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
