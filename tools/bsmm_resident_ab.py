"""Kernel 4 (csrc/bsmm.cu's bsmm_resident) on the card: every ring depth and
cluster it takes, held bit for bit against kernel 3 and within one bf16 ulp
of bsmm_ref, on matmul 1 of the block-sparse FFN at full width
(BlockSparseFFNConfig(), x (8192, 4096) bf16, block_m 16) and at M = 256;
then, unless --check-only, every variant timed in one process beside kernel
3, torch.matmul of x by the dense W1 and, with --parent, an earlier tree's
kernel 4 built from its own csrc/bsmm.cu.

    python tools/bsmm_resident_ab.py [--parent DIR] [--check-only] [--repeats N]

DIR holds an earlier checkout whose spgemm_tpu_torch/csrc/bsmm.cu exports
spgemm_bsmm_resident(x, rows, tiles, out, M, d_in, nbc, rpc, k, br,
col_chunk, dtype, fuse_gelu, device, stream); it is built with nvcc into
build/bsmm_ab/.  Timed runs go in turns (parent, variants, variants
reversed, parent), each launch after the L2 cache was overwritten, CUDA
events around it; the median of each name's runs is reported.  Prints the
card's nvidia-smi line, the ptxas lines of kernel 4, then one JSON line.
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
from spgemm_tpu_torch.ops import _build, cuda_bsmm  # noqa: E402

SEED = 20260
BLOCK_M = 16
SMALL_M = 256
L2_BYTES = 50 << 20
BF16_TOL = (2 ** -7, 1e-4)  # one bf16 ulp: both sum the same products in float32


def _parent_lib(parent: Path) -> ctypes.CDLL:
    src = parent / "spgemm_tpu_torch" / "csrc" / "bsmm.cu"
    out = REPO / "build" / "bsmm_ab" / "libbsmm_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.spgemm_bsmm_resident.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.spgemm_bsmm_resident.restype = ctypes.c_int
    return lib


def _parent_k4(lib, x, rows, tiles) -> torch.Tensor:
    M, d_in = x.shape
    nbc, rpc, k, _ = tiles.shape
    geo = cuda_bsmm.launch_geometry(M, nbc, BLOCK_M, True, cuda_bsmm.sm_count(x.device.index))
    out = torch.empty((M, nbc * k), dtype=x.dtype, device=x.device)
    err = lib.spgemm_bsmm_resident(x.data_ptr(), rows.data_ptr(), tiles.data_ptr(),
                                   out.data_ptr(), M, d_in, nbc, rpc, k, geo.br, geo.col_chunk,
                                   1, 0, x.device.index,
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"the parent's kernel 4 failed to launch: CUDA error {err}")
    return out


def _variants(M: int, k: int) -> dict:
    """name -> _launch keywords of kernel 4: every ring depth at cluster 1,
    every cluster at the deepest ring, the stream alone at each cluster,
    and the default (cluster_size, the deepest ring)."""
    deepest = cuda_bsmm.resident_layout(4096, BLOCK_M, 2, k).stages
    clusters = cuda_bsmm.cluster_sizes(M // cuda_bsmm.block_rows(BLOCK_M), k)
    out = {"k4": {}}
    for s in cuda_bsmm.RESIDENT_STAGES:
        if s <= deepest:
            out[f"k4_s{s}_c1"] = {"stages": s, "cluster": 1}
    for c in clusters:
        out[f"k4_s{deepest}_c{c}"] = {"stages": deepest, "cluster": c}
        out[f"k4_stream_c{c}"] = {"stages": deepest, "cluster": c, "stream_only": True}
    return out


def _k4(x, rows, tiles, **kw) -> torch.Tensor:
    return cuda_bsmm._launch(x, rows, tiles, BLOCK_M, False, resident=True, **kw)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bsmm_resident_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    log = _build.build("bsmm").with_suffix(".log").read_text()
    print("\n".join(line for line in log.splitlines()
                    if re.search(r"bsmm_resident|registers|spill", line)), flush=True)
    parent = _parent_lib(args.parent) if args.parent else None

    cfg = ffn.BlockSparseFFNConfig()
    gen = torch.Generator().manual_seed(SEED)
    params = ffn.init_params(cfg, gen, device="cuda")
    w1 = params["w1"]
    x = torch.randn((8 * 1024, cfg.d_model), generator=gen).to("cuda", torch.bfloat16)
    result = {"card": smi.stdout.strip().splitlines()[0], "checked": {}, "ms": {}, "runs": {}}
    for M in (x.shape[0], SMALL_M):
        xm = x[:M].contiguous()
        want = cuda_bsmm.bsmm(xm, w1["rows"], w1["tiles"], block_m=128)
        ref = cuda_bsmm.bsmm_ref(xm, w1["rows"], w1["tiles"])
        torch.cuda.synchronize()
        torch.testing.assert_close(want.float(), ref.float(), rtol=BF16_TOL[0], atol=BF16_TOL[1])
        checked = []
        for name, kw in _variants(M, cfg.k).items():
            if kw.get("stream_only"):
                continue
            got = _k4(xm, w1["rows"], w1["tiles"], **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise RuntimeError(f"kernel 4 {name} {kw} != kernel 3 at M = {M}: {bad} "
                                   f"elements differ")
            checked.append(name)
        if parent is not None:
            got = _parent_k4(parent, xm, w1["rows"], w1["tiles"])
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"the parent's kernel 4 != kernel 3 at M = {M}")
            checked.append("parent_k4")
        result["checked"][M] = checked
        print(f"M = {M}: kernel 4 == kernel 3 bit for bit, and within one bf16 ulp of "
              f"bsmm_ref: {checked}", flush=True)
    if args.check_only:
        print(json.dumps(result), flush=True)
        return 0

    dense = torch.zeros((cfg.nb_model, cfg.k, cfg.nb_ff, cfg.k), dtype=x.dtype, device="cuda")
    own = torch.arange(cfg.nb_ff, device="cuda")[:, None].expand(cfg.nb_ff, cfg.rpc).reshape(-1)
    dense[w1["rows"].reshape(-1).long(), :, own, :] = w1["tiles"].reshape(-1, cfg.k, cfg.k)
    dense = dense.reshape(cfg.d_model, cfg.d_ff)
    mm1 = (x, w1["rows"], w1["tiles"])
    fns = {name: (lambda kw=kw: _k4(*mm1, **kw)) for name, kw in _variants(x.shape[0],
                                                                            cfg.k).items()}
    fns["k3"] = lambda: cuda_bsmm.bsmm(*mm1, block_m=128)
    fns["lib_matmul"] = lambda: torch.matmul(x, dense)
    order = list(fns)
    if parent is not None:
        fns["parent_k4"] = lambda: _parent_k4(parent, *mm1)
        order = ["parent_k4", *order, *reversed(order), "parent_k4"]
    else:
        order = [*order, *reversed(order)]
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device="cuda")
    for fn in fns.values():  # warm-up: builds, first loads
        fn()
    runs = {name: [] for name in fns}
    for name in order:
        for _ in range(args.repeats):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            end.synchronize()
            runs[name].append(start.elapsed_time(end))
    result["ms"] = {name: sorted(r)[len(r) // 2] for name, r in runs.items()}
    result["runs"] = runs
    result["max_active_clusters"] = {
        c: cuda_bsmm.max_active_clusters(cfg.d_model, cfg.k, BLOCK_M, torch.bfloat16, c,
                                         x.device.index)
        for c in cuda_bsmm.cluster_sizes(x.shape[0] // BLOCK_M, cfg.k)}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
