#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spgemm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its wall time; any failure raises and
the script exits non-zero without printing a result:

  1. device  -- the card, and `nvidia-smi --query-gpu=name,power.limit`;
  2. build   -- every kernel in spgemm_tpu_torch/csrc, built with nvcc;
  3. kernel  -- each kernel against its plain PyTorch version on the card
               (EDGE values, sentinel padding, an empty round, a stacked
               round, a hub fanout; k in 1, 2, 4, 8, 32, 64), exact equality;
  4. cli     -- `python -m spgemm_tpu_torch.cli` on the golden inputs, byte
               equality with the expected files, plus one small multiply
               against the numpy oracle;
  5. medium  -- the reference report's Medium chain (N=10 banded block-sparse
               matrices, block_dim 1111, bandwidth 4, k=32, ~100k tiles) from
               a fixed seed: the main path once with the launch counts zeroed
               before and read after, then timed runs of the kernel and of
               the plain version on the card, whose results must be equal.

Then one JSON line describing every ported kernel and, last, the device line
`{"ok": true, "device": {...}}`.  Imports torch, numpy and the port only.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import _build, cuda_spgemm
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import plan, spgemm
from spgemm_tpu_torch.utils import io_text
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import banded_block_sparse, random_block_sparse
from spgemm_tpu_torch.utils.semantics import spgemm_oracle

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 20260
MAX = (1 << 64) - 1
# the SURVEY.md section 2.9 trigger set: products and sums straddling 2^32/2^64
EDGE = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
        (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX]
# Medium scale of the reference report (bench.py's default workload)
MEDIUM = {"n": 10, "block_dim": 1111, "bandwidth": 4, "k": 32}
KERNEL_REPEATS = 3  # timed kernel runs of the Medium chain; the median is reported

# H100 SXM peaks (NVIDIA data sheet).  The fp32 rate, 67e12 FLOP/s, is
# 2 flops x 128 fp32 lanes per SM per clock; an SM issues 64 32-bit integer
# add/compare/select results per clock, a quarter of that.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# Integer-pipe instructions per u64 MAC in csrc/numeric_round.cu's sm_90a
# SASS: ISETP, ISETP.EX, SEL, SEL for each of the two compare-with-all-ones
# steps, and IADD3 for the low half of the add.  The multiply-low (three
# IMADs and an IMAD.IADD) and the add's carry (IMAD.X) issue on the FMA pipe
# beside them, so the integer pipe is the bound.
INT_OPS_PER_MAC = 9


def _phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.3f} s)", flush=True)


def _u64_max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """max |x - y| over int64 bit-views read as uint64."""
    if x.shape != y.shape:
        raise RuntimeError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.numel() == 0:
        return 0
    flip = torch.iinfo(torch.int64).min  # xor with the sign bit orders as unsigned
    x_ge_y = (x ^ flip) >= (y ^ flip)
    d = torch.where(x_ge_y, x - y, y - x)  # wrapping: the unsigned difference
    return (int((d ^ flip).max().item()) & MAX) ^ (1 << 63)


def _edge_values(rng: np.random.Generator, shape) -> np.ndarray:
    """Half EDGE values, half uniform uint64."""
    edge = np.array(EDGE, np.uint64)[rng.integers(0, len(EDGE), size=shape)]
    full = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    return np.where(rng.random(shape) < 0.5, edge, full)


def _round_case(rng, k: int, n_tiles: int, K: int, P: int, stack: int = 0):
    """Random slabs (sentinel zero tile last) and sentinel-padded pair
    indices on the card: (a, b, pa, pb)."""
    dev = torch.device(DEVICE)
    slabs = []
    for _ in range(2):
        tiles = _edge_values(rng, (n_tiles + 1, k, k))
        tiles[-1] = 0
        slabs.append(torch.from_numpy(tiles.view(np.int64)).to(dev))
    lead = (stack, K) if stack else (K,)
    pa = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pb = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    real = rng.integers(0, P + 1, size=lead)  # each key's real fanout
    pad = np.arange(P) >= real[..., None]
    pa[pad] = n_tiles
    pb[pad] = n_tiles
    return (slabs[0], slabs[1], torch.from_numpy(pa).to(dev),
            torch.from_numpy(pb).to(dev))


def phase_kernel(rng) -> int:
    """Kernel vs plain version on the card; returns the max abs error."""
    t0 = time.perf_counter()
    cases = [(k, 40, 37, 5, 0) for k in (1, 2, 4, 8, 32, 64)]
    cases += [(8, 30, 9, 3, 3), (32, 30, 9, 3, 2),   # stacked (R, K, P) rounds
              (32, 20, 0, 4, 0),                     # empty K = 0 round
              (32, 300, 4, 384, 0), (8, 300, 6, 256, 0)]  # hub fanouts
    worst = 0
    for k, n_tiles, K, P, stack in cases:
        a, b, pa, pb = _round_case(rng, k, n_tiles, K, P, stack)
        got = cuda_spgemm.numeric_round(a, b, pa, pb)
        want = cuda_spgemm.numeric_round_ref(a, b, pa, pb)
        torch.cuda.synchronize()
        err = _u64_max_abs_err(got, want)
        worst = max(worst, err)
        if not torch.equal(got, want):
            raise RuntimeError(f"kernel != plain version at k={k} K={K} P={P} "
                               f"stack={stack}: max abs err {err}")
    _phase("kernel", t0, f"numeric_round == numeric_round_ref on {len(cases)} "
           f"rounds (k in 1..64, stacked, empty, hub P<=384); max_abs_err {worst}")
    return worst


def _multiplying_lines(n: int) -> list[str]:
    """The chain's progress lines for an N-matrix chain (helper2 pairing)."""
    lines, m = [], n
    while m > 1:
        lines += [f"multiplying {i} {i + 1}" for i in range(0, m - 1, 2)]
        m = m // 2 + m % 2
    return lines


def phase_cli(rng) -> None:
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": REPO}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        for name in ("golden_chain", "golden_wrap"):
            folder = os.path.join(REPO, "tests", "data", name)
            out = os.path.join(tmp, f"{name}.matrix")
            proc = subprocess.run(
                [sys.executable, "-m", "spgemm_tpu_torch.cli", folder, "--output", out,
                 "--device", DEVICE],
                cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"cli on {name} exited {proc.returncode}:\n{proc.stderr}")
            with open(out, "rb") as f, \
                    open(os.path.join(REPO, "tests", "data", f"{name}_expected_matrix"), "rb") as g:
                if f.read() != g.read():
                    raise RuntimeError(f"cli output on {name} differs from the expected bytes")
            lines = proc.stdout.splitlines()
            n, _ = io_text.read_size(folder)
            if lines[:-1] != _multiplying_lines(n) or \
                    not re.fullmatch(r"time taken \S+ seconds", lines[-1]):
                raise RuntimeError(f"cli stdout on {name} is not the reference's:\n{proc.stdout}")
    a = random_block_sparse(5, 5, 4, 0.5, rng)
    b = random_block_sparse(5, 5, 4, 0.5, rng)
    a.tiles[:] = _edge_values(rng, a.tiles.shape)
    got = spgemm(a, b, device=DEVICE)
    want = BlockSparseMatrix.from_dict(a.rows, b.cols, 4,
                                       spgemm_oracle(a.to_dict(), b.to_dict(), 4))
    if got != want:
        raise RuntimeError("spgemm on the card differs from the numpy oracle")
    _phase("cli", t0, "golden_chain and golden_wrap byte-equal, stdout lines "
           "match; small EDGE spgemm == oracle")


class TimedFold:
    """A numeric-round function wrapped in CUDA events, counting the work
    the run's data needs: real tile-pair MACs and bytes (each referenced
    tile, index and output element once)."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []
        self.macs = 0
        self.bytes = 0

    def __call__(self, a, b, pa, pb):
        k = a.shape[-1]
        tile = k * k * 8
        self.macs += int((pa != a.shape[0] - 1).sum()) * k ** 3
        self.bytes += (len(torch.unique(pa)) + len(torch.unique(pb))) * tile \
            + (pa.numel() + pb.numel()) * 4 + pa.shape[0] * tile
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(a, b, pa, pb)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _banded_coords(block_dim: int, bandwidth: int) -> np.ndarray:
    r = np.arange(block_dim)[:, None]
    c = np.arange(block_dim)[None, :]
    return np.argwhere(np.abs(r - c) <= bandwidth).astype(np.int64)


def _plan_chain_s(mats) -> float:
    """Host seconds the chain's planner (join + rounds + permutation) takes
    alone, on the block structures only."""
    arr = [SimpleNamespace(k=m.k, nnzb=m.nnzb, coords=m.coords) for m in mats]
    t0 = time.perf_counter()
    while len(arr) > 1:
        nxt = []
        for i in range(0, len(arr) - 1, 2):
            p = plan(arr[i], arr[i + 1])
            nxt.append(SimpleNamespace(k=p.k, nnzb=p.join.num_keys, coords=p.join.keys))
        arr = nxt + arr[len(nxt) * 2:]
    return time.perf_counter() - t0


def phase_medium() -> dict:
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cfg = MEDIUM
    mats = [banded_block_sparse(cfg["block_dim"], cfg["k"], cfg["bandwidth"], rng)
            for _ in range(cfg["n"])]
    dev_mats = [DeviceBlockMatrix.from_host(m, DEVICE) for m in mats]
    torch.cuda.synchronize()
    tiles = sum(m.nnzb for m in mats)
    _phase("medium", t0, f"generated + uploaded {cfg['n']} banded matrices, "
           f"{tiles} tiles of {cfg['k']}x{cfg['k']} uint64 "
           f"({tiles * cfg['k'] ** 2 * 8 / 1e6:.0f} MB)")

    # the main path, once: counts zeroed just before, read just after
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cuda_spgemm.launches = 0
    res = chain_product(dev_mats, device=DEVICE, keep_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_spgemm.launches
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0:
        raise RuntimeError("the main path launched the numeric_round kernel 0 times")
    want_coords = _banded_coords(cfg["block_dim"], cfg["bandwidth"] * cfg["n"])
    if not np.array_equal(res.coords, want_coords) or \
            tuple(res.slab.shape) != (len(want_coords) + 1, cfg["k"], cfg["k"]):
        raise RuntimeError("Medium result structure is not the expected band")
    t_plan = _plan_chain_s(mats)
    _phase("medium", t0, f"main path: chain wall {wall:.6f} s (host planning "
           f"alone {t_plan:.6f} s), numeric_round "
           f"launches {launches}, result {res.nnzb} tiles, peak device memory "
           f"{peak / 2**30:.3f} GiB")

    t0 = time.perf_counter()
    kerns = [TimedFold(cuda_spgemm.numeric_round) for _ in range(KERNEL_REPEATS)]
    plain = TimedFold(cuda_spgemm.numeric_round_ref)
    with contextlib.redirect_stdout(io.StringIO()):  # the progress lines again
        for kern in kerns:
            res_k = chain_product(dev_mats, device=DEVICE, keep_device=True, fold=kern)
        res_p = chain_product(dev_mats, device=DEVICE, keep_device=True, fold=plain)
        plain_ms = plain.ms()
    runs_ms = sorted(kern.ms() for kern in kerns)
    kern_ms = runs_ms[len(runs_ms) // 2]
    err = max(_u64_max_abs_err(res.slab, res_p.slab), _u64_max_abs_err(res_k.slab, res_p.slab))
    if not (torch.equal(res.slab, res_p.slab) and torch.equal(res_k.slab, res_p.slab)
            and np.array_equal(res.coords, res_p.coords)):
        raise RuntimeError(f"Medium chain: kernel result != plain version (max abs err {err})")
    ops_ms = kern.macs * INT_OPS_PER_MAC / INT32_OPS_PER_S * 1e3
    bytes_ms = kern.bytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    _phase("medium", t0, f"kernel total {kern_ms:.3f} ms over {len(kern.events)} "
           f"launches (median of {', '.join(f'{t:.3f}' for t in runs_ms)}), plain "
           f"version total {plain_ms:.3f} ms; results equal; "
           f"{kern.macs / 1e9:.3f} G MACs -> integer bound {ops_ms:.3f} ms, "
           f"{kern.bytes / 1e9:.3f} GB -> bytes bound {bytes_ms:.3f} ms; "
           f"kernel at {bound_ms / kern_ms * 100:.1f}% of bound")
    return {"name": "numeric_round", "route": "cuda",
            "source": "spgemm_tpu_torch/csrc/numeric_round.cu",
            "replaces": "spgemm_tpu/ops/pallas_spgemm.py:188",
            "launches": launches, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "equal": True,
            "ms_runs": runs_ms, "chain_wall_s": wall, "plan_s": t_plan, "macs": kern.macs,
            "peak_bytes": peak}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    _phase("device", t0, f"{name}, {torch.cuda.device_count()} visible, torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)
    _phase("build", t0, f"built {', '.join(sorted(libs))} with nvcc")

    rng = np.random.default_rng(SEED)
    kernel_err = phase_kernel(rng)
    phase_cli(rng)
    row = phase_medium()
    row["max_abs_err"] = max(row["max_abs_err"], kernel_err)
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
