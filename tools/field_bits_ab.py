"""F1 and F3 (csrc/field_fold.cu) of this tree against an earlier tree's, on
the card: the same bits, then each timed in turns.

The operands are two multiplies of the Medium chain (chip_smoke's MEDIUM:
banded_block_sparse(1111, 32, 4) from default_rng(20260), ten inputs): its
first, M1 x M2 ("l1"), and the level-2 multiply (M1 M2) x (M3 M4) ("l2"),
whose operands are the field-mode products of the first four.  F1 runs as
spgemm_inner runs it at one position (every ladder round of the plan, one
launch each); F3 as spgemm_ring runs it at n positions (default 4): this
tree folds each (position, slab) CSR list of ring_cells in one launch, the
parent each rank list and the tail trip of plan_ring in one launch each,
into an accumulator per position; all the n^2 (position, slab) folds are
made, as over a whole ring multiply.  Bits: every F1 tile and every
accumulator equal.  Times: the sum over a multiply's launches of CUDA-event
times, with 400 MB zeroed before each launch so that no launch finds its
tiles in the L2 cache; turns of parent, this tree, this tree, parent;
medians of the runs.

    python tools/field_bits_ab.py --parent DIR [--positions N] [--repeats N]
                                  [--check-only]

DIR holds an earlier checkout's spgemm_tpu_torch/csrc/ (field_fold.cu and
any header it includes), whose entries are those of commit 14341be:
spgemm_field_fold(a, b, pa, pb, out, C, P, k, a_sent, b_sent, small, device,
stream) and spgemm_field_fold_scatter(a, b, pa, pb, rows, acc, C, P, k,
a_sent, b_sent, dummy_row, small, device, stream); e.g. `git archive
<commit> spgemm_tpu_torch/csrc | tar -x -C build/parent`.  It is built with
nvcc into build/field_bits_ab/.  Prints the card's nvidia-smi line, this
tree's ptxas figures for F1 and F3, then one JSON line; exits 1 where any
bits differ.  Needs an NVIDIA GPU; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from spgemm_tpu_torch.obs import profile  # noqa: E402
from spgemm_tpu_torch.ops import _build, cuda_field, u64  # noqa: E402
from spgemm_tpu_torch.ops.spgemm import pack_tiles  # noqa: E402
from spgemm_tpu_torch.ops.spgemm import plan as make_plan  # noqa: E402
from spgemm_tpu_torch.parallel.innershard import spgemm_inner  # noqa: E402
from spgemm_tpu_torch.parallel.ring import plan_ring, ring_cells  # noqa: E402
from spgemm_tpu_torch.utils.gen import banded_block_sparse  # noqa: E402

SEED = 20260
MEDIUM = {"n": 10, "block_dim": 1111, "bandwidth": 4, "k": 32}
FLUSH_BYTES = 400 * 10 ** 6


def _parent_lib(parent: Path) -> ctypes.CDLL:
    src = parent / "spgemm_tpu_torch" / "csrc" / "field_fold.cu"
    out = REPO / "build" / "field_bits_ab" / "libfield_fold_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.spgemm_field_fold.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.spgemm_field_fold_scatter.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.spgemm_field_fold.restype = lib.spgemm_field_fold_scatter.restype = ctypes.c_int
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _parent_fold(lib, a, b, pa, pb, small: bool) -> torch.Tensor:
    K, P = pa.shape
    k = a.shape[-1]
    out = torch.empty((K, k, k), dtype=torch.int64, device=a.device)
    err = lib.spgemm_field_fold(a.data_ptr(), b.data_ptr(), pa.data_ptr(), pb.data_ptr(),
                                out.data_ptr(), K, P, k, a.shape[0] - 1, b.shape[0] - 1,
                                int(small), a.device.index, _stream(a))
    if err:
        raise RuntimeError(f"the parent's F1 launch failed: {err}")
    return out


def _parent_scatter(lib, acc, a, b, rows, pa, pb, small: bool) -> None:
    C = rows.shape[0]
    P = 1 if pa.dim() == 1 else pa.shape[1]
    k = a.shape[-1]
    err = lib.spgemm_field_fold_scatter(a.data_ptr(), b.data_ptr(), pa.data_ptr(),
                                        pb.data_ptr(), rows.data_ptr(), acc.data_ptr(), C, P, k,
                                        a.shape[0] - 1, b.shape[0] - 1, acc.shape[0] - 1,
                                        int(small), a.device.index, _stream(a))
    if err:
        raise RuntimeError(f"the parent's F3 launch failed: {err}")


def _timed(calls: list, flush: torch.Tensor | None) -> float:
    """Run each call, timed alone by CUDA events (flush zeroed before each
    when given); returns the sum of their times in ms."""
    total = 0.0
    for call in calls:
        if flush is not None:
            flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total


def _f1_case(lib, a, b, dev) -> dict:
    """F1 over every ladder round of a x b, as spgemm_inner at one position:
    each side's launches and its outputs."""
    rounds = make_plan(a, b, route="ladder").rowshard_rounds(None)
    a_s, b_s = pack_tiles(a, dev), pack_tiles(b, dev)
    small = u64.operands_below_2_32(a, b)
    idx = [tuple(torch.from_numpy(np.array(x)).to(dev) for x in (r.pa, r.pb))
           for r in rounds]
    outs = {"parent": [None] * len(idx), "tree": [None] * len(idx)}

    def call(who, i):
        pa, pb = idx[i]
        if who == "parent":
            outs[who][i] = _parent_fold(lib, a_s, b_s, pa, pb, small)
        else:
            outs[who][i] = cuda_field.field_fold(a_s, b_s, pa, pb, small=small)

    calls = {who: [lambda who=who, i=i: call(who, i) for i in range(len(idx))]
             for who in outs}
    pairs = sum(int(((r.pa != a.nnzb) & (r.pb != b.nnzb)).sum()) for r in rounds)
    return {"calls": calls, "outs": outs, "launches": len(idx), "pairs": pairs,
            "small": small}


def _f3_case(lib, a, b, dev, n: int) -> dict:
    """F3 over all n^2 (position, slab) folds of the ring at n positions:
    this tree one launch a CSR list, the parent one a rank list or tail."""
    key_chunks, slab_bounds, ranks, tail, s_max, k_max = plan_ring(
        _join(a, b), b.nnzb, n, mass_balance=False)
    cells = ring_cells(ranks, tail, n, k_max)
    a_s = pack_tiles(a, dev)
    b_host = pack_tiles(b, "cpu")
    k = a.k
    small = u64.operands_below_2_32(a, b)
    slabs = []
    for s in range(n):
        lo, hi = slab_bounds[s], slab_bounds[s + 1]
        slab = torch.zeros((s_max + 1, k, k), dtype=torch.int64)
        slab[: hi - lo] = b_host[lo:hi]
        slabs.append(slab.to(dev))
    accs = {who: [torch.zeros((k_max + 1, k, k), dtype=torch.int64, device=dev)
                  for _ in range(n)] for who in ("parent", "tree")}
    calls = {"parent": [], "tree": []}
    trips = [(rows, np.where(pa < 0, a.nnzb, pa).astype(np.int32), pb)
             for rows, pa, pb in ranks + ([tail] if tail is not None else [])]
    for d in range(n):
        *arrays, bounds = cells.position(d)
        rows, cell_ptr, pa, pb = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                                  for x in arrays)
        for s in range(n):
            c0, c1 = int(bounds[s]), int(bounds[s + 1])
            if c1 > c0:
                calls["tree"].append(
                    lambda d=d, s=s, lists=(rows[c0:c1], cell_ptr[c0: c1 + 1], pa, pb):
                    cuda_field.field_fold_scatter(accs["tree"][d], a_s, slabs[s], *lists,
                                                  small=small))
            for trip in trips:
                t_rows, t_pa, t_pb = (torch.from_numpy(np.ascontiguousarray(x[d, s])).to(dev)
                                      for x in trip)
                calls["parent"].append(
                    lambda d=d, s=s, t=(t_rows, t_pa, t_pb):
                    _parent_scatter(lib, accs["parent"][d], a_s, slabs[s], *t, small))
    return {"calls": calls, "accs": accs, "launches": {w: len(c) for w, c in calls.items()},
            "pairs": len(cells.pa), "cells": len(cells.rows), "small": small}


def _join(a, b):
    from spgemm_tpu_torch.ops.symbolic import symbolic_join  # noqa: PLC0415

    return symbolic_join(a.coords, b.coords)


def _ptxas() -> dict:
    """Registers and spill bytes of this tree's F1 and F3 instances."""
    log = _build.build("field_fold").with_suffix(".log").read_text()
    out = {}
    for entry, stats in profile.parse_ptxas(log).items():
        m = re.search(r"limb_fold_kernelILi(\d)ELi(\d)E\w*?(RowWalk|CellWalk)", entry)
        if m:
            name = ("F1 " if m.group(3) == "RowWalk" else "F3 ") + f"{m.group(1)}x{m.group(2)}"
            out[name] = {key: stats[key] for key in ("registers", "spill_stores", "spill_loads")}
    return out


def _median(runs: list) -> float:
    return sorted(runs)[len(runs) // 2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--positions", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--check-only", action="store_true")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    lib = _parent_lib(args.parent)
    print(f"F1 and F3 ptxas: {_ptxas()}", flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    mats = [banded_block_sparse(MEDIUM["block_dim"], MEDIUM["k"], MEDIUM["bandwidth"], rng)
            for _ in range(4)]
    l2 = [spgemm_inner(mats[i], mats[i + 1], devices=[dev]) for i in (0, 2)]
    operands = {"l1": (mats[0], mats[1]), "l2": tuple(l2)}
    cases, equal, info = {}, {}, {}
    for name, (a, b) in operands.items():
        cases[f"F1_{name}"] = f1 = _f1_case(lib, a, b, dev)
        cases[f"F3_{name}"] = f3 = _f3_case(lib, a, b, dev, args.positions)
        for case in (f1, f3):
            for who in ("parent", "tree"):
                _timed(case["calls"][who], None)
        torch.cuda.synchronize()
        equal[f"F1_{name}"] = all(torch.equal(x, y) for x, y in zip(f1["outs"]["parent"],
                                                                      f1["outs"]["tree"]))
        equal[f"F3_{name}"] = all(torch.equal(x, y) for x, y in zip(f3["accs"]["parent"],
                                                                      f3["accs"]["tree"]))
        info[f"F1_{name}"] = {"launches": f1["launches"], "pairs": f1["pairs"],
                              "small": f1["small"]}
        info[f"F3_{name}"] = {"launches": f3["launches"], "pairs": f3["pairs"],
                              "cells": f3["cells"], "small": f3["small"]}
    print(json.dumps({"equal": equal, "cases": info}), flush=True)
    if args.check_only:
        return 0 if all(equal.values()) else 1
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    runs = {f"{who}_{name}": [] for who in ("parent", "tree") for name in cases}
    for _ in range(args.repeats):
        for order in (("parent", "tree"), ("tree", "parent")):
            for who in order:
                for name, case in cases.items():
                    runs[f"{who}_{name}"].append(_timed(case["calls"][who], flush))
    result = {"equal": equal, "cases": info, "positions": args.positions,
              "median_ms": {name: _median(r) for name, r in runs.items()}, "runs_ms": runs}
    print(json.dumps(result))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
