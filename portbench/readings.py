"""Readings of the numbers that decide `correct`, over many seeds in one
process: the lower readings from the program as the configuration states it,
the upper from the control.  The benchmark's own runs never run this.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 --seconds 3 [--backend mxu]

One set-up, then for each seed a short window at the cell's own load and the
check of its sampled request, as run.py makes them.  `--backend mxu` is the
control: the program's own field-mode path (clean arithmetic mod 2^64 - 1,
the limb kernel) in place of the exact fold the configuration states, the
step a faster path would tempt a change to take.  One JSON line a seed, then
one with the largest reading of each number.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import check, harness  # noqa: E402


def readings(cell: harness.Cell, seeds: list[int], seconds: float, device,
             backend: str | None = None, out=sys.stdout) -> dict:
    """{number: largest reading} over the seeds; one line a seed to out."""
    worst: dict = {}
    with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
        driver = harness.Driver(cell, device, backend)
        driver.warm(seeds[0])
    for seed in seeds:
        reservoir = check.Reservoir(seed)
        t0 = time.perf_counter()
        with open(os.devnull, "w") as devnull, contextlib.redirect_stdout(devnull):
            loop = driver.window(seed, seconds, reservoir)
        window_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        if reservoir.results is not None:
            driver.draw(seed, reservoir.request)
        numbers = check.judge(cell.config, driver.inputs, reservoir.results, loop.failed)
        line = {"seed": seed, "backend": driver.backend, "requests": loop.completed,
                "request": reservoir.request, "window_s": window_s,
                "reference_s": time.perf_counter() - t1, **numbers}
        print(json.dumps(line), file=out, flush=True)
        for name in check.LIMITS:
            worst[name] = max(worst.get(name, numbers[name]), numbers[name])
        del reservoir
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--backend", default=None, help="in place of the configuration's")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    os.environ.update(harness.program_env(cell.config, False))
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    worst = readings(cell, seeds, args.seconds, device, args.backend)
    print(json.dumps({"workload": args.workload, "backend": args.backend or "as configured",
                      "seeds": len(seeds), "largest": worst}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
