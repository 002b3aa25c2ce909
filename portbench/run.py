"""Run one cell of the benchmark once; the last line of standard output is
the result as one JSON object.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (`spgemm_tpu_torch`)
beside this folder.  It exits with another code than 0, and prints no
result, where the card the cell asks for is missing, where the port is
missing, or where JAX, Flax or the JAX package was loaded.  The check's
numbers, each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T0 = time.time()
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        started = harness.process_start_epoch()
    except (OSError, ValueError, IndexError):
        started = _T0
    cell = harness.load_cell(args.workload)
    os.environ.update(harness.program_env(cell.config, bool(args.trace)))

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if (harness.CHECKOUT / "spgemm_tpu_torch" / "__init__.py").exists() is False:
        print("portbench: the port (spgemm_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, lines = harness.run(cell, args.seed, args.seconds, bool(args.trace), device, started)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
