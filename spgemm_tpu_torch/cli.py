"""CLI entry point: the reference's `a4` contract on PyTorch and CUDA.

    python -m spgemm_tpu_torch.cli <folder> [--device cuda|cpu]
                                   [--backend exact|mxu|hybrid]
                                   [--output matrix] [--threads N] [-v]

reads `<folder>/size` (N, k) and `<folder>/matrix1..matrixN`, computes the
chain product on the device, prunes all-zero tiles, writes `./matrix`
byte-identically to the reference, and prints `multiplying i j` lines and
then `time taken X seconds` (sparse_matrix_mult.cu:402-682).

The default device is `cuda`; without a usable card that raises before any
file is read or written.  `--device cpu` runs the kernels' plain PyTorch
versions on the CPU.  `--backend` picks the numeric kernels
(ops/spgemm.py): `exact` (default) and `hybrid` write the reference's
bytes, `mxu` the chain's product in clean arithmetic mod 2^64 - 1.

`-v` logs the seconds of load, chain and prune+write, and inside the chain
those of the engine's host phases (utils/timers.ENGINE): plan, plan_wait and
upload.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops.device import resolve_device
from spgemm_tpu_torch.ops.spgemm import BACKENDS
from spgemm_tpu_torch.utils import io_text
from spgemm_tpu_torch.utils.timers import ENGINE, PhaseTimers


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spgemm_tpu_torch",
        description="Block-sparse uint64 matrix chain product on an NVIDIA "
                    "GPU (reference-compatible output).")
    p.add_argument("folder", help="input directory containing `size` and `matrix1..N`")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the chain runs (default: cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--backend", choices=list(BACKENDS), default="exact",
                   help="numeric kernels (default: exact, the reference's "
                        "fold; mxu = field-mode limb kernel on every round; "
                        "hybrid = the limb kernel on rounds proven "
                        "bit-exact, the exact fold elsewhere; "
                        "SPGEMM_TPU_HYBRID_GATE=auto|proof sets its speed gate)")
    p.add_argument("--output", default="matrix",
                   help="output path (the reference writes ./matrix)")
    p.add_argument("--threads", type=int, default=None,
                   help="file-loader thread pool size (default: min(16, 4x "
                        "host cores); the reference hardcodes 16)")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def run(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(name)s %(message)s")
    device = resolve_device(args.device)
    t_start = time.perf_counter()
    timers = PhaseTimers()
    ENGINE.reset()
    with timers.phase("load"):
        n, k = io_text.read_size(args.folder)
        matrices = io_text.read_chain(args.folder, 0, n - 1, k,
                                      max_workers=args.threads)
    with timers.phase("chain"):
        result = chain_product(matrices, device=device, backend=args.backend)
    with timers.phase("prune+write"):
        io_text.write_matrix(args.output, result.prune_zeros())
    timers.log_report()
    ENGINE.log_report()  # the chain's host phases: plan, plan_wait, upload
    # byte-parity with the reference's only surviving print (:679)
    print(f"time taken {time.perf_counter() - t_start} seconds")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
