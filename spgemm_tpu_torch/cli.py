"""CLI entry point: the reference's `a4` contract on PyTorch and CUDA.

    python -m spgemm_tpu_torch.cli <folder> [--device cuda|cpu]
        [--backend exact|mxu|hybrid|oracle] [--output matrix] [--threads N]
        [--round-size N] [--stream | --out-of-core] [--ranks P]
        [--checkpoint-dir DIR] [--failover] [--profile DIR] [-v]

reads `<folder>/size` (N, k) and `<folder>/matrix1..matrixN`, computes the
chain product, prunes all-zero tiles, writes `./matrix` byte-identically to
the reference, and prints `multiplying i j` lines and then `time taken X
seconds` (sparse_matrix_mult.cu:402-682).  The flags are the JAX package's
(spgemm_tpu/cli.py) and combine as there; stdout keeps its bytes.

  --device        cuda (default) or cpu.  Without a usable card, cuda raises
                  before any file is read or written; cpu runs the kernels'
                  plain PyTorch versions.
  --backend       exact (default) and hybrid write the reference's bytes,
                  mxu the product in clean arithmetic mod 2^64 - 1, oracle
                  the reference's bytes from the host-only python-int oracle
                  (needs no card; ignores --stream, --out-of-core, --ranks,
                  --checkpoint-dir and --failover, as the JAX CLI does).
  --round-size    at most N output tiles per numeric launch (the reference's
                  small_size); the bytes do not change.
  --stream        chain partials in host memory: each multiply uploads its
                  operands and fetches its result (ops/spgemm.spgemm).
  --out-of-core   partials in host memory and each round uploads only the
                  tiles it references (ops/spgemm.spgemm_outofcore), so no
                  operand slab is ever on the card; implies --stream.
  --ranks P       `mpirun -np P`'s partition and combine
                  (parallel/chainpart.py): the reference's bytes at P, one
                  set of `multiplying` lines per sub-chain and the combine.
  --checkpoint-dir  snapshot the partials after each pass; resume from the
                  newest snapshot there written for the same inputs
                  (utils/checkpoint.py).
  --failover      probe the card in a subprocess first and run on the CPU
                  if it is unusable; a multiply that fails mid-chain
                  restarts its pass on the host oracle if the probe then
                  finds no working card, and is raised if it finds one.
                  Each fallback prints one line to stderr.  Only this flag
                  falls back.
  --profile DIR   a torch.profiler Chrome trace of the run into DIR.

`-v` logs the seconds of load, chain and prune+write, and the engine's host
phases and counters (utils/timers.ENGINE).

A run pins SPGEMM_TPU_DELTA to 0 unless it is exported: delta recompute
(ops/delta) pays off only in a process that outlives one chain, and a
run-once process would hash its inputs and retain results it throws away.

    python -m spgemm_tpu_torch.cli warm [--stat | --clear | --clone SRC]
        [--dir PATH] [--json]

inspects (the default), empties or seeds from another directory the
persistent warm store (ops/warmstore): plans and delta entries a later
process reads back.  The directory is --dir, else SPGEMM_TPU_WARM_DIR.

    python -m spgemm_tpu_torch.cli serve [--socket PATH] [--addr tcp:H:P]
        [--device cuda|cpu] [--slices SPEC] [--queue-cap N] [--no-journal] [-v]
    python -m spgemm_tpu_torch.cli submit <folder> [--wait] [--backend ...]
    python -m spgemm_tpu_torch.cli status [job_id] [--wait | --shutdown]

run spgemmd, the resident daemon that owns the card and keeps the engine
warm across jobs (serve/daemon.py; delta recompute stays on there), and
talk to it (serve/client.py).  Without --device cpu, serve needs a card.
SPGEMM_TPU_SERVE_BATCH_WINDOW_S > 0 with SPGEMM_TPU_DELTA=0 arms cross-job
batching: up to SPGEMM_TPU_SERVE_BATCH_K queued jobs of one chain structure
run as one batch (`serve --help` says more).
A directory named warm, serve, submit or status that holds a `size` file
is still a chain folder.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops import warmstore
from spgemm_tpu_torch.ops.device import resolve_device
from spgemm_tpu_torch.ops.spgemm import BACKENDS, spgemm, spgemm_outofcore
from spgemm_tpu_torch.parallel.chainpart import chain_product_partitioned
from spgemm_tpu_torch.utils import backend_probe, io_text, knobs
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.semantics import chain_oracle
from spgemm_tpu_torch.utils.timers import ENGINE, PhaseTimers, maybe_profile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spgemm_tpu_torch",
        description="Block-sparse uint64 matrix chain product on an NVIDIA "
                    "GPU (reference-compatible output).")
    p.add_argument("folder", help="input directory containing `size` and `matrix1..N`")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the chain runs (default: cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    p.add_argument("--backend", choices=[*BACKENDS, "oracle"], default="exact",
                   help="numeric kernels (default: exact, the reference's "
                        "fold; mxu = field-mode limb kernel on every round; "
                        "hybrid = the limb kernel on rounds proven "
                        "bit-exact, the exact fold elsewhere; "
                        "SPGEMM_TPU_HYBRID_GATE=auto|proof sets its speed gate; "
                        "oracle = the host-only python-int oracle)")
    p.add_argument("--output", default="matrix",
                   help="output path (the reference writes ./matrix)")
    p.add_argument("--round-size", type=int, default=None,
                   help="max output tiles per numeric launch (default: the "
                        "card's cap, 2^25 / k^2; 512 under --out-of-core; the "
                        "reference's small_size=500)")
    p.add_argument("--threads", type=int, default=None,
                   help="file-loader thread pool size (default: min(16, 4x "
                        "host cores); the reference hardcodes 16)")
    p.add_argument("--stream", action="store_true",
                   help="host-resident chain partials: each multiply uploads its "
                        "two operands and fetches its result")
    p.add_argument("--out-of-core", action="store_true",
                   help="host-resident partials (implies --stream) and each round "
                        "uploads only the tiles it references, SPGEMM_TPU_OOC_DEPTH "
                        "rounds in flight (default 2)")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="snapshot chain partials after each reduction pass and "
                        "resume from the newest snapshot on restart")
    p.add_argument("--failover", action="store_true",
                   help="probe the card first and run on the CPU if it is unusable; "
                        "restart a failed pass on the host oracle")
    p.add_argument("--ranks", type=int, default=1, metavar="P",
                   help="`mpirun -np P` chain partitioning semantics "
                        "(reference sparse_matrix_mult.cu:438-456)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace to DIR")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def _chain(args, matrices: list, k: int, device):
    """The chain product as the flags ask for it."""
    if args.backend == "oracle":
        blocks = chain_oracle([m.to_dict() for m in matrices], k)
        return BlockSparseMatrix.from_dict(matrices[0].rows, matrices[-1].cols, k, blocks)
    multiply = None
    if args.out_of_core:
        multiply = spgemm_outofcore
    elif args.stream:
        multiply = spgemm
    kwargs = {"multiply": multiply, "device": device, "backend": args.backend,
              "round_size": args.round_size, "checkpoint_dir": args.checkpoint_dir,
              "failover": args.failover}
    if args.ranks > 1:
        return chain_product_partitioned(matrices, args.ranks, **kwargs)
    return chain_product(matrices, **kwargs)


def run_warm(argv: list[str]) -> int:
    """`warm [--stat|--clear|--clone SRC] [--dir PATH] [--json]` (the JAX
    package's cli.run_warm; the directory is --dir or SPGEMM_TPU_WARM_DIR,
    not read from a daemon's socket as there)."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch warm",
                                description="inspect (--stat, the default), empty "
                                            "(--clear) or seed from another directory "
                                            "(--clone) the persistent warm store")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--stat", action="store_true",
                   help="entry counts, bytes, budget, and whether a live process holds it")
    g.add_argument("--clear", action="store_true",
                   help="delete every entry; refuses while a live process holds the dir")
    g.add_argument("--clone", default=None, metavar="SRC_DIR",
                   help="copy SRC_DIR's entries in, each envelope-checked; entries "
                        "already here are kept")
    p.add_argument("--dir", default=None, metavar="PATH",
                   help="warm dir (default: SPGEMM_TPU_WARM_DIR)")
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args(argv)
    target = args.dir or knobs.get("SPGEMM_TPU_WARM_DIR")
    if not target:
        print("warm: no directory: pass --dir or set SPGEMM_TPU_WARM_DIR", file=sys.stderr)
        return 2
    try:
        if args.clear:
            removed = warmstore.clear(target)
            print(f"warm: cleared {removed} entries from {target}")
            return 0
        if args.clone:
            result = warmstore.clone(args.clone, target)
            if args.as_json:
                print(json.dumps(result, indent=2))
            else:
                print(f"warm: cloned {result['copied']} entries {args.clone} -> {target} "
                      f"({result['skipped']} skipped"
                      + (f": {result['skip_reasons']}" if result["skip_reasons"] else "") + ")")
            return 0
    except RuntimeError as e:
        print(f"warm: {e}", file=sys.stderr)
        return 1
    info = warmstore.scan(target)
    if args.as_json:
        print(json.dumps(info, indent=2))
        return 0
    state = ("missing" if not info["exists"]
             else "in use by a live process" if info["locked"] else "idle")
    print(f"warm store {target}: {state}")
    print(f"  plans={info['plans']} deltas={info['deltas']} bytes={info['bytes']} "
          f"budget={info['budget_bytes']}")
    return 0


def _serve(argv: list[str]) -> int:
    from spgemm_tpu_torch.serve import daemon  # noqa: PLC0415

    return daemon.main(argv)


def _submit(argv: list[str]) -> int:
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    return client.main_submit(argv)


def _status(argv: list[str]) -> int:
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    return client.main_status(argv)


_SUBCOMMANDS = {"warm": run_warm, "serve": _serve, "submit": _submit, "status": _status}


def run(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # a directory named like a subcommand that holds a chain keeps its
    # meaning as the folder
    if argv and argv[0] in _SUBCOMMANDS and not os.path.exists(os.path.join(argv[0], "size")):
        return _SUBCOMMANDS[argv[0]](argv[1:])
    args = build_parser().parse_args(argv)
    restore = knobs.pin_unless_exported("SPGEMM_TPU_DELTA", "0")
    try:
        return _run_chain(args)
    finally:
        restore()


def _run_chain(args) -> int:
    """The chain run of run(), inside its delta pin."""
    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(name)s %(message)s")
    device = None
    if args.backend == "oracle":
        if args.stream or args.out_of_core:
            print("--stream/--out-of-core ignored: the oracle backend is "
                  "host-only and the distributed path manages residency per "
                  "process", file=sys.stderr, flush=True)
    else:
        # stderr only: stdout keeps the reference's bytes
        if args.failover and args.device == "cuda" \
                and backend_probe.failover_to_cpu("--failover"):
            args.device = "cpu"
        device = resolve_device(args.device)
    t_start = time.perf_counter()
    timers = PhaseTimers()
    ENGINE.reset()
    with maybe_profile(args.profile, device):
        with timers.phase("load"):
            n, k = io_text.read_size(args.folder)
            matrices = io_text.read_chain(args.folder, 0, n - 1, k,
                                          max_workers=args.threads)
        with timers.phase("chain"):
            result = _chain(args, matrices, k, device)
        with timers.phase("prune+write"):
            io_text.write_matrix(args.output, result.prune_zeros())
    timers.log_report()
    ENGINE.log_report()  # the engine's host phases and counters
    # byte-parity with the reference's only surviving print (:679)
    print(f"time taken {time.perf_counter() - t_start} seconds")
    return 0


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
