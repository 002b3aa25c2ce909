"""CLI entry point: the reference's `a4` contract on PyTorch and CUDA.

    python -m spgemm_tpu_torch.cli <folder> [--device cuda|cpu]
        [--backend exact|mxu|hybrid|oracle] [--output matrix] [--threads N]
        [--round-size N] [--stream | --out-of-core]
        [--shard none|keys|inner|ring|chain]
        [--ranks P] [--checkpoint-dir DIR] [--failover] [--profile DIR]
        [--distributed] [-v]

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
  --shard keys    each multiply's output keys sharded over the visible cards
                  (parallel/rowshard.py; on --device cpu one shard), kernel 1
                  folding each shard: the reference's bytes, partials in host
                  memory (so --stream and --out-of-core do not apply), the
                  exact fold, which exact and hybrid give too; with
                  --backend mxu, whose field-mode bytes differ, it is
                  refused.  `none` is the default.
  --shard inner   each multiply's pair lists cut over the visible cards, the
                  partial tiles all-reduced (parallel/innershard.py); on
                  --device cpu one position.  Clean arithmetic mod 2^64 - 1,
                  --backend mxu's bytes, whatever --backend says (one stderr
                  line under exact and hybrid); partials in host memory.
  --shard ring    B's slabs rotating around the visible cards, each folding
                  its range of output keys (parallel/ring.py): the same
                  bytes as inner; SPGEMM_TPU_RING_OVERLAP=0 copies each slab
                  after its fold instead of beside it.
  --shard chain   rank r of --ranks P (default: one rank a card) reducing its
                  sub-chain on card r mod the cards, the combine on the
                  first (parallel/chainpart.chain_product_on_devices): the
                  bytes of --ranks P; ignores --stream and --out-of-core.
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
  --distributed   one process of P (parallel/multihost.py): set
                  JAX_COORDINATOR=host:port (rank 0's), JAX_NUM_PROCESSES=P
                  and JAX_PROCESS_ID=r for each; without them P = 1.  Each
                  rank reduces its slice of --ranks P's partition on
                  --device, the partials are exchanged on gloo in chunks of
                  SPGEMM_TPU_DCN_CHUNK_MB, every rank runs the combine and
                  rank 0 writes ./matrix: --ranks P's bytes.  The exact fold
                  (hybrid and oracle give its bytes: one stderr line; --backend
                  mxu is refused); --ranks, --shard, --checkpoint-dir,
                  --failover, --stream and --out-of-core are ignored, one
                  stderr line each.

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
    python -m spgemm_tpu_torch.cli metrics
    python -m spgemm_tpu_torch.cli events [--tail N] [--follow]
    python -m spgemm_tpu_torch.cli trace-dump [--merge DIR] [--trace ID] [-o FILE]
    python -m spgemm_tpu_torch.cli profile [--json]
    python -m spgemm_tpu_torch.cli slo [--json]

run spgemmd, the resident daemon that owns the card and keeps the engine
warm across jobs (serve/daemon.py; delta recompute stays on there), and
talk to it (serve/client.py).  Without --device cpu, serve needs a card.
SPGEMM_TPU_SERVE_BATCH_WINDOW_S > 0 with SPGEMM_TPU_DELTA=0 arms cross-job
batching: up to SPGEMM_TPU_SERVE_BATCH_K queued jobs of one chain structure
run as one batch (`serve --help` says more).  `metrics` scrapes the
daemon's Prometheus text, `events` prints its event log (--follow tails
<socket>.events.jsonl), `trace-dump` writes its span flight recorder as
trace_event JSON or merges a directory of dumps, `profile` reports its
build records, device memory watermark and estimator and delta accuracy,
`slo` its per-tenant latency quantiles, error ratio and burn state (obs/).

    python -m spgemm_tpu_torch.cli route --backends ADDR[,ADDR...]
        [--listen tcp:H:P] [--poll-s S] [-v]

runs spgemm-router (fleet/router.py), one front door for several spgemmd
daemons (each started with `serve --addr tcp:H:P`): it polls their stats,
places each submit by the fleet's price book, proxies status and wait,
joins their scrapes, and re-submits a job once when its daemon dies.  The
client subcommands talk to it with `--addr` as to a daemon.

    python -m spgemm_tpu_torch.cli knobs [--json]
    python -m spgemm_tpu_torch.cli tune [--status | --clear] [--dir PATH] [--json]

`knobs` lists every SPGEMM_TPU_* knob (value, source env|tuned|default,
default; the knobs the autotuner searches are marked [tuned-search], those a
persisted override carries [tuned: N class(es)]) and the live plan-cache,
estimator, delta, warm-store and profiling blocks; an invalid value is
reported on its row.  `tune` reads the autotuner's persisted per-class
overrides (the warm store's tune tier, tune/) from disk, or deletes them;
the directory is --dir, else SPGEMM_TPU_WARM_DIR, else the default socket's
<socket>.warm.  A directory named like a subcommand that holds a `size`
file is still a chain folder.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from functools import partial

from spgemm_tpu_torch.utils import knobs

# The engine (torch, numpy, the kernels) is imported by the functions that
# run a chain, so the client subcommands (submit, status, metrics, events,
# trace-dump, profile, slo, knobs, tune) start without torch: a scrape is not
# a cold torch import.


def build_parser() -> argparse.ArgumentParser:
    from spgemm_tpu_torch.ops import BACKENDS  # noqa: PLC0415 -- torch-free

    p = argparse.ArgumentParser(
        prog="spgemm_tpu_torch",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description="Block-sparse uint64 matrix chain product on an NVIDIA "
                    "GPU (reference-compatible output).",
        # the epilog is GENERATED from the knob registry, so --help can
        # never drift from the knobs the code reads (spgemm-lint DOC)
        epilog=knobs.cli_epilog())
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
    p.add_argument("--shard", choices=["none", "keys", "inner", "ring", "chain"],
                   default="none",
                   help="shard over the visible cards: keys = output-tile sharding of "
                        "each multiply (bit-exact), inner = contraction sharding with "
                        "an all-reduce, ring = B's slabs rotating around the cards, "
                        "the copy double-buffered beside the fold "
                        "(SPGEMM_TPU_RING_OVERLAP=0 serializes it, bit-identical) "
                        "(inner and ring fold in clean mod-(2^64-1) arithmetic; all "
                        "three keep partials in host memory), chain = one chain rank "
                        "a card (the bytes of --ranks P)")
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
    p.add_argument("--distributed", action="store_true",
                   help="multi-process mode: partition the chain across processes "
                        "(set JAX_COORDINATOR/JAX_NUM_PROCESSES/JAX_PROCESS_ID per "
                        "process; replaces `mpirun -np P`). Partial products exchange "
                        "on gloo in bounded chunks of SPGEMM_TPU_DCN_CHUNK_MB (default "
                        "64) per rank; 0 = legacy padded all-gather")
    p.add_argument("--verbose", "-v", action="store_true")
    return p


def _chain(args, matrices: list, k: int, device):
    """The chain product as the flags ask for it."""
    from spgemm_tpu_torch.chain import chain_product  # noqa: PLC0415
    from spgemm_tpu_torch.ops.spgemm import spgemm, spgemm_outofcore  # noqa: PLC0415
    from spgemm_tpu_torch.parallel.chainpart import (  # noqa: PLC0415
        chain_product_on_devices, chain_product_partitioned)
    from spgemm_tpu_torch.parallel.innershard import spgemm_inner  # noqa: PLC0415
    from spgemm_tpu_torch.parallel.mesh import default_devices  # noqa: PLC0415
    from spgemm_tpu_torch.parallel.ring import spgemm_ring  # noqa: PLC0415
    from spgemm_tpu_torch.parallel.rowshard import spgemm_sharded  # noqa: PLC0415
    from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix  # noqa: PLC0415
    from spgemm_tpu_torch.utils.semantics import chain_oracle  # noqa: PLC0415

    if args.backend == "oracle":
        blocks = chain_oracle([m.to_dict() for m in matrices], k)
        return BlockSparseMatrix.from_dict(matrices[0].rows, matrices[-1].cols, k, blocks)
    devices = default_devices(device_type=device.type) if args.shard != "none" else None
    if args.shard == "chain":
        return chain_product_on_devices(
            matrices, devices, num_parts=args.ranks if args.ranks > 1 else None,
            backend=args.backend, round_size=args.round_size,
            checkpoint_dir=args.checkpoint_dir, failover=args.failover)
    multiply, backend = None, args.backend
    if args.shard == "keys":
        # the sharded fold is the exact one (mxu is refused in run())
        multiply, backend = partial(spgemm_sharded, devices=devices), "exact"
    elif args.shard in ("inner", "ring"):
        # field mode whatever --backend says: mxu's arithmetic, which also
        # tags checkpoints and picks failover's field-mode oracle
        fn = spgemm_inner if args.shard == "inner" else spgemm_ring
        multiply, backend = partial(fn, devices=devices), "mxu"
    elif args.out_of_core:
        multiply = spgemm_outofcore
    elif args.stream:
        multiply = spgemm
    kwargs = {"multiply": multiply, "device": device, "backend": backend,
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
    from spgemm_tpu_torch.ops import warmstore  # noqa: PLC0415

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


def _tune_dir(explicit: str | None = None) -> str:
    """The warm directory `tune` and `knobs` read: explicit, else
    SPGEMM_TPU_WARM_DIR, else the default socket's <socket>.warm (the
    daemon's own default)."""
    from spgemm_tpu_torch.serve import protocol  # noqa: PLC0415

    return explicit or knobs.get("SPGEMM_TPU_WARM_DIR") or protocol.default_socket_path() + ".warm"


def _tuned_classes() -> dict[str, list[str]]:
    """knob name -> the class keys whose persisted canary or live override
    carries it, read from disk (nothing where no directory can be read)."""
    from spgemm_tpu_torch.ops import warmstore  # noqa: PLC0415

    tuned_by: dict[str, list[str]] = {}
    for ck, rec in sorted(warmstore.scan_tunes(_tune_dir()).items()):
        if rec.get("state") in ("canary", "live"):
            for name in {**(rec.get("knobs") or {}), **(rec.get("est") or {})}:
                tuned_by.setdefault(str(name), []).append(ck)
    return tuned_by


def _stats_or_error(fn, fallback: dict) -> dict:
    """fn()'s block, or fallback with the error where an invalid knob makes
    fn raise: the listing reports it in place and goes on."""
    try:
        return fn()
    except ValueError as e:
        return {**fallback, "error": str(e)}


def run_knobs(argv: list[str]) -> int:
    """`knobs [--json]` (the JAX package's cli.run_knobs): the registry's
    live state, one row per knob, and the engine's live blocks beside it."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch knobs",
                                description="list the engine's env knobs: current value, "
                                            "default and source")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable: {knobs: [one object per knob], plan_cache, "
                        "estimator, delta, warm, profile}")
    args = p.parse_args(argv)
    from spgemm_tpu_torch.obs import profile as obs_profile  # noqa: PLC0415
    from spgemm_tpu_torch.ops import delta, estimate, plancache, warmstore  # noqa: PLC0415

    rows = knobs.snapshot()
    tuned_by = _tuned_classes()
    for r in rows:
        if r["name"] in tuned_by:
            r["tuned_classes"] = tuned_by[r["name"]]
    cache = _stats_or_error(
        lambda: {**plancache.stats(), "capacity": knobs.get("SPGEMM_TPU_PLAN_CACHE_CAP"),
                 "enabled": plancache.enabled()},
        {"hits": 0, "misses": 0, "evictions": 0, "entries": 0, "capacity": "?",
         "enabled": "?"})
    est = _stats_or_error(estimate.stats, {"hits": 0, "fallbacks": 0, "enabled": "?",
                                           "sample_rows": "?", "confidence_threshold": "?"})
    dlt = _stats_or_error(delta.stats, {"hits": 0, "full_fallbacks": 0, "evictions": 0,
                                        "rows_recomputed": 0, "rows_total": 0, "entries": 0,
                                        "capacity": "?", "enabled": "?"})
    warm = _stats_or_error(warmstore.stats, {"plans": 0, "deltas": 0, "tunes": 0, "bytes": 0,
                                             "plan_hits": 0, "plan_misses": 0,
                                             "delta_hits": 0, "delta_misses": 0,
                                             "corrupt": 0, "dir": None, "enabled": "?"})
    if args.as_json:
        print(json.dumps({"knobs": rows, "plan_cache": cache, "estimator": est, "delta": dlt,
                          "warm": warm, "profile": _stats_or_error(obs_profile.report, {})},
                         indent=2))
        return 0
    prof = _stats_or_error(obs_profile.summary, {"compiles": 0, "compile_s": 0,
                                                 "est_mean_rel_error": {},
                                                 "delta_mean_dirty_fraction": None,
                                                 "hbm_peak_bytes": None})

    def flag(v):
        return v if v == "?" else int(v)

    name_w = max(len(r["name"]) for r in rows)
    val_w = max(len(r["value"]) for r in rows)
    lines = []
    for r in rows:
        search = " [tuned-search]" if r["tuned_search"] else ""
        tuned = (f" [tuned: {len(r['tuned_classes'])} class(es)]"
                 if r.get("tuned_classes") else "")
        lines.append(f"{r['name']:<{name_w}}  {r['value']:>{val_w}}  "
                     f"({r['source']}, default {r['default']}){search}{tuned}")
        if r.get("error"):
            lines.append(f"{'':<{name_w}}  !! {r['error']}")
        lines.append(f"{'':<{name_w}}  {r['doc']}")
    blocks = [
        (f"plan cache: hits={cache['hits']} misses={cache['misses']} "
         f"evictions={cache.get('evictions', 0)} entries={cache['entries']}/"
         f"{cache['capacity']} enabled={flag(cache['enabled'])}  [ops/plancache.py]", cache),
        (f"estimator:  est_hits={est['hits']} est_fallbacks={est['fallbacks']} "
         f"enabled={flag(est['enabled'])} sample_rows={est['sample_rows']} "
         f"confidence>={est['confidence_threshold']}  [ops/estimate.py]", est),
        (f"delta:      hits={dlt['hits']} full_fallbacks={dlt['full_fallbacks']} "
         f"rows={dlt['rows_recomputed']}/{dlt['rows_total']} "
         f"entries={dlt['entries']}/{dlt['capacity']} enabled={flag(dlt['enabled'])}"
         "  [ops/delta.py]", dlt),
        (f"warm:       plans={warm['plans']} deltas={warm['deltas']} tunes={warm['tunes']} "
         f"bytes={warm['bytes']} hits={warm['plan_hits'] + warm['delta_hits']} "
         f"misses={warm['plan_misses'] + warm['delta_misses']} corrupt={warm['corrupt']} "
         f"dir={warm['dir'] or '(unbound)'} enabled={flag(warm['enabled'])}"
         "  [ops/warmstore.py]", warm),
        (f"profile:    compiles={prof['compiles']} ({prof['compile_s']}s) "
         f"est_err={prof['est_mean_rel_error'] or None} "
         f"delta_dirty_frac={prof['delta_mean_dirty_fraction']} "
         f"hbm_peak={prof['hbm_peak_bytes']}  [obs/profile.py]", prof),
    ]
    for line, block in blocks:
        lines.append(line)
        if block.get("error"):
            lines.append(f"  !! {block['error']}")
    try:
        for line in lines:
            print(line)
    except BrokenPipeError:
        # `knobs | head` closing the pipe is not an error for a listing; point
        # stdout at devnull so the interpreter's exit flush cannot raise again
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


def _crossover_entries(prefix: str) -> dict:
    """The crossover cache's entries under a key prefix, read from the file
    ops/crossover.cache_path() names, without importing that module (it
    imports torch); {} where the file cannot be read."""
    root = knobs.get("SPGEMM_TPU_CROSSOVER_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "spgemm_tpu_torch")
    try:
        with open(os.path.join(root, "hybrid_crossover.json")) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return {}
    return {k: v for k, v in entries.items() if k.startswith(prefix)} \
        if isinstance(entries, dict) else {}


def run_tune(argv: list[str]) -> int:
    """`tune [--status|--clear] [--dir PATH] [--json]` (the JAX package's
    cli.run_tune): the autotuner's persisted overrides, one row per
    structure class (state, knob vector, measured win, estimator
    adaptation), and the dense-route gate's `dense-v1:` measurements in the
    crossover cache, which trial legs under `auto` fill as jobs do.  Read
    from disk: works against a stopped daemon."""
    p = argparse.ArgumentParser(prog="spgemm_tpu_torch tune",
                                description="inspect (--status, the default) or empty "
                                            "(--clear) the autotuner's persisted per-class "
                                            "knob overrides")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--status", action="store_true",
                   help="the override table: class, state, knob vector, measured win, "
                        "estimator adaptation (the default)")
    g.add_argument("--clear", action="store_true",
                   help="delete the tune tier's entries (plans and delta entries stay); "
                        "refuses while a live process holds the dir")
    p.add_argument("--dir", default=None, metavar="PATH",
                   help="warm dir (default: SPGEMM_TPU_WARM_DIR, else <default socket>.warm)")
    p.add_argument("--json", action="store_true", dest="as_json")
    args = p.parse_args(argv)
    from spgemm_tpu_torch.ops import warmstore  # noqa: PLC0415

    target = _tune_dir(args.dir)
    if args.clear:
        try:
            removed = warmstore.clear_tunes(target)
        except RuntimeError as e:
            print(f"tune: {e}", file=sys.stderr)
            return 1
        print(f"tune: cleared {removed} override record(s) from {target}")
        return 0
    records = warmstore.scan_tunes(target)
    dense = _crossover_entries("dense-v1:")
    if args.as_json:
        print(json.dumps({"dir": target, "overrides": records, "crossover_dense": dense},
                         indent=2))
        return 0
    print(f"tune store {target}: {len(records)} class record(s)")
    for ck, rec in sorted(records.items()):
        vec = " ".join(f"{k}={v}" for k, v in sorted((rec.get("knobs") or {}).items())) or "-"
        est = " ".join(f"{k}={v}" for k, v in sorted((rec.get("est") or {}).items()))
        win = rec.get("win")
        line = f"  {ck}  [{rec.get('state', '?')}]  win={win if win is not None else '-'}  {vec}"
        print(line + (f"  est: {est}" if est else ""))
    if dense:
        print(f"crossover dense-v1 captures: {len(dense)}")
        for key, hit in sorted(dense.items()):
            ladder_s, dense_s = hit.get("ladder_s"), hit.get("dense_s")
            verdict = "dense" if (dense_s is not None and ladder_s is not None
                                  and dense_s < ladder_s) else "ladder"
            print(f"  {key}  ladder={ladder_s}s dense={dense_s}s -> {verdict}")
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


def _metrics(argv: list[str]) -> int:
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    return client.main_metrics(argv)


def _trace_dump(argv: list[str]) -> int:
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    return client.main_trace_dump(argv)


def _events(argv: list[str]) -> int:
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    return client.main_events(argv)


def _profile(argv: list[str]) -> int:
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    return client.main_profile(argv)


def _slo(argv: list[str]) -> int:
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    return client.main_slo(argv)


def _route(argv: list[str]) -> int:
    from spgemm_tpu_torch.fleet import router  # noqa: PLC0415

    return router.main(argv)


_SUBCOMMANDS = {"knobs": run_knobs, "warm": run_warm, "tune": run_tune, "serve": _serve,
                "submit": _submit, "status": _status, "metrics": _metrics,
                "trace-dump": _trace_dump, "events": _events, "profile": _profile,
                "slo": _slo, "route": _route}


def run(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # a directory named like a subcommand that holds a chain keeps its
    # meaning as the folder
    if argv and argv[0] in _SUBCOMMANDS and not os.path.exists(os.path.join(argv[0], "size")):
        return _SUBCOMMANDS[argv[0]](argv[1:])
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.shard == "keys" and args.backend == "mxu":
        parser.error("--shard keys runs the exact fold; --backend mxu's field-mode bytes "
                     "differ from it")
    if args.distributed and args.backend == "mxu":
        parser.error("--distributed runs the exact fold; --backend mxu's field-mode bytes "
                     "differ from it")
    restore = knobs.pin_unless_exported("SPGEMM_TPU_DELTA", "0")
    try:
        return _run_chain(args)
    finally:
        restore()


def _run_chain(args) -> int:
    """The chain run of run(), inside its delta pin.  --distributed joins
    the group init_from_env makes (parallel/multihost.py): this rank loads
    and reduces its slice, every rank prints its `multiplying` lines and
    `time taken`, and rank 0 writes ./matrix."""
    from spgemm_tpu_torch.ops.device import resolve_device  # noqa: PLC0415
    from spgemm_tpu_torch.utils import backend_probe, io_text  # noqa: PLC0415
    from spgemm_tpu_torch.utils.timers import ENGINE, PhaseTimers, maybe_profile  # noqa: PLC0415

    logging.basicConfig(level=logging.INFO if args.verbose else logging.WARNING,
                        format="%(name)s %(message)s")
    for note in _notes(args):
        print(note, file=sys.stderr, flush=True)
    device = None
    if args.backend != "oracle" or args.distributed:
        # stderr only: stdout keeps the reference's bytes
        if args.failover and not args.distributed and args.device == "cuda" \
                and backend_probe.failover_to_cpu("--failover"):
            args.device = "cpu"
        device = resolve_device(args.device)  # no card: fails before joining a group
    t_start = time.perf_counter()
    timers = PhaseTimers()
    ENGINE.reset()
    if args.distributed:
        from spgemm_tpu_torch.parallel import multihost  # noqa: PLC0415

        multihost.init_from_env()
    try:
        with maybe_profile(args.profile, device):
            if args.distributed:
                n, k = io_text.read_size(args.folder)

                def loader(start, end):
                    with timers.phase("load"):
                        return io_text.read_chain(args.folder, start, end, k,
                                                  max_workers=args.threads)

                result = multihost.run_distributed(args.folder, k, n, loader, device=device,
                                                   round_size=args.round_size)
            else:
                with timers.phase("load"):
                    n, k = io_text.read_size(args.folder)
                    matrices = io_text.read_chain(args.folder, 0, n - 1, k,
                                                  max_workers=args.threads)
                with timers.phase("chain"):
                    result = _chain(args, matrices, k, device)
            if not args.distributed or multihost.world()[1] == 0:
                with timers.phase("prune+write"):
                    io_text.write_matrix(args.output, result.prune_zeros())
    finally:
        if args.distributed:
            import torch.distributed as dist  # noqa: PLC0415

            if dist.is_initialized():
                dist.destroy_process_group()
    timers.log_report()
    ENGINE.log_report()  # the engine's host phases and counters
    # byte-parity with the reference's only surviving print (:679)
    print(f"time taken {time.perf_counter() - t_start} seconds")
    return 0


# the JAX CLI's note on --stream/--out-of-core where they do not apply
_RESIDENCY_NOTE = ("--stream/--out-of-core ignored: the oracle backend is host-only and the "
                   "distributed path manages residency per process")


def _notes(args) -> list[str]:
    """The stderr lines of the flags a run ignores or overrides."""
    ooc = args.stream or args.out_of_core
    if args.distributed:
        notes = [_RESIDENCY_NOTE] if ooc else []
        if args.backend in ("hybrid", "oracle"):
            notes.append(f"--backend {args.backend} with --distributed runs the exact fold, "
                         "whose bytes it gives")
        if args.ranks > 1:
            notes.append("--ranks ignored with --distributed: P is JAX_NUM_PROCESSES")
        if args.shard != "none":
            notes.append(f"--shard {args.shard} ignored with --distributed: each process "
                         "reduces its sub-chain on --device")
        if args.checkpoint_dir:
            notes.append("--checkpoint-dir ignored with --distributed: recovery is a rerun")
        if args.failover:
            notes.append("--failover ignored with --distributed: a failed rank fails the run")
        return notes
    notes = []
    if ooc and args.shard in ("keys", "inner", "ring"):
        notes.append(f"--shard {args.shard} already keeps chain partials host-resident; "
                     "--out-of-core per-round staging does not apply to the sharded multiply")
    if ooc and args.shard == "chain":
        notes.append("--stream/--out-of-core ignored with --shard chain (per-rank partials are "
                     "device-resident by design)")
    if args.shard in ("inner", "ring") and args.backend in ("exact", "hybrid"):
        notes.append(f"--shard {args.shard} folds in clean arithmetic mod 2^64 - 1 whatever "
                     f"--backend says: --backend {args.backend}'s bytes differ where a product "
                     "or sum reaches 2^64 - 1")
    if args.backend == "oracle" and ooc:
        notes.append(_RESIDENCY_NOTE)
    return notes


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
