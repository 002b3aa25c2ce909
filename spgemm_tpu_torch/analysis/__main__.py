"""CLI: `python -m spgemm_tpu_torch.analysis [paths...] [--json|--sarif F]`.

Default run (no paths): self-lint the whole spgemm_tpu_torch package and
chip_smoke.py plus the port's doc-drift checks (the generated tables in
spgemm_tpu_torch/ARCHITECTURE.md, the port CLI's help coverage, the
rule-id coverage of this very --help).  Explicit paths lint just those
files/dirs; the doc checks then run only when --claude-md is passed
(fixture testing drives this).

Exit status: 0 = clean, 1 = findings (CI-gateable).  --json emits one
machine-readable report object on stdout:
  {"findings": [{"file", "line", "rule", "message"}, ...],
   "counts": {<rule id>: n for every registered rule},
   "suppressions": [{"file", "line", "rule", "reason", "stale"}, ...],
   "cache": {"enabled", "dir"?, "hits"?, "misses"?, "invalidations"?},
   "clean": bool}
(the suppression inventory lists EVERY escape-hatch comment in the run --
fld-proof / thr-ok / exc-ok / lck-ok / blk-ok / tsi-ok / drf-ok -- with
stale=true
for an escape that no longer suppresses anything; a stale escape is also a
SUP finding).  --sarif F additionally writes a SARIF 2.1.0 log to F
(`make lint-sarif`), with suppressed findings carried as results bearing
SARIF `suppressions` objects.

Per-file results are content-hash cached under `build/lint_cache/` by
default (the linter is proven env-independent and torch-free, so a file's
findings are a pure function of its bytes + the analysis package's
bytes): a warm `make lint-torch` re-runs only changed files.  The JAX
linter's `.lint_cache/` is a different directory on purpose: each
linter's default-scope run prunes entries outside its scope.
`--no-cache` disables it, `--cache-dir` relocates it (tests).
"""

from __future__ import annotations

import argparse
import collections
import json
import sys

from spgemm_tpu_torch.analysis import core, docrules, sarif


def build_parser() -> argparse.ArgumentParser:
    """The analysis CLI parser.  The epilog is generated from the rule-id
    registry (core.RULES) so docrules.check_analysis_help can hold this
    --help to covering every rule id without a hand-maintained list."""
    epilog = "rule ids:\n" + "\n".join(
        f"  {rule_id:6s}{doc}" for rule_id, doc in core.RULES.items())
    p = argparse.ArgumentParser(
        prog="spgemm_tpu_torch.analysis",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        description="spgemm-lint for the PyTorch/CUDA port: package-level "
                    "invariant checker (FLD fold "
                    "order incl. interprocedural taint, KNB knob registry, "
                    "BKD import-time CUDA-context touch, THR lock discipline, "
                    "LCK lock-order deadlock detection, BLK blocking-under-"
                    "lock, TSI thread-shared inference, EXC exception "
                    "contracts, MET metric registry, FPT failpoint "
                    "registry, PRO wire-protocol registry, EVT event-kind "
                    "registry, DRF registry drift, SUP stale "
                    "suppressions, DOC doc drift)",
        epilog=epilog)
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the "
                        "spgemm_tpu_torch package and chip_smoke.py, + the "
                        "port's doc checks)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable findings + suppression-"
                        "inventory report")
    p.add_argument("--sarif", default=None, metavar="FILE",
                   help="also write a SARIF 2.1.0 log to FILE "
                        "(`make lint-sarif` writes lint.sarif)")
    p.add_argument("--claude-md", default=None, metavar="PATH",
                   help="doc file to diff the knob table against "
                        "(default: spgemm_tpu_torch/ARCHITECTURE.md, on a "
                        "default run; the other tables are checked in the "
                        "ARCHITECTURE.md beside it)")
    p.add_argument("--architecture-md", default=None, metavar="PATH",
                   help="ARCHITECTURE.md for the --write-*-table flags "
                        "(default: spgemm_tpu_torch/ARCHITECTURE.md)")
    p.add_argument("--no-doc", action="store_true",
                   help="skip the DOC drift checks")
    p.add_argument("--write-knob-table", action="store_true",
                   help="regenerate the knob-table block (in "
                        "spgemm_tpu_torch/ARCHITECTURE.md) from the "
                        "registry and exit")
    p.add_argument("--write-metrics-table", action="store_true",
                   help="regenerate the ARCHITECTURE.md metrics-table "
                        "block from the obs/metrics.py registry and exit")
    p.add_argument("--write-thread-inventory", action="store_true",
                   help="regenerate the ARCHITECTURE.md thread-inventory "
                        "block from the concurrency pass (LCK/BLK/TSI) "
                        "over the default scope and exit")
    p.add_argument("--write-protocol-table", action="store_true",
                   help="regenerate the ARCHITECTURE.md wire-protocol "
                        "table block from the serve/protocol.py registry "
                        "and exit")
    p.add_argument("--write-event-table", action="store_true",
                   help="regenerate the ARCHITECTURE.md event-kind table "
                        "block from the obs/events.py EVENT_KINDS "
                        "registry and exit")
    p.add_argument("--no-cache", action="store_true",
                   help="disable the content-hash per-file result cache "
                        "(build/lint_cache/; the default run caches)")
    p.add_argument("--cache-dir", default=None, metavar="DIR",
                   help="cache directory (default: "
                        "<repo>/build/lint_cache)")
    return p


def _write_block(path: str, begin_marker: str, end_marker: str,
                 block: str, what: str) -> int:
    """Regenerate one marked generated-doc block in place."""
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        print(f"cannot read {path}", file=sys.stderr)
        return 1
    begin = text.find(begin_marker)
    end = text.find(end_marker)
    if begin < 0 or end < 0 or end < begin:
        print(f"{path}: {what} markers missing; paste this block where "
              f"the {what} belongs:\n\n" + block, file=sys.stderr)
        return 1
    new = text[:begin] + block + text[end + len(end_marker):]
    if new != text:
        with open(path, "w", encoding="utf-8") as f:
            f.write(new)
        print(f"updated {what} in {path}")
    else:
        print(f"{what} in {path} already current")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    default_claude = core.default_doc()
    if args.write_knob_table or args.write_metrics_table \
            or args.write_thread_inventory or args.write_protocol_table \
            or args.write_event_table:
        # the flags compose: "regenerate everything" must not silently
        # leave a later table stale behind an earlier early return
        rc = 0
        if args.write_knob_table:
            rc = max(rc, _write_block(
                args.claude_md or default_claude,
                docrules.KNOB_TABLE_BEGIN, docrules.KNOB_TABLE_END,
                docrules.render_knob_block(), "knob table"))
        if args.write_metrics_table:
            rc = max(rc, _write_block(
                args.architecture_md or core.default_doc(),
                docrules.METRICS_TABLE_BEGIN, docrules.METRICS_TABLE_END,
                docrules.render_metrics_block(), "metrics table"))
        if args.write_thread_inventory:
            rc = max(rc, _write_block(
                args.architecture_md or core.default_doc(),
                docrules.THREAD_TABLE_BEGIN, docrules.THREAD_TABLE_END,
                docrules.render_thread_block(), "thread inventory"))
        if args.write_protocol_table:
            rc = max(rc, _write_block(
                args.architecture_md or core.default_doc(),
                docrules.PROTOCOL_TABLE_BEGIN, docrules.PROTOCOL_TABLE_END,
                docrules.render_protocol_block(), "protocol table"))
        if args.write_event_table:
            rc = max(rc, _write_block(
                args.architecture_md or core.default_doc(),
                docrules.EVENT_TABLE_BEGIN, docrules.EVENT_TABLE_END,
                docrules.render_event_block(), "event table"))
        return rc

    if args.paths:
        paths = args.paths
        claude_md = args.claude_md  # None = no doc checks on custom runs
    else:
        paths = core.default_paths()
        claude_md = args.claude_md or default_claude
    cache = None if args.no_cache else core.LintCache(args.cache_dir)
    # the DOC half (knob table + CLI/analysis help) runs only when a
    # CLAUDE.md is in play: default runs always, explicit-path runs only
    # with --claude-md
    report = core.lint_run(
        paths, claude_md=claude_md,
        doc=not args.no_doc and claude_md is not None, cache=cache)
    findings, suppressions = report.findings, report.suppressions

    if args.sarif:
        sarif.write(args.sarif, findings, report.suppressed)
    if args.as_json:
        counts = collections.Counter(f.rule for f in findings)
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "counts": {rule: counts.get(rule, 0) for rule in core.RULES},
            "suppressions": [s.to_dict() for s in suppressions],
            "cache": report.cache or {"enabled": False},
            "clean": not findings,
        }, indent=2))
    else:
        for f in findings:
            print(f"{f.file}:{f.line}: [{f.rule}] {f.message}")
        print(f"spgemm-lint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
