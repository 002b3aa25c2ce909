"""DOC rule: generated-vs-committed doc drift.

Three halves:

  * CLAUDE.md knob table -- the block between the `<!-- knob-table:begin -->`
    and `<!-- knob-table:end -->` markers must equal
    `knobs.knob_table_md()` exactly (regenerate with
    `python -m spgemm_tpu_torch.analysis --write-knob-table`).
  * ARCHITECTURE.md metrics table -- the block between the
    `<!-- metrics-table:begin/end -->` markers must equal
    `obs.metrics.metrics_table_md()` (regenerate with
    `--write-metrics-table`): the scrape surface is registry-generated
    exactly like the knobs.
  * CLI help -- `cli.build_parser()` help text must cover every registered
    knob name.  The epilog is generated from the registry
    (`knobs.cli_epilog`), so this check fails only if someone hardcodes or
    drops the epilog; the check inspects the BUILT parser, not the source,
    so any spelling of coverage passes.
"""

from __future__ import annotations

from spgemm_tpu_torch.analysis.core import Finding, rel_file
from spgemm_tpu_torch.utils import knobs

KNOB_TABLE_BEGIN = "<!-- knob-table:begin -->"
KNOB_TABLE_END = "<!-- knob-table:end -->"

METRICS_TABLE_BEGIN = "<!-- metrics-table:begin -->"
METRICS_TABLE_END = "<!-- metrics-table:end -->"

THREAD_TABLE_BEGIN = "<!-- thread-inventory:begin -->"
THREAD_TABLE_END = "<!-- thread-inventory:end -->"

PROTOCOL_TABLE_BEGIN = "<!-- protocol-table:begin -->"
PROTOCOL_TABLE_END = "<!-- protocol-table:end -->"

EVENT_TABLE_BEGIN = "<!-- event-table:begin -->"
EVENT_TABLE_END = "<!-- event-table:end -->"


def thread_inventory_md(rows: list | None = None) -> str:
    """The generated thread-inventory table: one row per thread root the
    LCK/BLK/TSI pass resolves over the DEFAULT lint scope (always the
    default scope, independent of what a particular run linted, so the
    committed table has exactly one truth) -- root function, spawner,
    locks it may transitively hold, shared attrs it writes.

    rows: precomputed inventory rows from a lint run whose unit set WAS
    the default scope (lint_run passes them through so the default
    `make lint` builds the whole-program analysis once, not twice);
    None = build the analysis here."""
    from spgemm_tpu_torch.analysis import core, lockrules  # noqa: PLC0415

    if rows is None:
        units = [core.LintUnit(f) for path in core.default_paths()
                 for f in core._walk_py(path)]
        rows = lockrules.inventory_rows(units)
    lines = ["| thread root | spawned by | locks it may hold "
             "| shared state it writes |",
             "|---|---|---|---|"]
    for row in rows:
        def cell(items):
            return ", ".join(f"`{i}`" for i in items) if items else "—"
        lines.append(f"| `{row['root']}` | {cell(row['spawners'])} "
                     f"| {cell(row['locks'])} | {cell(row['writes'])} |")
    return "\n".join(lines)


def render_thread_block() -> str:
    """The full marked block, ready to paste into ARCHITECTURE.md."""
    return (f"{THREAD_TABLE_BEGIN}\n{thread_inventory_md()}\n"
            f"{THREAD_TABLE_END}")


def check_thread_inventory(path: str,
                           rows: list | None = None) -> list[Finding]:
    """Diff the committed thread-inventory table against the one the
    concurrency pass generates from the default scope (the same
    keep-it-generated contract as the knob and metrics tables;
    regenerate with `--write-thread-inventory`)."""
    if rows is None:
        # generating the table means a full default-scope analysis:
        # don't pay it just to learn the file is unreadable or has no
        # markers -- those findings compare nothing
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            text = None
        if text is None or THREAD_TABLE_BEGIN not in text \
                or THREAD_TABLE_END not in text:
            return _check_marked_block(path, THREAD_TABLE_BEGIN,
                                       THREAD_TABLE_END, "",
                                       "thread inventory",
                                       "--write-thread-inventory")
    return _check_marked_block(path, THREAD_TABLE_BEGIN, THREAD_TABLE_END,
                               thread_inventory_md(rows),
                               "thread inventory",
                               "--write-thread-inventory")


def render_knob_block() -> str:
    """The full marked block, ready to paste into CLAUDE.md."""
    return (f"{KNOB_TABLE_BEGIN}\n{knobs.knob_table_md()}\n"
            f"{KNOB_TABLE_END}")


def render_metrics_block() -> str:
    """The full marked block, ready to paste into ARCHITECTURE.md."""
    from spgemm_tpu_torch.obs import metrics  # noqa: PLC0415

    return (f"{METRICS_TABLE_BEGIN}\n{metrics.metrics_table_md()}\n"
            f"{METRICS_TABLE_END}")


def render_protocol_block() -> str:
    """The full marked block, ready to paste into ARCHITECTURE.md."""
    from spgemm_tpu_torch.serve import protocol  # noqa: PLC0415

    return (f"{PROTOCOL_TABLE_BEGIN}\n{protocol.protocol_table_md()}\n"
            f"{PROTOCOL_TABLE_END}")


def render_event_block() -> str:
    """The full marked block, ready to paste into ARCHITECTURE.md."""
    from spgemm_tpu_torch.obs import events  # noqa: PLC0415

    return (f"{EVENT_TABLE_BEGIN}\n{events.event_table_md()}\n"
            f"{EVENT_TABLE_END}")


def _check_marked_block(path: str, begin_marker: str, end_marker: str,
                        generated: str, what: str,
                        regen_flag: str) -> list[Finding]:
    """Shared marker-block diff for the generated doc tables."""
    file = rel_file(path)
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except OSError:
        return [Finding(file, 1, "DOC", f"{what} check: cannot read "
                        f"{file} (expected the generated {what} "
                        f"between {begin_marker} / {end_marker})")]
    begin = text.find(begin_marker)
    end = text.find(end_marker)
    if begin < 0 or end < 0 or end < begin:
        return [Finding(file, 1, "DOC",
                        f"{what} markers missing: {file} must carry the "
                        f"generated {what} between {begin_marker} "
                        f"and {end_marker} (run `python -m "
                        f"spgemm_tpu_torch.analysis {regen_flag}`)")]
    committed = text[begin + len(begin_marker):end].strip()
    if committed != generated.strip():
        line = text[:begin].count("\n") + 1
        return [Finding(file, line, "DOC",
                        f"{what} drifted from its registry: regenerate "
                        f"with `python -m spgemm_tpu_torch.analysis "
                        f"{regen_flag}`")]
    return []


def check_claude_md(path: str) -> list[Finding]:
    """Diff the committed knob table against the registry-generated one."""
    return _check_marked_block(path, KNOB_TABLE_BEGIN, KNOB_TABLE_END,
                               knobs.knob_table_md(), "knob table",
                               "--write-knob-table")


def check_architecture_md(path: str) -> list[Finding]:
    """Diff the committed metrics table against the obs/metrics.py
    registry (the same keep-it-generated contract as the knob table)."""
    from spgemm_tpu_torch.obs import metrics  # noqa: PLC0415

    return _check_marked_block(path, METRICS_TABLE_BEGIN, METRICS_TABLE_END,
                               metrics.metrics_table_md(), "metrics table",
                               "--write-metrics-table")


def check_protocol_table(path: str) -> list[Finding]:
    """Diff the committed wire-protocol table against the
    serve/protocol.py registry (ops, fields, min versions, error codes)."""
    from spgemm_tpu_torch.serve import protocol  # noqa: PLC0415

    return _check_marked_block(path, PROTOCOL_TABLE_BEGIN,
                               PROTOCOL_TABLE_END,
                               protocol.protocol_table_md(),
                               "protocol table", "--write-protocol-table")


def check_event_table(path: str) -> list[Finding]:
    """Diff the committed event-kind table against the obs/events.py
    EVENT_KINDS registry."""
    from spgemm_tpu_torch.obs import events  # noqa: PLC0415

    return _check_marked_block(path, EVENT_TABLE_BEGIN, EVENT_TABLE_END,
                               events.event_table_md(), "event table",
                               "--write-event-table")


def check_analysis_help() -> list[Finding]:
    """`python -m spgemm_tpu_torch.analysis --help` must list every rule id.

    The epilog is generated from core.RULES (see __main__.build_parser), so
    this fails only if someone hardcodes or drops the epilog -- the same
    keep-it-wired contract check_cli_help applies to the knob epilog.  The
    BUILT parser is inspected, not the source, so any spelling of coverage
    passes."""
    from spgemm_tpu_torch.analysis import __main__ as analysis_main  # noqa: PLC0415
    from spgemm_tpu_torch.analysis.core import RULES  # noqa: PLC0415

    file = rel_file(analysis_main.__file__)
    try:
        help_text = analysis_main.build_parser().format_help()
    except Exception as e:  # noqa: BLE001 -- a broken parser IS the finding
        return [Finding(file, 1, "DOC",
                        f"analysis build_parser() failed: {e!r}")]
    missing = [rule for rule in RULES if rule not in help_text]
    return [Finding(file, 1, "DOC",
                    f"analysis --help does not mention rule id {rule} (the "
                    "epilog is generated from core.RULES -- keep it wired)")
            for rule in missing]


def check_cli_help() -> list[Finding]:
    """Every registered knob must appear in the CLI help text."""
    import spgemm_tpu_torch.cli as cli  # noqa: PLC0415 -- jax-free at module level

    file = rel_file(cli.__file__)
    try:
        help_text = cli.build_parser().format_help()
    except Exception as e:  # noqa: BLE001 -- a broken parser IS the finding
        return [Finding(file, 1, "DOC",
                        f"cli.build_parser() failed: {e!r}")]
    missing = [name for name in knobs.REGISTRY if name not in help_text]
    return [Finding(file, 1, "DOC",
                    f"CLI help does not mention knob {name} (the epilog is "
                    "generated by knobs.cli_epilog() -- keep it wired)")
            for name in missing]
