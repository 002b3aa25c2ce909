"""MET: metric-name registry discipline for the ENGINE timer registry.

The Prometheus surface (obs/metrics.py) and the span flight recorder both
key on the names passed to `ENGINE.phase(...)` / `ENGINE.record(...)` /
`ENGINE.incr(...)` -- an ad-hoc name at a call site would mint a new
time series that no dashboard, no generated doc table, and no alert knows
about.  This rule makes the registry binding the same way KNB does for
knobs:

  * the name argument must be a STRING LITERAL (a computed name cannot be
    audited against the registry, and per-item dynamic names are exactly
    the cardinality explosion Prometheus forbids);
  * phase()/record() names must be declared in
    `obs/metrics.ENGINE_PHASES`, incr() names in
    `obs/metrics.ENGINE_COUNTERS`.

Receiver resolution is import-based: any local alias of
`spgemm_tpu_torch.utils.timers.ENGINE` counts (`from ... import ENGINE`,
`from ... import ENGINE as timers`, `import spgemm_tpu_torch.utils.timers as t`
+ `t.ENGINE...`).  Ad-hoc PhaseTimers INSTANCES (the CLI's local driver
timers, test registries) are deliberately out of scope: only the
process-wide ENGINE feeds the scrape/trace surface.
"""

from __future__ import annotations

import ast

from spgemm_tpu_torch.analysis.core import Finding
from spgemm_tpu_torch.analysis.rules import dotted_name
from spgemm_tpu_torch.obs.metrics import ENGINE_COUNTERS, ENGINE_PHASES

TIMERS_MODULE = "spgemm_tpu_torch.utils.timers"

# method name -> (registry, registry spelling for the message)
_METHODS = {
    "phase": (ENGINE_PHASES, "obs/metrics.ENGINE_PHASES"),
    "record": (ENGINE_PHASES, "obs/metrics.ENGINE_PHASES"),
    "incr": (ENGINE_COUNTERS, "obs/metrics.ENGINE_COUNTERS"),
}


def _engine_receivers(tree: ast.AST) -> set[str]:
    """Every dotted spelling that refers to the ENGINE registry in this
    module: direct/aliased `from ...timers import ENGINE`, plus
    `<module-alias>.ENGINE` for any import of the timers module."""
    receivers: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module and node.module.endswith("utils.timers"):
                for alias in node.names:
                    if alias.name == "ENGINE":
                        receivers.add(alias.asname or alias.name)
            elif node.module and node.module.endswith("utils"):
                # `from spgemm_tpu_torch.utils import timers [as t]`
                for alias in node.names:
                    if alias.name == "timers":
                        receivers.add(f"{alias.asname or alias.name}.ENGINE")
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == TIMERS_MODULE or \
                        alias.name.endswith("utils.timers"):
                    receivers.add(f"{alias.asname or alias.name}.ENGINE")
    return receivers


def check_met(tree: ast.AST, file: str) -> list[Finding]:
    """MET over one module: undeclared or non-literal ENGINE metric
    names."""
    receivers = _engine_receivers(tree)
    if not receivers:
        return []
    findings: list[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _METHODS):
            continue
        recv = dotted_name(node.func.value)
        if recv not in receivers:
            continue
        # the name rides as the first positional OR as name= -- both
        # spellings mint the series, so both are in scope
        arg = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "name"), None)
        if arg is None:
            continue
        registry, spelled = _METHODS[node.func.attr]
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            findings.append(Finding(
                file, node.lineno, "MET",
                f"ENGINE.{node.func.attr}() metric name must be a string "
                f"literal declared in {spelled}: a computed name mints an "
                "unauditable time series (and dynamic label-by-name is "
                "the cardinality explosion the metrics registry exists "
                "to prevent)"))
        elif arg.value not in registry:
            findings.append(Finding(
                file, node.lineno, "MET",
                f"undeclared metric name {arg.value!r} in "
                f"ENGINE.{node.func.attr}(): declare it in {spelled} "
                "(spgemm_tpu_torch/obs/metrics.py) so the Prometheus surface, "
                "the flight recorder, and the generated ARCHITECTURE.md "
                "table stay in sync -- no ad-hoc series names"))
    return findings
