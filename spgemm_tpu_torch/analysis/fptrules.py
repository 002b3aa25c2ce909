"""FPT: failpoint-name registry discipline for utils/failpoints.check.

The chaos harness arms injection points BY NAME (SPGEMM_TPU_FAILPOINTS),
so a `failpoints.check("...")` site whose name is not declared in the
`utils/failpoints.py` registry is dead chaos surface -- unarmed forever,
silently -- and a computed name cannot be audited at all.  Symmetrically,
a REGISTRY entry with no live call site is a failpoint an operator can
arm that injects nothing: the chaos run "passes" without ever faulting
that path.  This rule makes the registry binding both ways, the MET
pattern applied to fault injection:

  * per file (`check_fpt`): the name argument of every
    `failpoints.check(...)` call must be a string literal declared in
    the registry;
  * package level (`check_fpt_registry`, run by core.lint_report when
    the registry module itself is in the linted unit set): every
    registry entry must have at least one literal call site somewhere in
    the unit set -- a stale entry is a finding at its declaration line.

Receiver resolution is import-based like MET: any alias of the
failpoints module (`from spgemm_tpu_torch.utils import failpoints [as fp]`,
`import spgemm_tpu_torch.utils.failpoints as f`) or of the function itself
(`from ...failpoints import check [as c]`) counts.
"""

from __future__ import annotations

import ast

from spgemm_tpu_torch.analysis.core import Finding
from spgemm_tpu_torch.analysis.rules import dotted_name
from spgemm_tpu_torch.utils.failpoints import REGISTRY

FAILPOINTS_MODULE = "spgemm_tpu_torch.utils.failpoints"
FAILPOINTS_SUFFIX = "/utils/failpoints.py"


def _receivers(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(dotted module-spellings whose `.check` is the failpoint check,
    bare function-name spellings that ARE the check)."""
    modules: set[str] = set()
    funcs: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module and node.module.endswith("utils.failpoints"):
                for alias in node.names:
                    if alias.name == "check":
                        funcs.add(alias.asname or alias.name)
            elif node.module and node.module.endswith("utils"):
                # `from spgemm_tpu_torch.utils import failpoints [as fp]`
                for alias in node.names:
                    if alias.name == "failpoints":
                        modules.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == FAILPOINTS_MODULE or \
                        alias.name.endswith("utils.failpoints"):
                    modules.add(alias.asname or alias.name)
    return modules, funcs


def _check_calls(tree: ast.AST):
    """Yield (call node, name argument node) for every failpoint check
    call in the module."""
    modules, funcs = _receivers(tree)
    if not modules and not funcs:
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        hit = (isinstance(f, ast.Attribute) and f.attr == "check"
               and dotted_name(f.value) in modules) \
            or (isinstance(f, ast.Name) and f.id in funcs)
        if not hit:
            continue
        arg = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "name"), None)
        yield node, arg


def check_fpt(tree: ast.AST, file: str) -> list[Finding]:
    """FPT over one module: undeclared or non-literal failpoint names."""
    findings: list[Finding] = []
    for node, arg in _check_calls(tree):
        if arg is None:
            continue
        if not (isinstance(arg, ast.Constant)
                and isinstance(arg.value, str)):
            findings.append(Finding(
                file, node.lineno, "FPT",
                "failpoints.check() name must be a string literal "
                "declared in the spgemm_tpu_torch/utils/failpoints.py registry: "
                "a computed name cannot be audited against the registry "
                "(and can never be armed deliberately)"))
        elif arg.value not in REGISTRY:
            findings.append(Finding(
                file, node.lineno, "FPT",
                f"undeclared failpoint {arg.value!r} in "
                "failpoints.check(): declare it in the "
                "spgemm_tpu_torch/utils/failpoints.py registry (name, kind, "
                "site module, doc) so the chaos spec, the triggered "
                "metric and the FPT stale-entry check stay in sync"))
    return findings


def literal_names(tree: ast.AST) -> set[str]:
    """The string-literal failpoint names checked in one module (the
    package-level stale-entry pass's per-unit contribution)."""
    names: set[str] = set()
    for _, arg in _check_calls(tree):
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            names.add(arg.value)
    return names


def check_fpt_registry(units) -> list[Finding]:
    """The reverse direction, over the whole unit set: a registry entry
    no `failpoints.check` site names is a stale failpoint (armable,
    injects nothing).  Runs only when the registry module itself is
    among the linted units (the default self-lint scope) -- fixture runs
    over partial trees must not see every entry as stale."""
    registry_unit = next(
        (u for u in units
         if u.path.replace("\\", "/").endswith(FAILPOINTS_SUFFIX)), None)
    if registry_unit is None or registry_unit.tree is None:
        return []
    seen: set[str] = set()
    for u in units:
        if u.tree is not None and u is not registry_unit:
            seen |= literal_names(u.tree)
    findings: list[Finding] = []
    src_lines = registry_unit.source.splitlines()
    for name in sorted(set(REGISTRY) - seen):
        line = next((i + 1 for i, text in enumerate(src_lines)
                     if f'"{name}"' in text), 1)
        findings.append(Finding(
            registry_unit.file, line, "FPT",
            f"stale failpoint registry entry {name!r}: no "
            "failpoints.check() site names it anywhere in the package -- "
            "arming it injects nothing; wire the site (module "
            f"{REGISTRY[name].module}) or delete the entry"))
    return findings
