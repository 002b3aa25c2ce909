"""Interprocedural FLD: fold-order taint through the intra-package call graph.

The per-module FLD rule (rules.check_fld) is syntactic and module-scoped:
a numeric-path module could "hide the index_add_ in utils/" by calling a
helper in a non-numeric module.  This pass closes that hole.  Over the
whole lint run's file set it builds a torch-free call graph -- module-level
functions, class methods, and the imports that name them -- marks every
function that DIRECTLY performs an unordered reduction (rules.fld_violation
on the spelled call name, minus reductions escaped at source with
`# spgemm-lint: fld-proof(<reason>)`), propagates that taint along resolved
call edges, and flags every call site in a NUMERIC module whose callee
lives in a non-numeric module and (transitively) reaches a reduction.  The
finding lands at the call site -- where a reviewer would look -- and names
the witness chain down to the reduction's file:line.

Resolution is deliberately name-based (the same trade the per-module rules
make: the spelled form is the form): `from pkg.mod import f` / `import
pkg.mod as m; m.f(...)` / same-module `f(...)` / `self.method(...)` within
a class all resolve; attribute calls on arbitrary objects do not.  A bare
`import x` resolves by module-path suffix only when `x` is not a stdlib
module name, so `import queue` can never alias serve/queue.py.  Everything
is stdlib-only ast -- no imports are executed.
"""

from __future__ import annotations

import ast
import sys
from dataclasses import dataclass, field

from spgemm_tpu_torch.analysis.core import Finding, LintUnit
from spgemm_tpu_torch.analysis.rules import dotted_name, fld_violation

_STDLIB = getattr(sys, "stdlib_module_names", frozenset())


@dataclass
class _Func:
    """One function or method: its direct (unescaped) reductions and the
    spelled calls it makes."""

    module: str                # dotted module of the defining unit
    label: str                 # "f" or "Cls.method"
    file: str
    reductions: list[tuple[int, str]] = field(default_factory=list)
    calls: list[tuple[int, str, str | None]] = field(default_factory=list)
    # calls: (lineno, spelled name, enclosing class or None)


@dataclass
class _Module:
    module: str
    unit: LintUnit
    # local import name -> list of resolution candidates, each either
    # ("mod", dotted_module) or ("member", dotted_module, member_name)
    imports: dict = field(default_factory=dict)
    funcs: dict = field(default_factory=dict)       # label -> _Func
    toplevel_calls: list = field(default_factory=list)
    used_escapes: set = field(default_factory=set)  # taint-suppressing lines
    classes: set = field(default_factory=set)       # class names defined here
    # module-level singleton instances: `ENGINE = PhaseTimers()` makes
    # `ENGINE.incr(...)` resolve to PhaseTimers.incr -- the repo's
    # process-wide registries (timers.ENGINE, trace.RECORDER, events.LOG)
    # are exactly this shape, and the concurrency pass needs their lock
    # acquisitions visible through the singleton spelling
    singletons: dict = field(default_factory=dict)  # local name -> class name


def _module_name(unit: LintUnit) -> str:
    name = unit.file
    if name.endswith(".py"):
        name = name[:-3]
    name = name.replace("/", ".")
    if name.endswith(".__init__"):
        name = name[: -len(".__init__")]
    return name


def _collect(unit: LintUnit) -> _Module:
    mod = _Module(_module_name(unit), unit)
    fld_escape_lines = set(unit.escapes["FLD"])
    used_escapes: set[int] = set()

    def add_import(node: ast.AST) -> None:
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".", 1)[0]
                target = alias.name if alias.asname else alias.name.split(
                    ".", 1)[0]
                mod.imports.setdefault(local, []).append(("mod", target))
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                local = alias.asname or alias.name
                mod.imports.setdefault(local, []).extend([
                    ("member", node.module, alias.name),
                    ("mod", f"{node.module}.{alias.name}"),
                ])

    def visit(node: ast.AST, func: _Func | None, cls: str | None) -> None:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            add_import(node)
            return
        if isinstance(node, ast.ClassDef):
            mod.classes.add(node.name)
            for child in ast.iter_child_nodes(node):
                visit(child, func, node.name)
            return
        if (isinstance(node, ast.Assign) and func is None and cls is None
                and isinstance(node.value, ast.Call)):
            # module-level singleton: NAME = Cls(...) with Cls defined in
            # this module (class defs precede their instantiation in file
            # order, so one pass sees them)
            cls_name = (dotted_name(node.value.func) or "").rsplit(".", 1)[-1]
            if cls_name in mod.classes:
                for target in node.targets:
                    if isinstance(target, ast.Name):
                        mod.singletons[target.id] = cls_name
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            label = f"{cls}.{node.name}" if cls else node.name
            # a nested def folds into its enclosing function's info (it
            # runs, at the latest, when the enclosing scope wires it up)
            f = func if func is not None else _Func(mod.module, label,
                                                    unit.file)
            if func is None:
                mod.funcs[label] = f
            for child in ast.iter_child_nodes(node):
                visit(child, f, cls)
            return
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name is not None:
                if fld_violation(name) is not None:
                    if (node.lineno in fld_escape_lines
                            or node.lineno - 1 in fld_escape_lines):
                        # a source-escaped reduction: suppresses taint,
                        # and the escape is therefore USED (audit)
                        used_escapes.add(
                            node.lineno if node.lineno in fld_escape_lines
                            else node.lineno - 1)
                    elif func is not None:
                        func.reductions.append((node.lineno, name))
                if func is not None:
                    func.calls.append((node.lineno, name, cls))
                else:
                    mod.toplevel_calls.append((node.lineno, name, cls))
        for child in ast.iter_child_nodes(node):
            visit(child, func, cls)

    for child in ast.iter_child_nodes(unit.tree):
        visit(child, None, None)
    mod.used_escapes = used_escapes
    return mod


class _Graph:
    def __init__(self, modules: list[_Module]):
        self.by_name: dict[str, _Module] = {m.module: m for m in modules}
        # suffix index for bare-name module resolution (non-stdlib only)
        self.by_tail: dict[str, list[str]] = {}
        for m in modules:
            tail = m.module.rsplit(".", 1)[-1]
            self.by_tail.setdefault(tail, []).append(m.module)
        self._taint_memo: dict[tuple[str, str], tuple | None] = {}

    def _resolve_module(self, dotted: str) -> _Module | None:
        m = self.by_name.get(dotted)
        if m is not None:
            return m
        # bare, non-stdlib names may resolve by path suffix (fixtures and
        # scripts lint under paths like tests.lint_fixtures.hosthelper but
        # import each other by bare name)
        if "." not in dotted and dotted not in _STDLIB:
            cands = self.by_tail.get(dotted, ())
            if len(cands) == 1:
                return self.by_name[cands[0]]
        return None

    def _lookup(self, module: _Module, label: str) -> _Func | None:
        f = module.funcs.get(label)
        if f is not None:
            return f
        # class instantiation: a call spelled `Cls(...)` (or resolving to
        # the class name) executes Cls.__init__
        if "." not in label and label in module.classes:
            return module.funcs.get(f"{label}.__init__")
        return None

    def _lookup_singleton(self, module: _Module, inst: str,
                          method: str) -> _Func | None:
        cls_name = module.singletons.get(inst)
        if cls_name is None:
            return None
        return module.funcs.get(f"{cls_name}.{method}")

    def resolve(self, module: _Module, name: str,
                cls: str | None) -> _Func | None:
        """Spelled call name -> defining _Func, or None."""
        parts = name.split(".")
        head, rest = parts[0], parts[1:]
        if head == "self" and cls is not None and len(rest) == 1:
            return self._lookup(module, f"{cls}.{rest[0]}")
        for kind, *info in module.imports.get(head, ()):
            if kind == "member" and not rest:
                target = self._resolve_module(info[0])
                if target is not None:
                    f = self._lookup(target, info[1])
                    if f is not None:
                        return f
            elif kind == "member" and len(rest) == 1:
                # imported singleton: `from ...timers import ENGINE;
                # ENGINE.incr(...)`
                target = self._resolve_module(info[0])
                if target is not None:
                    f = self._lookup_singleton(target, info[1], rest[0])
                    if f is not None:
                        return f
            elif kind == "mod" and rest:
                target = self._resolve_module(
                    ".".join([info[0]] + rest[:-1]))
                if target is not None:
                    f = self._lookup(target, rest[-1])
                    if f is not None:
                        return f
                if len(rest) >= 2:
                    # module-attribute singleton: `import ...timers as t;
                    # t.ENGINE.incr(...)` / `obs_events.LOG.emit(...)`
                    target = self._resolve_module(
                        ".".join([info[0]] + rest[:-2]))
                    if target is not None:
                        f = self._lookup_singleton(target, rest[-2],
                                                   rest[-1])
                        if f is not None:
                            return f
        if not rest:
            # same-module function (or Class.method spelled directly)
            return self._lookup(module, head)
        if len(rest) == 1:
            # same-module singleton: `LOG.emit(...)` under `LOG = EventLog()`
            f = self._lookup_singleton(module, head, rest[0])
            if f is not None:
                return f
        # fully-dotted spelling against the module set, longest prefix
        for split in range(len(parts) - 1, 0, -1):
            target = self.by_name.get(".".join(parts[:split]))
            if target is not None:
                return self._lookup(target, ".".join(parts[split:]))
        # Class.method within the same module
        if len(parts) == 2:
            return self._lookup(module, name)
        return None

    def taint(self, func: _Func) -> tuple | None:
        """Witness that func transitively performs an unordered reduction:
        (chain labels, reduction file, line, spelled name); None if clean.

        Memoized, but cycle-safe: a clean verdict computed while the walk
        was inside a call cycle is provisional (the on-stack ancestor's
        taint was unknown at the time), so only witnesses and
        cycle-independent Nones are cached -- naively caching the
        in-progress None would finalize an ancestor as clean even when its
        only route to a reduction runs through the cycle."""
        witness, _ = self._taint(func, set())
        return witness

    def _taint(self, func: _Func, stack: set) -> tuple:
        """(witness, provisional): provisional=True means the clean verdict
        depended on an on-stack node and must not be memoized."""
        key = (func.module, func.label)
        if key in self._taint_memo:
            return self._taint_memo[key], False
        if key in stack:
            return None, True  # cycle edge: the ancestor decides
        if func.reductions:
            line, name = func.reductions[0]
            witness = ([func.label], func.file, line, name)
            self._taint_memo[key] = witness
            return witness, False
        stack.add(key)
        witness = None
        provisional = False
        module = self.by_name[func.module]
        for _lineno, name, cls in func.calls:
            callee = self.resolve(module, name, cls)
            if callee is None:
                continue
            w, p = self._taint(callee, stack)
            provisional = provisional or p
            if w is not None:
                witness = ([func.label] + w[0], w[1], w[2], w[3])
                break
        stack.discard(key)
        if witness is not None or not provisional:
            self._taint_memo[key] = witness
        return witness, witness is None and provisional


def build(units: list[LintUnit]) -> tuple[list, "_Graph"]:
    """Collect the whole-program (modules, graph) pair ONCE per lint
    run: this pass and the LCK/BLK/TSI concurrency pass (lockrules)
    both walk the same resolved call graph, and rebuilding it per pass
    doubles the dominant AST-walk cost of `make lint`."""
    modules = [_collect(u) for u in units if u.tree is not None]
    return modules, _Graph(modules)


def check(units: list[LintUnit], *,
          prebuilt: tuple | None = None) -> tuple[list[Finding],
                                                  list[Finding],
                                                  set[tuple[str, int]]]:
    """The interprocedural pass over one lint run's unit set.

    Returns (findings, raw_findings, used_source_escapes): findings honor
    call-site `fld-proof` escapes, raw_findings ignore them (the
    suppression audit derives escape usage from the difference), and
    used_source_escapes are (file, line) of escapes that suppressed a
    reduction at its source, which keeps the callee untainted -- also
    "used" for the audit.  prebuilt: a build(units) result to reuse."""
    modules, graph = prebuilt if prebuilt is not None else build(units)
    findings: list[Finding] = []
    raw: list[Finding] = []
    used: set[tuple[str, int]] = set()
    for m in modules:
        for line in m.used_escapes:
            used.add((m.unit.file, line))
    for m in modules:
        if not m.unit.numeric:
            continue
        escapes = set(m.unit.escapes["FLD"])
        calls = list(m.toplevel_calls)
        for func in m.funcs.values():
            calls.extend(func.calls)
        seen: set[tuple[int, str]] = set()
        for lineno, name, cls in sorted(calls):
            callee = graph.resolve(m, name, cls)
            if callee is None or callee.module == m.module:
                continue
            callee_unit_numeric = graph.by_name[callee.module].unit.numeric
            if callee_unit_numeric:
                continue  # the reduction is flagged (or escaped) at source
            w = graph.taint(callee)
            if w is None or (lineno, name) in seen:
                continue
            seen.add((lineno, name))
            chain, red_file, red_line, red_name = w
            f = Finding(
                m.unit.file, lineno, "FLD",
                f"`{name}` reaches an unordered reduction outside the "
                f"numeric modules: {' -> '.join(chain)} -> `{red_name}` "
                f"({red_file}:{red_line}); fold order is load-bearing on "
                "the numeric path (SURVEY.md 2.9) -- make the helper "
                "order-preserving, prove it at the source with "
                "fld-proof(<reason>), or escape this call site")
            raw.append(f)
            if lineno not in escapes and lineno - 1 not in escapes:
                findings.append(f)
    return findings, raw, used
