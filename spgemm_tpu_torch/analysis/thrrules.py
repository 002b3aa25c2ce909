"""THR: lock discipline for shared mutable state, annotation-enforced.

PRs 4-5 made the engine genuinely multi-threaded (chain plan-ahead worker,
OOC staging/landing pipeline, spgemmd executor/watchdog/conn handlers) --
exactly the shape where the multi-threaded SpGEMM literature says
accumulator/ordering bugs live.  The lock discipline used to exist only as
comments ("# ids, journal file, degrade state"); this rule makes it a
machine-checked contract:

    self._jobs = []        # spgemm-lint: guarded-by(_lock)
    _CACHE = OrderedDict() # spgemm-lint: guarded-by(_LOCK)

declares that every read/write of the attribute (instance attribute via
`self.X`, or module global via bare `X`) must happen inside a
`with self._lock:` / `with _LOCK:` block.  Accesses outside one are THR
findings.  The rule understands:

  * lock ALIASES: `self._avail = threading.Condition(self._lock)` makes
    `with self._avail:` hold the same lock (condition variables share
    their lock by construction);
  * `__init__` is exempt -- construction happens-before publication to
    any other thread;
  * methods named `*_locked` are exempt -- the suffix is the repo's
    caller-holds-the-lock convention (the caller's `with` is the guard);
  * a NESTED def or lambda inside a `with` block does NOT inherit the
    guard: its body runs later, usually on another thread (Thread targets,
    callbacks), so held locks reset to none inside it;
  * the escape hatch `# spgemm-lint: thr-ok(<reason>)` on the access line
    (or the line above) for accesses that are provably safe lock-free --
    the reason is the reviewable proof.

The annotation is deliberately opt-in per attribute: single-writer
handoff protocols (spgemmd's _current/_reaped slots) are lock-free by
design and stay unannotated, with their ordering argument in comments.
"""

from __future__ import annotations

import ast

from spgemm_tpu_torch.analysis.core import Finding, LintUnit
from spgemm_tpu_torch.analysis.rules import dotted_name

GUARD_MARKER = "spgemm-lint: guarded-by("

_CONDITION_WRAPPERS = {"Condition"}  # threading.Condition(lock) aliases lock


def guard_on_assignment(ann: dict[int, str],
                        node: ast.AST) -> str | None:
    """The guard name an annotation binds to `node` -- on ANY line the
    (possibly wrapped) assignment spans: a multi-line dict literal
    carries its comment on the closing line, and an annotation that
    silently fails to bind is worse than no annotation.  THE one
    binding rule: THR (enforcement) and TSI (the annotated-state
    exemption) must agree on it, so both call this."""
    for ln in range(node.lineno,
                    (getattr(node, "end_lineno", None) or node.lineno) + 1):
        if ln in ann:
            return ann[ln]
    return None


def _guard_annotations(comments: dict[int, str]) -> dict[int, str]:
    """1-indexed line -> declared lock name (leading `self.` stripped).
    Scans real comments only (core.comment_map), so a quoted marker in a
    docstring or message string never declares a guard."""
    out: dict[int, str] = {}
    for i, text in comments.items():
        pos = text.find(GUARD_MARKER)
        if pos < 0:
            continue
        lock = text[pos + len(GUARD_MARKER):].split(")", 1)[0].strip()
        if lock.startswith("self."):
            lock = lock[len("self."):]
        if lock:
            out[i] = lock
    return out


def _assign_targets(node: ast.AST):
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        return [node.target]
    return []


class _Scope:
    """Guarded names + lock aliases for one class (attr access via self.X)
    or one module (bare-name globals)."""

    def __init__(self):
        self.guards: dict[str, str] = {}  # name -> lock name
        self.alias: dict[str, str] = {}   # lock alias -> lock name

    def rep(self, lock: str) -> str:
        seen = set()
        while lock in self.alias and lock not in seen:
            seen.add(lock)
            lock = self.alias[lock]
        return lock

    def collect(self, body_walk, ann: dict[int, str], *,
                attr_of_self: bool) -> None:
        """Pick up guard annotations and Condition aliases from an AST
        walk (class body or module top level)."""
        def name_of(target: ast.expr) -> str | None:
            if attr_of_self:
                if (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    return target.attr
                return None
            return target.id if isinstance(target, ast.Name) else None

        for node in body_walk:
            targets = _assign_targets(node)
            if not targets:
                continue
            names = [n for n in map(name_of, targets) if n is not None]
            if not names:
                continue
            guard = guard_on_assignment(ann, node)
            if guard is not None:
                for n in names:
                    self.guards[n] = guard
            value = getattr(node, "value", None)
            if (isinstance(value, ast.Call)
                    and (dotted_name(value.func) or "").rsplit(".", 1)[-1]
                    in _CONDITION_WRAPPERS and value.args):
                arg = value.args[0]
                arg_name = name_of(arg)
                if arg_name is not None:
                    for n in names:
                        self.alias[n] = arg_name


def _local_shadows(fn: ast.AST, guarded: set[str]) -> frozenset:
    """Guarded names this function binds LOCALLY (a parameter, or assigned
    in its body without a `global` declaration): Python scoping makes
    every use of such a name refer to the local, never the guarded module
    global, so the THR check must not fire on it.  Nested defs are
    excluded -- they have their own scopes, handled on entry."""
    declared_global: set[str] = set()
    assigned: set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        assigned.update(a.arg for a in (
            args.posonlyargs + args.args + args.kwonlyargs
            + [a for a in (args.vararg, args.kwarg) if a is not None]))

    def rec(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Global):
                declared_global.update(child.names)
            elif isinstance(child, ast.Name) and isinstance(
                    child.ctx, (ast.Store, ast.Del)):
                assigned.add(child.id)
            rec(child)

    rec(fn)
    return frozenset((assigned & guarded) - declared_global)


class _AccessChecker:
    """Walk function bodies tracking held locks; report unguarded accesses
    of guarded names."""

    def __init__(self, unit: LintUnit, scope: _Scope, escapes: set[int],
                 *, attr_of_self: bool):
        self.unit = unit
        self.scope = scope
        self.escapes = escapes
        self.attr_of_self = attr_of_self
        self.findings: list[Finding] = []
        self._seen: set[tuple[int, str]] = set()
        self._shadow: frozenset = frozenset()

    def _acquired(self, item: ast.withitem) -> str | None:
        expr = item.context_expr
        if self.attr_of_self:
            if (isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"):
                return self.scope.rep(expr.attr)
            return None
        if isinstance(expr, ast.Name):
            return self.scope.rep(expr.id)
        return None

    def _accessed_name(self, node: ast.AST) -> str | None:
        if self.attr_of_self:
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "self"
                    and node.attr in self.scope.guards):
                return node.attr
            return None
        if (isinstance(node, ast.Name) and node.id in self.scope.guards
                and node.id not in self._shadow):
            return node.id
        return None

    def check_function(self, fn: ast.AST) -> None:
        if not self.attr_of_self:
            self._shadow = _local_shadows(fn, set(self.scope.guards))
        for stmt in fn.body:
            self._visit(stmt, frozenset())

    def _visit(self, node: ast.AST, held: frozenset) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = set()
            for item in node.items:
                self._visit(item.context_expr, held)
                lock = self._acquired(item)
                if lock is not None:
                    acquired.add(lock)
            inner = held | acquired
            for stmt in node.body:
                self._visit(stmt, inner)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # a nested def/lambda runs LATER, usually on another thread
            # (Thread target, callback): the enclosing `with` does not
            # protect it -- held locks reset to none inside.  Shadowing
            # accumulates: a name local to ANY enclosing scope (or bound
            # here) is a closure variable, not the guarded global
            for dec in getattr(node, "decorator_list", ()):
                self._visit(dec, held)
            outer_shadow = self._shadow
            if not self.attr_of_self:
                self._shadow = outer_shadow | _local_shadows(
                    node, set(self.scope.guards))
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                self._visit(stmt, frozenset())
            self._shadow = outer_shadow
            return
        name = self._accessed_name(node)
        if name is not None:
            lock = self.scope.rep(self.scope.guards[name])
            line = node.lineno
            if (lock not in held and (line, name) not in self._seen
                    and line not in self.escapes
                    and line - 1 not in self.escapes):
                self._seen.add((line, name))
                spelled = f"self.{name}" if self.attr_of_self else name
                lock_spelled = f"self.{lock}" if self.attr_of_self else lock
                self.findings.append(Finding(
                    self.unit.file, line, "THR",
                    f"`{spelled}` is declared guarded-by({lock}) but is "
                    f"accessed outside a `with {lock_spelled}:` block "
                    "(worker/watchdog/handler threads share this state); "
                    "hold the lock, or escape with "
                    "`# spgemm-lint: thr-ok(<reason>)` if lock-free access "
                    "is provably safe here"))
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)


def _exempt(fn_name: str, *, attr_of_self: bool) -> bool:
    # *_locked is the caller-holds-the-lock convention (both scopes);
    # __init__ is exempt ONLY for the instance's own attributes -- it runs
    # before the OBJECT is published to any other thread, but a module
    # global is already published to every thread while __init__ runs
    if fn_name.endswith("_locked"):
        return True
    return attr_of_self and fn_name == "__init__"


def check_thr(unit: LintUnit, escapes: set[int]) -> list[Finding]:
    """THR over one unit: class-attribute guards and module-global guards."""
    tree = unit.tree
    ann = _guard_annotations(unit.comments)
    findings: list[Finding] = []
    if not ann:
        return findings

    # ---- class-attribute guards (self.X) --------------------------------
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        scope = _Scope()
        scope.collect(ast.walk(cls), ann, attr_of_self=True)
        if not scope.guards:
            continue
        for item in cls.body:
            if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and not _exempt(item.name, attr_of_self=True)):
                checker = _AccessChecker(unit, scope, escapes,
                                         attr_of_self=True)
                checker.check_function(item)
                findings += checker.findings

    # ---- module-global guards (bare names) ------------------------------
    scope = _Scope()
    scope.collect(ast.iter_child_nodes(tree), ann, attr_of_self=False)
    if scope.guards:
        for node in _outer_functions(tree):
            if not _exempt(node.name, attr_of_self=False):
                checker = _AccessChecker(unit, scope, escapes,
                                         attr_of_self=False)
                checker.check_function(node)
                findings += checker.findings
    return findings


def _outer_functions(tree: ast.AST) -> list[ast.AST]:
    """Outermost function defs (module level, class methods, any nesting
    of classes/ifs -- but NOT defs nested in other defs: the access
    checker recurses into those itself, with held locks reset)."""
    out: list[ast.AST] = []

    def rec(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(child)
            else:
                rec(child)

    rec(tree)
    return out
