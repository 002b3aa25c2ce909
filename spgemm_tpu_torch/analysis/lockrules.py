"""Whole-program concurrency soundness: LCK / BLK / TSI.

PRs 12-13 multiplied spgemmd's thread population (per-slice executors,
watchdog, recovery probes, drain handlers, the event-log writer, the
plan-ahead and OOC workers) and the THR rule only protects attributes
someone remembered to annotate; nothing checked lock ACQUISITION ORDER or
what runs WHILE a lock is held -- exactly the hang/deadlock class the
chaos harness (PR 13) can only probe dynamically, one seed at a time.
This pass closes it statically, over the same torch-free call graph the
interprocedural FLD taint uses (analysis/callgraph.py):

  LCK  lock-order deadlock detection.  Every `with <lock>:` on a
       REGISTERED lock (an attribute/global assigned threading.Lock /
       RLock / Condition / Semaphore; Condition(lock) aliases its lock,
       like THR) is an acquisition; an acquisition while another
       registered lock is held -- directly nested, or transitively
       through resolved call edges -- is an order edge.  A cycle in the
       order graph is a potential deadlock, reported with the witness
       chains that acquire the locks in opposite orders; a SELF-edge
       (re-acquiring a lock already held) is the non-reentrant
       threading.Lock self-deadlock -- RLock is exempt from the
       self-edge (same-thread re-entry is its documented use-case) but
       still participates in order cycles.  Lock identity is per class
       attribute / module global (two instances of one class share a
       node -- the deliberate over-approximation every static lock-order
       tool makes).  Escape: `# spgemm-lint: lck-ok(<reason>)` on the
       finding's anchor line.

  BLK  blocking-under-lock.  A blocking operation -- time.sleep,
       subprocess.run/call/check_*, fcntl.flock, os.fsync,
       select.select, socket accept/recv/sendall,
       torch.cuda.synchronize and a stream's or event's .synchronize(),
       the torch.distributed collectives (all_gather, all_reduce,
       barrier, ...) and a rendezvous store's get/wait, and (via the
       registered-resource map)
       Queue.get/put, Thread.join, Event/Condition.wait and
       Lock/Semaphore.acquire -- reached while a registered lock is held
       is a finding with the witness chain down to the blocking call.
       `Condition.wait` is exempt for the condition's OWN lock (wait
       releases it); every OTHER held lock stays held across the wait
       and counts.  Plain file read/write is deliberately NOT in the set
       (the journal writes under the daemon lock are the durability
       contract); fsync/flock are.  Escape:
       `# spgemm-lint: blk-ok(<reason>)` -- on the blocking line itself
       (a source escape: callers stop seeing the op, like fld-proof at a
       reduction) or on the call site the finding lands on.

  TSI  thread-shared inference -- THR's opt-in hole, closed.  Functions
       passed to `threading.Thread(target=...)` (including through the
       repo's loop-over-(target, name)-tuples spelling, and including
       NESTED defs, which get their own records -- a closure spawned
       from `__init__` does not inherit its happens-before-publication
       write exemption) are THREAD ROOTS; a root spawned inside a loop
       that does not rebind the target, or from >= 2 distinct sites,
       is MULTI-INSTANCE and counts as two threads by itself (the
       accept loop's per-connection handler).  An instance attribute or
       module global WRITTEN (outside `__init__`) from functions
       reached by >= 2 root-weighted threads without a
       `# spgemm-lint: guarded-by(<lock>)` annotation is a finding: the
       state is demonstrably multi-thread-written, so it must either be
       annotated (and THR then enforces the lock) or carry a reasoned
       `# spgemm-lint: tsi-ok(<reason>)` on the write line (the
       single-writer-handoff argument, made reviewable).  Registered
       synchronization resources themselves are exempt.

Resolution is the call graph's name-based trade (spelled forms resolve;
attribute calls on arbitrary objects do not), extended with module-level
singleton instances (`ENGINE = PhaseTimers()`) and class instantiation
(`Cls(...)` -> `Cls.__init__`) so the process-wide registries' locks are
visible through their real spellings.  Everything is stdlib ast -- no
imports execute, no environment is read.

The thread-inventory table in ARCHITECTURE.md (between the
`<!-- thread-inventory:begin/end -->` markers) is GENERATED from this
pass over the default lint scope -- root function, spawner, locks it may
hold, shared attrs it writes -- and held current by the DOC rule exactly
like the knob and metrics tables.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from spgemm_tpu_torch.analysis import callgraph
from spgemm_tpu_torch.analysis.core import Finding, LintUnit
from spgemm_tpu_torch.analysis.core import escape_at as core_escape_at
from spgemm_tpu_torch.analysis.rules import dotted_name
from spgemm_tpu_torch.analysis.thrrules import (_guard_annotations,
                                          guard_on_assignment)

# ------------------------------------------------ registered resources ----
# factory last-name -> resource kind (namespace-agnostic, like the THR
# Condition detection: `threading.Lock()`, `Lock()` after a from-import,
# and `mp.Lock()` all register)
_FACTORY_KINDS = {
    "Lock": "lock", "RLock": "rlock",
    "Condition": "cond",
    "Semaphore": "sem", "BoundedSemaphore": "sem",
    "Event": "event",
    "Queue": "queue", "LifoQueue": "queue", "PriorityQueue": "queue",
    "SimpleQueue": "queue",
    "Thread": "thread",
    "socket": "socket",
    # threading.local(): per-thread by construction -- registered so
    # TSI exempts writes through it like the other sync resources
    "local": "tlocal",
}
# `with <x>:` acquires these; rlock participates in ORDER edges (an
# RLock in a cycle deadlocks like any lock) but is exempt from the
# self-edge finding (same-thread re-acquisition is its documented
# use-case, never a deadlock)
_ACQUIRABLE = ("lock", "rlock", "cond", "sem")

# always-blocking calls by exact spelled name
BLOCKING_CALLS = {
    "time.sleep",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output",
    "fcntl.flock",
    "os.fsync",
    "select.select",
    # the host waits for every launch queued on the card
    "torch.cuda.synchronize",
    # collectives block until every rank of the group arrives: a lock
    # held across one is held for as long as the slowest rank takes
    # (parallel/multihost.py's exchange)
    "torch.distributed.all_gather", "torch.distributed.all_gather_object",
    "torch.distributed.all_reduce", "torch.distributed.broadcast",
    "torch.distributed.broadcast_object_list", "torch.distributed.barrier",
    "torch.distributed.monitored_barrier", "torch.distributed.gather",
    "torch.distributed.scatter", "torch.distributed.reduce",
    "torch.distributed.reduce_scatter",
    "torch.distributed.reduce_scatter_tensor",
    "torch.distributed.all_to_all", "torch.distributed.send",
    "torch.distributed.recv",
    "torch.distributed.init_process_group",
}
# blocking method names on ANY base object (unambiguous spellings only:
# `.get`/`.put`/`.join`/`.wait`/`.acquire` need a typed base -- dict.get,
# str.join and os.path.join would drown the rule in false positives)
BLOCKING_METHODS = {"accept", "recv", "recv_into", "recvfrom", "sendall",
                    "synchronize"}
# a rendezvous store's get/wait block until another rank sets the key;
# `.get`/`.wait` are ambiguous on arbitrary bases, so they count only on
# a base whose last name is `store` or ends in `_store` (`self._store`)
STORE_BLOCKING_METHODS = {"get", "wait"}
# blocking methods gated on the base resolving to a registered resource
_TYPED_BLOCKING = {
    "queue": {"get", "put"},
    "thread": {"join"},
    "event": {"wait"},
    "cond": {"wait"},
    "lock": {"acquire"},
    "rlock": {"acquire"},
    "sem": {"acquire"},
    "socket": {"accept", "recv", "sendall", "connect"},
}


@dataclass
class _Resource:
    kind: str
    alias: str | None = None   # Condition(lock): the aliased lock attr


@dataclass
class _FnInfo:
    """Per-function concurrency facts.  Named nested defs get their own
    records (labeled `outer.name`) so they can be thread roots and keep
    their own write/escape context; lambdas fold into the outer record
    with held locks reset."""

    module: str
    label: str
    file: str
    # (line, lock id, held-before tuple)
    acquisitions: list = field(default_factory=list)
    # (line, spelled name, enclosing class, held tuple)
    calls: list = field(default_factory=list)
    # (line, op spelling, effective-held tuple, escape line | None,
    #  released lock id | None)
    blocks: list = field(default_factory=list)
    # (line, attr key, escaped) -- shared-state writes outside __init__
    writes: list = field(default_factory=list)


@dataclass
class _RootSite:
    """One resolved-or-not thread-entry reference: the spelled target of
    a threading.Thread(...) call, with the spawning function."""

    spelled: str
    cls: str | None
    spawner: str        # label of the function creating the thread
    file: str
    line: int
    # pre-resolved intra-module label (a NESTED def passed as target:
    # the call graph cannot name it, the walker that saw the def can)
    label: str | None = None
    # the spawn sits inside a loop whose iteration does not rebind the
    # target: the SAME function runs on many threads (the accept loop's
    # per-connection handler), so one root already means >= 2 threads
    multi: bool = False


class _ModInfo:
    """One module's resource registry + per-function facts."""

    def __init__(self, unit: LintUnit, module: str):
        self.unit = unit
        self.module = module
        self.file = unit.file
        self.class_res: dict[str, dict[str, _Resource]] = {}
        self.module_res: dict[str, _Resource] = {}
        self.module_globals: set[str] = set()
        # import aliases: local name -> canonical dotted prefix, so
        # `from time import sleep` / `import subprocess as sp` still
        # hit the always-blocking set (BLOCKING_CALLS stores canonical
        # spellings)
        self.aliases: dict[str, str] = {}
        self.fns: dict[str, _FnInfo] = {}
        self.roots: list[_RootSite] = []
        # guard-annotated attr names, per scope (class name or None for
        # module globals) -- TSI skips them (THR owns annotated state)
        self.annotated: dict[str | None, set[str]] = {}
        self.used_escapes: set[tuple[str, int]] = set()  # (rule, line)

    # ---------------------------------------------------- lock identity --
    def _rep_attr(self, scope: dict[str, _Resource], name: str) -> str:
        seen = set()
        while name in scope and scope[name].alias and name not in seen:
            seen.add(name)
            name = scope[name].alias
        return name

    def lock_id(self, cls: str | None, name: str) -> str | None:
        """Global id for an acquirable resource spelled `self.<name>` (in
        class cls) or bare `<name>` (module global); None if unregistered."""
        scope = self.class_res.get(cls, {}) if cls is not None \
            else self.module_res
        res = scope.get(name)
        if res is None or res.kind not in _ACQUIRABLE:
            return None
        rep = self._rep_attr(scope, name)
        owner = f"{self.module}.{cls}" if cls is not None else self.module
        return f"{owner}.{rep}"

    def resource_of(self, cls: str | None, base: str,
                    local_kinds: dict[str, str]) -> _Resource | None:
        """Resource record for a call base: `self.X` (class attr), bare
        `X` (function local, then module global)."""
        if base.startswith("self.") and cls is not None:
            return self.class_res.get(cls, {}).get(base[len("self."):])
        if "." not in base:
            kind = local_kinds.get(base)
            if kind is not None:
                return _Resource(kind)
            return self.module_res.get(base)
        return None


def _res_of_value(value: ast.expr) -> _Resource | None:
    if not isinstance(value, ast.Call):
        return None
    name = dotted_name(value.func)
    if name is None:
        return None
    kind = _FACTORY_KINDS.get(name.rsplit(".", 1)[-1])
    if kind is None:
        return None
    alias = None
    if kind == "cond" and value.args:
        arg = value.args[0]
        arg_name = dotted_name(arg)
        if arg_name is not None:
            alias = arg_name[len("self."):] \
                if arg_name.startswith("self.") else arg_name
    return _Resource(kind, alias)


def _assign_pairs(node: ast.AST):
    """(target, value) pairs for Assign/AnnAssign nodes."""
    if isinstance(node, ast.Assign) and node.value is not None:
        return [(t, node.value) for t in node.targets]
    if isinstance(node, ast.AnnAssign) and node.value is not None:
        return [(node.target, node.value)]
    return []


def _self_attr(node: ast.expr) -> str | None:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _collect_resources(mod: _ModInfo) -> None:
    """Registered synchronization resources + guard annotations, per class
    and at module level."""
    tree = mod.unit.tree
    ann = _guard_annotations(mod.unit.comments)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mod.aliases[a.asname] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                mod.aliases[a.asname or a.name] = \
                    f"{node.module}.{a.name}"

    def spans_annotation(node: ast.AST) -> bool:
        # the SAME binding rule THR enforces with (thrrules): TSI's
        # annotated-state exemption and THR's guard binding must agree
        return guard_on_assignment(ann, node) is not None

    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        attrs: dict[str, _Resource] = {}
        annotated: set[str] = set()
        for node in ast.walk(cls):
            for target, value in _assign_pairs(node):
                name = _self_attr(target)
                if name is None:
                    continue
                res = _res_of_value(value)
                if res is not None:
                    attrs[name] = res
                if spans_annotation(node):
                    annotated.add(name)
        mod.class_res[cls.name] = attrs
        mod.annotated[cls.name] = annotated

    def module_scope(node: ast.AST):
        # every statement executed at MODULE scope: descend through
        # try/if/with nesting (conditionally-defined locks and guarded
        # globals are real), never into function or class bodies
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            yield child
            yield from module_scope(child)

    annotated_mod: set[str] = set()
    for node in module_scope(tree):
        for target, value in _assign_pairs(node):
            if not isinstance(target, ast.Name):
                continue
            mod.module_globals.add(target.id)
            res = _res_of_value(value)
            if res is not None:
                mod.module_res[target.id] = res
            if spans_annotation(node):
                annotated_mod.add(target.id)
    mod.annotated[None] = annotated_mod


def _local_binds(fn: ast.AST) -> set[str]:
    """Names bound locally in fn (params + assignments, nested defs
    excluded) -- a bare-name write to one of these is a local, never a
    module global."""
    out: set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        out.update(a.arg for a in (
            args.posonlyargs + args.args + args.kwonlyargs
            + [a for a in (args.vararg, args.kwarg) if a is not None]))

    def rec(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            if isinstance(child, ast.Name) and isinstance(
                    child.ctx, (ast.Store, ast.Del)):
                out.add(child.id)
            rec(child)

    rec(fn)
    return out


def _declared_globals(fn: ast.AST) -> set[str]:
    return {name for node in ast.walk(fn) if isinstance(node, ast.Global)
            for name in node.names}


def _harvest_refs(expr: ast.expr) -> list[str]:
    """Every spelled Attribute/Name reference inside expr (Load ctx) --
    the thread-target candidates hiding in a tuple literal the spawn loop
    iterates (`for target, name in ((self._accept_loop, ...), ...)`).
    A call's FUNCTION is skipped: in `t = pick(worker_a, worker_b)` the
    candidates are the arguments, not `pick` itself (which runs
    synchronously on the spawning thread, never as a thread)."""
    out: list[str] = []

    def rec(node: ast.AST) -> None:
        if isinstance(node, ast.Call):
            for child in list(node.args) \
                    + [kw.value for kw in node.keywords]:
                rec(child)
            return
        if isinstance(node, (ast.Attribute, ast.Name)) \
                and isinstance(getattr(node, "ctx", None), ast.Load):
            name = dotted_name(node)
            if name is not None and name not in out:
                out.append(name)
        for child in ast.iter_child_nodes(node):
            rec(child)

    rec(expr)
    return out


def _binds_name(target: ast.expr, name: str) -> bool:
    for node in ast.walk(target):
        if isinstance(node, ast.Name) and node.id == name:
            return True
    return False


def _flatten_targets(target: ast.expr):
    """The elementary write targets inside a possibly tuple/list/starred
    unpacking target -- `self.a, (self.b, *rest) = ...` writes each."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _flatten_targets(elt)
    elif isinstance(target, ast.Starred):
        yield from _flatten_targets(target.value)
    else:
        yield target


# the ONE spelling of the escape-attachment rule lives in core
_escape_at = core_escape_at


class _FnWalker:
    """Walk one outer function tracking held registered locks; record
    acquisitions, calls-with-held, blocking ops and shared-state writes.
    Named nested defs become their OWN _FnInfo records (their bodies run
    later, usually on another thread -- a nested def passed to
    Thread(target=...) is a thread root in its own right, and a closure
    defined in __init__ must NOT inherit the happens-before-publication
    write exemption); lambdas still fold in with held locks reset."""

    def __init__(self, mod: _ModInfo, info: _FnInfo, fn: ast.AST,
                 cls: str | None, blk_escapes: dict[int, str],
                 tsi_escapes: dict[int, str]):
        self.mod = mod
        self.info = info
        self.fn = fn
        self.cls = cls
        self.blk_escapes = blk_escapes
        self.tsi_escapes = tsi_escapes
        self.local_kinds: dict[str, str] = {}
        self.locals = _local_binds(fn)
        self.globals_declared = _declared_globals(fn)
        self.is_init = getattr(fn, "name", "") == "__init__"
        self.nested: dict[str, str] = {}   # local def name -> full label
        self._loops: list[set[str]] = []   # enclosing loops' bound names

    def run(self) -> None:
        for stmt in self.fn.body:
            self._visit(stmt, frozenset())

    # ---------------------------------------------------------- helpers --
    def _lock_of_expr(self, expr: ast.expr) -> str | None:
        name = _self_attr(expr)
        if name is not None:
            return self.mod.lock_id(self.cls, name)
        if isinstance(expr, ast.Name):
            if expr.id in self.locals \
                    and expr.id not in self.globals_declared:
                # a parameter/local shadowing a registered lock's name
                # is NOT the module lock: misattributing it would
                # fabricate order edges and blocking-under-lock findings
                return None
            return self.mod.lock_id(None, expr.id)
        return None

    def _escaped(self, line: int, escapes: dict[int, str]) -> int | None:
        """The escape line covering `line` (itself or the line above)."""
        return _escape_at(escapes, line)

    def _record_block(self, line: int, op: str, held: frozenset,
                      released: str | None = None) -> None:
        # the escape line rides the record; whether it is USED is
        # decided by the analysis (an escape on an op no caller ever
        # reaches under a lock suppresses nothing and must go stale).
        # released: the lock the op gives up while blocking
        # (Condition.wait's own lock) -- callers discharge it from
        # their held set too
        esc = self._escaped(line, self.blk_escapes)
        self.info.blocks.append((line, op, tuple(sorted(held)), esc,
                                 released))

    def _classify_call(self, node: ast.Call, name: str,
                       held: frozenset) -> None:
        head, _, rest = name.partition(".")
        full = self.mod.aliases.get(head)
        canon = (f"{full}.{rest}" if rest else full) if full else name
        if name in BLOCKING_CALLS or canon in BLOCKING_CALLS:
            self._record_block(node.lineno, name, held)
            return
        base, _, meth = name.rpartition(".")
        if not base:
            return
        if meth in BLOCKING_METHODS:
            self._record_block(node.lineno, name, held)
            return
        store = base.rsplit(".", 1)[-1]
        if meth in STORE_BLOCKING_METHODS \
                and (store == "store" or store.endswith("_store")):
            self._record_block(node.lineno, name, held)
            return
        res = self.mod.resource_of(self.cls, base, self.local_kinds)
        if res is None:
            return
        if meth in _TYPED_BLOCKING.get(res.kind, ()):
            effective = set(held)
            released = None
            if res.kind == "cond":
                # Condition.wait releases the condition's own lock; every
                # other held lock stays held across the wait
                attr = base[len("self."):] if base.startswith("self.") \
                    else base
                released = self.mod.lock_id(
                    self.cls if base.startswith("self.") else None, attr)
                if released is not None:
                    effective.discard(released)
            self._record_block(node.lineno, name, frozenset(effective),
                               released)

    def _thread_targets(self, node: ast.Call) -> None:
        target = next((kw.value for kw in node.keywords
                       if kw.arg == "target"), None)
        if target is None:
            return
        spelled = dotted_name(target)
        candidates: list[str] = []
        if spelled is not None:
            if isinstance(target, ast.Name) and spelled in self.locals:
                # `Thread(target=target)` where `target` is bound by a
                # local assignment or a for over a tuple of entry points:
                # harvest the function references from the binding exprs
                for n in ast.walk(self.fn):
                    for tgt, value in _assign_pairs(n):
                        if _binds_name(tgt, spelled):
                            candidates.extend(_harvest_refs(value))
                    if isinstance(n, ast.For) \
                            and _binds_name(n.target, spelled):
                        candidates.extend(_harvest_refs(n.iter))
            else:
                candidates.append(spelled)
        # a spawn inside a loop whose iteration does NOT rebind the
        # target runs the SAME function on many threads (the accept
        # loop's per-connection handler); a loop-variable target (the
        # repo's for-over-(target, name)-tuples start()) spawns each
        # bound function once and stays single-instance
        loop_vars: set[str] = set().union(*self._loops) \
            if self._loops else set()
        multi = bool(self._loops) and not any(
            isinstance(n, ast.Name) and n.id in loop_vars
            for n in ast.walk(target))
        for cand in candidates:
            label = self.nested.get(cand) if "." not in cand else None
            self.mod.roots.append(_RootSite(cand, self.cls,
                                            self.info.label,
                                            self.mod.file, node.lineno,
                                            label=label, multi=multi))

    def _record_write(self, line: int, scope_cls: str | None,
                      attr: str) -> None:
        if self.is_init:
            return  # construction happens-before publication
        scope = self.mod.class_res.get(scope_cls, {}) if scope_cls \
            else self.mod.module_res
        res = scope.get(attr)
        if res is not None:
            return  # the synchronization resources themselves are exempt
        esc = self._escaped(line, self.tsi_escapes)
        owner = f"{self.mod.module}.{scope_cls}" if scope_cls \
            else self.mod.module
        self.info.writes.append((line, (scope_cls, attr, owner), esc))

    def _mutation_base(self, target: ast.expr) -> tuple[str | None,
                                                        str] | None:
        """(class scope, attr) for a write target: `self.X` (and any
        deeper `self.X.y`/`self.X[k]` mutation, recorded as a write of
        X), bare global `X` (with a `global` declaration), or
        `X[k]`/`X.attr` mutation of a module-level name."""
        node = target
        mutated = False  # stripped at least one Subscript/Attribute
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            if isinstance(node, ast.Attribute):
                name = _self_attr(node)
                if name is not None:
                    return (self.cls, name)
            node = node.value
            mutated = True
        if isinstance(node, ast.Name):
            if node.id in self.locals \
                    and node.id not in self.globals_declared:
                return None  # a local (or parameter) shadow
            if mutated:
                if node.id in self.mod.module_globals:
                    return (None, node.id)
                return None
            if node.id in self.globals_declared:
                return (None, node.id)
        return None

    # ------------------------------------------------------------- walk --
    def _visit(self, node: ast.AST, held: frozenset) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            # items of one `with A, B:` acquire left-to-right exactly
            # like nested withs: each later item sees the earlier ones
            # held, so the A->B order edge exists in either spelling
            acquired: set[str] = set()
            for item in node.items:
                self._visit(item.context_expr, held | acquired)
                lid = self._lock_of_expr(item.context_expr)
                if lid is not None:
                    self.info.acquisitions.append(
                        (item.context_expr.lineno, lid,
                         tuple(sorted(held | acquired))))
                    acquired.add(lid)
                if item.optional_vars is not None:
                    # `with open() as self.x:` binds (writes) the target
                    for t in _flatten_targets(item.optional_vars):
                        based = self._mutation_base(t)
                        if based is not None:
                            self._record_write(
                                item.context_expr.lineno, *based)
            inner = held | acquired
            for stmt in node.body:
                self._visit(stmt, inner)
            return
        if isinstance(node, ast.Lambda):
            # lambda: runs later, held locks reset, folds into the outer
            self._visit(node.body, frozenset())
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # named nested def: its own record (thread-root candidate;
            # no inherited __init__ exemption; synchronous calls to it
            # resolve through the intra-module nested-label edge)
            for dec in node.decorator_list:
                self._visit(dec, held)
            label = f"{self.info.label}.{node.name}"
            self.nested[node.name] = label
            sub = _FnInfo(self.mod.module, label, self.info.file)
            self.mod.fns[label] = sub
            _FnWalker(self.mod, sub, node, self.cls, self.blk_escapes,
                      self.tsi_escapes).run()
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            # track the enclosing-loop context (and which names the
            # loop rebinds) for the multi-instance thread-spawn signal
            names: set[str] = set()
            if isinstance(node, (ast.For, ast.AsyncFor)):
                for nd in ast.walk(node.target):
                    if isinstance(nd, ast.Name):
                        names.add(nd.id)
                # `for self.cur in ...:` writes the attribute each
                # iteration -- a shared-state write like any other
                for t in _flatten_targets(node.target):
                    based = self._mutation_base(t)
                    if based is not None:
                        self._record_write(node.lineno, *based)
                self._visit(node.iter, held)
            else:
                self._visit(node.test, held)
            self._loops.append(names)
            for stmt in node.body:
                self._visit(stmt, held)
            self._loops.pop()
            # the else block runs ONCE, after the loop: a thread spawned
            # there is not multi-instance
            for stmt in node.orelse:
                self._visit(stmt, held)
            return
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name is not None:
                last = name.rsplit(".", 1)[-1]
                if last == "Thread":
                    self._thread_targets(node)
                self.info.calls.append((node.lineno, name, self.cls,
                                        tuple(sorted(held))))
                self._classify_call(node, name, held)
            for child in ast.iter_child_nodes(node):
                self._visit(child, held)
            return
        for target, value in _assign_pairs(node):
            res = _res_of_value(value)
            if res is not None and isinstance(target, ast.Name):
                self.local_kinds[target.id] = res.kind
        if isinstance(node, (ast.Assign, ast.AugAssign)) \
                or (isinstance(node, ast.AnnAssign)
                    and node.value is not None):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                for t in _flatten_targets(target):
                    based = self._mutation_base(t)
                    if based is not None:
                        self._record_write(node.lineno, based[0],
                                           based[1])
        for child in ast.iter_child_nodes(node):
            self._visit(child, held)


def _outer_functions(tree: ast.AST):
    """(fn node, enclosing class name, label) for every outermost def."""
    out = []

    def rec(node: ast.AST, cls: str | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                rec(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                label = f"{cls}.{child.name}" if cls else child.name
                out.append((child, cls, label))
            else:
                rec(child, cls)

    rec(tree, None)
    return out


def _collect(unit: LintUnit, module: str) -> _ModInfo:
    mod = _ModInfo(unit, module)
    _collect_resources(mod)
    blk = unit.escapes.get("BLK", {})
    tsi = unit.escapes.get("TSI", {})
    for fn, cls, label in _outer_functions(unit.tree):
        info = _FnInfo(module, label, unit.file)
        mod.fns[label] = info
        _FnWalker(mod, info, fn, cls, blk, tsi).run()
    return mod


# ============================================================== analysis ==
class _Analysis:
    """The package-level pass: summaries by fixpoint over resolved call
    edges (cycle-tolerant by construction), then LCK edges/cycles, BLK
    witnesses and TSI root reachability."""

    def __init__(self, units: list[LintUnit],
                 prebuilt: tuple | None = None):
        self.units = [u for u in units if u.tree is not None]
        if prebuilt is None:
            prebuilt = callgraph.build(self.units)
        self.cg_modules, self.graph = prebuilt
        self.mods: dict[str, _ModInfo] = {}
        for u, cgm in zip(self.units, self.cg_modules):
            self.mods[cgm.module] = _collect(u, cgm.module)
        self.infos: dict[tuple[str, str], _FnInfo] = {
            (m.module, label): info
            for m in self.mods.values() for label, info in m.fns.items()}
        self.unit_by_file = {u.file: u for u in self.units}
        # (finding, escape reason) pairs whose escapes sit away from the
        # finding's own anchor line (a tsi-ok on a non-anchor write, a
        # blk-ok at the blocking SOURCE suppressing a caller's finding)
        # -- the anchor-based split cannot recover these, so they feed
        # the SARIF suppressions surface directly
        self.tsi_suppressed: list[tuple[Finding, str]] = []
        self.blk_suppressed: list[tuple[Finding, str]] = []
        # lock id -> kind (the representative's kind: a Condition(lock)
        # alias deadlocks, or not, like the lock it wraps)
        self.lock_kinds: dict[str, str] = {}
        for mod in self.mods.values():
            for cls, scope in list(mod.class_res.items()) \
                    + [(None, mod.module_res)]:
                for name in scope:
                    lid = mod.lock_id(cls, name)
                    if lid is None:
                        continue
                    rep = mod._rep_attr(scope, name)
                    rep_res = scope.get(rep, scope[name])
                    self.lock_kinds.setdefault(lid, rep_res.kind)
        self._resolve_edges()
        self._fixpoint()

    # ------------------------------------------------------- resolution --
    def _resolve_edges(self) -> None:
        self.callees: dict[tuple[str, str], list] = {}
        by_name = {m.module: m for m in self.cg_modules}
        for key, info in self.infos.items():
            cgm = by_name[key[0]]
            edges = []
            for line, name, cls, held in info.calls:
                if "." not in name:
                    # a synchronous call to a nested def visible from
                    # this scope: the caller's own children first, then
                    # siblings by ascending through enclosing FUNCTION
                    # scopes (never past one -- a bare name inside a
                    # method must not resolve to a sibling method)
                    prefix, nkey = key[1], None
                    while True:
                        cand = (key[0], f"{prefix}.{name}")
                        if cand in self.infos:
                            nkey = cand
                            break
                        if "." not in prefix:
                            break
                        parent = prefix.rsplit(".", 1)[0]
                        if (key[0], parent) not in self.infos:
                            break
                        prefix = parent
                    if nkey is not None:
                        edges.append((line, name, held, nkey))
                        continue
                callee = self.graph.resolve(cgm, name, cls)
                if callee is None:
                    continue
                ckey = (callee.module, callee.label)
                # self-edges stay: `with self._lock: self.step(...)`
                # recursing into itself is the one-edge re-acquisition
                # deadlock (the fixpoint merges are no-ops on them)
                if ckey not in self.infos:
                    continue
                edges.append((line, name, held, ckey))
            self.callees[key] = edges

    # -------------------------------------------------------- summaries --
    def _fixpoint(self) -> None:
        # acquires[f]: lock id -> (chain labels, acq file, acq line)
        self.acquires: dict[tuple[str, str], dict] = {}
        # blocks[f]: released-lock -> (chain labels, file, line, op) --
        # first UNESCAPED blocking op reachable from f, kept PER
        # released lock (Condition.wait gives up its own lock while
        # blocking, so a caller discharge of that lock must not hide a
        # plain sleep behind the same call edge)
        self.blocks: dict[tuple[str, str], dict] = {}
        # blocks_raw[f]: same with escapes ignored, each witness
        # carrying its own escape (module, line) (feeds raw findings
        # and the SARIF justification); block_escapes[f]: every source
        # blk-ok's (module, line) on a blocking op reachable from f --
        # a lock-held call marks ALL of them used (each suppresses its
        # own route), so an escape on an op no caller reaches under a
        # lock goes stale
        self.blocks_raw: dict[tuple[str, str], dict] = {}
        self.block_escapes: dict[tuple[str, str], set] = {}
        for key, info in self.infos.items():
            acq = {}
            for line, lid, _held in info.acquisitions:
                acq.setdefault(lid, ([info.label], info.file, line))
            self.acquires[key] = acq
            blk: dict = {}
            blk_raw: dict = {}
            esc_set = set()
            for line, op, _held, esc, released in info.blocks:
                blk_raw.setdefault(
                    released, ([info.label], info.file, line, op,
                               (key[0], esc) if esc is not None else None))
                if esc is not None:
                    esc_set.add((key[0], esc))
                else:
                    blk.setdefault(released,
                                   ([info.label], info.file, line, op))
            self.blocks[key] = blk
            self.blocks_raw[key] = blk_raw
            self.block_escapes[key] = esc_set
        changed = True
        while changed:
            changed = False
            for key in sorted(self.infos):
                info = self.infos[key]
                acq = self.acquires[key]
                for _line, _name, _held, ckey in self.callees[key]:
                    for lid, (chain, afile, aline) in \
                            self.acquires[ckey].items():
                        if lid not in acq:
                            acq[lid] = ([info.label] + chain, afile, aline)
                            changed = True
                    for summary in (self.blocks, self.blocks_raw):
                        mine = summary[key]
                        for released, witness in list(
                                summary[ckey].items()):
                            if released not in mine:
                                chain, *rest = witness
                                mine[released] = ([info.label] + chain,
                                                  *rest)
                                changed = True
                    if not self.block_escapes[ckey] \
                            <= self.block_escapes[key]:
                        self.block_escapes[key] |= \
                            self.block_escapes[ckey]
                        changed = True

    # -------------------------------------------------------------- LCK --
    def lock_edges(self) -> dict:
        """(held, acquired) -> [(site file, site line, chain labels,
        acq file, acq line), ...]: EVERY distinct site creating the
        order edge, in deterministic order -- an lck-ok at one site must
        not vouch for the same hazard spelled elsewhere."""
        edges: dict[tuple[str, str], list] = {}

        def add(h, lid, sfile, sline, chain, afile, aline):
            sites = edges.setdefault((h, lid), [])
            if not any(s[0] == sfile and s[1] == sline for s in sites):
                sites.append((sfile, sline, chain, afile, aline))

        for key in sorted(self.infos):
            info = self.infos[key]
            sites = [("acq", line, lid, held)
                     for line, lid, held in info.acquisitions if held]
            sites += [("call", line, ckey, held)
                      for line, _name, held, ckey in self.callees[key]
                      if held]
            for kind, line, payload, held in sorted(
                    sites, key=lambda s: s[1]):
                if kind == "acq":
                    for h in held:
                        add(h, payload, info.file, line, [info.label],
                            info.file, line)
                else:
                    for lid, (chain, afile, aline) in sorted(
                            self.acquires[payload].items()):
                        for h in held:
                            add(h, lid, info.file, line,
                                [info.label] + chain, afile, aline)
        return edges

    def lck_findings(self) -> tuple[list[Finding], list[Finding]]:
        edges = self.lock_edges()
        findings: list[Finding] = []
        raw: list[Finding] = []

        def emit_sites(sites, message_fn):
            # raw finding at EVERY site (any site's escape counts as
            # used), live finding at the FIRST UNESCAPED site: one
            # escaped anchor cannot vouch for the same hazard spelled
            # elsewhere, and one live finding per hazard keeps the
            # report readable
            live_done = False
            for sfile, sline, chain, afile, aline in sites:
                f = Finding(sfile, sline, "LCK",
                            message_fn(chain, afile, aline))
                raw.append(f)
                if live_done:
                    continue
                unit = self.unit_by_file.get(sfile)
                escapes = unit.escapes.get("LCK", {}) if unit else {}
                if _escape_at(escapes, sline) is None:
                    findings.append(f)
                    live_done = True

        # self-edges: re-acquisition of a non-reentrant lock (RLock is
        # exempt -- same-thread re-acquisition is its documented
        # use-case; it still participates in order cycles above)
        for (h, lid), sites in sorted(edges.items()):
            if h != lid or self.lock_kinds.get(lid) == "rlock":
                continue
            emit_sites(sites, lambda chain, afile, aline, lid=lid: (
                f"`{lid}` may be re-acquired while already held "
                f"({' -> '.join(chain)} acquires it at {afile}:{aline}); "
                "threading.Lock is non-reentrant, so this path "
                "self-deadlocks -- restructure to a *_locked helper, or "
                "escape with `# spgemm-lint: lck-ok(<reason>)` if the "
                "re-acquiring branch is provably unreachable here"))
        # cycles between distinct locks (the two-witness deadlock class);
        # pairwise detection over the edge set covers every 2-cycle, and
        # longer cycles always contain lock pairs ordered both ways
        # transitively -- report the direct pairs, which is where the fix
        # (pick one order) lands anyway.  The closure composes on one
        # representative witness per pair; emission walks every direct
        # site of the a->b direction (first unescaped wins)
        first = {pair: sites[0] for pair, sites in edges.items()}
        closure = self._transitive_closure(first)
        for (a, b) in sorted(closure):
            if a >= b or (b, a) not in closure:
                continue
            w_ba = closure[(b, a)]
            _, _, chain_ba, afile_ba, aline_ba = w_ba
            ab_sites = edges.get((a, b)) or [closure[(a, b)]]
            emit_sites(ab_sites, lambda chain, afile, aline, a=a, b=b: (
                f"lock-order cycle between `{a}` and `{b}`: "
                f"{' -> '.join(chain)} acquires `{b}` while holding "
                f"`{a}` ({afile}:{aline}), but "
                f"{' -> '.join(chain_ba)} acquires `{a}` while holding "
                f"`{b}` ({w_ba[0]}:{w_ba[1]} -> {afile_ba}:{aline_ba}) "
                "-- a potential deadlock; impose one acquisition order, "
                "or escape with `# spgemm-lint: lck-ok(<reason>)`"))
        return findings, raw

    @staticmethod
    def _transitive_closure(edges: dict) -> dict:
        """held -> acquired reachability with first witnesses: A->B and
        B->C compose to A->C so indirect inversions still close a cycle."""
        closure = dict(edges)
        changed = True
        while changed:
            changed = False
            for (a, b), w1 in list(closure.items()):
                for (b2, c), w2 in list(closure.items()):
                    if b2 != b or (a, c) in closure:
                        continue
                    # compose witnesses: anchor stays at the first hop
                    closure[(a, c)] = (w1[0], w1[1],
                                       w1[2] + ["..."] + w2[2],
                                       w2[3], w2[4])
                    changed = True
        return closure

    # -------------------------------------------------------------- BLK --
    def blk_findings(self) -> tuple[list[Finding], list[Finding]]:
        findings: list[Finding] = []
        raw: list[Finding] = []
        reported: set[tuple[str, int]] = set()

        def emit(file, line, escaped, message):
            if (file, line) in reported:
                return None
            reported.add((file, line))
            f = Finding(file, line, "BLK", message)
            raw.append(f)
            if not escaped:
                findings.append(f)
            return f

        for key in sorted(self.infos):
            info = self.infos[key]
            unit = self.unit_by_file.get(info.file)
            escapes = unit.escapes.get("BLK", {}) if unit else {}
            for line, op, held, esc, _released in info.blocks:
                if not held:
                    continue
                if esc is not None:
                    # the escape suppresses a real lock-held hazard
                    self.mods[key[0]].used_escapes.add(("BLK", esc))
                emit(info.file, line, esc is not None,
                     f"blocking `{op}` while holding {', '.join(held)}: "
                     "every other thread contending for the lock stalls "
                     "behind this call (watchdog/executor latency, drain "
                     "hangs); move the blocking work outside the critical "
                     "section, or escape with "
                     "`# spgemm-lint: blk-ok(<reason>)`")
            for line, name, held, ckey in self.callees[key]:
                if not held or not self.blocks_raw[ckey]:
                    continue

                # a witness discharges the lock its op RELEASES while
                # blocking (Condition.wait's own lock, reached through
                # a helper): pick the first witness that still leaves a
                # lock held -- the canonical cond-var pattern is not a
                # hazard, but a plain sleep behind the same call edge is
                def pick(witnesses: dict):
                    for released in sorted(
                            witnesses,
                            key=lambda r: (r is not None, r or "")):
                        effective = tuple(h for h in held if h != released)
                        if effective:
                            return witnesses[released], effective
                    return None, None

                witness, effective = pick(self.blocks[ckey])
                src_esc = None
                if witness is not None:
                    live = True
                    chain, bfile, bline, op = witness
                else:
                    live = False
                    witness, effective = pick(self.blocks_raw[ckey])
                    if witness is None:
                        continue  # every route discharges all held locks
                    chain, bfile, bline, op, src_esc = witness
                # every source escape on a blocking route reachable from
                # here is doing real work on a lock-held path: used
                for esc_mod, esc_line in self.block_escapes[ckey]:
                    self.mods[esc_mod].used_escapes.add(("BLK", esc_line))
                call_esc = _escape_at(escapes, line) is not None
                escaped = call_esc or not live
                f = emit(info.file, line, escaped,
                     f"`{name}` reaches blocking `{op}` while holding "
                     f"{', '.join(effective)}: {info.label} -> "
                     f"{' -> '.join(chain)} -> `{op}` ({bfile}:{bline}); "
                     "a lock held across a blocking call stalls every "
                     "contending thread -- hoist the call out of the "
                     "critical section, prove the op non-blocking at its "
                     "source with `# spgemm-lint: blk-ok(<reason>)`, or "
                     "escape this call site")
                if f is not None and not live and not call_esc:
                    # suppressed at the SOURCE, away from this anchor:
                    # carry the (finding, reason) pair -- reason from
                    # the escape on the WITNESSED op, so the SARIF
                    # justification argues for the blocking call the
                    # finding's own chain names
                    reason = ""
                    if src_esc is not None:
                        src_unit = self.unit_by_file.get(
                            self.mods[src_esc[0]].file)
                        if src_unit is not None:
                            reason = src_unit.escapes.get(
                                "BLK", {}).get(src_esc[1], "")
                    self.blk_suppressed.append((f, reason))
        return findings, raw

    # -------------------------------------------------------------- TSI --
    def thread_roots(self) -> dict[tuple[str, str], list[_RootSite]]:
        """Resolved thread-entry functions -> the sites that spawn them."""
        by_name = {m.module: m for m in self.cg_modules}
        roots: dict[tuple[str, str], list[_RootSite]] = {}
        for mod in self.mods.values():
            cgm = by_name[mod.module]
            for site in mod.roots:
                if site.label is not None:
                    # nested-def target: pre-resolved by the walker
                    key = (mod.module, site.label)
                    if key in self.infos:
                        roots.setdefault(key, []).append(site)
                    continue
                callee = self.graph.resolve(cgm, site.spelled, site.cls)
                if callee is None:
                    continue
                key = (callee.module, callee.label)
                if key in self.infos:
                    roots.setdefault(key, []).append(site)
        return roots

    def _root_weight(self, sites: list[_RootSite]) -> int:
        """2 when the root demonstrably runs on >= 2 threads at once --
        spawned inside a loop that does not rebind the target, or from
        two distinct sites; 1 otherwise."""
        if any(s.multi for s in sites) \
                or len({(s.file, s.line) for s in sites}) > 1:
            return 2
        return 1

    def _reachable(self, root: tuple[str, str]) -> set:
        seen = {root}
        stack = [root]
        while stack:
            key = stack.pop()
            for _line, _name, _held, ckey in self.callees.get(key, ()):
                if ckey not in seen:
                    seen.add(ckey)
                    stack.append(ckey)
        return seen

    def tsi_findings(self) -> tuple[list[Finding], list[Finding]]:
        roots = self.thread_roots()
        # a multi-instance root (loop-spawned same target, or >= 2 spawn
        # sites -- the daemon's per-connection handler) counts as two
        # threads by itself: one root is already a data race
        weight = {key: self._root_weight(sites)
                  for key, sites in roots.items()}
        roots_reaching: dict[tuple[str, str], set] = {}
        for root in roots:
            for key in self._reachable(root):
                roots_reaching.setdefault(key, set()).add(root)
        # attr key -> write records (file, line, func key, escape line)
        writes: dict[tuple, list] = {}
        for key in sorted(self.infos):
            info = self.infos[key]
            mod = self.mods[key[0]]
            for line, (scope_cls, attr, owner), esc in info.writes:
                if attr in mod.annotated.get(scope_cls, ()):
                    continue  # guarded-by-annotated: THR owns it
                writes.setdefault((owner, attr),
                                  []).append((info.file, line, key, esc))
        findings: list[Finding] = []
        raw: list[Finding] = []
        for (owner, attr), recs in sorted(writes.items()):
            recs.sort(key=lambda r: (r[0], r[1]))
            all_roots = set()
            for _file, _line, fkey, _esc in recs:
                all_roots |= roots_reaching.get(fkey, set())
            count = sum(weight[r] for r in all_roots)
            if count < 2:
                continue
            mod = self.mods[recs[0][2][0]]
            root_names = sorted(
                f"{r[1]} ({r[0]}"
                + (", multi-instance" if weight[r] > 1 else "") + ")"
                for r in all_roots)
            live = [r for r in recs if r[3] is None]
            for _file, _line, _fkey, esc in recs:
                if esc is not None:
                    mod.used_escapes.add(("TSI", esc))
            msg = (f"`{owner}.{attr}` is written from {count} "
                   f"thread roots ({'; '.join(root_names)}) without a "
                   "`# spgemm-lint: guarded-by(<lock>)` annotation: "
                   "multi-thread-written state must either declare its "
                   "lock (THR then enforces it) or argue its lock-free "
                   "protocol with `# spgemm-lint: tsi-ok(<reason>)` on "
                   "the write lines; write sites: "
                   + ", ".join(f"{r[0]}:{r[1]}" for r in recs))
            raw_f = Finding(recs[0][0], recs[0][1], "TSI", msg)
            raw.append(raw_f)
            live_roots = set()
            for _file, _line, fkey, _esc in live:
                live_roots |= roots_reaching.get(fkey, set())
            if sum(weight[r] for r in live_roots) >= 2:
                findings.append(Finding(live[0][0], live[0][1], "TSI", msg))
            else:
                # suppressed by tsi-ok escapes (possibly on non-anchor
                # write lines the anchor-based split cannot see): carry
                # the (finding, reason) pair for the SARIF suppressions
                # surface so the escape stays auditable
                for file, _line, _fkey, esc in recs:
                    if esc is None:
                        continue
                    unit = self.unit_by_file.get(file)
                    reason = unit.escapes.get("TSI", {}).get(esc, "") \
                        if unit else ""
                    self.tsi_suppressed.append((raw_f, reason))
                    break
        return findings, raw

    # -------------------------------------------------- thread inventory --
    def inventory_rows(self) -> list[dict]:
        """One row per resolved thread root: root label, spawners, locks
        it may (transitively) hold, shared attrs it may write --
        deterministic, for the generated ARCHITECTURE.md table."""
        rows = []
        for key, sites in sorted(self.thread_roots().items()):
            locks = set()
            attrs = set()
            for fkey in self._reachable(key):
                # acquires is seeded from every local acquisition before
                # the transitive merge, so it already covers them all
                locks.update(self.acquires[fkey])
                info = self.infos[fkey]
                for _line, (_scope_cls, attr, owner), _esc in info.writes:
                    attrs.add(f"{owner}.{attr}".replace("spgemm_tpu_torch.", ""))
            spawners = sorted({f"{s.spawner} ({s.file})" for s in sites})
            rows.append({
                "root": f"{key[0]}.{key[1]}".replace("spgemm_tpu_torch.", ""),
                "spawners": spawners,
                "locks": sorted(lk.replace("spgemm_tpu_torch.", "")
                                for lk in locks),
                "writes": sorted(attrs),
            })
        return rows


def check(units: list[LintUnit], *, inventory: list | None = None,
          prebuilt: tuple | None = None,
          suppressed: list | None = None) -> tuple[list[Finding],
                                                   list[Finding],
                                                   set[tuple[str, str, int]]]:
    """The concurrency pass over one lint run's unit set.

    Returns (findings, raw_findings, used_escapes): findings honor
    lck-ok/blk-ok/tsi-ok escapes, raw_findings ignore them (the
    suppression audit derives usage from the difference), and
    used_escapes are (file, rule, escape line) for source-level escapes
    that suppressed taint without an anchored finding (a blk-ok on the
    blocking op itself, a tsi-ok on a non-anchor write line).

    inventory: an optional sink list the thread-inventory rows are
    appended to -- the DOC table check reuses this run's analysis
    instead of rebuilding the whole program a second time (valid only
    when the unit set IS the default scope; the caller guards that).
    prebuilt: a callgraph.build(units) result to reuse (same
    once-per-run economy for the call graph itself).
    suppressed: an optional sink for (finding, escape reason) pairs
    whose escapes sit away from the finding's anchor line (a tsi-ok on
    a non-anchor write, a blk-ok at the blocking source suppressing a
    caller's finding) -- the caller's anchor-based raw-vs-surviving
    split cannot recover those reasons."""
    analysis = _Analysis(units, prebuilt)
    findings: list[Finding] = []
    raw: list[Finding] = []
    for fn in (analysis.lck_findings, analysis.blk_findings,
               analysis.tsi_findings):
        f, r = fn()
        findings += f
        raw += r
    used: set[tuple[str, str, int]] = set()
    for mod in analysis.mods.values():
        for rule, line in mod.used_escapes:
            used.add((mod.file, rule, line))
    if inventory is not None:
        inventory.extend(analysis.inventory_rows())
    if suppressed is not None:
        suppressed.extend(analysis.blk_suppressed)
        suppressed.extend(analysis.tsi_suppressed)
    return findings, raw, used


def inventory_rows(units: list[LintUnit]) -> list[dict]:
    """Thread-inventory rows for a unit set (docrules renders the table)."""
    return _Analysis(units).inventory_rows()
