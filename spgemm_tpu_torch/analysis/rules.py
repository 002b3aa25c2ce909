"""The AST rule families: FLD (ordered fold), KNB (knob registry), BKD
(import-time CUDA-context touch).  DOC lives in docrules.py (it diffs
generated docs, not syntax trees).

All three share the dotted-name helper: rules match on the *spelled*
call -- `torch.sum`, `dist.all_reduce`, `x.index_add_()` -- which is what
a reviewer reads and what a future PR would actually type.  Aliased
imports (`from torch import sum as s`) can evade an AST linter; the rule
set trades that corner for zero-dependency speed, and the tier-1
self-lint keeps the package idiom uniform enough that the spelled form is
the form.

BKD's rationale in the port: a CUDA context made at import time is one
that forked children -- spgemmd's and the fleet's workers, the
`--distributed` ranks -- cannot re-initialise (CUDA does not survive a
fork), and it costs start-up time and card memory in every process that
imports the module but never launches a kernel: the CLI's client
subcommands, the router, the linter's own subprocesses.  So the card is
touched lazily, inside the call that needs it.
"""

from __future__ import annotations

import ast

from spgemm_tpu_torch.analysis.core import Finding

# ---------------------------------------------------------------- FLD ----
# Unordered-reduction call names.  `.sum()` as a METHOD on anything is
# flagged too: on the numeric path even a host-side numpy sum over values
# is a fold whose order must be argued, and the fld-proof escape hatch
# (reason mandatory) is exactly that argument.
# Builtin bare `sum(...)` is a left fold (ordered) and stays legal.
# Terminals are torch's unordered accumulations: the collectives that sum
# across ranks and the scatter-style adds whose per-slot order is the
# device's atomic order, not the reference's j-ascending pair order.
FLD_TERMINALS = {"all_reduce", "reduce_scatter", "reduce_scatter_tensor",
                 "index_add", "index_add_", "scatter_add", "scatter_add_",
                 "scatter_reduce", "scatter_reduce_", "segment_reduce"}
FLD_REDUCE_NAMESPACES = {"functools", "ft"}

# ---------------------------------------------------------------- KNB ----
KNOB_PREFIX = "SPGEMM_TPU_"
ENVIRON_GETTERS = {"os.environ.get", "environ.get", "os.getenv", "getenv",
                   "os.environ.pop", "environ.pop",
                   "os.environ.setdefault", "environ.setdefault"}
ENVIRON_MAPS = {"os.environ", "environ"}

# ---------------------------------------------------------------- BKD ----
# Calls that create or query a CUDA context.  One made at module import
# cannot be re-initialised in a forked child (spgemmd's and the fleet's
# workers, the --distributed ranks), and it costs start-up and card memory
# in every process that imports the module but never launches a kernel.
BACKEND_CALLS = {
    "torch.distributed.init_process_group",
    "dist.init_process_group",
}
# Any CALL under torch.cuda.* queries or creates the context
# (`torch.cuda.device_count()` initialises the driver,
# `torch.cuda.current_stream()` the context itself).  Attribute access
# such as `torch.cuda.Event` as a type is fine: only calls are flagged.
BACKEND_NAMESPACES = ("torch.cuda.",)
# `<tensor>.cuda()` copies to the card, which creates the context.
BACKEND_METHODS = {"cuda"}

# Functions marked with this decorator (utils/backend_probe.host_only) run
# on host planner/worker threads -- the chain plan-ahead planner -- whose
# contract is that they never call into torch's device side: a card
# touch there serialises the planner behind the main thread's launches
# and syncs, and a failing card raises on a thread with no failover.
# Their WHOLE body is scanned for backend calls, not just import time.
HOST_ONLY_DECORATOR = "host_only"


def backend_call_name(node: ast.Call) -> str | None:
    """The spelled name of a call that creates or queries a CUDA context
    (BACKEND_CALLS / BACKEND_NAMESPACES / BACKEND_METHODS), else None.
    The `.cuda()` method counts on any base, a call's result included
    (`torch.zeros(3).cuda()`, spelled `<expr>.cuda`)."""
    name = dotted_name(node.func)
    if name is None:
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in BACKEND_METHODS):
            return f"<expr>.{node.func.attr}"
        return None
    head, _, last = name.rpartition(".")
    if (name in BACKEND_CALLS or name.startswith(BACKEND_NAMESPACES)
            or (head and last in BACKEND_METHODS)):
        return name
    return None


def dotted_name(node: ast.expr) -> str | None:
    """'torch.distributed.all_reduce' for Attribute/Name chains; None for
    anything else (subscripts, calls, literals)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _str_const(node: ast.expr) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def fld_violation(name: str) -> str | None:
    """The finding message for a spelled call name that is an unordered
    reduction, or None.  Shared by the per-module FLD pass below and the
    interprocedural taint scan (analysis/callgraph.py)."""
    head, _, last = name.rpartition(".")
    root = head.split(".", 1)[0] if head else ""
    if last in FLD_TERMINALS:
        return (f"unordered reduction `{name}` on the numeric path: the "
                "wrap-then-mod fold is non-associative (SURVEY.md 2.9)")
    if last == "sum" and head:  # any `<expr>.sum(...)` method/ns call
        return (f"`{name}` is an unordered reduction: the reference "
                "fold order is load-bearing on the numeric path "
                "(SURVEY.md 2.9); use the ordered MAC/fold helpers "
                "(ops/u64.py) or escape with a fld-proof(<reason>)")
    if last == "reduce" and (root in FLD_REDUCE_NAMESPACES or not head):
        return (f"`{name}` folds in container-iteration order, not the "
                "reference's j-ascending pair order; spell the fold "
                "explicitly or escape with fld-proof(<reason>)")
    return None


def check_fld(tree: ast.AST, file: str, escapes: set[int]) -> list[Finding]:
    """FLD: unordered reductions on the numeric path.

    A call is escaped when its own line (or the line directly above it,
    for wrapped expressions) carries `# spgemm-lint: fld-proof(<reason>)`.
    """
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        if name is None:
            continue
        bad = fld_violation(name)
        if bad is None:
            continue
        if node.lineno in escapes or node.lineno - 1 in escapes:
            continue
        findings.append(Finding(file, node.lineno, "FLD", bad))
    return findings


def check_knb(tree: ast.AST, file: str) -> list[Finding]:
    """KNB: raw SPGEMM_TPU_* environment READS outside the registry.

    Writes (`os.environ[k] = v`, Store/Del contexts) stay legal: that is
    how A/B harnesses and tests drive knob values for code that then
    reads them through the registry."""
    findings = []
    msg = ("raw environment read of {key!r}: SPGEMM_TPU_* knobs must go "
           "through spgemm_tpu_torch.utils.knobs (register the knob and "
           "call knobs.get)")
    for node in ast.walk(tree):
        key = None
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name in ENVIRON_GETTERS and node.args:
                key = _str_const(node.args[0])
        elif isinstance(node, ast.Subscript):
            if (isinstance(node.ctx, ast.Load)
                    and dotted_name(node.value) in ENVIRON_MAPS):
                key = _str_const(node.slice)
        if key is not None and key.startswith(KNOB_PREFIX):
            findings.append(Finding(file, node.lineno, "KNB",
                                    msg.format(key=key)))
    return findings


class _ImportTimeVisitor:
    """Collects backend-touching calls that execute at module import.

    Function/lambda BODIES are deferred (not import time), but their
    decorators and default-argument expressions evaluate at definition
    time -- at module scope that IS import time, so those are visited in
    the enclosing scope.  Class bodies execute at import and are walked.
    `if __name__ == "__main__"` blocks are skipped: they never run on a
    bare import, and a script driver touching the backend (after probing)
    is the CLI's job, not an import hazard.
    """

    def __init__(self, file: str):
        self.file = file
        self.findings: list[Finding] = []

    @staticmethod
    def _is_main_guard(node: ast.AST) -> bool:
        if not isinstance(node, ast.If):
            return False
        t = node.test
        return (isinstance(t, ast.Compare)
                and isinstance(t.left, ast.Name) and t.left.id == "__name__"
                and len(t.comparators) == 1
                and _str_const(t.comparators[0]) == "__main__")

    @staticmethod
    def _is_host_only(node: ast.AST) -> bool:
        for dec in getattr(node, "decorator_list", ()):
            target = dec.func if isinstance(dec, ast.Call) else dec
            name = dotted_name(target)
            if name is not None and (name == HOST_ONLY_DECORATOR
                                     or name.endswith("." + HOST_ONLY_DECORATOR)):
                return True
        return False

    def _scan_host_only(self, fn: ast.AST) -> None:
        """Flag every backend-touching call anywhere in a @host_only body
        (nested defs and lambdas included: they run on the same thread)."""
        for stmt in fn.body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call):
                    continue
                name = backend_call_name(node)
                if name is not None:
                    self.findings.append(Finding(
                        self.file, node.lineno, "BKD",
                        f"`{name}()` inside @host_only `{fn.name}`: "
                        "planner/worker-thread helpers must never touch "
                        "the card (plans are pure numpy -- a CUDA call on "
                        "the worker serialises it behind the main "
                        "thread's launches, and a failing card raises "
                        "where nothing fails over); resolve the device "
                        "on the main thread and pass it in"))

    def visit(self, node: ast.AST) -> None:
        if self._is_main_guard(node):
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                self.visit(dec)
            for default in (node.args.defaults + node.args.kw_defaults):
                if default is not None:
                    self.visit(default)
            if self._is_host_only(node):
                self._scan_host_only(node)
            return  # body runs only when called (host_only scanned above)
        if isinstance(node, ast.Lambda):
            for default in (node.args.defaults + node.args.kw_defaults):
                if default is not None:
                    self.visit(default)
            return
        if isinstance(node, ast.Call):
            name = backend_call_name(node)
            if name is not None:
                self.findings.append(Finding(
                    self.file, node.lineno, "BKD",
                    f"`{name}()` at module import time creates or queries "
                    "a CUDA context: forked children (spgemmd, fleet and "
                    "--distributed workers) cannot re-initialise it, and "
                    "it costs start-up and card memory in processes that "
                    "never launch a kernel; touch the card lazily, inside "
                    "the call that needs it"))
        for child in ast.iter_child_nodes(node):
            self.visit(child)


def check_bkd(tree: ast.AST, file: str) -> list[Finding]:
    """BKD: module-import-time CUDA-context calls."""
    visitor = _ImportTimeVisitor(file)
    visitor.visit(tree)
    return visitor.findings
