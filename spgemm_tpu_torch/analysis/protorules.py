"""PRO / EVT / DRF: wire-contract and registry-drift enforcement.

PRO -- the serve wire protocol's declarative registry
(serve/protocol.py: ENVELOPE_FIELDS / REQUEST_FIELDS / RESPONSE_FIELDS
/ ERROR_CODES) is binding at every call site that speaks the protocol
(any module importing serve.protocol or serve.client):

  * a literal field key read from a request (`msg.get("...")`,
    `msg["..."]`) or read from / written into a response
    (`protocol.ok(field=...)`, `protocol.error(code, msg, field=...)`,
    `resp[...]` / `resp.get(...)`, subscripts of a direct
    `request(...)` call) must be declared for the op in play.  Op
    context resolves from the enclosing function (the daemon's
    `_op_<name>` handlers) and from `{"op": "..."}` dict literals in
    the same scope; with no context the union of every op's table
    applies (cross-op helpers stay checkable without false positives);
  * an `{"op": ...}` dict literal must name a declared op, and its
    literal keys must be declared request fields FOR that op;
  * every structured-error code raised (`protocol.error` /
    `ProtocolError` / `ServeError` first argument) or compared
    (`....code == "..."`, `["code"] in (...)`) must be a declared
    ERROR_CODES value, and a `protocol.E_*` attribute must name a
    declared constant;
  * a dict literal stamping a hardcoded integer `"v"` is a
    rolling-upgrade hazard: version stamping belongs to
    protocol.version_for() over the derived FIELD_MIN_VERSION table;
  * package level (check_pro_registry, self-gated on protocol.py being
    in the linted unit set): the tables themselves must cohere --
    request/response op sets agree, min versions sit within
    1..PROTOCOL_VERSION, a field spelled in several request ops
    carries ONE min version (FIELD_MIN_VERSION flattens by name), every
    post-v1 request field lands in FIELD_MIN_VERSION (the
    rolling-upgrade-hazard half), and the E_* constants match
    ERROR_CODES both ways.

EVT -- the MET discipline applied to the structured event log: every
`emit(...)` / `LOG.emit(...)` kind (import-alias-resolved receivers of
obs/events: the module, its LOG singleton, or the bare emit function)
must be a string literal declared in events.EVENT_KINDS.

DRF -- the reverse audit over the whole unit set (escapable with
`# spgemm-lint: drf-ok(<reason>)` at the registry declaration line,
SUP-inventoried): a declared knob never read through knobs.get(), an
ENGINE phase/counter or metric family never referenced, an event kind
never emitted, or a protocol field / error code never referenced
anywhere in the package is dead registry surface -- the operator can
name it, the engine never honors it.  Each sub-audit self-gates on its
registry module being in the linted unit set, so fixture runs over
partial trees stay quiet.  Failpoints are deliberately NOT re-audited
here: FPT already owns that registry's stale direction, and one
finding per drift keeps escapes unambiguous.
"""

from __future__ import annotations

import ast

from spgemm_tpu_torch.analysis.core import Finding
from spgemm_tpu_torch.analysis.rules import dotted_name
from spgemm_tpu_torch.obs.events import EVENT_KINDS
from spgemm_tpu_torch.obs.metrics import ENGINE_COUNTERS, ENGINE_PHASES
from spgemm_tpu_torch.obs.metrics import REGISTRY as METRIC_REGISTRY
from spgemm_tpu_torch.serve import protocol
from spgemm_tpu_torch.utils.knobs import REGISTRY as KNOB_REGISTRY

PROTOCOL_SUFFIX = "/serve/protocol.py"
EVENTS_SUFFIX = "/obs/events.py"
KNOBS_SUFFIX = "/utils/knobs.py"
METRICS_SUFFIX = "/obs/metrics.py"

# the wire-variable naming convention the serve code already follows:
# requests travel as `msg`, responses as `resp` (plus direct subscripts
# of a `request(...)` call); other receiver names are out of scope --
# unauditable, and renaming a wire dict away from the convention is
# exactly the obscurity the rule exists to prevent
_REQUEST_NAMES = frozenset({"msg"})
_RESPONSE_NAMES = frozenset({"resp"})

_ENVELOPE = frozenset(protocol.ENVELOPE_FIELDS)
_ALL_REQUEST = frozenset(
    f for fields in protocol.REQUEST_FIELDS.values() for f in fields)
_ALL_RESPONSE = frozenset(
    f for fields in protocol.RESPONSE_FIELDS.values() for f in fields)
_CODES = frozenset(protocol.ERROR_CODES)
_E_NAMES = frozenset(
    n for n in dir(protocol)
    if n.startswith("E_") and isinstance(getattr(protocol, n), str))


def _str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


# ------------------------------------------------------------ PRO -----
def _protocol_imports(tree: ast.AST):
    """(dotted spellings of the protocol module, {local name: 'ok' |
    'error'} for functions imported from it, True iff serve.client is
    imported).  Any of them puts the module in PRO scope."""
    modules: set[str] = set()
    funcs: dict[str, str] = {}
    client_imported = False
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.endswith("serve.protocol"):
                for alias in node.names:
                    if alias.name in ("ok", "error"):
                        funcs[alias.asname or alias.name] = alias.name
            elif mod == "serve" or mod.endswith(".serve"):
                for alias in node.names:
                    if alias.name == "protocol":
                        modules.add(alias.asname or alias.name)
                    elif alias.name == "client":
                        client_imported = True
            elif mod.endswith("serve.client"):
                client_imported = True
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith("serve.protocol"):
                    modules.add(alias.asname or alias.name)
                elif alias.name.endswith("serve.client"):
                    client_imported = True
    return modules, funcs, client_imported


def _scope_roots(tree: ast.AST) -> list[ast.AST]:
    """Top-level functions and methods (class bodies included, nested
    defs excluded -- they share the enclosing root's op context)."""
    roots: list[ast.AST] = []

    def collect(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                roots.append(node)
            elif isinstance(node, ast.ClassDef):
                collect(node.body)

    collect(tree.body)
    return roots


def _context_ops(fn) -> set[str]:
    """The ops a scope provably speaks: its `_op_<name>` handler name
    plus every literal `{"op": "..."}` it builds."""
    ops: set[str] = set()
    if fn.name.startswith("_op_") and fn.name[4:] in protocol.OPS:
        ops.add(fn.name[4:])
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            for key, value in zip(node.keys, node.values):
                if _str(key) == "op" and _str(value) in protocol.OPS:
                    ops.add(_str(value))
    return ops


def _request_allowed(ops: set[str]) -> frozenset:
    if not ops:
        return _ALL_REQUEST | _ENVELOPE
    out = set(_ENVELOPE)
    for op in ops:
        out |= set(protocol.REQUEST_FIELDS.get(op, {}))
    return frozenset(out)


def _response_allowed(ops: set[str]) -> frozenset:
    if not ops:
        return _ALL_RESPONSE | _ENVELOPE
    out = set(_ENVELOPE)
    for op in ops:
        out |= set(protocol.RESPONSE_FIELDS.get(op, {}))
    return frozenset(out)


def _is_request_call(node) -> bool:
    """A direct `request(...)` / `x.request(...)` call -- its value IS a
    wire response, whatever it gets bound to."""
    if not isinstance(node, ast.Call):
        return False
    name = dotted_name(node.func)
    return name is not None and name.split(".")[-1] == "request"


def _wire_key_access(node):
    """('request'|'response', key node) for a literal field access on a
    conventional wire dict, else None: `msg.get("k")` / `msg["k"]` on
    the request side, `resp.get("k")` / `resp["k"]` /
    `request(...)["k"]` on the response side (reads and writes both --
    the client builds requests by subscript assignment)."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args:
        recv = node.func.value
        if isinstance(recv, ast.Name) and recv.id in _REQUEST_NAMES:
            return "request", node.args[0]
        if (isinstance(recv, ast.Name) and recv.id in _RESPONSE_NAMES) \
                or _is_request_call(recv):
            return "response", node.args[0]
    elif isinstance(node, ast.Subscript):
        recv = node.value
        if isinstance(recv, ast.Name) and recv.id in _REQUEST_NAMES:
            return "request", node.slice
        if (isinstance(recv, ast.Name) and recv.id in _RESPONSE_NAMES) \
                or _is_request_call(recv):
            return "response", node.slice
    return None


def _code_flavored(node) -> bool:
    """An expression that reads a structured error code: `x.code`,
    `...["code"]`, or `....get("code")`."""
    if isinstance(node, ast.Attribute) and node.attr == "code":
        return True
    if isinstance(node, ast.Subscript) and _str(node.slice) == "code":
        return True
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "get" and node.args
            and _str(node.args[0]) == "code")


def _check_pro_nodes(nodes, ops: set[str], file: str,
                     modules: set[str], funcs: dict[str, str],
                     findings: list[Finding]) -> None:
    req_allowed = _request_allowed(ops)
    resp_allowed = _response_allowed(ops)
    ctx = "/".join(sorted(ops)) if ops \
        else "any op (no op context in this scope)"
    tables = "serve/protocol.py REQUEST_FIELDS/RESPONSE_FIELDS"

    def field_finding(line, direction, key):
        table = "REQUEST_FIELDS" if direction == "request" \
            else "RESPONSE_FIELDS"
        findings.append(Finding(
            file, line, "PRO",
            f"undeclared wire {direction} field {key!r} for op {ctx}: "
            f"declare it in serve/protocol.py {table} (with its min "
            "protocol version) so the wire contract, version "
            "negotiation, and the generated ARCHITECTURE.md protocol "
            "table stay in sync"))

    def code_check(line, node):
        code = _str(node)
        if code is not None and code not in _CODES:
            findings.append(Finding(
                file, line, "PRO",
                f"undeclared error code {code!r}: every structured-"
                "error code raised or compared must be a declared "
                "serve/protocol.py ERROR_CODES value (use the E_* "
                "constant)"))

    for node in nodes:
        access = _wire_key_access(node)
        if access is not None:
            direction, key_node = access
            key = _str(key_node)
            allowed = req_allowed if direction == "request" \
                else resp_allowed
            if key is not None and key not in allowed:
                field_finding(node.lineno, direction, key)
            continue
        if isinstance(node, ast.Dict):
            keys = {_str(k): v for k, v in zip(node.keys, node.values)
                    if _str(k) is not None}
            if "op" not in keys and "v" not in keys:
                continue  # not a wire-message literal
            if "v" in keys and isinstance(keys["v"], ast.Constant) \
                    and isinstance(keys["v"].value, int):
                findings.append(Finding(
                    file, node.lineno, "PRO",
                    "hardcoded protocol version in a message literal: "
                    "stamp protocol.version_for(msg) (the "
                    "FIELD_MIN_VERSION capability table) so rolling "
                    "upgrades keep negotiating instead of pinning a "
                    "version a peer may not speak"))
            if "op" not in keys:
                continue
            op = _str(keys["op"])
            if op is None:
                continue  # computed op: runtime-validated by the daemon
            if op not in protocol.OPS:
                findings.append(Finding(
                    file, node.lineno, "PRO",
                    f"unknown op {op!r} in a wire-message literal "
                    f"(declared ops: {', '.join(protocol.OPS)})"))
                continue
            op_fields = (set(protocol.REQUEST_FIELDS[op]) | _ENVELOPE)
            for key in keys:
                if key not in op_fields:
                    findings.append(Finding(
                        file, node.lineno, "PRO",
                        f"undeclared wire request field {key!r} for op "
                        f"{op!r}: declare it in serve/protocol.py "
                        "REQUEST_FIELDS (with its min protocol version) "
                        "-- an undeclared field never negotiates and an "
                        "older daemon silently drops it"))
            continue
        if isinstance(node, ast.Call):
            f = node.func
            kind = None
            if isinstance(f, ast.Attribute) and f.attr in ("ok", "error") \
                    and dotted_name(f.value) in modules:
                kind = f.attr
            elif isinstance(f, ast.Name) and f.id in funcs:
                kind = funcs[f.id]
            if kind is not None:
                if kind == "error" and node.args:
                    code_check(node.lineno, node.args[0])
                for kw in node.keywords:
                    if kw.arg is not None and kw.arg not in resp_allowed:
                        field_finding(node.lineno, "response", kw.arg)
                continue
            ctor = dotted_name(f)
            if ctor is not None and ctor.split(".")[-1] in (
                    "ProtocolError", "ServeError") and node.args:
                code_check(node.lineno, node.args[0])
            continue
        if isinstance(node, ast.Attribute) and node.attr.startswith("E_") \
                and dotted_name(node.value) in modules:
            if node.attr not in _E_NAMES:
                findings.append(Finding(
                    file, node.lineno, "PRO",
                    f"undeclared error-code constant protocol."
                    f"{node.attr}: declare it (and its code value) in "
                    "serve/protocol.py ERROR_CODES"))
            continue
        if isinstance(node, ast.Compare) and any(
                isinstance(o, (ast.Eq, ast.NotEq, ast.In, ast.NotIn))
                for o in node.ops):
            sides = [node.left, *node.comparators]
            if not any(_code_flavored(s) for s in sides):
                continue
            for side in sides:
                candidates = side.elts if isinstance(
                    side, (ast.Tuple, ast.List, ast.Set)) else [side]
                for cand in candidates:
                    code_check(node.lineno, cand)


def check_pro(tree: ast.AST, file: str) -> list[Finding]:
    """PRO over one module: wire field / op / error-code literals at
    every call site that speaks the serve protocol."""
    modules, funcs, client_imported = _protocol_imports(tree)
    if not modules and not funcs and not client_imported:
        return []
    findings: list[Finding] = []
    covered: set[int] = set()
    for fn in _scope_roots(tree):
        nodes = list(ast.walk(fn))
        covered.update(id(n) for n in nodes)
        _check_pro_nodes(nodes, _context_ops(fn), file, modules, funcs,
                         findings)
    module_nodes = [n for n in ast.walk(tree) if id(n) not in covered]
    _check_pro_nodes(module_nodes, set(), file, modules, funcs, findings)
    return findings


def _registry_unit(units, suffix):
    return next((u for u in units
                 if u.path.replace("\\", "/").endswith(suffix)
                 and u.tree is not None), None)


def _decl_line(source: str, name: str) -> int:
    """The first source line spelling `name` as a quoted literal (the
    registry declaration anchor; 1 when not found)."""
    return next((i + 1 for i, text in enumerate(source.splitlines())
                 if f'"{name}"' in text or f"'{name}'" in text), 1)


def check_pro_registry(units) -> list[Finding]:
    """The registry-coherence half of PRO, over serve/protocol.py itself
    (self-gated like the FPT stale-entry pass)."""
    unit = _registry_unit(units, PROTOCOL_SUFFIX)
    if unit is None:
        return []
    findings: list[Finding] = []

    def at(name: str) -> int:
        return _decl_line(unit.source, name)

    for op in sorted(set(protocol.REQUEST_FIELDS)
                     ^ set(protocol.RESPONSE_FIELDS)):
        findings.append(Finding(
            unit.file, at(op), "PRO",
            f"op {op!r} is declared in only one of REQUEST_FIELDS/"
            "RESPONSE_FIELDS: every op needs both halves of its wire "
            "contract (an empty dict is an explicit 'no fields')"))
    for table_name, table in (
            ("REQUEST_FIELDS", protocol.REQUEST_FIELDS),
            ("RESPONSE_FIELDS", protocol.RESPONSE_FIELDS)):
        for op, fields in table.items():
            for fname, ver in fields.items():
                if not (isinstance(ver, int)
                        and 1 <= ver <= protocol.PROTOCOL_VERSION):
                    findings.append(Finding(
                        unit.file, at(fname), "PRO",
                        f"{table_name}[{op!r}][{fname!r}] min version "
                        f"{ver!r} is outside 1..PROTOCOL_VERSION "
                        f"({protocol.PROTOCOL_VERSION})"))
    flat: dict[str, int] = {}
    for op, fields in protocol.REQUEST_FIELDS.items():
        for fname, ver in fields.items():
            if fname in flat and flat[fname] != ver:
                findings.append(Finding(
                    unit.file, at(fname), "PRO",
                    f"request field {fname!r} carries two min versions "
                    f"({flat[fname]} and {ver}) across ops: "
                    "FIELD_MIN_VERSION flattens by field name, so one "
                    "name must mean one version everywhere"))
            flat[fname] = ver
            if ver > 1 and protocol.FIELD_MIN_VERSION.get(fname) != ver:
                findings.append(Finding(
                    unit.file, at(fname), "PRO",
                    f"rolling-upgrade hazard: post-v1 request field "
                    f"{fname!r} (v{ver}+) is missing from "
                    "FIELD_MIN_VERSION -- version_for() would stamp a "
                    "version too low to carry it and an older daemon "
                    "would silently drop it"))
    const_values = {getattr(protocol, n) for n in _E_NAMES}
    for code in sorted(_CODES - const_values):
        findings.append(Finding(
            unit.file, at(code), "PRO",
            f"ERROR_CODES entry {code!r} has no E_* constant: call "
            "sites spell codes through the constants, so an entry "
            "without one is unreachable by construction"))
    for n in sorted(_E_NAMES):
        if getattr(protocol, n) not in _CODES:
            findings.append(Finding(
                unit.file, at(getattr(protocol, n)), "PRO",
                f"constant {n} = {getattr(protocol, n)!r} is not a "
                "declared ERROR_CODES entry: the registry is the one "
                "source for the code set and its docs"))
    return findings


def wire_literals(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(field names, error-code values) one module references -- the
    DRF protocol sub-audit's per-unit contribution.  Scope-gated like
    check_pro; E_* attribute references count as their code values."""
    modules, funcs, client_imported = _protocol_imports(tree)
    fields: set[str] = set()
    codes: set[str] = set()
    if not modules and not funcs and not client_imported:
        return fields, codes
    for node in ast.walk(tree):
        access = _wire_key_access(node)
        if access is not None:
            key = _str(access[1])
            if key is not None:
                fields.add(key)
            continue
        if isinstance(node, ast.Dict):
            keys = [_str(k) for k in node.keys]
            if "op" in keys or "v" in keys:
                fields.update(k for k in keys if k is not None)
            continue
        if isinstance(node, ast.Call):
            f = node.func
            kind = None
            if isinstance(f, ast.Attribute) and f.attr in ("ok", "error") \
                    and dotted_name(f.value) in modules:
                kind = f.attr
            elif isinstance(f, ast.Name) and f.id in funcs:
                kind = funcs[f.id]
            if kind is not None:
                fields.update(kw.arg for kw in node.keywords
                              if kw.arg is not None)
                if kind == "error" and node.args \
                        and _str(node.args[0]) is not None:
                    codes.add(_str(node.args[0]))
                continue
            ctor = dotted_name(f)
            if ctor is not None and ctor.split(".")[-1] in (
                    "ProtocolError", "ServeError") and node.args \
                    and _str(node.args[0]) is not None:
                codes.add(_str(node.args[0]))
            continue
        if isinstance(node, ast.Attribute) and node.attr in _E_NAMES \
                and dotted_name(node.value) in modules:
            codes.add(getattr(protocol, node.attr))
            continue
        if isinstance(node, ast.Compare):
            sides = [node.left, *node.comparators]
            if not any(_code_flavored(s) for s in sides):
                continue
            for side in sides:
                candidates = side.elts if isinstance(
                    side, (ast.Tuple, ast.List, ast.Set)) else [side]
                codes.update(c for c in map(_str, candidates)
                             if c is not None)
    return fields, codes


# ------------------------------------------------------------ EVT -----
def _event_receivers(tree: ast.AST):
    """(dotted spellings of the events module, dotted spellings of its
    LOG singleton, bare names of the imported emit function)."""
    modules: set[str] = set()
    logs: set[str] = set()
    funcs: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.endswith("obs.events"):
                for alias in node.names:
                    if alias.name == "emit":
                        funcs.add(alias.asname or alias.name)
                    elif alias.name == "LOG":
                        logs.add(alias.asname or alias.name)
            elif mod == "obs" or mod.endswith(".obs"):
                for alias in node.names:
                    if alias.name == "events":
                        modules.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith("obs.events"):
                    modules.add(alias.asname or alias.name)
    return modules, logs, funcs


def _emit_calls(tree: ast.AST):
    """Yield (call node, kind argument node) for every event-log emit
    in the module (module alias, LOG singleton, or bare imported emit;
    locally-defined emit helpers never resolve -- receiver resolution
    is import-gated, the MET discipline)."""
    modules, logs, funcs = _event_receivers(tree)
    if not modules and not logs and not funcs:
        return
    log_spellings = logs | {f"{m}.LOG" for m in modules}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "emit":
            recv = dotted_name(f.value)
            if recv not in modules and recv not in log_spellings:
                continue
        elif not (isinstance(f, ast.Name) and f.id in funcs):
            continue
        arg = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "kind"), None)
        yield node, arg


def check_evt(tree: ast.AST, file: str) -> list[Finding]:
    """EVT over one module: undeclared or non-literal event kinds."""
    findings: list[Finding] = []
    for node, arg in _emit_calls(tree):
        if arg is None:
            continue
        kind = _str(arg)
        if kind is None:
            findings.append(Finding(
                file, node.lineno, "EVT",
                "event kind must be a string literal declared in "
                "obs/events.EVENT_KINDS: a computed kind mints an "
                "unauditable event stream no dashboard or postmortem "
                "tooling knows about"))
        elif kind not in EVENT_KINDS:
            findings.append(Finding(
                file, node.lineno, "EVT",
                f"undeclared event kind {kind!r} in emit(): declare it "
                "in obs/events.EVENT_KINDS (spgemm_tpu_torch/obs/events.py) "
                "so the event log, the DRF drift audit, and the "
                "generated ARCHITECTURE.md event table stay in sync"))
    return findings


def emit_kind_literals(tree: ast.AST) -> set[str]:
    """The string-literal event kinds one module emits (the DRF event
    sub-audit's per-unit contribution)."""
    kinds: set[str] = set()
    for _, arg in _emit_calls(tree):
        kind = _str(arg)
        if kind is not None:
            kinds.add(kind)
    return kinds


# ------------------------------------------------------------ DRF -----
def _knob_read_literals(tree: ast.AST) -> set[str]:
    """The knob names one module reads through the registry accessors
    (knobs.get / knobs.pin, module- or function-imported)."""
    modules: set[str] = set()
    funcs: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod.endswith("utils.knobs"):
                for alias in node.names:
                    if alias.name in ("get", "pin"):
                        funcs.add(alias.asname or alias.name)
            elif mod == "utils" or mod.endswith(".utils"):
                for alias in node.names:
                    if alias.name == "knobs":
                        modules.add(alias.asname or alias.name)
        elif isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name.endswith("utils.knobs"):
                    modules.add(alias.asname or alias.name)
    names: set[str] = set()
    if not modules and not funcs:
        return names
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        hit = (isinstance(f, ast.Attribute) and f.attr in ("get", "pin")
               and dotted_name(f.value) in modules) \
            or (isinstance(f, ast.Name) and f.id in funcs)
        if not hit or not node.args:
            continue
        name = _str(node.args[0])
        if name is not None:
            names.add(name)
    return names


def _engine_name_literals(tree: ast.AST) -> tuple[set[str], set[str]]:
    """(phase/record names, incr names) one module spells at ENGINE
    call sites -- the metrules receiver resolution, reference-collection
    direction."""
    from spgemm_tpu_torch.analysis.metrules import _engine_receivers  # noqa: PLC0415

    receivers = _engine_receivers(tree)
    phases: set[str] = set()
    counters: set[str] = set()
    if not receivers:
        return phases, counters
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("phase", "record", "incr")
                and dotted_name(node.func.value) in receivers):
            continue
        arg = node.args[0] if node.args else next(
            (kw.value for kw in node.keywords if kw.arg == "name"), None)
        name = _str(arg)
        if name is None:
            continue
        (counters if node.func.attr == "incr" else phases).add(name)
    return phases, counters


def _string_constants(tree: ast.AST, exclude_assigns: tuple[str, ...] = ()
                      ) -> set[str]:
    """Every string constant in the module EXCEPT docstrings and the
    subtrees of the named top-level assignments (a registry's own
    declaration block must not count as a reference to itself)."""
    excluded: set[int] = set()
    for node in ast.walk(tree):
        # docstrings: the leading Expr-of-Constant of any body
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                excluded.update(id(n) for n in ast.walk(body[0]))
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            names = {t.id for t in targets if isinstance(t, ast.Name)}
            if names & set(exclude_assigns):
                excluded.update(id(n) for n in ast.walk(node))
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in excluded:
            out.add(node.value)
    return out


def check_drf(units) -> list[Finding]:
    """The registry-drift audit (RAW findings -- core applies the
    drf-ok escape filter): declared-but-never-referenced entries of the
    knob, metric, event-kind, and protocol registries, each sub-audit
    gated on its registry module being in the unit set and anchored at
    the entry's declaration line."""
    findings: list[Finding] = []
    live = [u for u in units if u.tree is not None]

    knobs_unit = _registry_unit(units, KNOBS_SUFFIX)
    if knobs_unit is not None:
        read: set[str] = set()
        for u in live:
            if u is not knobs_unit:
                read |= _knob_read_literals(u.tree)
        for name in sorted(set(KNOB_REGISTRY) - read):
            findings.append(Finding(
                knobs_unit.file, _decl_line(knobs_unit.source, name),
                "DRF",
                f"declared knob {name} is never read through "
                "knobs.get() anywhere in the package: dead registry "
                "surface (setting it changes nothing) -- wire the "
                "reader, delete the entry, or escape with "
                "drf-ok(<reason>) if it is read outside Python"))

    metrics_unit = _registry_unit(units, METRICS_SUFFIX)
    if metrics_unit is not None:
        phases: set[str] = set()
        counters: set[str] = set()
        strings: set[str] = set()
        for u in live:
            ph, ct = _engine_name_literals(u.tree)
            phases |= ph
            counters |= ct
            if u is metrics_unit:
                strings |= _string_constants(
                    u.tree, ("_METRICS", "ENGINE_PHASES",
                             "ENGINE_COUNTERS"))
            else:
                strings |= _string_constants(u.tree)
        for name in sorted(set(ENGINE_PHASES) - phases - strings):
            findings.append(Finding(
                metrics_unit.file,
                _decl_line(metrics_unit.source, name), "DRF",
                f"declared ENGINE phase {name!r} has no ENGINE.phase/"
                "record site anywhere in the package: a time series "
                "that can never move -- wire the site or delete the "
                "entry (escape: drf-ok(<reason>))"))
        for name in sorted(set(ENGINE_COUNTERS) - counters - strings):
            findings.append(Finding(
                metrics_unit.file,
                _decl_line(metrics_unit.source, name), "DRF",
                f"declared ENGINE counter {name!r} has no ENGINE.incr "
                "site anywhere in the package: a counter that can "
                "never move -- wire the site or delete the entry "
                "(escape: drf-ok(<reason>))"))
        for name in sorted(set(METRIC_REGISTRY) - strings):
            findings.append(Finding(
                metrics_unit.file,
                _decl_line(metrics_unit.source, name), "DRF",
                f"declared metric family {name!r} is never referenced "
                "outside its registry entry: nothing renders it, so "
                "the scrape can never carry it -- wire the emitter or "
                "delete the entry (escape: drf-ok(<reason>))"))

    events_unit = _registry_unit(units, EVENTS_SUFFIX)
    if events_unit is not None:
        emitted: set[str] = set()
        for u in live:
            if u is not events_unit:
                emitted |= emit_kind_literals(u.tree)
        for name in sorted(set(EVENT_KINDS) - emitted):
            findings.append(Finding(
                events_unit.file,
                _decl_line(events_unit.source, name), "DRF",
                f"declared event kind {name!r} is never emitted "
                "anywhere in the package: dead event surface -- wire "
                "the emit site or delete the entry (escape: "
                "drf-ok(<reason>))"))

    protocol_unit = _registry_unit(units, PROTOCOL_SUFFIX)
    if protocol_unit is not None:
        fields: set[str] = set()
        codes: set[str] = set()
        for u in live:
            if u is protocol_unit:
                continue
            fl, cd = wire_literals(u.tree)
            fields |= fl
            codes |= cd
        declared_fields: dict[str, str] = {}
        for op in protocol.OPS:
            for fname in protocol.REQUEST_FIELDS[op]:
                declared_fields.setdefault(fname, f"op {op!r} request")
            for fname in protocol.RESPONSE_FIELDS[op]:
                declared_fields.setdefault(fname, f"op {op!r} response")
        for fname in protocol.ENVELOPE_FIELDS:
            declared_fields.setdefault(fname, "envelope")
        for fname in sorted(set(declared_fields) - fields):
            findings.append(Finding(
                protocol_unit.file,
                _decl_line(protocol_unit.source, fname), "DRF",
                f"declared wire field {fname!r} "
                f"({declared_fields[fname]}) is never referenced at "
                "any call site: dead wire surface -- wire the "
                "reader/writer or delete the entry (escape: "
                "drf-ok(<reason>))"))
        for code in sorted(_CODES - codes):
            findings.append(Finding(
                protocol_unit.file,
                _decl_line(protocol_unit.source, code), "DRF",
                f"declared error code {code!r} is never raised or "
                "compared at any call site: dead error surface -- "
                "wire the site or delete the entry (escape: "
                "drf-ok(<reason>))"))
    return findings
