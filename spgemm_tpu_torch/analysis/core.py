"""spgemm-lint driver: file walking, rule scoping, findings, suppressions.

Rule scoping is by path SUFFIX (posix-normalized), so the test fixtures
under tests/torch_lint_fixtures/ops/... exercise exactly the production
scoping logic.  Everything here is stdlib-only (ast + os) plus the port's
own registry modules, which load neither torch nor numpy: the linter must
run on a host with no card and no CUDA runtime -- importing torch to lint
for import-time CUDA-context creation would be self-defeating.

v2 grew the per-module AST passes into a package-level analysis: a run
over several files parses them once into LintUnits, runs the per-file
rule families, then the interprocedural fold-order pass (callgraph.py)
over the whole unit set, and finally the suppression audit -- every
escape-hatch comment is inventoried, and an escape whose underlying
finding no longer exists is itself a finding (SUP, like an unused noqa).
"""

from __future__ import annotations

import ast
import fnmatch
import hashlib
import io
import json
import os
import sys
import tokenize
from dataclasses import asdict, dataclass, field

# FLD scope: the modules on the numeric path, where the reference's
# wrap-then-mod fold order is load-bearing (SURVEY.md section 2.9).
# Suffixes carry a leading "/" so matching is path-segment-anchored
# (a hypothetical devops/spgemm.py must not land in numeric scope).
NUMERIC_SUFFIXES = (
    "/ops/u64.py",
    "/ops/spgemm.py",
    "/ops/mxu_spgemm.py",
    "/ops/estimate.py",
    "/ops/delta.py",
    "/parallel/ring.py",
    "/parallel/rowshard.py",
)
# the kernel wrappers: each holds its kernel's plain PyTorch version, the
# fold the CUDA kernel must reproduce bit for bit
NUMERIC_GLOBS = ("*/ops/cuda_*.py",)

# KNB exemption: the registry itself is the one blessed reader.
KNOB_REGISTRY_SUFFIX = "/utils/knobs.py"
# BKD exemption: the probe exists precisely to touch the backend safely.
BACKEND_PROBE_SUFFIX = "/utils/backend_probe.py"

# Escape-hatch directives, one marker per rule family that has one.  Every
# escape needs a non-empty reason -- the reason is the reviewable citation
# -- and every escape is audited: one that suppresses nothing is a SUP
# finding (see lint_report).
FLD_ESCAPE = "spgemm-lint: fld-proof("
THR_ESCAPE = "spgemm-lint: thr-ok("
EXC_ESCAPE = "spgemm-lint: exc-ok("
LCK_ESCAPE = "spgemm-lint: lck-ok("
BLK_ESCAPE = "spgemm-lint: blk-ok("
TSI_ESCAPE = "spgemm-lint: tsi-ok("
DRF_ESCAPE = "spgemm-lint: drf-ok("
ESCAPE_MARKERS = {"FLD": FLD_ESCAPE, "THR": THR_ESCAPE, "EXC": EXC_ESCAPE,
                  "LCK": LCK_ESCAPE, "BLK": BLK_ESCAPE, "TSI": TSI_ESCAPE,
                  "DRF": DRF_ESCAPE}

# The rule-id registry: single source for the CLI --help epilog, the JSON
# counts object, and the SARIF tool.driver.rules metadata (docrules checks
# the --help epilog covers every id, so the list cannot silently drift).
RULES = {
    "FLD": "unordered reduction on the numeric path (fold order is "
           "load-bearing; includes the interprocedural pass: a numeric-"
           "module call into a helper that transitively performs an "
           "unordered reduction); escape: fld-proof(<reason>)",
    "KNB": "raw SPGEMM_TPU_* environment read outside the central registry "
           "spgemm_tpu_torch/utils/knobs.py",
    "BKD": "CUDA-context-creating or -querying call (torch.cuda.*, "
           "torch.distributed.init_process_group, .cuda()) at module "
           "import time (or anywhere in a @host_only worker body) "
           "outside utils/backend_probe.py",
    "THR": "attribute declared `# spgemm-lint: guarded-by(<lock>)` "
           "accessed without holding the lock; escape: thr-ok(<reason>)",
    "LCK": "lock-order deadlock hazard: a cycle in the interprocedural "
           "lock-acquisition-order graph (two paths acquire registered "
           "locks in opposite orders), or a non-reentrant lock "
           "re-acquired while already held; escape: lck-ok(<reason>)",
    "BLK": "blocking operation (sleep, subprocess, flock/fsync, socket "
           "accept/recv/sendall, Queue.get/put, Thread.join, "
           "Event/Condition.wait, torch.cuda.synchronize and stream/event "
           ".synchronize(), torch.distributed collectives and store "
           "waits) reached while a registered lock is held, with the "
           "witness chain; escape: "
           "blk-ok(<reason>)",
    "TSI": "thread-shared inference: an instance attribute or module "
           "global written from >= 2 thread roots "
           "(threading.Thread targets) without a guarded-by(<lock>) "
           "annotation -- THR's opt-in hole, closed; escape: "
           "tsi-ok(<reason>)",
    "EXC": "broad `except Exception` without a `# noqa: BLE001 -- "
           "<reason>` justification, or a bare except / "
           "`except BaseException` that does not provably re-raise "
           "(the JobAbandoned contract); escape: exc-ok(<reason>)",
    "MET": "ENGINE.phase/record/incr metric name that is not a string "
           "literal declared in the metrics registry "
           "spgemm_tpu_torch/obs/metrics.py (no ad-hoc time-series names)",
    "FPT": "failpoints.check() name that is not a string literal "
           "declared in the failpoint registry "
           "spgemm_tpu_torch/utils/failpoints.py, or a registry entry with no "
           "check() site anywhere in the package (stale chaos surface)",
    "PRO": "wire-contract violation against the serve/protocol.py "
           "registry: an undeclared request/response field literal for "
           "the op in play, an unknown op in a message literal, an "
           "error code that is not a declared ERROR_CODES value, a "
           "hardcoded protocol version (rolling-upgrade hazard), or an "
           "incoherent registry (request/response op mismatch, a "
           "post-v1 field missing its FIELD_MIN_VERSION entry, E_* "
           "constants out of sync with ERROR_CODES)",
    "EVT": "emit()/LOG.emit() event kind that is not a string literal "
           "declared in the event registry spgemm_tpu_torch/obs/events.py "
           "EVENT_KINDS (no ad-hoc event streams)",
    "DRF": "registry drift (the reverse audit): a declared knob never "
           "read through knobs.get(), an ENGINE phase/counter or metric "
           "family never referenced, an event kind never emitted, or a "
           "protocol field / error code never referenced anywhere in "
           "the package; escape: drf-ok(<reason>)",
    "DOC": "generated doc drift (spgemm_tpu_torch/ARCHITECTURE.md knob, "
           "metrics, protocol, event and thread tables, CLI help knob "
           "coverage, analysis --help rule-id coverage)",
    "SUP": "stale suppression: an escape-hatch comment whose underlying "
           "finding no longer exists (delete the escape)",
    "PARSE": "file does not parse (no other rule ran on it)",
}


@dataclass(frozen=True)
class Finding:
    file: str   # repo-relative posix path (absolute if outside the repo)
    line: int   # 1-indexed
    rule: str   # family id: see RULES
    message: str

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class Suppression:
    """One escape-hatch comment, for the --json inventory.  stale=True
    means the escape suppresses nothing (also reported as a SUP finding)."""

    file: str
    line: int
    rule: str    # escape family (FLD | THR | EXC | LCK | BLK | TSI | DRF)
    reason: str
    stale: bool

    def to_dict(self) -> dict:
        return asdict(self)


def repo_root() -> str:
    """The directory containing the spgemm_tpu_torch package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _posix(path: str) -> str:
    return os.path.abspath(path).replace(os.sep, "/")


def rel_file(path: str) -> str:
    """Repo-relative posix path for findings (absolute when outside)."""
    root = _posix(repo_root())
    p = _posix(path)
    if p.startswith(root + "/"):
        return p[len(root) + 1:]
    return p


def is_numeric_module(path: str) -> bool:
    p = _posix(path)
    return (p.endswith(NUMERIC_SUFFIXES)
            or any(fnmatch.fnmatch(p, g) for g in NUMERIC_GLOBS))


def comment_map(source: str) -> dict[int, str]:
    """1-indexed line -> comment text (including the `#`).  Tokenize-based,
    so directive markers quoted in docstrings or string literals (this very
    package documents its own markers) never register as live directives.
    A file that fails to tokenize yields {} -- it will carry a PARSE
    finding and no directive-driven rule runs on it anyway."""
    out: dict[int, str] = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(source).readline):
            if tok.type == tokenize.COMMENT:
                out[tok.start[0]] = tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return {}
    return out


def _escape_map(comments: dict[int, str], marker: str) -> dict[int, str]:
    """1-indexed line -> reason for escape-hatch directives with a
    non-empty reason.  A bare `fld-proof()` is NOT an escape: the reason
    is the reviewable proof citation."""
    out: dict[int, str] = {}
    for i, text in comments.items():
        pos = text.find(marker)
        if pos < 0:
            continue
        rest = text[pos + len(marker):]
        reason = rest.split(")", 1)[0].strip()
        if reason:
            out[i] = reason
    return out


class LintUnit:
    """One parsed file: source, AST (None on a syntax error), numeric-path
    scoping, and the per-rule escape maps.  Parsed once per run and shared
    by the per-file rules, the interprocedural pass, and the audit."""

    def __init__(self, path: str, *, numeric: bool | None = None):
        self.path = path
        self.file = rel_file(path)
        with open(path, encoding="utf-8") as f:
            self.source = f.read()
        self.parse_finding: Finding | None = None
        try:
            self.tree: ast.AST | None = ast.parse(self.source, filename=path)
        except SyntaxError as e:
            self.tree = None
            # a broken file means NO rule ran on it -- its own rule id, so
            # JSON-count consumers never blame a rule family for it
            self.parse_finding = Finding(
                self.file, e.lineno or 1, "PARSE",
                f"file does not parse: {e.msg}")
        self.numeric = is_numeric_module(path) if numeric is None else numeric
        self.comments = comment_map(self.source)
        self.escapes = {rule: _escape_map(self.comments, marker)
                        for rule, marker in ESCAPE_MARKERS.items()}


def escape_at(escapes: dict[int, str], line: int) -> int | None:
    """The escape line covering `line` -- the line itself or the one
    above (the two lines every spgemm-lint escape can attach to).  THE
    one spelling of the attachment rule: the per-file filter, the
    suppressed-split, and the lockrules emit paths all call this."""
    if line in escapes:
        return line
    if line - 1 in escapes:
        return line - 1
    return None


def _lint_unit(unit: LintUnit) -> tuple[list[Finding],
                                        set[tuple[str, str, int]],
                                        list[tuple[Finding, str]]]:
    """The per-file rule families (FLD/KNB/BKD/THR/EXC) over one unit.

    Each escapable family runs ONCE with escapes ignored; the escape
    filter is applied here, so the same pass yields the surviving
    findings, the raw (file, rule, line) triples the suppression audit
    needs to tell used escapes from stale ones, and the suppressed
    findings with their justifications (the SARIF suppressions surface)."""
    from spgemm_tpu_torch.analysis import (excrules, fptrules, metrules,  # noqa: PLC0415
                                     protorules, rules, thrrules)

    if unit.tree is None:
        return [unit.parse_finding], set(), []
    p = _posix(unit.path)
    findings: list[Finding] = []
    raw: set[tuple[str, str, int]] = set()
    suppressed: list[tuple[Finding, str]] = []

    def escaping(family: list[Finding], rule: str) -> list[Finding]:
        escapes = unit.escapes[rule]
        out = []
        for f in family:
            raw.add((f.file, rule, f.line))
            esc = escape_at(escapes, f.line)
            if esc is None:
                out.append(f)
            else:
                suppressed.append((f, escapes[esc]))
        return out

    if unit.numeric:
        findings += escaping(rules.check_fld(unit.tree, unit.file, set()),
                             "FLD")
    if not p.endswith(KNOB_REGISTRY_SUFFIX):
        findings += rules.check_knb(unit.tree, unit.file)
    if not p.endswith(BACKEND_PROBE_SUFFIX):
        findings += rules.check_bkd(unit.tree, unit.file)
    findings += escaping(thrrules.check_thr(unit, set()), "THR")
    findings += escaping(excrules.check_exc(unit, set()), "EXC")
    findings += metrules.check_met(unit.tree, unit.file)
    findings += fptrules.check_fpt(unit.tree, unit.file)
    # the registry modules never self-report: protocol.py speaks no op
    # (no import of itself, so PRO self-gates) and events.py's own emit
    # machinery is the registry, not a call site
    if not p.endswith(protorules.PROTOCOL_SUFFIX):
        findings += protorules.check_pro(unit.tree, unit.file)
    if not p.endswith(protorules.EVENTS_SUFFIX):
        findings += protorules.check_evt(unit.tree, unit.file)
    return findings, raw, suppressed


def lint_file(path: str, *, numeric: bool | None = None) -> list[Finding]:
    """Run the per-file rule families over one file.

    numeric: override the path-based FLD scoping (tests); None = derive
    from the path suffix.  The cross-file passes (interprocedural FLD,
    the LCK/BLK/TSI concurrency pass, the suppression audit) need the
    whole unit set -- use lint_paths."""
    return _lint_unit(LintUnit(path, numeric=numeric))[0]


# under build/ (git-ignored), and NOT the JAX linter's .lint_cache/: a
# default-scope run of that linter prunes every entry outside its own
# scope, and its signature keys on its own package's bytes, so a shared
# directory would empty or invalidate this linter's entries on every run
DEFAULT_CACHE_DIR = os.path.join("build", "lint_cache")


# registry modules the CACHED per-file rules validate against: MET reads
# ENGINE_PHASES/ENGINE_COUNTERS from obs/metrics.py, FPT reads REGISTRY
# from utils/failpoints.py, PRO reads the field/op/error tables from
# serve/protocol.py, EVT reads EVENT_KINDS from obs/events.py -- a
# registry edit must invalidate every cached entry even when the call
# sites' own files are untouched, so all four are part of the
# linter-version signature (paths relative to the spgemm_tpu package
# root)
_SIGNATURE_EXTRAS = ("obs/metrics.py", "utils/failpoints.py",
                     "serve/protocol.py", "obs/events.py")


def _analysis_signature() -> str:
    """Content hash of the analysis package itself plus the registry
    modules the cached rules consult -- the linter-version half of every
    cache key, so ANY rule or registry change (not just a forgotten
    version bump) invalidates every cached entry."""
    h = hashlib.sha256()
    # results also depend on the running interpreter's ast/tokenize
    # behavior (f-string tokenization, node shapes shift across
    # minors): a CI image bump must not serve the old Python's results
    h.update(sys.version.encode())
    pkg = os.path.dirname(os.path.abspath(__file__))
    files = [(name, os.path.join(pkg, name))
             for name in sorted(os.listdir(pkg)) if name.endswith(".py")]
    files += [(rel, os.path.join(os.path.dirname(pkg), rel))
              for rel in _SIGNATURE_EXTRAS]
    for label, path in files:
        h.update(label.encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


class LintCache:
    """Content-hash cache for the per-file rule families.

    One JSON file (default `build/lint_cache/cache.json` under the repo
    root)
    maps a unit's repo-relative path to its per-file findings, raw
    triples, and suppressed findings, keyed by (sha256 of the file
    contents, sha256 of the analysis package).  The linter is proven
    env-independent and torch-free (tests pin both), so per-file results
    are a pure function of exactly those two hashes -- a warm `make lint`
    re-runs only changed files.  The cross-file passes (interprocedural
    FLD, LCK/BLK/TSI, the FPT registry direction, the suppression audit,
    DOC) always run live: they are whole-program by definition.

    hit = entry matched; miss = no entry for the file; invalidation =
    entry present but stale (file or linter changed) and replaced.
    Writes are atomic (tmp + os.replace) and best-effort: a racing or
    read-only cache degrades to a cold run, never an error."""

    def __init__(self, directory: str | None = None):
        self.directory = directory or os.path.join(repo_root(),
                                                   DEFAULT_CACHE_DIR)
        self.path = os.path.join(self.directory, "cache.json")
        self.signature = _analysis_signature()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self._dirty = False
        self._files: dict[str, dict] = {}
        try:
            with open(self.path, encoding="utf-8") as f:
                data = json.load(f)
            if isinstance(data, dict) and isinstance(data.get("files"),
                                                     dict):
                self._files = data["files"]
        except (OSError, ValueError):
            self._files = {}

    @staticmethod
    def content_key(source: str) -> str:
        return hashlib.sha256(source.encode("utf-8")).hexdigest()

    def get(self, file: str, sha: str):
        """Cached (findings, raw, suppressed) for a unit, or None."""
        entry = self._files.get(file)
        if entry is None:
            self.misses += 1
            return None
        try:
            if entry.get("sha") != sha \
                    or entry.get("version") != self.signature:
                self.invalidations += 1
                return None
            findings = [Finding(**f) for f in entry["findings"]]
            raw = {(r[0], r[1], r[2]) for r in entry["raw"]}
            suppressed = [(Finding(**f), reason)
                          for f, reason in entry["suppressed"]]
        except (AttributeError, KeyError, IndexError, TypeError,
                ValueError):
            # structurally malformed entry (hand edit, bad merge, torn
            # concurrent write that still parses): the cold-run
            # fallback, never a crash
            self.invalidations += 1
            return None
        self.hits += 1
        return findings, raw, suppressed

    def put(self, file: str, sha: str, findings, raw, suppressed) -> None:
        self._files[file] = {
            "sha": sha, "version": self.signature,
            "findings": [f.to_dict() for f in findings],
            "raw": sorted(list(t) for t in raw),
            "suppressed": [[f.to_dict(), reason]
                           for f, reason in suppressed],
        }
        self._dirty = True

    def prune(self, keep: set[str]) -> None:
        """Drop entries for files no longer in the linted set (renames,
        deletions) -- called on default-scope runs so cache.json cannot
        grow without bound under a long-lived checkout."""
        for file in [f for f in self._files if f not in keep]:
            del self._files[file]
            self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        try:
            os.makedirs(self.directory, exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"files": self._files}, f)
            os.replace(tmp, self.path)
        except OSError:
            pass  # read-only / racing cache dir: next run is just cold

    def stats(self) -> dict:
        return {"enabled": True, "dir": self.directory, "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations}


def _walk_py(path: str) -> list[str]:
    if os.path.isfile(path):
        return [path]
    out = []
    for dirpath, dirnames, filenames in os.walk(path):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                   if f.endswith(".py"))
    return out


def _audit_suppressions(units: list[LintUnit],
                        raw: set[tuple[str, str, int]],
                        extra_used: set[tuple[str, str, int]]
                        ) -> list[Suppression]:
    """The suppression inventory.  An escape is USED when the raw run of
    its rule family (escapes ignored -- the (file, rule, line) triples the
    per-file AND package-level passes produced) has a finding on the
    escape's line or the line below (the two lines an escape can attach
    to), or when it appears in extra_used: (file, rule, escape line) of
    SOURCE escapes that suppressed taint without an anchored raw finding
    (an fld-proof on a reduction, a blk-ok on the blocking op itself, a
    tsi-ok on a non-anchor write line)."""
    out: list[Suppression] = []
    for u in units:
        for rule, escapes in u.escapes.items():
            for line, reason in sorted(escapes.items()):
                used = ((u.file, rule, line) in raw
                        or (u.file, rule, line + 1) in raw
                        or (u.file, rule, line) in extra_used)
                out.append(Suppression(u.file, line, rule, reason,
                                       stale=not used))
    return out


@dataclass
class Report:
    """One full lint run: surviving findings, the escape inventory, the
    suppressed findings with their justifications (the SARIF
    `suppressions` surface), and the cache figures when a LintCache was
    in play."""

    findings: list[Finding] = field(default_factory=list)
    suppressions: list[Suppression] = field(default_factory=list)
    suppressed: list[tuple[Finding, str]] = field(default_factory=list)
    cache: dict | None = None


def _escaped_split(findings: list[Finding], raw: list[Finding],
                   units_by_file: dict[str, LintUnit], rule: str,
                   ) -> list[tuple[Finding, str]]:
    """The raw-minus-surviving findings of a package-level pass, paired
    with the escape reasons that suppressed them."""
    survived = set(findings)
    out = []
    for f in raw:
        if f in survived:
            continue
        unit = units_by_file.get(f.file)
        if unit is None:
            continue
        escapes = unit.escapes.get(rule, {})
        esc = escape_at(escapes, f.line)
        if esc is not None:
            out.append((f, escapes[esc]))
    return out


def lint_run(paths: list[str], *, claude_md: str | None = None,
             doc: bool = True, cache: LintCache | None = None) -> Report:
    """The full v3 run over files/directories: per-file rules (optionally
    content-hash cached), the interprocedural fold-order pass, the
    LCK/BLK/TSI concurrency pass, the suppression audit (stale escapes
    are SUP findings; the full inventory rides the report), and
    optionally the DOC drift checks (claude_md None = skip the table
    checks; the CLI/analysis help checks ride the same flag)."""
    from spgemm_tpu_torch.analysis import (callgraph, docrules,  # noqa: PLC0415
                                     fptrules, lockrules, protorules)

    units = [LintUnit(f) for path in paths for f in _walk_py(path)]
    units_by_file = {u.file: u for u in units}
    is_default_scope = list(paths) == default_paths()
    report = Report()
    findings = report.findings
    raw: set[tuple[str, str, int]] = set()
    for u in units:
        cached = None
        if cache is not None:
            sha = cache.content_key(u.source)
            cached = cache.get(u.file, sha)
        if cached is None:
            unit_findings, unit_raw, unit_sup = _lint_unit(u)
            if cache is not None:
                cache.put(u.file, sha, unit_findings, unit_raw, unit_sup)
        else:
            unit_findings, unit_raw, unit_sup = cached
        findings += unit_findings
        raw |= unit_raw
        report.suppressed += unit_sup
    if cache is not None:
        if is_default_scope:
            cache.prune({u.file for u in units})
        cache.save()
        report.cache = cache.stats()
    # the FPT stale-entry direction needs the whole unit set (a registry
    # entry is live if ANY module checks it); it self-gates on the
    # registry module being in scope, so fixture runs stay quiet
    findings += fptrules.check_fpt_registry(units)
    # the PRO registry-coherence direction (self-gated the same way)
    findings += protorules.check_pro_registry(units)
    # DRF: the reverse (drift) audit over every registry, raw findings
    # filtered through drf-ok escapes at the registry declaration lines
    # and fed to the suppression audit like any escapable family
    drf_raw = protorules.check_drf(units)
    drf_findings = []
    for f in drf_raw:
        unit = units_by_file.get(f.file)
        escapes = unit.escapes.get("DRF", {}) if unit is not None else {}
        if escape_at(escapes, f.line) is None:
            drf_findings.append(f)
    findings += drf_findings
    report.suppressed += _escaped_split(drf_findings, drf_raw,
                                        units_by_file, "DRF")
    for f in drf_raw:
        raw.add((f.file, "DRF", f.line))
    # package-level passes: interprocedural FLD taint, then the
    # concurrency-soundness pass (lock order / blocking-under-lock /
    # thread-shared inference) over the same call graph.  Their raw
    # findings feed the audit exactly like per-file raw runs: an escape
    # is used iff a raw finding sits ON its line or the line below; their
    # source-escape sets (taint suppressed at the source, no anchored
    # finding) arrive as exact (file, rule, escape-line) triples.
    extra_used: set[tuple[str, str, int]] = set()
    prebuilt = callgraph.build(units)
    cg_findings, cg_raw, cg_used = callgraph.check(units,
                                                   prebuilt=prebuilt)
    findings += cg_findings
    report.suppressed += _escaped_split(cg_findings, cg_raw,
                                        units_by_file, "FLD")
    for f in cg_raw:
        raw.add((f.file, "FLD", f.line))
    for file, line in cg_used:
        extra_used.add((file, "FLD", line))
    # when this run's unit set IS the default scope and the DOC checks
    # will want the thread-inventory table, harvest the rows from the
    # concurrency pass's analysis instead of rebuilding the whole
    # program a second time inside docrules
    inv_rows: list | None = None
    if doc and claude_md is not None and is_default_scope:
        inv_rows = []
    lk_suppressed: list = []
    lk_findings, lk_raw, lk_used = lockrules.check(units,
                                                   inventory=inv_rows,
                                                   prebuilt=prebuilt,
                                                   suppressed=lk_suppressed)
    findings += lk_findings
    for f in lk_raw:
        raw.add((f.file, f.rule, f.line))
    for rule in ("LCK", "BLK"):
        report.suppressed += _escaped_split(
            [f for f in lk_findings if f.rule == rule],
            [f for f in lk_raw if f.rule == rule], units_by_file, rule)
    # TSI escapes can sit on non-anchor write lines the anchor-based
    # split cannot see; the pass hands the pairs over directly
    report.suppressed += lk_suppressed
    extra_used |= lk_used
    suppressions = _audit_suppressions(units, raw, extra_used)
    report.suppressions = suppressions
    for s in suppressions:
        if s.stale:
            findings.append(Finding(
                s.file, s.line, "SUP",
                f"stale suppression: `{ESCAPE_MARKERS[s.rule]}{s.reason})` "
                f"suppresses nothing here (no underlying {s.rule} finding "
                "on this or the next line); delete the escape comment"))
    if doc:
        if claude_md is not None:
            findings += docrules.check_claude_md(claude_md)
            # the metrics and thread-inventory tables live in the
            # ARCHITECTURE.md beside the knob-table file in play (on the
            # port's own doc set they are one file).  Only a CUSTOM
            # --claude-md with no sibling ARCHITECTURE.md (fixture runs)
            # skips the checks; in the port's doc directory a
            # missing/renamed ARCHITECTURE.md is a DOC finding ("cannot
            # read"), never a silently disabled drift guard -- symmetric
            # with the knob table.
            doc_dir = os.path.dirname(os.path.abspath(claude_md))
            arch = os.path.join(doc_dir, "ARCHITECTURE.md")
            if os.path.exists(arch) or doc_dir == _posix(docs_dir()) \
                    or doc_dir == docs_dir():
                findings += docrules.check_architecture_md(arch)
                findings += docrules.check_protocol_table(arch)
                findings += docrules.check_event_table(arch)
                findings += docrules.check_thread_inventory(arch,
                                                            inv_rows)
        findings += docrules.check_cli_help()
        findings += docrules.check_analysis_help()
    findings.sort(key=lambda f: (f.file, f.line, f.rule))
    return report


def lint_report(paths: list[str], *, claude_md: str | None = None,
                doc: bool = True) -> tuple[list[Finding], list[Suppression]]:
    """lint_run as the historical (findings, suppressions) pair."""
    report = lint_run(paths, claude_md=claude_md, doc=doc)
    return report.findings, report.suppressions


def lint_paths(paths: list[str], *, claude_md: str | None = None,
               doc: bool = True) -> list[Finding]:
    """lint_report without the suppression inventory (findings only)."""
    return lint_report(paths, claude_md=claude_md, doc=doc)[0]


def default_paths() -> list[str]:
    """The default lint scope: the package plus the driver-facing script
    that reads engine knobs (chip_smoke.py).  tests/ stays out -- fixtures
    seed violations on purpose, and tests legitimately poke knob values
    via monkeypatch."""
    root = repo_root()
    return [p for p in (os.path.join(root, "spgemm_tpu_torch"),
                        os.path.join(root, "chip_smoke.py"))
            if os.path.exists(p)]


def docs_dir() -> str:
    """Where the port's generated doc tables live (its ARCHITECTURE.md)."""
    return os.path.join(repo_root(), "spgemm_tpu_torch")


def default_doc() -> str:
    """The port's ARCHITECTURE.md: it carries every generated table, the
    knob table included (the port has no CLAUDE.md of its own)."""
    return os.path.join(docs_dir(), "ARCHITECTURE.md")


def lint_repo() -> list[Finding]:
    """Self-lint the default scope + the port's docs: the tier-1 contract
    is that this returns []."""
    return lint_paths(default_paths(), claude_md=default_doc())
