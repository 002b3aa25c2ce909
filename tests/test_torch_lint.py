"""The port's spgemm-lint (spgemm_tpu_torch/analysis/): the port self-lints
clean (tier-1 gate), and each seeded fixture violation (FLD incl. the
interprocedural pass / KNB / BKD / THR / LCK / BLK / TSI / EXC / MET / FPT /
PRO / EVT / DRF / SUP / DOC) is caught with the correct rule ID -- both
in-process and through the `python -m spgemm_tpu_torch.analysis --json` /
`--sarif` reports -- plus the content-hash result cache, SARIF
`suppressions` objects on escaped findings, and the generated
spgemm_tpu_torch/ARCHITECTURE.md tables.

The counterparts of tests/test_lint.py.  FLD, BKD, MET, FPT, PRO, EVT, DRF
and DOC run on fixtures spelled in torch idiom and named in the port's
registries (tests/torch_lint_fixtures/); the rules that read no registry
and no JAX call name run on the JAX package's fixtures in place
(tests/lint_fixtures/, never copied), and a parity test holds both linters
to the same findings there."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from conftest import run_repo_script as _run
from spgemm_tpu_torch.analysis import (check_claude_md, core, docrules,
                                       lint_file, lint_repo)

REPO = core.repo_root()
FIXTURES = os.path.join(REPO, "tests", "torch_lint_fixtures")
FIXTURE_DOC = os.path.join(FIXTURES, "DRIFTED.md")
# the JAX package's idiom-free fixtures, read in place
JAX_FIXTURES = os.path.join(REPO, "tests", "lint_fixtures")
PARITY_FIXTURES = ("badthread.py", "badlockorder.py", "badblocking.py",
                   "badshared.py", "badexcept.py", "badknob.py",
                   "stalesup.py")


def _fixture_lines(name: str, needle: str) -> list[int]:
    """1-indexed lines of a fixture whose text contains needle (the port's
    fixture of that name, else the JAX package's)."""
    base = FIXTURES if os.path.exists(os.path.join(FIXTURES, name)) \
        else JAX_FIXTURES
    src = open(os.path.join(base, name)).read()
    return [i for i, ln in enumerate(src.splitlines(), 1) if needle in ln]


# ------------------------------------------------------- self-lint gate --
def test_repo_self_lints_clean():
    """The tier-1 contract: zero findings on the port -- package AST rules
    AND the doc drift checks (the ARCHITECTURE.md tables, CLI help)."""
    findings = lint_repo()
    assert findings == [], "\n".join(
        f"{f.file}:{f.line}: [{f.rule}] {f.message}" for f in findings)


def test_default_scope_covers_driver_scripts():
    """chip_smoke.py reads engine knobs too -- the default walk must keep
    it under the KNB/BKD contract; the JAX package stays out (its own
    linter holds it)."""
    names = {os.path.basename(p) for p in core.default_paths()}
    assert names == {"spgemm_tpu_torch", "chip_smoke.py"}


# ------------------------------------------------------------- FLD rule --
def test_fld_fixture_each_violation_caught():
    findings = lint_file(os.path.join(FIXTURES, "ops", "spgemm.py"))
    fld = [f for f in findings if f.rule == "FLD"]
    # torch.sum, dist.all_reduce, dist.reduce_scatter_tensor, .index_add_,
    # .scatter_add_, torch.scatter_reduce, torch.segment_reduce,
    # functools.reduce, method .sum()
    assert len(fld) == 9
    assert [f.line for f in fld] == [
        _fixture_lines("ops/spgemm.py", "seeded FLD")[i] for i in range(9)]
    legal = _fixture_lines("ops/spgemm.py", "index_copy_")[0]
    assert legal not in [f.line for f in fld]
    assert [f for f in findings if f.rule != "FLD"] == []
    assert all(f.file.endswith("ops/spgemm.py") and f.line > 0 for f in fld)


def test_fld_escape_hatch_suppresses_with_reason():
    src = open(os.path.join(FIXTURES, "ops", "spgemm.py")).read()
    escaped_line = next(i for i, ln in enumerate(src.splitlines(), 1)
                        if "escaped: must NOT" in ln)
    findings = lint_file(os.path.join(FIXTURES, "ops", "spgemm.py"))
    assert escaped_line not in [f.line for f in findings]


def test_fld_escape_requires_reason(tmp_path):
    """A bare fld-proof() is not an escape: the reason is the citation."""
    p = tmp_path / "ops" / "u64.py"  # numeric-path suffix
    p.parent.mkdir()
    p.write_text("import torch\n"
                 "def f(x):\n"
                 "    # spgemm-lint: fld-proof()\n"
                 "    return torch.sum(x)\n")
    assert [f.rule for f in lint_file(str(p))] == ["FLD"]


def test_fld_scope_is_path_based(tmp_path):
    """The same reductions in a non-numeric module are not findings."""
    p = tmp_path / "hostutil.py"
    p.write_text("import torch\n"
                 "def f(x):\n"
                 "    return torch.sum(x)\n")
    assert lint_file(str(p)) == []
    assert [f.rule for f in lint_file(str(p), numeric=True)] == ["FLD"]


def test_fld_delta_module_in_numeric_scope():
    """ops/delta.py (incremental recompute) is in the numeric-lint scope:
    its reachability masks gate which output rows re-fold, so a smuggled
    unordered reduction is a finding -- and the LIVE module self-lints
    clean."""
    assert core.is_numeric_module("spgemm_tpu_torch/ops/delta.py")
    findings = lint_file(os.path.join(FIXTURES, "ops", "delta.py"))
    assert [f.rule for f in findings] == ["FLD"]
    assert "torch.sum" in findings[0].message
    live = lint_file(os.path.join(REPO, "spgemm_tpu_torch", "ops", "delta.py"))
    assert live == [], "\n".join(
        f"{f.file}:{f.line}: [{f.rule}] {f.message}" for f in live)


def test_fld_estimator_module_in_numeric_scope():
    """ops/estimate.py (the sampled planner estimator) is in the
    numeric-lint scope: a torch.sum smuggled into an estimator helper is a
    finding -- and the LIVE module self-lints clean (its sizing sums carry
    reasoned fld-proof escapes)."""
    assert core.is_numeric_module("spgemm_tpu_torch/ops/estimate.py")
    findings = lint_file(os.path.join(FIXTURES, "ops", "estimate.py"))
    assert [f.rule for f in findings] == ["FLD"]
    assert "torch.sum" in findings[0].message
    live = lint_file(os.path.join(REPO, "spgemm_tpu_torch", "ops", "estimate.py"))
    assert live == [], "\n".join(
        f"{f.file}:{f.line}: [{f.rule}] {f.message}" for f in live)


def test_fld_kernel_wrappers_in_numeric_scope():
    """ops/cuda_*.py (the kernel wrappers, each holding its kernel's plain
    version) are in the numeric-lint scope in place of the JAX package's
    ops/pallas_*.py: an index_add_ fold there is a finding -- and every
    LIVE wrapper self-lints clean."""
    assert core.is_numeric_module("spgemm_tpu_torch/ops/cuda_spgemm.py")
    assert not core.is_numeric_module("spgemm_tpu_torch/ops/pallas_x.py")
    findings = lint_file(os.path.join(FIXTURES, "ops", "cuda_fold.py"))
    assert [f.rule for f in findings] == ["FLD"]
    assert "index_add_" in findings[0].message
    ops_dir = os.path.join(REPO, "spgemm_tpu_torch", "ops")
    wrappers = sorted(n for n in os.listdir(ops_dir)
                      if n.startswith("cuda_") and n.endswith(".py"))
    assert len(wrappers) >= 7
    for name in wrappers:
        live = lint_file(os.path.join(ops_dir, name))
        assert live == [], "\n".join(
            f"{f.file}:{f.line}: [{f.rule}] {f.message}" for f in live)


@pytest.mark.parametrize("call", [
    "dist.all_reduce(t)", "dist.reduce_scatter(t, ts)",
    "dist.reduce_scatter_tensor(t, u)", "t.index_add(0, i, v)",
    "t.index_add_(0, i, v)", "t.scatter_add(0, i, v)",
    "t.scatter_add_(0, i, v)", "t.scatter_reduce(0, i, v, 'sum')",
    "t.scatter_reduce_(0, i, v, 'sum')",
    "torch.segment_reduce(v, 'sum', lengths=i)"])
def test_fld_torch_terminals(tmp_path, call):
    """Each of torch's unordered accumulations that replace the JAX
    package's psum / psum_scatter / segment_sum / tree_reduce is an FLD
    finding on the numeric path."""
    p = tmp_path / "ops" / "spgemm.py"
    p.parent.mkdir()
    p.write_text("import torch\n"
                 "import torch.distributed as dist\n"
                 "def f(t, ts, u, i, v):\n"
                 f"    return {call}\n")
    findings = lint_file(str(p))
    assert [(f.rule, f.line) for f in findings] == [("FLD", 4)]


# ------------------------------------------------------------- KNB rule --
def test_knb_fixture_each_violation_caught():
    """Every READ spelling is a finding (the three classic ones plus the
    seeded planner-, serve-, and estimator-knob reads); the write/del in
    the same fixture (how harnesses and tests drive knob values) must NOT
    be."""
    findings = lint_file(os.path.join(JAX_FIXTURES, "badknob.py"))
    assert [f.rule for f in findings] == ["KNB"] * 25
    msgs = " ".join(f.message for f in findings)
    for seeded in ("SPGEMM_TPU_SEEDED_A", "SPGEMM_TPU_SEEDED_B",
                   "SPGEMM_TPU_SEEDED_C", "SPGEMM_TPU_PLAN_AHEAD",
                   "SPGEMM_TPU_PLAN_CACHE_CAP", "SPGEMM_TPU_SERVE_SOCKET",
                   "SPGEMM_TPU_SERVE_QUEUE_CAP",
                   "SPGEMM_TPU_SERVE_JOB_TIMEOUT",
                   "SPGEMM_TPU_SERVE_WEDGE_GRACE_S",
                   "SPGEMM_TPU_PLAN_ESTIMATE",
                   "SPGEMM_TPU_EST_SAMPLE_ROWS",
                   "SPGEMM_TPU_EST_CONFIDENCE",
                   "SPGEMM_TPU_DELTA", "SPGEMM_TPU_DELTA_RETAIN",
                   "SPGEMM_TPU_OBS_EVENTS",
                   "SPGEMM_TPU_OBS_EVENTS_MAX_KB",
                   "SPGEMM_TPU_WARM", "SPGEMM_TPU_WARM_DIR",
                   "SPGEMM_TPU_WARM_MAX_MB",
                   "SPGEMM_TPU_SERVE_BATCH_K",
                   "SPGEMM_TPU_SERVE_BATCH_WINDOW_S",
                   "SPGEMM_TPU_ACCUM_ROUTE",
                   "SPGEMM_TPU_SERVE_ADDR",
                   "SPGEMM_TPU_ROUTER_BACKENDS",
                   "SPGEMM_TPU_ROUTER_POLL_S"):
        assert seeded in msgs  # the finding names the offending knob


def test_knb_registry_module_is_exempt():
    """knobs.py itself reads the environment -- the one blessed reader."""
    findings = lint_file(os.path.join(REPO, "spgemm_tpu_torch", "utils",
                                      "knobs.py"))
    assert [f for f in findings if f.rule == "KNB"] == []


# ------------------------------------------------------------- BKD rule --
def test_bkd_fixture_each_violation_caught():
    findings = lint_file(os.path.join(FIXTURES, "badbackend.py"))
    # torch.cuda.device_count() at module scope, a .cuda() copy at module
    # scope, torch.cuda.current_stream() in a default-argument expression,
    # and dist.init_process_group() in a class body (all run at import)
    assert [f.rule for f in findings] == ["BKD"] * 4
    flagged = [f.line for f in findings]
    assert flagged == _fixture_lines("badbackend.py", "seeded BKD")
    msgs = " ".join(f.message for f in findings)
    for name in ("torch.cuda.device_count", "<expr>.cuda",
                 "torch.cuda.current_stream", "dist.init_process_group"):
        assert name in msgs
    assert "forked children" in msgs
    for needle in ("inside a function body: legal", "script driver",
                   "attribute access, no call: legal",
                   "a host tensor makes no context: legal"):
        assert _fixture_lines("badbackend.py", needle)[0] not in flagged


def test_bkd_probe_module_is_exempt():
    findings = lint_file(os.path.join(REPO, "spgemm_tpu_torch", "utils",
                                      "backend_probe.py"))
    assert [f for f in findings if f.rule == "BKD"] == []


def test_bkd_host_only_body_is_scanned():
    """@host_only (utils/backend_probe) marks planner/worker-thread code:
    its WHOLE body is in BKD scope -- a card touch there serialises the
    planner behind the main thread -- while unmarked function bodies keep
    the import-time-only rule."""
    findings = lint_file(os.path.join(FIXTURES, "badplanner.py"))
    assert [f.rule for f in findings] == ["BKD"] * 2
    msgs = " ".join(f.message for f in findings)
    assert "host_only" in msgs and "torch.cuda.synchronize" in msgs
    assert "<expr>.cuda" in msgs
    flagged = [f.line for f in findings]
    assert flagged == _fixture_lines("badplanner.py", "seeded BKD")
    legal = _fixture_lines("badplanner.py", "legal lazy touch")[0]
    assert legal not in flagged  # unmarked lazy touch stays legal


def test_bkd_host_only_dotted_decorator(tmp_path):
    """The dotted spelling `@backend_probe.host_only` is recognized too,
    and a passing helper (pure numpy) yields no finding."""
    p = tmp_path / "planhelp.py"
    p.write_text("from spgemm_tpu_torch.utils import backend_probe\n"
                 "import numpy as np\n"
                 "import torch\n"
                 "@backend_probe.host_only\n"
                 "def bad(x):\n"
                 "    return x.cuda()\n"
                 "@backend_probe.host_only\n"
                 "def good(x):\n"
                 "    return np.asarray(x).sum()\n")
    findings = lint_file(str(p))
    assert [f.rule for f in findings] == ["BKD"]
    assert "x.cuda" in findings[0].message


def test_host_only_marker_on_planner_entrypoints():
    """The engine's planner bodies really carry the marker the rule keys
    on (the runtime attribute host_only sets): the plan-ahead worker's
    body and the host planner it reaches through chain._make_planner and
    ops/spgemm.plan."""
    from spgemm_tpu_torch.chain import _PlanAheadWorker
    from spgemm_tpu_torch.ops.spgemm import _new_plan

    assert getattr(_new_plan, "__spgemm_host_only__", False)
    assert getattr(_PlanAheadWorker._work, "__spgemm_host_only__", False)


def test_bkd_live_planner_bodies_are_scanned(tmp_path):
    """The marker binds on the live modules: a CUDA call added to a copy
    of the plan-ahead worker's body turns BKD red."""
    src = open(os.path.join(REPO, "spgemm_tpu_torch", "chain.py")).read()
    anchor = "            with ENGINE.attributed(self._attr):\n"
    assert anchor in src, "anchor drifted in chain.py"
    p = tmp_path / "chain.py"
    p.write_text(src)
    assert [f for f in lint_file(str(p)) if f.rule == "BKD"] == []
    p.write_text(src.replace(anchor, "            torch.cuda.synchronize()\n"
                             + anchor, 1))
    bkd = [f for f in lint_file(str(p)) if f.rule == "BKD"]
    assert len(bkd) == 1 and "_work" in bkd[0].message


# ------------------------------------------------------------- MET rule --
def test_met_fixture_each_violation_caught():
    """Undeclared phase/counter names and computed names are findings;
    declared names and ad-hoc PhaseTimers instances stay legal."""
    findings = lint_file(os.path.join(FIXTURES, "badmetric.py"))
    met = [f for f in findings if f.rule == "MET"]
    assert len(met) == 10 and findings == met
    flagged = [f.line for f in met]
    for needle in ("MET: undeclared phase name",
                   "MET: undeclared counter name",
                   "MET: computed metric name",
                   "MET: undeclared launch counter",
                   "MET: undeclared JAX-only counter",
                   "MET: undeclared warm counter",
                   "MET: undeclared warm phase",
                   "MET: undeclared dcn phase",
                   "MET: undeclared dcn counter"):
        assert _fixture_lines("badmetric.py", needle)[0] in flagged
    # the conditional between two declared launch counters is computed
    (cond,) = [ln for ln in _fixture_lines("badmetric.py", "timers.incr(")
               if ln - 1 in _fixture_lines("badmetric.py", "declared "
                                           "counters, but")]
    assert cond in flagged
    assert sum(1 for f in met if "string literal" in f.message) == 2
    msgs = " ".join(f.message for f in met)
    assert "made_up_phase" in msgs and "made_up_counter" in msgs
    # the port counts launches per kernel: the JAX package's dispatch
    # counter and a singular near-miss are not its names
    assert "dispatches" in msgs and "launch_numeric_round" in msgs
    assert "warm_hit" in msgs and "warm_loading" in msgs
    assert "dcn_chains" in msgs and "dcn_chunk" in msgs
    assert "ENGINE_PHASES" in msgs and "ENGINE_COUNTERS" in msgs
    for needle in ("legal: declared phase", "legal: declared counter",
                   "legal: not the ENGINE registry",
                   "legal: declared launch counter",
                   "legal: declared warm phase",
                   "legal: declared warm counter",
                   "legal: declared dcn phase",
                   "legal: declared dcn counter"):
        for line in _fixture_lines("badmetric.py", needle):
            assert line not in flagged


def test_met_alias_spellings_resolve(tmp_path):
    """Both repo spellings -- `from ...timers import ENGINE` and the
    `import ... as t` + `t.ENGINE` form -- resolve to the registry, and
    the keyword spelling `name=` is in scope too (both mint the
    series)."""
    p = tmp_path / "h.py"
    p.write_text("from spgemm_tpu_torch.utils.timers import ENGINE\n"
                 "import spgemm_tpu_torch.utils.timers as t\n"
                 "from spgemm_tpu_torch.utils import timers\n"
                 "def f(i):\n"
                 "    ENGINE.incr('nope_a')\n"
                 "    t.ENGINE.incr('nope_b')\n"
                 "    timers.ENGINE.incr('nope_c')\n"
                 "    ENGINE.incr(name='nope_kw')\n"
                 "    ENGINE.incr(name=f'dyn_{i}')\n"
                 "    ENGINE.incr('plan_cache_hits')\n"
                 "    ENGINE.incr(name='plan_cache_hits')\n")
    findings = lint_file(str(p))
    assert [f.rule for f in findings] == ["MET"] * 5
    assert [f.line for f in findings] == [5, 6, 7, 8, 9]


def test_met_registry_covers_live_call_sites():
    """Every ENGINE phase/counter name the port actually uses is declared
    (the self-lint enforces this; spot-check the registry side so a
    deleted declaration cannot slip through unnoticed), the launch
    counters of every kernel wrapper included."""
    from spgemm_tpu_torch.obs.metrics import ENGINE_COUNTERS, ENGINE_PHASES

    for name in ("plan", "plan_wait", "numeric_dispatch", "assembly",
                 "ring_fold", "dcn_exchange", "serve_execute",
                 "serve_queue_wait", "join_fallback", "delta_diff",
                 "delta_splice", "warm_load", "warm_flush", "dcn_chain",
                 "serve_load"):
        assert name in ENGINE_PHASES
    for name in ("plan_cache_hits", "plan_cache_misses",
                 "plan_cache_evictions", "ring_steps", "serve_reaps",
                 "serve_degrades", "est_hits", "est_fallbacks",
                 "delta_rows_recomputed", "delta_rows_total",
                 "delta_full_fallbacks", "compiles", "warm_hits",
                 "warm_misses", "warm_corrupt", "launches_numeric_round",
                 "launches_numeric_round_no_mod", "launches_bsmm",
                 "launches_bsmm_resident", "launches_field_fold"):
        assert name in ENGINE_COUNTERS


# ------------------------------------------------------------- FPT rule --
def test_fpt_fixture_each_violation_caught():
    """Undeclared failpoint names (module and bare-import spellings) and
    a computed name are findings; declared names stay legal."""
    findings = lint_file(os.path.join(FIXTURES, "badfailpoint.py"))
    fpt = [f for f in findings if f.rule == "FPT"]
    assert len(fpt) == 3 and findings == fpt
    flagged = [f.line for f in fpt]
    for needle in ("FPT: undeclared failpoint name",
                   "FPT: computed failpoint name",
                   "FPT: undeclared via the bare import"):
        assert _fixture_lines("badfailpoint.py", needle)[0] in flagged
    msgs = " ".join(f.message for f in fpt)
    assert "made.up.point" in msgs and "also.made.up" in msgs
    assert "utils/failpoints.py" in msgs
    for needle in ("legal: declared (corrupt kind)",
                   "legal: declared via the bare import"):
        assert _fixture_lines("badfailpoint.py", needle)[0] not in flagged


def test_fpt_stale_registry_entry_is_a_finding(tmp_path):
    """The reverse direction: a registry entry no check() site names is
    flagged AT THE REGISTRY -- and only when the registry module itself
    is in the linted unit set (fixture runs over partial trees must not
    call every entry stale)."""
    import shutil

    from spgemm_tpu_torch.analysis.core import lint_report
    from spgemm_tpu_torch.utils.failpoints import REGISTRY

    # a partial tree WITHOUT the registry module: quiet
    site = tmp_path / "site.py"
    site.write_text("from spgemm_tpu_torch.utils import failpoints\n"
                    "def f():\n"
                    "    failpoints.check('warm.load')\n")
    findings, _ = lint_report([str(site)], doc=False)
    assert [f for f in findings if f.rule == "FPT"] == []

    # the registry module + one site: every OTHER entry is stale
    pkg = tmp_path / "utils"
    pkg.mkdir()
    shutil.copy(os.path.join(REPO, "spgemm_tpu_torch", "utils",
                             "failpoints.py"),
                str(pkg / "failpoints.py"))
    findings, _ = lint_report([str(site), str(pkg)], doc=False)
    stale = [f for f in findings if f.rule == "FPT"
             and "stale failpoint registry entry" in f.message]
    assert len(stale) == len(REGISTRY) - 1  # all but the checked one
    assert all(f.file.endswith("failpoints.py") for f in stale)
    assert not any("'warm.load'" in f.message for f in stale)


def test_fpt_registry_covers_live_call_sites():
    """Every failpoint the chaos harness documents is declared (the repo
    self-lint enforces site coverage; spot-check the registry side)."""
    from spgemm_tpu_torch.utils.failpoints import REGISTRY

    for name in ("plan.build", "plan.ensure_exact", "kernel.dispatch",
                 "delta.diff", "delta.splice", "warm.load", "warm.flush",
                 "serve.journal", "serve.accept", "serve.readline",
                 "serve.executor", "serve.heartbeat", "tune.trial"):
        assert name in REGISTRY
    assert all(fp.kind in ("raise", "hang", "corrupt", "delay")
               for fp in REGISTRY.values())


# ------------------------------------------------------------- PRO rule --
def test_pro_fixture_each_violation_caught():
    """Undeclared request/response fields (with and without op context),
    an unknown op, a hardcoded version stamp, undeclared error codes at
    raise and compare sites, and an undeclared E_* constant are
    findings; declared fields/codes and unconventional receiver names
    stay legal."""
    findings = lint_file(os.path.join(FIXTURES, "badproto.py"))
    pro = [f for f in findings if f.rule == "PRO"]
    assert len(pro) == 9 and findings == pro
    flagged = [f.line for f in pro]
    for needle in ("PRO: undeclared request field for status",
                   "PRO: undeclared request field `priority`",
                   "PRO: undeclared error code at a raise site",
                   "PRO: undeclared response field",
                   "PRO: undeclared error code on a code-flavored",
                   "PRO: undeclared error-code constant"):
        # seed comments sit on the finding's line or the line above
        # (dict-literal findings anchor on the literal's first line)
        line = _fixture_lines("badproto.py", needle)[0]
        assert line in flagged or line + 1 in flagged, needle
    # the worse-dict line carries BOTH the unknown-op and the
    # hardcoded-version findings
    (worse_line,) = _fixture_lines("badproto.py", '{"op": "frobnicate"')
    assert flagged.count(worse_line) == 2
    msgs = " ".join(f.message for f in pro)
    assert "flavor" in msgs and "verbose" in msgs and "priority" in msgs
    assert "frobnicate" in msgs and "version_for" in msgs
    assert "went-sideways" in msgs and "transient-blip" in msgs
    assert "E_NOPE" in msgs and "REQUEST_FIELDS" in msgs
    for needle in ("legal: declared status request field",
                   "legal: declared submit fields + envelope",
                   "legal: envelope field",
                   "legal: declared response field"):
        assert _fixture_lines("badproto.py", needle)[0] not in flagged
    out_of_scope = _fixture_lines("badproto.py", "return record.get")[0]
    assert out_of_scope not in flagged
    # the port's own stats fields (`device`, `serve`) are declared
    stats = _fixture_lines("badproto.py", "device={")[0]
    assert stats not in flagged and stats - 1 not in flagged


def test_pro_registry_coherence_audit(tmp_path):
    """The package-level PRO direction audits the LIVE registry
    (request/response op symmetry, min versions in range, one version
    per field name, post-v1 fields in FIELD_MIN_VERSION, E_* constants
    matching ERROR_CODES both ways), anchored at the registry module's
    declaration lines -- and gates on protocol.py itself being in the
    unit set, so partial trees stay quiet."""
    from spgemm_tpu_torch.analysis.core import lint_report

    src = open(os.path.join(REPO, "spgemm_tpu_torch", "serve",
                            "protocol.py")).read()
    # the real registry at the real suffix: coherent, zero PRO findings
    pkg = tmp_path / "serve"
    pkg.mkdir()
    (pkg / "protocol.py").write_text(src)
    findings, _ = lint_report([str(pkg)], doc=False)
    assert [f for f in findings if f.rule == "PRO"] == []
    # a wrong-suffix copy never gates the audit on
    (tmp_path / "notprotocol.py").write_text(src)
    findings, _ = lint_report([str(tmp_path / "notprotocol.py")],
                              doc=False)
    assert [f for f in findings if f.rule == "PRO"] == []


def test_pro_registry_audit_catches_incoherence(tmp_path, monkeypatch):
    """Seed the live tables with every incoherence class and watch the
    audit flag each: a request-only op, an out-of-range min version, a
    field name carrying two versions across ops, and a post-v1 field
    missing from FIELD_MIN_VERSION (the rolling-upgrade hazard)."""
    from spgemm_tpu_torch.analysis.core import lint_report
    from spgemm_tpu_torch.serve import protocol

    bad_requests = dict(protocol.REQUEST_FIELDS)
    bad_requests["phantom"] = {"thing": 9}       # no response half; v9
    bad_requests["status"] = {"id": 2}           # 'id' is 1 elsewhere
    bad_requests["wait"] = {"id": 1, "timeout": 1, "rush": 3}  # no FMV
    monkeypatch.setattr(protocol, "REQUEST_FIELDS", bad_requests)
    pkg = tmp_path / "serve"
    pkg.mkdir()
    (pkg / "protocol.py").write_text(open(os.path.join(
        REPO, "spgemm_tpu", "serve", "protocol.py")).read())
    findings, _ = lint_report([str(pkg)], doc=False)
    msgs = " ".join(f.message for f in findings if f.rule == "PRO")
    assert "'phantom'" in msgs and "only one of" in msgs
    assert "outside 1..PROTOCOL_VERSION" in msgs
    assert "two min versions" in msgs
    assert "rolling-upgrade hazard" in msgs and "'rush'" in msgs


def test_pro_guard_deletion_on_daemon_copy(tmp_path):
    """Guard-deletion spot-check: the pristine daemon lints PRO-clean,
    and a typo'd response kwarg on a copy goes red -- deleting or
    misspelling a wire field cannot land silently."""
    src = open(os.path.join(REPO, "spgemm_tpu_torch", "serve",
                            "daemon.py")).read()
    p = tmp_path / "daemon.py"
    p.write_text(src)
    clean = [f for f in lint_file(str(p)) if f.rule in ("PRO", "EVT")]
    assert clean == []
    needle = "state=job.state, queued="
    assert needle in src  # the _op_submit protocol.ok kwargs
    p.write_text(src.replace(needle, "state=job.state, qeued=", 1))
    broken = [f for f in lint_file(str(p)) if f.rule == "PRO"]
    assert broken and "qeued" in broken[0].message


# ------------------------------------------------------------- EVT rule --
def test_evt_fixture_each_violation_caught():
    """Undeclared kinds through the module alias and the LOG singleton,
    and a computed kind through the bare import, are findings; declared
    kinds and local emit helpers stay legal."""
    findings = lint_file(os.path.join(FIXTURES, "badevent.py"))
    evt = [f for f in findings if f.rule == "EVT"]
    assert len(evt) == 3 and findings == evt
    flagged = [f.line for f in evt]
    for needle in ("EVT: undeclared kind via the module alias",
                   "EVT: undeclared kind via the LOG singleton",
                   "EVT: computed kind via the bare import"):
        line = _fixture_lines("badevent.py", needle)[0]
        assert line in flagged or line + 1 in flagged, needle
    msgs = " ".join(f.message for f in evt)
    assert "job_vanished" in msgs and "daemon_hiccup" in msgs
    assert "EVENT_KINDS" in msgs
    for needle in ("legal: declared kind",
                   "legal: not the obs/events log"):
        for line in _fixture_lines("badevent.py", needle):
            assert line not in flagged


def test_evt_guard_deletion_on_daemon_copy(tmp_path):
    """Guard-deletion spot-check, event side: renaming an emitted kind
    on a daemon copy goes red against EVENT_KINDS."""
    src = open(os.path.join(REPO, "spgemm_tpu_torch", "serve",
                            "daemon.py")).read()
    assert '"job_submit"' in src
    p = tmp_path / "daemon.py"
    p.write_text(src.replace('"job_submit"', '"job_submitted"', 1))
    broken = [f for f in lint_file(str(p)) if f.rule == "EVT"]
    assert broken and "job_submitted" in broken[0].message


def test_evt_registry_covers_live_kinds():
    """Every lifecycle kind the daemon and engine actually emit is
    declared (the repo self-lint enforces the site direction;
    spot-check the registry side)."""
    from spgemm_tpu_torch.obs.events import EVENT_KINDS

    for kind in ("daemon_start", "job_submit", "job_done", "job_failed",
                 "watchdog_reap", "watchdog_wedge", "est_fallback",
                 "delta_fallback", "warm_load", "compile", "slo_burn",
                 "slo_burn_clear", "failpoint_trigger", "router_failover",
                 "tune_apply"):
        assert kind in EVENT_KINDS
        assert EVENT_KINDS[kind]  # every kind carries its doc


# ------------------------------------------------------------- DRF rule --
def test_drf_quiet_without_registry_modules():
    """The drift audit self-gates on each registry module being in the
    linted unit set: the fixture site alone yields nothing."""
    findings = lint_file(os.path.join(FIXTURES, "staledrift.py"))
    assert findings == []
    from spgemm_tpu_torch.analysis.core import lint_report

    findings, _ = lint_report(
        [os.path.join(FIXTURES, "staledrift.py")], doc=False)
    assert findings == []


def test_drf_stale_registry_entries_flagged_at_declarations(tmp_path):
    """Copies of the port's registries at the real suffixes + the
    one-reference fixture site: every UNreferenced knob and event kind is
    a DRF finding at its declaration line; the referenced ones are not;
    a drf-ok escape placed on one knob's declaration suppresses it
    (inventoried, not stale)."""
    from spgemm_tpu_torch.analysis.core import lint_run

    for sub, name in (("utils", "knobs.py"), ("obs", "events.py")):
        d = tmp_path / sub
        d.mkdir(exist_ok=True)
        shutil.copy(os.path.join(REPO, "spgemm_tpu_torch", sub, name),
                    str(d / name))
    # the escape: a reasoned drf-ok above the WARM_MAX_MB declaration
    knobs_copy = tmp_path / "utils" / "knobs.py"
    decl = '    Knob("SPGEMM_TPU_WARM_MAX_MB",'
    text = knobs_copy.read_text()
    assert text.count(decl) == 1, "declaration anchor drifted in knobs.py"
    knobs_copy.write_text(text.replace(
        decl, "    # spgemm-lint: drf-ok(seeded: read by an operator "
              "script outside Python)\n" + decl))
    site = tmp_path / "site.py"
    site.write_text(
        open(os.path.join(FIXTURES, "staledrift.py")).read())
    report = lint_run([str(tmp_path)], doc=False)
    drf = [f for f in report.findings if f.rule == "DRF"]
    assert drf, "expected drift findings against the registry copies"
    assert all(f.file.endswith(("knobs.py", "events.py")) for f in drf)
    msgs = " ".join(f.message for f in drf)
    # unreferenced entries flagged...
    assert "SPGEMM_TPU_PLAN_AHEAD" in msgs
    assert "job_done" in msgs
    # ...referenced ones not, and the escaped knob rides the suppression
    # inventory instead of the findings
    assert "SPGEMM_TPU_PLAN_CACHE " not in msgs
    assert "'job_start'" not in msgs
    assert "SPGEMM_TPU_WARM_MAX_MB" not in msgs
    esc = [s for s in report.suppressions if s.rule == "DRF"]
    assert len(esc) == 1 and not esc[0].stale
    # findings anchor at the declaration lines (the quoted name)
    knobs_src = knobs_copy.read_text().splitlines()
    for f in drf:
        if f.file.endswith("knobs.py"):
            assert '"SPGEMM_TPU_' in knobs_src[f.line - 1]


def test_drf_signature_covers_new_registries(tmp_path):
    """Editing serve/protocol.py or obs/events.py changes the analysis
    signature, so every cached per-file PRO/EVT result is invalidated
    on the next run (the same contract MET/FPT already have).  Probed on
    a copy of the package tree, so the repo's files stay untouched."""
    pkg = tmp_path / "spgemm_tpu_torch"
    shutil.copytree(os.path.join(REPO, "spgemm_tpu_torch", "analysis"),
                    str(pkg / "analysis"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in core._SIGNATURE_EXTRAS:
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(REPO, "spgemm_tpu_torch", rel),
                    str(pkg / rel))
    signature = types.FunctionType(
        core._analysis_signature.__code__,
        {**vars(core), "__file__": str(pkg / "analysis" / "core.py")})
    assert signature() == core._analysis_signature()
    for rel in ("serve/protocol.py", "obs/events.py"):
        before = signature()
        with open(pkg / rel, "ab") as f:
            f.write(b"\n# signature-probe\n")
        assert signature() != before


# ------------------------------------------------------------- DOC rule --
def test_doc_fixture_drift_caught():
    findings = check_claude_md(FIXTURE_DOC)
    assert [f.rule for f in findings] == ["DOC"]
    assert "drifted" in findings[0].message


def test_doc_current_table_passes_and_tamper_fails(tmp_path):
    good = tmp_path / "ARCHITECTURE.md"
    good.write_text("# doc\n\n" + docrules.render_knob_block() + "\n")
    assert check_claude_md(str(good)) == []
    tampered = good.read_text().replace("SPGEMM_TPU_PLAN_AHEAD",
                                        "SPGEMM_TPU_GONE")
    good.write_text(tampered)
    assert [f.rule for f in check_claude_md(str(good))] == ["DOC"]
    good.write_text("# no markers at all\n")
    findings = check_claude_md(str(good))
    assert [f.rule for f in findings] == ["DOC"]
    assert "markers missing" in findings[0].message


def test_doc_cli_help_covers_every_knob(monkeypatch):
    """The port CLI's --help carries the registry-generated epilog, and
    so names every knob; dropping the epilog turns DOC red."""
    assert docrules.check_cli_help() == []
    from spgemm_tpu_torch import cli

    real = cli.build_parser

    def no_epilog():
        p = real()
        p.epilog = None
        return p

    monkeypatch.setattr(cli, "build_parser", no_epilog)
    missing = docrules.check_cli_help()
    assert missing and all(f.rule == "DOC" for f in missing)


def test_doc_default_target_is_the_ports_architecture_md():
    """The port has no CLAUDE.md of its own and may not edit the JAX
    package's: every generated table lives in
    spgemm_tpu_torch/ARCHITECTURE.md, which --claude-md and
    --architecture-md both default to."""
    from spgemm_tpu_torch.analysis.__main__ import build_parser

    doc = os.path.join(REPO, "spgemm_tpu_torch", "ARCHITECTURE.md")
    assert core.default_doc() == doc and os.path.exists(doc)
    text = open(doc).read()
    for begin, end in ((docrules.KNOB_TABLE_BEGIN, docrules.KNOB_TABLE_END),
                       (docrules.METRICS_TABLE_BEGIN,
                        docrules.METRICS_TABLE_END),
                       (docrules.PROTOCOL_TABLE_BEGIN,
                        docrules.PROTOCOL_TABLE_END),
                       (docrules.EVENT_TABLE_BEGIN, docrules.EVENT_TABLE_END),
                       (docrules.THREAD_TABLE_BEGIN,
                        docrules.THREAD_TABLE_END)):
        assert text.count(begin) == 1 and text.count(end) == 1
    args = build_parser().parse_args([])
    assert args.claude_md is None and args.architecture_md is None


def test_doc_metrics_table_current_and_tamper_fails(tmp_path):
    """The ARCHITECTURE.md metrics table is held to the obs/metrics.py
    registry exactly like the knob table is to knobs.py."""
    good = tmp_path / "ARCHITECTURE.md"
    good.write_text("# arch\n\n" + docrules.render_metrics_block() + "\n")
    assert docrules.check_architecture_md(str(good)) == []
    tampered = good.read_text().replace("spgemm_phase_seconds_total",
                                        "spgemm_gone_total")
    good.write_text(tampered)
    findings = docrules.check_architecture_md(str(good))
    assert [f.rule for f in findings] == ["DOC"]
    assert "drifted" in findings[0].message
    good.write_text("# no markers at all\n")
    findings = docrules.check_architecture_md(str(good))
    assert [f.rule for f in findings] == ["DOC"]
    assert "markers missing" in findings[0].message


def test_write_metrics_table_regenerates(tmp_path):
    """`--write-metrics-table` rewrites the marked block in place, after
    which the DOC check passes."""
    arch = tmp_path / "ARCHITECTURE.md"
    arch.write_text("# doc\n" + docrules.METRICS_TABLE_BEGIN + "\nstale\n"
                    + docrules.METRICS_TABLE_END + "\ntail\n")
    rc = _run(["-m", "spgemm_tpu_torch.analysis", "--write-metrics-table",
               "--architecture-md", str(arch)])
    assert rc.returncode == 0, rc.stderr[-2000:]
    assert docrules.check_architecture_md(str(arch)) == []
    assert arch.read_text().startswith("# doc\n")
    assert arch.read_text().endswith("\ntail\n")


def test_doc_thread_inventory_current_and_tamper_fails(tmp_path):
    """The generated ARCHITECTURE.md thread-inventory table is held to
    the concurrency pass's output exactly like the knob and metrics
    tables are to their registries."""
    good = tmp_path / "ARCHITECTURE.md"
    good.write_text("# arch\n\n" + docrules.render_thread_block() + "\n")
    assert docrules.check_thread_inventory(str(good)) == []
    tampered = good.read_text().replace("Daemon._watchdog_loop",
                                        "Daemon._gone_loop")
    assert tampered != good.read_text()
    good.write_text(tampered)
    findings = docrules.check_thread_inventory(str(good))
    assert [f.rule for f in findings] == ["DOC"]
    assert "drifted" in findings[0].message
    good.write_text("# no markers at all\n")
    findings = docrules.check_thread_inventory(str(good))
    assert [f.rule for f in findings] == ["DOC"]
    assert "markers missing" in findings[0].message


def test_write_thread_inventory_regenerates(tmp_path):
    """`--write-thread-inventory` rewrites the marked block in place,
    after which the DOC check passes."""
    arch = tmp_path / "ARCHITECTURE.md"
    arch.write_text("# doc\n" + docrules.THREAD_TABLE_BEGIN + "\nstale\n"
                    + docrules.THREAD_TABLE_END + "\ntail\n")
    rc = _run(["-m", "spgemm_tpu_torch.analysis", "--write-thread-inventory",
               "--architecture-md", str(arch)])
    assert rc.returncode == 0, rc.stderr[-2000:]
    assert docrules.check_thread_inventory(str(arch)) == []
    assert arch.read_text().startswith("# doc\n")
    assert arch.read_text().endswith("\ntail\n")


def test_thread_inventory_covers_live_daemon_roots():
    """Spot-check the generated rows: the port's daemon, router and
    engine threads resolve as roots -- executors, watchdog, accept loop,
    connection handler, recovery probe, the event-log writer, the
    plan-ahead worker, the fleet router's loops, the --distributed
    heartbeat -- so the table the docs commit actually inventories the
    threads the concurrency pass reasons about."""
    md = docrules.thread_inventory_md()
    for root in ("serve.daemon.Daemon._executor_loop",
                 "serve.daemon.Daemon._watchdog_loop",
                 "serve.daemon.Daemon._accept_loop",
                 "serve.daemon.Daemon._handle_conn",
                 "serve.daemon.Daemon._recover_probe",
                 "obs.events.EventLog._writer_loop",
                 "chain._PlanAheadWorker._work",
                 "fleet.router.Router._accept_loop",
                 "fleet.router.Router._handle_conn",
                 "fleet.router.Router._poll_loop",
                 "parallel.multihost._beat_loop"):
        assert f"`{root}`" in md
    # the executor root's row names the locks it may transitively hold
    executor_row = next(ln for ln in md.splitlines()
                        if "Daemon._executor_loop" in ln)
    assert "serve.daemon.Daemon._lock" in executor_row
    assert "ops.warmstore._LOCK" in executor_row


# ----------------------------------------------------------- PARSE rule --
def test_syntax_error_gets_its_own_rule_id(tmp_path):
    """A broken file means NO rule ran on it: its finding must not be
    attributed to a rule family in the JSON counts."""
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    findings = lint_file(str(p))
    assert [f.rule for f in findings] == ["PARSE"]
    assert "does not parse" in findings[0].message


# ------------------------------------------------------------- THR rule --
def test_thr_fixture_each_violation_caught():
    """Unguarded accesses of guarded-by-annotated state: a module-global
    write, an instance read, and a nested-def access (callbacks run later,
    usually on another thread -- the enclosing `with` does not protect
    them)."""
    findings = lint_file(os.path.join(JAX_FIXTURES, "badthread.py"))
    thr = [f for f in findings if f.rule == "THR"]
    assert len(thr) == 3 and findings == thr
    flagged = [f.line for f in thr]
    for needle in ("module-global write without the lock", "THR: no lock",
                   "return list(self._jobs)"):
        assert _fixture_lines("badthread.py", needle)[0] in flagged
    # the legal shapes stay clean: lock held, Condition alias, __init__,
    # *_locked convention, reasoned thr-ok escape
    for needle in ("legal: lock held", "legal: Condition aliases",
                   "legal: __init__", "caller holds the lock",
                   "escaped with a reason"):
        assert _fixture_lines("badthread.py", needle)[0] not in flagged


def test_thr_finding_names_attribute_and_lock():
    findings = lint_file(os.path.join(JAX_FIXTURES, "badthread.py"))
    msgs = " ".join(f.message for f in findings)
    assert "guarded-by(_lock)" in msgs and "guarded-by(_GLOCK)" in msgs
    assert "self._jobs" in msgs and "_G" in msgs


def test_thr_guard_deletion_turns_lint_red(tmp_path):
    """The acceptance spot-check, on FIXTURE COPIES of the live serving
    modules: deleting any one `with` lock guard in serve/queue.py or
    serve/daemon.py must produce a THR finding (the annotations actually
    bind)."""
    cases = [
        ("serve/queue.py",
         "        with self._lock:\n            return {",
         "        if True:\n            return {"),           # Job.snapshot
        ("serve/daemon.py",
         "        with self._lock:\n            degraded, degrade_reason = "
         "self.degraded, self.degrade_reason",
         "        if True:\n            degraded, degrade_reason = "
         "self.degraded, self.degrade_reason"),  # _op_stats
    ]
    for rel, guarded, unguarded in cases:
        src = open(os.path.join(REPO, "spgemm_tpu_torch", rel)).read()
        assert lint_file(os.path.join(REPO, "spgemm_tpu_torch", rel)) == []
        mutated = src.replace(guarded, unguarded)
        assert mutated != src, f"guard pattern drifted in {rel}"
        p = tmp_path / os.path.basename(rel)
        p.write_text(mutated)
        thr = [f for f in lint_file(str(p)) if f.rule == "THR"]
        assert thr, f"deleting a lock guard in {rel} must turn lint red"


# ------------------------------------------------------------- LCK rule --
def test_lck_fixture_each_violation_caught():
    """The seeded lock-order fixture: the A->B vs B->A inversion is a
    cycle finding carrying BOTH witness chains, and the call-edge
    re-acquisition is the non-reentrant self-deadlock finding; the
    same-order nest stays a legal edge."""
    findings = core.lint_paths([os.path.join(JAX_FIXTURES, "badlockorder.py")],
                               doc=False)
    assert [f.rule for f in findings] == ["LCK", "LCK"]
    by_line = {f.line: f.message for f in findings}
    cycle_line = _fixture_lines("badlockorder.py", "one half of the cycle")[0]
    self_line = _fixture_lines("badlockorder.py", "self-deadlock")[0]
    assert set(by_line) == {cycle_line, self_line}
    legal = _fixture_lines("badlockorder.py", "an edge, not a new cycle")[0]
    assert legal not in by_line
    cycle = by_line[cycle_line]
    assert "lock-order cycle" in cycle
    assert "a_then_b" in cycle and "b_then_a" in cycle  # both witnesses
    assert "._A`" in cycle and "._B`" in cycle
    self_edge = by_line[self_line]
    assert "re-acquired while already held" in self_edge
    assert "reenters -> helper" in self_edge  # the witness chain
    assert "non-reentrant" in self_edge
    # RLock re-entry through a call edge is its documented use-case --
    # never a self-edge finding
    rlock = _fixture_lines("badlockorder.py", "RLock re-entry")[0]
    assert rlock not in by_line


def test_lck_multi_item_with_inversion_caught(tmp_path):
    """Review regression: `with A, B:` acquires left-to-right exactly
    like nested withs -- the single-statement spelling of one half of an
    AB/BA inversion must still close the cycle."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_A = threading.Lock()\n"
        "_B = threading.Lock()\n"
        "def f():\n"
        "    with _A, _B:\n"
        "        pass\n"
        "def g():\n"
        "    with _B:\n"
        "        with _A:\n"
        "            pass\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["LCK"]
    assert "lock-order cycle" in findings[0].message


def test_lck_conditionally_defined_module_lock_registers(tmp_path):
    """Review regression: a lock assigned inside a module-level try/if
    block still executes at module scope -- it must register (hazards
    on it checked), while function-local assignments must not leak into
    the module registry."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "try:\n"
        "    _L = threading.Lock()\n"
        "except ImportError:\n"
        "    _L = None\n"
        "def reenters():\n"
        "    with _L:\n"
        "        helper()\n"
        "def helper():\n"
        "    with _L:\n"
        "        pass\n"
        "def local_only():\n"
        "    _M = threading.Lock()\n"   # a local, not a module lock
        "    with _M:\n"
        "        pass\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["LCK"]
    assert "re-acquired while already held" in findings[0].message


def test_lck_escaped_anchor_does_not_vouch_for_other_sites(tmp_path):
    """Review regression: an lck-ok on one re-acquisition site argues
    THAT site's unreachability only -- the same hazard spelled at
    another site still turns lint red (the live finding moves to the
    first unescaped site; the escape stays used, not stale)."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_L = threading.Lock()\n"
        "def escaped_path():\n"
        "    with _L:\n"
        "        # spgemm-lint: lck-ok(seeded: this branch is gated unreachable)\n"
        "        helper()\n"
        "def other_path():\n"
        "    with _L:\n"
        "        helper()\n"
        "def helper():\n"
        "    with _L:\n"
        "        pass\n")
    findings, suppressions = core.lint_report([str(p)], doc=False)
    lck = [f for f in findings if f.rule == "LCK"]
    assert len(lck) == 1 and lck[0].line == 9  # the unescaped site
    assert findings == lck  # in particular: no stale-escape SUP
    assert len(suppressions) == 1 and not suppressions[0].stale


def test_lck_direct_self_recursion_caught(tmp_path):
    """Review regression: `with self._lock: self.step(...)` recursing
    into ITSELF is the one-edge re-acquisition deadlock -- the self
    call edge must not be dropped."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "    def step(self, n):\n"
        "        with self._lock:\n"
        "            if n:\n"
        "                self.step(n - 1)\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["LCK"]
    assert "re-acquired while already held" in findings[0].message


def test_lck_rlock_still_participates_in_order_cycles(tmp_path):
    """The RLock self-edge exemption must not blind the cycle detector:
    an RLock acquired in opposite orders against a plain Lock deadlocks
    exactly like two Locks -- still a finding."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_L = threading.Lock()\n"
        "_R = threading.RLock()\n"
        "def l_then_r():\n"
        "    with _L:\n"
        "        with _R:\n"
        "            pass\n"
        "def r_then_l():\n"
        "    with _R:\n"
        "        with _L:\n"
        "            pass\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["LCK"]
    assert "lock-order cycle" in findings[0].message


# ------------------------------------------------------------- BLK rule --
def test_blk_fixture_each_violation_caught():
    """The seeded blocking-under-lock fixture: direct sleep, transitive
    subprocess.run through a call edge, and the typed Queue.get are
    findings; no-lock blocking, the condition's own wait, and the
    reasoned blk-ok escape stay legal."""
    findings, suppressions = core.lint_report(
        [os.path.join(JAX_FIXTURES, "badblocking.py")], doc=False)
    assert [f.rule for f in findings] == ["BLK"] * 3
    flagged = [f.line for f in findings]
    for needle in ("BLK: sleeping while holding",
                   "BLK: reaches subprocess.run",
                   "BLK: Queue.get blocks"):
        assert _fixture_lines("badblocking.py", needle)[0] in flagged
    for needle in ("legal: nothing held", "legal: wait releases",
                   "time.sleep(0.0)"):
        assert _fixture_lines("badblocking.py", needle)[0] not in flagged
    by_line = {f.line: f.message for f in findings}
    trans = by_line[_fixture_lines("badblocking.py",
                                   "BLK: reaches subprocess.run")[0]]
    # the witness chain down to the blocking call, with its file:line
    assert "transitive -> helper -> `subprocess.run`" in trans
    assert "badblocking.py:" in trans
    # the escape is inventoried, in use (source escape on the sleep)
    blk = [s for s in suppressions if s.rule == "BLK"]
    assert len(blk) == 1 and not blk[0].stale


def test_blk_torch_blocking_calls_caught():
    """The torch spellings of a blocking call under a registered lock: a
    host sync (`torch.cuda.synchronize`, a stream's `.synchronize()`), a
    collective (`dist.all_gather`, resolved through the import alias) and a
    rendezvous store's `get` -- the port's counterparts of
    `block_until_ready`; nothing held, or a dict's `get`, stays legal."""
    findings = core.lint_paths([os.path.join(FIXTURES, "badsync.py")],
                               doc=False)
    assert [f.rule for f in findings] == ["BLK"] * 4
    assert [f.line for f in findings] == _fixture_lines("badsync.py",
                                                        "# BLK:")
    msgs = " ".join(f.message for f in findings)
    for name in ("`torch.cuda.synchronize`", "`stream.synchronize`",
                 "`dist.all_gather`", "`store.get`"):
        assert name in msgs
    for needle in ("legal: nothing held", "legal: a dict's get"):
        assert _fixture_lines("badsync.py", needle)[0] not in \
            [f.line for f in findings]


def test_blk_cond_wait_through_helper_discharges_own_lock(tmp_path):
    """Review regression: a Condition.wait hoisted into a helper still
    releases the condition's own lock -- the canonical cond-var pattern
    must not be flagged through the call edge; a SECOND held lock
    staying held across the wait still is."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._cond = threading.Condition()\n"
        "        self._other = threading.Lock()\n"
        "    def ok(self):\n"
        "        with self._cond:\n"
        "            self._wait_helper()\n"
        "    def bad(self):\n"
        "        with self._other:\n"
        "            with self._cond:\n"
        "                self._wait_helper()\n"
        "    def _wait_helper(self):\n"
        "        self._cond.wait()\n")
    findings = core.lint_paths([str(p)], doc=False)
    blk = [f for f in findings if f.rule == "BLK"]
    assert len(blk) == 1  # only the _other-held route
    assert "_other" in blk[0].message and "_cond.wait" in blk[0].message


def test_blk_cond_wait_does_not_shadow_later_blocking_op(tmp_path):
    """Review regression: the per-function block summary keeps one
    witness PER released lock -- a Condition.wait in a helper must not
    hide a plain sleep behind the same call edge when the caller's held
    lock is the one the wait releases."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "import time\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        self._cv = threading.Condition()\n"
        "    def caller(self):\n"
        "        with self._cv:\n"
        "            self._helper()\n"
        "    def _helper(self):\n"
        "        self._cv.wait()\n"
        "        time.sleep(1)\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["BLK"]
    assert "time.sleep" in findings[0].message


def test_blk_lock_shadow_param_not_module_lock(tmp_path):
    """Review regression: a parameter/local shadowing a registered
    lock's name is NOT the module lock -- blocking under it must not be
    misattributed (which would also fabricate LCK order edges)."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "import time\n"
        "_LOCK = threading.Lock()\n"
        "def f(_LOCK):\n"
        "    with _LOCK:\n"
        "        time.sleep(0.1)\n")
    assert core.lint_paths([str(p)], doc=False) == []


def test_tsi_for_and_with_as_targets_recorded(tmp_path):
    """Review regression: `for self.cur in ...:` and
    `with open() as self.fh:` write the attribute like any assignment
    -- two-root spellings of either must fire."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class W:\n"
        "    def start(self):\n"
        "        threading.Thread(target=self._w1).start()\n"
        "        threading.Thread(target=self._w2).start()\n"
        "    def _w1(self):\n"
        "        for self.cur in range(3):\n"
        "            pass\n"
        "        with open('/dev/null') as self.fh:\n"
        "            pass\n"
        "    def _w2(self):\n"
        "        for self.cur in range(3):\n"
        "            pass\n"
        "        with open('/dev/null') as self.fh:\n"
        "            pass\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["TSI", "TSI"]
    msgs = " ".join(f.message for f in findings)
    assert ".cur`" in msgs and ".fh`" in msgs


def test_blk_from_import_spelling_caught(tmp_path):
    """Review regression: `from time import sleep` / import aliases
    resolve to the canonical blocking spelling -- an import-style
    refactor must not disarm the rule."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "from time import sleep\n"
        "import subprocess as sp\n"
        "_LOCK = threading.Lock()\n"
        "def f():\n"
        "    with _LOCK:\n"
        "        sleep(1)\n"
        "def g():\n"
        "    with _LOCK:\n"
        "        sp.run(['true'])\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["BLK", "BLK"]
    assert [f.line for f in findings] == [7, 10]


def test_tsi_call_binding_target_does_not_root_the_callee(tmp_path):
    """Review regression: in `t = pick(worker_a, worker_b);
    Thread(target=t)` the candidates are the ARGUMENTS -- `pick` runs
    synchronously on the spawning thread and must not become a root
    (its writes would inflate root counts and pollute the inventory)."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_G = 0\n"
        "def pick(a, b):\n"
        "    global _G\n"
        "    _G = 1\n"           # synchronous write: no reaching root
        "    return a\n"
        "def spawn():\n"
        "    t = pick(worker_a, worker_b)\n"
        "    threading.Thread(target=t).start()\n"
        "def worker_a():\n"
        "    global _G\n"
        "    _G = 2\n"           # ONE root writes _G: no finding
        "def worker_b():\n"
        "    pass\n")
    assert core.lint_paths([str(p)], doc=False) == []


def test_blk_through_nested_def_called_under_lock(tmp_path):
    """A nested def invoked SYNCHRONOUSLY while the lock is held blocks
    under the lock like any helper: the intra-module nested-label call
    edge carries the witness chain (nested defs are separate records,
    not folds, since the thread-root rework)."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "import time\n"
        "_LOCK = threading.Lock()\n"
        "def outer():\n"
        "    def slow():\n"
        "        time.sleep(0.1)\n"
        "    with _LOCK:\n"
        "        slow()\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["BLK"]
    assert "outer -> outer.slow -> `time.sleep`" in findings[0].message


def test_tsi_thread_spawned_in_loop_else_not_multi_instance(tmp_path):
    """Review regression: a for/while `else` block runs exactly once,
    after the loop -- a thread spawned there is single-instance and its
    private writes stay legal."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_G = 0\n"
        "def spawn(items):\n"
        "    for it in items:\n"
        "        pass\n"
        "    else:\n"
        "        threading.Thread(target=worker).start()\n"
        "def worker():\n"
        "    global _G\n"
        "    _G = 1\n")
    assert core.lint_paths([str(p)], doc=False) == []


def test_tsi_tuple_unpacking_write_caught(tmp_path):
    """Review regression: `self.a, self.b = ...` writes both attributes
    -- the unpacking spelling must not reopen the hole the rule
    closes."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class W:\n"
        "    def start(self):\n"
        "        threading.Thread(target=self._w1).start()\n"
        "        threading.Thread(target=self._w2).start()\n"
        "    def _w1(self):\n"
        "        self.a, self.b = 1, 2\n"
        "    def _w2(self):\n"
        "        self.a, self.b = 3, 4\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["TSI", "TSI"]
    msgs = " ".join(f.message for f in findings)
    assert ".a`" in msgs and ".b`" in msgs


def test_tsi_nonanchor_escape_suppression_carried(tmp_path):
    """Review regression: a tsi-ok on a NON-anchor write line suppresses
    the finding -- and the (finding, reason) pair still reaches the
    report's suppressed surface (SARIF must audit the escape, not watch
    the finding vanish)."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_G = 0\n"
        "def spawn():\n"
        "    threading.Thread(target=w1).start()\n"
        "    threading.Thread(target=w2).start()\n"
        "def w1():\n"
        "    global _G\n"
        "    _G = 1\n"
        "def w2():\n"
        "    global _G\n"
        "    # spgemm-lint: tsi-ok(seeded: non-anchor escape)\n"
        "    _G = 2\n")
    report = core.lint_run([str(p)], doc=False)
    assert report.findings == []
    pairs = [(f, reason) for f, reason in report.suppressed
             if f.rule == "TSI"]
    assert len(pairs) == 1
    assert "non-anchor escape" in pairs[0][1]
    # the escape is inventoried in use, not stale
    tsi = [s for s in report.suppressions if s.rule == "TSI"]
    assert len(tsi) == 1 and not tsi[0].stale


def test_blk_sibling_nested_def_call_resolves(tmp_path):
    """Review regression: a nested def calling its SIBLING nested def
    resolves by ascending through enclosing function scopes -- a
    blocking op behind that hop while the lock is held is still a
    finding (the OOC stager/lander helper shape)."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "import time\n"
        "_LOCK = threading.Lock()\n"
        "def outer():\n"
        "    def a():\n"
        "        b()\n"
        "    def b():\n"
        "        time.sleep(1)\n"
        "    with _LOCK:\n"
        "        a()\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["BLK"]
    assert "outer -> outer.a -> outer.b -> `time.sleep`" \
        in findings[0].message


def test_nested_name_never_resolves_to_sibling_method(tmp_path):
    """The ascent stops at function scopes: a bare call inside a method
    must not resolve to a sibling METHOD of the class (Python name
    resolution would not either)."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "import time\n"
        "_LOCK = threading.Lock()\n"
        "class W:\n"
        "    def m(self):\n"
        "        with _LOCK:\n"
        "            sleeper()\n"      # NOT W.sleeper: no finding
        "    def sleeper(self):\n"
        "        time.sleep(1)\n")
    assert core.lint_paths([str(p)], doc=False) == []


def test_blk_escape_on_unreached_op_goes_stale(tmp_path):
    """Review regression: a blk-ok on a blocking op that is never
    reached with a lock held (e.g. the hazard was fixed by hoisting but
    the escape was forgotten) suppresses nothing -- SUP must report it
    stale, not let the dead justification outlive the code."""
    p = tmp_path / "h.py"
    p.write_text(
        "import time\n"
        "def poll():\n"
        "    # spgemm-lint: blk-ok(left behind after the hoist)\n"
        "    time.sleep(0.1)\n")
    findings, suppressions = core.lint_report([str(p)], doc=False)
    assert [f.rule for f in findings] == ["SUP"]
    assert len(suppressions) == 1 and suppressions[0].stale


def test_blk_source_escapes_on_lock_held_routes_stay_used(tmp_path):
    """The counterpart: source blk-oks whose ops ARE reached under a
    lock are in use -- including a SECOND escaped route behind the first
    (the failpoints delay+hang shape), which a single-witness summary
    would miss."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "import time\n"
        "_LOCK = threading.Lock()\n"
        "def entry():\n"
        "    with _LOCK:\n"
        "        helper()\n"
        "def helper():\n"
        "    # spgemm-lint: blk-ok(seeded: bounded injected delay)\n"
        "    time.sleep(0.1)\n"
        "    deeper()\n"
        "def deeper():\n"
        "    # spgemm-lint: blk-ok(seeded: the second escaped route)\n"
        "    time.sleep(0.2)\n")
    report = core.lint_run([str(p)], doc=False)
    assert report.findings == []  # both routes escaped at source
    assert len(report.suppressions) == 2
    assert not any(s.stale for s in report.suppressions)
    # the transitively-suppressed call-site finding still reaches the
    # SARIF suppressions surface, reason attached from the source escape
    pairs = [(f, r) for f, r in report.suppressed if f.rule == "BLK"]
    assert len(pairs) == 1
    assert "bounded injected delay" in pairs[0][1]


def test_tsi_threading_local_writes_exempt(tmp_path):
    """threading.local() is per-thread by construction: writes through
    a registered local (the flight recorder's span stack) are not
    shared state."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class R:\n"
        "    def __init__(self):\n"
        "        self._tls = threading.local()\n"
        "        threading.Thread(target=self._w1).start()\n"
        "        threading.Thread(target=self._w2).start()\n"
        "    def _w1(self):\n"
        "        self._tls.stack = [1]\n"
        "    def _w2(self):\n"
        "        self._tls.stack = [2]\n")
    assert core.lint_paths([str(p)], doc=False) == []


def test_tsi_module_singleton_attr_write_caught(tmp_path):
    """Review regression: `STATE.flag = ...` mutates the module-level
    singleton exactly like `STATE['k'] = ...` -- attribute spelling must
    not be invisible to TSI."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class Holder:\n"
        "    pass\n"
        "STATE = Holder()\n"
        "def spawn():\n"
        "    threading.Thread(target=w1).start()\n"
        "    threading.Thread(target=w2).start()\n"
        "def w1():\n"
        "    STATE.flag = True\n"
        "def w2():\n"
        "    STATE.flag = False\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["TSI"]
    assert "STATE" in findings[0].message


def test_cache_malformed_entry_falls_back_cold(tmp_path):
    """A structurally malformed (but valid-JSON) cache entry is a
    counted invalidation and a cold re-run, never a crash -- the
    best-effort contract."""
    d = tmp_path / "c"
    d.mkdir()
    (d / "cache.json").write_text(json.dumps({"files": {
        "a.py": "not-a-dict",
        "b.py": {"sha": "s", "version": core._analysis_signature()},
    }}))
    cache = core.LintCache(str(d))
    assert cache.get("a.py", "s") is None   # non-dict entry
    assert cache.get("b.py", "s") is None   # missing findings/raw keys
    assert cache.invalidations == 2 and cache.hits == 0


def test_tsi_nested_def_thread_in_init_not_exempt(tmp_path):
    """The review regression verbatim: a closure defined in __init__ and
    passed to Thread(target=...) runs AFTER publication -- its writes
    must not inherit __init__'s happens-before exemption, and with a
    second root writing the same attr the race is a finding."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        def warm():\n"
        "            self.state = 'warm'\n"
        "        threading.Thread(target=warm).start()\n"
        "        threading.Thread(target=self._serve).start()\n"
        "    def _serve(self):\n"
        "        self.state = 'serving'\n")
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["TSI"]
    assert "state" in findings[0].message
    assert "__init__.warm" in findings[0].message


# ------------------------------------------------------------- TSI rule --
def test_tsi_fixture_each_violation_caught():
    """The seeded thread-shared fixture: an attribute written from both
    Thread targets, a module global written by a nested-def root spawned
    from two sites, and an attribute written by a loop-spawned
    multi-instance root are findings; annotated state, __init__ writes,
    single-root writes, and the reasoned tsi-ok handoff slot stay
    legal."""
    findings, suppressions = core.lint_report(
        [os.path.join(JAX_FIXTURES, "badshared.py")], doc=False)
    assert [f.rule for f in findings] == ["TSI"] * 3
    by_line = {f.line: f.message for f in findings}
    nested = _fixture_lines("badshared.py", "nested-def root")[0]
    first = _fixture_lines("badshared.py", "TSI: two-root write")[0]
    second = _fixture_lines("badshared.py", "the second root's write")[0]
    multi = _fixture_lines("badshared.py", "multi-instance root")[0]
    assert set(by_line) == {nested, first, multi}
    two_root = by_line[first]
    assert "2 thread roots" in two_root
    assert "Worker._loop_a" in two_root and "Worker._loop_b" in two_root
    assert f"badshared.py:{first}" in two_root  # every write site named
    assert f"badshared.py:{second}" in two_root
    # the nested-def target resolves as a root in its own right, and its
    # two spawn sites make it multi-instance by themselves
    assert "spawn_workers.worker" in by_line[nested]
    assert "multi-instance" in by_line[nested]
    # one loop-spawned target = many threads: one root suffices
    assert "ConnServer._handle" in by_line[multi]
    assert "multi-instance" in by_line[multi]
    for needle in ("legal: annotated", "happens-before publication",
                   "legal: reached from one root", "self.beat = 1.0",
                   "self.beat = 2.0"):
        assert _fixture_lines("badshared.py", needle)[0] not in by_line
    # both tsi-ok escapes on the beat slot are inventoried, in use
    tsi = [s for s in suppressions if s.rule == "TSI"]
    assert len(tsi) == 2 and not any(s.stale for s in tsi)


def test_tsi_single_spawn_single_root_stays_quiet(tmp_path):
    """The precision boundary: ONE thread spawned once on one target
    writing its own private state is not a race -- no finding (the
    multi-instance weighting fires only on loop spawns and multi-site
    spawns)."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class W:\n"
        "    def __init__(self):\n"
        "        threading.Thread(target=self._work).start()\n"
        "    def _work(self):\n"
        "        self.n = 1\n")
    assert core.lint_paths([str(p)], doc=False) == []


def test_tsi_loop_variable_target_not_multi_instance(tmp_path):
    """The daemon's for-over-(target, name)-tuples start() spelling
    spawns each bound function ONCE: a loop whose iteration rebinds the
    target must not mark those roots multi-instance (each root's private
    writes stay legal); two DISTINCT roots writing one attr still
    fire."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "class W:\n"
        "    def start(self):\n"
        "        for target in (self._a, self._b):\n"
        "            threading.Thread(target=target).start()\n"
        "    def _a(self):\n"
        "        self.a_private = 1\n"   # one root: legal
        "        self.shared = 1\n"      # two roots: finding
        "    def _b(self):\n"
        "        self.b_private = 1\n"   # one root: legal
        "        self.shared = 2\n")     # the second root's write
    findings = core.lint_paths([str(p)], doc=False)
    assert [f.rule for f in findings] == ["TSI"]
    assert "shared" in findings[0].message
    assert "multi-instance" not in findings[0].message


# ------------------------------- v3 guard-deletion spot-checks (live copies) --
def test_lck_reentry_turns_lint_red(tmp_path):
    """Acceptance spot-check on a FIXTURE COPY of serve/daemon.py: the
    port's daemon holds no lock-order escape (the JAX package's one
    lck-ok, the recovery probe re-entering _spawn_executor, has no
    counterpart here), and the copy lints clean; calling _slice_rows --
    which takes self._lock -- from inside _journal_stats's `with
    self._lock:` must produce the LCK self-deadlock finding, so the
    analysis provably binds to the live module."""
    src = open(os.path.join(REPO, "spgemm_tpu_torch", "serve",
                            "daemon.py")).read()
    assert "spgemm-lint: lck-ok(" not in src
    p = tmp_path / "daemon.py"
    p.write_text(src)
    assert core.lint_paths([str(p)], doc=False) == []
    anchor = ("        with self._lock:\n"
              "            return {\"path\": self.journal_path, ")
    assert src.count(anchor) == 1, "anchor drifted in serve/daemon.py"
    p.write_text(src.replace(anchor, "        with self._lock:\n"
                             "            self._slice_rows()\n"
                             "            return {\"path\": "
                             "self.journal_path, "))
    lck = [f for f in core.lint_paths([str(p)], doc=False)
           if f.rule == "LCK"]
    assert lck, "re-acquiring Daemon._lock must turn lint red"
    assert "re-acquired while already held" in lck[0].message
    assert "_slice_rows" in lck[0].message


def test_blk_sleep_under_lock_turns_lint_red(tmp_path):
    """Acceptance spot-check on a FIXTURE COPY of ops/warmstore.py: the
    copy lints clean (its real flock/sleep sites carry reasoned blk-ok
    escapes), and adding one time.sleep inside a `with _LOCK:` block
    must produce a BLK finding."""
    src = open(os.path.join(REPO, "spgemm_tpu_torch", "ops",
                            "warmstore.py")).read()
    p = tmp_path / "warmstore.py"
    p.write_text(src)
    assert core.lint_paths([str(p)], doc=False) == []
    guarded = ("def directory() -> str | None:\n"
               "    with _LOCK:\n        return _DIR")
    mutated = src.replace(
        guarded, "def directory() -> str | None:\n    with _LOCK:\n"
                 "        time.sleep(0.2)\n        return _DIR")
    assert mutated != src, "anchor drifted in ops/warmstore.py"
    p.write_text(mutated)
    blk = [f for f in core.lint_paths([str(p)], doc=False)
           if f.rule == "BLK"]
    assert blk, "a sleep under _LOCK in warmstore must turn lint red"
    assert "time.sleep" in blk[0].message and "_LOCK" in blk[0].message


def test_tsi_guard_strip_turns_lint_red(tmp_path):
    """Acceptance spot-check on a FIXTURE COPY of serve/daemon.py:
    stripping the guarded-by annotation from Daemon.degraded -- written
    from the watchdog and recovery-probe thread roots -- must produce a
    TSI finding (the THR opt-in hole stays closed on the live module)."""
    src = open(os.path.join(REPO, "spgemm_tpu_torch", "serve",
                            "daemon.py")).read()
    annotated = ("self.degraded = False                    "
                 "# spgemm-lint: guarded-by(_lock)")
    mutated = src.replace(annotated, "self.degraded = False")
    assert mutated != src, "annotation anchor drifted in serve/daemon.py"
    p = tmp_path / "daemon.py"
    p.write_text(mutated)
    tsi = [f for f in core.lint_paths([str(p)], doc=False)
           if f.rule == "TSI"]
    assert tsi, \
        "stripping guarded-by from a two-root attribute must turn lint red"
    assert "degraded" in tsi[0].message
    assert "thread roots" in tsi[0].message
    assert "guarded-by" in tsi[0].message


# ------------------------------------------------------------- EXC rule --
def test_exc_fixture_each_violation_caught():
    """Naked broad catch, swallowing bare except, swallowing BaseException
    -- and the legal shapes: BLE001-with-reason, re-raising handler,
    reasoned exc-ok escape."""
    findings = lint_file(os.path.join(JAX_FIXTURES, "badexcept.py"))
    exc = [f for f in findings if f.rule == "EXC"]
    assert len(exc) == 3 and findings == exc
    flagged = [f.line for f in exc]
    for needle in ("no BLE001 justification", "bare except that swallows",
                   "would swallow JobAbandoned"):
        assert _fixture_lines("badexcept.py", needle)[0] in flagged
    legal = (_fixture_lines("badexcept.py", "noqa: BLE001")
             + _fixture_lines("badexcept.py", "re-raises"))
    assert legal and not set(legal) & set(flagged)


def test_exc_ble_reason_must_be_nonempty(tmp_path):
    """A bare `# noqa: BLE001` (no `-- reason`) does not justify the broad
    catch -- the reason is the reviewable citation."""
    p = tmp_path / "h.py"
    p.write_text("def f():\n"
                 "    try:\n"
                 "        pass\n"
                 "    except Exception:  # noqa: BLE001\n"
                 "        pass\n")
    assert [f.rule for f in lint_file(str(p))] == ["EXC"]


def test_exc_base_reraise_must_be_terminal(tmp_path):
    """A conditional re-raise does not satisfy the provably-re-raise
    contract: the handler body must END in `raise`."""
    p = tmp_path / "h.py"
    p.write_text("def f(flag):\n"
                 "    try:\n"
                 "        pass\n"
                 "    except BaseException:\n"
                 "        if flag:\n"
                 "            raise\n"
                 "        return None\n")
    assert [f.rule for f in lint_file(str(p))] == ["EXC"]


# ------------------------------------------- interprocedural FLD (taint) --
def test_interprocedural_fld_one_hop_outside_numeric():
    """The acceptance case: a numeric module calling a helper in a
    NON-numeric module whose body performs the unordered reduction is
    flagged at the call site, one and two hops deep, with the witness
    chain down to the reduction's file:line in the message."""
    findings = core.lint_paths([os.path.join(FIXTURES, "callchain")],
                               doc=False)
    fld = [f for f in findings if f.rule == "FLD"]
    assert len(fld) == 2 and findings == fld
    assert all(f.file.endswith("callchain/ops/spgemm.py") for f in fld)
    by_msg = {f.line: f.message for f in fld}
    src = open(os.path.join(FIXTURES, "callchain", "ops",
                            "spgemm.py")).read()
    one = next(i for i, ln in enumerate(src.splitlines(), 1)
               if "one call-hop" in ln)
    two = next(i for i, ln in enumerate(src.splitlines(), 1)
               if "two call-hops" in ln)
    assert set(by_msg) == {one, two}
    assert "hidden_add -> `out.index_add_`" in by_msg[one]
    assert "hosthelper.py:" in by_msg[one]
    assert "outer -> inner -> `torch.sum`" in by_msg[two]
    assert "hostdeep.py:" in by_msg[two]
    # the call-site escape and the source-proved helper stay clean
    escaped = next(i for i, ln in enumerate(src.splitlines(), 1)
                   if "call-site escape" in ln)
    proved = next(i for i, ln in enumerate(src.splitlines(), 1)
                  if "proves its sum at source" in ln)
    assert not {escaped, escaped + 1, proved} & set(by_msg)


def test_interprocedural_fld_same_module_helper_still_flagged(tmp_path):
    """Module-scoped evasion INSIDE numeric code never existed (check_fld
    sees the whole module); the taint pass must not double-report it."""
    p = tmp_path / "ops" / "spgemm.py"
    p.parent.mkdir()
    p.write_text("import torch\n"
                 "def helper(x):\n"
                 "    return torch.sum(x)\n"
                 "def entry(x):\n"
                 "    return helper(x)\n")
    findings = core.lint_paths([str(tmp_path)], doc=False)
    # exactly one finding: the direct reduction (per-module FLD); the
    # same-module call edge is not re-reported by the taint pass
    assert [f.rule for f in findings] == ["FLD"]
    assert findings[0].line == 3


def test_interprocedural_fld_import_alias_resolves(tmp_path):
    """`import helpers as h; h.f(...)` resolves through the alias."""
    (tmp_path / "ops").mkdir()
    (tmp_path / "ops" / "u64.py").write_text(
        "import myhelpers as h\n"
        "def entry(x):\n"
        "    return h.hidden(x)\n")
    (tmp_path / "myhelpers.py").write_text(
        "import torch\n"
        "def hidden(x):\n"
        "    return torch.sum(x)\n")
    findings = core.lint_paths([str(tmp_path)], doc=False)
    assert [f.rule for f in findings] == ["FLD"]
    assert findings[0].file.endswith("ops/u64.py") and findings[0].line == 3


# --------------------------------------------------- suppression audit --
def test_stale_suppressions_reported():
    """An escape comment on a line that no longer produces the underlying
    finding is itself a finding (SUP), for every escape family -- the
    three v2 spellings AND the v3 concurrency ones (lck-ok / blk-ok /
    tsi-ok), all in the one inventory."""
    findings, suppressions = core.lint_report(
        [os.path.join(JAX_FIXTURES, "stalesup.py")], doc=False)
    assert [f.rule for f in findings] == ["SUP"] * 7
    assert {s.rule for s in suppressions} == {"FLD", "THR", "EXC",
                                              "LCK", "BLK", "TSI", "DRF"}
    assert all(s.stale for s in suppressions)
    assert all("seeded-stale" in s.reason for s in suppressions)
    assert [f.line for f in findings] == [s.line for s in sorted(
        suppressions, key=lambda s: s.line)]


def test_fld_proof_on_clean_numeric_line_is_stale(tmp_path):
    """The acceptance case verbatim: a fld-proof(...) comment on a clean
    line IN A NUMERIC MODULE is reported as stale."""
    p = tmp_path / "ops" / "u64.py"
    p.parent.mkdir()
    p.write_text("def f(x):\n"
                 "    # spgemm-lint: fld-proof(left over from a refactor)\n"
                 "    return x + 1\n")
    findings, suppressions = core.lint_report([str(p)], doc=False)
    assert [f.rule for f in findings] == ["SUP"]
    assert "suppresses nothing" in findings[0].message
    assert len(suppressions) == 1 and suppressions[0].stale


def test_used_suppressions_inventoried_not_stale():
    """Escapes that DO suppress something appear in the inventory with
    stale=false and produce no SUP finding -- incl. interprocedural
    call-site escapes and taint-suppressing source escapes."""
    findings, suppressions = core.lint_report(
        [os.path.join(FIXTURES, "callchain")], doc=False)
    assert [f.rule for f in findings] == ["FLD", "FLD"]
    assert len(suppressions) == 2  # call-site escape + source escape
    assert not any(s.stale for s in suppressions)


# ------------------------------------------------- JSON report contract --
def test_json_report_fixture_run():
    """The machine-readable report: every rule family present with the
    correct rule ID, (file, line, rule, message) per finding, the full
    suppression inventory, the cache block, exit 1 -- over the port's
    fixture tree plus the JAX package's seven idiom-free fixtures."""
    rc = _run(["-m", "spgemm_tpu_torch.analysis", "--json", "--no-cache",
               FIXTURES, *(os.path.join(JAX_FIXTURES, name)
                           for name in PARITY_FIXTURES),
               "--claude-md", FIXTURE_DOC])
    assert rc.returncode == 1, rc.stderr[-2000:]
    report = json.loads(rc.stdout)
    assert report["clean"] is False
    # FLD: 9 per-module (ops/spgemm) + 1 ops/delta + 1 ops/estimate + 1
    # ops/cuda_fold numeric-scope + 2 interprocedural (callchain); KNB:
    # badknob's 25 reads; BKD: 4 import-time touches (badbackend) + 2
    # @host_only-body touches (badplanner); badthread/badexcept: 3 each;
    # badlockorder: cycle + self-edge; badblocking: direct + transitive
    # + typed-queue, badsync: 4 torch blocking calls; badshared: 3;
    # stalesup: one stale escape per family (7); badmetric: 10;
    # badfailpoint: 2 undeclared + 1 computed;
    # badproto: 9; badevent: 2 undeclared kinds + 1 computed kind; DRF
    # stays quiet (no registry module in the fixture unit set); DOC: the
    # drifted knob table
    assert report["counts"] == {"FLD": 14, "KNB": 25, "BKD": 6, "THR": 3,
                                "LCK": 2, "BLK": 7, "TSI": 3,
                                "EXC": 3, "MET": 10, "FPT": 3,
                                "PRO": 9, "EVT": 3, "DRF": 0, "DOC": 1,
                                "SUP": 7, "PARSE": 0}
    assert set(report["counts"]) == set(core.RULES)
    for f in report["findings"]:
        assert set(f) == {"file", "line", "rule", "message"}
        assert f["rule"] in core.RULES
        assert isinstance(f["line"], int) and f["line"] >= 1
    # the suppression inventory: every escape comment in the run, with
    # the seven stalesup.py seeds marked stale
    sup = report["suppressions"]
    assert all(set(s) == {"file", "line", "rule", "reason", "stale"}
               for s in sup)
    assert sum(s["stale"] for s in sup) == 7
    assert all(s["file"].endswith("stalesup.py")
               for s in sup if s["stale"])
    # 7 stale + thr-ok + exc-ok + 3 fld escapes + blk-ok (badblocking)
    # + 2 tsi-ok (badshared) in use
    assert len(sup) == 15
    # --no-cache: the cache block reports disabled, nothing else
    assert report["cache"] == {"enabled": False}


def test_json_report_clean_repo_run_cold_then_warm(tmp_path):
    """`make lint-torch` contract, cold AND warm: the default run exits 0
    with a clean report (and never needs a card -- the linter is
    torch-free by design), the port's own escape inventory rides along
    all in use -- including the reasoned fld-proof/blk-ok escapes -- and
    a second run on the unchanged tree is served from
    the content-hash cache: hits > 0, zero misses, byte-identical
    output.  Timing-assertion-free by design: the hit/miss figures, not
    the wall clock, are the contract."""
    args = ["-m", "spgemm_tpu_torch.analysis", "--json",
            "--cache-dir", str(tmp_path / "cache")]
    rc = _run(args)
    assert rc.returncode == 0, rc.stdout + rc.stderr[-2000:]
    cold = json.loads(rc.stdout)
    assert cold["clean"] is True and cold["findings"] == []
    assert not any(s["stale"] for s in cold["suppressions"])
    rules_in_use = {s["rule"] for s in cold["suppressions"]}
    assert {"FLD", "BLK"} <= rules_in_use
    cache = cold["cache"]
    assert cache["enabled"] is True
    assert cache["hits"] == 0 and cache["invalidations"] == 0
    assert cache["misses"] > 0  # a fresh cache dir: every unit is cold
    rc2 = _run(args)
    assert rc2.returncode == 0, rc2.stdout + rc2.stderr[-2000:]
    warm = json.loads(rc2.stdout)
    assert warm["cache"]["hits"] == cache["misses"]
    assert warm["cache"]["misses"] == 0
    assert warm["cache"]["invalidations"] == 0
    for key in ("findings", "counts", "suppressions", "clean"):
        assert warm[key] == cold[key]


# ---------------------------------------------- content-hash result cache --
def test_cache_warm_fixture_run_byte_identical(tmp_path):
    """The fixture tree (a run WITH findings) twice through one cache
    dir: the cold run misses every unit, the warm run hits every unit
    and re-runs none -- with byte-identical findings, counts, and
    suppressions either way (cached per-file results feed the
    whole-program passes exactly like live ones)."""
    args = ["-m", "spgemm_tpu_torch.analysis", "--json",
            "--cache-dir", str(tmp_path / "cache"), FIXTURES,
            "--claude-md", FIXTURE_DOC]
    cold = json.loads(_run(args).stdout)
    warm = json.loads(_run(args).stdout)
    assert cold["cache"]["hits"] == 0 and cold["cache"]["misses"] > 0
    assert warm["cache"]["hits"] == cold["cache"]["misses"]
    assert warm["cache"]["misses"] == 0
    assert warm["cache"]["invalidations"] == 0
    for key in ("findings", "counts", "suppressions", "clean"):
        assert warm[key] == cold[key]


def test_cache_invalidates_on_edit(tmp_path):
    """Editing one file invalidates exactly that entry (counted as an
    invalidation, not a miss); untouched files still hit."""
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "a.py").write_text("def f():\n    return 1\n")
    (tree / "b.py").write_text("def g():\n    return 2\n")
    cdir = str(tmp_path / "cache")
    args = ["-m", "spgemm_tpu_torch.analysis", "--json", "--cache-dir", cdir,
            str(tree)]
    r1 = json.loads(_run(args).stdout)
    assert r1["cache"] == {"enabled": True, "dir": cdir, "hits": 0,
                           "misses": 2, "invalidations": 0}
    (tree / "a.py").write_text("def f():\n    return 3\n")
    r2 = json.loads(_run(args).stdout)
    assert r2["cache"]["hits"] == 1
    assert r2["cache"]["invalidations"] == 1
    assert r2["cache"]["misses"] == 0


def test_cache_signature_covers_rule_registries():
    """The cached per-file rules validate against obs/metrics.py (MET),
    utils/failpoints.py (FPT), serve/protocol.py (PRO), and
    obs/events.py (EVT): all four must feed the linter-version
    signature, or a registry edit would replay stale cached results
    while the call sites' files are untouched."""
    assert set(core._SIGNATURE_EXTRAS) == {"obs/metrics.py",
                                           "utils/failpoints.py",
                                           "serve/protocol.py",
                                           "obs/events.py"}
    for rel in core._SIGNATURE_EXTRAS:
        assert os.path.exists(os.path.join(REPO, "spgemm_tpu_torch", rel))


def test_cache_prunes_dead_entries(tmp_path):
    """Entries for files renamed or deleted out of the scope are dropped
    on prune (default-scope runs call it), so cache.json cannot grow
    without bound."""
    d = str(tmp_path / "c")
    cache = core.LintCache(d)
    cache.put("a.py", "sha", [], set(), [])
    cache.put("gone.py", "sha", [], set(), [])
    cache.save()
    c2 = core.LintCache(d)
    c2.prune({"a.py"})
    c2.save()
    c3 = core.LintCache(d)
    assert c3.get("a.py", "sha") is not None
    assert c3.get("gone.py", "sha") is None and c3.misses == 1


def test_cache_keyed_on_analysis_package_content():
    """The linter-version half of the key is the analysis package's own
    content hash: ANY rule change invalidates every entry -- there is no
    version constant to forget to bump."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        cache = core.LintCache(d)
        cache.put("x.py", "sha-of-x", [], set(), [])
        cache.save()
        fresh = core.LintCache(d)
        assert fresh.get("x.py", "sha-of-x") is not None
        assert fresh.hits == 1
        skewed = core.LintCache(d)
        skewed.signature = "not-the-analysis-package-hash"
        assert skewed.get("x.py", "sha-of-x") is None
        assert skewed.invalidations == 1
        # and a content change on the file side invalidates too
        assert fresh.get("x.py", "different-bytes") is None
        assert fresh.invalidations == 1


# ------------------------------------------------------ SARIF emission --
def test_sarif_output_schema_shape(tmp_path):
    """`--sarif F` (make lint-sarif) writes a SARIF 2.1.0 log: version +
    $schema, one run, the full rule registry as tool.driver.rules, one
    result per finding with ruleId/message/physicalLocation."""
    out = tmp_path / "lint.sarif"
    rc = _run(["-m", "spgemm_tpu_torch.analysis", "--no-cache", "--sarif",
               str(out),
               os.path.join(JAX_FIXTURES, "badthread.py"),
               os.path.join(JAX_FIXTURES, "badexcept.py")])
    assert rc.returncode == 1
    log = json.loads(out.read_text())
    assert log["version"] == "2.1.0"
    assert log["$schema"].endswith("sarif-2.1.0.json")
    assert len(log["runs"]) == 1
    run = log["runs"][0]
    driver = run["tool"]["driver"]
    assert driver["name"] == "spgemm-lint"
    assert [r["id"] for r in driver["rules"]] == list(core.RULES)
    assert all(r["shortDescription"]["text"] for r in driver["rules"])
    # 3 THR + 3 EXC active, plus the fixtures' two escaped findings
    # (thr-ok + exc-ok) carried as results with SARIF suppressions
    assert len(run["results"]) == 8
    for res in run["results"]:
        assert res["ruleId"] in core.RULES
        assert res["level"] == "error"
        assert res["message"]["text"]
        loc = res["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith(".py")
        assert loc["region"]["startLine"] >= 1
    active = [r for r in run["results"] if not r["suppressions"]]
    escaped = [r for r in run["results"] if r["suppressions"]]
    assert len(active) == 6 and len(escaped) == 2
    # an active finding carries the explicit empty array (SARIF's "not
    # suppressed", distinct from "suppression state unknown")
    assert all(r["suppressions"] == [] for r in active)
    for res in escaped:
        (sup,) = res["suppressions"]
        assert sup["kind"] == "inSource"
        assert sup["justification"]  # the escape reason, auditable
    assert {r["ruleId"] for r in escaped} == {"THR", "EXC"}


def test_sarif_clean_run_empty_results(tmp_path):
    out = tmp_path / "lint.sarif"
    rc = _run(["-m", "spgemm_tpu_torch.analysis", "--no-cache", "--sarif",
               str(out),
               os.path.join(REPO, "spgemm_tpu_torch", "utils", "timers.py")])
    assert rc.returncode == 0
    log = json.loads(out.read_text())
    assert log["runs"][0]["results"] == []


# -------------------------------------------- environment independence --
_LOADED_PROBE = (
    "import json, runpy, sys\n"
    "sys.argv = ['spgemm_tpu_torch.analysis', '--json', '--no-cache']\n"
    "try:\n"
    "    runpy.run_module('spgemm_tpu_torch.analysis', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "    rc = 0\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('torch', 'numpy', 'jax', 'jaxlib',\n"
    "                                    'spgemm_tpu'))\n"
    "print(json.dumps({'rc': rc, 'loaded': bad}), file=sys.stderr)\n")


def test_analysis_import_is_torch_free():
    """The linter must run where the card and its runtime are not: a
    default `python -m spgemm_tpu_torch.analysis --json` run (the DOC
    checks included, which build the port CLI's parser) loads none of
    torch, numpy, jax or the JAX package, and the analysis package
    imports nothing of spgemm_tpu, not even spgemm_tpu.analysis."""
    rc = subprocess.run([sys.executable, "-c", _LOADED_PROBE], cwd=REPO,
                        capture_output=True, text=True, timeout=120,
                        env={**os.environ, "PYTHONPATH": REPO})
    probe = json.loads(rc.stderr.strip().splitlines()[-1])
    assert probe == {"rc": 0, "loaded": []}, rc.stderr[-2000:]
    assert json.loads(rc.stdout)["clean"] is True
    pkg = os.path.join(REPO, "spgemm_tpu_torch", "analysis")
    for name in sorted(os.listdir(pkg)):
        if name.endswith(".py"):
            text = open(os.path.join(pkg, name)).read()
            assert "import spgemm_tpu." not in text, name
            assert "from spgemm_tpu." not in text, name
            assert "from spgemm_tpu import" not in text, name


def test_linter_reads_no_engine_env(monkeypatch):
    """Lint results are environment-independent (CI-cacheable): a full
    default run reads zero SPGEMM_TPU_* variables -- the knob table and
    CLI epilog render from registry metadata, not live values."""
    real = os.environ
    reads: list[str] = []

    class Tracker:
        def get(self, key, default=None):
            reads.append(key)
            return real.get(key, default)

        def __getitem__(self, key):
            reads.append(key)
            return real[key]

        def __contains__(self, key):
            reads.append(key)
            return key in real

        def __setitem__(self, key, value):  # pytest writes its own vars
            real[key] = value

        def __delitem__(self, key):
            del real[key]

        def __iter__(self):
            return iter(dict(real))

        def keys(self):
            return real.keys()

        def items(self):
            return real.items()

        def copy(self):
            return real.copy()

    monkeypatch.setattr(os, "environ", Tracker())
    findings = core.lint_paths(core.default_paths(),
                               claude_md=core.default_doc())
    assert findings == []
    engine_reads = [k for k in reads if k.startswith("SPGEMM_TPU_")]
    assert engine_reads == [], engine_reads


def test_analysis_help_covers_every_rule_id():
    """The DOC half for the linter's own help: the epilog (generated from
    core.RULES) names every rule id."""
    assert docrules.check_analysis_help() == []
    from spgemm_tpu_torch.analysis.__main__ import build_parser
    help_text = build_parser().format_help()
    for rule in core.RULES:
        assert rule in help_text


# ------------------------------------------- review-hardening regressions --
def test_interprocedural_fld_taint_survives_call_cycle(tmp_path):
    """Regression: memoizing the in-progress None used to cut cycles
    finalized an ancestor as clean when its only route to a reduction ran
    through the cycle -- the call site a -> b -> d -> torch.sum was silently
    missed whenever b's back-edge to a was visited first."""
    (tmp_path / "ops").mkdir()
    (tmp_path / "ops" / "u64.py").write_text(
        "import helpa\n"
        "def entry(x):\n"
        "    return helpa.a_fn(x)\n")
    (tmp_path / "helpa.py").write_text(
        "import helpb\n"
        "def a_fn(x):\n"
        "    return helpb.b_fn(x)\n")
    (tmp_path / "helpb.py").write_text(
        "import helpa\n"
        "import helpd\n"
        "def b_fn(x):\n"
        "    helpa.a_fn(x)\n"          # cycle edge, visited first
        "    return helpd.d_fn(x)\n")  # the route to the reduction
    (tmp_path / "helpd.py").write_text(
        "import torch\n"
        "def d_fn(x):\n"
        "    return torch.sum(x)\n")
    findings = core.lint_paths([str(tmp_path)], doc=False)
    assert [f.rule for f in findings] == ["FLD"]
    assert findings[0].file.endswith("ops/u64.py")
    assert "a_fn -> b_fn -> d_fn -> `torch.sum`" in findings[0].message


def test_thr_local_shadow_of_guarded_global_not_flagged(tmp_path):
    """Regression: a plain local that shadows a guarded module global is
    the LOCAL on every use (no `global` declaration), so THR must not
    fire on it -- while `global X` rebinding stays checked, including
    from a nested def closing over the shadowing scope."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_CACHE = {}  # spgemm-lint: guarded-by(_LOCK)\n"
        "_LOCK = threading.Lock()\n"
        "def local_shadow():\n"
        "    _CACHE = {}\n"          # a plain local, not the global
        "    _CACHE['x'] = 1\n"      # must NOT be a finding
        "    def inner():\n"
        "        return _CACHE\n"    # closure over the local: clean too
        "    return inner\n"
        "def global_rebind():\n"
        "    global _CACHE\n"
        "    _CACHE = {}\n"          # THE global, unguarded: finding
        "def global_read():\n"
        "    return len(_CACHE)\n")  # the global, unguarded: finding
    findings = lint_file(str(p))
    assert [f.rule for f in findings] == ["THR", "THR"]
    assert [f.line for f in findings] == [12, 14]


def test_exc_ble_reason_on_wrapped_handler_clause(tmp_path):
    """Regression: a handler whose caught-type tuple wraps across lines
    carries its justification on the clause's LAST line -- it must count
    (a reformat of a justified handler must not break lint)."""
    p = tmp_path / "h.py"
    p.write_text(
        "def f():\n"
        "    try:\n"
        "        pass\n"
        "    except (ValueError,\n"
        "            Exception):  # noqa: BLE001 -- seeded: wrapped clause\n"
        "        pass\n")
    assert lint_file(str(p)) == []


def test_thr_parameter_shadow_of_guarded_global_not_flagged(tmp_path):
    """Regression: a function PARAMETER named like a guarded module global
    is the local on every use -- THR must not fire on it."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_COUNT = 0  # spgemm-lint: guarded-by(_LOCK)\n"
        "_LOCK = threading.Lock()\n"
        "def param_shadow(_COUNT):\n"
        "    return _COUNT + 1\n"       # the parameter, not the global
        "def star_shadow(*_COUNT, **kw):\n"
        "    return len(_COUNT)\n"      # vararg parameter: local too
        "def real_read():\n"
        "    return _COUNT\n")          # THE global, unguarded: finding
    findings = lint_file(str(p))
    assert [f.rule for f in findings] == ["THR"]
    assert findings[0].line == 9


def test_thr_init_not_exempt_for_module_globals(tmp_path):
    """Regression: __init__'s exemption holds only for the instance's own
    attributes (construction happens-before publication); a module global
    is already published to every thread while __init__ runs, so an
    unguarded write there is a real lost-update race -- a finding."""
    p = tmp_path / "h.py"
    p.write_text(
        "import threading\n"
        "_COUNT = 0  # spgemm-lint: guarded-by(_LOCK)\n"
        "_LOCK = threading.Lock()\n"
        "class Reg:\n"
        "    def __init__(self):\n"
        "        global _COUNT\n"
        "        _COUNT += 1\n"         # global in a ctor: still a finding
        "        self.n = _COUNT\n")
    findings = lint_file(str(p))
    assert [f.rule for f in findings] == ["THR", "THR"]
    assert [f.line for f in findings] == [7, 8]


def test_fld_proof_two_lines_above_interprocedural_finding_is_stale(tmp_path):
    """Regression: an fld-proof escape TWO lines above a tainted call
    suppresses nothing (escapes bind to their line and the one below) --
    the finding must still fire AND the escape must be reported stale,
    not vouched for by a widened used-window."""
    (tmp_path / "ops").mkdir()
    (tmp_path / "ops" / "u64.py").write_text(
        "import farhelp\n"
        "def entry(x):\n"
        "    # spgemm-lint: fld-proof(too far away to bind)\n"
        "    y = x\n"
        "    return farhelp.hidden(y)\n")
    (tmp_path / "farhelp.py").write_text(
        "import torch\n"
        "def hidden(x):\n"
        "    return torch.sum(x)\n")
    findings, suppressions = core.lint_report([str(tmp_path)], doc=False)
    assert sorted(f.rule for f in findings) == ["FLD", "SUP"]
    assert len(suppressions) == 1 and suppressions[0].stale


# ------------------------------------------------ parity with the JAX linter --
@pytest.mark.parametrize("name", PARITY_FIXTURES)
def test_parity_with_jax_linter(name):
    """On the JAX package's fixtures whose rules read no registry and no
    JAX call name, both linters report the same (basename, line, rule)
    set: the port's generic rules (THR, LCK, BLK, TSI, EXC, KNB, SUP) are
    the JAX package's, unchanged."""
    from spgemm_tpu.analysis import lint_paths as jax_lint_paths

    path = os.path.join(JAX_FIXTURES, name)

    def key(findings):
        return {(os.path.basename(f.file), f.line, f.rule) for f in findings}

    ours = key(core.lint_paths([path], doc=False))
    theirs = key(jax_lint_paths([path], doc=False))
    assert ours and ours == theirs


# ----------------------------------------------- the cache beside the JAX one --
def test_cache_default_dir_is_not_the_jax_linters():
    """The port's default cache lives under build/ (git-ignored), not in
    the JAX linter's .lint_cache/: each linter's default-scope run prunes
    every entry outside its own scope, and each signature keys on its own
    package's bytes."""
    from spgemm_tpu.analysis import core as jax_core

    assert core.DEFAULT_CACHE_DIR == os.path.join("build", "lint_cache")
    assert os.path.normpath(core.DEFAULT_CACHE_DIR) != os.path.normpath(
        jax_core.DEFAULT_CACHE_DIR)
    assert os.path.normpath(core.DEFAULT_CACHE_DIR) != ".lint_cache"
    assert core.LintCache().directory == os.path.join(
        REPO, "build", "lint_cache")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert "build/" in ignored or "build" in ignored


def test_jax_default_scope_run_keeps_the_ports_cache(tmp_path, monkeypatch):
    """A JAX default-scope run (which prunes its cache to its own scope)
    leaves the port's cache entries in place: under one root, the two
    default directories are different files."""
    from spgemm_tpu.analysis import core as jax_core

    monkeypatch.setattr(core, "repo_root", lambda: str(tmp_path))
    ours = core.LintCache()
    assert ours.directory == os.path.join(str(tmp_path), "build",
                                          "lint_cache")
    ours.put("spgemm_tpu_torch/chain.py", "sha", [], set(), [])
    ours.save()
    jax_dir = os.path.join(str(tmp_path), jax_core.DEFAULT_CACHE_DIR)
    theirs = jax_core.LintCache(jax_dir)
    theirs.put("spgemm_tpu_torch/chain.py", "sha", [], set(), [])
    theirs.save()
    jax_core.lint_run(jax_core.default_paths(), doc=False,
                      cache=jax_core.LintCache(jax_dir))
    # the JAX run pruned the port's path from ITS cache...
    assert jax_core.LintCache(jax_dir).get("spgemm_tpu_torch/chain.py",
                                           "sha") is None
    # ...and the port's cache, beside it, still has the entry
    again = core.LintCache()
    assert again.get("spgemm_tpu_torch/chain.py", "sha") is not None
