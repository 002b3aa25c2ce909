"""spgemm-lint for the PyTorch/CUDA port: the package-level invariant
checker, aimed at torch idioms and the port's own registries.

The reference semantics (SURVEY.md section 2.9) make the wrap-then-mod u64
arithmetic non-associative, so fold order is a correctness invariant;
every engine knob must be read through the port's registry; no module may
make a CUDA context at import time (forked daemon, fleet and
--distributed children cannot re-initialise one); and the threaded
runtime (plan-ahead worker, OOC pipeline, spgemmd, the fleet router)
requires its lock and exception contracts to hold.  Reviewer memory does
not scale to those contracts -- this package checks them structurally,
with the rule ids, escape markers and report formats of the JAX
package's spgemm-lint:

  FLD  ordered-fold rule: unordered reductions (torch .sum() /
       dist.all_reduce / reduce_scatter / index_add_ / scatter_add_ /
       scatter_reduce_ / segment_reduce / functools.reduce) are findings
       inside the numeric modules (ops/u64, ops/spgemm, ops/mxu_spgemm,
       ops/estimate, ops/delta, parallel/ring, parallel/rowshard and the
       kernel wrappers ops/cuda_*) unless escaped with a reasoned
       fld-proof comment.  The INTERPROCEDURAL pass (callgraph.py): a
       numeric-module call into a non-numeric helper that transitively
       performs an unordered reduction is flagged at the call site,
       closing the "hide the index_add_ in utils/" hole.
  KNB  knob rule: every SPGEMM_TPU_* environment read must go through the
       central registry (spgemm_tpu_torch/utils/knobs.py); raw
       os.environ / os.getenv reads are findings.
  BKD  backend rule: no module-import-time torch.cuda.* call,
       torch.distributed.init_process_group or .cuda() outside
       utils/backend_probe.py (nor anywhere in an @host_only worker
       body).
  THR  lock rule (thrrules.py): an attribute annotated
       `# spgemm-lint: guarded-by(<lock>)` accessed outside a
       `with <lock>:` block is a finding (__init__, *_locked methods,
       Condition aliases exempt; escape: reasoned thr-ok comment).
  LCK  lock-order rule (lockrules.py): v3 builds an interprocedural
       lock-acquisition-order graph from `with <lock>:` nests over the
       call graph; a cycle (two paths acquiring registered locks in
       opposite orders) or a non-reentrant re-acquisition is a
       potential-deadlock finding with both witness chains (RLock is
       exempt from the self-edge but participates in cycles; escape:
       reasoned lck-ok comment).
  BLK  blocking-under-lock rule (lockrules.py): a blocking operation
       (sleep, subprocess, flock/fsync, socket accept/recv/sendall,
       Queue.get/put, Thread.join, Event/Condition.wait,
       torch.cuda.synchronize / .synchronize(), torch.distributed
       collectives and store waits) reached transitively while a
       registered lock
       is held is a finding with the witness chain down to the blocking
       call (escape: reasoned blk-ok comment, at the call site or at the
       blocking source).
  TSI  thread-shared inference (lockrules.py): functions passed to
       threading.Thread(target=...) are thread roots -- nested defs
       included (no inherited __init__ write exemption), and a root
       spawned in a loop or from >= 2 sites counts as two threads by
       itself; an instance attribute or module global written from
       >= 2 root-weighted threads without a guarded-by(<lock>)
       annotation is a finding -- THR's opt-in hole, closed (escape:
       reasoned tsi-ok comment).
  EXC  exception rule (excrules.py): a broad `except Exception` needs the
       `# noqa: BLE001 -- <reason>` justification; a bare `except:` /
       `except BaseException` must end its handler in `raise` (the
       JobAbandoned-must-pierce contract; escape: reasoned exc-ok).
  SUP  suppression audit: every escape comment is inventoried (--json),
       and one whose underlying finding no longer exists is itself a
       finding (like an unused noqa).
  DOC  drift rule: the generated tables in spgemm_tpu_torch/ARCHITECTURE.md
       (knobs, metrics, protocol, events, threads), the port CLI's help,
       and the analysis --help rule-id epilog must cover exactly what the
       registries generate.

Run `python -m spgemm_tpu_torch.analysis [--json] [--sarif F]` (`make
lint-torch`); the port self-lints in tier-1 (tests/test_torch_lint.py).
Everything is stdlib-only plus the port's registry modules: the linter
never imports torch, numpy or jax, so it runs on a host with no card.
"""

from spgemm_tpu_torch.analysis.core import (RULES, Finding, LintCache, Report,
                                      Suppression, is_numeric_module,
                                      lint_file, lint_paths, lint_report,
                                      lint_repo, lint_run, repo_root)
from spgemm_tpu_torch.analysis.docrules import (KNOB_TABLE_BEGIN, KNOB_TABLE_END,
                                          check_analysis_help,
                                          check_claude_md, check_cli_help)

__all__ = [
    "Finding", "LintCache", "Report", "Suppression", "RULES", "lint_file",
    "lint_paths", "lint_report", "lint_repo", "lint_run", "repo_root",
    "is_numeric_module", "check_analysis_help", "check_claude_md",
    "check_cli_help", "KNOB_TABLE_BEGIN", "KNOB_TABLE_END",
]
