"""EVT fixture (the port's registry): structured-event-kind discipline.

Seeded violations: an undeclared kind through the module alias, an
undeclared kind through the LOG singleton, and a computed (non-literal)
kind through the bare imported emit.  Legal shapes alongside: declared
kinds through each receiver spelling, and a locally-defined emit helper
(not the obs/events log, so out of EVT scope by design).
NOT part of the package -- linted by tests/test_torch_lint.py only.
"""

from spgemm_tpu_torch.obs import events as obs_events
from spgemm_tpu_torch.obs.events import LOG, emit


def bad_module_alias(job_id):
    # EVT: undeclared kind via the module alias
    obs_events.emit("job_vanished", job=job_id)


def bad_log_singleton():
    # EVT: undeclared kind via the LOG singleton
    LOG.emit("daemon_hiccup")


def bad_dynamic(kind):
    emit(kind, detail="x")  # EVT: computed kind via the bare import


def legal_declared(job_id):
    obs_events.emit("job_submit", job=job_id)  # legal: declared kind
    LOG.emit("watchdog_reap", job=job_id)  # legal: declared kind
    emit("router_failover", job=job_id)  # legal: declared kind


def legal_local_helper():
    def local_emit(kind):  # legal: not the obs/events log
        return kind

    return local_emit("anything_goes")
