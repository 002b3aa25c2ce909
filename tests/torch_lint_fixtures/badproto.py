"""PRO fixture (the port's registry): serve wire-contract discipline.

Seeded violations: undeclared request/response field literals (with and
without op context), an unknown op in a message literal, a hardcoded
protocol version, undeclared error codes at raise and compare sites, and
an undeclared protocol.E_* constant.  Legal shapes alongside: declared
fields for the op in play, the envelope fields, declared codes through
the E_* constants, and wire dicts bound to unconventional names (out of
PRO scope by design -- the rule audits the `msg`/`resp` convention).
NOT part of the package -- linted by tests/test_torch_lint.py only.
"""

from spgemm_tpu_torch.serve import protocol


def _op_status(msg):
    job = msg.get("id")  # legal: declared status request field
    flavor = msg.get("flavor")  # PRO: undeclared request field for status
    if job is None:
        return protocol.error(protocol.E_BAD_REQUEST, "no id")  # legal
    return protocol.ok(job=job, verbose=flavor)  # PRO: undeclared `verbose`


def build_submit(folder):
    # legal: declared submit fields + envelope
    good = {"op": "submit", "folder": folder, "options": {}}
    # PRO: undeclared request field `priority` for op submit
    bad = {"op": "submit", "folder": folder, "priority": 9}
    # PRO x2: unknown op + (independently) a hardcoded version stamp
    worse = {"op": "frobnicate", "v": 3}
    return good, bad, worse


def poll(resp):
    if not resp.get("ok"):  # legal: envelope field
        # PRO: undeclared error code at a raise site
        raise protocol.ProtocolError("went-sideways", "poll failed")
    state = resp["job"]  # legal: declared response field (status/wait)
    queue = resp.get("backlog")  # PRO: undeclared response field
    return state, queue


def classify(err):
    # PRO: undeclared error code on a code-flavored compare
    if err.get("code") == "transient-blip":
        return "retry"
    # legal: declared codes (literal and via tuple)
    if err.get("code") in ("queue-full", "tenant-cap"):
        return "backoff"
    return "fail"


def misspelled():
    return protocol.E_NOPE  # PRO: undeclared error-code constant


def legal_constants():
    return (protocol.E_UNKNOWN_JOB, protocol.E_SHUTTING_DOWN)


def out_of_scope(record):
    # legal: `record` is not a conventional wire-dict name, so its keys
    # are not auditable wire fields (and must not false-positive)
    return record.get("whatever"), record["anything"]


def _op_stats():
    # legal: the port's own stats fields, declared in its RESPONSE_FIELDS
    return protocol.ok(daemon="spgemmd", device={"type": "cuda"},
                       serve={"serve_reaps": 0})
