"""plan_ms (layer planner): host milliseconds a chain in which the
dispatching (main) thread is held up by the planner: the union of its
ENGINE `plan` spans (ops/spgemm.plan run inline, as chain_products_batched
and a pass of one pair do; on a plan-cache hit the structure fingerprint
and the lookup) and `plan_wait` spans (waiting for the plan-ahead worker,
or wrapping an inline plan), clipped to the window.  An inline plan nests
inside its `plan_wait` and counts once; the worker's own `plan` spans run
beside the card on another thread and do not count."""

from portbench import devtrace

PHASES = ("plan", "plan_wait")


def read(rec) -> float | None:
    lo, hi = rec.window_ns
    spans = [s for s in rec.host_spans if s[0] in PHASES]
    if rec.chains == 0 or not spans:
        return None
    return devtrace.busy_ns(spans, lo, hi) / 1e6 / rec.chains
