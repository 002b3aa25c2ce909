"""The port's observability layer (the JAX package's `obs/`): host-side, and
importing neither torch nor numpy, since the client CLI and the daemon's
watchdog read it.

  * obs/trace.py   -- the span flight recorder: every ENGINE phase enter
    and exit emits a span (monotonic ts, duration, parent, job and trace
    tags) into a bounded in-process ring, exported as Perfetto/Chrome
    trace_event JSON.  Spans are host time: a span around a launch or an
    upload closes when the work is queued on the card, not when it ends.
  * obs/metrics.py -- the metrics registry (the port's own ENGINE phase and
    counter names, and the scrape families) and the Prometheus text-format
    0.0.4 renderer behind spgemmd's `metrics` op.
  * obs/events.py  -- the structured event log: a bounded in-process ring
    and a rotating JSONL file next to the spgemmd journal, correlated with
    the recorder's job and trace tags.
  * obs/profile.py -- the profiling accounts: build records of the nvcc and
    g++ libraries, the device memory watermark (per job too), estimator and
    delta prediction accountability, per-phase latency histograms fed by
    the recorder; spgemmd's `profile` op.
  * obs/slo.py     -- the SLO engine: rolling per-(tenant, slice) windows of
    terminal jobs, latency quantiles, error ratio, queue-wait share and
    multi-window burn alerts that carry the bad job's trace id; spgemmd's
    `slo` op.
"""
