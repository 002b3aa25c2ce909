"""Per-layer metrics, one module a metric, named as in BENCHMARK.json.

Each module has read(record) -> float | None, taking the traced run's
record (harness.Record: chains completed, the window, ENGINE's phase and counter
deltas over the window, the device operations, the chain's Work) and
returning None where it finds nothing to read: the harness then leaves the
metric out of the result line."""
