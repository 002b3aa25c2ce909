"""End-to-end metrics, one module a metric, named as in BENCHMARK.json.

Each module has read(window) -> float, taking the untraced run's
harness.Window (its seconds, the chains completed, each request's
latency, the set-up seconds, the device's peak of allocated bytes), all
measured by the harness on the host's clock or from the allocator."""
