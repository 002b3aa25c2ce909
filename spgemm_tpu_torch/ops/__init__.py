"""Device-side engine: u64 helpers, planner, device matrix, kernels."""
