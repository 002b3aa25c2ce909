"""Device-side engine: u64 helpers, planner, device matrix, kernels."""

# the multiply backends (torch-free here, so the CLI's parser can name them
# without importing the engine)
BACKENDS = ("exact", "mxu", "hybrid")
