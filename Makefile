# tpu-spgemm build + run targets.
#
# The reference's Makefile compiles nvcc+mpicxx into binary `a4` run as
# `mpirun -np P ./a4 <folder>`.  Here there is no compiler in the TPU loop
# (north star, BASELINE.json): `make run DEVICE=tpu FOLDER=<dir>` invokes the
# JAX entrypoint directly; `make native` builds the C++ I/O library.

PY      ?= python
DEVICE  ?= tpu
FOLDER  ?=
RANKS   ?= 1
BACKEND ?= xla
SHARD   ?= none
# memory mode: resident | stream (host partials) | outofcore (per-round staging)
MEM     ?= resident

MEMFLAG_resident  =
MEMFLAG_stream    = --stream
MEMFLAG_outofcore = --out-of-core
MEMFLAG = $(MEMFLAG_$(MEM))

NATIVE_SRC = spgemm_tpu/native/smmio.cpp spgemm_tpu/native/symbolic.cpp
NATIVE_SO  = spgemm_tpu/native/libsmmio.so

.PHONY: all native run test lint lint-fast lint-torch lint-torch-fast lint-sarif lint-cache-clean bench bench-large warm serve-smoke obs-smoke chaos-smoke chaos-smoke-torch fleet-smoke clean

all: native

native: $(NATIVE_SO)

$(NATIVE_SO): $(NATIVE_SRC)
	g++ -O3 -march=native -shared -fPIC -o $@ $(NATIVE_SRC)

# DEVICE=tpu runs on whatever TPU platform JAX sees (the default);
# DEVICE=cpu forces the CPU backend.
run:
ifeq ($(FOLDER),)
	$(error usage: make run FOLDER=<input dir> [DEVICE=tpu|cpu] [RANKS=P] [BACKEND=xla|pallas] [SHARD=none|keys|inner] [MEM=resident|stream|outofcore])
endif
ifeq ($(filter $(MEM),resident stream outofcore),)
	$(error unknown MEM='$(MEM)' (use resident, stream, or outofcore))
endif
ifeq ($(DEVICE),tpu)
	$(PY) -m spgemm_tpu.cli $(FOLDER) --backend $(BACKEND) --shard $(SHARD) --ranks $(RANKS) $(MEMFLAG)
else
	$(PY) -m spgemm_tpu.cli $(FOLDER) --device $(DEVICE) --backend $(BACKEND) --shard $(SHARD) --ranks $(RANKS) $(MEMFLAG)
endif

test:
	$(PY) -m pytest tests/ -x -q

# spgemm-lint: package-level invariant checker (FLD fold order incl. the
# interprocedural taint pass, KNB knob registry, BKD import-time backend
# touch, THR lock discipline, LCK lock-order deadlock detection, BLK
# blocking-under-lock, TSI thread-shared inference, EXC exception
# contracts, SUP stale suppressions, DOC doc drift); exit 1 on any
# finding.  Per-file results are content-hash cached under .lint_cache/
# (the linter is env-independent and jax-free, so a warm run re-runs only
# changed files with byte-identical output).
lint:
	$(PY) -m spgemm_tpu.analysis --json

# the inner-loop run: cached like `lint`, but skips the DOC drift checks
# (knob/metrics/thread-inventory table diffs + CLI help imports)
lint-fast:
	$(PY) -m spgemm_tpu.analysis --json --no-doc

# the PyTorch/CUDA port's own spgemm-lint (spgemm_tpu_torch/analysis/):
# the same rule ids and escapes, aimed at torch idioms and the port's
# registries, over spgemm_tpu_torch/ and chip_smoke.py, with the DOC
# tables in spgemm_tpu_torch/ARCHITECTURE.md; torch-free, cached under
# build/lint_cache/
lint-torch:
	$(PY) -m spgemm_tpu_torch.analysis --json

lint-torch-fast:
	$(PY) -m spgemm_tpu_torch.analysis --json --no-doc

# drop the content-hash cache (next run is fully cold)
lint-cache-clean:
	rm -rf .lint_cache

# same run as `lint`, plus a SARIF 2.1.0 log for CI / editor annotations
# (suppressed findings ride along as results with SARIF suppressions)
lint-sarif:
	$(PY) -m spgemm_tpu.analysis --json --sarif lint.sarif

bench:
	$(PY) bench.py

# spgemmd end-to-end proof on CPU: daemon up on a temp socket, two submits
# of the same input (second must hit the warm plan cache), then a third
# submit with a handful of mutated tiles (must take the delta-recompute
# path: 0 < delta_rows < total_rows in its status detail), all results
# bit-exact vs the oracle, clean shutdown; then a RESTART leg -- a second
# daemon on the same socket + warm dir re-serves the chain and its first
# contact must come from the persistent warm store (warm_hits >= 1, zero
# delta full fallbacks, a clean 0-row delta); then a CONCURRENCY leg -- a
# 2-slice pool daemon (SPGEMM_TPU_SERVE_SLICES=2) takes two same-cost
# jobs back-to-back, which must OVERLAP (second job's serve_queue_wait
# well under the first's serve_execute) on two different slices, both
# bit-exact; exits nonzero on any step.
serve-smoke:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) -m spgemm_tpu.serve.smoke

# observability end-to-end proof on CPU: daemon up, one submit, Prometheus
# `metrics` scrape (phase + plan-cache series must move, and the deep-
# profiling families -- compile accounting with nonzero cost, span-fed
# phase histograms, estimator/delta prediction accuracy, event-log
# counters -- must appear and move, plus the SLO quantile/error-ratio
# families), `cli profile --json` reports a compile record with nonzero
# FLOPs, `cli events --tail` returns the submit's lifecycle records,
# trace dumped and validated through the real `cli trace-dump`, clean
# shutdown; then the SLO burn leg -- an armed serve.executor wedge must
# flip spgemm_slo_burn_active, land an slo_burn event whose trace_id is
# the client-minted submit trace, and `cli trace-dump --merge` must
# stitch the client's ring dump + the daemon's dump into ONE Perfetto
# trace resolving that id to spans from both processes; exits nonzero
# on any step.
obs-smoke:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) -m spgemm_tpu.serve.obs_smoke

# chaos end-to-end proof on CPU: a seeded randomized failpoint schedule
# (SPGEMM_TPU_FAILPOINTS; utils/failpoints.py registry) against a live
# 2-slice daemon -- every job must end bit-exact vs the oracle or with a
# structured error, no hang past the watchdog window, one injected
# executor wedge must degrade the slice and the recovery loop
# (SPGEMM_TPU_SERVE_RECOVER_S) must reinstate it (recoveries >= 1), a
# torn journal tail (injected + a harness-appended half frame) must
# replay clean and counted on restart, and SIGTERM must drain and exit
# 0; exits nonzero on any step.
chaos-smoke:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) -m spgemm_tpu.serve.chaos_smoke

# the same chaos proof on the PyTorch/CUDA port (spgemm_tpu_torch): the
# one-card form on an NVIDIA GPU by default; TORCH_DEVICE=cpu runs a 2-slice
# pool of the port's daemon on the CPU
chaos-smoke-torch:
	$(PY) -m spgemm_tpu_torch.serve.chaos_smoke --device $(or $(TORCH_DEVICE),cuda)

# fleet end-to-end proof on CPU: two spgemmd backends each on a TCP
# front-end (SPGEMM_TPU_SERVE_ADDR / --addr) plus one spgemm-router
# (`cli route`) fronting both -- a mixed-tenant burst must spread across
# both backends bit-exact vs the oracle with every submit answer naming
# its backend, the aggregated scrape must carry the router's families
# AND every backend's series relabeled with backend=, one submit's
# client-minted trace must stitch via `cli trace-dump --merge` into ONE
# Perfetto file spanning client + router + backend, a SIGKILLed backend
# under load must leave every job completed-bit-exact (one-shot
# failover to the survivor) or structured backend-lost (never a hang)
# with later submits landing on the survivor, and SIGTERM must drain
# the router and the survivor to exit 0; exits nonzero on any step.
fleet-smoke:
	JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
		$(PY) -m spgemm_tpu.fleet.fleet_smoke

# the reference's Large scale (1M tiles) through the out-of-core pipeline
bench-large:
	$(PY) bench.py --preset large

# AOT-populate the persistent compile cache for the bench's round-shape
# ladder so a cold cache never contaminates (or zeroes) a timed run.
warm:
	$(PY) bench.py --warm

clean:
	rm -f $(NATIVE_SO)
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
