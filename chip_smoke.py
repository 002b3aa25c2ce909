#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spgemm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one line with its wall time; any failure raises and
the script exits non-zero without printing a result:

  1. device  -- the card, and `nvidia-smi --query-gpu=name,power.limit`;
  2. build   -- every kernel in spgemm_tpu_torch/csrc, built with nvcc;
  3. kernel  -- each kernel against its plain PyTorch version on the card,
               exact equality: kernel 1 in both variants (EDGE values,
               sentinel padding, an empty round, stacked rounds, hub
               fanouts; k in 1, 2, 4, 8, 32, 64; then rounds heavy with
               sentinel slots at k in 1..128 and P up to 384: all-pad keys,
               one-sided sentinels, sentinels between real slots, a last
               tile that is not zero, K = 0 and P = 0) and the limb kernel
               on the same shapes at 10x10 limbs on EDGE values, 3x3 and
               1x1 limbs on values below 2^16, on the same sentinel-heavy
               rounds at 10x10, over the limb grid (a_limbs 1..10 against
               b_limbs 1, 5, 10 and the mirror, k 1, 8, 32, values at the top
               of each range), at P*k = 2^17 with nearly all bytes 255 (the
               fragments' flush), at ragged k (3, 31, 33, 64, 128) and on
               slabs 8 bytes off a 16-byte boundary, plus a P*k > 2^17 round
               that must raise; kernel 1 (both variants) and the limb kernel
               on three jobs' round stacked as execute_batched stacks it
               (symbolic.stack_round_indices, sentinels in every job's copy,
               one shared zero tile), each job's rows equal to its solo
               round;
               the two bsmm kernels against bsmm_ref in float32 and bfloat16
               (k in 16, 32, 128, a ragged W2 fan-in with pad tiles, gelu
               fused and not), equal to each other and across block_m and
               the streaming kernel's row tile (16, 32, 64, 128), and
               two shapes that must raise (a resident panel that does not
               fit, k = 8); and the field-mode kernels of inner and ring
               sharding (csrc/field_fold.cu, F1 and F3 on kernel 2's body):
               F1 in its full (8 x 8 bytes) and SMALL (4 x 4) instances, F3
               and F2 on EDGE values, k 1..64 with 31 and 33, sentinel-heavy
               lists, keys and cells of sentinel slots only, P = 0, K = 0, a
               key of P*k > 2^17, F3 cells of 1 to 300 pairs with every other
               accumulator row left as it was, and sums of 2^64 - 1 (read 0);
  4. cli     -- `python -m spgemm_tpu_torch.cli` on the golden inputs, byte
               equality with the expected files, one small multiply against
               the numpy oracle, and a small-valued chain under each
               --backend: hybrid byte-equal to exact, mxu equal to the
               field-mode oracle;
  5. medium  -- the reference report's Medium chain (N=10 banded block-sparse
               matrices, block_dim 1111, bandwidth 4, k=32, ~100k tiles) from
               a fixed seed: the exact path once with the launch counts zeroed
               before and read after, then timed runs of the kernel and of
               the plain version on the card, whose results must be equal;
               the share of real pairs among the rounds' pair slots, kernel
               1's registers and spills (ptxas) and its blocks per SM, and
               kernel 2's at 8x8 and 3x3 byte limbs; then the host half:
               `[medium] host planning` (the planner with the native join
               and with SPGEMM_TPU_NO_NATIVE=1, plans identical),
               `[medium] plan-ahead` (the chain's wall at
               SPGEMM_TPU_PLAN_AHEAD 0 and 2 in turns, medians of 3, results
               equal, ENGINE's plan / plan_wait / upload split, the pinned
               host memory statistics, and the stream synchronizations inside
               execute over one chain, which must be 0), `[medium-cli]` (the
               chain written as text by the native writer, `python -m
               spgemm_tpu_torch.cli <dir> -v` with the default loader
               threads (the --threads 1 run was cut to make room for
               [rowshard] and [chaos]), its ./matrix read back equal to the
               in-memory result after prune_zeros; then, cut in depth to Medium's first 3
               matrices (links to the same files), natively and with
               SPGEMM_TPU_NO_NATIVE=1, the two ./matrix files byte-equal;
               about 4 GB under TMPDIR, deleted after) and `[medium] parity
               fold` (kernel 1's
               output of every level-1 multiply against the native u64 fold,
               every key, 0 bad keys).  The main path's line reports the plan
               cache's hits and misses from an empty cache; the planner's
               timings above run with SPGEMM_TPU_PLAN_CACHE=0, so they time
               the planner, not lookups.  `[medium] plan cache` (walls,
               ENGINE plan and plan_wait, hits and misses with the cache off
               and empty, in turns, then warm; then the same off/empty
               walls on a chain of distinct structures, input i's band
               shifted i blocks, where 0 hits are required, and the
               fingerprints' and freezing's host time), `[medium] device busy share`
               (a torch.profiler trace of one chain: the union of the kernels'
               intervals over the chain's host range, empty and warm cache),
               `[medium-ooc]` (spgemm_outofcore chained over the host
               matrices at SPGEMM_TPU_OOC_DEPTH 1, 2 and 4: wall, peak device
               memory against the resident path's, rounds, bytes uploaded,
               ENGINE stage_prep / dispatch / assembly; bytes equal to the
               resident result) and, in `[medium-cli]`, `--ranks 8`: time
               taken, the tiles that differ from P = 1, ./matrix equal to
               chain_product_partitioned(mats, 8, multiply=spgemm_outofcore)
               in memory;
               every phase so far runs with SPGEMM_TPU_DELTA=0 (and the
               estimator off, the port's default); then, on the Medium chain of distinct
               structures, `[delta]` (four submits from host leaves with delta on
               in one process: first contact, unchanged, 11 contiguous tile rows
               of M5 given new values, 11 rows spread evenly; each equal to the
               delta-off chain, whose walls are printed beside; rows recomputed
               per level, ENGINE delta_diff / delta_splice / plan, the splice's
               CUDA-event ms, the bytes the store retains; the row digests of the
               leaves alone on one thread and on the pool, in pairs of alternating
               order, with the pairs each won; the splice kernel
               against splice_ref on the splices of the two edited submits, timed
               beside the plain version and index_copy_ on a clone; the Medium
               chain of one structure twice: the hits its shared keys allow),
               `[warm]` (this script as two subprocesses, `--warm-child first`
               and `second`, on one SPGEMM_TPU_WARM_DIR: the second must find
               every plan and delta entry, recompute no row and give the first's
               bytes), `[estimate]` (the estimator on and off from an empty
               plan cache, in turns; the bytes equal) and `[dense]`, the dense
               accumulator route (SPGEMM_TPU_ACCUM_ROUTE; every earlier phase
               runs at its default, auto): (a) the segmented fold against its
               plain version at k 1, 2, 8, 32, 64 on contiguous and cycling
               seg with sentinel and pad slots, an all-pad stream and n_rows
               0, and on the twin rounds of (c) and (d) against kernel 1;
               (b) the Medium chain with the route forced to dense, equal to
               the ladder chain, the fold timed beside kernel 1 and its plain
               version, and Medium's auto plans equal to its ladder plans (no
               twin); (c) the hub multiply of 6 (e) under exact and hybrid x
               ladder, dense, auto with a fresh gate cache: the same bytes,
               the gate's choice and its measurements, kernel 1 mod, no_mod
               and the fold timed on the round; (d) the co-citation product
               A x A^T of powerlaw_block_sparse(4096, 32, 8.0): its fanout
               classes, its rounds with a twin (at least one), the gate's
               choices, and the auto and ladder walls with warm plans and
               gate, medians of 5 in turns, the bytes equal; then `[serve]`,
               the port's daemon (`python -m spgemm_tpu_torch.cli serve`, no
               --device: the card; delta on, its warm directory next to its
               socket) driven with serve/client over text directories of the
               Medium chain and of the chain of distinct structures: (a)
               Medium cold, (b) Medium again (every plan a hit), (c0) the
               chain of distinct structures, (c) the same with 11 tile rows of
               M5 given new values (delta rows below the total, the splice
               launched), (d) a restarted daemon on the same warm directory,
               Medium again (warm hits), run after (e) on that second
               daemon, which has serve.heartbeat armed to hang once and a 2 s
               job deadline, 1 s wedge grace and 1 s re-probe: (e) a small
               chain's job reaped, the slice degraded (one stderr line), the
               probe after it `ok`, the slice reinstated at once and the
               canary job on the card with the oracle's bytes, no job on the
               host oracle; (a), (c0) and (c) read back with the native
               parser and equal to the in-memory engine's, (b) and (d) equal
               to (a)'s bytes, each job
               of (a)-(d) with kernel 1 launched on the card (its own
               counters, from its PhaseScope in the daemon) and not
               degraded; the submit walls, each job's phases_s and counters,
               and the warm flush after each job, beside the CLI's time
               taken from [medium-cli]; then cross-job batching, each leg a
               main path with the counts zeroed before and read after, delta
               off, warm plans, in turns solo, batched, batched, solo: (f)
               the Medium chain with four value sets (seeds 20260..20263)
               as one lockstep batched chain (chain_products_batched)
               against four solo chains, (g) the same for eight chains of
               one small banded structure (block_dim 32), each with kernel-1
               launches, kernel-1 ms by CUDA events, walls and the share of
               the card's resident kernel-1 blocks a launch fills, 0
               differing bits per job; (h) a daemon in this process on the
               card over four text directories of (g)'s structure: each
               submitted once (solo, its structure recorded), then all four
               back to back with a 0.5 s window, K 8 and delta off: one
               shared batch id, serve_batches up by 1, every member's
               phases_s and kernel-1 launches, each output byte-equal to its
               first contact's; and `[obs]` on the same daemons (obs/): after
               (a) and (b) the `metrics` scrape (every family parses,
               spgemmd_jobs_terminal_total{outcome="done"} 2, the
               launches_numeric_round counter grown by the two jobs' kernel-1
               launches), the `trace` op ((a)'s job id on spans that nest
               upload and numeric_dispatch under its serve_execute, its plan
               spans inside it) and the `events` op (job_submit, job_start,
               job_done for each job), then `cli trace-dump` twice (the
               daemon's ring, then --merge of it with this process's own
               dump, filtered by (a)'s trace id), `cli profile --json` (a
               build record for numeric_round and native, with built and a
               wall), spgemm_phase_seconds_count{phase="plan"} grown by (a)'s
               and (b)'s plan spans, spgemm_hbm_peak_bytes and (a)'s detail
               hbm_peak_bytes between the resident Medium inputs (817 MB) and
               the card's memory, and `cli slo --json` (the tenant's 2 jobs,
               error ratio 0, p50, p95, p99); after (c) and after (d) the
               delta accountability (spgemm_delta_dirty_fraction_count grown
               by the daemon's delta multiplies, 0 mispredictions); after (e),
               on the second daemon started with SLO objectives, the events
               watchdog_reap, watchdog_wedge, daemon_degrade and
               slice_recovered, the flight dumps in <socket>.flight/ (the
               reaped job's holds its spans), spgemm_slo_burn_active{tenant,
               slice} at 1 and one slo_burn event carrying the trace id the
               client minted for the reaped job; after (h) the
               spgemm_serve_batch_size histogram with the batch of 4, the
               tenant's SLO jobs grown by the 4 members, and one `metrics` and
               one `trace` op timed against this process's ring; last the
               warm Medium chain in this process with SPGEMM_TPU_OBS_TRACE 1
               and 0 in turns (on, off, off, on, four times), its spans per
               chain counted; `[estimate]` also holds obs/profile's estimator
               count to the estimated plans that landed; then `[tune]`, the
               autotuner (tune/) in a daemon on the card with a private warm
               directory, SPGEMM_TPU_TUNE=1, SPGEMM_TPU_TUNE_TRIAL_S=0.5 and
               SPGEMM_TPU_TUNE_MIN_WIN=1 (so that the promotion path runs;
               what the default 1.1 decides on the same walls is printed):
               (t1) Medium twice (the second job's class registered), then
               idle until the class leaves trialing: each leg's vector, wall,
               plan seconds, kernel-1 and dense-fold launches and its digest,
               which must equal the in-memory result's, the ladder leg
               launching kernel 1 and the dense leg the fold; (t2) if a
               vector was promoted, Medium as the tuned canary (half its
               deadline, the golden bytes, one tune_canary_passed, the class
               live); (t3) the chain of distinct structures twice (a new
               class), and Medium submitted while its first leg runs: the
               tune_trial_preempted event and Medium's serve_queue_wait;
               (t4) a second daemon on the same warm directory: the persisted
               records adopted, `cli tune --status --json` and `cli knobs
               --json`, and Medium twice, the second under the adopted
               vector (SPGEMM_TPU_TUNE=0's inert daemon is held by the CPU
               tests, tests/test_torch_tune.py); then `[fleet]`, the fleet
               layer (fleet/) on the card, in the same temporary directory:
               two of the port's daemons started at once, each its own
               process, CUDA context, socket, TCP port (`serve --addr`) and
               SPGEMM_TPU_WARM_DIR, with SPGEMM_TPU_DELTA=0 and
               SPGEMM_TPU_TUNE=0, behind one `cli route` subprocess polling
               every 0.5 s: (f1) both up, waited for on the router's `stats`
               backends block, the daemons' start times and the time until
               the router marks both healthy; (f2) [serve]'s Medium text
               directory through the router twice from one tenant: each
               result byte-equal to (a)'s golden file, each answer naming its
               backend, each job's detail with the main path's kernel-1
               launches (74), the book merged by a poll (merged > 0,
               book_entries >= 1) and the second submit placed by price
               (book_hits + 1; which branch of the placement, Medium's mass
               against LARGE_MASS_PAIRS), each wall beside [serve]'s direct
               (a) and (b), the router's router_submit spans; (f3) [serve]
               (g)'s eight small chains from two tenants, each result equal
               to the in-memory engine's, both backends serving; (f4) one
               scrape through the router (its four spgemm_router_* families,
               each backend's series under backend=) and `cli trace-dump
               --merge` over this process's ring, the router's dump and the
               serving backend's, which must resolve (f2)'s client-minted
               trace id to spans of all three processes (client_submit,
               router_submit, serve_execute); (f5) Medium and four small
               chains submitted, their waits started, and once Medium's
               status says running, the backend holding it SIGKILLed: every
               job ends with its bytes exact or with the structured
               backend-lost, Medium re-submitted once to the survivor
               (spgemm_router_failovers_total >= 1, a router_failover event
               with outcome resubmitted), no wait past its deadline; the time
               from the kill to Medium's done; a later submit lands on the
               survivor; (f6) SIGTERM to the router and the survivor, both
               exit 0; kernel 1's row in the kernels line gains
               `fleet_launches`, the launches the phase's jobs report; then
               `[chaos]`, serve/chaos_smoke.py --device cuda (one slice on
               the card, a seeded failpoint schedule with the executor wedge
               and a torn journal record always armed, 3 jobs with a 30 s
               deadline) over [serve]'s Medium and distinct-structure
               directories, and at the same time its CPU form (a pool of 2
               slices), each exiting 0 with its OK line: every job bit-exact
               or failed with a structured error, the wedged slice
               reinstated, the torn journal counted by a second daemon,
               SIGTERM drained; beside it [serve]'s pool rows (width 1,
               steals 0); then `[rowshard]`, the Medium chain from its host
               leaves through parallel/rowshard.spgemm_sharded over [cuda:0]
               * 1, 2 and 4, each a main path byte-equal to the main path's
               result, kernel 1 launched once a shard of a round (n times the
               main path's launches), its wall beside the main path's in this
               call, kernel 1's ms by CUDA events in the same run, the
               rounds a multiply, and the wall split into plan, upload,
               dispatch, assembly and the rest beside the plan cache's hits
               and misses; `--shard keys` once through the CLI on
               golden_chain; kernel 1's row gains `rowshard_launches`;
               then `[inner-ring]`: the Medium chain from its host leaves
               through parallel/innershard.spgemm_inner and
               parallel/ring.spgemm_ring over [cuda:0] * 1, 2 and 4 (the ring
               with SPGEMM_TPU_RING_OVERLAP 1, and 0 at 4), each a main path
               launching F1 (and F2 at n > 1) or F3 (at most n^2 a
               multiply) and no other kernel, every result byte-equal to the
               mxu backend's chain on the same leaves (kernel 2 timed by CUDA
               events there, the yardstick of F1 and F3), with walls, ENGINE
               splits, launches and CUDA-event ms; F1 and F3 bound by their
               int8 byte products on the tensor cores, as kernel 2 is;
               the plain versions against the kernels on Medium's first 3
               matrices at 2 positions, timed; the webbase-ring pair
               (benchmarks/run.py's powerlaw_block_sparse(256, 32, 3.0),
               seed 3) through the ring at 4 positions equal to the exact
               path, with its deep-tail cells; chain_product_on_devices at
               P = 8 on [cuda:0] equal to [medium-cli]'s --ranks 8;
  6. medium-small -- the same chain with values below 2^16, where the hybrid
               router's proof holds on every level-1 multiply: (a) exact once,
               the reference bytes; (b) hybrid under the proof gate and
               (c) under the measured gate with a fresh crossover cache, both
               byte-equal to (a); (d) mxu over the whole chain against the
               limb kernel's plain version; (e) a hub multiply whose proven
               round is too deep for the limb kernel, on the no_mod fold (the
               ladder route: under auto its dense twin would take the round).
               Each run is a main path with the counts zeroed before and read
               after.  Kernel 2's bound counts byte-limb MACs (bytes_for_limbs7
               of each operand's limbs per u64 MAC); the 7-bit count is printed
               beside it.  Out-of-core hybrid (gate proof) over the host
               matrices must give (a)'s bytes and launch the limb kernel.
               Then the three kernels timed on the same level-1 rounds, the
               numbers the speed gate weighs;
  7. cli-modes -- on a small chain: --checkpoint-dir resuming after a
               failure injected after pass 1, run with --profile, whose
               trace must hold kernel 1's launches, and failover=True with a
               failing fold injected through Folds: with the real probe,
               which finds the card working, the error must be raised; with
               the probe standing in for a lost card, one stderr line and
               the oracle's bytes;
  8. ffn     -- the block-sparse FFN forward at full width
               (BlockSparseFFNConfig(), x (8, 1024, 4096) bf16, weights from
               init_params on a generator seeded with SEED): first the launch
               geometry of kernels 3 and 4 on each matmul (kernel 3's row
               tile, kernel 4's column chunks), kernel 4's ring and
               clusters, kernel 3's consumer tile, ring, shared memory,
               blocks an SM and persistent grid, both kernels' ptxas
               figures; then
               (i) block_m 128, (ii) the same with gelu fused, (iii) block_m
               16 with the resident gate deciding, (iv) x (1, 256, 4096) at
               block_m 16, each a main path with the bsmm counts zeroed
               before and read after, each against the plain ffn_forward in
               float32, (i) bit-equal to (iii) and (iv) to block_m 128 on its
               x; then each kernel per matmul (full width and M = 256), each
               forward, the plain versions and the dense x @ W product
               timed, kernel 4 bit-equal to kernel 3 on matmul 1 and kernel
               3 on matmul 2 bit-equal across the row tiles 16 to 128;
               kernel 3's variants on both matmuls timed (each ring depth,
               mma.sync warps in place of wgmma's warpgroups, row tile 64,
               one block an item, the pair
               stream alone with and without the epilogue), each but the
               streams bit-equal to the default;
  9. ffn-train -- the FFN training step at the same width (x and a target
               (8, 1024, 4096) bf16 from SEED + 2, lr 1e-3): first the plain
               autograd step in bf16 against float32, the basis of the
               limits (FFN_TRAIN_LOSS_RTOL, FFN_TRAIN_GRAD_TOL); then three
               steps at block_m 128 and one at block_m 16 through
               make_sharded_train_step on a 1 x 1 mesh, each a main path
               with the counts zeroed before and read after (forward 2 and
               dgrad 1 on kernels 3 and 4 as the resident gate picks, kernel
               5 twice), each step's loss and gradients against the plain
               step's within the limits; the step's forward bit-equal to
               ffn_forward_kernels'; then the dgrad (kernel 3 at block_m
               128, kernel 4 at 16, bit-equal; kernel 3's gelu_grad
               instance's layout, grid and ptxas, and its variants timed as
               in ffn) and kernel 5 (dW1, dW2)
               against their plain versions, timed beside them, torch.bmm
               of the gathered strips and torch.matmul of dy by the dense
               W2^T, and the whole step against the plain one.
               `python3 chip_smoke.py --only ffn-train` (or `--only ffn`)
               runs the device and build phases and that phase alone (no
               result line).

Then one JSON line describing every ported kernel (kernel 5 and the dgrad
after kernels 3 and 4, the splice and the dense fold, then F1, F2 and F3 of
csrc/field_fold.cu last) and, last, the
device line `{"ok": true, "device": {...}}`.  The rows known so far are also
printed as `[kernels so far]` lines after the Medium, dense, medium-small
and ffn phases and written to build/chip_smoke_kernels.json, so that a cut
output tail loses no row.  Imports torch, numpy and the port only.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import logging
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

from spgemm_tpu_torch.chain import chain_product, chain_products_batched
from spgemm_tpu_torch.models import ffn
from spgemm_tpu_torch.obs import profile as obs_profile
from spgemm_tpu_torch.ops import _build, crossover, cuda_bsmm, cuda_dense, cuda_mxu, cuda_splice
from spgemm_tpu_torch.ops import cuda_bsmm_grad, cuda_field, cuda_spgemm, u64
from spgemm_tpu_torch.ops import delta, estimate, mxu_spgemm, plancache, symbolic, warmstore
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import Folds, plan, spgemm, spgemm_device, spgemm_outofcore
from spgemm_tpu_torch.parallel.chainpart import chain_product_partitioned
from spgemm_tpu_torch.parallel.mesh import train_mesh
from spgemm_tpu_torch.utils import backend_probe, io_text, native
from spgemm_tpu_torch.utils.blockcsr import BlockSparseMatrix
from spgemm_tpu_torch.utils.gen import (banded_block_sparse, powerlaw_block_sparse,
                                        random_block_sparse, random_chain, random_values)
from spgemm_tpu_torch.utils.semantics import chain_oracle, field_spgemm_oracle, spgemm_oracle
from spgemm_tpu_torch.utils.timers import ENGINE

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
SEED = 20260
MAX = (1 << 64) - 1
# the SURVEY.md section 2.9 trigger set: products and sums straddling 2^32/2^64
EDGE = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1,
        (1 << 63) - 1, 1 << 63, MAX - 2, MAX - 1, MAX]
# Medium scale of the reference report (bench.py's default workload)
MEDIUM = {"n": 10, "block_dim": 1111, "bandwidth": 4, "k": 32}
KERNEL_REPEATS = 3  # timed kernel runs; the median is reported
HUB_FANOUT = 4500   # > 2^17 / 32: the round's class is too deep for the limb kernel
# bsmm cases (k, M, nb_in, nbc, rpc, block_m); kernel 4 runs each where its
# panel fits and must raise where it does not (the last: 128 panels over
# uneven column chunks, and kernel 3 at a row tile of 64)
BSMM_CASES = [(16, 96, 8, 6, 3, 32), (32, 128, 6, 5, 4, 64), (128, 256, 8, 4, 3, 16),
              (128, 64, 32, 7, 3, 16), (64, 2048, 8, 5, 3, 16)]
# bsmm against bsmm_ref, (rtol, atol): both sum the same products in float32
# in another order; bfloat16 then rounds once, so one bf16 ulp (2^-7 relative)
BSMM_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2 ** -7, 1e-4)}
# The FFN at full width: BlockSparseFFNConfig() and M = 8 x 1024 tokens
# (benchmarks/ffn_sweep.py:98-100).  The kernel forward against the plain
# forward in float32, (rtol, atol): the kernel path rounds h to bfloat16
# (twice when gelu is not fused) and y once, 2^-9 relative each.  The same
# arithmetic on the CPU (bsmm_ref in bfloat16) at this width with 512 tokens
# gave an error of standard deviation 1.9e-3 and at most 1.33e-2 against y
# of standard deviation 0.63; atol 2^-5 with rtol 2^-7 leaves a margin of
# about 2 over that maximum.
FFN_CFG = ffn.BlockSparseFFNConfig()
FFN_BATCH, FFN_SEQ = 8, 1024
FFN_SMALL_SEQ = 256   # run (iv): one sequence of 256 tokens, the small-M shape
FFN_TOL = (2 ** -7, 2 ** -5)
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor cores
# [ffn-train]: the training step at the same width on x and a target
# (8, 1024, 4096) bf16 from SEED + 2, SGD at the JAX step's default lr;
# FFN_TRAIN_STEPS steps at block_m 128 (every matmul on kernel 3), then one
# at block_m 16 (the resident gate takes kernel 4 for matmul 1 and the dgrad)
FFN_TRAIN_STEPS = 3
FFN_TRAIN_LR = 1e-3
# The kernel step against the plain autograd step, both in bf16: the loss
# within FFN_TRAIN_LOSS_RTOL, each weight gradient within
# FFN_TRAIN_GRAD_TOL times the plain gradient's largest |entry| (max abs
# error).  Set from the plain step in bf16 against the plain step in
# float32 on these inputs, which every run prints first: on an NVIDIA H100
# 80GB HBM3 (700.00 W) the loss 6.5e-5 apart (relative), dW1 3.3e-3 and dW2
# 3.0e-3 of their largest entry.  Two bf16 steps may sit on opposite sides
# of float32, so twice that; a margin of two over it, rounded up to a power
# of two: 4 x 6.5e-5 -> 2^-11, 4 x 3.3e-3 -> 2^-6.
FFN_TRAIN_LOSS_RTOL = 2 ** -11
FFN_TRAIN_GRAD_TOL = 2 ** -6
# a bf16 kernel of the step against its plain version on the same inputs:
# |got - want| <= rtol |want| + atol_frac max |want| (the gradients' values
# are ~1e-6, so an absolute floor must scale with them); both sum the same
# products in float32 in another order and round once to bf16
GRAD_KERNEL_TOL = (2 ** -7, 2 ** -10)
L2_BYTES = 50 << 20

# H100 SXM peaks (NVIDIA data sheet).  The fp32 rate, 67e12 FLOP/s, is
# 2 flops x 128 fp32 lanes per SM per clock; an SM issues 64 32-bit integer
# add/compare/select results per clock, a quarter of that, and 64 IMADs.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
INT8_TENSOR_OPS_PER_S = 1979e12  # dense int8 tensor cores, 2 ops per MAC
# Integer-pipe instructions per u64 MAC in csrc/numeric_round.cu's sm_90a
# SASS (mod variant): ISETP, ISETP.EX, SEL, SEL for each of the two
# compare-with-all-ones steps, and IADD3 for the low half of the add.  The
# multiply-low (three IMADs and an IMAD.IADD) and the add's carry (IMAD.X)
# issue on the FMA pipe beside them, so the integer pipe is the bound.
INT_OPS_PER_MAC = 9
# FMA-pipe instructions per u64 MAC of the no_mod variant's SASS: IMAD and
# IMAD for the cross products, IMAD.WIDE.U32 for the low product with the
# accumulator added in.  The integer pipe keeps one IADD3 (the high word's
# sum), so the FMA pipe, at the same 64 per SM per clock, is the bound.
FMA_OPS_PER_MAC_NO_MOD = 3


def _phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.3f} s)", flush=True)


def _u64_max_abs_err(x: torch.Tensor, y: torch.Tensor) -> int:
    """max |x - y| over int64 bit-views read as uint64."""
    if x.shape != y.shape:
        raise RuntimeError(f"shape mismatch {tuple(x.shape)} vs {tuple(y.shape)}")
    if x.numel() == 0:
        return 0
    flip = torch.iinfo(torch.int64).min  # xor with the sign bit orders as unsigned
    x_ge_y = (x ^ flip) >= (y ^ flip)
    d = torch.where(x_ge_y, x - y, y - x)  # wrapping: the unsigned difference
    return (int((d ^ flip).max().item()) & MAX) ^ (1 << 63)


def _edge_values(rng: np.random.Generator, shape) -> np.ndarray:
    """Half EDGE values, half uniform uint64."""
    edge = np.array(EDGE, np.uint64)[rng.integers(0, len(EDGE), size=shape)]
    full = rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    return np.where(rng.random(shape) < 0.5, edge, full)


def _round_case(rng, k: int, n_tiles: int, K: int, P: int, stack: int = 0,
                small: bool = False):
    """Random slabs (sentinel zero tile last) and sentinel-padded pair
    indices on the card: (a, b, pa, pb).  small: values below 2^16."""
    dev = torch.device(DEVICE)
    slabs = []
    for _ in range(2):
        shape = (n_tiles + 1, k, k)
        tiles = rng.integers(0, 1 << 16, size=shape, dtype=np.uint64) if small \
            else _edge_values(rng, shape)
        tiles[-1] = 0
        slabs.append(torch.from_numpy(tiles.view(np.int64)).to(dev))
    lead = (stack, K) if stack else (K,)
    pa = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    pb = rng.integers(0, n_tiles, size=(*lead, P)).astype(np.int32)
    real = rng.integers(0, P + 1, size=lead)  # each key's real fanout
    pad = np.arange(P) >= real[..., None]
    pa[pad] = n_tiles
    pb[pad] = n_tiles
    return (slabs[0], slabs[1], torch.from_numpy(pa).to(dev),
            torch.from_numpy(pb).to(dev))


def _sentinel_round(rng, k: int, K: int, P: int, pattern: str, n_tiles: int = 30):
    """A round whose sentinel slots are laid out by `pattern`: "pad_keys"
    (every third key all sentinel), "one_sided" (pa or pb alone a sentinel),
    "between" (both, between real slots), "dirty" (the same with a last
    tile that is not zero, which kernel 1 must skip as its plain version
    does)."""
    a, b, pa, pb = _round_case(rng, k, n_tiles, K, P)
    pa = torch.from_numpy(rng.integers(0, n_tiles, size=(K, P)).astype(np.int32)).to(DEVICE)
    pb = torch.from_numpy(rng.integers(0, n_tiles, size=(K, P)).astype(np.int32)).to(DEVICE)
    hole = torch.from_numpy(rng.random((K, P)) < 0.4).to(DEVICE)
    if pattern == "pad_keys":
        pa[::3] = n_tiles
        pb[::3] = n_tiles
    elif pattern == "one_sided":
        pa[hole] = n_tiles
        pb[~hole & torch.from_numpy(rng.random((K, P)) < 0.4).to(DEVICE)] = n_tiles
    else:
        pa[hole] = n_tiles
        pb[hole] = n_tiles
    if pattern == "dirty":
        a[-1] = a[0]
        b[-1] = b[1]
    return a, b, pa, pb


def _jobs_stacked_case(rng, k: int = 32, n_tiles: int = 40, K: int = 37, P: int = 6,
                       jobs: int = 3) -> dict:
    """A round stacked for `jobs` jobs as ops/spgemm.execute_batched stacks
    it: the jobs' slabs concatenated tiles only with one shared zero tile
    last, the indices by symbolic.stack_round_indices, sentinel slots
    (padded keys and one-sided ones) in every job's copy.  Kernel 1 (both
    variants) against numeric_round_ref and kernel 2 (10x10 limbs) against
    numeric_round_mxu_ref, bit for bit on the card, and each job's rows
    against its own solo round; returns the max abs error by kernel."""
    dev = torch.device(DEVICE)
    slabs = []
    for _ in range(2):
        side = []
        for _ in range(jobs):
            tiles = _edge_values(rng, (n_tiles + 1, k, k))
            tiles[-1] = 0
            side.append(torch.from_numpy(tiles.view(np.int64)).to(dev))
        slabs.append(side)
    idx = []
    for _ in range(2):
        x = rng.integers(0, n_tiles, size=(K, P)).astype(np.int32)
        x[np.arange(P) >= rng.integers(0, P + 1, size=K)[:, None]] = n_tiles
        x[rng.random((K, P)) < 0.2] = n_tiles
        idx.append(x)
    a, b = (torch.cat([t[:n_tiles] for t in side] + [side[0][n_tiles:]]) for side in slabs)
    spa, spb = (torch.from_numpy(symbolic.stack_round_indices(x, n_tiles, jobs)).to(dev)
                for x in idx)
    pa, pb = (torch.from_numpy(x).to(dev) for x in idx)
    worst = {}
    for name, no_mod in (("mod", False), ("no_mod", True)):
        got = cuda_spgemm.numeric_round(a, b, spa, spb, no_mod=no_mod)
        worst[name] = _check_equal(f"numeric_round {name} on {jobs} jobs' stacked indices", got,
                                   cuda_spgemm.numeric_round_ref(a, b, spa, spb, no_mod=no_mod))
        for j in range(jobs):
            _check_equal(f"numeric_round {name}, job {j}'s rows of the stacked launch", got[j],
                         cuda_spgemm.numeric_round_ref(slabs[0][j], slabs[1][j], pa, pb,
                                                       no_mod=no_mod))
    got = cuda_mxu.numeric_round_mxu(a, b, spa, spb)
    worst["mxu"] = _check_equal(f"numeric_round_mxu on {jobs} jobs' stacked indices", got,
                                mxu_spgemm.numeric_round_mxu_ref(a, b, spa, spb))
    for j in range(jobs):
        _check_equal(f"numeric_round_mxu, job {j}'s rows of the stacked launch", got[j],
                     mxu_spgemm.numeric_round_mxu_ref(slabs[0][j], slabs[1][j], pa, pb))
    return worst


def _check_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> int:
    """torch.equal or raise; returns the max abs error (0)."""
    torch.cuda.synchronize()
    err = _u64_max_abs_err(got, want)
    if not torch.equal(got, want):
        raise RuntimeError(f"{what}: kernel != plain version, max abs err {err}")
    return err


def _field_slab(rng, n_tiles: int, k: int, small: bool) -> torch.Tensor:
    """n_tiles tiles and the zero sentinel last, on the card: half EDGE
    values, half uniform; all below 2^32 when small (the SMALL instance's
    proof)."""
    pool = np.array([v for v in EDGE if not small or v < 1 << 32], np.uint64)
    shape = (n_tiles + 1, k, k)
    tiles = np.where(rng.random(shape) < 0.5, pool[rng.integers(0, len(pool), shape)],
                     rng.integers(0, 1 << 32 if small else 1 << 64, shape, dtype=np.uint64))
    tiles[-1] = 0
    return torch.from_numpy(tiles.view(np.int64)).to(DEVICE)


def _field_pairs(rng, n_tiles: int, K: int, P: int, pattern: str) -> list:
    """(pa, pb) on the card with sentinel slots laid out as _sentinel_round
    lays them ("pad_keys", "one_sided", "between"; "none": no sentinel)."""
    pa, pb = (rng.integers(0, n_tiles, size=(K, P)).astype(np.int32) for _ in range(2))
    hole = rng.random((K, P)) < 0.4
    if pattern == "pad_keys":
        pa[::3] = pb[::3] = n_tiles
    elif pattern == "one_sided":
        pa[hole] = n_tiles
        pb[~hole & (rng.random((K, P)) < 0.4)] = n_tiles
    elif pattern == "between":
        pa[hole] = pb[hole] = n_tiles
    return [torch.from_numpy(x).to(DEVICE) for x in (pa, pb)]


def _field_cells(rng, n_tiles: int, counts: np.ndarray, rows_acc: int) -> list:
    """F3's CSR on the card: cells of counts[c] pairs (about one slot in five
    a sentinel, on either side), on distinct rows of an accumulator of
    rows_acc; returns [rows, cell_ptr, pa, pb]."""
    cell_ptr = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    pa, pb = (rng.integers(0, n_tiles, size=int(cell_ptr[-1])).astype(np.int32)
              for _ in range(2))
    pa[rng.random(pa.shape) < 0.1] = n_tiles
    pb[rng.random(pb.shape) < 0.1] = n_tiles
    rows = rng.permutation(rows_acc)[: len(counts)].astype(np.int32)
    return [torch.from_numpy(x).to(DEVICE) for x in (rows, cell_ptr, pa, pb)]


def _field_cases(rng) -> dict:
    """The field-mode kernels of inner and ring sharding (csrc/field_fold.cu)
    against their plain versions on the card, exact equality: F1
    (field_fold, full 8 x 8 and SMALL 4 x 4 bytes, the full instance also on
    the SMALL cases' values) on EDGE values at k 1, 2, 8, 31, 32, 33, 64 with
    sentinel-heavy lists (keys of sentinel slots only among them), P = 0,
    K = 0, a key of P * k > 2^17 and a pair sum of 2^64 - 1 (which reads 0);
    F3 (field_fold_scatter) on CSR cells of 1 to 300 pairs at the same k,
    SMALL too, a cell of sentinel slots only and zero cells, every other
    accumulator row left as it was; F2 (addmod_field_) on EDGE values with
    a sum of 2^64 - 1.  Returns the max abs error by kernel and the number
    of cases."""
    worst = {"field_fold": 0, "field_fold_scatter": 0, "field_add": 0}
    cases = 0
    fold_cases = [(k, K, P, pattern) for k, K, P in ((1, 300, 9), (2, 300, 9), (8, 60, 7),
                                                     (31, 40, 8), (32, 40, 8), (33, 30, 5),
                                                     (64, 8, 5))
                  for pattern in ("none", "pad_keys", "one_sided", "between")]
    fold_cases += [(32, 4, 384, "between"), (8, 20, 384, "one_sided"), (16, 0, 4, "between"),
                   (16, 3, 0, "between"), (32, 3, 4100, "between")]  # the last: P*k > 2^17
    for k, K, P, pattern in fold_cases:
        for small in (False, True):
            a, b = _field_slab(rng, 30, k, small), _field_slab(rng, 30, k, small)
            pa, pb = _field_pairs(rng, 30, K, P, pattern)
            want = cuda_field.field_fold_ref(a, b, pa, pb, small=small)
            what = f"k={k} K={K} P={P} {pattern} small={small}"
            worst["field_fold"] = max(worst["field_fold"], _check_equal(
                f"field_fold {what}", cuda_field.field_fold(a, b, pa, pb, small=small), want))
            if small:  # the full instance is legal on small values too: the same bits
                _check_equal(f"field_fold (full) {what}", cuda_field.field_fold(a, b, pa, pb),
                             want)
            cases += 1
    # (2^32 - 1)^2 + (2^32 - 1) * 2 = 2^64 - 1, which reads 0 (every operand below 2^32,
    # as the SMALL route requires)
    a = torch.tensor([[[(1 << 32) - 1]], [[(1 << 32) - 1]], [[0]]], dtype=torch.int64,
                     device=DEVICE)
    b = torch.tensor([[[(1 << 32) - 1]], [[2]], [[0]]], dtype=torch.int64, device=DEVICE)
    pa = torch.tensor([[0, 1]], dtype=torch.int32, device=DEVICE)
    for small in (False, True):
        got = cuda_field.field_fold(a, b, pa, pa.clone(), small=small)
        _check_equal(f"field_fold 2^64 - 1 collapse small={small}", got, torch.zeros_like(got))
        acc = torch.zeros((2, 1, 1), dtype=torch.int64, device=DEVICE)
        cell = [torch.tensor(x, device=DEVICE) for x in (np.array([1], np.int32),
                                                          np.array([0, 2], np.int64))]
        got = cuda_field.field_fold_scatter(acc, a, b, *cell, pa[0], pa[0].clone(), small=small)
        _check_equal(f"field_fold_scatter 2^64 - 1 collapse small={small}", got,
                     torch.zeros_like(got))
    scatter_cases = [(k, counts) for k in (1, 2, 8, 31, 32, 33, 64)
                     for counts in ("ones", "mixed")]
    scatter_cases += [(32, "deep"), (8, "deep"), (8, "none")]
    for k, kind in scatter_cases:
        C = {"ones": 200, "mixed": 60, "deep": 12, "none": 0}[kind] if k < 64 else 20
        counts = {"ones": np.ones(C, np.int64), "none": np.zeros(0, np.int64),
                  "mixed": rng.integers(1, 40, C), "deep": rng.integers(1, 301, C)}[kind]
        if kind == "deep":
            counts[:2] = (1, 300)
        for small in (False, True):
            a, b = _field_slab(rng, 25, k, small), _field_slab(rng, 25, k, small)
            rows_acc = C + 7
            cells = _field_cells(rng, 25, counts, rows_acc)
            if C:  # a cell of sentinel slots only, which adds nothing
                cells[2][cells[1][0]: cells[1][1]] = 25
            start = _field_slab(rng, rows_acc - 1, k, False)
            start[start == -1] = 0  # an accumulator holds canonical residues
            got = cuda_field.field_fold_scatter(start.clone(), a, b, *cells, small=small)
            want = cuda_field.field_fold_scatter_ref(start.clone(), a, b, *cells, small=small)
            what = f"k={k} C={C} {kind} small={small}"
            worst["field_fold_scatter"] = max(worst["field_fold_scatter"], _check_equal(
                f"field_fold_scatter {what}", got, want))
            untouched = torch.ones(rows_acc, dtype=torch.bool, device=DEVICE)
            untouched[cells[0].long()] = False
            if C:
                untouched[cells[0][0].long()] = True  # its cell holds sentinels only
            if not torch.equal(got[untouched], start[untouched]):
                raise RuntimeError(f"field_fold_scatter {what} wrote a row of no cell")
            cases += 1
    for k, K in ((1, 1000), (8, 300), (32, 50), (64, 9)):
        x, y = _field_slab(rng, K, k, False), _field_slab(rng, K, k, False)
        x[0, 0, 0], y[0, 0, 0] = -2, 1  # (2^64 - 2) + 1 reads 0
        got = cuda_field.addmod_field_(x.clone(), y)
        worst["field_add"] = max(worst["field_add"], _check_equal(
            f"addmod_field_ k={k} K={K}", got, cuda_field.addmod_field_ref_(x.clone(), y)))
        if int(got[0, 0, 0]) != 0:
            raise RuntimeError("addmod_field_: (2^64 - 2) + 1 did not read 0")
        cases += 1
    return {"worst": worst, "cases": cases}


def phase_kernel(rng) -> dict:
    """Each kernel against its plain version on the card; returns the max
    abs error by kernel."""
    t0 = time.perf_counter()
    cases = [(k, 40, 37, 5, 0) for k in (1, 2, 4, 8, 32, 64)]
    cases += [(8, 30, 9, 3, 3), (32, 30, 9, 3, 2),   # stacked (R, K, P) rounds
              (32, 20, 0, 4, 0),                     # empty K = 0 round
              (32, 300, 4, 384, 0), (8, 300, 6, 256, 0)]  # hub fanouts
    worst = {"mod": 0, "no_mod": 0, "mxu": 0}
    for k, n_tiles, K, P, stack in cases:
        args = _round_case(rng, k, n_tiles, K, P, stack)
        what = f"k={k} K={K} P={P} stack={stack}"
        for name, no_mod in (("mod", False), ("no_mod", True)):
            got = cuda_spgemm.numeric_round(*args, no_mod=no_mod)
            want = cuda_spgemm.numeric_round_ref(*args, no_mod=no_mod)
            worst[name] = max(worst[name], _check_equal(f"numeric_round {name} {what}", got, want))
        got = cuda_mxu.numeric_round_mxu(*args)
        want = mxu_spgemm.numeric_round_mxu_ref(*args)
        worst["mxu"] = max(worst["mxu"], _check_equal(f"numeric_round_mxu 10x10 {what}", got, want))
    # the limb kernel at fewer limbs, on values below 2^16 (3 limbs hold them)
    small = [(k, 40, 37, 5, 0) for k in (1, 2, 4, 8, 32, 64)]
    small += [(8, 30, 9, 3, 3), (32, 20, 0, 4, 0), (32, 300, 4, 4096, 0)]  # P*k = 2^17
    for k, n_tiles, K, P, stack in small:
        args = _round_case(rng, k, n_tiles, K, P, stack, small=True)
        for limbs in (3, 1):
            got = cuda_mxu.numeric_round_mxu(*args, a_limbs=limbs, b_limbs=limbs)
            want = mxu_spgemm.numeric_round_mxu_ref(*args, a_limbs=limbs, b_limbs=limbs)
            worst["mxu"] = max(worst["mxu"], _check_equal(
                f"numeric_round_mxu {limbs}x{limbs} k={k} K={K} P={P}", got, want))
    # kernel 1 on rounds heavy with sentinel slots, both variants
    sentinel = [(k, K, P, pattern) for k, K, P in ((1, 300, 9), (2, 300, 9), (4, 300, 9),
                                                   (8, 300, 9), (16, 60, 7), (32, 40, 8),
                                                   (64, 8, 5), (128, 3, 4))
                for pattern in ("pad_keys", "one_sided", "dirty")]
    sentinel += [(32, 4, 384, "between"), (8, 20, 384, "one_sided"), (16, 0, 4, "between"),
                 (16, 3, 0, "between")]
    for k, K, P, pattern in sentinel:
        args = _sentinel_round(rng, k, K, P, pattern)
        for name, no_mod in (("mod", False), ("no_mod", True)):
            got = cuda_spgemm.numeric_round(*args, no_mod=no_mod)
            want = cuda_spgemm.numeric_round_ref(*args, no_mod=no_mod)
            worst[name] = max(worst[name], _check_equal(
                f"numeric_round {name} k={k} K={K} P={P} {pattern}", got, want))
    worst["mxu"] = max(worst["mxu"], _mxu_cases(rng, sentinel))
    for name, err in _jobs_stacked_case(rng).items():
        worst[name] = max(worst[name], err)
    args = _round_case(rng, 32, 20, 3, 4097, 0, small=True)  # P*k > 2^17
    for fn in (cuda_mxu.numeric_round_mxu, mxu_spgemm.numeric_round_mxu_ref):
        try:
            fn(*args)
        except ValueError:
            continue
        raise RuntimeError(f"{fn.__name__} took a P*k > 2^17 round")
    _phase("kernel", t0, f"numeric_round (mod, no_mod) and numeric_round_mxu (10x10 "
           f"EDGE, 3x3 and 1x1 below 2^16) == plain versions on {len(cases)} + "
           f"{len(small)} rounds (k in 1..64, stacked, empty, hub P*k<=2^17); "
           f"numeric_round (mod, no_mod) == plain version on {len(sentinel)} rounds heavy "
           f"with sentinel slots (k in 1..128, P up to 384; all-pad keys, one-sided, between "
           f"real slots, a last tile not zero, K = 0, P = 0); all three == plain versions on 3 "
           f"jobs' round stacked by stack_round_indices (sentinels in every job's copy), each "
           f"job's rows == its solo round; P*k > 2^17 raises; "
           f"max_abs_err {worst}")
    t1 = time.perf_counter()
    field = _field_cases(np.random.default_rng(SEED + 25))
    worst.update(field["worst"])
    _phase("kernel", t1, f"field_fold (F1, full and SMALL), field_fold_scatter (F3) and "
           f"addmod_field_ (F2) == plain versions on {field['cases']} cases (EDGE values, k "
           f"1..64 with 31 and 33, sentinel-heavy lists, P = 0, K = 0, P*k > 2^17, F3 cells "
           f"of 1 to 300 pairs with every other row untouched, sums of 2^64 - 1 read 0); "
           f"max_abs_err {field['worst']}")
    worst.update(_bsmm_cases(rng))
    return worst


def _range_tiles(rng, n_tiles: int, k: int, n_limbs: int) -> np.ndarray:
    """(n_tiles + 1, k, k) uint64 below 2^(7 * n_limbs), sentinel zero tile
    last: a third the range's top, a third EDGE values in range, a third
    uniform in range."""
    top = min(MAX, (1 << (7 * n_limbs)) - 1)
    shape = (n_tiles + 1, k, k)
    edge = np.array([e for e in EDGE if e <= top], np.uint64)
    pick = rng.integers(0, 3, size=shape)
    tiles = np.where(pick == 0, np.uint64(top), edge[rng.integers(0, len(edge), size=shape)])
    tiles = np.where(pick == 2, rng.integers(0, top, size=shape, dtype=np.uint64,
                                             endpoint=True), tiles)
    tiles[-1] = 0
    return tiles


def _on_card(*arrays) -> list[torch.Tensor]:
    return [torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64 else x).to(DEVICE)
            for x in arrays]


def _mxu_cases(rng, sentinel: list) -> int:
    """Kernel 2 against its plain version on the rounds that stress the
    byte-limb design; returns the max abs error (0)."""
    t0 = time.perf_counter()
    worst, n = 0, 0

    def check(what, args, **limbs):
        nonlocal worst, n
        got = cuda_mxu.numeric_round_mxu(*args, **limbs)
        want = mxu_spgemm.numeric_round_mxu_ref(*args, **limbs)
        worst = max(worst, _check_equal(f"numeric_round_mxu {what} {limbs}", got, want))
        n += 1

    # kernel 1's sentinel-heavy rounds: all-pad keys, one-sided, between,
    # a last tile that is not zero, K = 0, P = 0
    for k, K, P, pattern in sentinel:
        check(f"k={k} K={K} P={P} {pattern}", _sentinel_round(rng, k, K, P, pattern))
    # every a_limbs against b_limbs 1, 5, 10 and the mirror, at the top of
    # each limb count's range
    grid = sorted({(a, b) for a in range(1, 11) for b in (1, 5, 10)}
                  | {(a, b) for a in (1, 5, 10) for b in range(1, 11)})
    for a_limbs, b_limbs in grid:
        for k in (1, 8, 32):
            n_tiles, K, P = 9, 11, 4
            tiles = (_range_tiles(rng, n_tiles, k, a_limbs), _range_tiles(rng, n_tiles, k, b_limbs))
            pairs = rng.integers(0, n_tiles + 1, size=(2, K, P)).astype(np.int32)  # sentinels too
            check(f"limb grid k={k}", _on_card(*tiles, *pairs), a_limbs=a_limbs, b_limbs=b_limbs)
    # P * k = 2^17 real pairs of values whose bytes are nearly all 255: the
    # s32 fragments must fold before they overflow
    for k in (32, 64):
        n_tiles, P = 40, (1 << 17) // k
        tiles = [MAX - rng.integers(0, 256, size=(n_tiles + 1, k, k), dtype=np.uint64)
                 for _ in range(2)]
        pairs = rng.integers(0, n_tiles, size=(2, 2, P)).astype(np.int32)
        check(f"flush k={k} P={P} full range", _on_card(*tiles, *pairs))
    # ragged k (odd k takes 8-byte copies) and slabs 8 bytes off a 16-byte
    # boundary (8-byte copies at any k)
    for k in (3, 31, 33, 64, 128):
        a, b, pa, pb = _round_case(rng, k, 12, 6, 5)
        check(f"ragged k={k}", (a, b, pa, pb))
        a, b = [torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape) for x in (a, b)]
        if a.data_ptr() % 16 != 8 or b.data_ptr() % 16 != 8:
            raise RuntimeError("the unaligned slab case is aligned")
        check(f"unaligned slabs k={k}", (a, b, pa, pb))
    _phase("kernel", t0, f"numeric_round_mxu == plain version on {n} more rounds: "
           f"{len(sentinel)} heavy with sentinel slots (10x10), {3 * len(grid)} over the limb "
           f"grid (a_limbs 1..10 x b_limbs 1, 5, 10 and the mirror; k 1, 8, 32; the top of "
           f"each range), P*k = 2^17 at k 32 and 64 with bytes nearly all 255, ragged k "
           f"3, 31, 33, 64, 128 on aligned and unaligned slabs; max_abs_err {worst}")
    return worst


def _check_close(what: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
                 atol: float) -> float:
    """|got - want| <= atol + rtol |want| everywhere, or raise; returns the
    max abs error."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                           f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError(f"{what}: non-finite values")
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if (diff > atol + rtol * w.abs()).any():
        raise RuntimeError(f"{what}: kernel != plain version beyond rtol {rtol}, atol "
                           f"{atol}; max abs err {err}")
    return err


def _bsmm_operands(rng, M: int, nb_in: int, nbc: int, rpc: int, k: int, dtype):
    x = rng.standard_normal((M, nb_in * k)).astype(np.float32)
    rows = np.stack([rng.permutation(nb_in)[:rpc] for _ in range(nbc)]).astype(np.int32)
    tiles = (rng.standard_normal((nbc, rpc, k, k)) / np.sqrt(rpc * k)).astype(np.float32)
    return (torch.from_numpy(x).to(DEVICE, dtype), torch.from_numpy(rows).to(DEVICE),
            torch.from_numpy(tiles).to(DEVICE, dtype))


def _must_raise(what: str, fn, *args, **kw) -> None:
    try:
        fn(*args, **kw)
    except ValueError:
        return
    raise RuntimeError(f"{what} did not raise")


def _same_at_row_tiles(what: str, got, x, rows, tiles, fuse_gelu: bool = False) -> list:
    """Kernel 3 launched at every row tile br of 16, 32, 64 and 128 that
    divides M, in place of row_tile's: each must give got's bits.  Returns
    the row tiles checked."""
    brs = [br for br in (16, 32, 64, 128) if x.shape[0] % br == 0]
    for br in brs:
        other = cuda_bsmm._launch(x, rows, tiles, 16, fuse_gelu, resident=False, br=br)
        torch.cuda.synchronize()
        if not torch.equal(other, got):
            raise RuntimeError(f"{what}: row tile {br} gives other bits")
    return brs


def _bsmm_cases(rng) -> dict:
    """Kernels 3 and 4 against bsmm_ref on the card; returns their max abs
    errors."""
    t0 = time.perf_counter()
    worst = {"bsmm": 0.0, "bsmm_resident": 0.0}
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for k, M, nb_in, nbc, rpc, block_m in BSMM_CASES:
            cases.append((f"k={k} M={M} d_in={nb_in * k} nbc={nbc} rpc={rpc} {dtype}",
                          *_bsmm_operands(rng, M, nb_in, nbc, rpc, k, dtype), block_m))
        # a ragged W2 fan-in, padded with zero tiles by w2_to_column_major
        cfg = ffn.BlockSparseFFNConfig(d_model=512, d_ff=1024, k=32, block_density=0.3,
                                       dtype=str(dtype).removeprefix("torch."))
        params = ffn.init_params(cfg, torch.Generator().manual_seed(SEED), device=DEVICE)
        w2 = ffn.prepare_kernel_params(params, cfg)["w2cm"]
        fan = torch.bincount(params["w2"]["cols"].reshape(-1).long(), minlength=cfg.nb_model)
        if int(fan.min()) == int(fan.max()):
            raise RuntimeError("the ragged W2 case has no pad tiles")
        h = torch.from_numpy(rng.standard_normal((128, cfg.d_ff)).astype(np.float32))
        cases.append((f"ragged W2 fan-in {fan.tolist()} {dtype}", h.to(DEVICE, dtype),
                      w2["rows"], w2["tiles"], 16))
    n_resident = 0
    for what, x, rows, tiles, block_m in cases:
        rtol, atol = BSMM_TOL[x.dtype]
        for fuse_gelu in (False, True):
            want = cuda_bsmm.bsmm_ref(x, rows, tiles, fuse_gelu=fuse_gelu)
            got = cuda_bsmm.bsmm(x, rows, tiles, block_m=block_m, fuse_gelu=fuse_gelu)
            tag = f"{what} block_m={block_m} gelu={fuse_gelu}"
            worst["bsmm"] = max(worst["bsmm"], _check_close(f"bsmm {tag}", got, want, rtol, atol))
            wide = cuda_bsmm.bsmm(x, rows, tiles, block_m=x.shape[0], fuse_gelu=fuse_gelu)
            torch.cuda.synchronize()
            if not torch.equal(wide, got):
                raise RuntimeError(f"bsmm {tag}: block_m={x.shape[0]} gives other bits")
            _same_at_row_tiles(f"bsmm {tag}", got, x, rows, tiles, fuse_gelu)
            if not cuda_bsmm.resident_panel_fits(x.shape[1], block_m, x.element_size(),
                                                 tiles.shape[-1]):
                _must_raise(f"bsmm_resident {tag} (panel does not fit)",
                            cuda_bsmm.bsmm_resident, x, rows, tiles, block_m=block_m)
                continue
            res = cuda_bsmm.bsmm_resident(x, rows, tiles, block_m=block_m, fuse_gelu=fuse_gelu)
            n_resident += 1
            worst["bsmm_resident"] = max(worst["bsmm_resident"], _check_close(
                f"bsmm_resident {tag}", res, want, rtol, atol))
            if not torch.equal(res, got):
                raise RuntimeError(f"bsmm_resident {tag} != bsmm at the same block_m")
    x, rows, tiles = _bsmm_operands(rng, 32, 8, 2, 2, 8, torch.bfloat16)
    _must_raise("bsmm at k=8", cuda_bsmm.bsmm, x, rows, tiles, block_m=16)
    x, rows, tiles = _bsmm_operands(rng, 16, 128, 1, 1, 128, torch.bfloat16)  # d_in 16384
    _must_raise("bsmm_resident with a 16 x 16384 panel", cuda_bsmm.bsmm_resident, x, rows,
                tiles, block_m=16)
    _phase("kernel", t0, f"bsmm == bsmm_ref on {len(cases)} cases x gelu on/off (f32 and "
           f"bf16; k in 16, 32, 128; ragged W2 fan-in), bits equal across block_m and "
           f"across every row tile of 16, 32, 64, 128 that divides M; "
           f"bsmm_resident on {n_resident} of them, == bsmm bit for bit, raises where its "
           f"panel does not fit; k=8 and a 16 x 16384 bf16 panel raise; max_abs_err {worst}")
    return worst


def _multiplying_lines(n: int) -> list[str]:
    """The chain's progress lines for an N-matrix chain (helper2 pairing)."""
    lines, m = [], n
    while m > 1:
        lines += [f"multiplying {i} {i + 1}" for i in range(0, m - 1, 2)]
        m = m // 2 + m % 2
    return lines


def _cli(folder: str, out: str, cwd: str, env: dict, *extra) -> str:
    """Run the port's CLI on the card; returns its stdout."""
    proc = subprocess.run(
        [sys.executable, "-m", "spgemm_tpu_torch.cli", folder, "--output", out,
         "--device", DEVICE, *extra],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"cli on {folder} {extra} exited {proc.returncode}:\n{proc.stderr}")
    return proc.stdout


def phase_cli(rng) -> None:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        env = {**os.environ, "PYTHONPATH": REPO,
               "SPGEMM_TPU_CROSSOVER_CACHE": os.path.join(tmp, "crossover")}
        for name in ("golden_chain", "golden_wrap"):
            folder = os.path.join(REPO, "tests", "data", name)
            out = os.path.join(tmp, f"{name}.matrix")
            stdout = _cli(folder, out, tmp, env)
            with open(out, "rb") as f, \
                    open(os.path.join(REPO, "tests", "data", f"{name}_expected_matrix"), "rb") as g:
                if f.read() != g.read():
                    raise RuntimeError(f"cli output on {name} differs from the expected bytes")
            lines = stdout.splitlines()
            n, _ = io_text.read_size(folder)
            if lines[:-1] != _multiplying_lines(n) or \
                    not re.fullmatch(r"time taken \S+ seconds", lines[-1]):
                raise RuntimeError(f"cli stdout on {name} is not the reference's:\n{stdout}")
        # a small-valued chain: the hybrid proof holds on its first level
        k = 8
        mats = random_chain(4, 6, k, 0.4, rng, "small")
        folder = os.path.join(tmp, "small_chain")
        io_text.write_chain_dir(folder, mats, k)
        got = {}
        for backend in ("exact", "hybrid", "mxu"):
            out = os.path.join(tmp, f"small.{backend}.matrix")
            _cli(folder, out, tmp, env, "--backend", backend)
            with open(out, "rb") as f:
                got[backend] = f.read()
        dicts = [m.to_dict() for m in mats]
        rows, cols = mats[0].rows, mats[-1].cols
        want = io_text.format_matrix(BlockSparseMatrix.from_dict(
            rows, cols, k, chain_oracle(dicts, k)).prune_zeros())
        want_field = io_text.format_matrix(BlockSparseMatrix.from_dict(
            rows, cols, k, chain_oracle(dicts, k, field_spgemm_oracle)).prune_zeros())
        if got["exact"] != want or got["hybrid"] != got["exact"]:
            raise RuntimeError("cli --backend exact/hybrid on the small chain differ "
                               "from the oracle's bytes")
        if got["mxu"] != want_field:
            raise RuntimeError("cli --backend mxu differs from the field-mode oracle")
    a = random_block_sparse(5, 5, 4, 0.5, rng)
    b = random_block_sparse(5, 5, 4, 0.5, rng)
    a.tiles[:] = _edge_values(rng, a.tiles.shape)
    got = spgemm(a, b, device=DEVICE)
    want = BlockSparseMatrix.from_dict(a.rows, b.cols, 4,
                                       spgemm_oracle(a.to_dict(), b.to_dict(), 4))
    if got != want:
        raise RuntimeError("spgemm on the card differs from the numpy oracle")
    _phase("cli", t0, "golden_chain and golden_wrap byte-equal, stdout lines "
           "match; small-valued chain: --backend hybrid == exact == oracle bytes, "
           "--backend mxu == field-mode oracle; small EDGE spgemm == oracle")


class TimedFold:
    """A numeric-round function wrapped in CUDA events, counting the work
    the run's data needs: pair slots, real tile pairs (neither index the
    sentinel), their u64 MACs, their int8 limb MACs for the limb kernel
    (bytes_for_limbs7(a_limbs) * bytes_for_limbs7(b_limbs) byte products per
    u64 MAC, the least int8 work for the function; limb7_macs counts the
    a_limbs * b_limbs 7-bit products of the earlier design) and bytes (each
    referenced tile, index and output element once)."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []
        self.pairs = 0
        self.slots = 0
        self.macs = 0
        self.limb_macs = 0
        self.limb7_macs = 0
        self.bytes = 0

    def __call__(self, a, b, pa, pb, **kw):
        k = a.shape[-1]
        tile = k * k * 8
        real = int(((pa != a.shape[0] - 1) & (pb != b.shape[0] - 1)).sum())
        self.pairs += real
        self.slots += pa.numel()
        self.macs += real * k ** 3
        a_limbs = kw.get("a_limbs", mxu_spgemm.N_LIMBS)
        b_limbs = kw.get("b_limbs", mxu_spgemm.N_LIMBS)
        self.limb_macs += real * k ** 3 * mxu_spgemm.bytes_for_limbs7(a_limbs) \
            * mxu_spgemm.bytes_for_limbs7(b_limbs)
        self.limb7_macs += real * k ** 3 * a_limbs * b_limbs
        self.bytes += (len(torch.unique(pa)) + len(torch.unique(pb))) * tile \
            + (pa.numel() + pb.numel()) * 4 + pa.numel() // pa.shape[-1] * tile
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(a, b, pa, pb, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


class TimedMatmul:
    """torch.bmm wrapped in CUDA events: the plain limb version's product."""

    def __init__(self):
        self.events = []

    def __call__(self, A, B):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = torch.bmm(A, B)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _bound(ops_ms: float, bytes_ms: float) -> tuple[float, str]:
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def _banded_coords(block_dim: int, bandwidth: int) -> np.ndarray:
    r = np.arange(block_dim)[:, None]
    c = np.arange(block_dim)[None, :]
    return np.argwhere(np.abs(r - c) <= bandwidth).astype(np.int64)


def _plan_chain(mats) -> tuple[float, float, list]:
    """Host seconds the chain's planner (join + rounds + permutation) takes
    alone, on the block structures only, with the plan cache off (so the
    planner, not a lookup, is timed), the seconds of its joins alone, and
    the plans."""
    arr = [SimpleNamespace(k=m.k, nnzb=m.nnzb, coords=m.coords, rows=m.rows, cols=m.cols)
           for m in mats]
    plans, join_s = [], 0.0
    with _env(SPGEMM_TPU_PLAN_CACHE="0"):
        t0 = time.perf_counter()
        while len(arr) > 1:
            nxt = []
            for i in range(0, len(arr) - 1, 2):
                p = plan(arr[i], arr[i + 1])
                plans.append(p)
                nxt.append(SimpleNamespace(k=p.k, nnzb=p.join.num_keys, coords=p.join.keys,
                                           rows=arr[i].rows, cols=arr[i + 1].cols))
            arr = nxt + arr[len(nxt) * 2:]
        total = time.perf_counter() - t0
    for p in plans:
        t1 = time.perf_counter()
        symbolic.symbolic_join(p.a_coords, p.b_coords)
        join_s += time.perf_counter() - t1
    return total, join_s, plans


def _same_plans(xs: list, ys: list) -> bool:
    """Equal keys, pair lists, rounds and assembly permutations."""
    def arrays(p):
        yield from (p.join.keys, p.join.pair_ptr, p.join.pair_a, p.join.pair_b, p.take)
        for r in p.rounds:
            yield from (r.key_index, r.pa, r.pb, np.array([r.max_fanout]))

    return len(xs) == len(ys) and all(
        len(x.rounds) == len(y.rounds) and all(
            u.dtype == v.dtype and np.array_equal(u, v) for u, v in zip(arrays(x), arrays(y)))
        for x, y in zip(xs, ys))


def _ptxas_report() -> dict:
    """Registers and spill bytes of kernel 1's two instances, of kernel 2's
    instances at 8x8 and 3x3 byte limbs (10 and 3 7-bit limbs), of the
    segmented fold, of kernel 3's and kernel 4's two instances each on the
    FFN's paths (the forward's and the dgrad's gelu_grad one) and of kernel
    5's, from the ptxas reports _build keeps beside the libraries."""
    out = {}
    k3_rows = cuda_bsmm.warp_rows(128, 128, 2)  # 64: the wgmma warpgroups' instance
    k3_wg = int(k3_rows == 64)
    k3_mt = 1 if k3_wg else k3_rows // 16
    k3_nt = cuda_bsmm.warp_ntiles(128, 128, k3_rows)
    for lib, pattern, name in (
            ("numeric_round", r"numeric_round_kernelILb([01])E",
             lambda m: "no_mod" if m.group(1) == "1" else "mod"),
            ("numeric_round_mxu", r"limb_fold_kernelILi(\d)ELi(\d)E",
             lambda m: f"mxu {m.group(1)}x{m.group(2)}"),
            ("numeric_round_dense", r"numeric_round_kernelILb0ELb1E", lambda m: "dense"),
            # kernel 4 on the FFN's main path: bf16, k 128, 2 n-tiles a warp (block_m 16),
            # the forward's instance and the gelu_grad one (the dgrad at block_m 16)
            ("bsmm", r"bsmm_resident_kernelI13__nv_bfloat16Li128ELi2ELb([01])E",
             lambda m: "bsmm_resident" + ("_gelu_grad" if m.group(1) == "1" else "")),
            # kernel 3 on the FFN's main path: bf16, k 128, row tile 128, warp_rows'
            # warps, the forward's instance and the gelu_grad one (the dgrad)
            ("bsmm", rf"bsmm_kernelI13__nv_bfloat16Li128ELi{k3_mt}ELi{k3_nt}ELb([01])ELb{k3_wg}E",
             lambda m: "bsmm" + ("_gelu_grad" if m.group(1) == "1" else "")),
            # kernel 5 on the FFN training step's path: the wgmma body (bf16, k 128),
            # and its mma.sync body's instance there (a variant)
            ("bsmm_grad", r"bsmm_wgrad_wg_kernel", lambda m: "bsmm_wgrad"),
            ("bsmm_grad", r"bsmm_wgrad_kernelI13__nv_bfloat16Li128E",
             lambda m: "bsmm_wgrad_mma_sync")):
        log = _build.build(lib).with_suffix(".log").read_text()
        for entry, stats in obs_profile.parse_ptxas(log).items():
            m = re.search(pattern, entry)
            if m:
                out[name(m)] = {k: stats[k] for k in ("registers", "spill_stores", "spill_loads")}
    want = {"mod", "no_mod", "mxu 8x8", "mxu 3x3", "dense", "bsmm", "bsmm_gelu_grad",
            "bsmm_resident", "bsmm_resident_gelu_grad", "bsmm_wgrad", "bsmm_wgrad_mma_sync"}
    if not want <= set(out):
        raise RuntimeError(f"no ptxas report for {sorted(want - set(out))}: {out}")
    return {name: out[name] for name in sorted(want)}


# each kernel's ENGINE launch counter (bumped by its wrapper where it launches)
LAUNCH_COUNTERS = {"mod": "launches_numeric_round", "no_mod": "launches_numeric_round_no_mod",
                   "mxu": "launches_numeric_round_mxu", "splice": "launches_splice",
                   "dense": "launches_dense_fold", "bsmm": "launches_bsmm",
                   "bsmm_resident": "launches_bsmm_resident",
                   "bsmm_wgrad": "launches_bsmm_wgrad", "field_fold": "launches_field_fold",
                   "field_fold_scatter": "launches_field_fold_scatter",
                   "field_add": "launches_field_add"}


def _zero_counts() -> None:
    ENGINE.zero("launches_")
    for name in engine.rounds_by_kernel:
        engine.rounds_by_kernel[name] = 0


def _read_counts() -> dict:
    counters = ENGINE.counter_snapshot()
    return {**{short: counters.get(name, 0) for short, name in LAUNCH_COUNTERS.items()},
            "rounds": dict(engine.rounds_by_kernel)}


@contextlib.contextmanager
def _env(**values):
    old = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in old.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


class _HybridLog(logging.Handler):
    """The engine's per-multiply hybrid records: (mxu rounds, rounds,
    no_mod rounds, keys), in multiply order."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.multiplies = []

    def emit(self, record):
        if record.msg.startswith("spgemm[hybrid"):
            self.multiplies.append(record.args)


def _main_path(dev_mats, backend: str, folds=None, **env):
    """Drive chain_product once as a main path: counts zeroed just before,
    read just after; folds (default the kernels) may wrap the kernels in
    CUDA events.  Returns (result, wall s, counts, hybrid records)."""
    logger = logging.getLogger("spgemm_tpu_torch.spgemm")
    handler = _HybridLog()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        with _env(**env), contextlib.redirect_stdout(io.StringIO()):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            res = chain_product(dev_mats, device=DEVICE, keep_device=True, backend=backend,
                                folds=folds or engine.KERNELS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = _read_counts()
    finally:
        logger.removeHandler(handler)
    return res, wall, counts, handler.multiplies


def _medium_mats(seed: int = SEED) -> list:
    """The Medium chain's host matrices, from `seed` (its structure, a band,
    is the same for every seed)."""
    rng = np.random.default_rng(seed)
    cfg = MEDIUM
    return [banded_block_sparse(cfg["block_dim"], cfg["k"], cfg["bandwidth"], rng)
            for _ in range(cfg["n"])]


def _distinct_mats(mats: list) -> list:
    """The Medium chain of distinct structures: input i with its band
    shifted i blocks to the right (tiles past the last column dropped), so
    that no two multiplies of the chain share an operand structure: the
    products' bands are centred on distinct sums."""
    out = []
    for i, m in enumerate(mats):
        coords = m.coords + np.array([0, i], m.coords.dtype)
        keep = coords[:, 1] < m.cols // m.k
        out.append(BlockSparseMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=coords[keep],
                                     tiles=m.tiles[keep]))
    return out


def phase_medium() -> tuple[dict, SimpleNamespace]:
    t0 = time.perf_counter()
    cfg = MEDIUM
    mats = _medium_mats()
    dev_mats = [DeviceBlockMatrix.from_host(m, DEVICE) for m in mats]
    torch.cuda.synchronize()
    tiles = sum(m.nnzb for m in mats)
    _phase("medium", t0, f"generated + uploaded {cfg['n']} banded matrices, "
           f"{tiles} tiles of {cfg['k']}x{cfg['k']} uint64 "
           f"({tiles * cfg['k'] ** 2 * 8 / 1e6:.0f} MB)")

    # the main path, once, with an empty plan cache: counts zeroed just
    # before, read just after
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    plancache.clear()
    ENGINE.reset()
    _zero_counts()
    res = chain_product(dev_mats, device=DEVICE, keep_device=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counts()
    cache = {"hits": ENGINE.counters.get("plan_cache_hits", 0),
             "misses": ENGINE.counters.get("plan_cache_misses", 0),
             "plan_s": ENGINE.snapshot().get("plan", 0.0)}
    launches = counts["mod"]
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0:
        raise RuntimeError("the main path launched the numeric_round kernel 0 times")
    if counts["no_mod"] or counts["mxu"]:
        raise RuntimeError(f"the exact path launched another kernel than the mod fold: {counts}")
    want_coords = _banded_coords(cfg["block_dim"], cfg["bandwidth"] * cfg["n"])
    if not np.array_equal(res.coords, want_coords) or \
            tuple(res.slab.shape) != (len(want_coords) + 1, cfg["k"], cfg["k"]):
        raise RuntimeError("Medium result structure is not the expected band")
    t_plan = _plan_chain(mats)[0]
    _phase("medium", t0, f"main path (empty plan cache): chain wall {wall:.6f} s (host "
           f"planning alone, cache off, {t_plan:.6f} s; ENGINE plan {cache['plan_s']:.6f} s, "
           f"plan cache hits {cache['hits']}, misses {cache['misses']}), numeric_round "
           f"launches {launches} (no_mod 0, mxu 0), result {res.nnzb} tiles, peak "
           f"device memory {peak / 2**30:.3f} GiB ({(peak - base) / 2**30:.3f} GiB above "
           f"the {base / 2**30:.3f} GiB of its inputs)")

    t0 = time.perf_counter()
    kerns = [TimedFold(cuda_spgemm.numeric_round) for _ in range(KERNEL_REPEATS)]
    plain = TimedFold(cuda_spgemm.numeric_round_ref)
    with contextlib.redirect_stdout(io.StringIO()):  # the progress lines again
        for kern in kerns:
            res_k = chain_product(dev_mats, device=DEVICE, keep_device=True,
                                  folds=Folds(exact=kern))
        res_p = chain_product(dev_mats, device=DEVICE, keep_device=True,
                              folds=Folds(exact=plain))
        plain_ms = plain.ms()
    runs_ms = sorted(kern.ms() for kern in kerns)
    kern_ms = runs_ms[len(runs_ms) // 2]
    err = max(_u64_max_abs_err(res.slab, res_p.slab), _u64_max_abs_err(res_k.slab, res_p.slab))
    if not (torch.equal(res.slab, res_p.slab) and torch.equal(res_k.slab, res_p.slab)
            and np.array_equal(res.coords, res_p.coords)):
        raise RuntimeError(f"Medium chain: kernel result != plain version (max abs err {err})")
    ops_ms = kern.macs * INT_OPS_PER_MAC / INT32_OPS_PER_S * 1e3
    bytes_ms = kern.bytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = _bound(ops_ms, bytes_ms)
    _phase("medium", t0, f"kernel total {kern_ms:.3f} ms over {len(kern.events)} "
           f"launches (median of {', '.join(f'{t:.3f}' for t in runs_ms)}), plain "
           f"version total {plain_ms:.3f} ms; results equal; "
           f"{kern.macs / 1e9:.3f} G MACs -> integer bound {ops_ms:.3f} ms, "
           f"{kern.bytes / 1e9:.3f} GB -> bytes bound {bytes_ms:.3f} ms; "
           f"kernel at {bound_ms / kern_ms * 100:.1f}% of bound")
    ptxas = {name: v for name, v in _ptxas_report().items() if name in ("mod", "no_mod")}
    geometry = {name: cuda_spgemm.geometry(cfg["k"], no_mod=no_mod)
                for name, no_mod in (("mod", False), ("no_mod", True))}
    print(f"[medium] kernel 1: {kern.pairs} real pairs in {kern.slots} pair slots "
          f"({kern.pairs / kern.slots * 100:.2f}% real; sentinel slots skipped); ptxas "
          f"(registers, spill bytes) {ptxas['mod']}, {ptxas['no_mod']}; at k={cfg['k']}: "
          f"{geometry}", flush=True)
    return {"name": "numeric_round", "route": "cuda",
            "source": "spgemm_tpu_torch/csrc/numeric_round.cu",
            "replaces": "spgemm_tpu/ops/pallas_spgemm.py:188",
            "launches": launches, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "equal": True, "variant": "mod",
            "ms_runs": runs_ms, "chain_wall_s": wall, "plan_s": t_plan, "macs": kern.macs,
            "bytes": kern.bytes,
            "peak_bytes": peak, "peak_above_inputs_bytes": peak - base,
            "plan_cache_main_path": cache, "pairs": kern.pairs, "slots": kern.slots, "ptxas": ptxas,
            "geometry": geometry}, SimpleNamespace(mats=mats, dev_mats=dev_mats, res=res)


def _same(x: DeviceBlockMatrix, y: DeviceBlockMatrix) -> bool:
    return np.array_equal(x.coords, y.coords) and torch.equal(x.slab, y.slab)


def _execute_syncs(dev_mats) -> dict:
    """Stream synchronizations inside ops/spgemm.execute during one Medium
    chain at the default plan-ahead: calls of torch.cuda.synchronize and
    Stream.synchronize, and the synchronizing CUDA operations that torch's
    sync debug mode ("warn") reports while execute runs (checked first on a
    blocking .item(), which it must report)."""
    counts = {"synchronize": 0, "Stream.synchronize": 0, "sync_debug": 0}
    inside = []
    real_execute, real_sync = engine.execute, torch.cuda.synchronize
    real_stream_sync = torch.cuda.Stream.synchronize

    def sync(*args, **kw):
        counts["synchronize"] += bool(inside)
        return real_sync(*args, **kw)

    def stream_sync(self):
        counts["Stream.synchronize"] += bool(inside)
        return real_stream_sync(self)

    def execute(*args, **kw):
        inside.append(1)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return real_execute(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                inside.pop()
                counts["sync_debug"] += sum("called a synchronizing CUDA operation"
                                            in str(w.message) for w in caught)

    # the control: a blocking fetch must be reported, or a 0 means nothing
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            torch.ones(1, device=DEVICE).item()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if not any("called a synchronizing CUDA operation" in str(w.message) for w in caught):
        raise RuntimeError("torch's sync debug mode did not report a blocking .item()")
    engine.execute, torch.cuda.synchronize, torch.cuda.Stream.synchronize = \
        execute, sync, stream_sync
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            chain_product(dev_mats, device=DEVICE, keep_device=True)
        torch.cuda.synchronize()
    finally:
        engine.execute, torch.cuda.synchronize, torch.cuda.Stream.synchronize = \
            real_execute, real_sync, real_stream_sync
    return counts


def _pinned_stats() -> dict | str:
    """PyTorch's caching host allocator's statistics (pinned host memory),
    as torch.cuda.host_memory_stats gives them."""
    stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    return {name: v for name, v in stats.items() if "bytes" in name or "host_" in name} \
        or "not measured (torch.cuda.host_memory_stats gives nothing)"


def phase_medium_host(medium) -> dict:
    """The main path's host half on the Medium chain: the planner with the
    native join and with SPGEMM_TPU_NO_NATIVE=1 (plans identical), then the
    chain's wall at SPGEMM_TPU_PLAN_AHEAD 0 and 2 in turns (results equal to
    the main path's) with ENGINE's plan / plan_wait / upload split, and the
    stream synchronizations execute makes (must be 0)."""
    mats, dev_mats, res = medium.mats, medium.dev_mats, medium.res
    t0 = time.perf_counter()
    native_s, native_join_s, native_plans = _plan_chain(mats)
    medium.plans = native_plans
    with _env(SPGEMM_TPU_NO_NATIVE="1"):
        numpy_s, numpy_join_s, numpy_plans = _plan_chain(mats)
    if not _same_plans(native_plans, numpy_plans):
        raise RuntimeError("Medium planner: the native join's plans differ from the numpy join's")
    _phase("medium", t0, f"host planning alone: native join {native_s:.6f} s (joins "
           f"{native_join_s:.6f} s), SPGEMM_TPU_NO_NATIVE=1 {numpy_s:.6f} s (joins "
           f"{numpy_join_s:.6f} s) over {len(native_plans)} multiplies; keys, pair lists, "
           "rounds and permutations identical")

    t0 = time.perf_counter()
    if hasattr(torch.cuda, "reset_peak_host_memory_stats"):
        torch.cuda.reset_peak_host_memory_stats()
    walls, splits = {0: [], 2: []}, {0: [], 2: []}
    # the plan cache off: these time the planner, as before the cache
    with contextlib.redirect_stdout(io.StringIO()), _env(SPGEMM_TPU_PLAN_CACHE="0"):
        for _ in range(KERNEL_REPEATS):
            for ahead in (0, 2):
                with _env(SPGEMM_TPU_PLAN_AHEAD=str(ahead)):
                    torch.cuda.synchronize()
                    ENGINE.reset()
                    t1 = time.perf_counter()
                    got = chain_product(dev_mats, device=DEVICE, keep_device=True)
                    torch.cuda.synchronize()
                    walls[ahead].append(time.perf_counter() - t1)
                    splits[ahead].append(ENGINE.snapshot())
                if not _same(got, res):
                    raise RuntimeError(f"Medium chain at SPGEMM_TPU_PLAN_AHEAD={ahead} "
                                       "differs from the main path's result")
    del got
    pinned = _pinned_stats()
    syncs = _execute_syncs(dev_mats)
    if any(syncs.values()):
        raise RuntimeError(f"execute synchronized the stream: {syncs}")
    med = {}
    for ahead, ws in walls.items():
        i = sorted(range(len(ws)), key=ws.__getitem__)[len(ws) // 2]
        med[ahead] = {"wall_s": ws[i], "walls_s": ws,
                      **{name: splits[ahead][i].get(name, 0.0)
                         for name in ("plan", "plan_wait", "upload")}}
    _phase("medium", t0, "plan-ahead (plan cache off): chain wall (median of "
           f"{KERNEL_REPEATS}, in turns) SPGEMM_TPU_PLAN_AHEAD=0 {med[0]['wall_s']:.6f} s "
           f"(runs {', '.join(f'{w:.6f}' for w in walls[0])}; plan {med[0]['plan']:.6f}, "
           f"plan_wait {med[0]['plan_wait']:.6f}, upload {med[0]['upload']:.6f} s), =2 "
           f"{med[2]['wall_s']:.6f} s (runs {', '.join(f'{w:.6f}' for w in walls[2])}; plan "
           f"{med[2]['plan']:.6f}, plan_wait {med[2]['plan_wait']:.6f}, upload "
           f"{med[2]['upload']:.6f} s); results equal; stream synchronizations inside "
           f"execute over one chain: {syncs}; pinned host memory over the 6 chains {pinned}")
    return {"plan_native_s": native_s, "plan_numpy_s": numpy_s, "join_native_s": native_join_s,
            "join_numpy_s": numpy_join_s, "plan_ahead": med, "execute_syncs": syncs,
            "pinned": pinned}


def _write_text_dir(folder: str, mats: list) -> None:
    """The chain's input directory, one writer thread per file."""
    os.makedirs(folder)
    with open(os.path.join(folder, "size"), "w") as f:
        f.write(f"{len(mats)} {mats[0].k}\n")
    with ThreadPoolExecutor(max_workers=len(mats)) as pool:
        list(pool.map(lambda i: io_text.write_matrix(os.path.join(folder, f"matrix{i + 1}"),
                                                     mats[i]), range(len(mats))))


MEDIUM_CLI_NUMPY_N = 3  # [medium-cli]: the numpy leg runs on Medium's first 3 matrices


def phase_medium_cli(medium) -> dict:
    """The port's CLI on the Medium chain's text directory (written by the
    native writer), run as `python -m spgemm_tpu_torch.cli <dir> -v` with
    the default loader threads, its ./matrix, read back with the native
    parser, equal to the in-memory result after prune_zeros; then on a directory of Medium's
    first MEDIUM_CLI_NUMPY_N matrices (links to the same files) natively and
    with SPGEMM_TPU_NO_NATIVE=1 (the numpy paths), the two ./matrix files
    byte-equal.  Needs about 4 GB of disk under TMPDIR and deletes it."""
    t0 = time.perf_counter()
    want = medium.res_host.prune_zeros()
    k = want.k
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_medium_cli_") as tmp:
        free = shutil.disk_usage(tmp).free
        print(f"[medium-cli] free disk space under {tempfile.gettempdir()}: "
              f"{free / 1e9:.3f} GB", flush=True)
        folder = os.path.join(tmp, "medium")
        t1 = time.perf_counter()
        _write_text_dir(folder, medium.mats)
        out["write_dir_s"] = time.perf_counter() - t1
        out["text_bytes"] = sum(os.path.getsize(os.path.join(folder, f"matrix{i + 1}"))
                                for i in range(len(medium.mats)))
        # the numpy leg's depth cut: Medium's first matrices, the same files
        folder_n = os.path.join(tmp, "medium_head")
        os.makedirs(folder_n)
        with open(os.path.join(folder_n, "size"), "w") as f:
            f.write(f"{MEDIUM_CLI_NUMPY_N} {k}\n")
        for i in range(MEDIUM_CLI_NUMPY_N):
            os.symlink(os.path.join(folder, f"matrix{i + 1}"),
                       os.path.join(folder_n, f"matrix{i + 1}"))
        env = {**os.environ, "PYTHONPATH": REPO}
        for name, src, n, extra, knob in (
                ("default", folder, len(medium.mats), [], {}),
                ("native_head", folder_n, MEDIUM_CLI_NUMPY_N, [], {}),
                ("no_native", folder_n, MEDIUM_CLI_NUMPY_N, [], {"SPGEMM_TPU_NO_NATIVE": "1"})):
            proc = subprocess.run(
                [sys.executable, "-m", "spgemm_tpu_torch.cli", src, "-v", "--device", DEVICE,
                 *extra], cwd=tmp, env={**env, **knob}, capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"cli on the Medium directory {extra} exited "
                                   f"{proc.returncode}:\n{proc.stderr[-4000:]}")
            lines = proc.stdout.splitlines()
            taken = re.fullmatch(r"time taken (\S+) seconds", lines[-1] if lines else "")
            if lines[:-1] != _multiplying_lines(n) or not taken:
                raise RuntimeError(f"cli stdout on the Medium directory is not the "
                                   f"reference's:\n{proc.stdout[-2000:]}")
            phases = {m.group(1): float(m.group(2))
                      for m in re.finditer(r"phase (\S+): ([0-9.]+)s", proc.stderr)}
            matrix = os.path.join(tmp, "matrix")
            out[name] = {"time_taken_s": float(taken.group(1)), "phases": phases,
                         "matrix_bytes": os.path.getsize(matrix)}
            if name == "native_head":
                os.replace(matrix, os.path.join(tmp, "matrix.native_head"))
                continue
            if name == "no_native":
                if not _same_bytes(matrix, os.path.join(tmp, "matrix.native_head")):
                    raise RuntimeError(f"cli ./matrix under SPGEMM_TPU_NO_NATIVE=1 on Medium's "
                                       f"first {n} matrices differs from the native run's")
                os.remove(matrix)
                continue
            t1 = time.perf_counter()
            got = io_text.read_matrix(matrix, k)
            out[name]["read_back_s"] = time.perf_counter() - t1
            if (got.rows, got.cols) != (want.rows, want.cols) or \
                    not np.array_equal(got.coords, want.coords) or \
                    not np.array_equal(got.tiles, want.tiles):
                raise RuntimeError(f"cli ./matrix on the Medium directory ({name}) differs "
                                   "from the in-memory chain result after prune_zeros")
            os.remove(matrix)
        out["ranks_8"] = _medium_cli_ranks(medium, folder, tmp, env, want)
    d, h, n = out["default"], out["native_head"], out["no_native"]
    _phase("medium-cli", t0, f"wrote {len(medium.mats)} files, {out['text_bytes'] / 1e9:.3f} "
           f"GB of text in {out['write_dir_s']:.3f} s (native writer, a thread per file); "
           f"cli -v: time taken {d['time_taken_s']:.6f} s: load {d['phases'].get('load')}, "
           f"chain {d['phases'].get('chain')}, prune+write {d['phases'].get('prune+write')} s "
           f"(plan {d['phases'].get('plan')}, plan_wait {d['phases'].get('plan_wait')}, "
           f"upload {d['phases'].get('upload')} s); "
           f"on Medium's first {MEDIUM_CLI_NUMPY_N} matrices, SPGEMM_TPU_NO_NATIVE=1 (numpy "
           f"text I/O and join): time taken {n['time_taken_s']:.6f} s, load "
           f"{n['phases'].get('load')}, chain {n['phases'].get('chain')}, prune+write "
           f"{n['phases'].get('prune+write')} s, against native {h['time_taken_s']:.6f} s (load "
           f"{h['phases'].get('load')}, prune+write {h['phases'].get('prune+write')} s), "
           f"./matrix ({n['matrix_bytes'] / 1e9:.3f} GB) byte-equal; "
           f"./matrix ({d['matrix_bytes'] / 1e9:.3f} GB) read back in {d['read_back_s']:.3f} s "
           "equals the in-memory result after prune_zeros; --ranks 8: time "
           f"taken {out['ranks_8']['time_taken_s']:.6f} s (chain "
           f"{out['ranks_8']['phases'].get('chain')} s), "
           f"{out['ranks_8']['tiles_differing_from_p1']} of {out['ranks_8']['tiles']} tiles "
           "differ from P = 1, ./matrix == chain_product_partitioned(mats, 8, "
           f"multiply=spgemm_outofcore) in memory ({out['ranks_8']['in_memory_ooc_s']:.3f} s)")
    return out


def _medium_cli_ranks(medium, folder: str, tmp: str, env: dict, p1) -> dict:
    """`--ranks 8` on the Medium text directory: its ./matrix against
    chain_product_partitioned(mats, 8, multiply=spgemm_outofcore) run in
    memory (a data path that shares no slab with the CLI's), and the tiles
    whose bytes differ from the P = 1 result."""
    proc = subprocess.run(
        [sys.executable, "-m", "spgemm_tpu_torch.cli", folder, "-v", "--device", DEVICE,
         "--ranks", "8"], cwd=tmp, env=env, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"cli --ranks 8 on the Medium directory exited {proc.returncode}:"
                           f"\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    taken = re.fullmatch(r"time taken (\S+) seconds", lines[-1] if lines else "")
    # ranks 0-6 hold one matrix each, rank 7 three; the combine reduces 8
    want_lines = _multiplying_lines(3) + _multiplying_lines(8)
    if lines[:-1] != want_lines or not taken:
        raise RuntimeError(f"cli --ranks 8 stdout:\n{proc.stdout[-2000:]}")
    matrix = os.path.join(tmp, "matrix")
    got = io_text.read_matrix(matrix, p1.k)
    os.remove(matrix)
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        mem = chain_product_partitioned(medium.mats, 8, multiply=spgemm_outofcore,
                                        device=DEVICE).prune_zeros()
    mem_s = time.perf_counter() - t1
    if not _host_equal(got, mem):
        raise RuntimeError("cli --ranks 8 ./matrix differs from chain_product_partitioned "
                           "with spgemm_outofcore in memory")
    medium.ranks8_digest = _digest(got)  # [inner-ring] holds --shard chain's P = 8 to it
    phases = {m.group(1): float(m.group(2))
              for m in re.finditer(r"phase (\S+): ([0-9.]+)s", proc.stderr)}
    return {"time_taken_s": float(taken.group(1)), "phases": phases,
            "tiles": got.nnzb, "tiles_differing_from_p1": _differing_tiles(got, p1),
            "in_memory_ooc_s": mem_s}


def _digest(m: BlockSparseMatrix) -> str:
    """sha256 of a host matrix's dims, coords and tiles."""
    h = hashlib.sha256(np.array([m.rows, m.cols, m.k], np.int64).tobytes())
    h.update(np.ascontiguousarray(m.coords, np.int64).tobytes())
    h.update(np.ascontiguousarray(m.tiles, np.uint64).tobytes())
    return h.hexdigest()


def phase_medium_parity(medium) -> dict:
    """Kernel 1's output of every level-1 multiply of the Medium chain,
    fetched to the host, against the native u64 fold (native/parityfold.cpp,
    which shares no code with the port's numeric path), every key."""
    t0 = time.perf_counter()
    mats, dev_mats = medium.mats, medium.dev_mats
    fold_s, keys, pairs = 0.0, 0, 0
    for i in range(0, len(mats) - 1, 2):
        p = plan(dev_mats[i], dev_mats[i + 1])
        got = engine.execute(p, dev_mats[i], dev_mats[i + 1]).to_host()
        t1 = time.perf_counter()
        n_bad, first = native.parity_fold_check(mats[i].tiles, mats[i + 1].tiles, p.join.pair_ptr,
                                                p.join.pair_a, p.join.pair_b, got.tiles)
        fold_s += time.perf_counter() - t1
        if n_bad:
            raise RuntimeError(f"parity fold: {n_bad} keys of level-1 multiply {i} {i + 1} "
                               f"differ from kernel 1 (first key {first})")
        keys += p.join.num_keys
        pairs += len(p.join.pair_a)
    _phase("medium", t0, f"parity fold: kernel 1's output of all {len(mats) // 2} level-1 "
           f"multiplies ({keys} keys, {pairs} tile pairs) against the native u64 fold: 0 bad "
           f"keys; the fold took {fold_s:.3f} s on {os.cpu_count()} host cores")
    return {"fold_s": fold_s, "keys": keys, "pairs": pairs, "host_cores": os.cpu_count()}


def _timed_chain(dev_mats, want: DeviceBlockMatrix, **env) -> dict:
    """One chain on the card, as the main path runs it: wall, ENGINE plan
    and plan_wait, plan cache hits and misses; the result must equal want."""
    with _env(**env), contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        ENGINE.reset()
        t0 = time.perf_counter()
        got = chain_product(dev_mats, device=DEVICE, keep_device=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if not _same(got, want):
        raise RuntimeError(f"chain under {env} differs from its reference result")
    phases = ENGINE.snapshot()
    return {"wall_s": wall, "plan": phases.get("plan", 0.0),
            "plan_wait": phases.get("plan_wait", 0.0),
            "plan_exact": phases.get("plan_exact", 0.0),
            "hits": ENGINE.counters.get("plan_cache_hits", 0),
            "misses": ENGINE.counters.get("plan_cache_misses", 0),
            "est_hits": ENGINE.counters.get("est_hits", 0),
            "est_fallbacks": ENGINE.counters.get("est_fallbacks", 0)}


def _median_run(runs: list) -> dict:
    return sorted(runs, key=lambda r: r["wall_s"])[len(runs) // 2]


def phase_medium_plancache(medium) -> dict:
    """The Medium main path with an empty plan cache against
    SPGEMM_TPU_PLAN_CACHE=0, in turns (medians of KERNEL_REPEATS), then once
    more with the cache warm; and the tile pairs of the multiplies that hit,
    from the cache-off plans (_plan_chain)."""
    t0 = time.perf_counter()
    runs = {"off": [], "empty": []}
    for _ in range(KERNEL_REPEATS):
        for mode in ("off", "empty"):
            plancache.clear()
            runs[mode].append(_timed_chain(medium.dev_mats, medium.res,
                                           SPGEMM_TPU_PLAN_CACHE="0" if mode == "off" else "1"))
    warm = _timed_chain(medium.dev_mats, medium.res, SPGEMM_TPU_PLAN_CACHE="1")
    med = {mode: _median_run(rs) for mode, rs in runs.items()}
    walls = {mode: ", ".join(f"{r['wall_s']:.6f}" for r in rs) for mode, rs in runs.items()}
    keys = [(p.a_coords.tobytes(), p.b_coords.tobytes()) for p in medium.plans]
    pairs = [len(p.join.pair_a) for p in medium.plans]
    hit_pairs = sum(n for i, n in enumerate(pairs) if keys[i] in keys[:i])
    want = {"hits": len(keys) - len(set(keys)), "misses": len(set(keys))}
    if {x: med["empty"][x] for x in want} != want or warm["hits"] != len(keys):
        raise RuntimeError(f"plan cache on the Medium chain: {med['empty']} (want {want}), "
                           f"warm {warm}")
    _phase("medium", t0, f"plan cache, medians of {KERNEL_REPEATS} in turns: "
           f"SPGEMM_TPU_PLAN_CACHE=0 wall {med['off']['wall_s']:.6f} s (plan "
           f"{med['off']['plan']:.6f}, plan_wait {med['off']['plan_wait']:.6f} s; runs "
           f"{walls['off']}); empty cache "
           f"wall {med['empty']['wall_s']:.6f} s (plan {med['empty']['plan']:.6f}, plan_wait "
           f"{med['empty']['plan_wait']:.6f} s; hits {med['empty']['hits']}, misses "
           f"{med['empty']['misses']}; runs {walls['empty']}); warm cache "
           f"wall {warm['wall_s']:.6f} s (plan {warm['plan']:.6f}, plan_wait "
           f"{warm['plan_wait']:.6f} s; hits {warm['hits']}, misses {warm['misses']}); tile "
           f"pairs per multiply {pairs}, {hit_pairs} of {sum(pairs)} "
           f"({hit_pairs / sum(pairs) * 100:.2f}%) in the multiplies that hit; results equal")
    return {"off": med["off"], "empty": med["empty"], "warm": warm,
            "runs": runs, "pairs": pairs, "hit_pairs": hit_pairs,
            "distinct": _plancache_distinct(medium)}


def _plancache_distinct(medium) -> dict:
    """What the cache costs where it cannot help: the Medium chain of
    distinct structures (_distinct_mats).  Walls with the cache off and
    empty, in turns (medians of KERNEL_REPEATS), 0 hits required, results
    equal; and the cache's own host work on these 9 multiplies timed alone:
    the fingerprints and the freezing of each plan."""
    t0 = time.perf_counter()
    mats = _distinct_mats(medium.mats)
    dev_mats = [DeviceBlockMatrix.from_host(m, DEVICE) for m in mats]
    with contextlib.redirect_stdout(io.StringIO()), _env(SPGEMM_TPU_PLAN_CACHE="0"):
        want = chain_product(dev_mats, device=DEVICE, keep_device=True)
    runs = {"off": [], "empty": []}
    for _ in range(KERNEL_REPEATS):
        for mode in ("off", "empty"):
            plancache.clear()
            runs[mode].append(_timed_chain(dev_mats, want,
                                           SPGEMM_TPU_PLAN_CACHE="0" if mode == "off" else "1"))
    med = {mode: _median_run(rs) for mode, rs in runs.items()}
    if med["empty"]["hits"] != 0 or med["empty"]["misses"] != len(mats) - 1:
        raise RuntimeError(f"plan cache on distinct structures: {med['empty']}")
    plans = _plan_chain(mats)[2]
    t1 = time.perf_counter()
    for p in plans:
        plancache.fingerprint(p.a_coords, p.b_coords, (p.k, p.backend))
    hash_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    for p in plans:
        p.freeze()
    freeze_s = time.perf_counter() - t1
    plancache.clear()
    walls = {mode: ", ".join(f"{r['wall_s']:.6f}" for r in rs) for mode, rs in runs.items()}
    _phase("medium", t0, f"plan cache on distinct structures (input i's band shifted "
           f"i blocks), medians of {KERNEL_REPEATS} in turns: SPGEMM_TPU_PLAN_CACHE=0 wall "
           f"{med['off']['wall_s']:.6f} s (plan {med['off']['plan']:.6f} s; runs "
           f"{walls['off']}); empty cache wall {med['empty']['wall_s']:.6f} s (plan "
           f"{med['empty']['plan']:.6f} s; hits {med['empty']['hits']}, misses "
           f"{med['empty']['misses']}; runs {walls['empty']}); the cache's own work on the "
           f"{len(plans)} multiplies alone: fingerprints {hash_s:.6f} s, freezing "
           f"{freeze_s:.6f} s; results equal")
    return {"off": med["off"], "empty": med["empty"], "runs": runs,
            "fingerprint_s": hash_s, "freeze_s": freeze_s}


def _busy_share(trace_path: str, window: str) -> dict:
    """From a torch.profiler Chrome trace: the union of the device kernels'
    intervals inside the host range named `window`, over that range."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    wins = [e for e in events if e.get("name") == window and e.get("cat") == "user_annotation"]
    if len(wins) != 1:
        raise RuntimeError(f"the trace holds {len(wins)} ranges named {window!r}")
    start = float(wins[0]["ts"])
    end = start + float(wins[0]["dur"])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    spans = sorted((max(float(e["ts"]), start), min(float(e["ts"]) + float(e["dur"]), end))
                   for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:
        if e0 <= s0:
            continue
        if cur_e is None or s0 > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += 0.0 if cur_e is None else cur_e - cur_s
    k1 = [e for e in kernels if "numeric_round_kernel" in e.get("name", "")]
    return {"window_ms": (end - start) / 1e3, "busy_ms": busy / 1e3,
            "share": busy / (end - start), "kernels": len(kernels), "kernel1_launches": len(k1),
            "kernel1_ms": sum(float(e["dur"]) for e in k1) / 1e3}


def phase_medium_busy(medium) -> dict:
    """The device's busy share over one Medium main-path chain, from a
    torch.profiler trace (CPU and CUDA activity) of the chain, closed by a
    synchronize: with an empty plan cache and with a warm one."""
    t0 = time.perf_counter()
    out = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        for state in ("empty", "warm"):
            if state == "empty":
                plancache.clear()
            torch.cuda.synchronize()
            with contextlib.redirect_stdout(io.StringIO()), \
                    torch.profiler.profile(activities=acts) as prof:
                with torch.profiler.record_function("medium_chain"):
                    got = chain_product(medium.dev_mats, device=DEVICE, keep_device=True)
                    torch.cuda.synchronize()
            path = os.path.join(tmp, f"{state}.json")
            prof.export_chrome_trace(path)
            if not _same(got, medium.res):
                raise RuntimeError("the profiled Medium chain differs from the main path's result")
            out[state] = _busy_share(path, "medium_chain")
            if out[state]["kernel1_launches"] <= 0:
                raise RuntimeError(f"the profiler trace of the Medium chain holds no launch of "
                                   f"kernel 1: {out[state]}")
    _phase("medium", t0, "device busy share over one Medium main-path chain (torch.profiler, "
           "union of kernel intervals over the chain's host range, profiler on): empty plan "
           f"cache {out['empty']['share'] * 100:.2f}% ({out['empty']['busy_ms']:.3f} of "
           f"{out['empty']['window_ms']:.3f} ms; {out['empty']['kernels']} kernels, kernel 1 "
           f"{out['empty']['kernel1_launches']} launches, {out['empty']['kernel1_ms']:.3f} ms), "
           f"warm {out['warm']['share'] * 100:.2f}% ({out['warm']['busy_ms']:.3f} of "
           f"{out['warm']['window_ms']:.3f} ms; kernel 1 {out['warm']['kernel1_ms']:.3f} ms)")
    return out


def _host_equal(x: BlockSparseMatrix, y: BlockSparseMatrix) -> bool:
    return (x.rows, x.cols, x.k) == (y.rows, y.cols, y.k) and \
        np.array_equal(x.coords, y.coords) and np.array_equal(x.tiles, y.tiles)


def _ooc_chain(mats, backend: str = "exact", **env) -> tuple:
    """chain_product over host matrices with spgemm_outofcore: (result, wall
    s, peak device bytes above the memory allocated at its start, launches,
    ENGINE phases and counters)."""
    with _env(**env), contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ENGINE.reset()
        _zero_counts()
        t0 = time.perf_counter()
        got = chain_product(mats, device=DEVICE, backend=backend, multiply=spgemm_outofcore)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return got, {"wall_s": wall, "peak_bytes": torch.cuda.max_memory_allocated() - base,
                 "launches": _read_counts(), "phases": ENGINE.snapshot(),
                 "counters": dict(ENGINE.counters)}


def phase_medium_ooc(medium, resident_peak: int, resident_above: int) -> dict:
    """spgemm_outofcore chained over the Medium chain's host matrices at
    SPGEMM_TPU_OOC_DEPTH 1, 2 and 4: wall, peak device memory against the
    resident main path's, rounds, bytes uploaded, ENGINE's stage_prep,
    dispatch and assembly; each result equal to the resident result."""
    t0 = time.perf_counter()
    out = {}
    for depth in (1, 2, 4):
        got, out[depth] = _ooc_chain(medium.mats, SPGEMM_TPU_OOC_DEPTH=str(depth))
        if not _host_equal(got, medium.res_host):
            raise RuntimeError(f"out-of-core Medium chain at depth {depth} != resident result")
        if out[depth]["launches"]["mod"] <= 0 or not out[depth]["peak_bytes"] < resident_above:
            raise RuntimeError(f"out-of-core at depth {depth}: {out[depth]} (resident peak "
                               f"above its inputs {resident_above})")
        del got

    def line(d):
        r = out[d]
        return (f"depth {d}: wall {r['wall_s']:.6f} s, peak {r['peak_bytes'] / 2**20:.3f} MiB, "
                f"{r['counters'].get('ooc_rounds')} rounds, "
                f"{r['counters'].get('ooc_upload_bytes', 0) / 1e9:.3f} GB uploaded, kernel 1 "
                f"{r['launches']['mod']} launches, stage_prep "
                f"{r['phases'].get('stage_prep', 0):.6f} s, dispatch "
                f"{r['phases'].get('dispatch', 0):.6f} s, assembly "
                f"{r['phases'].get('assembly', 0):.6f} s, plan {r['phases'].get('plan', 0):.6f} s")
    _phase("medium-ooc", t0, f"{'; '.join(line(d) for d in out)}; each == the resident "
           f"result; the resident main path's peak {resident_peak / 2**30:.3f} GiB "
           f"({resident_above / 2**30:.3f} GiB above its inputs)")
    return out


def _differing_tiles(x: BlockSparseMatrix, y: BlockSparseMatrix) -> int:
    """Keys whose tiles differ between x and y, a key held by one only
    counting as differing."""
    kx = {tuple(c): i for i, c in enumerate(x.coords.tolist())}
    ky = {tuple(c): i for i, c in enumerate(y.coords.tolist())}
    both = sorted(kx.keys() & ky.keys())
    ix = np.array([kx[c] for c in both], np.int64)
    iy = np.array([ky[c] for c in both], np.int64)
    same = np.all(x.tiles[ix] == y.tiles[iy], axis=(1, 2)) if both else np.zeros(0, bool)
    return int((~same).sum()) + len(kx.keys() ^ ky.keys())


def phase_cli_modes(rng) -> dict:
    """On a small chain (k=8, 7 matrices, EDGE-like values): --checkpoint-dir
    resuming after a failure injected after pass 1, run with --profile, whose
    trace must hold kernel 1's launches; failover=True with a failing fold
    injected through Folds, raised on this working card and answered by the
    oracle when the probe reports a lost card.  Each against the oracle's
    bytes."""
    t0 = time.perf_counter()
    k = 8
    mats = random_chain(7, 10, k, 0.4, rng, "adversarial")
    want = io_text.format_matrix(BlockSparseMatrix.from_dict(
        mats[0].rows, mats[-1].cols, k, chain_oracle([m.to_dict() for m in mats], k)
    ).prune_zeros())
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_modes_") as tmp:
        folder = os.path.join(tmp, "chain")
        io_text.write_chain_dir(folder, mats, k)
        env = {**os.environ, "PYTHONPATH": REPO}
        # checkpoint: pass 1 has 3 multiplies; the 4th raises
        ck = os.path.join(tmp, "ck")
        calls = []

        def failing(a, b, **kw):
            calls.append(1)
            if len(calls) == 4:
                raise RuntimeError("failure injected after pass 1")
            return spgemm_device(a, b, **kw)

        try:
            with contextlib.redirect_stdout(io.StringIO()):
                chain_product(mats, device=DEVICE, multiply=failing, checkpoint_dir=ck)
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
        else:
            raise RuntimeError("the injected failure did not raise")
        if sorted(os.listdir(ck)) != ["pass_1.npz"]:
            raise RuntimeError(f"checkpoint dir after the failure: {os.listdir(ck)}")
        # the resume runs under --profile too: its trace must hold kernel 1
        matrix = os.path.join(tmp, "ck.matrix")
        prof = os.path.join(tmp, "prof")
        lines = _cli(folder, matrix, tmp, env, "--checkpoint-dir", ck,
                     "--profile", prof).splitlines()
        with open(matrix, "rb") as f:
            if f.read() != want:
                raise RuntimeError("--checkpoint-dir resume differs from the oracle's bytes")
        if lines[:-1] != _multiplying_lines(4):  # passes 2 and 3 only: it resumed
            raise RuntimeError(f"--checkpoint-dir did not resume from pass 1: {lines}")
        out["checkpoint"] = {"resumed_lines": len(lines) - 1,
                             "passes": sorted(os.listdir(ck))}
        # failover with a failing fold: first with the real probe, which
        # finds this card working, so the error must be raised; then with
        # the probe standing in for a lost card, so the oracle answers
        def failing_folds():
            calls = []

            def fold(*args, **kw):
                calls.append(1)
                if len(calls) >= 2:
                    raise RuntimeError("fold failure injected")
                return cuda_spgemm.numeric_round(*args, **kw)

            return Folds(exact=fold)

        err = io.StringIO()
        t1 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
                chain_product(mats, device=DEVICE, failover=True, folds=failing_folds())
        except RuntimeError as e:
            if "fold failure injected" not in str(e):
                raise
        else:
            raise RuntimeError("failover on a working card answered instead of raising")
        if err.getvalue():
            raise RuntimeError(f"failover on a working card wrote to stderr: {err.getvalue()}")
        live_s = time.perf_counter() - t1
        err = io.StringIO()
        real_probe = backend_probe.probe_default_backend
        backend_probe.probe_default_backend = lambda: "error"
        try:
            with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(err):
                got = chain_product(mats, device=DEVICE, failover=True, folds=failing_folds())
        finally:
            backend_probe.probe_default_backend = real_probe
        err_lines = err.getvalue().splitlines()
        if len(err_lines) != 1 or not err_lines[0].startswith("chain failover:"):
            raise RuntimeError(f"failover's stderr: {err_lines}")
        if io_text.format_matrix(got.prune_zeros()) != want:
            raise RuntimeError("failover's result differs from the oracle's bytes")
        out["failover"] = {"stderr": err_lines[0], "live_card_raised_after_s": live_s}
        (trace,) = os.listdir(prof)
        with open(os.path.join(prof, trace)) as f:
            events = json.load(f)["traceEvents"]
        k1 = [e for e in events if e.get("cat") == "kernel"
              and "numeric_round_kernel" in e.get("name", "")]
        if not k1:
            raise RuntimeError("the --profile trace holds no launch of kernel 1")
        out["profile"] = {"kernel1_launches": len(k1), "trace_bytes":
                          os.path.getsize(os.path.join(prof, trace))}
    _phase("cli-modes", t0, f"7-matrix k=8 chain: --checkpoint-dir resumed after a failure "
           f"injected after pass 1 ({out['checkpoint']['resumed_lines']} multiplies left), "
           f"bytes == oracle, its --profile trace holding "
           f"{out['profile']['kernel1_launches']} kernel 1 launches; failover=True with a "
           f"failing fold: the real probe found the card working and the error was raised "
           f"({out['failover']['live_card_raised_after_s']:.3f} s, probe included); with the "
           f"probe standing in for a lost card, one stderr line, bytes == oracle")
    return out


def _hub_operands(rng, k: int):
    """One output row whose two keys each contract HUB_FANOUT tile pairs,
    values below 2^16: the proof holds, but the fanout class times k passes
    2^17, so the hybrid router keeps the round on the no_mod fold."""
    a_c = np.stack([np.zeros(HUB_FANOUT, np.int64), np.arange(HUB_FANOUT)], axis=1)
    b_c = np.stack([np.repeat(np.arange(HUB_FANOUT), 2), np.tile([0, 1], HUB_FANOUT)], axis=1)
    a = BlockSparseMatrix.from_blocks(k, HUB_FANOUT * k, k, a_c, rng.integers(
        0, 1 << 16, size=(len(a_c), k, k), dtype=np.uint64))
    b = BlockSparseMatrix.from_blocks(HUB_FANOUT * k, 2 * k, k, b_c, rng.integers(
        0, 1 << 16, size=(len(b_c), k, k), dtype=np.uint64))
    return [DeviceBlockMatrix.from_host(m, DEVICE) for m in (a, b)]


def _level1_timings(dev_mats) -> dict:
    """Kernel 2 (at the operands' limbs), kernel 1 no_mod and kernel 1 mod
    on the same rounds: every round of the chain's five level-1 multiplies,
    as the hybrid backend plans them.  All three must agree (the proof
    holds there); the no_mod plain version runs once beside them."""
    rounds = []
    for a, b in zip(dev_mats[0::2], dev_mats[1::2]):
        p = plan(a, b, backend="hybrid")
        limbs = {"a_limbs": cuda_mxu.limbs_for_bound(a.bound()),
                 "b_limbs": cuda_mxu.limbs_for_bound(b.bound())}
        for rnd in p.rounds:
            rounds.append((a.slab, b.slab, torch.tensor(rnd.pa, device=DEVICE),
                           torch.tensor(rnd.pb, device=DEVICE), limbs))
    runs = {"mxu": [], "no_mod": [], "mod": []}
    err = 0
    for _ in range(KERNEL_REPEATS):
        t = {"mxu": TimedFold(cuda_mxu.numeric_round_mxu),
             "no_mod": TimedFold(partial(cuda_spgemm.numeric_round, no_mod=True)),
             "mod": TimedFold(cuda_spgemm.numeric_round)}
        for a, b, pa, pb, limbs in rounds:
            got = t["mxu"](a, b, pa, pb, **limbs)
            for name in ("no_mod", "mod"):
                err = max(err, _check_equal(f"level-1 round, mxu vs {name}", got, t[name](a, b, pa, pb)))
        for name, fold in t.items():
            runs[name].append((fold.ms(), fold))
    plain = TimedFold(partial(cuda_spgemm.numeric_round_ref, no_mod=True))
    nomod = TimedFold(partial(cuda_spgemm.numeric_round, no_mod=True))
    for a, b, pa, pb, _ in rounds:
        err = max(err, _check_equal("level-1 round, no_mod vs its plain version",
                                    nomod(a, b, pa, pb), plain(a, b, pa, pb)))
    out = {"rounds": len(rounds), "err": err, "plain_no_mod_ms": plain.ms()}
    for name, rs in runs.items():
        rs.sort(key=lambda r: r[0])
        out[name] = rs[len(rs) // 2][1]
        out[f"{name}_runs"] = [r[0] for r in rs]
    return out


def phase_medium_small() -> list[dict]:
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    cfg = MEDIUM
    mats = [banded_block_sparse(cfg["block_dim"], cfg["k"], cfg["bandwidth"], rng, dist="small")
            for _ in range(cfg["n"])]
    dev_mats = [DeviceBlockMatrix.from_host(m, DEVICE) for m in mats]
    torch.cuda.synchronize()
    _phase("medium-small", t0, f"generated + uploaded the Medium chain with values "
           f"below 2^16, {sum(m.nnzb for m in dev_mats)} tiles")

    t0 = time.perf_counter()
    res_a, wall_a, counts_a, _ = _main_path(dev_mats, "exact")
    _phase("medium-small", t0, f"(a) exact: chain wall {wall_a:.6f} s, launches {counts_a}")

    t0 = time.perf_counter()
    ooc, ooc_run = _ooc_chain(mats, "hybrid", SPGEMM_TPU_HYBRID_GATE="proof")
    if not _host_equal(ooc, res_a.to_host()) or ooc_run["launches"]["mxu"] <= 0:
        raise RuntimeError(f"out-of-core hybrid on the Medium-small chain != exact, or no "
                           f"limb-kernel launch: {ooc_run['launches']}")
    del ooc, mats
    _phase("medium-small", t0, f"out-of-core hybrid (gate proof): wall "
           f"{ooc_run['wall_s']:.6f} s, byte-equal to (a); launches {ooc_run['launches']}; "
           f"peak {ooc_run['peak_bytes'] / 2**20:.3f} MiB above its start")

    t0 = time.perf_counter()
    res_b, wall_b, counts_b, mult_b = _main_path(dev_mats, "hybrid", SPGEMM_TPU_HYBRID_GATE="proof")
    if not _same(res_b, res_a):
        raise RuntimeError("hybrid (proof gate) != exact on the Medium-small chain")
    level1 = mult_b[: cfg["n"] // 2]
    if counts_b["mxu"] <= 0 or any(m[0] != m[1] for m in level1):
        raise RuntimeError(f"hybrid (proof gate) did not route every level-1 round "
                           f"to the limb kernel: {mult_b}, launches {counts_b}")
    _phase("medium-small", t0, f"(b) hybrid, gate proof: chain wall {wall_b:.6f} s, "
           f"byte-equal to (a); launches {counts_b}; per multiply (mxu rounds, rounds, "
           f"no_mod rounds, keys) {mult_b}")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_crossover_") as cache:
        res_c, wall_c, counts_c, mult_c = _main_path(
            dev_mats, "hybrid", SPGEMM_TPU_HYBRID_GATE="auto", SPGEMM_TPU_CROSSOVER_CACHE=cache)
        with _env(SPGEMM_TPU_CROSSOVER_CACHE=cache):
            gate = crossover.entries()
    if not _same(res_c, res_a):
        raise RuntimeError("hybrid (measured gate) != exact on the Medium-small chain")
    decisions = {key: {**v, "winner": "mxu" if v["mxu_s"] < v["exact_s"] else "no_mod"}
                 for key, v in sorted(gate.items())}
    _phase("medium-small", t0, f"(c) hybrid, gate auto (fresh cache): chain wall "
           f"{wall_c:.6f} s, byte-equal to (a); launches {counts_c} (the gate's "
           f"measurements included); per multiply {mult_c}; gate decisions {decisions}")

    t0 = time.perf_counter()
    res_d, wall_d, counts_d, _ = _main_path(dev_mats, "mxu")
    if counts_d["mxu"] <= 0 or counts_d["mod"] or counts_d["no_mod"]:
        raise RuntimeError(f"mxu backend launched {counts_d}")
    kerns = [TimedFold(cuda_mxu.numeric_round_mxu) for _ in range(KERNEL_REPEATS)]
    plain = TimedFold(mxu_spgemm.numeric_round_mxu_ref)
    bmm = TimedMatmul()
    with contextlib.redirect_stdout(io.StringIO()):
        for kern in kerns:
            res_k = chain_product(dev_mats, device=DEVICE, keep_device=True, backend="mxu",
                                  folds=Folds(mxu=kern))
        res_p = chain_product(dev_mats, device=DEVICE, keep_device=True, backend="mxu",
                              folds=Folds(mxu=partial(plain, matmul=bmm)))
    plain_ms, bmm_ms = plain.ms(), bmm.ms()
    runs_ms = sorted(kern.ms() for kern in kerns)
    kern_ms = runs_ms[len(runs_ms) // 2]
    err_d = max(_u64_max_abs_err(res_d.slab, res_p.slab), _u64_max_abs_err(res_k.slab, res_p.slab))
    if not (_same(res_d, res_p) and _same(res_k, res_p)):
        raise RuntimeError(f"mxu chain: kernel != plain version (max abs err {err_d})")
    ops_ms = 2 * kern.limb_macs / INT8_TENSOR_OPS_PER_S * 1e3
    ops7_ms = 2 * kern.limb7_macs / INT8_TENSOR_OPS_PER_S * 1e3
    bytes_ms = kern.bytes / HBM_BYTES_PER_S * 1e3
    mxu_bound, mxu_by = _bound(ops_ms, bytes_ms)
    mxu7_bound = max(ops7_ms, bytes_ms)
    ptxas = {name: v for name, v in _ptxas_report().items() if name.startswith("mxu")}
    geometry = {f"{limbs}x{limbs} limbs": cuda_mxu.geometry(cfg["k"], limbs, limbs)
                for limbs in (10, 3)}
    _phase("medium-small", t0, f"(d) mxu: chain wall {wall_d:.6f} s, launches {counts_d}; "
           f"kernel total {kern_ms:.3f} ms (median of {', '.join(f'{t:.3f}' for t in runs_ms)}), "
           f"plain version {plain_ms:.3f} ms of which its float64 torch.bmm {bmm_ms:.3f} ms; "
           f"results equal; {kern.pairs} real pairs in {kern.slots} pair slots, "
           f"{kern.limb_macs / 1e12:.3f} T int8 byte-limb MACs -> tensor-core bound "
           f"{ops_ms:.3f} ms, {kern.bytes / 1e9:.3f} GB -> bytes bound {bytes_ms:.3f} ms; kernel "
           f"at {mxu_bound / kern_ms * 100:.2f}% of bound (7-bit limbs, as counted before: "
           f"{kern.limb7_macs / 1e12:.3f} T MACs -> {ops7_ms:.3f} ms, "
           f"{mxu7_bound / kern_ms * 100:.2f}%); kernel 2 ptxas (registers, spill bytes) "
           f"{ptxas}; at k={cfg['k']}: {geometry}")
    del res_d, res_k, res_p

    t0 = time.perf_counter()
    hub = _hub_operands(rng, cfg["k"])
    # the ladder route: under auto the round's dense twin would take it (its
    # padded-MAC ratio, 1.37, passes the proof gate); [dense] (c) runs it so
    res_hx, _, _, _ = _main_path(hub, "exact", SPGEMM_TPU_ACCUM_ROUTE="ladder")
    res_e, wall_e, counts_e, mult_e = _main_path(hub, "hybrid", SPGEMM_TPU_HYBRID_GATE="proof",
                                                 SPGEMM_TPU_ACCUM_ROUTE="ladder")
    if not _same(res_e, res_hx) or counts_e["no_mod"] <= 0:
        raise RuntimeError(f"hub multiply: hybrid != exact or no no_mod launch: {counts_e}")
    _phase("medium-small", t0, f"(e) hub multiply, fanout {HUB_FANOUT} at k={cfg['k']}, "
           f"hybrid gate proof, route ladder: wall {wall_e:.6f} s, byte-equal to exact; launches "
           f"{counts_e}; (mxu rounds, rounds, no_mod rounds, keys) {mult_e}")
    del hub, res_hx, res_e

    t0 = time.perf_counter()
    lv = _level1_timings(dev_mats)
    nomod, mod, mxu = lv["no_mod"], lv["mod"], lv["mxu"]
    nm_ms, mod_ms, mxu_ms = nomod.ms(), mod.ms(), mxu.ms()
    nm_ops = nomod.macs * FMA_OPS_PER_MAC_NO_MOD / INT32_OPS_PER_S * 1e3
    mod_ops = mod.macs * INT_OPS_PER_MAC / INT32_OPS_PER_S * 1e3
    mxu_ops = 2 * mxu.limb_macs / INT8_TENSOR_OPS_PER_S * 1e3
    bytes_ms = nomod.bytes / HBM_BYTES_PER_S * 1e3
    nm_bound, nm_by = _bound(nm_ops, bytes_ms)
    _phase("medium-small", t0, f"level-1 rounds ({lv['rounds']} rounds, {nomod.pairs} real "
           f"pairs, {nomod.macs / 1e9:.3f} G MACs, {nomod.bytes / 1e9:.3f} GB -> bytes bound "
           f"{bytes_ms:.3f} ms), medians of {KERNEL_REPEATS}: numeric_round_mxu "
           f"{mxu_ms:.3f} ms (runs {lv['mxu_runs']}; int8 bound {mxu_ops:.3f} ms), "
           f"numeric_round no_mod {nm_ms:.3f} ms (runs {lv['no_mod_runs']}; FMA-pipe bound "
           f"{nm_ops:.3f} ms), numeric_round mod {mod_ms:.3f} ms (runs {lv['mod_runs']}; "
           f"integer-pipe bound {mod_ops:.3f} ms); no_mod plain version "
           f"{lv['plain_no_mod_ms']:.3f} ms; all equal")

    hybrid_runs = {"b_proof": counts_b, "c_auto": counts_c, "e_hub": counts_e}
    no_mod_row = {
        "name": "numeric_round_no_mod", "route": "cuda",
        "source": "spgemm_tpu_torch/csrc/numeric_round.cu",
        "replaces": "spgemm_tpu/ops/pallas_spgemm.py:188", "variant": "no_mod",
        "launches": sum(c["no_mod"] for c in hybrid_runs.values()),
        "launches_by_run": {run: c["no_mod"] for run, c in hybrid_runs.items()},
        "max_abs_err": lv["err"], "ms": nm_ms, "plain_ms": lv["plain_no_mod_ms"],
        "bound_ms": nm_bound, "bound_by": nm_by, "library_ms": None, "equal": True,
        "ms_runs": lv["no_mod_runs"], "timed_on": "Medium-small level-1 rounds",
        "macs": nomod.macs, "mod_ms_same_rounds": mod_ms, "mxu_ms_same_rounds": mxu_ms,
        "mod_bound_ms_same_rounds": mod_ops, "mxu_bound_ms_same_rounds": max(mxu_ops, bytes_ms)}
    mxu_runs = {"b_proof": counts_b, "c_auto": counts_c, "d_mxu": counts_d}
    mxu_row = {
        "name": "numeric_round_mxu", "route": "cuda",
        "source": "spgemm_tpu_torch/csrc/numeric_round_mxu.cu",
        "replaces": "spgemm_tpu/ops/pallas_mxu.py:201",
        "launches": sum(c["mxu"] for c in mxu_runs.values()),
        "launches_by_run": {run: c["mxu"] for run, c in mxu_runs.items()},
        "max_abs_err": err_d, "ms": kern_ms, "plain_ms": plain_ms,
        "bound_ms": mxu_bound, "bound_by": mxu_by, "library_ms": bmm_ms,
        "library_call": "torch.bmm in float64 of the plain version's byte-limb operands: "
                        "the product alone, without the split or the fold",
        "equal": True, "ms_runs": runs_ms, "timed_on": "Medium-small chain, --backend mxu",
        "limb_macs": kern.limb_macs, "limb7_macs": kern.limb7_macs,
        "bound_ms_limbs7": mxu7_bound, "pairs": kern.pairs, "slots": kern.slots,
        "ptxas": ptxas, "geometry": geometry,
        "chain_wall_s": {"a_exact": wall_a, "b_hybrid_proof": wall_b,
                         "c_hybrid_auto": wall_c, "d_mxu": wall_d},
        "gate": decisions, "ooc_hybrid": ooc_run}
    return [no_mod_row, mxu_row]


def _median_ms(fn, flush: torch.Tensor) -> tuple[float, list[float], object]:
    """fn() timed with CUDA events: one warm-up, then KERNEL_REPEATS runs,
    each after the L2 cache was overwritten outside the window; returns the
    median ms, the runs and the last result."""
    out = fn()
    runs = []
    for _ in range(KERNEL_REPEATS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end))
    return sorted(runs)[len(runs) // 2], runs, out


def _bsmm_bound(x: torch.Tensor, rows_read: int, n_tiles: int, nbc: int, k: int) -> dict:
    """The least time for one matmul's useful work: 2 M k^2 flops per real
    tile on the bf16 tensor cores, against the bytes of the rows_read x
    block-rows it needs, its real tiles and its output, each once."""
    M = x.shape[0]
    es = x.element_size()
    flops = 2 * M * n_tiles * k * k
    nbytes = (rows_read * M * k + n_tiles * k * k + M * nbc * k) * es
    ops_ms = flops / BF16_TENSOR_FLOPS * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = _bound(ops_ms, bytes_ms)
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _dense(rows: torch.Tensor, tiles: torch.Tensor, n_in: int, n_out: int,
           column_major: bool) -> torch.Tensor:
    """The dense (n_in * k, n_out * k) weight of a block-sparse one."""
    nb, per, k, _ = tiles.shape
    w = torch.zeros((n_in, k, n_out, k), dtype=tiles.dtype, device=tiles.device)
    own = torch.arange(nb, device=tiles.device)[:, None].expand(nb, per).reshape(-1)
    idx = rows.reshape(-1).long()
    if column_major:   # tiles[c, r] sits at block (rows[c, r], c)
        w[idx, :, own, :] = tiles.reshape(-1, k, k)
    else:              # tiles[r, j] sits at block (r, cols[r, j])
        w[own, :, idx, :] = tiles.reshape(-1, k, k)
    return w.reshape(n_in * k, n_out * k)


def _k3_plan(M: int, nbc: int, k: int, epilogue: int) -> dict:
    """Kernel 3's launch on one bf16 matmul at block_m 128: its row tile,
    consumer tile (rows x columns: a warp's on mma.sync, a warpgroup's on
    wgmma), ring depth, shared memory, blocks an SM
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor of the epilogue's
    instance), items and persistent grid."""
    dev = torch.cuda.current_device()
    sms = cuda_bsmm.sm_count(dev)
    geo = cuda_bsmm.launch_geometry(M, nbc, 128, False, sms)
    lay = cuda_bsmm.stream_layout(geo.br, k, 2)
    rows = cuda_bsmm.warp_rows(geo.br, k, 2)
    per_sm = cuda_bsmm.stream_blocks_per_sm(k, geo.br, rows, lay.stages, torch.bfloat16,
                                            epilogue, dev)
    items = geo.panels * nbc
    return {"br": geo.br, "warp_tile": [rows, 8 * cuda_bsmm.warp_ntiles(k, geo.br, rows)],
            "stages": lay.stages, "smem_bytes": lay.total, "blocks_per_sm": per_sm,
            "items": items, "grid": cuda_bsmm.stream_grid(items, sms, per_sm)}


def _k3_variants(M: int, nbc: int, k: int) -> dict:
    """name -> cuda_bsmm._launch keywords of kernel 3's variants on one bf16
    matmul at block_m 128: each ring depth, the other consumer tiles (warps
    of 16 and 32 rows on mma.sync beside wgmma's warpgroups), row tile 64,
    one block an item, the pair stream alone with the epilogue (stream_only
    1) and without it (2)."""
    br = cuda_bsmm.launch_geometry(M, nbc, 128, False,
                                   cuda_bsmm.sm_count(torch.cuda.current_device())).br
    rows = cuda_bsmm.warp_rows(br, k, 2)
    out = {f"s{s}": {"stages": s} for s in range(1, cuda_bsmm.stream_layout(br, k, 2).stages + 1)}
    for other in cuda_bsmm.warp_row_options(br, k, 2):
        if other != rows:
            out[f"warp{other}"] = {"warp_m": other}
    if br != 64 and M % 64 == 0:
        out["br64"] = {"br": 64}
    out["per_item"] = {"persistent": False}
    out["stream1"] = {"stream_only": 1}
    out["stream2"] = {"stream_only": 2}
    return out


def _k3_variant_times(what: str, args: tuple, want: torch.Tensor, flush: torch.Tensor,
                      gelu_grad: torch.Tensor | None = None) -> dict:
    """Each of _k3_variants' launches of kernel 3 on args (x, rows, tiles)
    timed (median ms, _median_ms), each but the streams bit-equal to want,
    the default launch's output."""
    x, rows, tiles = args
    out = {}
    for name, kw in _k3_variants(x.shape[0], tiles.shape[0], tiles.shape[-1]).items():
        ms, _, got = _median_ms(lambda kw=kw: cuda_bsmm._launch(
            x, rows, tiles, 128, False, resident=False, gelu_grad=gelu_grad, **kw), flush)
        if not kw.get("stream_only") and not torch.equal(got, want):
            raise RuntimeError(f"{what}: kernel 3 {kw} gives other bits than its default launch")
        out[name] = ms
    return out


def _expect_launches(run: str, got: tuple[int, int], want: tuple[int, int]) -> None:
    if got != want:
        raise RuntimeError(f"ffn run {run}: (bsmm, bsmm_resident) launches {got}, want {want}")


def phase_ffn() -> list[dict]:
    t0 = time.perf_counter()
    cfg = FFN_CFG
    gen = torch.Generator().manual_seed(SEED)
    params = ffn.init_params(cfg, gen, device=DEVICE)
    x = torch.randn((FFN_BATCH, FFN_SEQ, cfg.d_model), generator=gen).to(DEVICE, torch.bfloat16)
    x_small = torch.randn((1, FFN_SMALL_SEQ, cfg.d_model), generator=gen).to(DEVICE,
                                                                            torch.bfloat16)
    pparams = ffn.prepare_kernel_params(params, cfg)
    w1, w2 = pparams["w1"], pparams["w2cm"]
    fan = torch.bincount(params["w2"]["cols"].reshape(-1).long(), minlength=cfg.nb_model)
    params32 = {name: {key: t.float() if t.is_floating_point() else t for key, t in w.items()}
                for name, w in params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = ffn.ffn_forward(params32, x.float(), cfg)
    want_small = ffn.ffn_forward(params32, x_small.float(), cfg)
    torch.cuda.synchronize()
    _phase("ffn", t0, f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, k {cfg.k}, density "
           f"{cfg.block_density}, x {tuple(x.shape)} bf16; W1 rpc {cfg.rpc}; W2 fan-in "
           f"{int(fan.min())}..{int(fan.max())} (mean {float(fan.float().mean()):.3f}), so "
           f"column-major rpc {w2['rows'].shape[1]} with {w2['rows'].numel() - int(fan.sum())} "
           f"zero pad tiles of {w2['rows'].numel()}; plain float32 forward done")

    # the launch geometry of each kernel on each matmul the runs below take
    sms = cuda_bsmm.sm_count(torch.cuda.current_device())
    m_full, m_small = x.shape[0] * x.shape[1], x_small.shape[0] * x_small.shape[1]
    geometry = {
        f"{name} M={M}": cuda_bsmm.launch_geometry(M, nbc, 16, resident, sms).__dict__
        for M in (m_full, m_small)
        for name, nbc, resident in (("kernel 3 matmul 1", cfg.nb_ff, False),
                                    ("kernel 3 matmul 2", cfg.nb_model, False),
                                    ("kernel 4 matmul 1", cfg.nb_ff, True))}
    print(f"[ffn] launch geometry on {sms} SMs (kernel 3: br from row_tile, any block_m; "
          f"kernel 4 at block_m 16: br rows, col_blocks chunks of col_chunk columns): "
          f"{geometry}", flush=True)
    # kernel 4's ring and cluster on matmul 1, what the card holds of each cluster
    layout = cuda_bsmm.resident_layout(cfg.d_model, 16, x.element_size(), cfg.k)
    k4_plan = {M: {"stages": layout.stages, "smem_bytes": layout.total,
                   "ring_offset": layout.ring_offset,
                   "cluster": cuda_bsmm.cluster_size(M // 16, cfg.k),
                   "clusters_allowed": cuda_bsmm.cluster_sizes(M // 16, cfg.k)}
               for M in (m_full, m_small)}
    active = {c: cuda_bsmm.max_active_clusters(cfg.d_model, cfg.k, 16, x.dtype, c,
                                               torch.cuda.current_device())
              for c in cuda_bsmm.CLUSTER_SIZES}
    k4_ptxas = _ptxas_report()["bsmm_resident"]
    print(f"[ffn] kernel 4 at block_m 16 (d_in {cfg.d_model}, bf16, k {cfg.k}): ring of "
          f"{layout.stages} stages, {layout.total} bytes of shared memory (panel "
          f"{layout.panel_bytes}, ring at {layout.ring_offset}); cluster by M {k4_plan}; "
          f"cudaOccupancyMaxActiveClusters by cluster {active}; ptxas {k4_ptxas}", flush=True)

    # kernel 3's launch on each matmul at both sizes
    k3_plan = {f"{name} M={M}": _k3_plan(M, nbc, cfg.k, 0)
               for M in (m_full, m_small)
               for name, nbc in (("matmul 1", cfg.nb_ff), ("matmul 2", cfg.nb_model))}
    k3_ptxas = {name: v for name, v in _ptxas_report().items()
                if name in ("bsmm", "bsmm_gelu_grad")}
    print(f"[ffn] kernel 3 at block_m 128 (bf16, k {cfg.k}; TMA-fed ring of x blocks and tiles, "
          f"producer warp, wgmma warpgroups at row tile 128, output tile stored by TMA, "
          f"persistent grid): {k3_plan}; ptxas {k3_ptxas}", flush=True)

    # the main path: runs (i), (ii), (iii), (iv), counts zeroed before, read after
    t0 = time.perf_counter()
    rtol, atol = FFN_TOL
    runs = {"i": (x, {"block_m": 128}), "ii": (x, {"block_m": 128, "fuse_gelu": True}),
            "iii": (x, {"block_m": 16}), "iv": (x_small, {"block_m": 16})}
    wants = {"i": want, "ii": want, "iii": want, "iv": want_small}
    want_launches = {"i": (2, 0), "ii": (2, 0), "iii": (1, 1), "iv": (1, 1)}
    outs, counts, errs = {}, {}, {}
    for run, (xin, kw) in runs.items():
        torch.cuda.synchronize()
        _zero_counts()
        y = ffn.ffn_forward_kernels(pparams, xin, cfg, **kw)
        torch.cuda.synchronize()
        c = _read_counts()
        counts[run] = (c["bsmm"], c["bsmm_resident"])
        _expect_launches(run, counts[run], want_launches[run])
        w = wants[run]
        err = _check_close(f"ffn run {run} {kw}", y.float(), w, rtol, atol)
        big = w.abs() >= atol
        rel = float(((y.float() - w).abs()[big] / w.abs()[big]).max())
        outs[run], errs[run] = y, {"max_abs_err": err, "max_rel_err": rel}
    if not torch.equal(outs["i"], outs["iii"]):
        raise RuntimeError("ffn runs (i) and (iii) differ: the kernels' bits depend on block_m")
    # (iv) against kernel 3 at block_m 128 on the same x (outside the counted run)
    if not torch.equal(outs["iv"], ffn.ffn_forward_kernels(pparams, x_small, cfg, block_m=128)):
        raise RuntimeError("ffn run (iv) differs from kernel 3 at block_m 128 on its x")
    peak = torch.cuda.max_memory_allocated()
    _phase("ffn", t0, f"main path: (i) block_m 128, (ii) fused gelu, (iii) block_m 16, "
           f"resident gate, (iv) x {tuple(x_small.shape)} at block_m 16: (bsmm, "
           f"bsmm_resident) launches {counts}; each == plain float32 forward within rtol "
           f"{rtol}, atol {atol}: {errs} (rel over |want| >= {atol}); (i) == (iii) and "
           f"(iv) == block_m 128 on its x, bit for bit; peak device memory "
           f"{peak / 2**30:.3f} GiB (the plain float32 forward included)")
    del outs

    t0 = time.perf_counter()
    xf = x.reshape(-1, cfg.d_model)
    h = cuda_bsmm.gelu(cuda_bsmm.bsmm(xf, w1["rows"], w1["tiles"]))
    flush = torch.empty(2 * L2_BYTES // 4, dtype=torch.float32, device=DEVICE)
    mm1, mm2 = (xf, w1["rows"], w1["tiles"]), (h, w2["rows"], w2["tiles"])
    t = {}
    t["k3_mm1"] = _median_ms(lambda: cuda_bsmm.bsmm(*mm1, block_m=128), flush)
    t["k3_mm1_gelu"] = _median_ms(lambda: cuda_bsmm.bsmm(*mm1, block_m=128, fuse_gelu=True),
                                  flush)
    t["k3_mm2"] = _median_ms(lambda: cuda_bsmm.bsmm(*mm2, block_m=128), flush)
    t["k4_mm1"] = _median_ms(lambda: cuda_bsmm.bsmm_resident(*mm1, block_m=16), flush)
    # kernel 4's variants: each ring depth alone, each cluster, the stream without products
    k4_variants = {f"k4_mm1_s{st}_c1": {"stages": st, "cluster": 1}
                   for st in range(2, layout.stages + 1)}
    for c in k4_plan[m_full]["clusters_allowed"]:
        k4_variants[f"k4_mm1_s{layout.stages}_c{c}"] = {"stages": layout.stages, "cluster": c}
        k4_variants[f"k4_mm1_stream_c{c}"] = {"stages": layout.stages, "cluster": c,
                                              "stream_only": True}
    for name, kw in k4_variants.items():
        t[name] = _median_ms(
            lambda kw=kw: cuda_bsmm._launch(*mm1, 16, False, resident=True, **kw), flush)
    t["k3_mm2_16"] = _median_ms(lambda: cuda_bsmm.bsmm(*mm2, block_m=16), flush)
    # the launch block_m 16 took before row_tile: 16-row blocks
    t["k3_mm2_br16"] = _median_ms(
        lambda: cuda_bsmm._launch(*mm2, 16, False, resident=False, br=16), flush)
    xs = x_small.reshape(-1, cfg.d_model)
    hs = cuda_bsmm.gelu(cuda_bsmm.bsmm(xs, w1["rows"], w1["tiles"], block_m=16))
    mm1s, mm2s = (xs, w1["rows"], w1["tiles"]), (hs, w2["rows"], w2["tiles"])
    t["k4_mm1_small"] = _median_ms(lambda: cuda_bsmm.bsmm_resident(*mm1s, block_m=16), flush)
    t["k3_mm2_small"] = _median_ms(lambda: cuda_bsmm.bsmm(*mm2s, block_m=16), flush)
    for run, (xin, kw) in runs.items():
        t[f"fwd_{run}"] = _median_ms(
            lambda: ffn.ffn_forward_kernels(pparams, xin, cfg, **kw), flush)
    t["plain_mm1"] = _median_ms(lambda: cuda_bsmm.bsmm_ref(*mm1), flush)
    t["plain_mm2"] = _median_ms(lambda: cuda_bsmm.bsmm_ref(*mm2), flush)
    t["plain_fwd"] = _median_ms(lambda: ffn.ffn_forward(params32, x.float(), cfg), flush)
    err = {"bsmm": max(_check_close("bsmm matmul 1 at full width", t["k3_mm1"][2],
                                    t["plain_mm1"][2], *BSMM_TOL[torch.bfloat16]),
                       _check_close("bsmm matmul 2 at full width", t["k3_mm2"][2],
                                    t["plain_mm2"][2], *BSMM_TOL[torch.bfloat16])),
           "bsmm_resident": _check_close("bsmm_resident matmul 1 at full width",
                                         t["k4_mm1"][2], t["plain_mm1"][2],
                                         *BSMM_TOL[torch.bfloat16])}
    if not torch.equal(t["k4_mm1"][2], t["k3_mm1"][2]):
        raise RuntimeError("bsmm_resident != bsmm on matmul 1 at full width")
    for name, kw in k4_variants.items():
        if not kw.get("stream_only") and not torch.equal(t[name][2], t["k3_mm1"][2]):
            raise RuntimeError(f"bsmm_resident {kw} != bsmm on matmul 1 at full width")
    if not torch.equal(t["k3_mm2_16"][2], t["k3_mm2"][2]):
        raise RuntimeError("bsmm at block_m 16 != block_m 128 on matmul 2 at full width")
    brs = _same_at_row_tiles("bsmm matmul 2 at full width", t["k3_mm2"][2], *mm2)
    _same_at_row_tiles(f"bsmm matmul 2 at M = {xs.shape[0]}", t["k3_mm2_small"][2], *mm2s)
    err_small = {
        "bsmm": _check_close(f"bsmm matmul 2 at M = {xs.shape[0]}", t["k3_mm2_small"][2],
                             cuda_bsmm.bsmm_ref(*mm2s), *BSMM_TOL[torch.bfloat16]),
        "bsmm_resident": _check_close(f"bsmm_resident matmul 1 at M = {xs.shape[0]}",
                                      t["k4_mm1_small"][2], cuda_bsmm.bsmm_ref(*mm1s),
                                      *BSMM_TOL[torch.bfloat16])}
    if not torch.equal(t["k4_mm1_small"][2], cuda_bsmm.bsmm(*mm1s, block_m=xs.shape[0])):
        raise RuntimeError(f"bsmm_resident != bsmm on matmul 1 at M = {xs.shape[0]}")
    err = {name: max(e, err_small[name]) for name, e in err.items()}
    k3_variants = {
        "mm1": _k3_variant_times("bsmm matmul 1 at full width", mm1, t["k3_mm1"][2], flush),
        "mm2": _k3_variant_times("bsmm matmul 2 at full width", mm2, t["k3_mm2"][2], flush)}
    del want
    w1_dense = _dense(params["w1"]["rows"], params["w1"]["tiles"], cfg.nb_model, cfg.nb_ff, True)
    w2_dense = _dense(params["w2"]["cols"], params["w2"]["tiles"], cfg.nb_ff, cfg.nb_model, False)
    t["lib_mm1"] = _median_ms(lambda: torch.matmul(xf, w1_dense), flush)
    t["lib_mm2"] = _median_ms(lambda: torch.matmul(h, w2_dense), flush)
    t["lib_mm1_small"] = _median_ms(lambda: torch.matmul(xs, w1_dense), flush)
    t["lib_mm2_small"] = _median_ms(lambda: torch.matmul(hs, w2_dense), flush)
    # a check that W1_dense is W1: cuBLAS may reduce in bf16 (split-K), so
    # the FFN tolerance, not the one-ulp one
    lib_err = _check_close("x @ W1_dense against bsmm", t["lib_mm1"][2], t["k3_mm1"][2],
                           *FFN_TOL)
    del w1_dense, w2_dense, flush
    # W1: the distinct x block-rows its lists name; W2: every block-row of h
    # owns cpc real tiles (the pad tiles are not work)
    b1 = _bsmm_bound(xf, len(torch.unique(w1["rows"])), w1["rows"].numel(), cfg.nb_ff, cfg.k)
    b2 = _bsmm_bound(h, cfg.nb_ff, params["w2"]["cols"].numel(), cfg.nb_model, cfg.k)
    b1s = _bsmm_bound(xs, len(torch.unique(w1["rows"])), w1["rows"].numel(), cfg.nb_ff, cfg.k)
    b2s = _bsmm_bound(hs, cfg.nb_ff, params["w2"]["cols"].numel(), cfg.nb_model, cfg.k)
    ms = {name: v[0] for name, v in t.items()}
    ms_runs = {name: v[1] for name, v in t.items()}
    _phase("ffn", t0, f"medians of {KERNEL_REPEATS} (ms): {ms}; runs {ms_runs}; bound "
           f"matmul 1 {b1['bound_ms']:.6f} ms ({b1['bound_by']}: {b1['flops'] / 1e9:.3f} "
           f"GFLOP -> {b1['ops_ms']:.6f} ms, {b1['bytes'] / 1e6:.3f} MB -> "
           f"{b1['bytes_ms']:.6f} ms), matmul 2 {b2['bound_ms']:.6f} ms ({b2['bound_by']}: "
           f"{b2['flops'] / 1e9:.3f} GFLOP, {b2['bytes'] / 1e6:.3f} MB); at M = "
           f"{xs.shape[0]}: bound matmul 1 {b1s['bound_ms']:.6f} ms ({b1s['bound_by']}), "
           f"matmul 2 {b2s['bound_ms']:.6f} ms ({b2s['bound_by']}); kernels vs bsmm_ref max "
           f"abs err {err}, x @ W1_dense vs bsmm {lib_err}; kernel 4 == kernel 3 on matmul 1 "
           f"at both sizes, kernel 3 on matmul 2 the same bits at row tiles {brs} and at "
           f"block_m 16 and 128; kernel 3's variants (ms, each but the streams bit-equal to "
           f"its default) {k3_variants}")

    launches = {run: {"bsmm": c[0], "bsmm_resident": c[1]} for run, c in counts.items()}
    common = {"route": "cuda", "source": "spgemm_tpu_torch/csrc/bsmm.cu", "equal_3_4": True,
              "library_call": "torch.matmul in bf16 of x by the dense W (built outside the "
                              "window)", "ffn_errors": errs, "ffn_wall_ms": {
                  run: ms[f"fwd_{run}"] for run in runs}, "ffn_plain_ms": ms["plain_fwd"],
              "peak_bytes": peak, "small_m": xs.shape[0], "geometry": geometry}
    stream_row = {
        "name": "bsmm", "replaces": "spgemm_tpu/ops/pallas_bsmm.py:57",
        "launches": sum(c[0] for c in counts.values()),
        "launches_by_run": {run: v["bsmm"] for run, v in launches.items()},
        "max_abs_err": err["bsmm"], "ms": ms["k3_mm1"] + ms["k3_mm2"],
        "plain_ms": ms["plain_mm1"] + ms["plain_mm2"],
        "bound_ms": b1["bound_ms"] + b2["bound_ms"],
        "bound_by": b1["bound_by"] if b1["bound_ms"] >= b2["bound_ms"] else b2["bound_by"],
        "library_ms": ms["lib_mm1"] + ms["lib_mm2"],
        "timed_on": "both matmuls of the full-width FFN forward, block_m 128",
        "redesigned": "TMA-fed ring of x blocks and tiles, producer warp, wgmma warpgroups, "
                      "persistent grid, output tile stored by TMA",
        "plan": k3_plan, "ptxas": k3_ptxas, "variants_ms": k3_variants,
        "ms_by_matmul": {"mm1": ms["k3_mm1"], "mm1_gelu": ms["k3_mm1_gelu"],
                         "mm2": ms["k3_mm2"], "mm2_block_m16": ms["k3_mm2_16"],
                         "mm2_row_tile_16": ms["k3_mm2_br16"],
                         "mm2_small_m_block_m16": ms["k3_mm2_small"]},
        "bound_by_matmul": {"mm1": b1, "mm2": b2, "mm2_small_m": b2s},
        "plain_ms_by_matmul": {"mm1": ms["plain_mm1"], "mm2": ms["plain_mm2"]},
        "library_ms_by_matmul": {"mm1": ms["lib_mm1"], "mm2": ms["lib_mm2"],
                                 "mm2_small_m": ms["lib_mm2_small"]}, **common}
    resident_row = {
        "name": "bsmm_resident", "replaces": "spgemm_tpu/ops/pallas_bsmm.py:104",
        "launches": sum(c[1] for c in counts.values()),
        "launches_by_run": {run: v["bsmm_resident"] for run, v in launches.items()},
        "max_abs_err": err["bsmm_resident"], "ms": ms["k4_mm1"], "plain_ms": ms["plain_mm1"],
        "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"], "library_ms": ms["lib_mm1"],
        "timed_on": "matmul 1 of the full-width FFN forward, block_m 16",
        "redesigned": "TMA-fed tile ring, producer warp, cluster multicast",
        "stages": layout.stages, "cluster": k4_plan[m_full]["cluster"],
        "smem_bytes": layout.total, "max_active_clusters": active, "ptxas": k4_ptxas,
        "variants_ms": {name: ms[name] for name in k4_variants},
        "ms_small_m": ms["k4_mm1_small"], "bound_small_m": b1s,
        "library_ms_small_m": ms["lib_mm1_small"], **common}
    return [stream_row, resident_row]


def _grad_err(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Max abs error over the largest |entry| of want, and the norm of the
    difference over want's."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise RuntimeError("non-finite gradient")
    return {"max_over_scale": float((g - w).abs().max()) / float(w.abs().max()),
            "norm_rel": float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))}


def _check_scaled(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """_check_close at GRAD_KERNEL_TOL, the absolute floor scaled by want's
    largest |entry|; returns the max abs error."""
    rtol, frac = GRAD_KERNEL_TOL
    return _check_close(what, got, want, rtol, frac * float(want.float().abs().max()))


def _wgrad_bound(a: torch.Tensor, b: torch.Tensor, ia: torch.Tensor, ib: torch.Tensor,
                 k: int) -> dict:
    """Kernel 5's least time: 2 M P k^2 flops on the bf16 tensor cores,
    against the strips of a and b its pairs name, each read once, and its
    tiles written once."""
    M, P, es = a.shape[0], ia.numel(), a.element_size()
    flops = 2 * M * P * k * k
    nbytes = ((len(torch.unique(ia)) + len(torch.unique(ib))) * M * k + P * k * k) * es
    ops_ms, bytes_ms = flops / BF16_TENSOR_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = _bound(ops_ms, bytes_ms)
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _strips(t: torch.Tensor, idx: torch.Tensor, k: int, transpose: bool) -> torch.Tensor:
    """The k-wide column strips idx of t (M, n*k) stacked for torch.bmm:
    (P, k, M) transposed, else (P, M, k)."""
    g = t.reshape(t.shape[0], -1, k)[:, idx.long()]   # (M, P, k)
    return (g.permute(1, 2, 0) if transpose else g.permute(1, 0, 2)).contiguous()


def _k5_plan(a: torch.Tensor, ia: torch.Tensor, k: int, runs: dict) -> dict:
    """Kernel 5's launch on one full-width gradient with its run options:
    body, form, run length, rows a stage, ring depth, shared memory, grid
    (cuda_bsmm_grad.launch_plan with the card's occupancy), and the strip
    bytes it streams into shared memory against one tile a block's."""
    dev = torch.cuda.current_device()
    M, P = a.shape[0], ia.shape[0]
    shared_b = int(runs["shared"] == "b")
    plan = cuda_bsmm_grad.launch_plan(M, P, k, a.dtype, runs["run"], resident=lambda f, bm, s, g: (
        cuda_bsmm_grad.wgrad_resident(f, bm, s, g, shared_b, dev)))
    es = a.element_size()
    return {**plan, "strip_bytes": cuda_bsmm_grad.strip_bytes(
                M, P, k, plan.get("form", "tile"), plan.get("group", 1), es),
            "strip_bytes_one_tile": cuda_bsmm_grad.strip_bytes(M, P, k, "tile", 1, es)}


def _k5_variants(run: int) -> dict:
    """name -> cuda_bsmm_grad._launch keywords of kernel 5's variants on one
    gradient with runs of `run`: the mma.sync body (the first body), the
    wgmma body one tile a block (also at bm 64 and a block a tile) and over
    half a run (also at 3 stages), and the strip stream alone (stream_only)
    of each form and of the mma.sync body."""
    out = {"mma_sync": {"body": "mma_sync"}, "tile": {"form": "tile"},
           "tile_bm64": {"form": "tile", "bm": 64}, "tile_per_tile": {"form": "tile",
                                                                    "persistent": False}}
    forms = ["tile"]
    if run in cuda_bsmm_grad.WGRAD_GROUPS:
        forms.append("half")
        out["half"] = {"form": "half"}
        out["half_s3"] = {"form": "half", "stages": 3}
    for form in forms:
        out[f"stream_{form}"] = {"form": form, "stream_only": True}
    out["stream_mma_sync"] = {"body": "mma_sync", "stream_only": True}
    return out


def _k5_variant_times(what: str, args: tuple, k: int, runs: dict, want: torch.Tensor,
                      flush: torch.Tensor) -> dict:
    """Each of _k5_variants' launches of kernel 5 on args (a, b, ia, ib) with
    its run options timed (median ms, _median_ms), each but the streams
    bit-equal to want, the default launch's output."""
    out = {}
    for name, kw in _k5_variants(runs["run"]).items():
        ms, _, got = _median_ms(lambda kw=kw: cuda_bsmm_grad._launch(*args, k, **runs, **kw),
                                flush)
        if not kw.get("stream_only") and not torch.equal(got, want):
            raise RuntimeError(f"{what}: kernel 5 {kw} gives other bits than its default launch")
        out[name] = ms
    return out


def phase_ffn_train() -> list[dict]:
    t0 = time.perf_counter()
    cfg = FFN_CFG
    gen = torch.Generator().manual_seed(SEED + 2)
    params = ffn.init_params(cfg, gen, device=DEVICE)
    x = torch.randn((FFN_BATCH, FFN_SEQ, cfg.d_model), generator=gen).to(DEVICE, torch.bfloat16)
    target = torch.randn((FFN_BATCH, FFN_SEQ, cfg.d_model), generator=gen).to(
        DEVICE, torch.bfloat16)
    params32 = {name: {key: t.float() if t.is_floating_point() else t for key, t in w.items()}
                for name, w in params.items()}
    # the limits' basis: the plain step in bf16 against the plain step in float32
    loss32, g32 = ffn.loss_and_grads_ref(params32, x.float(), target.float(), cfg)
    loss_p, g_p = ffn.loss_and_grads_ref(params, x, target, cfg)
    plain_vs_f32 = {"loss_rel": abs(float(loss_p) - float(loss32)) / float(loss32),
                    **{name: _grad_err(g_p[name], g32[name]) for name in ("w1", "w2")}}
    del loss_p, g_p
    torch.cuda.empty_cache()
    _phase("ffn-train", t0, f"x and target {tuple(x.shape)} bf16, lr {FFN_TRAIN_LR}; the plain "
           f"step in bf16 against float32 (the limits' basis): {plain_vs_f32}; limits: loss "
           f"rtol {FFN_TRAIN_LOSS_RTOL}, each gradient {FFN_TRAIN_GRAD_TOL} of its largest "
           f"|entry|")

    # the main path: FFN_TRAIN_STEPS steps at block_m 128, one at block_m 16,
    # each with the counts zeroed before and read after, against the plain step
    t0 = time.perf_counter()
    mesh = train_mesh(device=DEVICE)
    steps = {bm: ffn.make_sharded_train_step(mesh, cfg, lr=FFN_TRAIN_LR, block_m=bm)
             for bm in (128, 16)}
    # (bsmm, bsmm_resident, bsmm_wgrad) a step: forward 2 + dgrad 1 on kernel 3
    # or 4 as the resident gate picks (at full width: all kernel 3 at block_m
    # 128; kernel 4 for matmul 1 and the dgrad at 16), kernel 5 twice
    want_counts = {}
    for bm in (128, 16):
        res = sum(cuda_bsmm.resident_panel_fits(d_in, bm, x.element_size(), cfg.k)
                  for d_in in (cfg.d_model, cfg.d_ff, cfg.d_model))
        want_counts[bm] = (3 - res, res, 2)
    p_k = p_p = params
    per_step, counts, vs_f32 = [], [], None
    for i, bm in enumerate([128] * FFN_TRAIN_STEPS + [16]):
        torch.cuda.synchronize()
        _zero_counts()
        loss_k, g_k = steps[bm].loss_and_grads(p_k, x, target)
        new_k = ffn.sgd(p_k, g_k, FFN_TRAIN_LR)
        torch.cuda.synchronize()
        c = _read_counts()
        got = (c["bsmm"], c["bsmm_resident"], c["bsmm_wgrad"])
        if got != want_counts[bm]:
            raise RuntimeError(f"ffn-train step {i + 1} (block_m {bm}): (bsmm, bsmm_resident, "
                               f"bsmm_wgrad) launches {got}, want {want_counts[bm]}")
        counts.append({"block_m": bm, "bsmm": got[0], "bsmm_resident": got[1],
                       "bsmm_wgrad": got[2]})
        loss_p, g_p = ffn.loss_and_grads_ref(p_p, x, target, cfg)
        new_p = ffn.sgd(p_p, g_p, FFN_TRAIN_LR)
        errs = {"block_m": bm, "loss": float(loss_k), "plain_loss": float(loss_p),
                "loss_rel": abs(float(loss_k) - float(loss_p)) / float(loss_p),
                **{name: _grad_err(g_k[name], g_p[name]) for name in ("w1", "w2")}}
        if i == 0:
            vs_f32 = {"loss_rel": abs(float(loss_k) - float(loss32)) / float(loss32),
                      **{name: _grad_err(g_k[name], g32[name]) for name in ("w1", "w2")}}
        if not np.isfinite(errs["loss"]) or errs["loss_rel"] > FFN_TRAIN_LOSS_RTOL or any(
                errs[name]["max_over_scale"] > FFN_TRAIN_GRAD_TOL for name in ("w1", "w2")):
            raise RuntimeError(f"ffn-train step {i + 1}: the kernel step against the plain one "
                               f"beyond the limits: {errs}")
        errs["tiles_differing"] = {
            name: int((new_k[name]["tiles"] != new_p[name]["tiles"]).sum()) for name in ("w1", "w2")}
        errs["tiles_moved"] = {
            name: int((new_k[name]["tiles"] != p_k[name]["tiles"]).sum()) for name in ("w1", "w2")}
        per_step.append(errs)
        p_k, p_p = new_k, new_p
    del g32, loss32, params32
    torch.cuda.empty_cache()
    # the step's forward gives the forward's bits (kernels 3 and 4 unchanged)
    xf = x.reshape(-1, cfg.d_model)
    index = steps[128].index(params)
    w1t, w2t_rm = params["w1"]["tiles"], params["w2"]["tiles"]
    pparams = ffn.prepare_kernel_params(params, cfg)
    with torch.no_grad():
        for bm in (128, 16):
            y_step = ffn._KernelFFN.apply(xf, w1t, w2t_rm, index, bm, None)
            if not torch.equal(y_step.reshape(x.shape), ffn.ffn_forward_kernels(
                    pparams, x, cfg, block_m=bm)):
                raise RuntimeError(f"ffn-train: the step's forward at block_m {bm} differs from "
                                   f"ffn_forward_kernels'")
    del y_step
    _phase("ffn-train", t0, f"main path: {FFN_TRAIN_STEPS} steps at block_m 128 and 1 at "
           f"block_m 16 through make_sharded_train_step on a 1 x 1 mesh, launches {counts}; "
           f"against the plain autograd step each: {per_step}; step 1 against float32: "
           f"{vs_f32}; the step's forward equals ffn_forward_kernels' bits at block_m 128 "
           f"and 16")

    # the backward's kernels alone, on the step's own operands; zeroing 8 x L2
    # before each launch outlasts the launch's host work, so no idle gap
    # before the kernel falls inside the timed window
    t0 = time.perf_counter()
    k, M = cfg.k, xf.shape[0]
    flush = torch.empty(8 * L2_BYTES // 4, dtype=torch.float32, device=DEVICE)
    pre = cuda_bsmm.bsmm(xf, index.rows1, w1t)
    h = cuda_bsmm.gelu(pre)
    y_pred = cuda_bsmm.bsmm(h, index.rows2, cuda_bsmm.gather_column_major(w2t_rm,
                                                                          index.tile_idx2))
    dy = (2 * (y_pred.float() - target.reshape(M, -1).float()) / y_pred.numel()).to(
        torch.bfloat16)
    del y_pred
    w2t = w2t_rm.transpose(-1, -2).contiguous()
    dgrad = (dy, index.cols2, w2t)
    t = {}
    t["dgrad_k3"] = _median_ms(lambda: cuda_bsmm.bsmm(*dgrad, gelu_grad=pre), flush)
    t["dgrad_k4"] = _median_ms(
        lambda: cuda_bsmm.bsmm_resident(*dgrad, block_m=16, gelu_grad=pre), flush)
    t["dgrad_plain"] = _median_ms(lambda: cuda_bsmm.bsmm_ref(*dgrad, gelu_grad=pre), flush)
    dpre = t["dgrad_k3"][2]
    if not torch.equal(t["dgrad_k4"][2], dpre):
        raise RuntimeError("ffn-train: the dgrad on kernel 4 != kernel 3")
    dgrad_plan = _k3_plan(M, cfg.nb_ff, k, 2)
    dgrad_variants = _k3_variant_times("ffn-train dgrad", dgrad, dpre, flush, gelu_grad=pre)
    dgrad_ptxas = _ptxas_report()["bsmm_gelu_grad"]
    print(f"[ffn-train] the dgrad on kernel 3 (the gelu_grad instance): {dgrad_plan}; ptxas "
          f"{dgrad_ptxas}; variants (ms, each but the streams bit-equal to its default) "
          f"{dgrad_variants}", flush=True)
    err_dgrad = _check_scaled("ffn-train dgrad (kernel 3, gelu_grad)", dpre, t["dgrad_plain"][2])
    dw1 = (xf, dpre, index.ia1, index.ib1)
    dw2 = (h, dy, index.ia2, index.ib2)
    # the step's own calls: with the run options StepIndex gives
    runs = {"dw1": {"run": index.run1, "shared": index.shared1},
            "dw2": {"run": index.run2, "shared": index.shared2}}
    t["dw1"] = _median_ms(lambda: cuda_bsmm_grad.bsmm_wgrad(*dw1, k=k, **runs["dw1"]), flush)
    t["dw2"] = _median_ms(lambda: cuda_bsmm_grad.bsmm_wgrad(*dw2, k=k, **runs["dw2"]), flush)
    k5_plan = {name: _k5_plan(args[0], args[2], k, runs[name])
               for name, args in (("dw1", dw1), ("dw2", dw2))}
    k5_variants = {name: _k5_variant_times(f"ffn-train {name}", args, k, runs[name],
                                           t[name][2], flush)
                   for name, args in (("dw1", dw1), ("dw2", dw2))}
    k5_ptxas = {body: _ptxas_report()[name] for body, name in (
        ("wgmma", "bsmm_wgrad"), ("mma_sync", "bsmm_wgrad_mma_sync"))}
    print(f"[ffn-train] kernel 5: plans {k5_plan}; ptxas {k5_ptxas}; variants (ms, each but "
          f"the streams bit-equal to its default) {k5_variants}", flush=True)
    t["dw1_plain"] = _median_ms(lambda: cuda_bsmm_grad.bsmm_wgrad_ref(*dw1, k=k), flush)
    t["dw2_plain"] = _median_ms(lambda: cuda_bsmm_grad.bsmm_wgrad_ref(*dw2, k=k), flush)
    err_wgrad = max(_check_scaled("ffn-train dW1 (kernel 5)", t["dw1"][2], t["dw1_plain"][2]),
                    _check_scaled("ffn-train dW2 (kernel 5)", t["dw2"][2], t["dw2_plain"][2]))
    b_dw1, b_dw2 = _wgrad_bound(*dw1, k), _wgrad_bound(*dw2, k)
    # the product alone in one PyTorch call: torch.bmm of the pre-gathered
    # strips (a check that the strips are kernel 5's: cuBLAS may split the sum)
    lib_err = 0.0
    for name, (a, b, ia, ib) in (("dw1", dw1), ("dw2", dw2)):
        sa, sb = _strips(a, ia, k, True), _strips(b, ib, k, False)
        t[f"{name}_lib"] = _median_ms(lambda: torch.bmm(sa, sb), flush)
        lib_err = max(lib_err, _check_scaled(f"ffn-train {name}: torch.bmm against kernel 5",
                                             t[f"{name}_lib"][2], t[name][2]))
        del sa, sb
    w2_dense = _dense(params["w2"]["cols"], w2t_rm, cfg.nb_ff, cfg.nb_model, False)
    t["dgrad_lib"] = _median_ms(lambda: torch.matmul(dy, w2_dense.t()), flush)
    del w2_dense
    b_dgrad = _bsmm_bound(dy, len(torch.unique(index.cols2)), index.cols2.numel(), cfg.nb_ff, k)
    pre_bytes = pre.numel() * pre.element_size()  # the epilogue's read of pre
    b_dgrad = {**b_dgrad, "bytes": b_dgrad["bytes"] + pre_bytes,
               "bytes_ms": b_dgrad["bytes_ms"] + pre_bytes / HBM_BYTES_PER_S * 1e3}
    b_dgrad["bound_ms"], b_dgrad["bound_by"] = _bound(b_dgrad["ops_ms"], b_dgrad["bytes_ms"])
    # the whole step, kernels against the plain autograd step
    t["step"] = _median_ms(lambda: steps[128](params, x, target), flush)
    t["step_16"] = _median_ms(lambda: steps[16](params, x, target), flush)
    t["step_plain"] = _median_ms(
        lambda: ffn.train_step_ref(params, x, target, cfg, FFN_TRAIN_LR), flush)
    # the step's least time: its five products (2 forward, the dgrad, 2 weight
    # gradients) on the tensor cores, against x, the target and the tiles
    # read and the tiles written once
    real = index.ia1.numel() + 3 * index.ia2.numel()   # mm1 and dW1; mm2, dgrad, dW2
    step_flops = 2 * M * k * k * (index.ia1.numel() + real)
    tile_bytes = sum(params[w]["tiles"].numel() for w in ("w1", "w2")) * 2
    step_bytes = 2 * x.numel() * 2 + 2 * tile_bytes
    step_bound, step_bound_by = _bound(step_flops / BF16_TENSOR_FLOPS * 1e3,
                                       step_bytes / HBM_BYTES_PER_S * 1e3)
    ms = {name: v[0] for name, v in t.items()}
    _phase("ffn-train", t0, f"medians of {KERNEL_REPEATS} (ms): {ms}; runs "
           f"{ {name: v[1] for name, v in t.items()} }; bounds: dW1 {b_dw1['bound_ms']:.6f} ms "
           f"({b_dw1['bound_by']}: {b_dw1['flops'] / 1e9:.3f} GFLOP -> {b_dw1['ops_ms']:.6f} ms, "
           f"{b_dw1['bytes'] / 1e6:.3f} MB -> {b_dw1['bytes_ms']:.6f} ms), dW2 "
           f"{b_dw2['bound_ms']:.6f} ms ({b_dw2['bound_by']}), dgrad {b_dgrad['bound_ms']:.6f} "
           f"ms ({b_dgrad['bound_by']}: {b_dgrad['flops'] / 1e9:.3f} GFLOP, "
           f"{b_dgrad['bytes'] / 1e6:.3f} MB), the step {step_bound:.6f} ms ({step_bound_by}: "
           f"{step_flops / 1e9:.3f} GFLOP, {step_bytes / 1e6:.3f} MB); against the plain "
           f"versions: dgrad {err_dgrad}, kernel 5 {err_wgrad}; torch.bmm against kernel 5 "
           f"{lib_err}; the dgrad on kernel 4 == kernel 3")
    del flush, pre, h, dy, dpre, w2t
    torch.cuda.empty_cache()

    launches = {name: sum(c[name] for c in counts) for name in ("bsmm", "bsmm_resident",
                                                                 "bsmm_wgrad")}
    # the dgrad's kernel in each step: kernel 4 where its panel (d_in d_model) fits
    dgrad_launches = {"bsmm": 0, "bsmm_resident": 0}
    for c in counts:
        fits = cuda_bsmm.resident_panel_fits(cfg.d_model, c["block_m"], 2, cfg.k)
        dgrad_launches["bsmm_resident" if fits else "bsmm"] += 1
    train = {"steps": per_step, "launches_by_step": counts, "plain_vs_f32": plain_vs_f32,
             "kernel_vs_f32": vs_f32, "limits": {"loss_rtol": FFN_TRAIN_LOSS_RTOL,
                                                 "grad_max_over_scale": FFN_TRAIN_GRAD_TOL},
             "step_ms": ms["step"], "step_ms_block_m16": ms["step_16"],
             "plain_step_ms": ms["step_plain"], "step_bound_ms": step_bound,
             "step_bound_by": step_bound_by, "lr": FFN_TRAIN_LR}
    wgrad_row = {
        "name": "bsmm_wgrad", "route": "cuda", "source": "spgemm_tpu_torch/csrc/bsmm_grad.cu",
        "replaces": "spgemm_tpu/models/ffn.py:204",
        "replaces_what": "XLA's weight-gradient transposes of bsmm_gather / bsmm_scatter "
                         "(ffn.py:85,94) under jax.value_and_grad; no Pallas kernel",
        "launches": launches["bsmm_wgrad"], "max_abs_err": err_wgrad,
        "ms": ms["dw1"] + ms["dw2"], "plain_ms": ms["dw1_plain"] + ms["dw2_plain"],
        "bound_ms": b_dw1["bound_ms"] + b_dw2["bound_ms"],
        "bound_by": b_dw1["bound_by"] if b_dw1["bound_ms"] >= b_dw2["bound_ms"]
        else b_dw2["bound_by"],
        "library_ms": ms["dw1_lib"] + ms["dw2_lib"],
        "library_call": "torch.bmm in bf16 of the pre-gathered strips (the product alone)",
        "timed_on": f"both weight gradients of one full-width step: dW1 (x against dpre) and "
                    f"dW2 (h against dy), {index.ia1.numel()} tiles each, M {M}, with the "
                    f"step's run options (runs of {index.run1} sharing dpre's strip, of "
                    f"{index.run2} sharing h's)",
        "ms_by_call": {"dw1": ms["dw1"], "dw2": ms["dw2"]},
        "bound_by_call": {"dw1": b_dw1, "dw2": b_dw2},
        "library_ms_by_call": {"dw1": ms["dw1_lib"], "dw2": ms["dw2_lib"]},
        "plan": k5_plan, "variants_ms": k5_variants,
        "stream_ms": {name: v[f"stream_{k5_plan[name].get('form', 'tile')}"]
                      for name, v in k5_variants.items()},
        "ptxas": k5_ptxas["wgmma"], "ptxas_mma_sync": k5_ptxas["mma_sync"], "train": train}
    dgrad_row = {
        "name": "bsmm_dgrad", "route": "cuda", "source": "spgemm_tpu_torch/csrc/bsmm.cu",
        "replaces": "spgemm_tpu/models/ffn.py:204",
        "replaces_what": "XLA's transpose of bsmm_scatter (ffn.py:94) and of the gelu under "
                         "jax.value_and_grad: kernels 3 and 4 with the gelu_grad epilogue",
        "launches": launches["bsmm"] + launches["bsmm_resident"] - 2 * len(counts),
        "launches_by_kernel": dgrad_launches,
        "forward_launches": {name: launches[name] - dgrad_launches[name]
                             for name in ("bsmm", "bsmm_resident")},
        "max_abs_err": err_dgrad, "ms": ms["dgrad_k3"], "ms_resident": ms["dgrad_k4"],
        "plain_ms": ms["dgrad_plain"], "bound_ms": b_dgrad["bound_ms"],
        "bound_by": b_dgrad["bound_by"], "bound": b_dgrad, "library_ms": ms["dgrad_lib"],
        "library_call": "torch.matmul in bf16 of dy by the dense W2^T (the product alone, "
                        "without gelu')",
        "timed_on": "the full-width step's dgrad: kernel 3 at block_m 128 (the step's "
                    "default); ms_resident kernel 4 at block_m 16",
        "plan": dgrad_plan, "ptxas": dgrad_ptxas, "variants_ms": dgrad_variants,
        "ptxas_resident": _ptxas_report()["bsmm_resident_gelu_grad"], "train": train}
    return [wgrad_row, dgrad_row]


DELTA_EDIT_LEAF = 4    # M5, the A operand of level-1 multiply (4, 5)
DELTA_EDIT_ROWS = 11   # 1% of the Medium chain's 1111 tile rows
DELTA_LEVELS = (5, 2, 1, 1)  # multiplies per pass of a 10-matrix chain
DIGEST_PAIRS = 6       # row digests, one thread against the pool, in alternating order
WARM_MAX_MB = 16384    # the warm phase's budget: every entry of the chain stays


class TimedSplice:
    """cuda_splice.splice wrapped in CUDA events, counting the bytes the
    function must move (each output row read once, from prev or sub, and
    written once, plus the source map); with record on, each call's
    arguments and output are kept for the comparison with the plain
    version."""

    def __init__(self):
        self.events = []
        self.bytes = 0
        self.calls = []
        self.record = False

    def __call__(self, prev, sub, src):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = cuda_splice.splice(prev, sub, src)
        end.record()
        self.events.append((start, end))
        self.bytes += 2 * prev.nbytes + src.nbytes
        if self.record:
            self.calls.append((prev, sub, src, out))
        return out

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _edit_rows(m: BlockSparseMatrix, rows, rng) -> BlockSparseMatrix:
    """The same structure with new uniform values in every tile of the
    given tile-rows."""
    tiles = m.tiles.copy()
    mask = np.isin(m.coords[:, 0], np.asarray(rows, np.int64))
    tiles[mask] = rng.integers(0, 1 << 64, size=(int(mask.sum()), m.k, m.k), dtype=np.uint64)
    return BlockSparseMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords, tiles=tiles)


@contextlib.contextmanager
def _per_multiply():
    """Records (rows recomputed, rows total, full fallback) of each delta
    multiply, in chain order, from ENGINE's counters around the engine's
    _delta_execute."""
    real = engine._delta_execute
    log = []

    def wrapped(*args, **kw):
        names = ("delta_rows_recomputed", "delta_rows_total", "delta_full_fallbacks")
        before = [ENGINE.counters.get(n, 0) for n in names]
        out = real(*args, **kw)
        log.append(tuple(ENGINE.counters.get(n, 0) - b for n, b in zip(names, before)))
        return out

    engine._delta_execute = wrapped
    try:
        yield log
    finally:
        engine._delta_execute = real


def _by_level(log: list) -> list:
    """[(recomputed, total), ...] per pass of the chain."""
    out, i = [], 0
    for n in DELTA_LEVELS:
        part = log[i:i + n]
        out.append((sum(r for r, _, _ in part), sum(t for _, t, _ in part)))
        i += n
    return out


def _retained_bytes() -> int:
    """Bytes of the distinct device slabs the delta store holds."""
    seen = {}
    for _, entry in delta.entries():
        slab = entry.result.slab
        seen[slab.data_ptr()] = slab.nbytes
    return sum(seen.values())


def _chain_on(inputs, folds=engine.KERNELS, **env) -> tuple:
    """One chain from host leaves: (result, wall s)."""
    with _env(**env), contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = chain_product(inputs, device=DEVICE, keep_device=True, folds=folds)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0


def _splice_check(calls: list) -> dict:
    """The splice kernel against splice_ref on the recorded calls (a real
    submit's indices), and the kernel, the plain version and one PyTorch
    call (index_copy_ on a clone) timed over the same calls, medians of
    KERNEL_REPEATS; the bound is the bytes the function must move over HBM."""
    err, equal = 0, True
    for prev, sub, src, out in calls:
        ref = cuda_splice.splice_ref(prev, sub, src)
        equal &= torch.equal(out, ref)
        err = max(err, _u64_max_abs_err(out, ref))
    if not equal:
        raise RuntimeError(f"splice kernel != splice_ref on the delta submits (max abs err {err})")
    rows = [torch.nonzero(src >= 0).flatten() for _, _, src, _ in calls]

    def timed(fn) -> float:
        runs = []
        for _ in range(KERNEL_REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for i, (prev, sub, src, _) in enumerate(calls):
                fn(i, prev, sub, src)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end))
        return sorted(runs)[len(runs) // 2]

    # (the main path's counts were read before these comparison launches)
    ms = timed(lambda i, prev, sub, src: cuda_splice.splice(prev, sub, src))
    plain_ms = timed(lambda i, prev, sub, src: cuda_splice.splice_ref(prev, sub, src))
    lib_ms = timed(lambda i, prev, sub, src:
                   prev.clone().index_copy_(0, rows[i], sub[:len(rows[i])]))
    nbytes = sum(2 * prev.nbytes + src.nbytes for prev, _, src, _ in calls)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "calls": len(calls)}


def phase_delta(medium) -> dict:
    """[delta]: four submits of the Medium chain of distinct structures from
    host leaves in one process, SPGEMM_TPU_DELTA=1: (a) first contact, (b)
    unchanged, (c) DELTA_EDIT_ROWS contiguous tile rows of M5 given new
    values, (d) as many rows spread evenly.  Each result must equal the
    delta-off chain on the same inputs, whose walls are printed beside; the
    delta-off chains run first (plans cold for (a), warm after), then the
    counts are zeroed, the plan cache and delta store emptied, and the four
    submits run as the main path.  Then the splice kernel against
    splice_ref on the calls of (c) and (d), and the Medium chain of one
    structure submitted twice: the hits its shared keys allow."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 11)
    base = _distinct_mats(medium.mats)
    leaf = base[DELTA_EDIT_LEAF]
    n_rows = leaf.rows // leaf.k
    mid = n_rows // 2
    contiguous = np.arange(mid - DELTA_EDIT_ROWS // 2, mid - DELTA_EDIT_ROWS // 2 + DELTA_EDIT_ROWS)
    spread = np.linspace(0, n_rows - 1, DELTA_EDIT_ROWS).astype(np.int64)
    c_inputs = list(base)
    c_inputs[DELTA_EDIT_LEAF] = _edit_rows(leaf, contiguous, rng)
    d_inputs = list(c_inputs)
    d_inputs[DELTA_EDIT_LEAF] = _edit_rows(c_inputs[DELTA_EDIT_LEAF], spread, rng)
    submits = {"a": base, "b": base, "c": c_inputs, "d": d_inputs}
    plancache.clear()
    want, off = {}, {}
    for name, inputs in submits.items():
        want[name], off[name] = _chain_on(inputs, SPGEMM_TPU_DELTA="0")
    _phase("delta", t0, "delta off, host leaves: walls " + ", ".join(
        f"({n}) {w:.6f} s" for n, w in off.items()) + " (plans cold for (a), warm after)")
    t0 = time.perf_counter()
    modes = {"one thread": 1, "pool": None}
    runs = {label: [] for label in modes}
    wins = dict.fromkeys(modes, 0)
    for i in range(DIGEST_PAIRS):
        got = {}
        for label in (("one thread", "pool") if i % 2 == 0 else ("pool", "one thread")):
            t1 = time.perf_counter()
            for m in base:
                delta.row_digests(m.coords, m.tiles, workers=modes[label])
            got[label] = time.perf_counter() - t1
            runs[label].append(got[label])
        wins[min(got, key=got.get)] += 1
    digest_s = {label: sorted(rs)[len(rs) // 2] for label, rs in runs.items()}
    leaf_bytes = sum(m.tiles.nbytes for m in base)
    _phase("delta", t0, f"row digests of the {len(base)} host leaves "
           f"({leaf_bytes / 1e6:.0f} MB) alone, {DIGEST_PAIRS} pairs in alternating order: "
           f"one thread median {digest_s['one thread']:.6f} s, won {wins['one thread']}; a "
           f"pool of {os.cpu_count()} threads (the engine's default) median "
           f"{digest_s['pool']:.6f} s, won {wins['pool']}; runs " + "; ".join(
               f"{label} " + ", ".join(f"{r:.6f}" for r in rs) for label, rs in runs.items())
           + f"; load average {os.getloadavg()}")

    timed = TimedSplice()
    folds = Folds(splice=timed)
    plancache.clear()
    delta.clear()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    out = {}
    for name, inputs in submits.items():
        t1 = time.perf_counter()
        ENGINE.reset()  # the launch counters too: each submit is a main path
        timed.events = []
        timed.record = name in ("c", "d")
        before = _read_counts()
        with _per_multiply() as log:
            got, wall = _chain_on(inputs, folds=folds, SPGEMM_TPU_DELTA="1")
        after = _read_counts()
        if not _same(got, want[name]):
            raise RuntimeError(f"[delta] submit ({name}) differs from the delta-off chain")
        phases = ENGINE.snapshot()
        rec = {"wall_s": wall, "wall_off_s": off[name], "levels": _by_level(log),
               "fallbacks": sum(f for _, _, f in log),
               "delta_diff": phases.get("delta_diff", 0.0),
               "delta_splice": phases.get("delta_splice", 0.0),
               "plan": phases.get("plan", 0.0), "plan_wait": phases.get("plan_wait", 0.0),
               "splice_ms": timed.ms(), "splices": after["splice"] - before["splice"],
               "mod_launches": after["mod"] - before["mod"],
               "retained_bytes": _retained_bytes(),
               "allocated_above_start": torch.cuda.memory_allocated() - base_mem}
        out[name] = rec
        del got
        lv = ", ".join(f"{r}/{t}" for r, t in rec["levels"])
        _phase("delta", t1, f"({name}) wall {wall:.6f} s (delta off {off[name]:.6f} s); rows "
               f"recomputed/total per level {lv}; full fallbacks {rec['fallbacks']}; ENGINE "
               f"delta_diff {rec['delta_diff']:.6f} s, delta_splice {rec['delta_splice']:.6f} s, "
               f"plan {rec['plan']:.6f} s, plan_wait {rec['plan_wait']:.6f} s; splices "
               f"{rec['splices']} ({rec['splice_ms']:.3f} ms by CUDA events); numeric_round "
               f"launches {rec['mod_launches']}; the store holds "
               f"{rec['retained_bytes'] / 2**30:.3f} GiB on the card (allocated "
               f"{rec['allocated_above_start'] / 2**30:.3f} GiB above the start); result equal "
               f"to the delta-off chain")
    counts = {"splice": sum(rec["splices"] for rec in out.values())}
    if out["a"]["fallbacks"] != sum(DELTA_LEVELS) or any(r for r, _ in out["b"]["levels"]) \
            or out["b"]["mod_launches"] or not (out["c"]["splices"] and out["d"]["splices"]):
        raise RuntimeError(f"[delta] counts off what the design gives: {out}")
    if counts["splice"] <= 0:
        raise RuntimeError("the delta submits launched the splice kernel 0 times")

    t1 = time.perf_counter()
    check = _splice_check(timed.calls)
    timed.calls = []
    _phase("delta", t1, f"splice kernel against splice_ref on the {check['calls']} splices of "
           f"(c) and (d): equal; kernel {check['ms']:.3f} ms, plain version "
           f"{check['plain_ms']:.3f} ms, index_copy_ on a clone {check['library_ms']:.3f} ms "
           f"(medians of {KERNEL_REPEATS}); {check['bytes'] / 1e9:.3f} GB -> bytes bound "
           f"{check['bound_ms']:.3f} ms, kernel at {check['bound_ms'] / check['ms'] * 100:.1f}%")

    t1 = time.perf_counter()
    delta.clear()
    plancache.clear()
    shared = []
    for _ in range(2):
        st0 = delta.stats()
        _, wall = _chain_on(medium.mats, SPGEMM_TPU_DELTA="1")
        st = delta.stats()
        shared.append({"wall_s": wall, **{k: st[k] - st0[k] for k in
                                          ("hits", "full_fallbacks", "rows_recomputed",
                                           "rows_total")}})
    _phase("delta", t1, f"the Medium chain of one structure, submitted twice: {shared[1]['hits']} "
           f"delta hits and {shared[1]['full_fallbacks']} full fallbacks on the second, rows "
           f"recomputed {shared[1]['rows_recomputed']} of {shared[1]['rows_total']} (the level's "
           f"multiplies share one key); walls {shared[0]['wall_s']:.6f}, "
           f"{shared[1]['wall_s']:.6f} s")
    delta.clear()
    plancache.clear()
    torch.cuda.empty_cache()
    return {"name": "delta_splice", "route": "cuda",
            "source": "spgemm_tpu_torch/csrc/splice.cu",
            "replaces": "spgemm_tpu/ops/spgemm.py:1100",
            "launches": counts["splice"], "max_abs_err": check["max_abs_err"],
            "ms": check["ms"], "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
            "bound_by": "bytes", "library_ms": check["library_ms"],
            "submits": out, "splice_bytes": check["bytes"], "splice_calls": check["calls"],
            "one_structure": shared, "digest_s": digest_s, "digest_runs": runs,
            "digest_pairs_won": wins}


def _warm_child(role: str) -> int:
    """`chip_smoke.py --warm-child first|second`, run by phase_warm with
    SPGEMM_TPU_WARM_DIR set: the Medium chain of distinct structures from
    host leaves, delta on (the library's defaults); the first also flushes
    the warm store.  Prints one JSON line."""
    mats = _distinct_mats(_medium_mats())
    ENGINE.reset()
    res, wall = _chain_on(mats, SPGEMM_TPU_DELTA="1")
    h = hashlib.sha256(res.coords.tobytes() + res.slab.cpu().numpy().tobytes()).hexdigest()
    t0 = time.perf_counter()
    flushed = warmstore.flush() if role == "first" else None
    flush_s = time.perf_counter() - t0
    phases = ENGINE.snapshot()
    print(json.dumps({"wall_s": wall, "hash": h, "flushed": flushed, "flush_s": flush_s,
                      "counters": ENGINE.counters, "warm_load_s": phases.get("warm_load", 0.0),
                      "warm": warmstore.stats(), "delta": delta.stats()}, default=str), flush=True)
    return 0


def phase_warm() -> dict:
    """[warm]: a subprocess runs the Medium chain of distinct structures
    with SPGEMM_TPU_WARM_DIR set to a temporary directory and flushes the
    store; a second subprocess runs it again and must find every plan and
    delta entry there, recompute no row and give the first's bytes."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="warm-") as d:
        env = {**os.environ, "SPGEMM_TPU_WARM_DIR": d, "SPGEMM_TPU_WARM_MAX_MB": str(WARM_MAX_MB)}
        runs = {}
        for role in ("first", "second"):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--warm-child", role],
                                  env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"[warm] {role} process exited {proc.returncode}:\n"
                                   f"{proc.stderr[-4000:]}")
            runs[role] = json.loads(proc.stdout.strip().splitlines()[-1])
        disk = warmstore.scan(d)
    first, second = runs["first"], runs["second"]
    w, c = second["warm"], second["counters"]
    n = sum(DELTA_LEVELS)
    if second["hash"] != first["hash"] or w["plan_hits"] != n or w["delta_hits"] != n \
            or c.get("delta_rows_recomputed", 0) != 0 or w["corrupt"]:
        raise RuntimeError(f"[warm] second process: {second}")
    _phase("warm", t0, f"first process: wall {first['wall_s']:.6f} s, flushed "
           f"{first['flushed']} in {first['flush_s']:.3f} s; the store holds {disk['plans']} "
           f"plans and {disk['deltas']} delta entries, {disk['bytes'] / 1e9:.3f} GB on disk; "
           f"second process: first submit's wall {second['wall_s']:.6f} s (warm_load "
           f"{second['warm_load_s']:.6f} s), warm hits {w['plan_hits']} plans and "
           f"{w['delta_hits']} delta entries, rows recomputed 0 of "
           f"{c.get('delta_rows_total', 0)}; result equal to the first process's")
    return {"first": first, "second": second, "disk": disk}


def phase_estimate(medium) -> dict:
    """[estimate]: the Medium chain of distinct structures (device leaves,
    delta off) from an empty plan cache with the estimator on and off, in
    turns (medians of KERNEL_REPEATS): est_hits, est_fallbacks, ENGINE
    plan / plan_exact / plan_wait; the bytes must equal the estimator-off
    chain's."""
    t0 = time.perf_counter()
    dev_mats = [DeviceBlockMatrix.from_host(m, DEVICE) for m in _distinct_mats(medium.mats)]
    with contextlib.redirect_stdout(io.StringIO()), _env(SPGEMM_TPU_PLAN_ESTIMATE="0",
                                                         SPGEMM_TPU_DELTA="0"):
        want = chain_product(dev_mats, device=DEVICE, keep_device=True)
    runs = {"off": [], "on": []}
    scored0 = obs_profile.est_stats()["count"]
    for _ in range(KERNEL_REPEATS):
        for mode in ("off", "on"):
            plancache.clear()
            runs[mode].append(_timed_chain(dev_mats, want, SPGEMM_TPU_DELTA="0",
                                           SPGEMM_TPU_PLAN_ESTIMATE="0" if mode == "off" else "1"))
    med = {mode: _median_run(rs) for mode, rs in runs.items()}
    if not med["on"]["est_hits"] or med["off"]["est_hits"] or med["off"]["est_fallbacks"]:
        raise RuntimeError(f"[estimate] estimator counts: {med}")
    # obs/profile scored each estimated plan once, when its exact join landed
    est = obs_profile.est_stats()
    scored = est["count"] - scored0
    landed = sum(r["est_hits"] for r in runs["on"])
    if scored != landed:
        raise RuntimeError(f"[estimate] obs/profile scored {scored} estimates against the "
                           f"{landed} estimated plans that landed")
    errs = {q: round(h["sum"] / h["count"], 4) for q, h in est["rel_error"].items() if h["count"]}
    walls = {mode: ", ".join(f"{r['wall_s']:.6f}" for r in rs) for mode, rs in runs.items()}
    plancache.clear()
    _phase("estimate", t0, "Medium chain of distinct structures, empty plan cache, medians of "
           f"{KERNEL_REPEATS} in turns: estimator off wall {med['off']['wall_s']:.6f} s (plan "
           f"{med['off']['plan']:.6f}, plan_wait {med['off']['plan_wait']:.6f} s; runs "
           f"{walls['off']}); on wall {med['on']['wall_s']:.6f} s (plan {med['on']['plan']:.6f}, "
           f"plan_exact {med['on']['plan_exact']:.6f}, plan_wait {med['on']['plan_wait']:.6f} s; "
           f"est_hits {med['on']['est_hits']}, est_fallbacks {med['on']['est_fallbacks']}; runs "
           f"{walls['on']}); results equal; obs/profile scored {scored} estimates = the {landed} "
           f"estimated plans that landed (mean relative errors {errs})")
    return {"off": med["off"], "on": med["on"], "runs": runs, "scored": scored,
            "mean_rel_error": errs}


# ------------------------------------------------------------------ [dense] --
COCITE = {"block_dim": 4096, "k": 32, "avg_per_row": 8.0}  # A of the co-citation product
DENSE_WALL_RUNS = 5  # co-citation walls per route, in turns
DENSE_KS = (1, 2, 8, 32, 64)


class TimedDense:
    """numeric_round_dense (or its plain version) wrapped in CUDA events,
    counting the work the run's data needs: real pairs (slots the rows span
    whose indices are both real), their u64 MACs, and bytes (each
    referenced tile, each index and each output element once)."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []
        self.pairs = 0
        self.macs = 0
        self.bytes = 0

    def __call__(self, a, b, pa, pb, seg, n_rows, row_ptr=None):
        k = a.shape[-1]
        tile = k * k * 8
        span = int(row_ptr[-1]) if row_ptr is not None else int((seg < n_rows).sum())
        ia, ib = pa[:span], pb[:span]
        real = int(((ia != a.shape[0] - 1) & (ib != b.shape[0] - 1)).sum())
        self.pairs += real
        self.macs += real * k ** 3
        self.bytes += (len(torch.unique(ia)) + len(torch.unique(ib))) * tile \
            + pa.numel() * 12 + (n_rows + 1) * 8 + n_rows * tile
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(a, b, pa, pb, seg, n_rows, row_ptr)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def _dense_stream(rng, k: int, n_rows: int, L: int, real: int, layout: str, n_tiles: int = 30):
    """Slabs of EDGE-heavy values (sentinel zero tile last) and an (L,)
    stream on the card: `real` slots on rows (contiguous runs, or cycling
    over the rows), a fifth a's sentinel and a fifth b's, the rest pad
    slots on the scratch row n_rows."""
    a, b, _, _ = _round_case(rng, k, n_tiles, 1, 1)
    pa = np.full(L, n_tiles, np.int32)
    pb = np.full(L, n_tiles, np.int32)
    seg = np.full(L, n_rows, np.int32)
    pa[:real] = rng.integers(0, n_tiles, size=real)
    pb[:real] = rng.integers(0, n_tiles, size=real)
    side = rng.integers(0, 5, size=real)
    pa[:real][side == 0] = n_tiles
    pb[:real][side == 1] = n_tiles
    if n_rows:
        seg[:real] = (np.sort(rng.integers(0, n_rows, size=real)) if layout == "contiguous"
                      else np.arange(real) % n_rows)
    return (a, b, *_on_card(pa, pb, seg))


def _twin_rounds(p, a, b) -> int:
    """Every auto round's dense twin against kernel 1 on its ladder layout,
    bit for bit; returns the max abs error (0)."""
    err = 0
    for rnd in p.rounds:
        d = rnd.dense_alt
        if d is None:
            continue
        ladder = cuda_spgemm.numeric_round(a.slab, b.slab, *_on_card(rnd.pa, rnd.pb))
        dense = cuda_dense.numeric_round_dense(a.slab, b.slab, *_on_card(d.pa, d.pb, d.seg),
                                               d.n_rows, *_on_card(d.row_ptr))
        err = max(err, _check_equal(f"dense twin vs kernel 1, round {rnd.pa.shape}",
                                    dense, ladder))
    return err


def _cocite_operands() -> list:
    """The co-citation product A x A^T of a power-law matrix, from its own
    generator seeded with SEED: B has A's block structure transposed and
    values drawn after A's."""
    cfg = COCITE
    rng = np.random.default_rng(SEED)
    a = powerlaw_block_sparse(cfg["block_dim"], cfg["k"], cfg["avg_per_row"], rng)
    bc = a.coords[:, ::-1]
    order = np.lexsort((bc[:, 1], bc[:, 0]))
    b = BlockSparseMatrix.from_blocks(a.cols, a.rows, a.k, bc[order],
                                      random_values((a.nnzb, a.k, a.k), rng))
    return [DeviceBlockMatrix.from_host(m, DEVICE) for m in (a, b)]


def _hub_runs(hub, cache: str) -> dict:
    """(c): the hub multiply under each backend and route, each a main path;
    the bytes must be the same in all six."""
    runs, want = {}, None
    for backend in ("exact", "hybrid"):
        for route in ("ladder", "dense", "auto"):
            plancache.clear()
            res, wall, counts, _ = _main_path(hub, backend, SPGEMM_TPU_ACCUM_ROUTE=route,
                                              SPGEMM_TPU_CROSSOVER_CACHE=cache)
            want = res if want is None else want
            if not _same(res, want):
                raise RuntimeError(f"[dense] hub multiply, {backend} {route} != exact ladder")
            if route == "dense" and (counts["dense"] <= 0 or counts["mod"] or counts["no_mod"]):
                raise RuntimeError(f"[dense] hub, forced dense launched {counts}")
            if route == "ladder" and counts["dense"]:
                raise RuntimeError(f"[dense] hub, ladder launched the dense fold: {counts}")
            runs[f"{backend}/{route}"] = {"wall_s": wall, "counts": counts}
    return runs


def _hub_kernel_ms(hub) -> dict:
    """Kernel 1 mod and no_mod on the hub's ladder round and the dense fold
    on its twin, medians of KERNEL_REPEATS (the values are below 2^16, so
    all three agree)."""
    a, b = hub
    with _env(SPGEMM_TPU_ACCUM_ROUTE="auto"):
        p = plan(a, b)
    [rnd] = p.rounds
    d = rnd.dense_alt
    ladder = _on_card(rnd.pa, rnd.pb)
    stream = (*_on_card(d.pa, d.pb, d.seg), d.n_rows, *_on_card(d.row_ptr))
    out, err = {}, 0
    for name, fn in (("mod", lambda: cuda_spgemm.numeric_round(a.slab, b.slab, *ladder)),
                     ("no_mod", lambda: cuda_spgemm.numeric_round(a.slab, b.slab, *ladder,
                                                                  no_mod=True)),
                     ("dense", lambda: cuda_dense.numeric_round_dense(a.slab, b.slab,
                                                                      *stream))):
        runs = []
        for _ in range(KERNEL_REPEATS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end))
        out[name] = sorted(runs)[len(runs) // 2]
        out[f"{name}_runs"] = runs
        if name == "mod":
            first = res
        err = max(err, _check_equal(f"hub round, {name} vs mod", res, first))
    out["err"] = err
    return out


def phase_dense(medium, kernel1_ms: float) -> dict:
    """[dense]: (a) the segmented fold against its plain version and, on
    planner rounds, against kernel 1; (b) the Medium chain with the route
    forced to dense; (c) the hub multiply under every route and backend;
    (d) the co-citation product under auto and ladder."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    err = 0
    for k in DENSE_KS:
        for layout in ("contiguous", "cycling"):
            n_rows = max(2, 256 // k)
            for L, real in ((8 * n_rows * 6, 6 * n_rows * 6 + 3), (16, 0)):
                args = _dense_stream(rng, k, n_rows, L, real, layout)
                err = max(err, _check_equal(
                    f"dense k={k} {layout} L={L} real={real}",
                    cuda_dense.numeric_round_dense(*args[:5], n_rows),
                    cuda_dense.numeric_round_dense_ref(*args[:5], n_rows)))
    args = _dense_stream(rng, 8, 0, 16, 0, "contiguous")
    got = cuda_dense.numeric_round_dense(*args[:5], 0)
    if tuple(got.shape) != (0, 8, 8):
        raise RuntimeError(f"dense fold with n_rows 0 gave {tuple(got.shape)}")
    hub = _hub_operands(rng, MEDIUM["k"])
    cocite = _cocite_operands()
    with _env(SPGEMM_TPU_ACCUM_ROUTE="auto"):
        hub_plan, cocite_plan = plan(*hub), plan(*cocite)
    err = max(err, _twin_rounds(hub_plan, *hub), _twin_rounds(cocite_plan, *cocite))
    _phase("dense", t0, f"(a) segmented fold == plain version at k {list(DENSE_KS)}, contiguous "
           f"and cycling seg, sentinel and pad slots, an all-pad stream, n_rows 0; == kernel 1 on "
           f"the hub's and the co-citation product's twin rounds")

    # (b) Medium with the route forced to dense
    t0 = time.perf_counter()
    with _env(SPGEMM_TPU_ACCUM_ROUTE="ladder"):
        ladder_plans = _plan_chain(medium.mats)[2]
    auto_plans = _plan_chain(medium.mats)[2]
    if any(r.dense_alt is not None for p in auto_plans for r in p.rounds) or \
            not _same_plans(auto_plans, ladder_plans):
        raise RuntimeError("[dense] Medium's auto plans carry a twin or differ from ladder's")
    res_b, wall_b, counts_b, _ = _main_path(medium.dev_mats, "exact",
                                            SPGEMM_TPU_ACCUM_ROUTE="dense")
    if not _same(res_b, medium.res) or counts_b["mod"] or counts_b["dense"] <= 0:
        raise RuntimeError(f"[dense] Medium forced dense != ladder bytes, or launches {counts_b}")
    kerns = [TimedDense(cuda_dense.numeric_round_dense) for _ in range(KERNEL_REPEATS)]
    plain = TimedDense(cuda_dense.numeric_round_dense_ref)
    with contextlib.redirect_stdout(io.StringIO()), _env(SPGEMM_TPU_ACCUM_ROUTE="dense"):
        for kern in kerns:
            res_k = chain_product(medium.dev_mats, device=DEVICE, keep_device=True,
                                  folds=Folds(dense=kern))
        res_p = chain_product(medium.dev_mats, device=DEVICE, keep_device=True,
                              folds=Folds(dense=plain))
        plain_ms = plain.ms()
    runs_ms = sorted(kern.ms() for kern in kerns)
    kern_ms = runs_ms[len(runs_ms) // 2]
    err_b = max(_u64_max_abs_err(res_k.slab, res_p.slab), _u64_max_abs_err(res_b.slab, res_p.slab))
    if not (_same(res_k, medium.res) and _same(res_p, medium.res)):
        raise RuntimeError(f"[dense] Medium dense kernel != plain version (max abs err {err_b})")
    err = max(err, err_b)
    ops_ms = kern.macs * INT_OPS_PER_MAC / INT32_OPS_PER_S * 1e3
    bytes_ms = kern.bytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = _bound(ops_ms, bytes_ms)
    ptxas = _ptxas_report()["dense"]
    _phase("dense", t0, f"(b) Medium, route dense: chain wall {wall_b:.6f} s, bytes equal to "
           f"the ladder chain; launches {counts_b}; auto plans carry no twin and equal ladder's; "
           f"dense kernel total {kern_ms:.3f} ms over {len(kern.events)} launches (median of "
           f"{', '.join(f'{t:.3f}' for t in runs_ms)}) beside kernel 1's {kernel1_ms:.3f} ms "
           f"in [medium]; plain version {plain_ms:.3f} ms; {kern.pairs} real pairs, "
           f"{kern.macs / 1e9:.3f} G MACs -> integer bound {ops_ms:.3f} ms, "
           f"{kern.bytes / 1e9:.3f} GB -> bytes bound {bytes_ms:.3f} ms; kernel at "
           f"{bound_ms / kern_ms * 100:.1f}% of bound; ptxas (registers, spill bytes) {ptxas}")
    del res_b, res_k, res_p

    # (c) the hub multiply under every route, exact and hybrid
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dense_gate_") as cache:
        hub_runs = _hub_runs(hub, cache)
        with _env(SPGEMM_TPU_CROSSOVER_CACHE=cache):
            hub_gate = crossover.entries()
        hub_ms = _hub_kernel_ms(hub)
        err = max(err, hub_ms["err"])
        # the rounds each kernel folded (launches also count the gate's timings)
        chosen = {run: ("dense" if r["counts"]["rounds"]["dense"] else "ladder")
                  for run, r in hub_runs.items() if run.endswith("auto")}
        why = {key: {**v, "winner": "dense" if v["dense_s"] < v["ladder_s"] else "ladder"}
               for key, v in sorted(hub_gate.items())}
        walls = {run: round(r["wall_s"], 6) for run, r in hub_runs.items()}
        _phase("dense", t0, f"(c) hub multiply (fanout {HUB_FANOUT}, k={MEDIUM['k']}, one "
               f"round of 2 keys): bytes equal under exact and hybrid x ladder, dense, auto; "
               f"walls {walls}; the measured gate chose {chosen} from {why}; kernels on the "
               f"round, medians of {KERNEL_REPEATS}: kernel 1 mod {hub_ms['mod']:.3f} ms, "
               f"no_mod {hub_ms['no_mod']:.3f} ms, dense {hub_ms['dense']:.3f} ms "
               f"(runs {hub_ms})")

        # (d) the co-citation product
        t0 = time.perf_counter()
        a, b = cocite
        fan = cocite_plan.join.fanouts
        classes, counts = np.unique(symbolic._shape_class_vec(fan), return_counts=True)
        twins = sum(r.dense_alt is not None for r in cocite_plan.rounds)
        if twins < 1:
            raise RuntimeError("[dense] the co-citation product planned no twin; raise alpha")
        with _env(SPGEMM_TPU_CROSSOVER_CACHE=cache):
            res_auto, _, counts_d, _ = _main_path([a, b], "exact", SPGEMM_TPU_ACCUM_ROUTE="auto")
            co_gate = {key: v for key, v in crossover.entries().items() if key not in hub_gate}
            with _env(SPGEMM_TPU_ACCUM_ROUTE="ladder"):
                plan(a, b)  # both routes' plans cached: the walls below are warm
            res_ladder = None
            walls_d = {"ladder": [], "auto": []}
            for _ in range(DENSE_WALL_RUNS):
                for route in ("ladder", "auto"):
                    with _env(SPGEMM_TPU_ACCUM_ROUTE=route):
                        torch.cuda.synchronize()
                        t1 = time.perf_counter()
                        got = spgemm_device(a, b, device=DEVICE)
                        torch.cuda.synchronize()
                        walls_d[route].append(time.perf_counter() - t1)
                    if not _same(got, res_auto):
                        raise RuntimeError(f"[dense] co-citation product, {route} != auto")
                    res_ladder = got if route == "ladder" else res_ladder
            del got
    med = {route: sorted(w)[len(w) // 2] for route, w in walls_d.items()}
    keys, pairs = cocite_plan.join.num_keys, int(cocite_plan.join.pair_ptr[-1])
    d_ops = pairs * COCITE["k"] ** 3 * INT_OPS_PER_MAC / INT32_OPS_PER_S * 1e3
    co_why = {key: {**v, "winner": "dense" if v["dense_s"] < v["ladder_s"] else "ladder"}
              for key, v in sorted(co_gate.items())}
    _phase("dense", t0, f"(d) co-citation A x A^T, A = powerlaw_block_sparse({COCITE['block_dim']}"
           f", {COCITE['k']}, {COCITE['avg_per_row']}): {a.nnzb} tiles per operand "
           f"({a.nnzb * COCITE['k'] ** 2 * 8 / 1e6:.0f} MB), {keys} keys, {pairs} pairs, "
           f"max fanout {int(fan.max())} (integer bound {d_ops:.3f} ms); fanout classes "
           f"{dict(zip(classes.tolist(), counts.tolist()))}; {len(cocite_plan.rounds)} rounds, "
           f"{twins} with a twin; main path (auto, gate filled here) launches {counts_d}; "
           f"gate {co_why}; warm plan cache and gate, medians of {DENSE_WALL_RUNS} in turns: "
           f"ladder {med['ladder']:.6f} s (runs {', '.join(f'{w:.6f}' for w in walls_d['ladder'])}),"
           f" auto {med['auto']:.6f} s (runs {', '.join(f'{w:.6f}' for w in walls_d['auto'])}); "
           f"bytes identical")
    del res_auto, res_ladder, cocite, hub
    runs = {"b_medium": counts_b, "d_cocite_auto": counts_d,
            **{f"c_{run}": r["counts"] for run, r in hub_runs.items()}}
    launches = {run: c["dense"] for run, c in runs.items()}  # the gate's timings included
    return {"name": "dense_fold", "route": "cuda",
            "source": "spgemm_tpu_torch/csrc/numeric_round_dense.cu",
            "replaces": "spgemm_tpu/ops/spgemm.py:150",
            "launches": sum(launches.values()), "launches_by_run": launches,
            "rounds_by_run": {run: c["rounds"]["dense"] for run, c in runs.items()},
            "max_abs_err": err, "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library_call": "none: no single PyTorch call computes a segmented "
                            "mod-(2^64-1) fold",
            "equal": True, "ms_runs": runs_ms, "timed_on": "Medium chain, route forced dense",
            "kernel1_ms_same_chain": kernel1_ms, "macs": kern.macs, "pairs": kern.pairs,
            "ptxas": ptxas, "medium_dense_wall_s": wall_b,
            "hub": {"walls_s": walls, "chosen": chosen, "gate": why, "kernel_ms": hub_ms},
            "cocite": {"tiles": a.nnzb, "keys": keys, "pairs": pairs,
                       "max_fanout": int(fan.max()), "twins": twins, "gate": co_why,
                       "walls_s": walls_d, "median_s": med, "launches": counts_d}}


SERVE_EDIT_LEAF = DELTA_EDIT_LEAF  # leg (c) edits M5 of the chain of distinct structures
SERVE_EDIT_ROWS = DELTA_EDIT_ROWS  # in 11 contiguous tile rows from the middle
SERVE_SMALL = {"n": 6, "block_dim": 32, "k": 8, "density": 0.3}  # leg (e)'s chain
SERVE_TIMEOUT_S = 2.0  # leg (e): the job deadline, the wedge grace and the
SERVE_GRACE_S = 1.0    # re-probe cadence of a dead card on the second daemon
SERVE_RECOVER_S = 1.0
SERVE_SLO_TARGET_S = 60.0  # the second daemon's objectives: a job over 60 s, or failed, is bad,
SERVE_SLO_ERROR_PCT = 1.0  # and 1% of the window's jobs may be


def _serve_env(**extra) -> dict:
    """A daemon's environment: this script's, without its own pins (delta
    off) or any serve, warm or failpoint setting, so the daemon runs at its
    defaults (delta on, the warm store next to its socket); the warm budget
    is raised so Medium's entries stay."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SPGEMM_TPU_DELTA", "SPGEMM_TPU_WARM", "SPGEMM_TPU_SERVE",
                                "SPGEMM_TPU_FAILPOINTS"))}
    env.update(PYTHONPATH=REPO, SPGEMM_TPU_WARM_MAX_MB=str(WARM_MAX_MB), **extra)
    return env


def _serve_start(sock: str, env: dict, log_path: str):
    """`python -m spgemm_tpu_torch.cli serve --socket sock -v` (no --device:
    the card; `--device cpu` when DEVICE is), its output to log_path;
    returns (process, {"start_s": seconds until the socket is bound,
    "probe_warm_s": the daemon's own probe and warm-up, from its log})."""
    t0 = time.perf_counter()
    log_f = open(log_path, "a")
    cpu = ["--device", "cpu"] if DEVICE == "cpu" else []
    proc = subprocess.Popen([sys.executable, "-m", "spgemm_tpu_torch.cli", "serve", "--socket",
                             sock, "-v", *cpu], env=env, cwd=REPO, stdout=log_f,
                            stderr=subprocess.STDOUT)
    log_f.close()
    deadline = time.time() + 300
    while not os.path.exists(sock):
        if proc.poll() is not None or time.time() > deadline:
            proc.kill()
            raise RuntimeError(f"[serve] the daemon did not bind {sock}:\n"
                               + open(log_path).read()[-4000:])
        time.sleep(0.05)
    start_s = time.perf_counter() - t0
    warm = re.findall(r"probed and warmed up in ([0-9.]+) s", open(log_path).read())
    return proc, {"start_s": start_s, "probe_warm_s": float(warm[-1]) if warm else None}


def _serve_stop(proc, sock: str, client, log_path: str) -> None:
    client.shutdown(sock)
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise RuntimeError("[serve] the daemon did not exit after shutdown") from None
    if rc != 0 or os.path.exists(sock):
        raise RuntimeError(f"[serve] the daemon exited {rc} (socket left: "
                           f"{os.path.exists(sock)}):\n" + open(log_path).read()[-4000:])


def _serve_job(client, sock: str, folder: str, out: str, **options) -> tuple[dict, float]:
    """One submit, waited for: (the job's snapshot, client-observed wall s)."""
    t0 = time.perf_counter()
    job = client.wait(client.submit(folder, sock, {"output": out, **options})["id"], sock,
                      timeout=900)["job"]
    wall = time.perf_counter() - t0
    if job["state"] != "done":
        raise RuntimeError(f"[serve] job {job['id']} ended {job['state']}: {job['error']}")
    return job, wall


def _serve_idle(client, sock: str) -> float:
    """Seconds until the daemon's executor is idle again: after a job's
    terminal answer it flushes the warm store before it takes the next
    (the smoke reads the job's output back meanwhile)."""
    t0 = time.perf_counter()
    while client.stats(sock)["slices"][0]["busy"]:
        time.sleep(0.02)
    return time.perf_counter() - t0


def _same_bytes(path_a: str, path_b: str, chunk: int = 64 << 20) -> bool:
    if os.path.getsize(path_a) != os.path.getsize(path_b):
        return False
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        while True:
            a, b = fa.read(chunk), fb.read(chunk)
            if a != b:
                return False
            if not a:
                return True


def _serve_check(leg: str, job: dict, out: str, want: BlockSparseMatrix | str,
                 keep: str | None = None,
                 kernels: tuple = ("launches_numeric_round",)) -> None:
    """A kernel of `kernels` (kernel 1 by default; none asked for when empty)
    launched on the card, not degraded, and ./out equal to want: read back with the native parser
    against the in-memory engine's result, or, when want is a path, byte for
    byte against that earlier leg's file.  The file is then removed, or
    renamed to keep."""
    det = job["detail"]
    on_card = DEVICE == "cuda"
    if det.get("degraded") is not False or det.get("device") != ("cuda:0" if on_card else "cpu") \
            or (on_card and kernels and sum(det.get(k, 0) for k in kernels) < 1):
        raise RuntimeError(f"[serve] ({leg}) did not launch {kernels} on the card: {det}")
    if isinstance(want, str):
        if not _same_bytes(out, want):
            raise RuntimeError(f"[serve] ({leg}) ./{os.path.basename(out)} differs from the "
                               f"bytes of ./{os.path.basename(want)}")
    elif not _host_equal(io_text.read_matrix(out, want.k), want):
        raise RuntimeError(f"[serve] ({leg}) ./{os.path.basename(out)} differs from the "
                           "in-memory engine's result")
    if keep is not None:
        os.replace(out, keep)
    else:
        os.remove(out)


def _serve_report(leg: str, job: dict, wall: float, smi: str) -> dict:
    det = job["detail"]
    counters = {k: v for k, v in det.items()
                if k not in ("phases_s", "plan_cache", "degraded", "slice", "device", "tenant")}
    print(f"[serve] ({leg}) {job['id']} on {smi}: submit wall {wall:.6f} s (client-observed); "
          f"phases_s {det['phases_s']}; ENGINE counters {counters}", flush=True)
    return {"wall_s": wall, "phases_s": det["phases_s"], "counters": counters}


def _serve_watchdog(client, sock: str, tmp: str) -> dict:
    """(e), on a daemon started with serve.heartbeat armed to hang once and
    a short job deadline, wedge grace and re-probe cadence: a small chain's
    job is reaped (job-timeout), the slice degrades and the probe that
    follows finds the card; the slice is reinstated at once and the canary
    job runs on the card with the oracle's bytes.  No job runs on the host
    oracle."""
    cfg = SERVE_SMALL
    mats = random_chain(cfg["n"], cfg["block_dim"], cfg["k"], cfg["density"],
                        np.random.default_rng(SEED + 14), "adversarial")
    folder = os.path.join(tmp, "small")
    io_text.write_chain_dir(folder, mats, cfg["k"])
    want = BlockSparseMatrix.from_dict(mats[0].rows, mats[-1].cols, cfg["k"], chain_oracle(
        [m.to_dict() for m in mats], cfg["k"])).prune_zeros()
    t0 = time.perf_counter()
    out = os.path.join(tmp, "e.out")
    resp = client.submit(folder, sock, {"output": out})
    job = client.wait(resp["id"], sock, timeout=300)["job"]
    reaped_s = time.perf_counter() - t0
    if job["state"] != "failed" or job["error"]["code"] != "job-timeout":
        raise RuntimeError(f"[serve] (e) the hung job was not reaped: {job}")
    seen = {}
    deadline = time.time() + 300
    while time.time() < deadline:
        st = client.stats(sock)
        sl = st["slices"][0]
        if sl["degraded"] and "degraded_s" not in seen:
            seen["degraded_s"] = time.perf_counter() - t0
            seen["reason"] = sl["degrade_reason"]
        if st["serve"]["serve_recoveries"] >= 1 and not sl["degraded"]:
            seen["reinstated_s"] = time.perf_counter() - t0
            break
        time.sleep(0.05)
    if "reinstated_s" not in seen or st["backend_probe"] != ("ok" if DEVICE == "cuda"
                                                             else "cpu") \
            or st["serve"]["serve_degrades"] != 1 or "wedged" not in (seen["reason"] or ""):
        raise RuntimeError(f"[serve] (e) no degrade and reinstatement after a live probe: "
                           f"{seen} {st}")
    canary, wall = _serve_job(client, sock, folder, out, timeout_s=20)
    _serve_check("e", canary, out, want)
    if canary["timeout_s"] != 10:
        raise RuntimeError(f"[serve] (e) the first job after the reinstatement was not "
                           f"the canary (deadline {canary['timeout_s']})")
    _serve_idle(client, sock)
    st = client.stats(sock)
    if st["slices"][0]["canary"] or st["degraded"] or st["slices"][0]["oracle_jobs"]:
        raise RuntimeError(f"[serve] (e) the canary did not settle, or a job ran on the "
                           f"oracle: {st['slices']}")
    return {"job_id": job["id"], "trace": resp["trace"], "reaped_s": reaped_s, **seen,
            "canary_wall_s": wall,
            "canary_launches": canary["detail"].get("launches_numeric_round", 0),
            "serve": st["serve"], "probe": st["backend_probe"]}


SERVE_BATCH_SEEDS = (SEED, SEED + 1, SEED + 2, SEED + 3)  # (f): Medium's four value sets
# (g): one small banded structure whose largest round holds 584 real keys (768
# key slots, the pad keys' blocks exit at once), under the 660 blocks of
# kernel 1 at k = 32 (5 per SM on 132 SMs, one key a block): a job that
# cannot fill the card on any launch, which batching exists for
SERVE_BATCH_SMALL = {"n": 10, "block_dim": 32, "bandwidth": 4, "k": 32, "jobs": 8}
SERVE_BATCH_WINDOW_S = 0.5  # (h): the batching window, K 8
SERVE_BATCH_FOLDERS = 4     # (h): text directories of (g)'s structure


class _LaunchKeys:
    """Kernel 1's wrapper, recording each launch's keys (the stacked lead
    axes) and real keys (a key with a real slot): what a launch can fill."""

    def __init__(self, fn):
        self.fn = fn
        self.launches = []

    def __call__(self, a, b, pa, pb, **kw):
        real = ((pa != a.shape[0] - 1) & (pb != b.shape[0] - 1)).any(-1)
        self.launches.append((real.numel(), int(real.sum())))
        return self.fn(a, b, pa, pb, **kw)


def _batch_chains(mats_by_job) -> dict:
    """One lockstep batched chain (chain.chain_products_batched) against the
    jobs' solo chains (chain_product), delta off, plans warm (one batched
    and one solo run first).  Walls in turns solo, batched, batched, solo,
    each a main path (counts zeroed before, read after), closed by
    torch.cuda.synchronize(); then one run of each with kernel 1 timed by
    CUDA events (TimedFold, which waits for each launch, so its walls are
    not kept) and each launch's keys recorded.  Every job's batched result
    must equal its solo one bit for bit."""
    dev_chains = [[DeviceBlockMatrix.from_host(m, DEVICE) for m in mats] for mats in mats_by_job]
    torch.cuda.synchronize()

    def solo(fold):
        return [chain_product(c, device=DEVICE, keep_device=True, folds=Folds(exact=fold))
                for c in dev_chains]

    def batched(fold):
        return chain_products_batched(dev_chains, folds=Folds(exact=fold))

    def check(mode, got):
        for g, w in zip(got, want):
            if not _same(g, w):
                raise RuntimeError(f"a {mode} chain differs from the first solo chains (max "
                                   f"abs err {_u64_max_abs_err(g.slab, w.slab)})")

    runs = {"solo": {"walls_s": [], "launches": []}, "batched": {"walls_s": [], "launches": []}}
    with contextlib.redirect_stdout(io.StringIO()):
        want = solo(cuda_spgemm.numeric_round)
        check("batched", batched(cuda_spgemm.numeric_round))
        for mode in ("solo", "batched", "batched", "solo"):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            got = (solo if mode == "solo" else batched)(cuda_spgemm.numeric_round)
            torch.cuda.synchronize()
            runs[mode]["walls_s"].append(time.perf_counter() - t0)
            runs[mode]["launches"].append(_read_counts()["mod"])
            check(mode, got)
            del got
        for mode in ("solo", "batched"):
            timed = TimedFold(cuda_spgemm.numeric_round)
            keys = _LaunchKeys(timed)  # outside the timed window
            check(mode, (solo if mode == "solo" else batched)(keys))
            runs[mode].update(kernel_ms=timed.ms(), launch_keys=keys.launches)
    del want, dev_chains
    return runs


def _fill(launch_keys: list, resident: int) -> dict:
    """What share of the card's resident kernel-1 blocks the launches' real
    keys can fill (one key a block at k = 32): the largest, and the mean
    over launches."""
    shares = [min(1.0, real / resident) for _, real in launch_keys]
    return {"max": max(shares), "mean": sum(shares) / len(shares),
            "keys_max": max(k for k, _ in launch_keys),
            "real_keys_max": max(r for _, r in launch_keys)}


def _batch_report(leg: str, what: str, runs: dict, resident: int, smi: str) -> dict:
    out = {mode: {"walls_s": r["walls_s"], "launches": r["launches"],
                  "kernel_ms": r["kernel_ms"], "fill": _fill(r["launch_keys"], resident)}
           for mode, r in runs.items()}
    s, b = out["solo"], out["batched"]
    print(f"[serve] ({leg}) {what} on {smi}: kernel-1 launches batched {b['launches']} "
          f"against solo {s['launches']}; walls (synchronized; in turns solo, batched, batched, "
          f"solo) batched {', '.join(f'{t:.6f}' for t in b['walls_s'])} s against solo "
          f"{', '.join(f'{t:.6f}' for t in s['walls_s'])} s; kernel-1 ms by CUDA events "
          f"batched {b['kernel_ms']:.3f} against solo {s['kernel_ms']:.3f}; the share of the "
          f"card's {resident} resident kernel-1 blocks a launch's real keys fill: solo max "
          f"{s['fill']['max']:.3f}, mean {s['fill']['mean']:.3f} (largest launch "
          f"{s['fill']['keys_max']} keys, {s['fill']['real_keys_max']} real), batched max "
          f"{b['fill']['max']:.3f}, mean {b['fill']['mean']:.3f}; 0 differing bits per job",
          flush=True)
    return out


def _small_batch_mats() -> list:
    """(g)'s chains: SERVE_BATCH_SMALL's banded structure, one value set per
    job from seeds SEED + 30 ..."""
    cfg = SERVE_BATCH_SMALL
    out = []
    for j in range(cfg["jobs"]):
        rng = np.random.default_rng(SEED + 30 + j)
        out.append([banded_block_sparse(cfg["block_dim"], cfg["k"], cfg["bandwidth"], rng)
                    for _ in range(cfg["n"])])
    return out


def _serve_batch_daemon(tmp: str, small_mats: list, want: list, smi: str) -> dict:
    """(h): the daemon in this process on the card, as the tests build it
    (no third start of a process): SERVE_BATCH_FOLDERS text directories of
    (g)'s structure with distinct values, each submitted once (first
    contact: solo, its structure recorded), then all resubmitted back to
    back with the window SERVE_BATCH_WINDOW_S, K 8 and delta off: one
    shared batch id, serve_batches up by 1, each output byte-equal to its
    first contact's, which equals the in-memory engine's result."""
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415
    from spgemm_tpu_torch.serve.daemon import Daemon  # noqa: PLC0415

    k = SERVE_BATCH_SMALL["k"]
    folders = []
    for j in range(SERVE_BATCH_FOLDERS):
        folder = os.path.join(tmp, f"batch{j}")
        io_text.write_chain_dir(folder, small_mats[j], k)
        folders.append(folder)
    plancache.clear()  # the structure book and plans start empty, as in a new daemon
    sock = os.path.join(tmp, "batch.sock")
    on_card = DEVICE == "cuda"
    with _env(SPGEMM_TPU_SERVE_BATCH_WINDOW_S=str(SERVE_BATCH_WINDOW_S),
              SPGEMM_TPU_SERVE_BATCH_K="8", SPGEMM_TPU_DELTA="0"), \
            contextlib.redirect_stdout(io.StringIO()):
        d = Daemon(sock, journal=False, device=DEVICE,
                   n_devices=torch.cuda.device_count() if on_card else None,
                   device_name=torch.cuda.get_device_name(0) if on_card else None)
        d.start()
        try:
            first = []
            for j, folder in enumerate(folders):
                job, _ = _serve_job(client, sock, folder, os.path.join(tmp, f"first{j}"))
                if job["batch"] is not None:
                    raise RuntimeError(f"[serve] (h) first contact {job['id']} ran in a batch")
                if not _host_equal(io_text.read_matrix(os.path.join(tmp, f"first{j}"), k),
                                   want[j]):
                    raise RuntimeError(f"[serve] (h) first contact {j} differs from the "
                                       "in-memory engine's result")
                first.append(job)
            before = client.stats(sock)["serve"]
            slo_before = client.slo(sock)["tenants"]["default"]["jobs"]
            t0 = time.perf_counter()
            ids = [client.submit(folder, sock, {"output": os.path.join(tmp, f"again{j}")})["id"]
                   for j, folder in enumerate(folders)]
            jobs = [client.wait(i, sock, timeout=300)["job"] for i in ids]
            wall = time.perf_counter() - t0
            after = client.stats(sock)["serve"]
            obs = _obs_after_h(client, sock, smi, slo_before)
        finally:
            d.stop()
    for j, job in enumerate(jobs):
        det = job["detail"]
        if job["state"] != "done" or det.get("degraded") is not False or \
                (on_card and det.get("launches_numeric_round", 0) < 1):
            raise RuntimeError(f"[serve] (h) job {job['id']} did not run on the card: {job}")
        if not _same_bytes(os.path.join(tmp, f"again{j}"), os.path.join(tmp, f"first{j}")):
            raise RuntimeError(f"[serve] (h) batched job {j}'s output differs from its first "
                               "contact's")
    batch_ids = {job["batch"] for job in jobs}
    launches = [job["detail"].get("launches_numeric_round", 0) for job in jobs]
    if None in batch_ids or len(batch_ids) != 1 or \
            after["serve_batches"] - before["serve_batches"] != 1 or len(set(launches)) != 1:
        raise RuntimeError(f"[serve] (h) the resubmits did not run as one batch: ids "
                           f"{batch_ids}, serve_batches {before} -> {after}, launches "
                           f"{launches}")
    head = jobs[0]["detail"]["phases_s"]
    mate_waits = [job["detail"]["phases_s"].get("serve_queue_wait") for job in jobs[1:]]
    _obs_report_h(obs, smi)
    for job in first + jobs:
        print(f"[serve] (h) {job['id']} ({'batch ' + job['batch'] if job['batch'] else 'solo'}) "
              f"on {smi}: phases_s {job['detail']['phases_s']}; kernel-1 launches "
              f"{job['detail'].get('launches_numeric_round', 0)}", flush=True)
    return {"wall_s": wall, "batch": batch_ids.pop(), "launches_per_member": launches,
            "first_launches": [job["detail"].get("launches_numeric_round", 0) for job in first],
            "phases_s": [job["detail"]["phases_s"] for job in jobs],
            "first_phases_s": [job["detail"]["phases_s"] for job in first],
            "head_execute_s": head.get("serve_execute"), "mate_queue_wait_s": mate_waits,
            "serve_batches": after["serve_batches"] - before["serve_batches"], "obs": obs}


def _serve_batch_legs(medium, tmp: str, smi: str) -> dict:
    """[serve]'s batching legs (f), (g), (h), each timed."""
    out = {}
    geo = cuda_spgemm.geometry(32) if DEVICE == "cuda" else {"blocks_per_sm": 5,
                                                             "keys_per_block": 1}
    sms = cuda_bsmm.sm_count(torch.cuda.current_device()) if DEVICE == "cuda" else 132
    resident = geo["blocks_per_sm"] * sms * geo["keys_per_block"]
    t0 = time.perf_counter()
    mats_f = [medium.mats] + [_medium_mats(seed) for seed in SERVE_BATCH_SEEDS[1:]]
    out["f_generate_s"] = time.perf_counter() - t0
    out["f"] = _batch_report("f", f"Medium, {len(mats_f)} jobs (seeds {SERVE_BATCH_SEEDS[0]}.."
                             f"{SERVE_BATCH_SEEDS[-1]}, {len(mats_f)} x 817 MB)",
                             _batch_chains(mats_f), resident, smi)
    del mats_f
    torch.cuda.empty_cache()
    out["f_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    cfg = SERVE_BATCH_SMALL
    small = _small_batch_mats()
    out["g"] = _batch_report("g", f"{cfg['jobs']} jobs of banded_block_sparse(block_dim "
                             f"{cfg['block_dim']}, bandwidth {cfg['bandwidth']}, k {cfg['k']}), "
                             f"N = {cfg['n']}", _batch_chains(small), resident, smi)
    out["g_s"] = time.perf_counter() - t1
    t2 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        want = [chain_product(m, device=DEVICE).prune_zeros() for m in small]
    medium.small_batch = (small, want)  # [fleet] (f3) and (f5) submit these chains
    out["h"] = _serve_batch_daemon(tmp, small, want, smi)
    out["h_s"] = time.perf_counter() - t2
    out["resident_blocks"] = resident
    h = out["h"]
    print(f"[serve] (h) on {smi}: {SERVE_BATCH_FOLDERS} resubmits in batch {h['batch']}, "
          f"serve_batches +{h['serve_batches']}, kernel-1 launches per member "
          f"{h['launches_per_member']} (first contacts {h['first_launches']}); mates' "
          f"serve_queue_wait {h['mate_queue_wait_s']} s against the {SERVE_BATCH_WINDOW_S} s "
          f"window, the head's serve_execute {h['head_execute_s']} s; wall {h['wall_s']:.6f} s; "
          f"each output byte-equal to its first contact's; legs (f) {out['f_s']:.3f} s (of "
          f"which generating three value sets {out['f_generate_s']:.3f} s), (g) "
          f"{out['g_s']:.3f} s, (h) {out['h_s']:.3f} s", flush=True)
    return out


OBS_PAIRS = 4  # [obs]: the warm Medium chain with the recorder on and off, 4 x (on, off, off, on)
OBS_COST_REPEATS = 2000  # [obs]: calls timed for each host cost of the recorder's knob


def _obs_series(text: str) -> dict:
    """A `metrics` scrape parsed: {series: value}.  Fails unless every
    sample line is `series value` with a float value and its family has
    one HELP and one TYPE line before it."""
    typed, out = {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            typed.setdefault(parts[2], set()).add(parts[1])
            continue
        series, value = line.rsplit(" ", 1)
        name = series.split("{", 1)[0]
        family = name if name in typed else re.sub(r"_(bucket|sum|count)$", "", name)
        if typed.get(family) != {"HELP", "TYPE"}:
            raise RuntimeError(f"[obs] the scrape's line {line!r} has no HELP and TYPE")
        out[series] = float(value)
    return out


def _obs_spans_under(spans: list, execute: dict) -> set:
    """The names of the spans whose parent chain reaches `execute`."""
    by_id = {e["args"]["span_id"]: e for e in spans}
    names = set()
    for e in spans:
        p = e
        while p is not None and p is not execute:
            p = by_id.get(p["args"].get("parent"))
        if p is execute and e is not execute:
            names.add(e["name"])
    return names


def _obs_cli_json(sock: str, sub: str) -> tuple[dict, float]:
    """`python -m spgemm_tpu_torch.cli <sub> --socket sock --json` in its own
    process: (its answer, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", sub, "--socket", sock,
                        "--json"], env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"[obs] cli {sub} --json exited {r.returncode}: {r.stderr[-2000:]}")
    return json.loads(r.stdout), time.perf_counter() - t0


def _obs_hbm_range(what: str, value, inputs_bytes: int) -> None:
    """On the card: value lies between the resident Medium inputs and the
    card's memory; on the CPU it is absent (the device reports nothing)."""
    if DEVICE == "cpu":
        if value is not None:
            raise RuntimeError(f"[obs] {what} on the CPU: {value} (want it omitted)")
        return
    total = torch.cuda.get_device_properties(0).total_memory
    if value is None or not inputs_bytes <= value <= total:
        raise RuntimeError(f"[obs] {what} {value} is not between the resident inputs' "
                           f"{inputs_bytes} bytes and the card's {total}")


def _obs_after_ab(client, sock: str, jobs: dict, base: dict, tmp: str, smi: str,
                  inputs_bytes: int) -> dict:
    """[obs] after (a) and (b), on the first daemon: the scrape, (a)'s spans,
    both jobs' events, `cli trace-dump` merging this process's dump with the
    daemon's on (a)'s trace id; then obs/profile and obs/slo: `cli profile
    --json`'s build records, the plan phase histogram against the jobs'
    plan spans, the device memory peak (the gauge and (a)'s detail), `cli
    slo --json`'s tenant row."""
    t0 = time.perf_counter()
    series = _obs_series(client.metrics(sock))
    launches = sum(jobs[leg]["detail"].get("launches_numeric_round", 0) for leg in ("a", "b"))
    key = 'spgemm_engine_events_total{event="launches_numeric_round"}'
    grown = series.get(key, 0) - base.get(key, 0)
    done = series.get('spgemmd_jobs_terminal_total{outcome="done"}')
    if done != 2 or grown != launches or (DEVICE == "cuda" and launches < 2):
        raise RuntimeError(f"[obs] after (a), (b): done {done}, kernel-1 launches counter grown "
                           f"by {grown} against the jobs' {launches}")
    a = jobs["a"]
    spans = [e for e in client.trace(sock) if e["ph"] == "X"]
    mine = [e for e in spans if e["args"].get("job_id") == a["id"]]
    execs = [e for e in mine if e["name"] == "serve_execute"]
    if len(execs) != 1 or any(e["args"].get("trace_id") != a["trace"] for e in mine):
        raise RuntimeError(f"[obs] (a)'s spans: {len(execs)} serve_execute, trace ids "
                           f"{sorted({str(e['args'].get('trace_id')) for e in mine})}")
    ex = execs[0]
    nested = _obs_spans_under(mine, ex)
    plans = [e for e in mine if e["name"] == "plan"]
    inside = all(ex["ts"] <= e["ts"] and e["ts"] + e["dur"] <= ex["ts"] + ex["dur"] + 1.0
                 for e in plans)
    if not {"upload", "numeric_dispatch", "plan_wait"} <= nested or not plans or not inside:
        raise RuntimeError(f"[obs] (a)'s spans under its serve_execute: {sorted(nested)}; "
                           f"{len(plans)} plan spans, inside it: {inside}")
    evs = client.events(200, sock)
    for leg in ("a", "b"):
        kinds = [e["kind"] for e in evs if e.get("job_id") == jobs[leg]["id"]
                 and e["kind"].startswith("job_")]
        if kinds != ["job_submit", "job_start", "job_done"]:
            raise RuntimeError(f"[obs] ({leg})'s lifecycle events: {kinds}")
    dumps = os.path.join(tmp, "obs_dumps")
    from spgemm_tpu_torch.obs import trace as obs_trace  # noqa: PLC0415

    obs_trace.dump_json(os.path.join(dumps, "client.trace.json"), process_name="chip_smoke")
    t1 = time.perf_counter()
    cli = [sys.executable, "-m", "spgemm_tpu_torch.cli", "trace-dump", "--socket", sock]
    env = {**os.environ, "PYTHONPATH": REPO}
    for extra in (["-o", os.path.join(dumps, "daemon.trace.json")],
                  ["--merge", dumps, "--trace", a["trace"], "-o",
                   os.path.join(tmp, "merged.json")]):
        r = subprocess.run(cli + extra, env=env, cwd=REPO, capture_output=True, text=True,
                           timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"[obs] cli trace-dump {extra[0]} exited {r.returncode}: "
                               f"{r.stderr[-2000:]}")
    dump_s = time.perf_counter() - t1
    merged = json.load(open(os.path.join(tmp, "merged.json")))
    xs = [e for e in merged if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    if {e["args"].get("trace_id") for e in xs} != {a["trace"]} \
            or not {"client_submit", "serve_execute", "numeric_dispatch"} <= names \
            or len({e["pid"] for e in xs}) != 2:
        raise RuntimeError(f"[obs] the merged trace of (a): {sorted(names)} on "
                           f"{len({e['pid'] for e in xs})} process tracks")
    # obs/profile and obs/slo
    prof, prof_s = _obs_cli_json(sock, "profile")
    builds = {}
    for rec in prof["compiles"]:
        builds.setdefault(rec["site"], rec)
    sites = ("numeric_round", "native") if DEVICE == "cuda" else ("native",)
    for site in sites:
        rec = builds.get(site)
        if rec is None or not isinstance(rec.get("built"), bool) or not rec["wall_s"] > 0:
            raise RuntimeError(f"[obs] cli profile --json: no build record for {site} with "
                               f"built and a wall: {sorted(builds)}")
    key = 'spgemm_phase_seconds_count{phase="plan"}'
    plan_grown = series.get(key, 0) - base.get(key, 0)
    ab_ids = {jobs["a"]["id"], jobs["b"]["id"]}
    plan_spans = sum(1 for e in spans if e["name"] == "plan" and e["args"].get("job_id") in ab_ids)
    if plan_grown != plan_spans or plan_spans < len(plans):
        raise RuntimeError(f"[obs] {key} grew by {plan_grown}, the jobs' plan spans are "
                           f"{plan_spans}")
    hbm = series.get("spgemm_hbm_peak_bytes")
    _obs_hbm_range("spgemm_hbm_peak_bytes", None if hbm is None else int(hbm), inputs_bytes)
    a_peak = a["detail"].get("hbm_peak_bytes")
    _obs_hbm_range("(a)'s detail hbm_peak_bytes", a_peak, inputs_bytes)
    slo_rep, slo_s = _obs_cli_json(sock, "slo")
    row = slo_rep["tenants"].get("default", {})
    if row.get("jobs") != 2 or row.get("error_ratio") != 0 \
            or set(row.get("latency_s", {})) != {"p50", "p95", "p99"}:
        raise RuntimeError(f"[obs] cli slo --json: the default tenant's row {row}")
    walls = [round(max(0.0, j["finished_at"] - (j["started_at"] or j["submitted_at"])), 6)
             for j in (jobs["a"], jobs["b"])]
    out = {"done": done, "launches_grown": grown, "jobs_launches": launches,
           "a_spans": len(mine), "a_nested": sorted(nested), "a_plan_spans": len(plans),
           "merged_events": len(merged), "merged_spans": len(xs), "trace_dump_s": dump_s,
           "families": len({k.split("{")[0] for k in series}),
           "builds": {site: {k: rec[k] for k in ("built", "wall_s")}
                      for site, rec in sorted(builds.items())},
           "profile_cli_s": prof_s, "slo_cli_s": slo_s, "plan_count_grown": plan_grown,
           "plan_spans_ab": plan_spans, "hbm_peak_bytes": hbm, "a_hbm_peak_bytes": a_peak,
           "inputs_bytes": inputs_bytes, "slo": row, "daemon_walls_s": walls,
           "leg_s": time.perf_counter() - t0}
    print(f"[obs] after (a), (b) on {smi}: the scrape parses ({out['families']} series names), "
          f"jobs done {done}, launches_numeric_round grew by {grown} = the jobs' {launches}; "
          f"(a) {a['id']} tags {len(mine)} spans, {sorted(nested)} under its serve_execute, "
          f"{len(plans)} plan spans inside it; job_submit, job_start, job_done for both; cli "
          f"trace-dump (daemon ring, then --merge with this process's dump on (a)'s trace) "
          f"{dump_s:.3f} s: {len(xs)} spans on 2 process tracks; leg {out['leg_s']:.3f} s",
          flush=True)
    print(f"[obs] profile after (a), (b) on {smi}: cli profile --json {prof_s:.3f} s, build "
          f"records (built, wall s) {out['builds']}; "
          f"spgemm_phase_seconds_count{{phase=\"plan\"}} grew by {plan_grown:g} = (a)'s and "
          f"(b)'s {plan_spans} plan spans; spgemm_hbm_peak_bytes {hbm} (the allocator's peak), "
          f"(a)'s detail hbm_peak_bytes {a_peak}, against the resident inputs' {inputs_bytes} "
          f"bytes", flush=True)
    print(f"[obs] slo after (a), (b) on {smi}: cli slo --json {slo_s:.3f} s: tenant default "
          f"jobs {row['jobs']}, error_ratio {row['error_ratio']}, latency_s {row['latency_s']}, "
          f"queue_wait_share {row['queue_wait_share']} (the jobs' daemon walls {walls} s)",
          flush=True)
    return out


def _obs_delta(client, sock: str, base: dict, want: int, leg: str, smi: str) -> dict:
    """[obs] the delta accountability on a daemon: the dirty-fraction
    histogram grown by exactly `want` delta multiplies since the scrape
    `base`, 0 mispredictions."""
    series = _obs_series(client.metrics(sock))
    key = "spgemm_delta_dirty_fraction"
    grown = series.get(f"{key}_count", 0) - base.get(f"{key}_count", 0)
    mis = series.get("spgemm_delta_mispredictions_total")
    if grown != want or mis != 0:
        raise RuntimeError(f"[obs] after ({leg}): {key}_count grew by {grown} against the "
                           f"{want} delta multiplies, mispredictions {mis}")
    buckets = {le: series.get(f'{key}_bucket{{le="{le}"}}', 0)
               - base.get(f'{key}_bucket{{le="{le}"}}', 0) for le in ("0", "0.01", "0.9")}
    print(f"[obs] delta after ({leg}) on {smi}: {key}_count grew by {grown:g} = the daemon's "
          f"{want} delta multiplies (of them at dirty fraction 0: {buckets['0']:g}, <= 0.01: "
          f"{buckets['0.01']:g}, <= 0.9: {buckets['0.9']:g}); "
          f"spgemm_delta_mispredictions_total {mis:g}", flush=True)
    return {"grown": grown, "mispredictions": mis, "buckets": buckets, "series": series}


def _obs_after_e(client, sock: str, reaped_id: str, reaped_trace: str, smi: str) -> dict:
    """[obs] after (e), on the second daemon: the watchdog's events, the
    flight dumps (the reaped job's holds its spans and the reap marker), and
    the SLO burn the reap set off: the gauge at 1 and one slo_burn event
    carrying the trace id the client minted for the reaped job."""
    t0 = time.perf_counter()
    evs = client.events(500, sock)
    kinds = [e["kind"] for e in evs]
    want = ("watchdog_reap", "watchdog_wedge", "daemon_degrade", "slice_recovered")
    reap = [e for e in evs if e["kind"] == "watchdog_reap"]
    if any(k not in kinds for k in want) or [e.get("job_id") for e in reap] != [reaped_id]:
        raise RuntimeError(f"[obs] (e)'s events: {kinds}")
    flight = sock + ".flight"
    files = sorted(os.listdir(flight))
    need = {f"{reaped_id}.trace.json", f"{reaped_id}.wedged.trace.json", "degrade.trace.json"}
    if not need <= set(files):
        raise RuntimeError(f"[obs] (e)'s flight dumps: {files}")
    dump = json.load(open(os.path.join(flight, f"{reaped_id}.trace.json")))
    if not isinstance(dump, list) or not all({"name", "ph", "pid", "tid"} <= set(e)
                                             for e in dump):
        raise RuntimeError("[obs] the reaped job's flight dump is not trace-event JSON")
    job_spans = {e["name"] for e in dump if (e.get("args") or {}).get("job_id") == reaped_id}
    if "serve_execute" in job_spans or not {"serve_load", "serve_reap"} <= job_spans:
        raise RuntimeError(f"[obs] the reaped job's flight dump: its spans {sorted(job_spans)}")
    series = _obs_series(client.metrics(sock))
    gauge = {k: v for k, v in series.items() if k.startswith("spgemm_slo_burn_active{")}
    burns = [e for e in evs if e["kind"] == "slo_burn"]
    if list(gauge.values()) != [1.0] or 'tenant="default"' not in next(iter(gauge)) \
            or len(burns) != 1 or burns[0].get("trace_id") != reaped_trace:
        raise RuntimeError(f"[obs] (e)'s SLO burn: gauge {gauge}, slo_burn events {burns}, "
                           f"the client's trace {reaped_trace}")
    out = {"kinds": kinds, "flight": files, "reaped_spans": sorted(job_spans),
           "dump_events": len(dump), "burn_gauge": gauge, "slo_burn": burns[0],
           "series": series, "leg_s": time.perf_counter() - t0}
    b = burns[0]
    print(f"[obs] after (e) on {smi}: events {', '.join(want)} present; flight dumps {files}; "
          f"{reaped_id}'s ({len(dump)} trace events) holds its spans {sorted(job_spans)}; "
          f"{next(iter(gauge))} {gauge[next(iter(gauge))]:g}; one slo_burn event (fast_burn "
          f"{b['fast_burn']}, slow_burn {b['slow_burn']}, bad {b['bad']} of {b['jobs']}, target "
          f"{b['target_s']} s, budget {b['error_pct']}%) with trace_id {b['trace_id']} = the "
          f"client's {reaped_trace}; leg {out['leg_s']:.3f} s", flush=True)
    return out


def _obs_after_h(client, sock: str, smi: str, slo_before: int) -> dict:
    """[obs] after (h), on the daemon in this process: the batch-size
    histogram holds the batch of 4, the tenant's SLO jobs grew by the 4
    members (slo_before: its jobs before the resubmits), and one `metrics`
    and one `trace` op timed against this process's ring."""
    from spgemm_tpu_torch.obs import trace as obs_trace  # noqa: PLC0415

    t0 = time.perf_counter()
    text = client.metrics(sock)
    metrics_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    evs = client.trace(sock)
    trace_s = time.perf_counter() - t1
    ring = obs_trace.RECORDER.stats()
    series = _obs_series(text)
    hist = {k: v for k, v in series.items() if k.startswith("spgemm_serve_batch_size")}
    if hist.get("spgemm_serve_batch_size_count") != 1 \
            or hist.get("spgemm_serve_batch_size_sum") != SERVE_BATCH_FOLDERS \
            or hist.get('spgemm_serve_batch_size_bucket{le="4"}') != 1 \
            or hist.get('spgemm_serve_batch_size_bucket{le="2"}') != 0:
        raise RuntimeError(f"[obs] (h)'s batch-size histogram: {hist}")
    slo_after = client.slo(sock)["tenants"]["default"]["jobs"]
    if slo_after - slo_before != SERVE_BATCH_FOLDERS:
        raise RuntimeError(f"[obs] (h)'s SLO records: the tenant's jobs {slo_before} -> "
                           f"{slo_after}, not one record per member")
    return {"metrics_op_s": metrics_s, "trace_op_s": trace_s, "ring": ring,
            "trace_events": len(evs), "metrics_bytes": len(text), "batch_size": hist,
            "slo_jobs": (slo_before, slo_after)}


def _obs_report_h(obs: dict, smi: str) -> None:
    ring = obs["ring"]
    print(f"[obs] after (h) on {smi}: spgemm_serve_batch_size {obs['batch_size']}; the "
          f"tenant's SLO jobs {obs['slo_jobs'][0]} -> {obs['slo_jobs'][1]} (one record per "
          f"member of the batch of {SERVE_BATCH_FOLDERS}); against a "
          f"ring of {ring['spans']} spans (capacity {ring['capacity']}, {ring['dropped']} "
          f"evicted so far): one metrics op {obs['metrics_op_s'] * 1e3:.3f} ms "
          f"({obs['metrics_bytes']} bytes), one trace op {obs['trace_op_s'] * 1e3:.3f} ms "
          f"({obs['trace_events']} trace events)", flush=True)


def _obs_overhead(medium, smi: str) -> dict:
    """The warm Medium chain in this process (delta off, plans warm), walls
    closed by torch.cuda.synchronize(), with SPGEMM_TPU_OBS_TRACE 1 and 0
    in turns (on, off, off, on) OBS_PAIRS times; the spans one chain emits
    (a chain of more than the ring's capacity would drop its own oldest)."""
    from spgemm_tpu_torch.obs import trace as obs_trace  # noqa: PLC0415

    t0 = time.perf_counter()
    _timed_chain(medium.dev_mats, medium.res)  # plans warm
    walls = {"1": [], "0": []}
    spans = []
    for _ in range(OBS_PAIRS):
        for on in ("1", "0", "0", "1"):
            before = obs_trace.RECORDER.stats()
            walls[on].append(_timed_chain(medium.dev_mats, medium.res,
                                          SPGEMM_TPU_OBS_TRACE=on)["wall_s"])
            after = obs_trace.RECORDER.stats()
            if on == "1":
                spans.append(after["emitted"] - before["emitted"])
            elif after["emitted"] != before["emitted"]:
                raise RuntimeError("[obs] SPGEMM_TPU_OBS_TRACE=0 emitted spans")
    med = {on: sorted(w)[len(w) // 2] for on, w in walls.items()}
    cap = obs_trace.RECORDER.stats()["capacity"]
    # the host cost of what the recorder's knob turns on besides the spans:
    # a memory sample (9 a Medium chain) against reading the same two
    # counters through memory_allocated and max_memory_allocated, and one
    # phase observation (36 a chain)
    dev = torch.device(DEVICE)
    costs_us = {}
    for what, fn in (
            ("memory_sample", partial(engine._observe_memory, dev)),
            ("memory_allocated_and_max", lambda: (torch.cuda.memory_allocated(dev),
                                                  torch.cuda.max_memory_allocated(dev))),
            ("observe_phase", partial(obs_profile.observe_phase, "plan", 0.001))):
        t1 = time.perf_counter()
        for _ in range(OBS_COST_REPEATS):
            fn()
        costs_us[what] = (time.perf_counter() - t1) / OBS_COST_REPEATS * 1e6
    out = {"walls_s": walls, "median_s": med, "spans_per_chain": spans, "ring_capacity": cap,
           "costs_us": costs_us, "leg_s": time.perf_counter() - t0}
    print(f"[obs] recorder on against off, the warm Medium chain on {smi} (in turns on, off, "
          f"off, on, x{OBS_PAIRS}): on {', '.join(f'{w:.6f}' for w in walls['1'])} s, off "
          f"{', '.join(f'{w:.6f}' for w in walls['0'])} s; medians on {med['1']:.6f} s, off "
          f"{med['0']:.6f} s ({(med['1'] / med['0'] - 1) * 100:+.2f}%); spans emitted per chain "
          f"{sorted(set(spans))} against a ring of {cap} (a chain drops "
          f"{max(0, max(spans) - cap)} of its own; the medians' gap is "
          f"{(med['1'] - med['0']) / max(spans) * 1e6:.2f} us a span, each span also feeding "
          f"obs/profile's phase histogram); on slower in "
          f"{sum(a > b for a, b in zip(walls['1'], walls['0']))} of {len(walls['1'])} pairs; "
          f"host cost (mean of {OBS_COST_REPEATS}): a memory sample "
          f"{costs_us['memory_sample']:.2f} us (memory_allocated and max_memory_allocated: "
          f"{costs_us['memory_allocated_and_max']:.2f} us), an observe_phase "
          f"{costs_us['observe_phase']:.2f} us; leg {out['leg_s']:.3f} s", flush=True)
    return out


def phase_serve(medium, cli: dict, tmp: str) -> dict:
    """[serve]: the port's daemon (`python -m spgemm_tpu_torch.cli serve`, on
    the card) driven with its client over text directories of the Medium
    chain and of the Medium chain of distinct structures, written under tmp
    (where [tune] finds them, with (a)'s and (c)'s results as result_a and
    result_c): (a) Medium cold, (b) Medium again (every plan a
    hit), (c0) the chain of distinct structures, (c) the same with 11 tile
    rows of M5 given new values (delta recompute and the splice); then a
    second daemon on the same socket and warm directory, started with the
    watchdog leg armed: (e) (_serve_watchdog) and (d), Medium again (warm
    hits).  Each result is read back and held against the in-memory
    engine's.  Every job of (a)-(d) must run kernel 1 on the card, and no
    degrade but (e)'s may happen.  Each job's own counters come from its
    PhaseScope in the daemon: zero at pickup, read at its end.  The [obs]
    leg reads the same daemons' `metrics`, `trace` and `events` ops and
    flight dumps (_obs_after_ab, _obs_after_e, _obs_after_h) and, last,
    times the warm Medium chain with the recorder on and off
    (_obs_overhead)."""
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    want_a = medium.res_host.prune_zeros()
    dmats = _distinct_mats(medium.mats)
    with contextlib.redirect_stdout(io.StringIO()):
        want_c0 = chain_product(dmats, device=DEVICE).prune_zeros()
        edited = list(dmats)
        leaf = dmats[SERVE_EDIT_LEAF]
        mid = leaf.rows // leaf.k // 2  # 11 contiguous tile rows from the middle
        edited[SERVE_EDIT_LEAF] = _edit_rows(leaf, np.arange(SERVE_EDIT_ROWS) + mid,
                                             np.random.default_rng(SEED + 5))
        want_c = chain_product(edited, device=DEVICE).prune_zeros()
    out = {}
    t1 = time.perf_counter()
    medium_dir, distinct_dir = os.path.join(tmp, "medium"), os.path.join(tmp, "distinct")
    _write_text_dir(medium_dir, medium.mats)
    _write_text_dir(distinct_dir, dmats)
    out["write_dirs_s"] = time.perf_counter() - t1
    sock, log_path = os.path.join(tmp, "d.sock"), os.path.join(tmp, "d.log")
    proc, out["start"] = _serve_start(sock, _serve_env(), log_path)
    try:
        res, res_a = os.path.join(tmp, "result"), os.path.join(tmp, "result_a")
        jobs = {}
        obs_base = _obs_series(client.metrics(sock))
        # (a) is read back against the engine; (b) and (d) must give its bytes
        for leg, folder, want in (("a", medium_dir, want_a), ("b", medium_dir, res_a),
                                  ("c0", distinct_dir, want_c0)):
            jobs[leg], wall = _serve_job(client, sock, folder, res)
            _serve_check(leg, jobs[leg], res, want, keep=res_a if leg == "a" else None)
            out[f"flush_{leg}_s"] = _serve_idle(client, sock)
            out[leg] = _serve_report(leg, jobs[leg], wall, smi)
            if leg == "b":
                out["obs_ab"] = _obs_after_ab(client, sock, jobs, obs_base, tmp, smi,
                                              sum(m.tiles.nbytes for m in medium.mats))
        a, b = jobs["a"]["detail"], jobs["b"]["detail"]
        if b["plan_cache_misses"] or \
                b["plan_cache_hits"] != a["plan_cache_hits"] + a["plan_cache_misses"]:
            raise RuntimeError(f"[serve] (b) is not every plan a hit: (a) hits "
                               f"{a['plan_cache_hits']} misses {a['plan_cache_misses']}, "
                               f"(b) hits {b['plan_cache_hits']} misses "
                               f"{b['plan_cache_misses']}")
        io_text.write_matrix(os.path.join(distinct_dir, f"matrix{SERVE_EDIT_LEAF + 1}"),
                             edited[SERVE_EDIT_LEAF])
        jobs["c"], wall = _serve_job(client, sock, distinct_dir, res)
        _serve_check("c", jobs["c"], res, want_c, keep=os.path.join(tmp, "result_c"))
        out["flush_c_s"] = _serve_idle(client, sock)
        out["c"] = _serve_report("c", jobs["c"], wall, smi)
        c = jobs["c"]["detail"]
        if not 0 < c["delta_rows"] < c["total_rows"] or \
                (DEVICE == "cuda" and c.get("launches_splice", 0) < 1):
            raise RuntimeError(f"[serve] (c) did not take the delta path: {c}")
        st = client.stats(sock)
        card = {"type": "cuda", "name": torch.cuda.get_device_name(0)} if DEVICE == "cuda" \
            else {"type": "cpu", "name": "cpu"}
        if st["device"] != card \
                or st["degraded"] or st["serve"]["serve_degrades"]:
            raise RuntimeError(f"[serve] stats: {st['device']}, degraded {st['degraded']}, "
                               f"{st['serve']}")
        out["warm_disk"] = {k: st["warm"][k] for k in ("plans", "deltas", "bytes")}
        # the pool's rows: one card, one single-device slice, nothing stolen
        rows = st["slices"]
        if [(r["name"], r["width"], r["devices"], r["device"], r["steals"]) for r in rows] \
                != [("s0w1", 1, [0], "cuda:0", 0)]:
            raise RuntimeError(f"[serve] stats' pool rows: {rows}")
        out["pool_rows"] = [{k: r[k] for k in ("name", "width", "devices", "device", "default",
                                               "steals", "jobs_total", "recoveries")}
                            for r in rows]
        # (a), (b), (c0), (c): every multiply of the four jobs took the delta path
        out["obs_c"] = _obs_delta(client, sock, obs_base, 4 * (MEDIUM["n"] - 1), "c", smi)
        _serve_stop(proc, sock, client, log_path)
        # the second daemon: the watchdog leg armed (its knobs), then (d)
        env_e = _serve_env(SPGEMM_TPU_FAILPOINTS="serve.heartbeat:1:1",
                           SPGEMM_TPU_SERVE_JOB_TIMEOUT=str(SERVE_TIMEOUT_S),
                           SPGEMM_TPU_SERVE_WEDGE_GRACE_S=str(SERVE_GRACE_S),
                           SPGEMM_TPU_SERVE_RECOVER_S=str(SERVE_RECOVER_S),
                           SPGEMM_TPU_SLO_TARGET_S=str(SERVE_SLO_TARGET_S),
                           SPGEMM_TPU_SLO_ERROR_PCT=str(SERVE_SLO_ERROR_PCT))
        proc, out["restart"] = _serve_start(sock, env_e, log_path)
        out["e"] = _serve_watchdog(client, sock, tmp)
        out["obs_e"] = _obs_after_e(client, sock, out["e"]["job_id"], out["e"]["trace"],
                                    smi)
        jobs["d"], wall = _serve_job(client, sock, medium_dir, res, timeout_s=0)
        _serve_check("d", jobs["d"], res, res_a)
        out["d"] = _serve_report("d", jobs["d"], wall, smi)
        out["obs_d"] = _obs_delta(client, sock, out["obs_e"]["series"], MEDIUM["n"] - 1,
                                  "d", smi)
        if jobs["d"]["detail"].get("warm_hits", 0) < 1:
            raise RuntimeError(f"[serve] (d) no warm hit: {jobs['d']['detail']}")
        st = client.stats(sock)
        if st["degraded"] or st["serve"]["serve_degrades"] != 1:
            raise RuntimeError(f"[serve] (d) a degrade besides (e)'s: {st['serve']}")
        _serve_stop(proc, sock, client, log_path)
        t_batch = time.perf_counter()
        out["batch"] = _serve_batch_legs(medium, tmp, smi)
        out["batch_s"] = time.perf_counter() - t_batch
        out["obs_overhead"] = _obs_overhead(medium, smi)
    finally:
        if proc.poll() is None:
            proc.kill()
    stderr_degrade = [ln for ln in open(log_path)
                      if ln.startswith("spgemmd: slice") and " degraded: " in ln]
    oracle = [ln for ln in open(log_path) if "serves on the host oracle" in ln]
    if len(stderr_degrade) != 1 or oracle:
        raise RuntimeError(f"[serve] want one stderr degrade line, (e)'s, and none "
                           f"handing a slice to the oracle, got {stderr_degrade + oracle}")
    e = out["e"]
    obs_s = out["obs_ab"]["leg_s"] + out["obs_e"]["leg_s"] + out["obs_overhead"]["leg_s"]
    _phase("serve", t0, f"on {smi}: daemon up in {out['start']['start_s']:.3f} s, of which "
           f"its probe and warm-up {out['start']['probe_warm_s']} s (restart "
           f"{out['restart']['start_s']:.3f} s, {out['restart']['probe_warm_s']} s); two text "
           f"directories written in {out['write_dirs_s']:.3f} s; submit walls (a) Medium cold "
           f"{out['a']['wall_s']:.6f} s, (b) again {out['b']['wall_s']:.6f} s, (c0) distinct "
           f"structures {out['c0']['wall_s']:.6f} s, (c) 11 rows of M5 edited "
           f"{out['c']['wall_s']:.6f} s (delta rows {c['delta_rows']} of {c['total_rows']}, "
           f"splice launches {c.get('launches_splice', 0)}), (d) after a restart "
           f"{out['d']['wall_s']:.6f} s (warm hits {jobs['d']['detail']['warm_hits']}); the warm "
           f"flush after (a), (b), (c0), (c): {out['flush_a_s']:.3f}, {out['flush_b_s']:.3f}, "
           f"{out['flush_c0_s']:.3f}, {out['flush_c_s']:.3f} s past the read-back (store "
           f"{out['warm_disk']}); the "
           f"run-once CLI's time taken on the same Medium directory "
           f"{cli['default']['time_taken_s']:.6f} s; (a), (c0), (c) equal to the in-memory "
           f"engine's result, (b) and (d) to (a)'s bytes, kernel 1 on the card in every job, no degrade but (e)'s; (e) reaped at "
           f"{e['reaped_s']:.3f} s, degraded at {e['degraded_s']:.3f} s (one stderr line), probe "
           f"{e['probe']}, reinstated at {e['reinstated_s']:.3f} s, canary "
           f"{e['canary_wall_s']:.6f} s with {e['canary_launches']} kernel 1 launches, oracle "
           f"bytes, no job on the oracle, {e['serve']}; the batching legs (f), (g), (h) "
           f"{out['batch_s']:.3f} s; the [obs] leg {obs_s:.3f} s (after (a), (b) "
           f"{out['obs_ab']['leg_s']:.3f}, after (e) {out['obs_e']['leg_s']:.3f}, recorder "
           f"on/off {out['obs_overhead']['leg_s']:.3f}); the phase beyond writing the directories "
           f"{time.perf_counter() - t0 - out['write_dirs_s']:.3f} s")
    return out


TUNE_TRIAL_S = 0.5   # [tune]: the daemon's idle-trial cadence
TUNE_WAIT_S = 300.0  # [tune]: the longest wait for a class to leave trialing
TUNE_KERNELS = ("launches_numeric_round", "launches_dense_fold")


def _tune_rows(client, sock: str) -> dict:
    """The daemon's tuner rows by class key."""
    return {r["class"]: r for r in client.stats(sock)["tune"]["classes"]}


def _tune_settle(client, sock: str, ck: str | None) -> dict:
    """Poll `stats` until class ck (the only class when None) holds a state
    other than idle or trialing; its row."""
    deadline = time.time() + TUNE_WAIT_S
    while time.time() < deadline:
        rows = _tune_rows(client, sock)
        row = rows.get(ck) if ck is not None else (next(iter(rows.values())) if rows else None)
        if row is not None and row["state"] not in ("idle", "trialing"):
            return row
        time.sleep(0.1)
    raise RuntimeError(f"[tune] class {ck} did not leave trialing in {TUNE_WAIT_S:g} s: "
                       f"{_tune_rows(client, sock)}")


def _tune_events(client, sock: str, kind: str, ck: str | None = None) -> list:
    return [e for e in client.events(512, sock)
            if e["kind"] == kind and (ck is None or e.get("class_key") == ck)]


def _tune_cli(sub: list, env: dict) -> dict:
    """`python -m spgemm_tpu_torch.cli <sub...> --json` in its own process."""
    r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", *sub, "--json"],
                       env={**env, "PYTHONPATH": REPO}, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"[tune] cli {sub} exited {r.returncode}: {r.stderr[-2000:]}")
    return json.loads(r.stdout)


def _tune_legs(legs: list, want_digest: str, smi: str) -> dict:
    """(t1)'s legs: one line each, the digest check, the kernels each route
    must launch on the card, and what the default SPGEMM_TPU_TUNE_MIN_WIN
    decides on these walls."""
    for e in legs:
        c = e["counters"]
        print(f"[tune] (t1) leg {e['knobs'] or 'base'} on {smi}: wall {e['seconds']:.6f} s, "
              f"plan {e['phases_s'].get('plan', 0.0):.4f} s, plan_wait "
              f"{e['phases_s'].get('plan_wait', 0.0):.4f} s, kernel 1 "
              f"{c.get('launches_numeric_round', 0)}, dense fold "
              f"{c.get('launches_dense_fold', 0)}, digest {e['digest'][:16]} "
              f"({'equal to' if e['digest'] == want_digest else 'DIFFERS FROM'} the in-memory "
              "result's)", flush=True)
    if any(e["digest"] != want_digest for e in legs):
        raise RuntimeError("[tune] (t1) a leg's digest differs from the in-memory result's")
    by_route = {e["knobs"].get("SPGEMM_TPU_ACCUM_ROUTE"): e["counters"] for e in legs}
    if DEVICE == "cuda" and (by_route["ladder"].get("launches_numeric_round", 0) < 1
                             or by_route["dense"].get("launches_dense_fold", 0) < 1):
        raise RuntimeError(f"[tune] (t1) the ladder leg ran no kernel 1 or the dense leg no "
                           f"fold: {by_route}")
    base = legs[0]["seconds"]
    best = min(legs[1:], key=lambda e: e["seconds"])
    win = base / best["seconds"]
    print(f"[tune] (t1) best candidate {best['knobs']}: win {win:.4f} (baseline / best wall); "
          f"the default SPGEMM_TPU_TUNE_MIN_WIN=1.1 would "
          f"{'promote it' if win >= 1.1 else 'settle the class untuned'}; this daemon runs "
          "with SPGEMM_TPU_TUNE_MIN_WIN=1 to drive the promotion path", flush=True)
    return {"walls": {json.dumps(e["knobs"]): e["seconds"] for e in legs},
            "plan_s": {json.dumps(e["knobs"]): e["phases_s"].get("plan", 0.0) for e in legs},
            "win": win, "best": best["knobs"], "default_min_win_promotes": win >= 1.1}


def phase_tune(medium, tmp: str) -> dict:
    """[tune]: the autotuner in the port's daemon on the card, over [serve]'s
    Medium and distinct-structure text directories under tmp (see the module
    docstring, (t1)-(t4)).  Every job's bytes equal the golden file ((a)'s
    and (c)'s results of [serve]), every leg's digest the in-memory Medium
    result's."""
    from spgemm_tpu_torch.serve import client  # noqa: PLC0415
    from spgemm_tpu_torch.serve.daemon import result_digest  # noqa: PLC0415

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    medium_dir, distinct_dir = os.path.join(tmp, "medium"), os.path.join(tmp, "distinct")
    golden, golden_c = os.path.join(tmp, "result_a"), os.path.join(tmp, "result_c")
    want_digest = result_digest(medium.res_host)
    warm = os.path.join(tmp, "tune.warm")
    sock, log_path, res = (os.path.join(tmp, n) for n in ("t.sock", "t.log", "t.result"))
    env = _serve_env(SPGEMM_TPU_WARM_DIR=warm, SPGEMM_TPU_TUNE="1",
                     SPGEMM_TPU_TUNE_TRIAL_S=str(TUNE_TRIAL_S), SPGEMM_TPU_TUNE_MIN_WIN="1")
    both = TUNE_KERNELS
    out = {"legs_launches": dict.fromkeys(TUNE_KERNELS, 0)}

    def medium_job(leg: str, **options) -> dict:
        job, wall = _serve_job(client, sock, medium_dir, res, **options)
        _serve_check(leg, job, res, golden, kernels=both)
        _serve_idle(client, sock)
        out[leg] = _serve_report(f"tune {leg}", job, wall, smi)
        return job

    def count_legs() -> list:
        legs = _tune_events(client, sock, "tune_trial")
        for e in legs:
            for k in TUNE_KERNELS:
                out["legs_launches"][k] += e["counters"].get(k, 0)
        return legs

    proc, out["start"] = _serve_start(sock, env, log_path)
    try:
        # (t1): the first job records Medium's structure, so the second has a class
        medium_job("t1.0", timeout_s=0)
        medium_job("t1.1", timeout_s=0)
        t_idle = time.perf_counter()
        row = _tune_settle(client, sock, None)
        ck = row["class"]
        out["t1_settle_s"] = time.perf_counter() - t_idle
        legs = _tune_events(client, sock, "tune_trial", ck)
        if [e["knobs"] for e in legs] != [{}, {"SPGEMM_TPU_ACCUM_ROUTE": "ladder"},
                                          {"SPGEMM_TPU_ACCUM_ROUTE": "dense"},
                                          {"SPGEMM_TPU_PLAN_AHEAD": "0"}]:
            raise RuntimeError(f"[tune] (t1) the legs are not the trial plan: {legs}")
        out["t1"] = _tune_legs(legs, want_digest, smi)
        out["t1"].update(state=row["state"], class_key=ck, knobs=row["knobs"], win_row=row["win"])
        print(f"[tune] (t1) class {ck}: {row['state']}, win {row['win']}, knobs {row['knobs']} "
              f"({out['t1_settle_s']:.3f} s from idle to settled)", flush=True)
        # (t2): the tuned canary
        if row["state"] == "canary":
            job = medium_job("t2", timeout_s=600)
            passed = _tune_events(client, sock, "tune_canary_passed", ck)
            row2 = _tune_rows(client, sock)[ck]
            if job["timeout_s"] != 300 or len(passed) != 1 or row2["state"] != "live":
                raise RuntimeError(f"[tune] (t2) the canary: deadline {job['timeout_s']}, "
                                   f"passed {passed}, {row2}")
            out["t2"] = {"timeout_s": job["timeout_s"], "state": row2["state"],
                         "launches": {k: job["detail"].get(k, 0) for k in TUNE_KERNELS}}
            print(f"[tune] (t2) the tuned canary under {row['knobs']}: deadline 600 -> "
                  f"{job['timeout_s']:g} s, golden bytes, launches {out['t2']['launches']}, one "
                  "tune_canary_passed, the class live", flush=True)
        else:
            out["t2"] = None
            print(f"[tune] (t2) skipped: nothing was promoted (the class is {row['state']}, "
                  f"win {row['win']} below SPGEMM_TPU_TUNE_MIN_WIN=1)", flush=True)
        # (t3): a new class, and a real job preempting its first leg
        for i in range(2):
            job, _ = _serve_job(client, sock, distinct_dir, res, timeout_s=0)
            # the second submit's content is unchanged: delta recompute serves
            # every row from the first's retained results, with no launch
            _serve_check(f"t3.{i}", job, res, golden_c, kernels=both if i == 0 else ())
            _serve_idle(client, sock)
        trials = client.stats(sock)["tune"]["trials"]
        deadline = time.time() + 60
        while client.stats(sock)["tune"]["trials"] == trials:
            if time.time() > deadline:
                raise RuntimeError("[tune] (t3) no leg of the new class started")
            time.sleep(0.01)
        job, wall = _serve_job(client, sock, medium_dir, res, timeout_s=0)
        _serve_check("t3", job, res, golden, kernels=both)
        _serve_idle(client, sock)
        pre = [e for e in _tune_events(client, sock, "tune_trial_preempted") if e["class_key"] != ck]
        if not pre or pre[-1]["reason"] != "preempted":
            raise RuntimeError(f"[tune] (t3) no preempted leg of the new class: {pre}")
        qwait = job["detail"]["phases_s"].get("serve_queue_wait", 0.0)
        out["t3"] = {"queue_wait_s": qwait, "wall_s": wall, "preempted": pre[-1]["knobs"]}
        print(f"[tune] (t3) Medium submitted while the new class's leg {pre[-1]['knobs'] or 'base'} "
              f"ran: tune_trial_preempted (preempted), its serve_queue_wait {qwait:.4f} s "
              f"(a leg's read plus one multiply at most), submit wall {wall:.6f} s", flush=True)
        count_legs()
        _serve_stop(proc, sock, client, log_path)
        # (t4): the restart adopts the persisted records
        proc, out["restart"] = _serve_start(sock, env, log_path)
        rows = _tune_rows(client, sock)
        if row["state"] == "canary" and rows.get(ck, {}).get("state") != "live":
            raise RuntimeError(f"[tune] (t4) the live record was not adopted: {rows}")
        tune_cli = _tune_cli(["tune", "--status", "--dir", warm], env)
        knobs_cli = _tune_cli(["knobs"], env)
        marked = {r["name"]: r["tuned_classes"] for r in knobs_cli["knobs"]
                  if r.get("tuned_classes")}
        if set(tune_cli["overrides"]) != {k for k, r in rows.items()
                                          if r["state"] in ("canary", "live", "reverted")} \
                or any(ck not in marked.get(k, [ck]) for k in row["knobs"]):
            raise RuntimeError(f"[tune] (t4) cli tune / knobs disagree with stats: "
                               f"{tune_cli['overrides']} {marked} {rows}")
        out["t4"] = {"adopted": {k: r["state"] for k, r in rows.items()}, "marked": marked}
        print(f"[tune] (t4) restart: adopted {out['t4']['adopted']} (a canary record "
              f"re-auditions at its class's first job); cli tune --status --json "
              f"{sorted(tune_cli['overrides'])}; cli knobs --json marks {marked}", flush=True)
        medium_job("t4.0", timeout_s=0)  # the restarted daemon's first contact
        job = medium_job("t4.1", timeout_s=0)  # under the adopted vector
        out["t4"]["launches"] = {k: job["detail"].get(k, 0) for k in TUNE_KERNELS}
        count_legs()
        _serve_stop(proc, sock, client, log_path)
    finally:
        if proc.poll() is None:
            proc.kill()
    if DEVICE == "cuda" and (out["legs_launches"]["launches_numeric_round"] < 1
                             or out["legs_launches"]["launches_dense_fold"] < 1):
        raise RuntimeError(f"[tune] the legs launched {out['legs_launches']}")
    _phase("tune", t0, f"on {smi}: daemon starts {out['start']['start_s']:.3f}, "
           f"{out['restart']['start_s']:.3f} s; the trial "
           f"legs' launches {out['legs_launches']}; class {out['t1']['state']} at win "
           f"{out['t1']['win']:.4f}; (t2) {'ran' if out['t2'] else 'skipped'}; (t3) queue wait "
           f"{out['t3']['queue_wait_s']:.4f} s")
    return out


FLEET_POLL_S = 0.5     # [fleet]: the router's poll cadence
FLEET_WAIT_S = 600.0   # [fleet]: the deadline of every wait through the router
FLEET_KILL_SMALL = 4   # [fleet] (f5): small chains submitted beside Medium


def _fleet_fail(procs, msg: str):
    """RuntimeError(msg) with the tail of every process's log."""
    tails = "".join(f"\n--- {p.log_path}:\n" + open(p.log_path, errors="replace").read()[-3000:]
                    for p in procs)
    return RuntimeError(f"[fleet] {msg}{tails}")


def _fleet_job_check(leg: str, job: dict, out: str, want, procs) -> int:
    """A done job of the fleet: run on the card (the CPU when DEVICE is),
    not degraded, kernel 1 launched on the card, ./out equal to want (a
    path: byte for byte; else read back against the engine's result).  Its
    kernel-1 launches."""
    det = job.get("detail") or {}
    launches = det.get("launches_numeric_round", 0)
    if job.get("state") != "done" or det.get("degraded") is not False \
            or det.get("device") != ("cuda:0" if DEVICE == "cuda" else "cpu") \
            or (DEVICE == "cuda" and launches < 1):
        raise _fleet_fail(procs, f"({leg}) job {job.get('id')} did not run on the card: "
                                 f"{job.get('state')} {job.get('error')} {det}")
    if isinstance(want, str):
        same = _same_bytes(out, want)
    else:
        same = _host_equal(io_text.read_matrix(out, want.k), want)
    if not same:
        raise _fleet_fail(procs, f"({leg}) job {job['id']}'s ./{os.path.basename(out)} differs "
                                 "from the wanted bytes")
    os.remove(out)
    return launches


def phase_fleet(medium, tmp: str, serve_out: dict, medium_launches: int) -> dict:
    """[fleet]: two of the port's daemons on the card, each its own process,
    CUDA context, socket, TCP port and warm directory (delta and the tuner
    off), behind one `cli route` subprocess, over [serve]'s Medium text
    directory and golden result under tmp and [serve] (g)'s eight small
    chains; (f1)-(f6) in the module docstring.  Every wait has a deadline;
    any failed check raises.  The kernel-1 launches the jobs' details report
    are the phase's `fleet_launches`."""
    from spgemm_tpu_torch.fleet.fleet_smoke import _free_port, _spawn  # noqa: PLC0415
    from spgemm_tpu_torch.obs import trace as obs_trace  # noqa: PLC0415
    from spgemm_tpu_torch.serve import client, placement  # noqa: PLC0415

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    medium_dir, golden = os.path.join(tmp, "medium"), os.path.join(tmp, "result_a")
    small, small_want = medium.small_batch
    ftmp = os.path.join(tmp, "fleet")
    os.makedirs(ftmp)
    small_dirs = []
    for j, mats in enumerate(small):
        folder = os.path.join(ftmp, f"small{j}")
        io_text.write_chain_dir(folder, mats, mats[0].k)
        small_dirs.append(folder)
    ports = [_free_port(), _free_port()]
    names = [f"tcp:127.0.0.1:{p}" for p in ports]
    raddr = f"tcp:127.0.0.1:{_free_port()}"
    socks = [os.path.join(ftmp, f"b{i}.sock") for i in (0, 1)]
    base_env = {k: v for k, v in _serve_env().items() if not k.startswith("SPGEMM_TPU_ROUTER")}
    out = {"launches": 0}
    tw = time.perf_counter()
    backends = [_spawn([sys.executable, "-m", "spgemm_tpu_torch.cli", "serve", "--socket",
                        socks[i], "--addr", names[i], "--device", DEVICE, "-v"],
                       {**base_env, "SPGEMM_TPU_WARM_DIR": os.path.join(ftmp, f"b{i}.warm"),
                        "SPGEMM_TPU_DELTA": "0", "SPGEMM_TPU_TUNE": "0"},
                       os.path.join(ftmp, f"b{i}.log")) for i in (0, 1)]
    router = _spawn([sys.executable, "-m", "spgemm_tpu_torch.cli", "route", "--listen", raddr,
                     "--backends", ",".join(names), "--poll-s", str(FLEET_POLL_S), "-v"],
                    base_env, os.path.join(ftmp, "router.log"))
    procs = [*backends, router]
    try:
        # (f1): both up, by the router's poll
        started, healthy_s, deadline = {}, None, time.time() + 300
        while healthy_s is None:
            for i, proc in enumerate(procs):
                if proc.poll() is not None:
                    raise _fleet_fail(procs, f"(f1) process {i} exited {proc.returncode} before "
                                             "the fleet came up")
            for i in (0, 1):
                if i not in started and os.path.exists(socks[i]):
                    started[i] = time.perf_counter() - tw
            try:
                st = client.request({"op": "stats"}, raddr, timeout=10, retry_total_s=0.0)
            except (client.ServeError, OSError):
                st = {}
            rows = st.get("backends") or {}
            if len(rows) == 2 and all(b["up"] and not b["degraded"] for b in rows.values()):
                healthy_s = time.perf_counter() - tw
            elif time.time() > deadline:
                raise _fleet_fail(procs, f"(f1) the router never saw both backends healthy: "
                                         f"{rows}")
            else:
                time.sleep(0.05)
        warm = [re.findall(r"probed and warmed up in ([0-9.]+) s", open(p.log_path).read())
                for p in backends]
        out["f1"] = {"start_s": [started.get(0), started.get(1)], "healthy_s": healthy_s,
                     "probe_warm_s": [float(w[-1]) if w else None for w in warm]}
        print(f"[fleet] (f1) on {smi}: both daemons started at once, sockets bound at "
              f"{started.get(0):.3f} and {started.get(1):.3f} s (probe and warm-up "
              f"{out['f1']['probe_warm_s']} s); the router marked both up and undegraded at "
              f"{healthy_s:.3f} s (poll every {FLEET_POLL_S} s)", flush=True)

        # (f2): Medium twice through the router from one tenant
        sig = placement.signature(medium_dir)
        f2 = []
        for i in (0, 1):
            res = os.path.join(ftmp, f"f2_{i}")
            book_before = client.stats(raddr)["placement"]
            t1 = time.perf_counter()
            resp = client.submit(medium_dir, raddr, {"output": res}, tenant="fleet-a")
            job = client.wait(resp["id"], raddr, timeout=FLEET_WAIT_S)["job"]
            wall = time.perf_counter() - t1
            if resp.get("backend") not in names or job["id"] != resp["id"]:
                raise _fleet_fail(procs, f"(f2) submit {i}: backend {resp.get('backend')}, "
                                         f"fleet id {resp['id']} answered as {job['id']}")
            launches = _fleet_job_check("f2", job, res, golden, procs)
            if DEVICE == "cuda" and launches != medium_launches:
                raise _fleet_fail(procs, f"(f2) submit {i} launched kernel 1 {launches} times, "
                                         f"the main path {medium_launches}")
            out["launches"] += launches
            book_after = client.stats(raddr)["placement"]
            f2.append({"backend": resp["backend"], "wall_s": wall, "launches": launches,
                       "trace": resp["trace"], "phases_s": job["detail"]["phases_s"],
                       "book_hits": book_after["book_hits"] - book_before["book_hits"]})
            if i == 0:  # a poll merges the serving backend's gossip
                deadline = time.time() + 30
                while True:
                    book = client.stats(raddr)["placement"]
                    if book["merged"] > 0 and book["book_entries"] >= 1:
                        break
                    if time.time() > deadline:
                        raise _fleet_fail(procs, f"(f2) no poll merged the book: {book}")
                    time.sleep(0.05)
                gossip = client.stats(resp["backend"])["placement"]["book"]
                mass = gossip.get(sig)
                if mass is None:
                    raise _fleet_fail(procs, "(f2) the serving backend does not gossip "
                                             "Medium's price")
        if f2[0]["book_hits"] != 0 or f2[1]["book_hits"] != 1:
            raise _fleet_fail(procs, f"(f2) book hits per submit {[e['book_hits'] for e in f2]}"
                                     ", want 0 then 1 (placed by price)")
        branch = ("large: the widest backend first" if mass >= placement.LARGE_MASS_PAIRS
                  else "cheap: the least-loaded backend first")
        spans = [ev for ev in client.trace(raddr)
                 if ev["name"] == "router_submit" and ev["args"].get("trace_id")
                 in {e["trace"] for e in f2}]
        router_ms = sorted(ev["dur"] / 1e3 for ev in spans)
        if len(router_ms) != 2:
            raise _fleet_fail(procs, f"(f2) {len(router_ms)} router_submit spans for the two "
                                     "submits")
        out["f2"] = {"jobs": f2, "mass": mass, "branch": branch, "router_submit_ms": router_ms,
                     "book": book}
        print(f"[fleet] (f2) on {smi}: Medium through the router, tenant fleet-a: submit walls "
              f"{f2[0]['wall_s']:.6f} s on {f2[0]['backend']} (first contact) and "
              f"{f2[1]['wall_s']:.6f} s on {f2[1]['backend']} (priced: book hit +1; Medium's "
              f"mass {mass:g} pairs against LARGE_MASS_PAIRS {placement.LARGE_MASS_PAIRS:g}: "
              f"{branch}), against [serve]'s direct (a) {serve_out['a']['wall_s']:.6f} and (b) "
              f"{serve_out['b']['wall_s']:.6f} s; phases_s {f2[0]['phases_s']} and "
              f"{f2[1]['phases_s']}; the router's router_submit spans {router_ms} ms; kernel-1 "
              f"launches {f2[0]['launches']} and {f2[1]['launches']}; the router's book {book}; "
              "both results equal the golden bytes", flush=True)

        # (f3): [serve] (g)'s eight chains from two tenants
        t1 = time.perf_counter()
        burst = []
        for j, folder in enumerate(small_dirs):
            res = os.path.join(ftmp, f"f3_{j}")
            resp = client.submit(folder, raddr, {"output": res},
                                 tenant="fleet-a" if j % 2 == 0 else "fleet-b")
            burst.append((j, resp, res))
        served = {}
        for j, resp, res in burst:
            job = client.wait(resp["id"], raddr, timeout=FLEET_WAIT_S)["job"]
            out["launches"] += _fleet_job_check("f3", job, res, small_want[j], procs)
            served[resp["backend"]] = served.get(resp["backend"], 0) + 1
        if set(served) != set(names):
            raise _fleet_fail(procs, f"(f3) the burst did not reach both backends: {served}")
        out["f3"] = {"served": served, "wall_s": time.perf_counter() - t1}
        print(f"[fleet] (f3) on {smi}: {len(small_dirs)} chains of [serve] (g) from tenants "
              f"fleet-a and fleet-b in {out['f3']['wall_s']:.6f} s, jobs per backend {served}, "
              "every result equal to the in-memory engine's", flush=True)

        # (f4): one scrape, one trace
        scrape = client.metrics(raddr)
        need = ["spgemm_router_failovers_total 0"]
        for name in names:
            need += [f'spgemm_router_backend_up{{backend="{name}"}} 1',
                     f'spgemm_router_backend_queue_depth{{backend="{name}"}}',
                     f'spgemm_router_jobs_total{{backend="{name}"}}',
                     f'spgemmd_jobs_terminal_total{{backend="{name}",outcome="done"}}']
        missing = [n for n in need if n not in scrape]
        if missing:
            raise _fleet_fail(procs, f"(f4) the scrape lacks {missing}")
        trace_id, t_backend = f2[1]["trace"], f2[1]["backend"]
        stitch = os.path.join(ftmp, "stitch")
        obs_trace.dump_json(os.path.join(stitch, "client.trace.json"),
                            process_name="chip-smoke-client")
        env = {**os.environ, "PYTHONPATH": REPO}
        for addr, fname in ((raddr, "router.trace.json"), (t_backend, "backend.trace.json")):
            r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", "trace-dump",
                                "--addr", addr, "-o", os.path.join(stitch, fname)], env=env,
                               cwd=REPO, capture_output=True, text=True, timeout=120)
            if r.returncode != 0:
                raise _fleet_fail(procs, f"(f4) trace-dump --addr {addr}: {r.stderr[-1000:]}")
        merged_path = os.path.join(ftmp, "merged.trace.json")
        r = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.cli", "trace-dump",
                            "--merge", stitch, "--trace", trace_id, "-o", merged_path], env=env,
                           cwd=REPO, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            raise _fleet_fail(procs, f"(f4) trace-dump --merge: {r.stderr[-1000:]}")
        spans = [ev for ev in json.load(open(merged_path)) if ev.get("ph") != "M"]
        by_pid = {}
        for ev in spans:
            by_pid.setdefault(ev["pid"], set()).add(ev["name"])
        span_names = set().union(*by_pid.values()) if by_pid else set()
        if len(by_pid) < 3 or not {"client_submit", "router_submit", "serve_execute"} \
                <= span_names:
            raise _fleet_fail(procs, f"(f4) trace {trace_id} does not span the client, the "
                                     f"router and the backend: {by_pid}")
        out["f4"] = {"scrape_lines": len(scrape.splitlines()), "pids": len(by_pid),
                     "spans": len(spans)}
        print(f"[fleet] (f4) on {smi}: one scrape, {out['f4']['scrape_lines']} lines: the four "
              f"spgemm_router_* families and both backends' series under backend=; trace "
              f"{trace_id} merged from this process, the router and {t_backend}: "
              f"{len(spans)} spans in {len(by_pid)} processes, span names by process "
              f"{[sorted(v) for v in by_pid.values()]}", flush=True)

        # (f5): the backend holding a running Medium job is killed
        res_m = os.path.join(ftmp, "f5_medium")
        kill_jobs = [("medium", client.submit(medium_dir, raddr, {"output": res_m},
                                              tenant="fleet-a"), res_m, golden)]
        for j in range(FLEET_KILL_SMALL):
            res = os.path.join(ftmp, f"f5_{j}")
            kill_jobs.append((f"small{j}", client.submit(small_dirs[j], raddr, {"output": res},
                                                         tenant="fleet-b"), res, small_want[j]))
        ended = {}

        def waiter(label: str, fleet_id: str) -> None:
            try:
                ended[label] = (client.wait(fleet_id, raddr, timeout=FLEET_WAIT_S),
                                time.perf_counter())
            except Exception as e:  # noqa: BLE001 -- judged after the join
                ended[label] = (e, time.perf_counter())

        threads = [threading.Thread(target=waiter, args=(label, resp["id"]), daemon=True)
                   for label, resp, _, _ in kill_jobs]
        for t in threads:
            t.start()
        medium_id, holder = kill_jobs[0][1]["id"], kill_jobs[0][1]["backend"]
        deadline = time.time() + 300
        while (state := client.status(medium_id, raddr)["job"]["state"]) != "running":
            if time.time() > deadline or state in ("done", "failed"):
                raise _fleet_fail(procs, f"(f5) Medium's job never showed running ({state})")
            time.sleep(0.02)
        victim = backends[names.index(holder)]
        survivor_name = names[1 - names.index(holder)]
        victim.kill()  # SIGKILL mid-job: its CUDA context goes with it
        t_kill = time.perf_counter()
        for t in threads:
            t.join(timeout=max(1.0, FLEET_WAIT_S + 60 - (time.perf_counter() - t_kill)))
        hung = [label for label, *_ in kill_jobs if label not in ended]
        if hung:
            raise _fleet_fail(procs, f"(f5) waits that never returned: {hung}")
        outcomes = {}
        for label, resp, res, want in kill_jobs:
            got, at = ended[label]
            if isinstance(got, client.ServeError) and got.code == "backend-lost":
                outcomes[label] = "backend-lost"
                continue
            if isinstance(got, Exception):
                raise _fleet_fail(procs, f"(f5) {label} ended with {got!r}")
            out["launches"] += _fleet_job_check(f"f5 {label}", got["job"], res, want, procs)
            outcomes[label] = f"done on {got['backend']}"
            if label == "medium":
                kill_to_done = at - t_kill
        rst = client.stats(raddr)
        failover_events = [e for e in client.events(512, raddr) if e["kind"] == "router_failover"]
        resubmitted = [e for e in failover_events if e.get("outcome") == "resubmitted"]
        if outcomes["medium"] != f"done on {survivor_name}" or rst["jobs"]["failovers"] < 1 \
                or not resubmitted or f"spgemm_router_failovers_total {rst['jobs']['failovers']}" \
                not in client.metrics(raddr):
            raise _fleet_fail(procs, f"(f5) Medium did not fail over to the survivor: "
                                     f"{outcomes}, {rst['jobs']}, {failover_events}")
        deadline = time.time() + 60
        while client.stats(raddr)["backends"][holder]["up"]:
            if time.time() > deadline:
                raise _fleet_fail(procs, "(f5) the router still reports the killed backend up")
            time.sleep(0.05)
        res = os.path.join(ftmp, "f5_after")
        resp = client.submit(small_dirs[-1], raddr, {"output": res}, tenant="fleet-b")
        job = client.wait(resp["id"], raddr, timeout=FLEET_WAIT_S)["job"]
        if resp["backend"] != survivor_name:
            raise _fleet_fail(procs, f"(f5) a later submit landed on {resp['backend']}, not the "
                                     f"survivor {survivor_name}")
        out["launches"] += _fleet_job_check("f5 later", job, res, small_want[-1], procs)
        out["f5"] = {"outcomes": outcomes, "failovers": rst["jobs"]["failovers"],
                     "kill_to_done_s": kill_to_done, "killed": holder,
                     "events": [{k: e.get(k) for k in ("job", "dead", "to", "outcome")}
                                for e in failover_events]}
        print(f"[fleet] (f5) on {smi}: SIGKILL of {holder} while Medium ran there; outcomes "
              f"{outcomes}; failovers {rst['jobs']['failovers']}, router_failover events "
              f"{out['f5']['events']}; kill to the re-submitted Medium job's done "
              f"{kill_to_done:.6f} s (a cold start of Medium on the survivor's card); a later "
              f"submit on the survivor {survivor_name}; every finished job's bytes exact, no wait "
              "hung", flush=True)

        # (f6): SIGTERM to the router and the survivor
        survivor = backends[names.index(survivor_name)]
        rcs = {}
        for label, proc in (("router", router), ("survivor", survivor)):
            proc.send_signal(signal.SIGTERM)
            try:
                rcs[label] = proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                raise _fleet_fail(procs, f"(f6) the {label} did not exit after SIGTERM") from None
        if rcs != {"router": 0, "survivor": 0}:
            raise _fleet_fail(procs, f"(f6) exit codes after SIGTERM {rcs}")
        print(f"[fleet] (f6) SIGTERM: router and survivor exited {rcs}", flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    out["fleet_s"] = time.perf_counter() - t0
    _phase("fleet", t0, f"on {smi}: two daemons and a router, both up at "
           f"{out['f1']['healthy_s']:.3f} s; Medium through the router {f2[0]['wall_s']:.6f} / "
           f"{f2[1]['wall_s']:.6f} s, the second placed by price ({branch}); 8 small chains "
           f"over {out['f3']['served']}; one scrape, one trace over 3 processes; kill leg: "
           f"{out['f5']['outcomes']}, kill to done {out['f5']['kill_to_done_s']:.3f} s; clean "
           f"SIGTERM; kernel-1 launches over the phase's jobs {out['launches']}")
    return out


KERNELS_FILE = os.path.join(REPO, "build", "chip_smoke_kernels.json")


ROWSHARD_SHARDS = (1, 2, 4)  # [rowshard]: shards a round is cut into, all on cuda:0
# [rowshard]: spgemm_sharded's ENGINE phases, the split of each run's wall
ROWSHARD_SPLIT = ("plan", "upload", "numeric_dispatch", "assembly")


class EventFold:
    """A numeric-round function wrapped in CUDA events only: no work count,
    so no synchronisation inside the timed chain."""

    def __init__(self, fn):
        self.fn = fn
        self.events = []

    def __call__(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out

    def ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def phase_rowshard(medium) -> dict:
    """[rowshard]: the Medium chain through parallel/rowshard.spgemm_sharded
    over [cuda:0] * n for n in ROWSHARD_SHARDS, from the host leaves to a
    host result, each run a main path (counts zeroed just before, read just
    after), its result byte-equal to the main path's; kernel 1 launches
    once a shard of a round, so its launches are the shard dispatches
    (ENGINE rowshard_round), n times the main path's rounds; kernel 1 timed
    by CUDA events in the same run (EventFold); the wall split by
    spgemm_sharded's ENGINE phases (ROWSHARD_SPLIT; `other` is the rest:
    the chain's own work) beside the plan cache's hits and misses (the
    first run plans the ladder plans cold, the later ones find them in the
    cache).  Beside them, in this call,
    the main path's chain with warm plans from the device leaves and from
    the host leaves to a host result.  Then `--shard keys` once through the
    CLI on the golden data."""
    from spgemm_tpu_torch.parallel.rowshard import spgemm_sharded  # noqa: PLC0415

    t0 = time.perf_counter()
    want = medium.res_host
    multiplies = MEDIUM["n"] - 1
    out = {"shards": {}}
    with contextlib.redirect_stdout(io.StringIO()):
        _, out["main_device_wall_s"], main_counts, _ = _main_path(medium.dev_mats, "exact")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = chain_product(medium.mats, device=DEVICE)
        out["main_host_wall_s"] = time.perf_counter() - t1
        if not _host_equal(res, want):
            raise RuntimeError("[rowshard] the main path from host leaves differs")
        for n in ROWSHARD_SHARDS:
            mult = partial(spgemm_sharded, devices=[torch.device(DEVICE, 0)] * n)
            kern = EventFold(cuda_spgemm.numeric_round)
            torch.cuda.synchronize()
            _zero_counts()
            ENGINE.zero("rowshard_round")
            ph0, c0 = ENGINE.snapshot(), ENGINE.counter_snapshot()
            t1 = time.perf_counter()
            res = chain_product(medium.mats, device=DEVICE, multiply=mult, folds=Folds(exact=kern))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            counts = _read_counts()
            ph1, c1 = ENGINE.snapshot(), ENGINE.counter_snapshot()
            shards = c1.get("rowshard_round", 0)
            split = {name: ph1.get(name, 0.0) - ph0.get(name, 0.0) for name in ROWSHARD_SPLIT}
            split["other"] = wall - sum(split.values())
            cache = {name: c1.get(name, 0) - c0.get(name, 0)
                     for name in ("plan_cache_hits", "plan_cache_misses")}
            if not _host_equal(res, want):
                raise RuntimeError(f"[rowshard] {n} shard(s): the result differs from the main "
                                   "path's")
            if counts["mod"] != shards or counts["mod"] != n * main_counts["mod"] \
                    or counts["no_mod"] or counts["mxu"] or counts["dense"]:
                raise RuntimeError(f"[rowshard] {n} shard(s): launches {counts}, shards {shards}, "
                                   f"the main path's kernel 1 {main_counts['mod']}")
            out["shards"][n] = {"wall_s": wall, "launches": counts["mod"],
                                "rounds_per_multiply": shards / n / multiplies,
                                "kernel_ms": kern.ms(), "split_s": split, "plan_cache": cache}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rowshard_") as tmp:
        env = {**os.environ, "PYTHONPATH": REPO}
        got = os.path.join(tmp, "golden_chain.matrix")
        _cli(os.path.join(REPO, "tests", "data", "golden_chain"), got, tmp, env, "--shard", "keys")
        if not _same_bytes(got, os.path.join(REPO, "tests", "data",
                                             "golden_chain_expected_matrix")):
            raise RuntimeError("[rowshard] cli --shard keys on golden_chain differs from the "
                               "expected bytes")
    line = "; ".join(
        f"{n} shard(s): wall {r['wall_s']:.6f} s, kernel 1 {r['launches']} launches "
        f"({r['rounds_per_multiply']:.3f} rounds a multiply), {r['kernel_ms']:.3f} ms, split "
        + ", ".join(f"{name} {t:.6f} s" for name, t in r["split_s"].items())
        + f", plan cache {r['plan_cache']['plan_cache_hits']} hits "
        f"{r['plan_cache']['plan_cache_misses']} misses"
        for n, r in out["shards"].items())
    _phase("rowshard", t0, f"Medium through spgemm_sharded over [cuda:0] * n, host leaves to a "
           f"host result, each byte-equal to the main path's: {line}; the main path in this "
           f"call, warm plans: {out['main_device_wall_s']:.6f} s from device leaves "
           f"(kernel 1 {main_counts['mod']} launches), {out['main_host_wall_s']:.6f} s from "
           "host leaves to a host result; cli --shard keys on golden_chain byte-equal to the "
           "expected file")
    return out


INNER_RING_N = (1, 2, 4)  # [inner-ring]: positions of spgemm_inner and spgemm_ring, on cuda:0
INNER_RING_PLAIN = (3, 2)  # [inner-ring]: the plain versions on Medium's first 3, 2 positions
# [inner-ring]: spgemm_inner's and spgemm_ring's ENGINE phases, each run's wall split
INNER_SPLIT = ("plan", "upload", "numeric_dispatch", "assembly")
RING_SPLIT = ("ring_plan", "ring_hop", "upload", "ring_fold", "assembly")
# the webbase-ring pair of benchmarks/run.py:340-342: powerlaw_block_sparse(256, 32, 3.0,
# rng, "small") twice from default_rng(3), through the ring at 4 positions
WEBBASE_RING = {"block_dim": 256, "k": 32, "avg_per_row": 3.0, "seed": 3, "n": 4}
# int8 byte products a u64 MAC of F1 and F3 runs on the tensor cores: 8 x 8 bytes, or 4 x 4
# on the SMALL route (every value below 2^32)
FIELD_BYTE_PRODUCTS = {False: 64, True: 16}


@contextlib.contextmanager
def _patched(obj, **attrs):
    """Set attributes of a module for the duration, then restore them."""
    old = {name: getattr(obj, name) for name in attrs}
    for name, value in attrs.items():
        setattr(obj, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(obj, name, value)


class FieldTimer:
    """The three field-mode wrappers (or their plain versions) wrapped in
    CUDA events where inner and ring sharding call them; F2 also counts its
    bytes (x and y read, x written).  No synchronisation inside a run."""

    def __init__(self, plain: bool = False):
        self.fold = EventFold(cuda_field.field_fold_ref if plain else cuda_field.field_fold)
        self.scatter = EventFold(cuda_field.field_fold_scatter_ref if plain
                                 else cuda_field.field_fold_scatter)
        self.add = EventFold(cuda_field.addmod_field_ref_ if plain else cuda_field.addmod_field_)
        self.add_bytes = 0

    def _add(self, x, y):
        self.add_bytes += 3 * x.numel() * 8
        return self.add(x, y)

    @contextlib.contextmanager
    def installed(self):
        from spgemm_tpu_torch.parallel import innershard  # noqa: PLC0415

        with _patched(innershard, fold_pairs_field=self.fold), \
                _patched(cuda_field, field_fold_scatter=self.scatter, addmod_field_=self._add):
            yield self

    def ms(self) -> dict:
        return {"field_fold": self.fold.ms(), "field_fold_scatter": self.scatter.ms(),
                "field_add": self.add.ms()}


def _field_chain(mats, strategy: str, n: int, overlap: str = "1", plain: bool = False) -> tuple:
    """The chain of host leaves through spgemm_inner or spgemm_ring over
    [cuda:0] * n (SPGEMM_TPU_RING_OVERLAP=overlap), as a main path: counts
    zeroed just before and read just after; the field kernels timed by
    CUDA events (their plain versions when plain).  Returns (host result,
    run dict)."""
    from spgemm_tpu_torch.parallel.innershard import spgemm_inner  # noqa: PLC0415
    from spgemm_tpu_torch.parallel.ring import spgemm_ring  # noqa: PLC0415

    fn = spgemm_inner if strategy == "inner" else spgemm_ring
    timer = FieldTimer(plain)
    mult = partial(fn, devices=[torch.device(DEVICE, 0)] * n)
    with _env(SPGEMM_TPU_RING_OVERLAP=overlap), timer.installed(), \
            contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        _zero_counts()
        ph0, c0 = ENGINE.snapshot(), ENGINE.counter_snapshot()
        t1 = time.perf_counter()
        res = chain_product(mats, device=DEVICE, multiply=mult, backend="mxu")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        counts = _read_counts()
        ph1, c1 = ENGINE.snapshot(), ENGINE.counter_snapshot()
    split = {name: ph1.get(name, 0.0) - ph0.get(name, 0.0)
             for name in (INNER_SPLIT if strategy == "inner" else RING_SPLIT)}
    split["other"] = wall - sum(v for name, v in split.items() if name != "ring_hop")
    launches = {name: counts[name] for name in ("field_fold", "field_fold_scatter", "field_add")}
    others = {name: counts[name] for name in ("mod", "no_mod", "mxu", "dense")}
    want = ({"field_fold_scatter"} if strategy == "ring"
            else {"field_fold", "field_add"} if n > 1 else {"field_fold"})
    if not plain and ({name for name, v in launches.items() if v > 0} != want
                      or any(others.values())):
        raise RuntimeError(f"[inner-ring] {strategy} at {n} position(s): launches {launches}, "
                           f"other kernels {others}; expected launches of {sorted(want)} only")
    # F3: one launch a (step, position) of a multiply at most
    if not plain and launches["field_fold_scatter"] > (len(mats) - 1) * n * n:
        raise RuntimeError(f"[inner-ring] ring at {n} position(s): "
                           f"{launches['field_fold_scatter']} F3 launches over "
                           f"{len(mats) - 1} multiplies, more than n^2 each")
    return res, {"wall_s": wall, "launches": launches, "ms": timer.ms(), "split_s": split,
                 "f2_bytes": timer.add_bytes,
                 "ring_steps": c1.get("ring_steps", 0) - c0.get("ring_steps", 0)}


def phase_inner_ring(medium, kernel1: dict) -> list[dict]:
    """[inner-ring]: the Medium chain from its host leaves through
    parallel/innershard.spgemm_inner and parallel/ring.spgemm_ring over
    [cuda:0] * n for n in INNER_RING_N (the ring with SPGEMM_TPU_RING_OVERLAP
    1, and at the last n with 0 too), each a main path (counts zeroed just
    before, read just after: F1 and, at n > 1, F2 under inner, F3 under
    ring, no other kernel), every result byte-equal to the others and to
    the mxu backend's chain (kernel 2, exact field mode: Medium's deepest
    class has P * k = 96 * 32 <= 2^17) on the same leaves; each run's wall,
    its ENGINE split and the field kernels' launches and CUDA-event ms.
    Then the plain versions against the kernels on Medium's first 3
    matrices at 2 positions (a cut in depth, as [medium-cli]'s), timed;
    the webbase-ring pair through the ring at 4 positions, a main path,
    equal to the exact main path's result (bounded values: field mode is
    exact there), with its deep-tail cells and the small route; and
    chain_product_on_devices(Medium, [cuda:0], num_parts=8) byte-equal to
    [medium-cli]'s `--ranks 8` result.  Returns the F1, F2 and F3 rows of
    the kernels line."""
    from spgemm_tpu_torch.parallel.chainpart import chain_product_on_devices  # noqa: PLC0415
    from spgemm_tpu_torch.parallel.ring import plan_ring, ring_cells  # noqa: PLC0415

    t0 = time.perf_counter()
    k2 = EventFold(cuda_mxu.numeric_round_mxu)  # kernel 2, the yardstick of F1 and F3
    want, mxu_wall, mxu_counts, _ = _main_path(medium.dev_mats, "mxu", folds=Folds(mxu=k2))
    if mxu_counts["mxu"] <= 0:
        raise RuntimeError(f"[inner-ring] the mxu chain launched {mxu_counts}")
    k2_ms = k2.ms()
    want = want.to_host()
    small = u64.operands_below_2_32(*medium.mats)
    runs = {}
    legs = [("inner", n, "1") for n in INNER_RING_N] + [("ring", n, "1") for n in INNER_RING_N]
    legs.append(("ring", INNER_RING_N[-1], "0"))
    for strategy, n, overlap in legs:
        res, run = _field_chain(medium.mats, strategy, n, overlap)
        if not _host_equal(res, want):
            raise RuntimeError(f"[inner-ring] {strategy} at {n} position(s), overlap {overlap}: "
                               "the result differs from the mxu chain's")
        runs[f"{strategy} n={n}" + (" overlap=0" if overlap == "0" else "")] = run
        del res
    line = "; ".join(
        f"{name}: wall {r['wall_s']:.6f} s, launches {r['launches']}, ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in r["ms"].items() if r["launches"][k])
        + ", split " + ", ".join(f"{k} {v:.6f} s" for k, v in r["split_s"].items())
        for name, r in runs.items())
    _phase("inner-ring", t0, f"Medium from host leaves through spgemm_inner and spgemm_ring "
           f"over [cuda:0] * n, each byte-equal to the mxu chain's ({mxu_wall:.6f} s from "
           f"device leaves, kernel 2 {mxu_counts['mxu']} launches, {k2_ms:.3f} ms by CUDA "
           f"events: the yardstick of F1 and F3); F3 at most n^2 launches a multiply; small route "
           f"{'taken' if small else 'not taken (values reach 2^32)'}: {line}")

    # the plain versions against the kernels on a cut in depth
    t0 = time.perf_counter()
    depth, n_plain = INNER_RING_PLAIN
    plain = {}
    for strategy in ("inner", "ring"):
        got_k, run_k = _field_chain(medium.mats[:depth], strategy, n_plain)
        got_p, run_p = _field_chain(medium.mats[:depth], strategy, n_plain, plain=True)
        if not _host_equal(got_k, got_p):
            raise RuntimeError(f"[inner-ring] {strategy} on Medium's first {depth}: the kernels' "
                               "result != the plain versions'")
        plain[strategy] = {"kernel_ms": run_k["ms"], "plain_ms": run_p["ms"],
                           "kernel_wall_s": run_k["wall_s"], "plain_wall_s": run_p["wall_s"]}
    _phase("inner-ring", t0, f"Medium's first {depth} matrices at {n_plain} positions, kernels "
           f"== plain versions: " + "; ".join(
               f"{s}: kernels " + ", ".join(f"{k} {v:.3f}" for k, v in p["kernel_ms"].items())
               + " ms, plain " + ", ".join(f"{k} {v:.3f}" for k, v in p["plain_ms"].items())
               + " ms" for s, p in plain.items()))

    # the webbase-ring pair at 4 positions against the exact main path
    t0 = time.perf_counter()
    cfg = WEBBASE_RING
    rng = np.random.default_rng(cfg["seed"])
    a, b = (powerlaw_block_sparse(cfg["block_dim"], cfg["k"], cfg["avg_per_row"], rng, "small")
            for _ in range(2))
    exact, _, exact_counts, _ = _main_path([a, b], "exact")
    exact = exact.to_host()
    got, web = _field_chain([a, b], "ring", cfg["n"])
    if not _host_equal(got, exact):
        raise RuntimeError("[inner-ring] webbase-ring: the ring's result != the exact path's")
    sched = plan_ring(symbolic.symbolic_join(a.coords, b.coords), b.nnzb, cfg["n"],
                      mass_balance=False)
    tail_cells = 0 if sched[3] is None else int((sched[3][0] != sched[5]).sum())
    cells = ring_cells(sched[2], sched[3], cfg["n"], sched[5])
    web.update({"tail_cells": tail_cells, "small": u64.operands_below_2_32(a, b),
                "rank_lists": len(sched[2]), "tiles": (a.nnzb, b.nnzb),
                "cells": len(cells.rows), "max_cell_pairs": int(np.diff(cells.cell_ptr).max()),
                "exact_launches": exact_counts["mod"] + exact_counts["no_mod"]
                + exact_counts["dense"]})
    _phase("inner-ring", t0, f"webbase-ring ({a.nnzb} x {b.nnzb} tiles, k {cfg['k']}) through "
           f"the ring at {cfg['n']} positions == the exact path: wall {web['wall_s']:.6f} s, "
           f"F3 {web['launches']['field_fold_scatter']} launches, "
           f"{web['ms']['field_fold_scatter']:.3f} ms, small route {'taken' if web['small'] else 'not taken'}, "
           f"{web['rank_lists']} rank lists, {tail_cells} deep-tail cells; the CSR holds "
           f"{web['cells']} cells of up to {web['max_cell_pairs']} pairs")

    # --shard chain at P = 8 against [medium-cli]'s --ranks 8
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        t1 = time.perf_counter()
        chained = chain_product_on_devices(medium.mats, [torch.device(DEVICE, 0)], num_parts=8)
        chain_wall = time.perf_counter() - t1
    if _digest(chained.prune_zeros()) != medium.ranks8_digest:
        raise RuntimeError("[inner-ring] chain_product_on_devices at P = 8 != --ranks 8")
    _phase("inner-ring", t0, f"chain_product_on_devices(Medium, [cuda:0], num_parts=8) == "
           f"[medium-cli]'s --ranks 8 result: wall {chain_wall:.6f} s")

    # the rows: launches and ms of the main path at the widest n, bounds from the chain's
    # real MACs (every pair folded once, as by kernel 1) and its bytes; F1 and F3 run
    # FIELD_BYTE_PRODUCTS int8 products a MAC on the tensor cores, as kernel 2's row counts
    wide = INNER_RING_N[-1]
    inner, ring = runs[f"inner n={wide}"], runs[f"ring n={wide}"]
    products = FIELD_BYTE_PRODUCTS[small]
    bytes_ms = kernel1["bytes"] / HBM_BYTES_PER_S * 1e3
    fold_bound, fold_by = _bound(2 * kernel1["macs"] * products / INT8_TENSOR_OPS_PER_S * 1e3,
                                 bytes_ms)
    add_bound, add_by = _bound(0.0, inner["f2_bytes"] / HBM_BYTES_PER_S * 1e3)
    ptxas = _field_ptxas()
    common = {"route": "cuda", "source": "spgemm_tpu_torch/csrc/field_fold.cu",
              "max_abs_err": 0, "library_ms": None, "plain_scope":
              f"Medium's first {depth} matrices, {n_plain} positions", "small": small,
              "kernel2_ms_same_chain": k2_ms, "kernel2_launches": mxu_counts["mxu"]}
    by_run = {name: {k: {"launches": r["launches"][k], "ms": r["ms"][k]}
                     for k in r["launches"] if r["launches"][k]} for name, r in runs.items()}
    rows = []
    for name, replaces, run, strategy, bound, by in (
            ("field_fold", "spgemm_tpu/parallel/innershard.py:35", inner, "inner",
             fold_bound, fold_by),
            ("field_add", "spgemm_tpu/parallel/innershard.py:79", inner, "inner",
             add_bound, add_by),
            ("field_fold_scatter", "spgemm_tpu/parallel/ring.py:368", ring, "ring",
             fold_bound, fold_by)):
        rows.append({**common, "name": name, "replaces": replaces,
                     "launches": run["launches"][name], "ms": run["ms"][name],
                     "plain_ms": plain[strategy]["plain_ms"][name],
                     "ms_plain_scope": plain[strategy]["kernel_ms"][name],
                     "bound_ms": bound, "bound_by": by, "main_path": f"{strategy} n={wide}",
                     "byte_products_per_mac": products if name != "field_add" else None,
                     "ptxas": ptxas.get(name),
                     "by_run": {r: v[name] for r, v in by_run.items() if name in v}})
    rows[2]["webbase_ring"] = {"launches": web["launches"]["field_fold_scatter"],
                               "ms": web["ms"]["field_fold_scatter"],
                               "tail_cells": tail_cells, "small": web["small"],
                               "cells": web["cells"], "max_cell_pairs": web["max_cell_pairs"]}
    print(f"[inner-ring] rows: F1 {rows[0]['ms']:.3f} ms ({rows[0]['launches']} launches), "
          f"F2 {rows[1]['ms']:.3f} ms ({rows[1]['launches']}), F3 {rows[2]['ms']:.3f} ms "
          f"({rows[2]['launches']}), kernel 2 over the same chain {k2_ms:.3f} ms "
          f"({mxu_counts['mxu']}); bound of F1 and F3 {fold_bound:.3f} ms ({fold_by}, "
          f"{kernel1['macs'] / 1e9:.3f} G MACs x {products} int8 byte products x 2 ops / "
          f"{INT8_TENSOR_OPS_PER_S:.4g} ops/s; bytes {bytes_ms:.3f} ms); F2 {add_bound:.3f} ms "
          f"({add_by}, {inner['f2_bytes'] / 1e9:.3f} GB); ptxas (registers, spill bytes) "
          f"{ptxas}", flush=True)
    return rows


def _field_ptxas() -> dict:
    """Registers and spill bytes of F1's and F3's instances (full 8 x 8 and
    SMALL 4 x 4 bytes), from the ptxas report _build keeps beside
    libfield_fold."""
    log = _build.build("field_fold").with_suffix(".log").read_text()
    out = {}
    for entry, stats in obs_profile.parse_ptxas(log).items():
        m = re.search(r"limb_fold_kernelILi(\d)ELi(\d)E\w*?(RowWalk|CellWalk)", entry)
        if m:
            name = "field_fold" if m.group(3) == "RowWalk" else "field_fold_scatter"
            out.setdefault(name, {})[f"{m.group(1)}x{m.group(2)}"] = {
                k: stats[k] for k in ("registers", "spill_stores", "spill_loads")}
    return out


CHAOS_JOBS = 3               # [chaos]: the card's chaos-leg submits
CHAOS_JOB_TIMEOUT_S = 30.0   # [chaos]: the card daemon's job deadline (the wedged job's wait)
CHAOS_LIMIT_S = 900.0        # [chaos]: each smoke's time limit


def phase_chaos(tmp: str, serve_out: dict) -> dict:
    """[chaos]: `python -m spgemm_tpu_torch.serve.chaos_smoke --device cuda`
    over [serve]'s Medium and distinct-structure text directories under
    tmp (their expected bytes [serve]'s result_a and result_c), and at the
    same time its CPU form (--device cpu: a pool of 2 slices over its
    generated chains) as a second subprocess.  Each must exit 0 with its OK
    line; a failure of either fails the phase.  The daemons run at the
    default SPGEMM_TPU_DELTA.  Prints beside them [serve]'s pool rows."""
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "SPGEMM_TPU_DELTA"}
    env["PYTHONPATH"] = REPO
    base = [sys.executable, "-m", "spgemm_tpu_torch.serve.chaos_smoke"]
    runs = {
        "card": base + ["--device", DEVICE, "--jobs", str(CHAOS_JOBS), "--job-timeout",
                        f"{CHAOS_JOB_TIMEOUT_S:g}", "--chain",
                        f"{os.path.join(tmp, 'medium')}={os.path.join(tmp, 'result_a')}",
                        "--chain",
                        f"{os.path.join(tmp, 'distinct')}={os.path.join(tmp, 'result_c')}"],
        "cpu_pool": base + ["--device", "cpu", "--jobs", "4", "--job-timeout", "15"],
    }
    procs, logs, started = {}, {}, {}
    for name, cmd in runs.items():
        logs[name] = os.path.join(tmp, f"chaos_{name}.log")
        with open(logs[name], "w") as f:
            started[name] = time.perf_counter()
            procs[name] = subprocess.Popen(cmd, env=env, cwd=tmp, stdout=f,
                                           stderr=subprocess.STDOUT)
    out = {}
    try:
        ended = {}
        while len(ended) < len(procs):
            if time.perf_counter() - t0 > CHAOS_LIMIT_S:
                raise RuntimeError(f"[chaos] {sorted(set(procs) - set(ended))} still running "
                                   f"after {CHAOS_LIMIT_S:g} s")
            for name, proc in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter()
            time.sleep(0.2)
        for name, proc in procs.items():
            text = open(logs[name], errors="replace").read()
            ok = [ln for ln in text.splitlines() if ln.startswith("chaos-smoke: OK")]
            if proc.returncode != 0 or not ok:
                raise RuntimeError(f"[chaos] chaos_smoke ({name}) exited {proc.returncode}:\n"
                                   f"{text[-6000:]}")
            out[name] = {"wall_s": ended[name] - started[name], "ok": ok[-1],
                         "schedule": text.splitlines()[0]}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
    _phase("chaos", t0, f"card: {out['card']['schedule']}; {out['card']['ok']} (subprocess "
           f"wall {out['card']['wall_s']:.3f} s); CPU pool of 2 slices at the same time: "
           f"{out['cpu_pool']['ok']} ({out['cpu_pool']['wall_s']:.3f} s); [serve]'s pool rows "
           f"{serve_out['pool_rows']}")
    return out


def _kernels_so_far(rows: list) -> None:
    """The kernels line as far as the run has come, printed (not as the
    bare JSON object the last lines carry) and written to KERNELS_FILE, so
    that a cut output tail loses no row."""
    line = json.dumps({"kernels": rows})
    print(f"[kernels so far] {line}", flush=True)
    os.makedirs(os.path.dirname(KERNELS_FILE), exist_ok=True)
    with open(KERNELS_FILE, "w") as f:
        f.write(line + "\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--warm-child"]:
        return _warm_child(sys.argv[2])
    # --only ffn or ffn-train: the device and build phases, then that phase
    # alone (its kernels line, no result line); a diagnostic, not the smoke run
    only = sys.argv[2] if sys.argv[1:2] == ["--only"] else None
    if only not in (None, "ffn", "ffn-train"):
        print(f"chip_smoke: --only takes ffn or ffn-train, not {only!r}", file=sys.stderr)
        return 2
    # every phase before [delta] runs without delta recompute, so its numbers
    # compare with earlier runs; the later phases set it themselves.  The
    # estimator keeps the port's default (off) everywhere but [estimate].
    os.environ["SPGEMM_TPU_DELTA"] = "0"
    # float32 products in full float32, never TF32, in every plain version
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    _phase("device", t0, f"{name}, {torch.cuda.device_count()} visible, torch "
           f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0], flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            text = log.read_text().strip().splitlines()
            print("\n".join(line for line in text if "registers" in line or "spill" in line
                            or "Compiling entry" in line), flush=True)
    for lib in libs:
        _build.load(lib)  # loaded here, so no timed launch pays the first load
    _phase("build", t0, f"built {', '.join(sorted(libs))} with nvcc")
    if only:
        rows = phase_ffn() if only == "ffn" else phase_ffn_train()
        print(json.dumps({"kernels": rows}), flush=True)
        return 0

    rng = np.random.default_rng(SEED)
    kernel_err = phase_kernel(rng)
    phase_cli(rng)
    row, medium = phase_medium()
    row["max_abs_err"] = max(row["max_abs_err"], kernel_err["mod"])
    row["host"] = phase_medium_host(medium)
    row["plan_cache"] = phase_medium_plancache(medium)
    row["busy_share"] = phase_medium_busy(medium)
    medium.res_host = medium.res.to_host()
    row["ooc"] = phase_medium_ooc(medium, row["peak_bytes"], row["peak_above_inputs_bytes"])
    row["cli"] = phase_medium_cli(medium)
    row["parity_fold"] = phase_medium_parity(medium)
    _kernels_so_far([row])
    splice_row = phase_delta(medium)
    splice_row["warm"] = phase_warm()
    splice_row["estimate"] = phase_estimate(medium)
    dense_row = phase_dense(medium, row["ms"])
    _kernels_so_far([row, splice_row, dense_row])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        row["serve"] = phase_serve(medium, row["cli"], tmp)
        row["tune"] = phase_tune(medium, tmp)
        row["fleet"] = phase_fleet(medium, tmp, row["serve"], row["launches"])
        row["chaos"] = phase_chaos(tmp, row["serve"])
    row["rowshard"] = phase_rowshard(medium)
    field_rows = phase_inner_ring(medium, row)
    for r in field_rows:
        r["max_abs_err"] = max(r["max_abs_err"], kernel_err[r["name"]])
    # the [rowshard] path's own counts: kernel 1's launches at each shard count
    row["rowshard_launches"] = {n: r["launches"] for n, r in row["rowshard"]["shards"].items()}
    # the [fleet] path's own count: the kernel-1 launches its jobs report
    row["fleet_launches"] = row["fleet"]["launches"]
    # the [tune] path's own counts: the trial legs' launches
    row["tune_launches"] = row["tune"]["legs_launches"]["launches_numeric_round"]
    dense_row["tune_launches"] = row["tune"]["legs_launches"]["launches_dense_fold"]
    del medium
    torch.cuda.empty_cache()
    no_mod_row, mxu_row = phase_medium_small()
    no_mod_row["max_abs_err"] = max(no_mod_row["max_abs_err"], kernel_err["no_mod"])
    no_mod_row["ptxas"] = row["ptxas"]["no_mod"]
    no_mod_row["geometry"] = row["geometry"]["no_mod"]
    mxu_row["max_abs_err"] = max(mxu_row["max_abs_err"], kernel_err["mxu"])
    _kernels_so_far([row, no_mod_row, mxu_row, splice_row, dense_row, *field_rows])
    row["cli_modes"] = phase_cli_modes(rng)
    torch.cuda.empty_cache()
    ffn_rows = phase_ffn()
    for r in ffn_rows:
        r["max_abs_err"] = max(r["max_abs_err"], kernel_err[r["name"]])
    _kernels_so_far([row, no_mod_row, mxu_row, *ffn_rows, splice_row, dense_row,
                     *field_rows])
    torch.cuda.empty_cache()
    train_rows = phase_ffn_train()
    for r in ffn_rows:  # the forward launches of [ffn-train]'s main path
        r["train_launches"] = train_rows[1]["forward_launches"][r["name"]]
    kernels = [row, no_mod_row, mxu_row, *ffn_rows, *train_rows, splice_row, dense_row,
               *field_rows]
    _kernels_so_far(kernels)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
