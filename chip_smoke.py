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
               fit, k = 8);
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
               threads, with --threads 1 (the default's load must be faster)
               and with SPGEMM_TPU_NO_NATIVE=1, each ./matrix read back equal
               to the in-memory result after prune_zeros; about 4 GB under
               TMPDIR, deleted after) and `[medium] parity fold` (kernel 1's
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
               first contact's;
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
               tile, kernel 4's column chunks); then
               (i) block_m 128, (ii) the same with gelu fused, (iii) block_m
               16 with the resident gate deciding, (iv) x (1, 256, 4096) at
               block_m 16, each a main path with the bsmm counts zeroed
               before and read after, each against the plain ffn_forward in
               float32, (i) bit-equal to (iii) and (iv) to block_m 128 on its
               x; then each kernel per matmul (full width and M = 256), each
               forward, the plain versions and the dense x @ W product
               timed, kernel 4 bit-equal to kernel 3 on matmul 1 and kernel
               3 on matmul 2 bit-equal across the row tiles 16 to 128.

Then one JSON line describing every ported kernel (the splice and the dense fold last) and,
last, the device line
`{"ok": true, "device": {...}}`.  Imports torch, numpy and the port only.
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
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

from spgemm_tpu_torch.chain import chain_product, chain_products_batched
from spgemm_tpu_torch.models import ffn
from spgemm_tpu_torch.ops import _build, crossover, cuda_bsmm, cuda_dense, cuda_mxu, cuda_splice
from spgemm_tpu_torch.ops import cuda_spgemm
from spgemm_tpu_torch.ops import delta, estimate, mxu_spgemm, plancache, symbolic, warmstore
from spgemm_tpu_torch.ops import spgemm as engine
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import Folds, plan, spgemm, spgemm_device, spgemm_outofcore
from spgemm_tpu_torch.parallel.chainpart import chain_product_partitioned
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
    instances at 8x8 and 3x3 byte limbs (10 and 3 7-bit limbs) and of the
    segmented fold, from the ptxas reports _build keeps beside the
    libraries."""
    out = {}
    for lib, pattern, name in (
            ("numeric_round", r"numeric_round_kernelILb([01])E",
             lambda m: "no_mod" if m.group(1) == "1" else "mod"),
            ("numeric_round_mxu", r"numeric_round_mxu_kernelILi(\d)ELi(\d)E",
             lambda m: f"mxu {m.group(1)}x{m.group(2)}"),
            ("numeric_round_dense", r"numeric_round_kernelILb0ELb1E", lambda m: "dense")):
        log = _build.build(lib).with_suffix(".log").read_text()
        for chunk in log.split("Compiling entry function")[1:]:
            m = re.search(pattern, chunk)
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
            if m and regs and spill:
                out[name(m)] = {"registers": int(regs.group(1)),
                                "spill_stores": int(spill.group(1)),
                                "spill_loads": int(spill.group(2))}
    want = {"mod", "no_mod", "mxu 8x8", "mxu 3x3", "dense"}
    if not want <= set(out):
        raise RuntimeError(f"no ptxas report for {sorted(want - set(out))}: {out}")
    return {name: out[name] for name in sorted(want)}


# each kernel's ENGINE launch counter (bumped by its wrapper where it launches)
LAUNCH_COUNTERS = {"mod": "launches_numeric_round", "no_mod": "launches_numeric_round_no_mod",
                   "mxu": "launches_numeric_round_mxu", "splice": "launches_splice",
                   "dense": "launches_dense_fold", "bsmm": "launches_bsmm",
                   "bsmm_resident": "launches_bsmm_resident"}


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


def _main_path(dev_mats, backend: str, **env):
    """Drive chain_product once as a main path: counts zeroed just before,
    read just after.  Returns (result, wall s, counts, hybrid records)."""
    logger = logging.getLogger("spgemm_tpu_torch.spgemm")
    handler = _HybridLog()
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        with _env(**env), contextlib.redirect_stdout(io.StringIO()):
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            res = chain_product(dev_mats, device=DEVICE, keep_device=True, backend=backend)
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


def phase_medium_cli(medium) -> dict:
    """The port's CLI on the Medium chain's text directory (written by the
    native writer), run as `python -m spgemm_tpu_torch.cli <dir> -v` with
    the default loader threads, with --threads 1 (the default's load must
    be faster) and with SPGEMM_TPU_NO_NATIVE=1 (the numpy paths); each
    ./matrix, read back with the native parser, must equal the in-memory
    result after prune_zeros.  Needs about 4 GB of disk under TMPDIR and
    deletes it."""
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
        env = {**os.environ, "PYTHONPATH": REPO}
        for name, extra, knob in (("default", [], {}), ("threads_1", ["--threads", "1"], {}),
                                  ("no_native", [], {"SPGEMM_TPU_NO_NATIVE": "1"})):
            proc = subprocess.run(
                [sys.executable, "-m", "spgemm_tpu_torch.cli", folder, "-v", "--device", DEVICE,
                 *extra], cwd=tmp, env={**env, **knob}, capture_output=True, text=True,
                timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"cli on the Medium directory {extra} exited "
                                   f"{proc.returncode}:\n{proc.stderr[-4000:]}")
            lines = proc.stdout.splitlines()
            taken = re.fullmatch(r"time taken (\S+) seconds", lines[-1] if lines else "")
            if lines[:-1] != _multiplying_lines(len(medium.mats)) or not taken:
                raise RuntimeError(f"cli stdout on the Medium directory is not the "
                                   f"reference's:\n{proc.stdout[-2000:]}")
            phases = {m.group(1): float(m.group(2))
                      for m in re.finditer(r"phase (\S+): ([0-9.]+)s", proc.stderr)}
            matrix = os.path.join(tmp, "matrix")
            t1 = time.perf_counter()
            got = io_text.read_matrix(matrix, k)
            read_s = time.perf_counter() - t1
            if (got.rows, got.cols) != (want.rows, want.cols) or \
                    not np.array_equal(got.coords, want.coords) or \
                    not np.array_equal(got.tiles, want.tiles):
                raise RuntimeError(f"cli ./matrix on the Medium directory ({name}) differs "
                                   "from the in-memory chain result after prune_zeros")
            out[name] = {"time_taken_s": float(taken.group(1)), "phases": phases,
                         "matrix_bytes": os.path.getsize(matrix), "read_back_s": read_s}
            os.remove(matrix)
        out["ranks_8"] = _medium_cli_ranks(medium, folder, tmp, env, want)
    d, t, n = out["default"], out["threads_1"], out["no_native"]
    if not d["phases"]["load"] < t["phases"]["load"]:
        raise RuntimeError(f"the CLI's load with the default threads ({d['phases']['load']} s) "
                           f"is not faster than with --threads 1 ({t['phases']['load']} s)")
    _phase("medium-cli", t0, f"wrote {len(medium.mats)} files, {out['text_bytes'] / 1e9:.3f} "
           f"GB of text in {out['write_dir_s']:.3f} s (native writer, a thread per file); "
           f"cli -v: time taken {d['time_taken_s']:.6f} s: load {d['phases'].get('load')}, "
           f"chain {d['phases'].get('chain')}, prune+write {d['phases'].get('prune+write')} s "
           f"(plan {d['phases'].get('plan')}, plan_wait {d['phases'].get('plan_wait')}, "
           f"upload {d['phases'].get('upload')} s); --threads 1: time taken "
           f"{t['time_taken_s']:.6f} s, load {t['phases'].get('load')} s; "
           f"SPGEMM_TPU_NO_NATIVE=1 (numpy text I/O and join): time taken "
           f"{n['time_taken_s']:.6f} s, load {n['phases'].get('load')}, chain "
           f"{n['phases'].get('chain')}, prune+write {n['phases'].get('prune+write')} s; "
           f"./matrix ({d['matrix_bytes'] / 1e9:.3f} GB) read back in {d['read_back_s']:.3f} s "
           "equals the in-memory result after prune_zeros (all three runs); --ranks 8: time "
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
    phases = {m.group(1): float(m.group(2))
              for m in re.finditer(r"phase (\S+): ([0-9.]+)s", proc.stderr)}
    return {"time_taken_s": float(taken.group(1)), "phases": phases,
            "tiles": got.nnzb, "tiles_differing_from_p1": _differing_tiles(got, p1),
            "in_memory_ooc_s": mem_s}


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
           f"block_m 16 and 128")

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
        "ms_small_m": ms["k4_mm1_small"], "bound_small_m": b1s,
        "library_ms_small_m": ms["lib_mm1_small"], **common}
    return [stream_row, resident_row]


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
    for _ in range(KERNEL_REPEATS):
        for mode in ("off", "on"):
            plancache.clear()
            runs[mode].append(_timed_chain(dev_mats, want, SPGEMM_TPU_DELTA="0",
                                           SPGEMM_TPU_PLAN_ESTIMATE="0" if mode == "off" else "1"))
    med = {mode: _median_run(rs) for mode, rs in runs.items()}
    if not med["on"]["est_hits"] or med["off"]["est_hits"] or med["off"]["est_fallbacks"]:
        raise RuntimeError(f"[estimate] estimator counts: {med}")
    walls = {mode: ", ".join(f"{r['wall_s']:.6f}" for r in rs) for mode, rs in runs.items()}
    plancache.clear()
    _phase("estimate", t0, "Medium chain of distinct structures, empty plan cache, medians of "
           f"{KERNEL_REPEATS} in turns: estimator off wall {med['off']['wall_s']:.6f} s (plan "
           f"{med['off']['plan']:.6f}, plan_wait {med['off']['plan_wait']:.6f} s; runs "
           f"{walls['off']}); on wall {med['on']['wall_s']:.6f} s (plan {med['on']['plan']:.6f}, "
           f"plan_exact {med['on']['plan_exact']:.6f}, plan_wait {med['on']['plan_wait']:.6f} s; "
           f"est_hits {med['on']['est_hits']}, est_fallbacks {med['on']['est_fallbacks']}; runs "
           f"{walls['on']}); results equal")
    return {"off": med["off"], "on": med["on"], "runs": runs}


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
                 keep: str | None = None) -> None:
    """Kernel 1 launched on the card, not degraded, and ./out equal to want:
    read back with the native parser against the in-memory engine's result,
    or, when want is a path, byte for byte against that earlier leg's file.
    The file is then removed, or renamed to keep."""
    det = job["detail"]
    on_card = DEVICE == "cuda"
    if det.get("degraded") is not False or det.get("device") != ("cuda:0" if on_card else "cpu") \
            or (on_card and det.get("launches_numeric_round", 0) < 1):
        raise RuntimeError(f"[serve] ({leg}) did not run kernel 1 on the card: {det}")
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
    job = client.wait(client.submit(folder, sock, {"output": out})["id"], sock,
                      timeout=300)["job"]
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
    return {"reaped_s": reaped_s, **seen, "canary_wall_s": wall,
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
            t0 = time.perf_counter()
            ids = [client.submit(folder, sock, {"output": os.path.join(tmp, f"again{j}")})["id"]
                   for j, folder in enumerate(folders)]
            jobs = [client.wait(i, sock, timeout=300)["job"] for i in ids]
            wall = time.perf_counter() - t0
            after = client.stats(sock)["serve"]
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
    for job in first + jobs:
        print(f"[serve] (h) {job['id']} ({'batch ' + job['batch'] if job['batch'] else 'solo'}) "
              f"on {smi}: phases_s {job['detail']['phases_s']}; kernel-1 launches "
              f"{job['detail'].get('launches_numeric_round', 0)}", flush=True)
    return {"wall_s": wall, "batch": batch_ids.pop(), "launches_per_member": launches,
            "first_launches": [job["detail"].get("launches_numeric_round", 0) for job in first],
            "phases_s": [job["detail"]["phases_s"] for job in jobs],
            "first_phases_s": [job["detail"]["phases_s"] for job in first],
            "head_execute_s": head.get("serve_execute"), "mate_queue_wait_s": mate_waits,
            "serve_batches": after["serve_batches"] - before["serve_batches"]}


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


def phase_serve(medium, cli: dict) -> dict:
    """[serve]: the port's daemon (`python -m spgemm_tpu_torch.cli serve`, on
    the card) driven with its client over text directories of the Medium
    chain and of the Medium chain of distinct structures, under a temporary
    directory it deletes: (a) Medium cold, (b) Medium again (every plan a
    hit), (c0) the chain of distinct structures, (c) the same with 11 tile
    rows of M5 given new values (delta recompute and the splice); then a
    second daemon on the same socket and warm directory, started with the
    watchdog leg armed: (e) (_serve_watchdog) and (d), Medium again (warm
    hits).  Each result is read back and held against the in-memory
    engine's.  Every job of (a)-(d) must run kernel 1 on the card, and no
    degrade but (e)'s may happen.  Each job's own counters come from its
    PhaseScope in the daemon: zero at pickup, read at its end."""
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
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
            # (a) is read back against the engine; (b) and (d) must give its bytes
            for leg, folder, want in (("a", medium_dir, want_a), ("b", medium_dir, res_a),
                                      ("c0", distinct_dir, want_c0)):
                jobs[leg], wall = _serve_job(client, sock, folder, res)
                _serve_check(leg, jobs[leg], res, want, keep=res_a if leg == "a" else None)
                out[f"flush_{leg}_s"] = _serve_idle(client, sock)
                out[leg] = _serve_report(leg, jobs[leg], wall, smi)
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
            _serve_check("c", jobs["c"], res, want_c)
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
            _serve_stop(proc, sock, client, log_path)
            # the second daemon: the watchdog leg armed (its knobs), then (d)
            env_e = _serve_env(SPGEMM_TPU_FAILPOINTS="serve.heartbeat:1:1",
                               SPGEMM_TPU_SERVE_JOB_TIMEOUT=str(SERVE_TIMEOUT_S),
                               SPGEMM_TPU_SERVE_WEDGE_GRACE_S=str(SERVE_GRACE_S),
                               SPGEMM_TPU_SERVE_RECOVER_S=str(SERVE_RECOVER_S))
            proc, out["restart"] = _serve_start(sock, env_e, log_path)
            out["e"] = _serve_watchdog(client, sock, tmp)
            jobs["d"], wall = _serve_job(client, sock, medium_dir, res, timeout_s=0)
            _serve_check("d", jobs["d"], res, res_a)
            out["d"] = _serve_report("d", jobs["d"], wall, smi)
            if jobs["d"]["detail"].get("warm_hits", 0) < 1:
                raise RuntimeError(f"[serve] (d) no warm hit: {jobs['d']['detail']}")
            st = client.stats(sock)
            if st["degraded"] or st["serve"]["serve_degrades"] != 1:
                raise RuntimeError(f"[serve] (d) a degrade besides (e)'s: {st['serve']}")
            _serve_stop(proc, sock, client, log_path)
            t_batch = time.perf_counter()
            out["batch"] = _serve_batch_legs(medium, tmp, smi)
            out["batch_s"] = time.perf_counter() - t_batch
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
           f"{out['batch_s']:.3f} s; the phase beyond writing the directories "
           f"{time.perf_counter() - t0 - out['write_dirs_s']:.3f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--warm-child"]:
        return _warm_child(sys.argv[2])
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
    splice_row = phase_delta(medium)
    splice_row["warm"] = phase_warm()
    splice_row["estimate"] = phase_estimate(medium)
    dense_row = phase_dense(medium, row["ms"])
    row["serve"] = phase_serve(medium, row["cli"])
    del medium
    torch.cuda.empty_cache()
    no_mod_row, mxu_row = phase_medium_small()
    no_mod_row["max_abs_err"] = max(no_mod_row["max_abs_err"], kernel_err["no_mod"])
    no_mod_row["ptxas"] = row["ptxas"]["no_mod"]
    no_mod_row["geometry"] = row["geometry"]["no_mod"]
    mxu_row["max_abs_err"] = max(mxu_row["max_abs_err"], kernel_err["mxu"])
    row["cli_modes"] = phase_cli_modes(rng)
    torch.cuda.empty_cache()
    ffn_rows = phase_ffn()
    for r in ffn_rows:
        r["max_abs_err"] = max(r["max_abs_err"], kernel_err[r["name"]])
    print(json.dumps({"kernels": [row, no_mod_row, mxu_row, *ffn_rows, splice_row,
                                  dense_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
