"""Measured speed gates of ops/spgemm.execute: the hybrid router's (limb
kernel or exact kernel, for a round the exactness proof has already cleared)
and the auto accumulator route's (kernel 1 on the ladder layout or the
segmented-fold kernel on the dense stream, for a round with a dense twin).

Both kernels of a gate give the same bits, so a gate ranks wall time only.
Policy, from SPGEMM_TPU_HYBRID_GATE, for both gates:

  * "auto"  -- time both kernels once per shape key, persist the result,
               route to the faster.  Default on CUDA.
  * "proof" -- route every proven round to the limb kernel; take the dense
               twin where the ladder's padded-MAC ratio reaches
               DENSE_RATIO_GATE (the JAX package's structural gate).
               Default on the CPU, where the plain versions' speed says
               nothing about a card and tests pin deterministic routing.

Any other value of SPGEMM_TPU_HYBRID_GATE raises.  The cache is a JSON file,
`hybrid_crossover.json`, in the directory SPGEMM_TPU_CROSSOVER_CACHE names
(default ~/.cache/spgemm_tpu_torch).  A measurement that fails raises: it
does not route to either kernel by default.  Timing inputs are random slabs,
since both kernels take the same time whatever the values.

The measurement's rounds are pad-free: every slot of its (K, P) indices is a
real pair.  The planner's rounds carry sentinel slots (the pair axis and the
key axis pad to the shape ladder), which both kernels skip, so the padding
costs each of them little beside its real pairs, and both give the same
bits.  The key's version names the kernels that were timed: v3 is the limb
kernel on byte limbs that skips sentinel slots (v2 timed the earlier limb
kernel beside the kernel 1 that skips them), so a cache written for earlier
kernels is not read.

The dense gate's keys are `dense-v1:<card>:<ladder variant>:k..:K..:P..`:
the ladder leg is the kernel-1 variant the round would run (mod, or no_mod
under a hybrid proof), and the dense leg the segmented fold, always mod.
Its timing round holds the round's real pair count (scaled to the measured
key class), spread evenly over the keys: on the ladder leg each key's real
slots first and sentinel slots after, as the planner lays them out, since
kernel 1 skips those; on the dense leg one stream of the same pairs with
contiguous rows, as the planner's dense layout has them.  The JAX package
times rows cycling over the keys (`arange % K`); contiguous rows are the
only layout the planner makes.
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from spgemm_tpu_torch.ops.symbolic import _segment_expand, _stream_pad
from spgemm_tpu_torch.utils import knobs

log = logging.getLogger("spgemm_tpu_torch.crossover")

CACHE_FILE = "hybrid_crossover.json"
# The measurement's key axis: per-key cost is flat past a few thousand keys,
# so larger classes share one measurement at this many keys.
MEASURE_KEYS = 4096
MEASURE_TILES = 2048
# The proof policy's dense gate (the JAX package's): the dense twin runs
# where the ladder layout ships at least this many pair slots per real pair.
DENSE_RATIO_GATE = 1.25

# Measured entries by cache-file path, so that a changed
# SPGEMM_TPU_CROSSOVER_CACHE neither sees nor shadows the old file's.
_CACHE: dict[str, dict] = {}


def gate_policy(device) -> str:
    """'auto' or 'proof' for rounds on `device` (see the module docstring)."""
    policy = knobs.get("SPGEMM_TPU_HYBRID_GATE")
    if policy is not None:
        return policy
    return "auto" if torch.device(device).type == "cuda" else "proof"


def cache_path() -> str:
    root = knobs.get("SPGEMM_TPU_CROSSOVER_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "spgemm_tpu_torch")
    return os.path.join(root, CACHE_FILE)


def _card(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def cache_key(device, a_limbs: int, b_limbs: int, k: int, K: int, P: int) -> str:
    """The cache key of one measurement: the version of the timed kernels,
    the card's name, the limb counts, k, the key class and P."""
    return f"v3:{_card(device)}:l{a_limbs}x{b_limbs}:k{k}:K{K}:P{P}"


def dense_cache_key(device, ladder: str, k: int, K: int, P: int) -> str:
    """The dense gate's cache key: the card, the ladder leg's kernel-1
    variant ('mod' or 'no_mod'), k, the key class and P."""
    return f"dense-v1:{_card(device)}:{ladder}:k{k}:K{K}:P{P}"


def _load() -> dict:
    path = cache_path()
    if path not in _CACHE:
        try:
            with open(path) as f:
                _CACHE[path] = json.load(f)
        except (OSError, ValueError):
            _CACHE[path] = {}
    return _CACHE[path]


def _save() -> None:
    """Write the cache, keeping entries another process wrote meanwhile
    (first measurement of a key wins)."""
    path = cache_path()
    entries = _CACHE.get(path, {})
    try:
        with open(path) as f:
            on_disk = json.load(f)
    except (OSError, ValueError):
        on_disk = {}
    entries.update({key: v for key, v in on_disk.items() if key not in entries})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(entries, f, indent=0, sort_keys=True)
    os.replace(tmp, path)


def entries() -> dict:
    """A copy of the measured entries of the current cache file."""
    return dict(_load())


def _time_call(fn, args, device, repeats: int = 2) -> float:
    """Least wall seconds of fn(*args) over `repeats` runs after one warm-up,
    each closed by torch.cuda.synchronize() on a card."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)

    def once() -> float:
        sync()
        t0 = time.perf_counter()
        fn(*args)
        sync()
        return time.perf_counter() - t0

    once()
    return min(once() for _ in range(repeats))


def mxu_wins(exact_fn, mxu_fn, *, key: str, k: int, K: int, P: int, device) -> bool:
    """True iff mxu_fn measured faster than exact_fn on a round of K keys
    and P pairs.  The first call for a key measures both and persists the
    times; later calls read the cache."""
    cache = _load()
    hit = cache.get(key)
    if hit is None:
        rng = np.random.default_rng(0)
        tiles = rng.integers(0, 1 << 63, size=(MEASURE_TILES + 1, k, k), dtype=np.int64)
        tiles[-1] = 0  # the sentinel zero tile, as the planner guarantees
        slab = torch.from_numpy(tiles).to(device)
        pa = torch.from_numpy(rng.integers(0, MEASURE_TILES, size=(K, P), dtype=np.int32)).to(device)
        pb = torch.from_numpy(rng.integers(0, MEASURE_TILES, size=(K, P), dtype=np.int32)).to(device)
        args = (slab, slab, pa, pb)
        hit = {"exact_s": _time_call(exact_fn, args, device),
               "mxu_s": _time_call(mxu_fn, args, device)}
        cache[key] = hit
        _save()
        log.info("crossover %s: exact=%.6fs mxu=%.6fs -> %s", key, hit["exact_s"],
                 hit["mxu_s"], "mxu" if hit["mxu_s"] < hit["exact_s"] else "exact")
    return hit["mxu_s"] < hit["exact_s"]


def _dense_timing_round(k: int, K: int, P: int, real: int, device) -> tuple:
    """The dense gate's timing inputs on `device`: (slab, ladder pa, pb,
    stream pa, pb, seg, row_ptr), `real` pairs spread evenly over K keys
    (see the module docstring)."""
    rng = np.random.default_rng(0)
    tiles = rng.integers(0, 1 << 63, size=(MEASURE_TILES + 1, k, k), dtype=np.int64)
    tiles[-1] = 0
    per_key = np.full(K, real // K, np.int64)
    per_key[: real % K] += 1
    rows, cols = _segment_expand(per_key)
    pair_a = rng.integers(0, MEASURE_TILES, size=real, dtype=np.int32)
    pair_b = rng.integers(0, MEASURE_TILES, size=real, dtype=np.int32)
    pa = np.full((K, P), MEASURE_TILES, np.int32)
    pb = np.full((K, P), MEASURE_TILES, np.int32)
    pa[rows, cols], pb[rows, cols] = pair_a, pair_b
    L = _stream_pad(real)
    spa = np.full(L, MEASURE_TILES, np.int32)
    spb = np.full(L, MEASURE_TILES, np.int32)
    seg = np.full(L, K, np.int32)
    spa[:real], spb[:real], seg[:real] = pair_a, pair_b, rows
    row_ptr = np.searchsorted(seg[:real], np.arange(K + 1)).astype(np.int64)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (tiles, pa, pb, spa, spb, seg, row_ptr))


def dense_wins(ladder_fn, dense_fn, *, key: str, k: int, K: int, P: int, real_pairs: int,
               device, policy: str, padded_ratio: float) -> bool:
    """True iff the dense twin should replace the ladder layout on a round
    of K keys (the key class, at most MEASURE_KEYS), class width P and
    real_pairs real pairs.  Under 'proof': iff padded_ratio (the ladder
    layout's shipped / real slots) reaches DENSE_RATIO_GATE.  Under 'auto':
    the first call for a key times ladder_fn(a, b, pa, pb) against
    dense_fn(a, b, pa, pb, seg, n_rows, row_ptr) on the timing round, its
    indices on the card before the first timed run, and persists
    {"ladder_s", "dense_s"}; later calls read the cache."""
    if policy != "auto":
        return padded_ratio >= DENSE_RATIO_GATE
    cache = _load()
    hit = cache.get(key)
    if hit is None:
        real = max(1, min(real_pairs, K * P))
        slab, pa, pb, spa, spb, seg, row_ptr = _dense_timing_round(k, K, P, real, device)
        hit = {"ladder_s": _time_call(ladder_fn, (slab, slab, pa, pb), device),
               "dense_s": _time_call(dense_fn, (slab, slab, spa, spb, seg, K, row_ptr),
                                     device)}
        cache[key] = hit
        _save()
        log.info("crossover %s: ladder=%.6fs dense=%.6fs -> %s", key, hit["ladder_s"],
                 hit["dense_s"], "dense" if hit["dense_s"] < hit["ladder_s"] else "ladder")
    return hit["dense_s"] < hit["ladder_s"]
