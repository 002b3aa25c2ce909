"""Measured speed gate of the hybrid router (ops/spgemm.py): limb kernel or
exact kernel, for a round the exactness proof has already cleared.

Both kernels give the same bits on a proven round, so the gate ranks wall
time only.  Policy, from SPGEMM_TPU_HYBRID_GATE:

  * "auto"  -- time both kernels once per (card, limb counts, k, key class,
               P), persist the result, route to the faster.  Default on CUDA.
  * "proof" -- route every proven round to the limb kernel.  Default on the
               CPU, where the plain versions' speed says nothing about a card
               and tests pin deterministic routing.

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
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from spgemm_tpu_torch.utils import knobs

log = logging.getLogger("spgemm_tpu_torch.crossover")

CACHE_FILE = "hybrid_crossover.json"
# The measurement's key axis: per-key cost is flat past a few thousand keys,
# so larger classes share one measurement at this many keys.
MEASURE_KEYS = 4096
MEASURE_TILES = 2048

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


def cache_key(device, a_limbs: int, b_limbs: int, k: int, K: int, P: int) -> str:
    """The cache key of one measurement: the version of the timed kernels,
    the card's name, the limb counts, k, the key class and P."""
    dev = torch.device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return f"v3:{name}:l{a_limbs}x{b_limbs}:k{k}:K{K}:P{P}"


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
