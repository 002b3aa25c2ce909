"""Structure-keyed LRU cache of SpgemmPlan, and spgemmd's structure book
(the port's copy of the JAX package's `ops/plancache.py`, without the
tuner's class keys).

A plan (ops/spgemm.plan) depends only on the operands' block structures and
the plan parameters, never on tile values, so a multiply whose structures
were planned before can reuse that plan.  The key is a content fingerprint
over the coordinate arrays and a tuple of those parameters.  A chain whose
inputs share one structure repeats its operand structures level by level
(the Medium chain's 9 multiplies have 4).

Knobs (utils/knobs.py):
  SPGEMM_TPU_PLAN_CACHE      0|1 (default 1): memoization on or off.
  SPGEMM_TPU_PLAN_CACHE_CAP  int >= 1 (default 32): LRU capacity, read at
                             each store.

The structure book maps a chain folder's stat signature
(serve/placement.signature) to the fingerprint of its chain's block
structures (chain_fingerprint): the daemon's executor records it once it has
read a chain, and admission looks it up (a stat call and a dict lookup,
never a parse) to give the job its batching group key.  Values never enter
the fingerprint.  An LRU of STRUCT_CAP entries; an evicted or unknown folder
gets no group key and runs solo.

Cached plans are shared by every multiply that hits them, so ops/spgemm
makes their arrays read-only before storing them.  One lock guards the
cache and is held only for a lookup or a store, never for a build:
ops/spgemm.plan goes through get_or_build, which marks a key in flight
while its plan is built, so two planners (chain.py's planner thread and the
dispatching thread) build two keys at once, and never both build one key.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

import numpy as np

from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.timers import ENGINE

LOCK = threading.RLock()
_CACHE: "OrderedDict[str, object]" = OrderedDict()  # guarded by LOCK
_STATS = {"hits": 0, "misses": 0, "evictions": 0}  # guarded by LOCK
_BUILDING: "dict[str, threading.Event]" = {}  # keys in flight, guarded by LOCK
STRUCT_CAP = 4096  # structure-book entries (LRU past it)
_STRUCTS: "OrderedDict[str, str]" = OrderedDict()  # guarded by LOCK


def enabled() -> bool:
    """SPGEMM_TPU_PLAN_CACHE (default 1)."""
    return knobs.get("SPGEMM_TPU_PLAN_CACHE")


def hash_update(h, arr: np.ndarray) -> None:
    """Feed one array into an open hashlib digest: its shape and dtype, so
    two arrays of other shapes never collide, then its bytes.  The one
    content-hashing step: fingerprint below and ops/delta's row digests
    both go through it."""
    arr = np.ascontiguousarray(arr)
    h.update(repr((arr.shape, str(arr.dtype))).encode())
    h.update(memoryview(arr).cast("B") if arr.size else b"")
    h.update(b"|")


def fingerprint(a_coords: np.ndarray, b_coords: np.ndarray, meta: tuple) -> str:
    """blake2b over both coordinate arrays (hash_update) and the repr of
    meta, the plan parameters."""
    h = hashlib.blake2b(digest_size=32)
    for arr in (a_coords, b_coords):
        hash_update(h, arr)
    h.update(repr(meta).encode())
    return h.hexdigest()


def chain_fingerprint(coords_list) -> str:
    """Fingerprint of a chain's block structures: every matrix's coords, in
    chain order, through hash_update.  Two chains that share it walk the
    same plan sequence (planning depends on structure only), so their jobs
    may share plans and launches."""
    h = hashlib.blake2b(digest_size=32)
    h.update(b"chain|")
    for coords in coords_list:
        hash_update(h, np.asarray(coords))
    return h.hexdigest()


def note_chain_structure(sig: str | None, fp: str) -> None:
    """Record folder signature -> chain structure fingerprint (None: the
    folder could not be read, nothing is recorded)."""
    if sig is None:
        return
    with LOCK:
        _STRUCTS[sig] = fp
        _STRUCTS.move_to_end(sig)
        while len(_STRUCTS) > STRUCT_CAP:
            _STRUCTS.popitem(last=False)


def chain_structure(sig: str | None) -> str | None:
    """The recorded structure fingerprint of a folder signature, or None on
    first contact, after the content changed or after eviction (the job
    then runs solo: grouping never decides a result)."""
    if sig is None:
        return None
    with LOCK:
        fp = _STRUCTS.get(sig)
        if fp is not None:
            _STRUCTS.move_to_end(sig)
        return fp


def lookup(key: str):
    """The cached plan for key, or None; a hit becomes the most recent."""
    with LOCK:
        plan = _CACHE.get(key)
        if plan is None:
            _STATS["misses"] += 1
            return None
        _CACHE.move_to_end(key)
        _STATS["hits"] += 1
        return plan


def store(key: str, plan) -> int:
    """Insert a plan, evicting the least recent past the capacity; returns
    the number evicted."""
    cap = knobs.get("SPGEMM_TPU_PLAN_CACHE_CAP")
    evicted = 0
    with LOCK:
        _CACHE[key] = plan
        _CACHE.move_to_end(key)
        while len(_CACHE) > cap:
            _CACHE.popitem(last=False)
            evicted += 1
        _STATS["evictions"] += evicted
    return evicted


def get_or_build(key: str, build):
    """(plan, hit): the cached plan for key, or build()'s, stored.  A miss
    on a key that another thread is building waits for that build and
    counts as a hit; if that build fails, this thread builds in turn.
    Evictions of the store are ENGINE's `plan_cache_evictions`."""
    while True:
        with LOCK:
            plan = _CACHE.get(key)
            if plan is not None:
                _CACHE.move_to_end(key)
                _STATS["hits"] += 1
                return plan, True
            pending = _BUILDING.get(key)
            if pending is None:
                pending = _BUILDING[key] = threading.Event()
                _STATS["misses"] += 1
                break
        pending.wait()
    try:
        plan = build()
        evicted = store(key, plan)
        if evicted:
            ENGINE.incr("plan_cache_evictions", evicted)
        return plan, False
    finally:
        with LOCK:
            del _BUILDING[key]
        pending.set()


def entries() -> list:
    """A copy of the live (key, plan) pairs, least recent first (the warm
    store's flush walks it without holding the lock)."""
    with LOCK:
        return list(_CACHE.items())


def baseline() -> dict:
    """The counters now, for stats(since=): a caller that wants the hits,
    misses and evictions of one job takes a baseline before it."""
    with LOCK:
        return dict(_STATS)


def stats(since: dict | None = None) -> dict:
    """Hits, misses and evictions since the last clear(), or since the
    baseline() `since`, and the entries held."""
    base = since or {}
    with LOCK:
        return {**{name: n - base.get(name, 0) for name, n in _STATS.items()},
                "entries": len(_CACHE)}


def clear() -> None:
    """Drop every plan and structure-book entry and zero the statistics."""
    with LOCK:
        _CACHE.clear()
        _STRUCTS.clear()
        for name in _STATS:
            _STATS[name] = 0
