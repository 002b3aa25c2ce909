"""Delta recompute: row-granular incremental multiplies for evolving inputs
(the port's copy of the JAX package's `ops/delta.py`).

A long-lived process sees the same chain submitted again with a few tiles
changed.  The plan cache already skips the planner on such repeats; this
module lets the numeric phase skip the output rows nothing reached:

  * `row_digests` hashes each tile-row of a host operand (coords and tile
    bytes, through plancache.hash_update, the step the plan fingerprint
    uses); rows whose digest changed since the previous submit are dirty;
  * `reach` carries input-row dirtiness through the exact join's pair
    lists to the output tile-rows it can reach;
  * ops/spgemm then folds only those rows (a sub-plan built by
    symbolic.slice_join, each kept key's pair list whole and in order)
    and splices them into the retained previous result.

Exactness by construction: an output key's bytes are a function of the
tiles its pair list reads, in j-ascending order (SURVEY.md section 2.9), so
an untouched row keeps its bytes and a dirty row re-folds in full.
SPGEMM_TPU_DELTA=0 is the A/B: the same bytes either way.

Provenance of each operand of a retained multiply:

  * ("digest", rows, digests): a host-reachable operand (a leaf of the
    chain: a BlockSparseMatrix, or a DeviceBlockMatrix uploaded from one,
    which keeps it as `_host`);
  * ("tag", key, version): a partial this module served carries a DeltaTag
    (its entry, its version and its dirty output rows), so the next
    multiply takes its dirty set with no hashing and no copy to the host,
    as long as the version lineage matches;
  * ("opaque",): nothing proves what changed.

Any doubt -- first contact, a lineage gap, an evicted entry, an opaque
operand -- is a counted full fallback that re-seeds the entry.  Versions
come from one process-wide counter that never goes back (clear() included),
and the warm store fences it past every version on disk (fence_version), so
a tag can never be mistaken for another lineage's.

Multiplies of one structure share one entry (the key is the plan's
fingerprint and the operands' placement): on a chain whose level repeats a
structure, each such multiply diffs against its sibling's provenance, finds
every row dirty and takes the full path.  The JAX package behaves the same.

Host-only; the retained result is opaque here (ops/spgemm owns it).  Knobs
(utils/knobs.py): SPGEMM_TPU_DELTA 0|1 (default 1), SPGEMM_TPU_DELTA_RETAIN
int >= 1 (default 16, entries kept, LRU; each holds one result on the card).
ops/spgemm mirrors the accounting into ENGINE: `delta_rows_recomputed`,
`delta_rows_total`, `delta_full_fallbacks`, phases `delta_diff` and
`delta_splice`.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from spgemm_tpu_torch.ops import plancache
from spgemm_tpu_torch.utils import knobs

_LOCK = threading.Lock()
_STORE: "OrderedDict[str, DeltaEntry]" = OrderedDict()  # guarded by _LOCK
_STATS = {"hits": 0, "full_fallbacks": 0, "evictions": 0,
          "rows_recomputed": 0, "rows_total": 0}  # guarded by _LOCK
# full fallbacks by reason: "no_entry" (first contact or an evicted entry),
# "provenance_mismatch" (a lineage the store could not prove)
_FALLBACK_REASONS: dict = {}  # guarded by _LOCK
_VERSION = 0  # guarded by _LOCK; monotonic, never reset
# row_digests splits an operand of at least this many tile bytes over a pool
# of host threads (hashlib releases the GIL while it hashes a row's bytes)
PARALLEL_MIN_BYTES = 1 << 22
_POOL: ThreadPoolExecutor | None = None  # guarded by _LOCK, made at first use


def enabled() -> bool:
    """SPGEMM_TPU_DELTA (default 1)."""
    return knobs.get("SPGEMM_TPU_DELTA")


def capacity() -> int:
    """SPGEMM_TPU_DELTA_RETAIN (default 16), read at each store."""
    return knobs.get("SPGEMM_TPU_DELTA_RETAIN")


def placement_of(key: str) -> str:
    """The placement part of a store key (ops/spgemm._delta_key appends
    `|dev<a>x<b>`), or "(none)"."""
    part = key.split("|dev", 1)
    return "dev" + part[1] if len(part) == 2 else "(none)"


def placement_histogram(keys) -> dict:
    """Keys counted by placement_of."""
    out: dict[str, int] = {}
    for key in keys:
        name = placement_of(key)
        out[name] = out.get(name, 0) + 1
    return out


def _next_version() -> int:
    global _VERSION
    with _LOCK:
        _VERSION += 1
        return _VERSION


@dataclass
class DeltaTag:
    """Provenance a delta-served multiply attaches to its result
    (`_delta_tag`): version `version` of entry `key`, differing from
    `prev_version` in exactly the output tile-rows `dirty_rows`."""

    key: str
    version: int
    prev_version: int
    dirty_rows: np.ndarray


@dataclass
class DeltaEntry:
    """The retained state of one multiply structure.  Changed only by the
    thread that executes the multiply; the store itself is _LOCK-guarded."""

    key: str
    version: int
    a_src: tuple   # ("digest", rows, digests) | ("tag", key, version) | ("opaque",)
    b_src: tuple
    result: object  # the previous result (ops/spgemm's DeviceBlockMatrix)
    out_rows: int   # distinct output tile-rows of the multiply


@dataclass
class DeltaDiff:
    """One diff's verdict: the join keys to re-fold (key_mask, the dirty
    output rows spread back over the keys), the dirty output-row ids, and
    the operands' new provenance for commit."""

    key_mask: np.ndarray
    dirty_rows: np.ndarray
    new_a_src: tuple
    new_b_src: tuple


# ------------------------------------------------------------ row digests --
def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(os.cpu_count() or 1, thread_name_prefix="delta-digest")
        return _POOL


def _digest_rows(base, cbuf, tbuf, cs: int, ts: int, starts, ends) -> list:
    out = []
    for s, e in zip(starts, ends):
        h = base.copy()
        h.update(cbuf[s * cs:e * cs])
        h.update(tbuf[s * ts:e * ts])
        out.append(h.digest())
    return out


def row_digests(coords: np.ndarray, tiles: np.ndarray,
                workers: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """(row_ids, digests): one sha256 per distinct tile-row over the row's
    coordinates and tile bytes, after a header that hashes both arrays'
    dtypes and tile shape through plancache.hash_update.  Equal digests
    are equal rows.  coords lex-sorted, so each row is one slice; the
    slices are hashed from zero-copy views.  An operand of at least
    PARALLEL_MIN_BYTES of tiles has its rows split into `workers` runs
    (default: the host's cores) hashed on a thread pool; each row's digest
    is the same either way."""
    coords = np.ascontiguousarray(coords)
    n = len(coords)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, dtype="S32")
    row_ids, starts = np.unique(coords[:, 0], return_index=True)
    ends = np.append(starts[1:], n)
    tiles = np.ascontiguousarray(tiles)
    base = hashlib.sha256()
    plancache.hash_update(base, coords[:0])
    plancache.hash_update(base, tiles[:0])
    cbuf = memoryview(coords).cast("B")
    tbuf = memoryview(tiles).cast("B")
    args = (base, cbuf, tbuf, len(cbuf) // n, len(tbuf) // n)
    starts, ends = starts.tolist(), ends.tolist()
    workers = (os.cpu_count() or 1) if workers is None else workers
    if workers > 1 and tiles.nbytes >= PARALLEL_MIN_BYTES and len(row_ids) >= 2 * workers:
        cut = np.linspace(0, len(row_ids), workers + 1).astype(int).tolist()
        runs = [_pool().submit(_digest_rows, *args, starts[lo:hi], ends[lo:hi])
                for lo, hi in zip(cut[:-1], cut[1:])]
        out = [d for run in runs for d in run.result()]
    else:
        out = _digest_rows(*args, starts, ends)
    return row_ids, np.array(out, dtype="S32")


def _host_view(m):
    """(coords, tiles) of an operand's host copy, or None.  A device
    matrix qualifies only through `_host`: a digest never forces a copy
    from the card."""
    tiles = getattr(m, "tiles", None)
    if tiles is not None:
        return m.coords, tiles
    host = getattr(m, "_host", None)
    if host is not None:
        return host.coords, host.tiles
    return None


def stash_digests(a, b) -> tuple:
    """Both operands' row digests computed ahead, (a's, b's), each None
    where the operand's tiles are not on the host.  chain.py's plan-ahead
    worker calls it so the hashing leaves the dispatching thread, and hands
    the stash with the pair's plan to that one multiply
    (spgemm_device(..., digests=)), where diff and store_full take it in
    place of hashing anew.  Nothing is attached to the operands: the stash
    lives only as long as its multiply, so tiles changed in place later are
    always hashed anew.  (The JAX package stashes on the operand, where a
    stash that no multiply takes outlives it and can later pass an edited
    row as clean.)"""
    view_a = _host_view(a)
    got_a = None if view_a is None else row_digests(*view_a)
    if b is a:
        return got_a, got_a
    view_b = _host_view(b)
    return got_a, None if view_b is None else row_digests(*view_b)


def current_digests(m, stashed=None):
    """The operand's (row_ids, digests): its multiply's stash where there
    is one, else computed now; None when its tiles are not on the host."""
    if stashed is not None:
        return stashed
    view = _host_view(m)
    return None if view is None else row_digests(*view)


# --------------------------------------------------------------- the store --
def lookup(key: str):
    """The entry for key, or None; a hit becomes the most recent."""
    with _LOCK:
        entry = _STORE.get(key)
        if entry is not None:
            _STORE.move_to_end(key)
        return entry


def note_fallback_reason(reason: str) -> None:
    with _LOCK:
        _FALLBACK_REASONS[reason] = _FALLBACK_REASONS.get(reason, 0) + 1


def clear() -> None:
    """Drop every entry and zero the counts (the version counter goes on)."""
    with _LOCK:
        _STORE.clear()
        for name in _STATS:
            _STATS[name] = 0
        _FALLBACK_REASONS.clear()


def stats() -> dict:
    """Delta-served multiplies, full fallbacks (with their reasons), rows
    recomputed of rows total, and the store's state."""
    cap = capacity()
    with _LOCK:
        return {**_STATS, "fallback_reasons": dict(_FALLBACK_REASONS),
                "entries": len(_STORE), "placements": placement_histogram(_STORE),
                "capacity": cap, "enabled": enabled()}


def _store_entry(entry: DeltaEntry) -> None:
    cap = capacity()
    with _LOCK:
        _STORE[entry.key] = entry
        _STORE.move_to_end(entry.key)
        while len(_STORE) > cap:
            _STORE.popitem(last=False)
            _STATS["evictions"] += 1


def entries() -> list:
    """A copy of the live (key, entry) pairs, least recent first (the warm
    store's flush walks it)."""
    with _LOCK:
        return list(_STORE.items())


def fence_version(v: int) -> None:
    """Move the version counter past v: a persisted entry, or a tag it
    references, carries a version from an earlier process, and a fresh
    counter would hand the same number to another lineage."""
    global _VERSION
    with _LOCK:
        _VERSION = max(_VERSION, int(v))


def seed_entry(entry: DeltaEntry) -> None:
    """Install a reloaded entry, the counter fenced past it."""
    fence_version(entry.version)
    _store_entry(entry)


# ------------------------------------------------------------------ diffing --
def _operand_dirty(src: tuple, m, stashed):
    """(dirty row ids, new provenance) of operand m against src, or None
    when the lineage cannot be proven.  stashed: m's digests computed
    ahead for this multiply, or None."""
    if src[0] == "digest":
        cur = current_digests(m, stashed)
        if cur is None:
            return None
        row_ids, digs = cur
        if not np.array_equal(src[1], row_ids):
            return None
        return row_ids[src[2] != digs], ("digest", row_ids, digs)
    if src[0] == "tag":
        tag = getattr(m, "_delta_tag", None)
        if tag is None or tag.key != src[1]:
            return None
        if tag.prev_version == src[2]:
            dirty = np.asarray(tag.dirty_rows, np.int64)
        elif tag.version == src[2]:
            dirty = np.zeros(0, np.int64)  # the version this entry consumed
        else:
            return None  # a lineage gap
        return dirty, ("tag", tag.key, tag.version)
    return None


def operand_src(m, stashed=None) -> tuple:
    """Provenance to store for an operand on the full path: its tag, else
    its row digests (stashed, or computed now), else opaque."""
    tag = getattr(m, "_delta_tag", None)
    if tag is not None:
        return ("tag", tag.key, tag.version)
    cur = current_digests(m, stashed)
    if cur is not None:
        return ("digest", *cur)
    return ("opaque",)


def reach(join_keys: np.ndarray, pair_ptr: np.ndarray, pair_a: np.ndarray,
          pair_b: np.ndarray, a_coords: np.ndarray, b_coords: np.ndarray,
          dirty_a_rows: np.ndarray, dirty_b_rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A pair is dirty when its A or B tile lies in a dirty input tile-row,
    a key when any of its pairs is, and the set rounds up to whole output
    tile-rows.  Returns (key_mask, dirty_output_rows)."""
    num_keys = len(join_keys)
    if num_keys == 0:
        return np.zeros(0, bool), np.zeros(0, np.int64)
    dirty_blk_a = np.isin(a_coords[:, 0], dirty_a_rows)
    dirty_blk_b = np.isin(b_coords[:, 0], dirty_b_rows)
    hit = np.flatnonzero(dirty_blk_a[pair_a] | dirty_blk_b[pair_b])
    key_dirty = np.zeros(num_keys, bool)
    key_dirty[np.searchsorted(pair_ptr, hit, side="right") - 1] = True
    dirty_rows = np.unique(join_keys[key_dirty, 0])
    return np.isin(join_keys[:, 0], dirty_rows), dirty_rows


def diff(entry: DeltaEntry, a, b, join, a_coords: np.ndarray,
         b_coords: np.ndarray, stash: tuple = (None, None)) -> DeltaDiff | None:
    """Both operands against the entry's provenance, carried through the
    join; None on any lineage doubt (a full fallback).  stash: the
    operands' digests computed ahead for this multiply (stash_digests)."""
    got_a = _operand_dirty(entry.a_src, a, stash[0])
    if got_a is None:
        return None
    got_b = _operand_dirty(entry.b_src, b, stash[1])
    if got_b is None:
        return None
    (dirty_a, new_a_src), (dirty_b, new_b_src) = got_a, got_b
    key_mask, dirty_rows = reach(join.keys, join.pair_ptr, join.pair_a, join.pair_b,
                                 a_coords, b_coords, dirty_a, dirty_b)
    return DeltaDiff(key_mask=key_mask, dirty_rows=dirty_rows,
                     new_a_src=new_a_src, new_b_src=new_b_src)


# ------------------------------------------------------------------ commits --
def _tag(result, key: str, version: int, prev_version: int, dirty_rows: np.ndarray) -> None:
    try:
        result._delta_tag = DeltaTag(key=key, version=version, prev_version=prev_version,
                                     dirty_rows=dirty_rows)
    except AttributeError:
        pass  # a result type without a __dict__: the next multiply falls back


def commit(entry: DeltaEntry, result, d: DeltaDiff, out_rows: int) -> None:
    """Land a delta-served multiply: a new version, the new provenance and
    result, and the result tagged for the next multiply."""
    prev_version = entry.version
    entry.version = _next_version()
    entry.a_src, entry.b_src = d.new_a_src, d.new_b_src
    entry.result = result
    entry.out_rows = out_rows
    _store_entry(entry)
    _tag(result, entry.key, entry.version, prev_version, np.asarray(d.dirty_rows, np.int64))
    with _LOCK:
        _STATS["hits"] += 1
        _STATS["rows_recomputed"] += len(d.dirty_rows)
        _STATS["rows_total"] += out_rows


def store_full(key: str, a, b, result, out_rows: int, out_row_ids: np.ndarray,
               stash: tuple = (None, None)) -> None:
    """Land a full multiply (first contact or fallback): seed the entry and
    tag the result all-dirty against the previous version.  With an opaque
    operand nothing is stored and the result is not tagged, so the store
    never holds a result it cannot serve.  stash: as for diff."""
    with _LOCK:
        prev = _STORE.get(key)
        prev_version = prev.version if prev is not None else 0
        _STATS["full_fallbacks"] += 1
        _STATS["rows_recomputed"] += out_rows
        _STATS["rows_total"] += out_rows
    a_src = operand_src(a, stash[0])
    if a_src[0] == "opaque":
        return  # no state to drop: the stash dies with this multiply
    b_src = operand_src(b, stash[1])
    if b_src[0] == "opaque":
        return
    version = _next_version()
    _store_entry(DeltaEntry(key=key, version=version, a_src=a_src, b_src=b_src,
                            result=result, out_rows=out_rows))
    _tag(result, key, version, prev_version, np.asarray(out_row_ids, np.int64))
