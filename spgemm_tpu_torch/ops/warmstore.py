"""Persistent warm store: the plan cache and the delta store on disk (the
port's copy of the plan and delta tiers of the JAX package's
`ops/warmstore.py`).

A process that outlives one chain keeps its plans (ops/plancache) and its
retained results (ops/delta) in memory; this module keeps them across a
restart:

  * an exact plan is one `plan-<fingerprint>.npz` (symbolic.plan_to_arrays):
    the fingerprint covers the operand coords and every plan parameter, so
    it is the file's key, and a reloaded plan replays the same folds;
  * a delta entry is one `delta-<hash of key>.npz`: the operands'
    provenance and the retained result's slab fetched to the host.

ops/spgemm reads a plan here after a plan-cache miss (and writes an exact
plan through at once), and a delta entry after a delta-store miss.  flush()
writes what is not on disk yet and prunes the oldest entries past
SPGEMM_TPU_WARM_MAX_MB.  Loading is lazy: an entry is read on its first
match.  Every write is a temporary file and an atomic rename.

Failure policy: a corrupt, truncated or foreign entry (another schema, kind,
identity or knob signature -- a file the JAX package wrote is one -- or a
plan codec skew) is counted (`warm_corrupt`), removed, and the caller goes
on cold.  It never raises into the engine and never yields other bits.

One process owns a directory at a time (a flock on `<dir>/lock`); another
runs cold.  The JAX package's third tier, its XLA compile cache, has no
counterpart here: the port's kernels and host library are built once into
content-hashed caches (ops/_build.py, utils/native.py).  Its tune tier
waits for the port's tune/.

Knobs (utils/knobs.py): SPGEMM_TPU_WARM 0|1 (default 1),
SPGEMM_TPU_WARM_DIR (unset: no persistence), SPGEMM_TPU_WARM_MAX_MB (256).
ENGINE counters: warm_hits, warm_misses, warm_corrupt; phases warm_load and
warm_flush.
"""

from __future__ import annotations

import fcntl
import hashlib
import logging
import os
import shutil
import threading
import time
import zipfile

import numpy as np

from spgemm_tpu_torch.utils import knobs
from spgemm_tpu_torch.utils.timers import ENGINE

log = logging.getLogger("spgemm_tpu_torch.warmstore")

# The envelope's schema; plan payloads carry their own codec version too.
SCHEMA_VERSION = 1

_LOCK = threading.Lock()
_DIR: str | None = None         # guarded by _LOCK
_DISABLED: str | None = None    # guarded by _LOCK
_LOCK_FILE = None               # guarded by _LOCK
# delta entries on disk, key -> version (an unchanged entry is not rewritten)
_SAVED_DELTA: dict = {}         # guarded by _LOCK
_STATS = {"plan_hits": 0, "plan_misses": 0, "delta_hits": 0, "delta_misses": 0,
          "corrupt": 0, "saved_plans": 0, "saved_deltas": 0, "pruned": 0}  # guarded by _LOCK

_VAL_BOUND_NONE = (1 << 64) - 1  # stands for a val_bound of None


def enabled() -> bool:
    """SPGEMM_TPU_WARM (default 1), read at each call."""
    return knobs.get("SPGEMM_TPU_WARM")


def budget_bytes() -> int:
    """SPGEMM_TPU_WARM_MAX_MB in bytes."""
    return knobs.get("SPGEMM_TPU_WARM_MAX_MB") * (1 << 20)


def _knob_sig() -> str:
    """The knob signature stored in and checked on every entry.  The one
    knob of the port that changes a plan, SPGEMM_TPU_ACCUM_ROUTE, is in the
    plan's fingerprint (ops/spgemm.plan puts the route into the plan-cache
    key), and no knob changes a result, so the signature names the package:
    an entry of the JAX package (whose signature is its jit-static knob
    vector) never matches."""
    return repr(("spgemm_tpu_torch", SCHEMA_VERSION))


def _try_flock(fh) -> bool:
    try:
        fcntl.flock(fh.fileno(), fcntl.LOCK_EX | fcntl.LOCK_NB)
        return True
    except OSError:
        return False


# ------------------------------------------------------------ configuration --
def configure(path: str | None = None) -> bool:
    """Bind the store to a directory and take its flock; True when usable.
    SPGEMM_TPU_WARM_DIR wins over `path`.  A directory another live
    process holds leaves this process cold (after a short retry)."""
    global _DIR, _DISABLED, _LOCK_FILE
    if not enabled():
        return False
    directory = knobs.get("SPGEMM_TPU_WARM_DIR") or path
    if not directory:
        return False
    with _LOCK:
        if _DIR == directory and _LOCK_FILE is not None:
            return True
        _release_locked()
        try:
            os.makedirs(directory, exist_ok=True)
            fh = open(os.path.join(directory, "lock"), "a+")
        except OSError as e:
            _DISABLED = f"warm dir unusable: {e!r}"
            log.warning("warm store disabled: %s", _DISABLED)
            return False
        locked = False
        for attempt in range(6):  # a `warm --stat` probe holds it for microseconds
            locked = _try_flock(fh)
            if locked or attempt == 5:
                break
            time.sleep(0.05)
        if not locked:
            fh.close()
            _DISABLED = f"warm dir {directory} is locked by another live process; running cold"
            log.warning("warm store disabled: %s", _DISABLED)
            return False
        _DIR, _DISABLED, _LOCK_FILE = directory, None, fh
        plans, deltas, size = _scan_dir(directory)
    _fence_delta_versions(directory)
    log.info("warm store at %s: %d plans, %d delta entries, %d bytes",
             directory, plans, deltas, size)
    return True


def _fence_delta_versions(directory: str) -> None:
    """Move ops/delta's version counter past every version on disk before
    any multiply mints one (see delta.fence_version).  An unreadable entry
    is skipped here and counted when it is loaded."""
    from spgemm_tpu_torch.ops import delta  # noqa: PLC0415 -- delta imports nothing of this

    high = 0
    for name in _listdir(directory):
        if name.startswith("delta-") and name.endswith(".npz"):
            try:
                with np.load(os.path.join(directory, name), allow_pickle=False) as z:
                    high = max(high, int(z["version"]))
            except Exception:  # noqa: BLE001 -- counted at load
                continue
    if high:
        delta.fence_version(high)


def _release_locked() -> None:
    global _DIR, _DISABLED, _LOCK_FILE
    if _LOCK_FILE is not None:
        try:
            _LOCK_FILE.close()  # drops the flock
        except OSError:
            pass
    _DIR = _DISABLED = _LOCK_FILE = None
    _SAVED_DELTA.clear()


def reset() -> None:
    """Drop the flock, unbind (the files stay) and zero the counts."""
    with _LOCK:
        _release_locked()
        for name in _STATS:
            _STATS[name] = 0


def active() -> bool:
    """Persistence on, a directory bound (from SPGEMM_TPU_WARM_DIR at first
    use) and its flock held."""
    if not enabled():
        return False
    with _LOCK:
        ready = _LOCK_FILE is not None or _DISABLED is not None
    if not ready and knobs.get("SPGEMM_TPU_WARM_DIR"):
        configure()
    with _LOCK:
        return _LOCK_FILE is not None


def directory() -> str | None:
    with _LOCK:
        return _DIR


def disabled_reason() -> str | None:
    with _LOCK:
        return _DISABLED


# --------------------------------------------------------------- file layer --
def _plan_path(d: str, fingerprint: str) -> str:
    return os.path.join(d, f"plan-{fingerprint}.npz")


def _delta_path(d: str, key: str) -> str:
    # the key holds device names: hashed into the name, stored whole inside
    return os.path.join(d, f"delta-{hashlib.sha256(key.encode()).hexdigest()[:40]}.npz")


def _atomic_savez(path: str, payload: dict) -> None:
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _listdir(d: str) -> list:
    try:
        return os.listdir(d)
    except OSError:
        return []


def _scan_dir(d: str) -> tuple[int, int, int]:
    """(plan files, delta files, bytes of all entries) of d."""
    plans = deltas = size = 0
    for name in _listdir(d):
        if not name.endswith(".npz") or name.endswith(".tmp.npz"):
            continue
        try:
            size += os.path.getsize(os.path.join(d, name))
        except OSError:
            continue
        plans += name.startswith("plan-")
        deltas += name.startswith("delta-")
    return plans, deltas, size


def _note_corrupt(path: str, reason: str) -> None:
    """Count one unusable entry and remove it, so the next flush writes a
    good one in its place; the caller goes on cold."""
    with _LOCK:
        _STATS["corrupt"] += 1
    ENGINE.incr("warm_corrupt")
    try:
        os.unlink(path)
    except OSError:
        pass
    log.warning("warm entry %s skipped (%s); removed, cold path", path, reason)


def _check_envelope(z, path: str, kind: str, ident: str) -> bool:
    """Schema, kind, identity and knob signature; False = counted corrupt."""
    schema = int(z["schema"]) if "schema" in z.files else -1
    if schema != SCHEMA_VERSION:
        _note_corrupt(path, f"schema version {schema} != {SCHEMA_VERSION}")
        return False
    if str(z["kind"]) != kind or str(z["ident"]) != ident:
        _note_corrupt(path, "entry identity mismatch")
        return False
    if str(z["knobs"]) != _knob_sig():
        _note_corrupt(path, "knob signature mismatch")
        return False
    return True


def _bound_dir() -> str | None:
    if not active():
        return None
    with _LOCK:
        return _DIR


def _miss(stat: str) -> None:
    with _LOCK:
        _STATS[stat] += 1
    ENGINE.incr("warm_misses")


def _hit(stat: str) -> None:
    with _LOCK:
        _STATS[stat] += 1
    ENGINE.incr("warm_hits")


# -------------------------------------------------------------------- plans --
def save_plan(plan) -> bool:
    """Write one exact fingerprinted plan, unless its file exists (a plan
    never changes once exact).  False when skipped."""
    if getattr(plan, "fingerprint", None) is None:
        return False
    d = _bound_dir()
    if d is None:
        return False
    from spgemm_tpu_torch.ops.symbolic import plan_to_arrays  # noqa: PLC0415 -- import cycle

    path = _plan_path(d, plan.fingerprint)
    if os.path.exists(path):
        return False
    payload = plan_to_arrays(plan)
    if payload is None:
        return False  # deferred: its join is not built yet
    payload.update(schema=np.int64(SCHEMA_VERSION), kind=np.array("plan"),
                   ident=np.array(plan.fingerprint), knobs=np.array(_knob_sig()))
    try:
        _atomic_savez(path, payload)
    except OSError as e:
        log.warning("warm plan save failed (%r); continuing", e)
        return False
    with _LOCK:
        _STATS["saved_plans"] += 1
    return True


def load_plan(fingerprint: str):
    """The plan stored for a fingerprint, or None (a miss, or a counted
    corrupt entry)."""
    d = _bound_dir()
    if d is None:
        return None
    from spgemm_tpu_torch.ops.symbolic import plan_from_arrays  # noqa: PLC0415 -- import cycle

    path = _plan_path(d, fingerprint)
    with ENGINE.phase("warm_load"):
        if not os.path.exists(path):
            _miss("plan_misses")
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                if not _check_envelope(z, path, "plan", fingerprint):
                    return None
                plan = plan_from_arrays(z, fingerprint=fingerprint)
        except Exception as e:  # noqa: BLE001 -- any unreadable entry is a counted cold path
            _note_corrupt(path, repr(e))
            return None
    _hit("plan_hits")
    return plan


# ------------------------------------------------------------ delta entries --
def _encode_src(prefix: str, src: tuple, payload: dict) -> bool:
    """An operand's provenance into the payload; False for opaque."""
    if src[0] == "digest":
        payload[f"{prefix}_kind"] = np.array("digest")
        payload[f"{prefix}_rows"] = np.asarray(src[1], np.int64)
        payload[f"{prefix}_digs"] = np.asarray(src[2], dtype="S32")
        return True
    if src[0] == "tag":
        payload[f"{prefix}_kind"] = np.array("tag")
        payload[f"{prefix}_tag_key"] = np.array(src[1])
        payload[f"{prefix}_tag_version"] = np.int64(src[2])
        return True
    return False


def _decode_src(prefix: str, z) -> tuple:
    kind = str(z[f"{prefix}_kind"])
    if kind == "digest":
        return ("digest", np.asarray(z[f"{prefix}_rows"], np.int64),
                np.asarray(z[f"{prefix}_digs"], dtype="S32"))
    if kind == "tag":
        return ("tag", str(z[f"{prefix}_tag_key"]), int(z[f"{prefix}_tag_version"]))
    raise ValueError(f"unknown provenance kind {kind!r}")


def save_delta(key: str, entry) -> bool:
    """Write one delta entry: its provenance and its result's slab, fetched
    from the card (the flush's one copy per changed entry)."""
    d = _bound_dir()
    if d is None:
        return False
    res = entry.result
    try:
        slab = res.slab.detach().cpu().numpy()
        meta = np.array([res.rows, res.cols, res.k], np.int64)
        coords = np.asarray(res.coords, np.int64)
        vb = res.val_bound
    except AttributeError:
        return False  # a result without a slab: nothing to keep
    payload = {
        "schema": np.int64(SCHEMA_VERSION), "kind": np.array("delta"),
        "ident": np.array(key), "knobs": np.array(_knob_sig()),
        "version": np.int64(entry.version), "out_rows": np.int64(entry.out_rows),
        "res_meta": meta, "res_coords": coords, "res_slab": slab,
        "res_val_bound": np.uint64(_VAL_BOUND_NONE if vb is None
                                   else min(vb, _VAL_BOUND_NONE - 1)),
    }
    if not (_encode_src("a", entry.a_src, payload) and _encode_src("b", entry.b_src, payload)):
        return False
    path = _delta_path(d, key)
    try:
        _atomic_savez(path, payload)
    except OSError as e:
        log.warning("warm delta save failed (%r); continuing", e)
        return False
    with _LOCK:
        _STATS["saved_deltas"] += 1
        _SAVED_DELTA[key] = entry.version
    return True


def load_delta(key: str) -> dict | None:
    """The delta entry stored for a key as host data, or None (a miss, or a
    counted corrupt entry): {"version", "out_rows", "a_src", "b_src",
    "result": {rows, cols, k, coords, slab, val_bound}}.  ops/spgemm puts
    the slab back on the card and seeds ops/delta."""
    d = _bound_dir()
    if d is None:
        return None
    path = _delta_path(d, key)
    with ENGINE.phase("warm_load"):
        if not os.path.exists(path):
            _miss("delta_misses")
            return None
        try:
            with np.load(path, allow_pickle=False) as z:
                if not _check_envelope(z, path, "delta", key):
                    return None
                rows, cols, k = (int(v) for v in z["res_meta"])
                coords = np.asarray(z["res_coords"], np.int64).reshape(-1, 2)
                slab = np.asarray(z["res_slab"], np.int64)
                if slab.shape != (len(coords) + 1, k, k):
                    raise ValueError(f"result slab {slab.shape} does not match its coords")
                vb = int(z["res_val_bound"])
                out = {"version": int(z["version"]), "out_rows": int(z["out_rows"]),
                       "a_src": _decode_src("a", z), "b_src": _decode_src("b", z),
                       "result": {"rows": rows, "cols": cols, "k": k, "coords": coords,
                                  "slab": slab,
                                  "val_bound": None if vb == _VAL_BOUND_NONE else vb}}
        except Exception as e:  # noqa: BLE001 -- any unreadable entry is a counted cold path
            _note_corrupt(path, repr(e))
            return None
    with _LOCK:
        _SAVED_DELTA[key] = out["version"]  # disk holds what was loaded
    _hit("delta_hits")
    return out


# -------------------------------------------------------------------- flush --
def flush() -> dict:
    """Write every plan and delta entry not on disk yet, then prune to the
    budget.  Cheap when nothing changed (plans by file, entries by
    version).  Never raises."""
    counts = {"plans": 0, "deltas": 0, "pruned": 0}
    try:
        if not active():
            return counts
        from spgemm_tpu_torch.ops import delta, plancache  # noqa: PLC0415 -- import cycle

        with ENGINE.phase("warm_flush"):
            for _, plan in plancache.entries():
                counts["plans"] += save_plan(plan)
            for key, entry in delta.entries():
                with _LOCK:
                    unchanged = _SAVED_DELTA.get(key) == entry.version
                if not unchanged:
                    counts["deltas"] += save_delta(key, entry)
            counts["pruned"] = _prune_budget()
    except Exception as e:  # noqa: BLE001 -- persistence never takes the engine down
        log.warning("warm flush failed midway (%r); every entry validates itself", e)
    return counts


def _prune_budget() -> int:
    """Remove the oldest entries past SPGEMM_TPU_WARM_MAX_MB."""
    with _LOCK:
        d = _DIR
    if d is None:
        return 0
    files = []
    for name in _listdir(d):
        if name.endswith(".npz") and not name.endswith(".tmp.npz"):
            path = os.path.join(d, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            files.append((st.st_mtime, st.st_size, path))
    total = sum(size for _, size, _ in files)
    budget = budget_bytes()
    pruned = 0
    for _, size, path in sorted(files):
        if total <= budget:
            break
        try:
            os.unlink(path)
        except OSError:
            continue
        total -= size
        pruned += 1
        with _LOCK:  # a pruned delta entry must be written again later
            for key in [k for k in _SAVED_DELTA if _delta_path(d, k) == path]:
                del _SAVED_DELTA[key]
    if pruned:
        with _LOCK:
            _STATS["pruned"] += pruned
        log.info("warm store pruned %d entries to fit %d bytes", pruned, budget)
    return pruned


# -------------------------------------------------------------------- stats --
def stats() -> dict:
    """The bound store's files and this process's counts."""
    with _LOCK:
        d = _DIR
        plans, deltas, size = _scan_dir(d) if d else (0, 0, 0)
        return {"dir": d, "enabled": enabled(), "active": _LOCK_FILE is not None,
                "disabled_reason": _DISABLED, "plans": plans, "deltas": deltas,
                "bytes": size, "budget_bytes": budget_bytes(), **_STATS}


def _held_elsewhere(path: str) -> bool:
    """True when another live process holds path's flock (this process's
    own binding does not count)."""
    with _LOCK:
        if _LOCK_FILE is not None and _DIR == path:
            return False
    lock_path = os.path.join(path, "lock")
    if not os.path.exists(lock_path):
        return False
    try:
        probe = open(lock_path, "a+")
    except OSError:
        return False
    try:
        return not _try_flock(probe)
    finally:
        probe.close()  # drops the probe's lock


def scan(path: str) -> dict:
    """A read-only view of any warm directory, without binding it: entry
    counts, bytes, and whether a live process holds it."""
    out = {"dir": path, "exists": os.path.isdir(path), "plans": 0, "deltas": 0,
           "bytes": 0, "locked": False, "budget_bytes": budget_bytes()}
    if out["exists"]:
        out["plans"], out["deltas"], out["bytes"] = _scan_dir(path)
        out["locked"] = _held_elsewhere(path)
    return out


def clear(path: str | None = None) -> int:
    """Delete every entry under `path` (default: the bound directory);
    refuses while another live process holds it.  Returns the count."""
    target = path if path is not None else directory()
    if target is None or not os.path.isdir(target):
        return 0
    if _held_elsewhere(target):
        raise RuntimeError(f"warm dir {target} is in use by a live process; stop it "
                           "before clearing")
    removed = 0
    for name in _listdir(target):
        if name.endswith(".npz"):
            try:
                os.unlink(os.path.join(target, name))
                removed += 1
            except OSError:
                pass
    with _LOCK:
        _SAVED_DELTA.clear()
    return removed


def clone(src: str, dst: str) -> dict:
    """Seed warm directory dst from src's entries.  src is read without a
    lock (entries land by rename, so none is torn); dst is refused while
    another live process holds it.  Each entry's envelope is checked
    (readable, this schema, kind matching its name) and one that fails is
    a counted skip; an entry dst already has is kept.  Identity and knob
    signature are checked where the entry is loaded.  Returns {"copied",
    "skipped", "skip_reasons"}."""
    if not os.path.isdir(src):
        raise RuntimeError(f"warm clone source {src} is not a directory")
    if os.path.abspath(src) == os.path.abspath(dst):
        raise RuntimeError("warm clone source and destination are the same directory")
    if os.path.isdir(dst):
        if _held_elsewhere(dst):
            raise RuntimeError(f"warm dir {dst} is in use by a live process; stop it "
                               "before seeding")
    else:
        os.makedirs(dst, exist_ok=True)
    copied = 0
    reasons: dict[str, int] = {}
    for name in sorted(_listdir(src)):
        if not name.endswith(".npz") or name.endswith(".tmp.npz"):
            continue
        prefix = name.split("-", 1)[0]
        reason = None
        if prefix not in ("plan", "delta"):
            reason = "unknown-kind"
        elif os.path.exists(os.path.join(dst, name)):
            reason = "exists"
        else:
            try:
                with np.load(os.path.join(src, name), allow_pickle=False) as z:
                    schema = int(z["schema"]) if "schema" in z.files else -1
                    if schema != SCHEMA_VERSION:
                        reason = "schema-skew"
                    elif str(z["kind"]) != prefix:
                        reason = "kind-mismatch"
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                reason = "unreadable"
        if reason is None:
            tmp = os.path.join(dst, f"{name}.{os.getpid()}.tmp.npz")
            try:
                shutil.copyfile(os.path.join(src, name), tmp)
                os.replace(tmp, os.path.join(dst, name))
                copied += 1
                continue
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                reason = "copy-failed"
        reasons[reason] = reasons.get(reason, 0) + 1
    log.info("warm clone %s -> %s: %d copied, skipped %s", src, dst, copied, reasons)
    return {"copied": copied, "skipped": sum(reasons.values()), "skip_reasons": reasons}
