"""Estimator-priced job placement for spgemmd, and the autotuner's class book
(the port's copy of the JAX package's `serve/placement.py`).

At admission (`route`, cheap: stat calls only) a job's input folder is
looked up by its stat signature (file names, sizes, mtimes).  A hit prices
the job with the pair mass recorded before; a miss classifies by the
matrix files' bytes (a monotone proxy of the tile count) and otherwise
sends the job to the default slice.  The executor records the price
(`note_mass`) once it has read the chain: ops/estimate.chain_mass, the
predicted tile pairs of the first reduction pass.

With the port's single slice every class lands on the same card; the
record still rides each job's status, and the book feeds the multi-slice
pool when it is ported.  `stats()` gossips the book's newest entries
(`book`, at most BOOK_GOSSIP_CAP), which the fleet router merges into its
replicated price book (fleet/pricebook.py) to place submits across
daemons.  Pricing steers placement only, never the bytes.

The class book maps an autotuner structure class (ops/plancache.
tune_class_key) to a representative folder: the newest folder a job of the
class ran (`note_class`, the executor's terminal path), which the tuner's idle
trial legs replay (`rep_folder`).  Imports the standard library only.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict

# a job whose predicted pair mass reaches LARGE_MASS_PAIRS is large; a first
# contact whose matrix files reach LARGE_INPUT_BYTES is taken to be large
LARGE_MASS_PAIRS = 1e6
LARGE_INPUT_BYTES = 64 << 20

# price-book capacity (LRU past it)
BOOK_CAP = 4096

# the newest book entries stats() gossips to a fleet router: a bound that
# keeps a stats answer a small wire line with a full book
BOOK_GOSSIP_CAP = 64

_LOCK = threading.Lock()
_BOOK: "OrderedDict[str, float]" = OrderedDict()  # spgemm-lint: guarded-by(_LOCK)
# tune class -> representative folder, the same LRU discipline
_CLASS_BOOK: "OrderedDict[str, str]" = OrderedDict()  # spgemm-lint: guarded-by(_LOCK)
_STATS = {"book_hits": 0, "book_misses": 0, "routed": {}}  # spgemm-lint: guarded-by(_LOCK)


def signature(folder: str) -> str | None:
    """Stat signature of a chain folder (the `size` file and the matrix
    files: names, byte sizes, mtimes), the book's key; None when the
    folder cannot be read."""
    try:
        names = sorted(n for n in os.listdir(folder) if n == "size" or n.startswith("matrix"))
        h = hashlib.sha256(folder.encode())
        for n in names:
            st = os.stat(os.path.join(folder, n))
            h.update(f"{n}:{st.st_size}:{st.st_mtime_ns}|".encode())
        return h.hexdigest()
    except OSError:
        return None


def input_bytes(folder: str) -> int:
    """Bytes of the folder's matrix files; 0 when it cannot be read."""
    total = 0
    try:
        for n in os.listdir(folder):
            if n.startswith("matrix"):
                total += os.path.getsize(os.path.join(folder, n))
    except OSError:
        return 0
    return total


def note_mass(folder: str, mass: float) -> None:
    """Record the pair mass of the folder's current content."""
    sig = signature(folder)
    if sig is None:
        return
    with _LOCK:
        _BOOK[sig] = float(mass)
        _BOOK.move_to_end(sig)
        while len(_BOOK) > BOOK_CAP:
            _BOOK.popitem(last=False)


def lookup_mass(folder: str) -> float | None:
    """The recorded pair mass of the folder's current content, or None on
    first contact or after the content changed."""
    sig = signature(folder)
    with _LOCK:
        if sig is None or sig not in _BOOK:
            _STATS["book_misses"] += 1
            return None
        _BOOK.move_to_end(sig)
        _STATS["book_hits"] += 1
        return _BOOK[sig]


def note_class(class_key: str | None, folder: str) -> None:
    """Record the folder as the class's representative (the newest sighting
    wins: any folder of a class has its structure)."""
    if class_key is None:
        return
    with _LOCK:
        _CLASS_BOOK[class_key] = folder
        _CLASS_BOOK.move_to_end(class_key)
        while len(_CLASS_BOOK) > BOOK_CAP:
            _CLASS_BOOK.popitem(last=False)


def rep_folder(class_key: str) -> str | None:
    """The class's representative folder, or None: never seen, evicted, or
    the folder is gone (checked here, so a deleted input never reaches a
    trial leg; the stale entry is dropped)."""
    with _LOCK:
        folder = _CLASS_BOOK.get(class_key)
    if folder is not None and not os.path.isdir(folder):
        with _LOCK:
            if _CLASS_BOOK.get(class_key) == folder:
                del _CLASS_BOOK[class_key]
        return None
    return folder


def route(folder: str) -> dict:
    """The admission-time placement record: `class` small|large|default and
    where the price came from."""
    mass = lookup_mass(folder)
    if mass is not None:
        cls = "large" if mass >= LARGE_MASS_PAIRS else "small"
        source = "estimate"
    else:
        nbytes = input_bytes(folder)
        if nbytes >= LARGE_INPUT_BYTES:
            cls, source = "large", "bytes"
            mass = float(nbytes)
        else:
            cls, source = "default", "none"
    with _LOCK:
        _STATS["routed"][cls] = _STATS["routed"].get(cls, 0) + 1
    return {"class": cls, "source": source, **({"mass": mass} if mass is not None else {})}


def stats() -> dict:
    """The book's size and hit counts, the routing histogram, and the gossip
    sample `book`: the newest (most recently used) BOOK_GOSSIP_CAP
    signatures and their masses."""
    with _LOCK:
        newest = list(_BOOK.items())[-BOOK_GOSSIP_CAP:]
        return {"book_entries": len(_BOOK), "book_hits": _STATS["book_hits"],
                "book_misses": _STATS["book_misses"], "routed": dict(_STATS["routed"]),
                "large_mass_pairs": LARGE_MASS_PAIRS, "large_input_bytes": LARGE_INPUT_BYTES,
                "book": dict(newest)}


def clear() -> None:
    """Drop the books and zero the counts."""
    with _LOCK:
        _BOOK.clear()
        _CLASS_BOOK.clear()
        _STATS["book_hits"] = _STATS["book_misses"] = 0
        _STATS["routed"].clear()
