"""The fleet router's replicated price book (the port's copy of the JAX
package's `fleet/pricebook.py`).

Each spgemmd prices the chains it has read (serve/placement.note_mass, the
estimator's pair mass) and gossips its newest entries in every stats answer
(`placement.book`, at most placement.BOOK_GOSSIP_CAP).  The router's poll
merges those samples here, so a submit whose folder any backend has priced
is placed on a real estimate rather than as a first contact.

Keys are serve/placement.signature stat signatures (folder, file names,
sizes, mtimes): an edited input is priced anew, never on a stale mass.
Pricing steers placement only, never the bytes.  Imports the standard
library and serve/placement only.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from spgemm_tpu_torch.serve import placement

# merged-book capacity (LRU past it): one entry per distinct folder content
# across the fleet, the per-daemon book's scale
CAP = 4096


class PriceBook:
    """The router's merged (signature -> pair mass) book."""

    def __init__(self, cap: int = CAP):
        self._cap = cap
        self._lock = threading.Lock()
        self._book: "OrderedDict[str, float]" = OrderedDict()  # spgemm-lint: guarded-by(_lock)
        self._merged = 0  # spgemm-lint: guarded-by(_lock)
        self._hits = 0    # spgemm-lint: guarded-by(_lock)
        self._misses = 0  # spgemm-lint: guarded-by(_lock)

    def merge(self, placement_block) -> int:
        """Fold one backend's stats `placement` block in (the newest sighting
        wins); the number of entries taken.  A malformed block or entry
        contributes nothing: gossip is best effort, and placement falls back
        to round-robin."""
        book = placement_block.get("book") if isinstance(placement_block, dict) else None
        if not isinstance(book, dict):
            return 0
        taken = 0
        with self._lock:
            for sig, mass in book.items():
                if not isinstance(sig, str) or not isinstance(mass, (int, float)):
                    continue
                self._book[sig] = float(mass)
                self._book.move_to_end(sig)
                taken += 1
            while len(self._book) > self._cap:
                self._book.popitem(last=False)
            self._merged += taken
        return taken

    def lookup(self, folder: str) -> float | None:
        """The fleet's pair mass for the folder's current content, or None on
        first contact, after an edit, or when the folder cannot be read."""
        sig = placement.signature(folder)
        with self._lock:
            if sig is None or sig not in self._book:
                self._misses += 1
                return None
            self._book.move_to_end(sig)
            self._hits += 1
            return self._book[sig]

    def stats(self) -> dict:
        with self._lock:
            return {"book_entries": len(self._book), "book_hits": self._hits,
                    "book_misses": self._misses, "merged": self._merged}
