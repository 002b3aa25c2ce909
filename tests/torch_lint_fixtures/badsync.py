"""BLK fixture (torch idiom): the card's and the process group's blocking
calls under a registered lock.  A host sync waits for every launch queued
on the card, and a collective or a store wait for the slowest rank: a lock
held across one stalls every thread contending for it.  Never imported.
NOT part of the package -- linted by tests/test_torch_lint.py only.
"""

import threading

import torch
import torch.distributed as dist

_LOCK = threading.Lock()


def sync_under_lock():
    with _LOCK:
        torch.cuda.synchronize()  # BLK: host sync under the lock


def stream_sync_under_lock(stream):
    with _LOCK:
        stream.synchronize()  # BLK: a stream's sync under the lock


def gather_under_lock(out, t):
    with _LOCK:
        dist.all_gather(out, t)  # BLK: a collective under the lock


def store_wait_under_lock(store):
    with _LOCK:
        return store.get("ready")  # BLK: a rendezvous store's wait


def legal_sync_outside():
    torch.cuda.synchronize()  # legal: nothing held
    with _LOCK:
        cached = {}.get("x")  # legal: a dict's get, not a store's
    return cached
