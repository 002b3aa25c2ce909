"""The comparison that decides `correct`: a request of the timed window,
drawn from the seed, against the plain reference run over the same leaves.

Exact arithmetic has exact limits: every number compared has the limit 0.

  bad_keys   keys in one result's coordinates and not the other's;
  bad_tiles  keys in both whose tiles differ in any bit;
  failed     requests of the window that raised.

The sample: reservoir sampling over the window's requests with a generator
seeded from --seed, so each completed request is the one checked with the
same chance, and only one request's results are held on the device.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

LIMITS = {"bad_keys": 0, "bad_tiles": 0, "failed": 0}
TILE_BLOCK = 1 << 15  # tiles compared at a time


class Reservoir:
    """Keeps one of the requests offered so far, each with equal chance."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng([seed & ((1 << 64) - 1), 0x5EED])
        self.offered = 0
        self.request = None
        self.results = None

    def offer(self, request: int, results) -> None:
        self.offered += 1
        if self._rng.integers(self.offered) == 0:
            self.request, self.results = request, results


def compare(got_coords: np.ndarray, got_tiles: torch.Tensor,
            want_coords: np.ndarray, want_tiles: torch.Tensor) -> dict:
    """{'bad_keys', 'bad_tiles'} of one result (tiles without the
    sentinel) against the reference's."""
    got_coords = np.asarray(got_coords, dtype=np.int64).reshape(-1, 2)
    want_coords = np.asarray(want_coords, dtype=np.int64).reshape(-1, 2)
    if got_coords.shape == want_coords.shape and np.array_equal(got_coords, want_coords):
        gi = wi = np.arange(len(want_coords))
        bad_keys = 0
    else:
        width = int(max(got_coords.max(initial=0), want_coords.max(initial=0))) + 1
        g = got_coords[:, 0] * width + got_coords[:, 1]
        w = want_coords[:, 0] * width + want_coords[:, 1]
        common, gi, wi = np.intersect1d(g, w, return_indices=True)
        bad_keys = len(g) + len(w) - 2 * len(common)
    bad_tiles = 0
    for lo in range(0, len(gi), TILE_BLOCK):
        a = got_tiles[torch.from_numpy(gi[lo:lo + TILE_BLOCK]).to(got_tiles.device)]
        b = want_tiles[torch.from_numpy(wi[lo:lo + TILE_BLOCK]).to(want_tiles.device)]
        bad_tiles += int((a != b.to(a.device)).flatten(1).any(dim=1).sum())
    return {"bad_keys": int(bad_keys), "bad_tiles": bad_tiles}


def judge(config: dict, leaves, results: list, failed: int) -> dict:
    """The numbers compared, summed over the sampled request's chains:
    each result (coords, tiles without the sentinel) against the reference
    named by the configuration, over the leaves of that request."""
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    numbers = {"bad_keys": 0, "bad_tiles": 0, "failed": failed}
    if results is None:
        numbers["bad_keys"] = numbers["bad_tiles"] = -1  # nothing to compare
        return numbers
    for job, (coords, tiles) in enumerate(results):
        want_coords, want_tiles = ref.chain_product(leaves.tiles(job))
        got = compare(coords, tiles, want_coords, want_tiles)
        del want_tiles
        numbers["bad_keys"] += got["bad_keys"]
        numbers["bad_tiles"] += got["bad_tiles"]
    return numbers


def passed(numbers: dict) -> bool:
    return all(0 <= numbers[name] <= limit for name, limit in LIMITS.items())


def lines(numbers: dict) -> list[str]:
    return [f"check {name} {numbers[name]} limit {limit}" for name, limit in LIMITS.items()]
