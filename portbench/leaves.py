"""A configuration's leaves: block coordinates on the host, built once from
the structure named in its file (structures/<kind>.py), and tile values
drawn on the device for each request from (--seed, request index).

Every seed does the same work: the structure is fixed by the configuration
(its own structure seed, where it has one), and the seed draws only the
values.  The values of one request are uniform 64-bit patterns, drawn in one
call on the device into one buffer that holds every leaf of every chain of
the request, each leaf followed by the all-zero sentinel tile the program's
device matrices end with.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

from portbench import roofline

INT64_MIN = -(1 << 63)


def structure(config: dict) -> list[np.ndarray]:
    """The chain's leaves' (n, 2) block coordinates, from
    structures/<kind>.py's build(params)."""
    params = config["structure"]
    mod = importlib.import_module(f"portbench.structures.{params['kind']}")
    return mod.build(params)


def request_seed(seed: int, request: int) -> int:
    """The generator seed of one request: a hash of (seed, request), so
    that any whole seed, however large, and any request index give a
    distinct stream."""
    ss = np.random.SeedSequence([seed & ((1 << 64) - 1), request & ((1 << 64) - 1)])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


@dataclass
class Leaves:
    """One request's leaves: `jobs` chains over the same coordinates, as
    tile slabs that are views of one device buffer."""

    coords: list
    k: int
    jobs: int
    buf: torch.Tensor
    dim: int = 0  # rows and cols of each leaf, in elements

    @classmethod
    def alloc(cls, coords: list, k: int, jobs: int, device, dim: int = 0) -> "Leaves":
        rows = jobs * sum(len(c) + 1 for c in coords)
        buf = torch.empty((rows, k, k), dtype=torch.int64, device=device)
        return cls(coords, k, jobs, buf, dim)

    @classmethod
    def for_config(cls, config: dict, jobs: int, device) -> "Leaves":
        """`jobs` chains over the configuration's structure (square leaves
        of `block_dim` block rows of k)."""
        k = int(config["structure"]["k"])
        return cls.alloc(structure(config), k, jobs, device,
                         int(config["structure"]["block_dim"]) * k)

    def slabs(self) -> list[list[torch.Tensor]]:
        """slabs()[job][leaf]: the (n + 1, k, k) slab, sentinel last."""
        out, at = [], 0
        for _ in range(self.jobs):
            chain = []
            for c in self.coords:
                chain.append(self.buf[at:at + len(c) + 1])
                at += len(c) + 1
            out.append(chain)
        return out

    def draw(self, seed: int, request: int) -> None:
        """Fill every tile from (seed, request); zero every sentinel."""
        g = torch.Generator(device=self.buf.device)
        g.manual_seed(request_seed(seed, request))
        self.buf.random_(INT64_MIN, None, generator=g)
        for chain in self.slabs():
            for slab in chain:
                slab[-1].zero_()

    def device_chains(self) -> list[list]:
        """The program's view: one list of DeviceBlockMatrix a chain, over
        the slabs (no copy)."""
        from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
        return [[DeviceBlockMatrix(rows=self.dim, cols=self.dim, k=self.k, coords=c, slab=s)
                 for c, s in zip(self.coords, slabs)] for slabs in self.slabs()]

    def work(self) -> roofline.Work:
        """The fold work of one chain over these leaves."""
        return roofline.chain_work(self.coords, self.k)

    def tiles(self, job: int) -> list[tuple]:
        """The reference's view of one chain: [(coords, tiles)] per leaf,
        without the sentinel."""
        return [(c, s[:-1]) for c, s in zip(self.coords, self.slabs()[job])]
