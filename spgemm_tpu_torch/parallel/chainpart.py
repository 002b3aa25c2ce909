"""Chain partition and combine: `mpirun -np P` on one card (the port's copy
of the JAX package's `parallel/chainpart.py`).

The reference range-partitions the chain over P ranks
(sparse_matrix_mult.cu:438-456): rank r owns [r*q, (r+1)*q - 1] with
q = N // P, the last rank takes the remainder, and if q == 0 rank 0 does
everything alone (:612-666).  Each rank reduces its sub-chain with helper2,
rank 0 gathers the partials (:460-556) and reduces them with helper2 again
(:557-571).  The wrap-then-mod fold is not associative (SURVEY.md section
2.9), so the bytes at P differ from those at P = 1, and parity means the
reference's bytes at the same P: the partition arithmetic is an exact copy,
the q == 0 branch included.  The gather disappears; with the default
multiply each rank's partial stays on the card until the combine.
"""

from __future__ import annotations

import os

from spgemm_tpu_torch.chain import chain_product
from spgemm_tpu_torch.ops.spgemm import spgemm_device


def partition_chain(n: int, p: int) -> list[tuple[int, int] | None]:
    """Rank r -> its inclusive (start, end) in the chain, or None for an idle
    rank (sparse_matrix_mult.cu:438-456 and the :612 branch)."""
    q = n // p
    if q == 0:
        return [(0, n - 1)] + [None] * (p - 1)
    parts: list[tuple[int, int] | None] = []
    for r in range(p):
        start = r * q
        end = (r + 1) * q - 1 if r < p - 1 else n - 1
        parts.append((start, end))
    return parts


def chain_product_partitioned(matrices: list, num_parts: int, multiply=None,
                              checkpoint_dir: str | None = None, *, device="cuda",
                              keep_device: bool = False, **kwargs):
    """The chain product with `mpirun -np num_parts`'s partition and combine.

    Each rank's sub-chain goes through chain_product (its `multiplying i j`
    lines included), then the partials through chain_product again, the
    reference's rank-0 combine (:571).  multiply and kwargs (backend, folds,
    round_size, failover, resume) are forwarded to every chain_product.
    With the default multiply the rank partials stay on the card (a rank of
    one matrix uploads it).  With checkpoint_dir each rank snapshots into
    `rank<i>/` and the combine into `combine/`."""
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    on_card = multiply is None or multiply is spgemm_device

    def sub(name):
        return os.path.join(checkpoint_dir, name) if checkpoint_dir else None

    partials = [
        chain_product(matrices[start : end + 1], multiply=multiply, device=device,
                      checkpoint_dir=sub(f"rank{idx}"), keep_device=on_card, **kwargs)
        for idx, part in enumerate(partition_chain(len(matrices), num_parts))
        if part is not None
        for start, end in [part]
    ]
    # one partial (the q == 0 branch, or P = 1) needs no combine: no pass runs
    return chain_product(partials, multiply=multiply, device=device, keep_device=keep_device,
                         checkpoint_dir=sub("combine") if len(partials) > 1 else None,
                         **kwargs)
