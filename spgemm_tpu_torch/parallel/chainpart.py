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

from spgemm_tpu_torch.chain import _host_multiply, _to_host, chain_product
from spgemm_tpu_torch.ops.device import DeviceBlockMatrix
from spgemm_tpu_torch.ops.spgemm import spgemm_device
from spgemm_tpu_torch.parallel.mesh import resolve_devices


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
                              devices=None, keep_device: bool = False, **kwargs):
    """The chain product with `mpirun -np num_parts`'s partition and combine.

    Each rank's sub-chain goes through chain_product (its `multiplying i j`
    lines included), then the partials through chain_product again, the
    reference's rank-0 combine (:571).  multiply and kwargs (backend, folds,
    round_size, failover, resume) are forwarded to every chain_product.
    With checkpoint_dir each rank snapshots into `rank<i>/` and the combine
    into `combine/`; every pass then fetches its partials, so on a card the
    ranks run one after another.

    devices: rank r reduces on devices[r % len(devices)] (a device may
    repeat) and the combine runs on devices[0], the partials' tiles moved
    there; without it every rank and the combine run on `device`.  With the
    default multiply the rank partials stay on their devices (a rank of one
    matrix uploads it).  A rank that failed over to the host oracle
    (failover=True) returns a host partial instead: the combine then runs
    on the backend's host oracle too, as the card cannot be trusted."""
    if num_parts < 1:
        raise ValueError(f"num_parts must be >= 1, got {num_parts}")
    on_card = multiply is None or multiply is spgemm_device
    devs = [device] if devices is None else resolve_devices(devices)

    def sub(name):
        return os.path.join(checkpoint_dir, name) if checkpoint_dir else None

    partials = [
        chain_product(matrices[start : end + 1], multiply=multiply, device=devs[idx % len(devs)],
                      checkpoint_dir=sub(f"rank{idx}"), keep_device=on_card, **kwargs)
        for idx, part in enumerate(partition_chain(len(matrices), num_parts))
        if part is not None
        for start, end in [part]
    ]
    combine = sub("combine") if len(partials) > 1 else None
    if on_card and not all(isinstance(m, DeviceBlockMatrix) for m in partials):
        backend = kwargs.get("backend", "exact")
        return chain_product([_to_host(m) for m in partials], multiply=_host_multiply(backend),
                             backend=backend, checkpoint_dir=combine)
    if on_card and devices is not None:
        # the partials' tiles converge on devices[0]; coords stay on the host
        partials = [DeviceBlockMatrix(rows=m.rows, cols=m.cols, k=m.k, coords=m.coords,
                                      slab=m.slab.to(devs[0]), val_bound=m.val_bound)
                    for m in partials]
    # one partial (the q == 0 branch, or P = 1) needs no combine: no pass runs
    return chain_product(partials, multiply=multiply, device=devs[0], keep_device=keep_device,
                         checkpoint_dir=combine, **kwargs)


def chain_product_on_devices(matrices: list, devices=None, num_parts: int | None = None,
                             **kwargs):
    """chain_product_partitioned with each rank's sub-chain on its own device
    (default every visible card), the JAX package's name for it.

    num_parts: P (default len(devices)); parity with the reference needs its
    P, so an explicit P cycles the ranks over the devices, and idle ranks
    (N < P, the :612 branch) get no work.  kwargs go to
    chain_product_partitioned.  Returns the host result."""
    devs = resolve_devices(devices)
    return chain_product_partitioned(matrices, num_parts or len(devs), devices=devs, **kwargs)
