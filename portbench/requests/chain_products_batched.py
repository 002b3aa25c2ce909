"""`chains_per_request` chains of one structure a request, through
`chain_products_batched`: one plan a multiply and one launch a round for
all of them, as a value sweep is batched."""

from __future__ import annotations

from portbench import leaves


def make(config: dict, mix: dict, device) -> leaves.Leaves:
    return leaves.Leaves.for_config(config, int(mix["chains_per_request"]), device)


def call(inputs: leaves.Leaves, device, backend: str) -> list:
    from spgemm_tpu_torch.chain import chain_products_batched
    outs = chain_products_batched(inputs.device_chains(), backend=backend)
    return [(m.coords, m.slab[:-1]) for m in outs]
