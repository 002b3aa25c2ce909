"""One chain a request: `chain_product(..., keep_device=True)` over the
configuration's leaves, their values drawn on the device."""

from __future__ import annotations

from portbench import leaves


def make(config: dict, mix: dict, device) -> leaves.Leaves:
    return leaves.Leaves.for_config(config, 1, device)


def call(inputs: leaves.Leaves, device, backend: str) -> list:
    from spgemm_tpu_torch.chain import chain_product
    out = chain_product(inputs.device_chains()[0], device=device, keep_device=True,
                        backend=backend)
    return [(out.coords, out.slab[:-1])]
