"""The device-pool slice table of spgemmd (the port's copy of the slice half
of the JAX package's `parallel/mesh.py`), for single-device slices.

Slice-spec grammar (`SPGEMM_TPU_SERVE_SLICES`), the JAX package's:

  spec     := "auto" | term ("+" term)*
  term     := [COUNT "x"] WIDTH ["*"]

`COUNTxWIDTH` is COUNT slices of WIDTH devices each, a bare `COUNT` is
COUNT single-device slices, and a trailing `*` marks the default slices.
`auto` is one single-device slice per visible device plus, with more than
one device, one full-mesh slice.

A slice wider than one device runs the output-sharded multiply
(parallel/rowshard in the JAX package), which the port does not have yet:
slice_pool raises SliceSpecError for one, naming that port, and never
serves a narrower slice in its place.  So with one visible card `1` and
`auto` give the one slice on cuda:0.  Pure Python: device positions, not
live devices.

Beside the slice table, the (dp, tp) training mesh of the block-sparse FFN
(TrainMesh, train_mesh): the port's counterpart of the
`jax.sharding.Mesh(devices.reshape(dp, tp), ("dp", "tp"))` that
spgemm_tpu/models/ffn.py:make_sharded_train_step takes, over
torch.distributed process groups.  It imports torch only when built, so the
daemon's import of this module stays free of torch.
"""

from __future__ import annotations

import re
from dataclasses import dataclass


class SliceSpecError(ValueError):
    """An unparsable, overcommitted or not yet served slice spec."""


@dataclass(frozen=True)
class DeviceSlice:
    """One named slice: device_ids are positions among the visible cards."""

    name: str
    index: int
    device_ids: tuple[int, ...]
    default: bool = False

    @property
    def width(self) -> int:
        return len(self.device_ids)


_TERM_RE = re.compile(r"^(?:(\d+)x)?(\d+)(\*)?$")


def parse_slice_spec(spec: str, n_devices: int | None = None) -> list[tuple[int, bool]]:
    """A slice spec as [(width, is_default), ...] in declaration order.
    `auto` needs n_devices; an explicit spec is checked against n_devices
    when it is known."""
    spec = (spec or "").strip()
    if not spec:
        raise SliceSpecError("empty slice spec (SPGEMM_TPU_SERVE_SLICES)")
    if spec == "auto":
        if n_devices is None:
            raise SliceSpecError("slice spec 'auto' needs the visible device count")
        out = [(1, True)] * n_devices
        if n_devices > 1:
            out.append((n_devices, False))
        return out
    widths: list[tuple[int, bool]] = []
    for term in spec.split("+"):
        m = _TERM_RE.match(term.strip())
        if m is None:
            raise SliceSpecError(
                f"bad slice-spec term {term.strip()!r} in "
                f"SPGEMM_TPU_SERVE_SLICES={spec!r} (grammar: [COUNTx]WIDTH"
                f"[*] terms joined by '+', or 'auto')")
        count_s, width_s, star = m.groups()
        if count_s is None:
            count, width = int(width_s), 1  # bare N = N single-device slices
        else:
            count, width = int(count_s), int(width_s)
        if count < 1 or width < 1:
            raise SliceSpecError(
                f"slice-spec term {term.strip()!r} must have count and "
                f"width >= 1 (SPGEMM_TPU_SERVE_SLICES={spec!r})")
        widths += [(width, star is not None)] * count
    total = sum(w for w, _ in widths)
    if n_devices is not None and total > n_devices:
        raise SliceSpecError(
            f"slice spec {spec!r} needs {total} devices but only "
            f"{n_devices} are visible")
    return widths


def slice_pool(spec: str | None = None, n_devices: int | None = None) -> list[DeviceSlice]:
    """The slice table of a spec (default: SPGEMM_TPU_SERVE_SLICES), devices
    assigned to terms in order; the default slices are the `*` term's, else
    the narrowest.  SliceSpecError for a slice wider than one device."""
    from spgemm_tpu_torch.utils import knobs  # noqa: PLC0415

    spec = (knobs.get("SPGEMM_TPU_SERVE_SLICES") if spec is None else spec).strip()
    # the width first, so a wide slice is named as such whatever the count
    wide = max(w for w, _ in parse_slice_spec(spec, n_devices if spec == "auto" else None))
    if wide > 1:
        raise SliceSpecError(
            f"slice spec {spec!r} asks for a {wide}-device slice; a slice wider "
            "than one device runs the output-sharded multiply, which waits for the port "
            "of parallel/rowshard.py")
    widths = parse_slice_spec(spec, n_devices)
    if spec == "auto":
        return [DeviceSlice(f"s{i}w1", i, (i,), default=True) for i in range(n_devices)]
    any_default = any(d for _, d in widths)
    return [DeviceSlice(f"s{i}w1", i, (i,), default=is_default if any_default else True)
            for i, (_, is_default) in enumerate(widths)]


def slice_device(sl: DeviceSlice, device_type: str) -> str:
    """The torch device a single-device slice runs on: `cuda:<position>`,
    or `cpu` for a daemon on the CPU."""
    if sl.width != 1:
        raise SliceSpecError(f"slice {sl.name} has {sl.width} devices; the port serves "
                             "single-device slices only")
    return "cpu" if device_type == "cpu" else f"{device_type}:{sl.device_ids[0]}"


@dataclass(frozen=True)
class TrainMesh:
    """One rank's view of a (dp, tp) training mesh.  Ranks are laid out as
    the JAX mesh's devices, row-major: rank = dp_index * tp + tp_index.
    dp_group holds the tp_index column (the ranks that share a weight
    shard), tp_group the dp_index row (the ranks that share a batch shard);
    each is None where its axis has one rank, and then no collective runs
    over it.  device is the torch device this rank computes on."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    device: object               # torch.device
    dp_group: object | None = None  # torch.distributed ProcessGroup
    tp_group: object | None = None

    @property
    def rank(self) -> int:
        return self.dp_index * self.tp + self.tp_index


def train_mesh(dp: int = 1, tp: int = 1, device="cuda") -> TrainMesh:
    """This rank's TrainMesh.  At 1 x 1 it needs no process group (the one
    card's case).  Wider, torch.distributed must already be initialised by
    the caller (init_process_group with its own address, world size and
    rank; gloo on the CPU, nccl on cards) with world size dp * tp; every
    rank calls this with the same dp and tp, since new_group is collective.
    device defaults to cuda (via ops/device.resolve_device: it raises
    without a card)."""
    from spgemm_tpu_torch.ops.device import resolve_device  # noqa: PLC0415 -- torch

    if dp < 1 or tp < 1:
        raise ValueError(f"a training mesh needs dp, tp >= 1, got ({dp}, {tp})")
    dev = resolve_device(device)
    if dp * tp == 1:
        return TrainMesh(1, 1, 0, 0, dev)
    import torch.distributed as dist  # noqa: PLC0415

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"a ({dp}, {tp}) training mesh needs torch.distributed "
                           "initialised (init_process_group) with world size "
                           f"{dp * tp}")
    if dist.get_world_size() != dp * tp:
        raise ValueError(f"a ({dp}, {tp}) training mesh needs world size {dp * tp}, "
                         f"not {dist.get_world_size()}")
    rank = dist.get_rank()
    dp_index, tp_index = divmod(rank, tp)
    tp_group = dp_group = None
    if tp > 1:  # every rank creates every group, in one order
        for d in range(dp):
            group = dist.new_group([d * tp + t for t in range(tp)])
            if d == dp_index:
                tp_group = group
    if dp > 1:
        for t in range(tp):
            group = dist.new_group([d * tp + t for d in range(dp)])
            if t == tp_index:
                dp_group = group
    return TrainMesh(dp, tp, dp_index, tp_index, dev, dp_group, tp_group)
