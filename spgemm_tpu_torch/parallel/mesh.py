"""The device-pool slice table of spgemmd and the device lists of the
output-sharded multiply (the port's copy of the JAX package's
`parallel/mesh.py`).

Slice-spec grammar (`SPGEMM_TPU_SERVE_SLICES`), the JAX package's:

  spec     := "auto" | term ("+" term)*
  term     := [COUNT "x"] WIDTH ["*"]

`COUNTxWIDTH` is COUNT slices of WIDTH devices each, a bare `COUNT` is
COUNT single-device slices, and a trailing `*` marks the default slices.
Devices are assigned to terms in declaration order (`1x4+4` on 8 devices:
one slice of devices 0-3, then singles on 4-7).  `auto` is one
single-device slice per visible device plus, with more than one device,
one full-mesh slice that overlaps the singles (spgemmd never dispatches to
two slices that share a device at once).  Without a `*`, the narrowest
width is the default.  A slice wider than one device runs the
output-sharded multiply (parallel/rowshard.py) over its devices.

Spec parsing is pure Python over device positions; slice_devices and
default_devices resolve positions into torch devices: `cuda:<i>` on cards,
and on the CPU every position is `cpu` (a CPU pool's width is how many
shards a multiply is cut into, not how many devices run them).  An
explicit spec is checked against the device count when it is known, and a
card position past the visible cards raises, as in the JAX package: with
one card, a spec that needs two devices is refused, never time-sliced.

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
    """An unparsable or overcommitted slice spec; names the spec."""


@dataclass(frozen=True)
class DeviceSlice:
    """One named slice: device_ids are positions among the visible devices."""

    name: str
    index: int
    device_ids: tuple[int, ...]
    default: bool = False

    @property
    def width(self) -> int:
        return len(self.device_ids)

    def overlaps(self, other: "DeviceSlice") -> bool:
        return bool(set(self.device_ids) & set(other.device_ids))


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
    """The slice table of a spec (default: SPGEMM_TPU_SERVE_SLICES): names
    `s{i}w{width}`, devices assigned to terms in declaration order; `auto`
    is the singles plus one overlapping full-mesh slice.  The default
    slices are the `*` term's, else the narrowest."""
    from spgemm_tpu_torch.utils import knobs  # noqa: PLC0415

    spec = (knobs.get("SPGEMM_TPU_SERVE_SLICES") if spec is None else spec).strip()
    if spec == "auto":
        if n_devices is None:
            raise SliceSpecError("slice spec 'auto' needs the visible device count")
        slices = [DeviceSlice(f"s{i}w1", i, (i,), default=True) for i in range(n_devices)]
        if n_devices > 1:
            slices.append(DeviceSlice(f"s{n_devices}w{n_devices}", n_devices,
                                      tuple(range(n_devices))))
        return slices
    widths = parse_slice_spec(spec, n_devices)
    any_default = any(d for _, d in widths)
    min_width = min(w for w, _ in widths)
    slices: list[DeviceSlice] = []
    pos = 0
    for i, (width, is_default) in enumerate(widths):
        slices.append(DeviceSlice(f"s{i}w{width}", i, tuple(range(pos, pos + width)),
                                  default=is_default if any_default else width == min_width))
        pos += width
    return slices


def slice_device_names(sl: DeviceSlice, device_type: str) -> list[str]:
    """The torch device names of a slice's positions, without importing
    torch: `cuda:<i>`, or `cpu` for every position on the CPU."""
    if device_type == "cpu":
        return ["cpu"] * sl.width
    return [f"{device_type}:{i}" for i in sl.device_ids]


def slice_devices(sl: DeviceSlice, device_type: str = "cuda") -> list:
    """The torch devices of a slice (positions -> devices).  On cards a
    position past the visible ones raises SliceSpecError, as the JAX
    package's does: a spec is never served on fewer devices than it
    names."""
    import torch  # noqa: PLC0415

    if device_type != "cpu":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if sl.device_ids and max(sl.device_ids) >= visible:
            raise SliceSpecError(
                f"slice {sl.name} needs device position {max(sl.device_ids)} "
                f"but only {visible} devices are visible")
    return [torch.device(name) for name in slice_device_names(sl, device_type)]


def default_devices(n: int | None = None, device_type: str = "cuda") -> list:
    """The first n visible devices (the port's default_mesh): all cards by
    default; on the CPU n entries of `cpu` (one by default)."""
    if device_type == "cpu":
        width = 1 if n is None else n
    else:
        import torch  # noqa: PLC0415

        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible == 0:
            raise RuntimeError("no CUDA device is visible; pass device_type='cpu' "
                               "(CLI: --device cpu) to run on the CPU")
        width = visible if n is None else n
    if width < 1:
        raise ValueError(f"a device list needs n >= 1, got {width}")
    return slice_devices(DeviceSlice("default", 0, tuple(range(width))), device_type)


def resolve_devices(devices=None) -> list:
    """torch devices for a sharded multiply's device list (names or
    devices; a device may repeat), default_devices() when None: every
    visible card.  A CUDA entry without a usable card raises, as does an
    empty list."""
    from spgemm_tpu_torch.ops.device import resolve_device  # noqa: PLC0415 -- imports torch

    devs = [resolve_device(d) for d in (default_devices() if devices is None else devices)]
    if not devs:
        raise ValueError("a sharded multiply needs at least one device")
    return devs


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
