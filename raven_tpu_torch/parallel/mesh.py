"""Device meshes for the single-host multi-device path.

The port of raven_tpu/parallel/mesh.py and the single-process half of
raven_tpu/parallel/distributed.py (make_data_shard_mesh).  A mesh is an
ordered set of torch devices laid out over named axes: 1-D ("shard",) or
2-D ("data", "shard"), row-major, as raven_tpu lays its devices out.  It is
single-controller, as raven_tpu's is: one Python process drives every
device of the mesh.  The exchanges between devices are tensor copies
(`.to(owner, non_blocking=True)`) and raven_tpu's psum is an integer sum
on the mesh's first device (`sum_on_first`).

`make_mesh` and `make_data_shard_mesh` take CUDA cards only.  A mesh whose
devices repeat (["cuda:0"] * 4, ["cpu"] * 8) is a *virtual* mesh, built
explicitly with `Mesh(...)`; tests and chip_smoke.py use one to drive the
sharded paths on one device.  `default_mesh` is what the engine and the
polisher take unasked: every card when the device is CUDA and more than
one card is visible, else none.
"""

from __future__ import annotations

import math

import torch


class Mesh:
    """Devices over named axes (see the module docstring)."""

    def __init__(self, devices, axis_names=("shard",), shape=None):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        axis_names = tuple(axis_names)
        shape = (len(devs),) if shape is None else tuple(int(s) for s in shape)
        if not devs or len(shape) != len(axis_names) or math.prod(shape) != len(devs):
            raise ValueError(
                f"a mesh of shape {shape} over axes {axis_names} cannot hold "
                f"{len(devs)} devices"
            )
        self.devices = tuple(devs)
        self.axis_names = axis_names
        self.shape = shape

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        return self.devices[0]

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names, self.shape))
        return f"Mesh({axes}; {', '.join(str(d) for d in self.devices)})"


def _cards(need: int) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need or need < 1:
        raise ValueError(f"need {need} CUDA devices, have {have}")
    return [torch.device("cuda", i) for i in range(need)]


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    """1-D mesh over the first `n_devices` CUDA cards (all of them by
    default); raises when there are fewer."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return Mesh(_cards(n_devices), (axis,))


def make_data_shard_mesh(n_data: int, n_shard: int) -> Mesh:
    """("data", "shard") mesh over the first n_data * n_shard CUDA cards;
    raises when there are fewer."""
    return Mesh(_cards(n_data * n_shard), ("data", "shard"), (n_data, n_shard))


def default_mesh(device: torch.device) -> Mesh | None:
    """Every card when `device` is CUDA and more than one card is visible
    (raven_tpu's automatic multi-device path), else None."""
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


def split_rows(n_rows: int, n_devices: int) -> list[slice]:
    """Contiguous blocks of `n_rows` rows, one a device (the order
    PartitionSpec(axis) deals them); n_rows must be a multiple of
    n_devices."""
    if n_rows % n_devices:
        raise ValueError(f"{n_rows} rows do not split over {n_devices} devices")
    per = n_rows // n_devices
    return [slice(d * per, (d + 1) * per) for d in range(n_devices)]


def sum_on_first(per_device, device: torch.device):
    """raven_tpu's psum: the element-wise sum of every device's tuple of
    tensors, on `device`, in the dtype they carry (the first tuple's
    tensors are summed into)."""
    per_device = iter(per_device)
    total = tuple(t.to(device) for t in next(per_device))
    for tables in per_device:
        for acc, t in zip(total, tables):
            acc += t.to(device, non_blocking=device.type == "cuda")
    return total
