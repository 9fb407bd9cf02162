"""Device meshes for the multi-device and the multi-process paths.

The port of raven_tpu/parallel/mesh.py and of the mesh half of
raven_tpu/parallel/distributed.py (make_data_shard_mesh).  A mesh is an
ordered set of torch devices laid out over named axes: 1-D ("shard",) or
2-D ("data", "shard"), row-major, as raven_tpu lays its devices out.

Without a process group a mesh is single-controller, as raven_tpu's
single-host mesh is: one Python process drives every device of it, the
exchanges between devices are tensor copies (`.to(owner,
non_blocking=True)`) and raven_tpu's psum is an integer sum on the mesh's
first device (`sum_on_first`).

With a process group (parallel/distributed.py) every device belongs to a
rank (`owners`, in rank order), as a global jax mesh's devices belong to
processes: each rank drives only its own devices (`local_indices`), the
exchanges go through the group's collectives and the psum is the local
sum all-reduced, so every rank holds the totals.  Such a mesh goes
through the collectives even at world size 1.

`make_mesh` and `make_data_shard_mesh` take CUDA cards only, or once
`initialize_distributed` has run, the global mesh: each rank's own device
in rank order.  A mesh whose devices repeat (["cuda:0"] * 4, ["cpu"] * 8)
is a *virtual* mesh, built explicitly with `Mesh(...)` or, across
processes, `distributed.process_mesh(...)`; tests and chip_smoke.py use
one to drive the sharded paths on one device.  `default_mesh` is what the
engine and the polisher take unasked: the global mesh when it spans two
or more devices, else every card when the device is CUDA and more than
one card is visible, else none.
"""

from __future__ import annotations

import math

import torch


class Mesh:
    """Devices over named axes (see the module docstring).  `owners` holds
    the rank that drives each device, in rank order (all 0 without a
    process group); `group` is the torch.distributed group of those ranks
    or None."""

    def __init__(self, devices, axis_names=("shard",), shape=None, owners=None,
                 group=None, rank: int = 0):
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
        owners = (0,) * len(devs) if owners is None else tuple(int(o) for o in owners)
        if len(owners) != len(devs) or list(owners) != sorted(owners):
            raise ValueError(f"device owners {owners} are not in rank order")
        if sorted(set(owners)) != list(range(max(owners) + 1)) or rank not in owners:
            raise ValueError(f"ranks 0-{max(owners)} must each own a device (owners "
                             f"{owners}, rank {rank})")
        self.devices = tuple(devs)
        self.axis_names = axis_names
        self.shape = shape
        self.owners = owners
        self.group = group
        self.rank = rank
        # this process's devices, by their index in the mesh
        self.local_indices = tuple(i for i, o in enumerate(owners) if o == rank)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def n_ranks(self) -> int:
        return self.owners[-1] + 1

    @property
    def first(self) -> torch.device:
        """This process's first device (the mesh's first without a group):
        where its sums, merged matches and consensus tables live."""
        return self.devices[self.local_indices[0]]

    def rank_indices(self, rank: int) -> range:
        """The mesh indices of `rank`'s devices (contiguous: rank order)."""
        lo = self.owners.index(rank)
        return range(lo, lo + self.owners.count(rank))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in zip(self.axis_names, self.shape))
        if self.group is None:
            return f"Mesh({axes}; {', '.join(str(d) for d in self.devices)})"
        devs = ", ".join(f"{d}@rank{o}" for d, o in zip(self.devices, self.owners))
        return f"Mesh({axes}; {devs}; rank {self.rank})"


def _cards(need: int) -> list[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need or need < 1:
        raise ValueError(f"need {need} CUDA devices, have {have}")
    return [torch.device("cuda", i) for i in range(need)]


def _global(axis_names, shape, need: int | None) -> Mesh | None:
    """The mesh over every rank's own device once initialize_distributed
    has run (None before): raven_tpu's jax.devices() is global then."""
    from raven_tpu_torch.parallel import distributed

    world = distributed.world()
    if world is None:
        return None
    if need is not None and need != len(world.devices):
        raise ValueError(
            f"the process group holds {len(world.devices)} devices, not {need}"
        )
    shape = (len(world.devices),) if shape is None else shape
    return Mesh(world.devices, axis_names, shape, owners=range(world.size),
                group=torch.distributed.group.WORLD, rank=world.rank)


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    """1-D mesh over every rank's device once a process group is up, else
    over the first `n_devices` CUDA cards (all of them by default);
    raises when the count differs from the group's or exceeds the cards."""
    mesh = _global((axis,), None, n_devices)
    if mesh is not None:
        return mesh
    if n_devices is None:
        n_devices = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return Mesh(_cards(n_devices), (axis,))


def make_data_shard_mesh(n_data: int, n_shard: int) -> Mesh:
    """("data", "shard") mesh over every rank's device (row-major, in rank
    order) once a process group is up, else over the first n_data *
    n_shard CUDA cards; raises when the counts do not fit."""
    mesh = _global(("data", "shard"), (n_data, n_shard), n_data * n_shard)
    if mesh is not None:
        return mesh
    return Mesh(_cards(n_data * n_shard), ("data", "shard"), (n_data, n_shard))


def default_mesh(device: torch.device) -> Mesh | None:
    """The global mesh when a process group is up and spans two or more
    devices; else every card when `device` is CUDA and more than one card
    is visible (raven_tpu's automatic multi-device path); else None."""
    mesh = _global(("shard",), None, None)
    if mesh is not None:
        return mesh if mesh.size > 1 else None
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return make_mesh()
    return None


def chosen_mesh(forced, device: torch.device) -> Mesh | None:
    """The mesh a MESH class attribute asks for: None takes
    default_mesh(device), False refuses any mesh (raven_tpu's
    RAVEN_TPU_SHARDED_MAP=0 and RAVEN_TPU_SHARDED_POLISH=0), a Mesh forces
    itself (their value 1)."""
    if forced is None:
        return default_mesh(device)
    return None if forced is False else forced


def split_rows(n_rows: int, n_devices: int) -> list[slice]:
    """Contiguous blocks of `n_rows` rows, one a device (the order
    PartitionSpec(axis) deals them); n_rows must be a multiple of
    n_devices."""
    if n_rows % n_devices:
        raise ValueError(f"{n_rows} rows do not split over {n_devices} devices")
    per = n_rows // n_devices
    return [slice(d * per, (d + 1) * per) for d in range(n_devices)]


def local_blocks(mesh: Mesh, n_rows: int) -> list[tuple[torch.device, slice]]:
    """This process's (device, rows) of `n_rows` rows dealt over the whole
    mesh by split_rows."""
    blocks = split_rows(n_rows, mesh.size)
    return [(mesh.devices[i], blocks[i]) for i in mesh.local_indices]


def sum_on_first(per_device, device: torch.device, group=None):
    """raven_tpu's psum: the element-wise sum of every device's tuple of
    tensors, on `device`, in the dtype they carry (the first tuple's
    tensors are summed into).  With a process group the local sums are
    all-reduced, so every rank gets the totals."""
    per_device = iter(per_device)
    total = tuple(t.to(device) for t in next(per_device))
    for tables in per_device:
        for acc, t in zip(total, tables):
            acc += t.to(device, non_blocking=device.type == "cuda")
    if group is not None:
        from raven_tpu_torch.parallel.distributed import all_reduce_sum

        for t in total:
            all_reduce_sum(t, group)
    return total
