"""The multi-process path: its process group and the collectives it shares.

The port of raven_tpu/parallel/distributed.py (jax.distributed and the
multi-host ("data", "shard") mesh) onto torch.distributed.  raven_tpu's
processes become the ranks of one process group.  Each rank holds the
whole readset and runs the host phases itself, replicated, as raven_tpu's
SPMD processes do; the device work is dealt over the devices of every rank
(a Mesh whose devices belong to ranks, parallel/mesh.py), and whatever the
host reads is made the same on every rank by three collectives:

  exchange            raven_tpu's all_to_all: variable-size columns, the
                      counts per destination first (all_to_all_single of
                      int64 counts), then one all_to_all_single a column
                      with input_split_sizes and output_split_sizes;
  all_gather_columns  variable-size rows onto every rank, in rank order:
                      the counts gathered, the rows padded to the largest,
                      gathered, trimmed and concatenated;
  all_reduce_sum      raven_tpu's psum of integer tables.

NCCL runs them between cards (one card a rank: NCCL refuses two ranks on
one card); gloo runs them on the CPU, and on CUDA tensors too.  A bool
column travels as uint8 (NCCL has no bool) and comes back as bool.  With
no group (None: a single-process mesh) each is the identity.  The
collectives run with async_op=False: under NCCL, which works on a stream
of its own, that makes the current stream wait for them, so a host read
that follows on it (the counts that size the next buffers, `.tolist()`,
`.cpu()`) sees their result; nothing else synchronises the device.

The group is the process's own state, as torch.distributed's is: one
`initialize_distributed` a process, `shutdown` to leave.  The port reads
no environment variable: the address comes as an argument (raven_tpu reads
RAVEN_TPU_COORDINATOR).
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from raven_tpu_torch.device import resolve_device
from raven_tpu_torch.parallel.mesh import Mesh

# this process's share of the collectives since the counts were last set
# to 0: calls, and the bytes it handed to them
COLLECTIVES = {"calls": 0, "bytes": 0}


@dataclasses.dataclass(frozen=True)
class World:
    """The process group this process joined: its address, size, this
    process's rank, backend and device, and every rank's device in rank
    order."""

    init_method: str
    size: int
    rank: int
    backend: str
    device: torch.device
    devices: tuple


_WORLD: World | None = None


def world() -> World | None:
    """The group initialize_distributed joined, or None."""
    return _WORLD


def initialize_distributed(init_method: str | None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None,
                           device=None, timeout_s: float = 600.0) -> World | None:
    """Join the process group at `init_method` (a torch URL,
    tcp://127.0.0.1:PORT or file:///path) as rank `process_id` of
    `num_processes`, on `device` (CUDA by default; raises without a card).

    None is a no-op, as raven_tpu's is without a coordinator.  The backend
    defaults to NCCL on a CUDA device, which binds the rank to its card,
    and gloo on the CPU.  A second call with the same world returns it; a
    call with another world raises.  Every collective of the group gives
    up after `timeout_s` seconds."""
    global _WORLD
    if init_method is None:
        return None
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    num_processes, process_id = int(num_processes), int(process_id)
    asked = (init_method, num_processes, process_id, backend, device)
    if _WORLD is not None:
        have = (_WORLD.init_method, _WORLD.size, _WORLD.rank, _WORLD.backend, _WORLD.device)
        if have == asked:
            return _WORLD
        raise RuntimeError(
            f"this process is rank {_WORLD.rank} of {_WORLD.size} at "
            f"{_WORLD.init_method} ({_WORLD.backend}, {_WORLD.device}); it cannot "
            f"join another world (rank {process_id} of {num_processes} at "
            f"{init_method}, {backend}, {device})"
        )
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is initialized outside initialize_distributed")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} is outside a world of {num_processes}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"NCCL runs on CUDA devices, not {device}")
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s), **kwargs,
    )
    names = [None] * num_processes
    dist.all_gather_object(names, str(device))
    _WORLD = World(init_method, num_processes, process_id, backend, device,
                   tuple(torch.device(n) for n in names))
    return _WORLD


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    global _WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD = None


def process_mesh(local_devices, axis_names=("shard",), shape=None) -> Mesh:
    """A mesh over every rank's `local_devices` (each rank passes its own;
    repeated devices make a virtual mesh, ["cpu"] * 4 or ["cuda:0"] * 2 a
    rank), in rank order.  A collective: every rank calls it."""
    w = _WORLD
    if w is None:
        raise RuntimeError("no process group: call initialize_distributed first")
    mine = [str(resolve_device(d)) for d in local_devices]
    if not mine:
        raise ValueError("a rank of a mesh needs at least one device")
    names = [None] * w.size
    dist.all_gather_object(names, mine)
    devices = [torch.device(d) for per in names for d in per]
    owners = [r for r, per in enumerate(names) for _ in per]
    shape = (len(devices),) if shape is None else shape
    return Mesh(devices, axis_names, shape, owners=owners, group=dist.group.WORLD,
                rank=w.rank)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """`t` as the collectives carry it: contiguous, bool as uint8."""
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def exchange(columns, splits, group):
    """raven_tpu's all_to_all for variable-size columns.  `columns` are
    tensors of one row count on one device, their rows in destination-rank
    order, `splits[r]` of them for rank r (zero is fine).  Returns (the
    columns received, in source-rank order, each in its own dtype; the
    rows from each rank)."""
    dev = columns[0].device
    size = 1 if group is None else dist.get_world_size(group)
    if len(splits) != size or sum(splits) != columns[0].shape[0]:
        raise ValueError(f"splits {list(splits)} do not cut {columns[0].shape[0]} rows "
                         f"over {size} ranks")
    if group is None:
        return tuple(columns), [int(splits[0])]
    COLLECTIVES["calls"] += 1
    send = torch.tensor([int(s) for s in splits], dtype=torch.int64, device=dev)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    got = recv.tolist()  # sizes the buffers below
    out = []
    for c in columns:
        w = _wire(c)
        r = torch.empty((sum(got), *w.shape[1:]), dtype=w.dtype, device=dev)
        dist.all_to_all_single(r, w, output_split_sizes=got,
                               input_split_sizes=[int(s) for s in splits], group=group)
        COLLECTIVES["bytes"] += w.numel() * w.element_size()
        out.append(r.to(torch.bool) if c.dtype == torch.bool else r)
    return tuple(out), got


def all_gather_columns(columns, group):
    """Every rank's `columns` (tensors of one row count on one device) on
    every rank, concatenated in rank order; returns (the columns, each in
    its own dtype; the rows from each rank)."""
    if group is None:
        return tuple(columns), [columns[0].shape[0]]
    dev = columns[0].device
    size = dist.get_world_size(group)
    COLLECTIVES["calls"] += 1
    n = torch.tensor([columns[0].shape[0]], dtype=torch.int64, device=dev)
    counts = [torch.empty_like(n) for _ in range(size)]
    dist.all_gather(counts, n, group=group)
    counts = torch.cat(counts).tolist()
    rows = max(max(counts), 1)  # no collective of zero elements
    out = []
    for c in columns:
        w = _wire(c)
        pad = torch.zeros((rows, *w.shape[1:]), dtype=w.dtype, device=dev)
        pad[: w.shape[0]] = w
        bufs = [torch.empty_like(pad) for _ in range(size)]
        dist.all_gather(bufs, pad, group=group)
        COLLECTIVES["bytes"] += pad.numel() * pad.element_size()
        cat = torch.cat([b[:k] for b, k in zip(bufs, counts)])
        out.append(cat.to(torch.bool) if c.dtype == torch.bool else cat)
    return tuple(out), counts


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """raven_tpu's psum: `t` (an integer tensor) summed over the ranks, in
    place; returns it."""
    if t.dtype == torch.bool or t.is_floating_point():
        raise TypeError(f"all_reduce_sum sums integer tensors, not {t.dtype}")
    if group is None:
        return t
    COLLECTIVES["calls"] += 1
    w = t if t.is_contiguous() else t.contiguous()
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    COLLECTIVES["bytes"] += w.numel() * w.element_size()
    if w is not t:
        t.copy_(w)
    return t
