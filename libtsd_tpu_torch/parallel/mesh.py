"""The ("chan", "time") device mesh of the port, single-controller.

Ported from ``libtsd_tpu/parallel/mesh.py``.  The sharding model is the
JAX package's:

* axis "chan": channels are embarrassingly parallel, the SDR analogue of
  data parallelism; no collective in steady state;
* axis "time": a long signal is cut into contiguous time blocks; a
  streaming filter needs the last K - 1 samples of the previous block,
  the overlap-save halo (``parallel.halo``).

JAX's ``shard_map`` is single-controller: one program sees a global array
over a mesh of devices.  The port keeps that shape.  A :class:`Mesh` is a
grid of ``torch.device``s; one process drives every shard of it, the
"collectives" are device-to-device copies and small sums ordered by that
process (``parallel.halo``).  Devices may repeat: ``make_mesh(chan=2,
time=4, devices=["cuda:0"] * 8)`` is 8 virtual shards on one card, as the
JAX tests use 8 virtual CPU devices, and ``devices=["cpu"] * 8`` is the
same mesh on the CPU.

``channel_sharding``, ``P`` and ``NamedSharding`` have no torch
counterpart.  In their place :func:`shard` cuts a global (C, N) tensor into
the grid of local tensors, each on its device, and :func:`gather` puts a
grid back together; the sharded functions take either form and return the
form they were given.

Across processes (``parallel.launch``): each process builds the mesh over
its own devices; ``chan`` and ``time`` are the GLOBAL axis sizes, the
processes lie along "chan" in rank order and each owns whole "time" rows.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch

from ..config import device as _device

__all__ = ["Mesh", "make_mesh", "shard", "gather"]


def on_device(dev: torch.device):
    """Context that makes ``dev`` current for launches (a CUDA device), or
    does nothing (the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _indexed(d) -> torch.device:
    """``d`` as a device with its index ("cuda" is the current card), so
    that equal devices compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        _device(d)                      # raises without a card
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A ("chan", "time") grid of devices.  ``devices[i][t]`` is the device
    of this process's chan row i (global row ``row0 + i``) and time shard
    t; ``shape`` holds the global axis sizes.  ``halo_buffers[i]`` holds
    kernel #11's receive slots of row i, made at first use and kept."""

    axis_names = ("chan", "time")

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 chan: int, time: int, row0: int = 0):
        self.devices = [[_indexed(d) for d in row] for row in devices]
        self.shape = {"chan": int(chan), "time": int(time)}
        self.row0 = int(row0)
        self.halo_buffers: dict = {}

    @property
    def local_rows(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, rows {self.row0}.."
                f"{self.row0 + self.local_rows - 1}, devices="
                f"{[[str(d) for d in r] for r in self.devices]})")


def _process() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(chan: Optional[int] = None, time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("chan", "time") mesh over this process's devices.

    devices: this process's devices, repeats allowed (virtual shards);
    None = every visible CUDA device (raises without a card).  If chan is
    None, every device goes on the channel axis.  In a process group of W
    processes the axes span W times as many devices, processes along
    "chan"; a "time" row that would cross processes raises
    NotImplementedError."""
    if devices is None:
        _device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    rank, world = _process()
    n_local = len(devices)
    n = n_local * world
    if time < 1 or time > n:
        raise ValueError(f"time={time} axis does not fit the {n} "
                         f"available devices")
    if chan is None:
        if n % time:
            raise ValueError(
                f"time={time} does not divide the {n} devices — pass "
                f"chan explicitly to use a subset deliberately")
        chan = n // time
    need = chan * time
    if need > n:
        raise ValueError(
            f"chan*time={need} exceeds device count ({n})")
    if world > 1 and n_local % time:
        raise NotImplementedError(
            f"time={time} would split a time row across processes "
            f"({n_local} devices each): the port's halo exchange runs "
            f"within one process (ROADMAP.md §1, slice 8 gaps: a 'time' "
            f"axis across processes)")
    rows_per_proc = n_local // time
    row0 = rank * rows_per_proc
    nrows = max(0, min(chan - row0, rows_per_proc))
    grid = [devices[i * time:(i + 1) * time] for i in range(nrows)]
    return Mesh(grid, chan, time, row0)


def _split(mesh: Mesh, n: int, axis: str) -> int:
    k = mesh.shape[axis] if axis == "time" else mesh.local_rows
    if k == 0 or n % k:
        raise ValueError(f"{n} does not split evenly over the {k} "
                         f"{axis!r} shards of this process")
    return n // k


def shard(mesh: Mesh, x: torch.Tensor) -> list:
    """Cut x (C, N), the channels of this process's rows, into the grid
    ``[[x_it]]`` of contiguous local tensors, x_it on device (i, t)."""
    if x.ndim != 2:
        raise ValueError(f"shard takes (C, N), got {tuple(x.shape)}")
    c = _split(mesh, x.shape[0], "chan")
    n = _split(mesh, x.shape[1], "time")
    return [[x[i * c:(i + 1) * c, t * n:(t + 1) * n].to(d).contiguous()
             for t, d in enumerate(row)]
            for i, row in enumerate(mesh.devices)]


def gather(mesh: Mesh, grid: list) -> torch.Tensor:
    """The grid's tensors put back into one (C, N) tensor on the device of
    shard (0, 0)."""
    dev = mesh.devices[0][0]
    return torch.cat([torch.cat([p.to(dev) for p in row], dim=-1)
                      for row in grid], dim=0)
