"""The ("chan", "time") device mesh of the port, in one process or many.

Ported from ``libtsd_tpu/parallel/mesh.py``.  The sharding model is the
JAX package's:

* axis "chan": channels are embarrassingly parallel, the SDR analogue of
  data parallelism; no collective in steady state;
* axis "time": a long signal is cut into contiguous time blocks; a
  streaming filter needs the last K - 1 samples of the previous block,
  the overlap-save halo (``parallel.halo``).

In one process a :class:`Mesh` is a grid of ``torch.device``s and that
process drives every shard; the "collectives" are device-to-device copies
and small sums (``parallel.halo``).  Devices may repeat: ``make_mesh(
chan=2, time=4, devices=["cuda:0"] * 8)`` is 8 virtual shards on one card,
as the JAX tests use 8 virtual CPU devices, and ``devices=["cpu"] * 8`` is
the same mesh on the CPU.

Across processes (``parallel.launch``) the global layout is JAX's: the
global device list is the processes in rank order, each process's devices
in local order, reshaped row-major into (chan, time).  A process may own
whole rows, part of one row or parts of several; ``Mesh.devices`` holds
its segment of each row it touches, ``Mesh.rows`` and ``Mesh.tstart``
their global row and first time index.  A row that crosses processes has
a :class:`RowLink`: the row's process group (made once, in the same order
on every rank), the ranks to the left and right of this process's
segment, and the transport, chosen from the topology when the mesh is
built and printed: NCCL where the row's ranks own distinct cards, gloo
otherwise (CPU shards, or ranks that share a card, which NCCL refuses).

``channel_sharding``, ``P`` and ``NamedSharding`` have no torch
counterpart.  In their place :func:`shard` cuts this process's (C, N)
block into the grid of local tensors, each on its device, and
:func:`gather` puts a grid back together; the sharded functions take
either form and return the form they were given.
"""
from __future__ import annotations

import contextlib
import datetime
import socket
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..config import device as _device

__all__ = ["Mesh", "RowLink", "make_mesh", "shard", "gather"]

# how long a row's collectives wait for its ranks before they give up
# (NCCL's default, stated so that kernel #11's wait can follow it)
ROW_TIMEOUT = datetime.timedelta(minutes=10)

# the cards given to ``launch.initialize`` (local_device_ids): what
# ``make_mesh(devices=None)`` means in that process
_LOCAL_DEVICES: Optional[list] = None


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


@dataclass(frozen=True)
class RowLink:
    """One mesh row that crosses processes, seen from this process.

    ``group``: the process group of the row's ranks (``ranks``, in time
    order); ``left``/``right``: the global ranks that hold the shards just
    before and after this process's segment (None at the row's ends);
    ``t0``: the segment's first time index, ``time`` the row's length;
    ``transport``: "nccl" or "gloo"; ``device``: the segment's first
    device, where this process's traffic of the row goes (one NCCL
    communicator a row); ``one_host``: every rank of the row runs on this
    host (kernel #11's receive slots are mapped between processes by CUDA
    IPC, which needs it); ``timeout``: how long the row's collectives wait
    for its ranks (its group's)."""
    row: int
    group: object
    ranks: tuple
    left: Optional[int]
    right: Optional[int]
    t0: int
    time: int
    transport: str
    device: torch.device
    one_host: bool
    timeout: datetime.timedelta = ROW_TIMEOUT


class Mesh:
    """A ("chan", "time") grid of devices.  ``devices[i]`` is this
    process's segment of global row ``rows[i]``, time shards ``tstart[i]``
    on; ``shape`` holds the global axis sizes; ``links[i]`` is the row's
    :class:`RowLink`, or None when the row lies in this process.
    ``halo_buffers[i]`` holds kernel #11's receive slots of row i, made at
    first use and kept."""

    axis_names = ("chan", "time")

    def __init__(self, devices: Sequence[Sequence[torch.device]],
                 chan: int, time: int, rows: Optional[Sequence[int]] = None,
                 tstart: Optional[Sequence[int]] = None,
                 links: Optional[Sequence] = None):
        self.devices = [[_indexed(d) for d in row] for row in devices]
        self.shape = {"chan": int(chan), "time": int(time)}
        n = len(self.devices)
        self.rows = list(rows) if rows is not None else list(range(n))
        self.tstart = list(tstart) if tstart is not None else [0] * n
        self.links = list(links) if links is not None else [None] * n
        self.halo_buffers: dict = {}

    @property
    def local_rows(self) -> int:
        return len(self.devices)

    def box(self) -> tuple[range, range]:
        """(global rows, global time shards) of the smallest block that
        holds every local shard: what ``launch.host_slice`` names and
        :func:`shard` cuts."""
        if not self.devices:
            return range(0), range(0)
        t0 = min(self.tstart)
        t1 = max(t + len(r) for t, r in zip(self.tstart, self.devices))
        return range(self.rows[0], self.rows[-1] + 1), range(t0, t1)

    def __repr__(self) -> str:
        segs = [f"row {r} t {t}..{t + len(d) - 1}: {[str(x) for x in d]}"
                for r, t, d in zip(self.rows, self.tstart, self.devices)]
        return f"Mesh(shape={self.shape}, {'; '.join(segs)})"


def _process() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _card_id(d: torch.device, rank: int) -> tuple:
    """What identifies the card behind ``d`` across processes: (host, the
    card's UUID); a CPU shard is its own (host, "cpu", rank)."""
    host = socket.gethostname()
    if d.type == "cuda":
        return (host, str(torch.cuda.get_device_properties(d).uuid))
    return (host, "cpu", rank)


def _row_links(chan: int, time: int, n_local: int, rank: int, info: list,
               segs: dict, grid: dict) -> dict:
    """Make the process group of every row that crosses processes, in row
    order on every rank (``dist.new_group`` is collective over the whole
    world), and return this process's {row: RowLink}."""
    links = {}
    for r in range(chan):
        gs = range(r * time, (r + 1) * time)
        ranks = tuple(sorted({g // n_local for g in gs}))
        if len(ranks) == 1:
            continue
        cards = [info[g // n_local]["cards"][g % n_local] for g in gs]
        on_cuda = all(c[1] != "cpu" for c in cards)
        owners: dict = {}
        for g, c in zip(gs, cards):
            owners.setdefault(c, set()).add(g // n_local)
        shared = any(len(o) > 1 for o in owners.values())
        transport = "nccl" if on_cuda and not shared else "gloo"
        group = dist.new_group(list(ranks), backend=transport,
                               timeout=ROW_TIMEOUT)
        one_host = len({info[k]["host"] for k in ranks}) == 1
        if rank == ranks[0]:
            why = ("the row's ranks own distinct cards" if transport == "nccl"
                   else "CPU shards" if not on_cuda
                   else "ranks share a card, which NCCL refuses")
            print(f"mesh: row {r} spans ranks {list(ranks)}: transport "
                  f"{transport} ({why})", flush=True)
        if r in segs:
            t0, tn = segs[r]
            g0, g1 = r * time + t0, r * time + tn
            left = (g0 - 1) // n_local if t0 > 0 else None
            right = g1 // n_local if tn < time else None
            links[r] = RowLink(r, group, ranks, left, right, t0, time,
                               transport, grid[r][0], one_host)
            if transport == "nccl":
                # make the communicator now, with every rank of the row:
                # a first point-to-point call may involve only two of them
                with on_device(grid[r][0]):
                    dist.all_reduce(torch.zeros(1, device=grid[r][0]),
                                    group=group)
    return links


def make_mesh(chan: Optional[int] = None, time: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ("chan", "time") mesh.

    devices: this process's devices, repeats allowed (virtual shards);
    None = the cards given to ``launch.initialize``, else every visible
    CUDA device (raises without a card).  If chan is None, every device
    goes on the channel axis.  In a process group of W processes, each
    with as many devices, the axes span W times as many devices in JAX's
    global order; every rank must call this with the same chan and time
    (rows that cross processes get their process groups here)."""
    if devices is None:
        if _LOCAL_DEVICES is not None:
            devices = list(_LOCAL_DEVICES)
        else:
            _device("cuda")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [_indexed(d) for d in devices]
    rank, world = _process()
    n_local = len(devices)
    info = [{"host": socket.gethostname(), "n": n_local,
             "cards": [_card_id(d, rank) for d in devices]}]
    if world > 1:
        mine, info = info[0], [None] * world
        dist.all_gather_object(info, mine)
        counts = {i["n"] for i in info}
        if len(counts) > 1:
            raise ValueError(f"every process must bring as many devices; "
                             f"got {[i['n'] for i in info]}")
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
    # this process's global positions g = rank n_local + j, row-major
    segs: dict = {}
    grid: dict = {}
    for j, d in enumerate(devices):
        g = rank * n_local + j
        if g >= need:
            break
        r, t = divmod(g, time)
        grid.setdefault(r, []).append(d)
        t0, _ = segs.get(r, (t, t))
        segs[r] = (t0, t + 1)
    links = (_row_links(chan, time, n_local, rank, info, segs, grid)
             if world > 1 else {})
    rows = sorted(grid)
    return Mesh([grid[r] for r in rows], chan, time, rows=rows,
                tstart=[segs[r][0] for r in rows],
                links=[links.get(r) for r in rows])


def _split(n: int, k: int, axis: str) -> int:
    if k == 0 or n % k:
        raise ValueError(f"{n} does not split evenly over the {k} "
                         f"{axis!r} shards of this process")
    return n // k


def shard(mesh: Mesh, x: torch.Tensor) -> list:
    """Cut x (C, N), this process's block of the global signal (its rows'
    channels, the samples of the time shards it holds: ``Mesh.box``), into
    the grid ``[[x_it]]`` of contiguous local tensors, x_it on the device of
    segment i's shard t."""
    if x.ndim != 2:
        raise ValueError(f"shard takes (C, N), got {tuple(x.shape)}")
    rows, ts = mesh.box()
    c = _split(x.shape[0], len(rows), "chan")
    n = _split(x.shape[1], len(ts), "time")
    grid = []
    for r, t0, row in zip(mesh.rows, mesh.tstart, mesh.devices):
        i = r - rows.start
        grid.append([x[i * c:(i + 1) * c,
                       (t0 + k - ts.start) * n:(t0 + k - ts.start + 1) * n]
                     .to(d).contiguous() for k, d in enumerate(row)])
    return grid


def gather(mesh: Mesh, grid: list) -> torch.Tensor:
    """The grid's tensors put back into one (C, N) tensor on the device of
    shard (0, 0).  Raises when this process's segments do not fill its
    block (a row held in part): pass and take the grid then."""
    _, ts = mesh.box()
    if any(t0 != ts.start or len(row) != len(ts)
           for t0, row in zip(mesh.tstart, mesh.devices)):
        raise ValueError("this process holds parts of rows of unequal span; "
                         "the sharded functions take and return the grid")
    dev = mesh.devices[0][0]
    return torch.cat([torch.cat([p.to(dev) for p in row], dim=-1)
                      for row in grid], dim=0)
