"""Multi-process launch path: the part of scale-out that crosses hosts.

Ported from ``libtsd_tpu/parallel/launch.py``.  Model:

* one process per host (or per group of cards); :func:`initialize` first,
  with the coordinator's address, the process count and this process's
  rank given explicitly (nothing on a GPU machine announces a cluster):
  ``torch.distributed`` over NCCL between cards, gloo on the CPU;
* processes lie along the mesh's "chan" axis in rank order, each owning
  whole "time" rows (``mesh.make_mesh``): the halo exchange and the sum
  over "time" stay inside a process, and nothing crosses processes in
  steady state.  A "time" row across processes raises
  NotImplementedError (ROADMAP.md, slice 8 gaps);
* each process ingests ONLY its own channels (its SDR front end or file
  shard), :func:`host_slice` says which, and :func:`ingest_local` places
  them on its devices; a cross-process result (a checksum, a global
  spectrum) is the caller's ``torch.distributed`` collective.

The same sharded calls run unchanged in one process or many.
"""
from __future__ import annotations

import datetime
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, shard

__all__ = ["initialize", "is_distributed", "ingest_local", "host_slice"]

TIMEOUT = datetime.timedelta(seconds=120)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join the process group.  Call once per process, before building a
    mesh; a second call is a no-op.

    coordinator_address: "host:port" (or "tcp://host:port") of rank 0.
    local_device_ids: this process's CUDA devices: NCCL, the first of them
    made current; None: gloo (CPU shards).  The rendezvous and every
    collective give up after TIMEOUT."""
    if dist.is_initialized():
        return
    addr = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    backend = "gloo"
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
        backend = "nccl"
    dist.init_process_group(backend, init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=TIMEOUT)


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def host_slice(mesh: Mesh, axis: str, n: int) -> slice:
    """The half-open range of global indices along a dimension of size n,
    mapped to mesh axis ``axis``, that this process's devices own: its
    block of channels along "chan", everything along "time"."""
    shards = mesh.shape[axis]
    if n % shards:
        raise ValueError(f"{n} does not split over {shards} {axis!r} "
                         f"shards")
    if axis == "time":
        return slice(0, n)
    if mesh.local_rows == 0:
        raise ValueError(
            f"this process owns no device in the mesh along {axis!r} "
            f"(mesh devices exclude all local devices)")
    per = n // shards
    return slice(mesh.row0 * per, (mesh.row0 + mesh.local_rows) * per)


def ingest_local(mesh: Mesh, local_data) -> list:
    """Place this process's slice of the global (C, N) signal (its
    ``host_slice`` channels, every sample) on its devices: the grid of
    local tensors that the sharded functions take."""
    if isinstance(local_data, np.ndarray):
        local_data = torch.from_numpy(np.ascontiguousarray(local_data))
    return shard(mesh, local_data)
