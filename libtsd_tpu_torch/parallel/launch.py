"""Multi-process launch path: the part of scale-out that crosses processes
and hosts.

Ported from ``libtsd_tpu/parallel/launch.py``.  Model:

* one process per card (or per host, or per group of cards);
  :func:`initialize` first, with the coordinator's address, the process
  count and this process's rank given explicitly (nothing on a GPU
  machine announces a cluster).  The world group is gloo: it carries the
  mesh's set-up (the topology, the process groups, kernel #11's slot
  handles) and small host objects.  Each mesh row that crosses processes
  gets its own group when the mesh is built, NCCL or gloo from the
  topology (``mesh.make_mesh``);
* the global ("chan", "time") mesh is JAX's layout: processes in rank
  order, each process's devices in local order; a "time" row may cross
  processes, and then its halo goes point to point and its sum over
  "time" is an all-reduce over the row's group (``parallel.halo``);
* each process ingests ONLY its own block of the signal (its SDR front
  end or file shard): :func:`host_slice` says which along each axis, and
  :func:`ingest_local` places it on its devices; a cross-process result
  (a checksum, a global spectrum) is the caller's ``torch.distributed``
  collective.

The same sharded calls run unchanged in one process or many.
:func:`spawn` starts such a fleet on this host, for the examples, the
smoke run and the tests.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as _mesh
from .mesh import Mesh, shard

__all__ = ["initialize", "is_distributed", "ingest_local", "host_slice",
           "spawn"]

TIMEOUT = datetime.timedelta(seconds=120)


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join the process group.  Call once per process, before building a
    mesh; a second call is a no-op.

    coordinator_address: "host:port" (or "tcp://host:port") of rank 0.
    local_device_ids: this process's CUDA devices, the first made current;
    ``make_mesh(devices=None)`` then means these cards.  None: CPU shards,
    or devices passed to ``make_mesh``.  The rendezvous and every
    collective give up after TIMEOUT."""
    if dist.is_initialized():
        return
    addr = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
        _mesh._LOCAL_DEVICES = [torch.device("cuda", int(i))
                                for i in local_device_ids]
    dist.init_process_group("gloo", init_method=addr,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=TIMEOUT)


def is_distributed() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def host_slice(mesh: Mesh, axis: str, n: int) -> slice:
    """The half-open range of global indices along a dimension of size n,
    mapped to mesh axis ``axis``, that this process's devices own.  They
    must be contiguous along the axis (JAX's check); a process that holds
    parts of several rows gets the block that spans them."""
    shards = mesh.shape[axis]
    if n % shards:
        raise ValueError(f"{n} does not split over {shards} {axis!r} "
                         f"shards")
    if mesh.local_rows == 0:
        raise ValueError(
            f"this process owns no device in the mesh along {axis!r} "
            f"(mesh devices exclude all local devices)")
    if axis == "chan":
        pos = sorted(set(mesh.rows))
    else:
        pos = sorted({t0 + k for t0, row in zip(mesh.tstart, mesh.devices)
                      for k in range(len(row))})
    if pos != list(range(pos[0], pos[0] + len(pos))):
        raise ValueError(f"process devices not contiguous along {axis}: "
                         f"{pos}")
    per = n // shards
    return slice(pos[0] * per, (pos[-1] + 1) * per)


def ingest_local(mesh: Mesh, local_data) -> list:
    """Place this process's block of the global (C, N) signal (its
    ``host_slice`` along both axes) on its devices: the grid of local
    tensors that the sharded functions take.  Where the process holds part
    of a row, the block's other shards are not placed."""
    if isinstance(local_data, np.ndarray):
        local_data = torch.from_numpy(np.ascontiguousarray(local_data))
    return shard(mesh, local_data)


def spawn(argv: Sequence[str], nproc: int, timeout: float,
          env: Optional[dict] = None) -> list:
    """Run ``python argv... --coordinator A --nproc n --pid p`` for p in
    0..nproc-1 on this host, all at once, and wait for them within one
    deadline of ``timeout`` seconds.  The workers see this environment,
    plus ``env``, with the checkout on PYTHONPATH.  Returns each worker's
    output (stdout and stderr together).  A worker that fails or outlives
    the deadline raises RuntimeError with its output's tail; every worker
    is stopped before this returns or raises."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, **(env or {}), "PYTHONPATH": root + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    with socket.socket() as sock:          # a port free at this moment
        sock.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{sock.getsockname()[1]}"
    logs = [tempfile.TemporaryFile("w+") for _ in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, *argv, "--coordinator", addr, "--nproc",
         str(nproc), "--pid", str(p)], stdout=log,
        stderr=subprocess.STDOUT, text=True, env=env)
        for p, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    failed, late = None, False
    try:
        # poll them all: a worker that fails stops the others at once
        # (they would wait on it until their collectives time out)
        while failed is None and any(pr.poll() is None for pr in procs):
            failed = next((p for p, pr in enumerate(procs)
                           if pr.poll() not in (None, 0)), None)
            if failed is None and time.monotonic() > deadline:
                late = True
                failed = next(p for p, pr in enumerate(procs)
                              if pr.poll() is None)
            time.sleep(0.05)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
            pr.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed is None:
        failed = next((p for p, pr in enumerate(procs) if pr.returncode),
                      None)
    if failed is not None:
        why = (f"did not finish within {timeout:.0f} s" if late
               else f"exited {procs[failed].returncode}")
        raise RuntimeError(f"worker {failed} of {nproc} {why}:\n"
                           f"{outs[failed][-4000:]}")
    return outs
