"""Sharded fused metric chain: the FIR + periodogram kernel run over the
("chan", "time") mesh.

Ported from ``libtsd_tpu/parallel/chain.py``:

* channels are data-parallel over "chan" (no steady-state exchange);
* a long signal is sequence-parallel over "time": each time shard hands
  its input tail, the (D - 1) 128 samples the FIR needs as initial state,
  to its right neighbour, and the kernel starts from that history instead
  of zeros; the first shard gets zeros (or the caller's state), so the
  sharded run equals the unsharded one up to float32 reassociation of the
  per-shard spectrum sums;
* the per-shard partial spectra are summed over "time", JAX's ``psum``:
  here one sum of the row's (C_local, 4096) partials on the first device
  of this process's segment, then, where the row crosses processes, an
  all-reduce over the row's group, so that the row's spectrum stands on
  every rank of the row (JAX's ``out_specs=P("chan", None)``).

Two exchange forms, as in JAX: ``halo="ppermute"`` copies the tails with
``halo_exchange_left`` (point to point between processes) and runs kernel
#3 with ``hist0``; ``halo="fused"`` runs kernel #11, which stores each
tail into the right neighbour's receive slot from inside the kernel
(``ops.kernels.chain_halo``; its slots are allocated once per mesh row and
kept in ``mesh.halo_buffers``; across processes they are mapped by CUDA
IPC, so the fused form needs every rank of a row on one host).

Across processes the fused form's calls are ordered by the row's sum: a
rank all-reduces a call's partials over the row's group on the first
shard's stream before it makes the next call, and its next #11 queues
behind that sum, which completes only once every rank's #11 of the call
has finished.  So #11 is told so (``_ordered_by_sum``) and, on the NCCL
transport, runs without a row barrier of its own: one collective a call,
the sum.  The first call after the slots are made is ordered by the
exchange of their handles.  A rank whose left neighbour's host is late
then waits inside #11, on its flag, for up to the row group's timeout
(``RowLink.timeout``, as long as the barrier or the sum would wait); then
#11 traps and the rank's CUDA context is lost, as a collective that times
out ends the process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.kernels.chain import _L, fir_periodogram4096
from ..ops.kernels.chain_halo import HaloBuffers, fir_periodogram4096_halo
from .halo import _grid, halo_exchange_left
from .mesh import Mesh, on_device

__all__ = ["sharded_fir_periodogram4096"]

HALO_FORMS = ("ppermute", "fused")


def sharded_fir_periodogram4096(mesh: Mesh, x, G: torch.Tensor,
                                precision: str = "split",
                                halo: str = "ppermute",
                                fir_passes: int = 3) -> torch.Tensor:
    """Distributed fused FIR + periodogram over a ("chan", "time") mesh.

    x: the global (C, N) tensor (cut by ``mesh.shard``) or that grid of
    local tensors; N / time shards must be a multiple of 4096.  G: (D, 128,
    128) Toeplitz tap matrices.  precision / fir_passes: the tiers of
    ``ops.kernels.chain.fir_periodogram4096``.

    halo: "ppermute" (tail copies, then kernel #3) or "fused" (kernel #11).

    Returns the (C, 4096) accumulated power spectra of the FIR-filtered
    signal of this process's rows, on the device of its shard (0, 0):
    equal to ``fir_periodogram4096(x, G)`` on one device.  The fused form
    raises ValueError for a row whose ranks are not all on this host."""
    if halo not in HALO_FORMS:
        raise ValueError(f"halo must be one of {HALO_FORMS}, got {halo!r}")
    D = G.shape[0]
    H = max(D - 1, 1)
    grid, _ = _grid(mesh, x)
    dev0 = mesh.devices[0][0]
    rows = []
    for i, (row, link) in enumerate(zip(grid, mesh.links)):
        if halo == "fused":
            if link is not None and not link.one_host:
                raise ValueError(
                    f"halo='fused' maps kernel #11's receive slots between "
                    f"processes by CUDA IPC, which needs every rank of a row "
                    f"on one host; row {link.row} spans ranks "
                    f"{list(link.ranks)} on several hosts: use "
                    f"halo='ppermute'")
            parts = fir_periodogram4096_halo(
                row, G, precision=precision, fir_passes=fir_passes,
                bufs=mesh.halo_buffers.setdefault(i, HaloBuffers(link)),
                _ordered_by_sum=True)
        else:
            # the left neighbour's input tail = this shard's FIR state
            tails = halo_exchange_left(row, H * _L, link)
            first = link is None or link.left is None
            parts = []
            for t, (xs, h) in enumerate(zip(row, tails)):
                hist0 = (None if t == 0 and first
                         else h.reshape(xs.shape[0], H, _L))
                with on_device(xs.device):
                    parts.append(fir_periodogram4096(
                        xs, G.to(xs.device), hist0, precision, fir_passes))
        # psum over "time": the segment's partials summed on its first
        # device, then over the row's group (for the fused form, also what
        # orders #11's next call across the row's ranks)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p.to(acc.device)
        if link is not None:
            dist.all_reduce(acc, group=link.group)   # gloo: CUDA all-reduce
        rows.append(acc.to(dev0))
    return torch.cat(rows, dim=0)

