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
  here one sum of the row's (C_local, 4096) partials on the row's first
  device.

Two exchange forms, as in JAX: ``halo="ppermute"`` copies the tails with
``halo_exchange_left`` and runs kernel #3 with ``hist0``;
``halo="fused"`` runs kernel #11, which stores each tail into the right
neighbour's receive slot from inside the kernel (``ops.kernels.
chain_halo``; its slots are allocated once per mesh row and kept in
``mesh.halo_buffers``).
"""
from __future__ import annotations

import torch

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

    Returns this process's (C, 4096) accumulated power spectra of the
    FIR-filtered signal, on the device of shard (0, 0): equal to
    ``fir_periodogram4096(x, G)`` on one device."""
    if halo not in HALO_FORMS:
        raise ValueError(f"halo must be one of {HALO_FORMS}, got {halo!r}")
    D = G.shape[0]
    H = max(D - 1, 1)
    grid, _ = _grid(mesh, x)
    dev0 = mesh.devices[0][0]
    rows = []
    for i, row in enumerate(grid):
        if halo == "fused":
            parts = fir_periodogram4096_halo(
                row, G, precision=precision, fir_passes=fir_passes,
                bufs=mesh.halo_buffers.setdefault(i, HaloBuffers()))
        else:
            # the left neighbour's input tail = this shard's FIR state
            tails = halo_exchange_left(row, H * _L)
            parts = []
            for t, (xs, h) in enumerate(zip(row, tails)):
                hist0 = h.reshape(xs.shape[0], H, _L) if t > 0 else None
                with on_device(xs.device):
                    parts.append(fir_periodogram4096(
                        xs, G.to(xs.device), hist0, precision, fir_passes))
        # psum over "time": the row's partials summed on its first device
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p.to(acc.device)
        rows.append(acc.to(dev0))
    return torch.cat(rows, dim=0)

