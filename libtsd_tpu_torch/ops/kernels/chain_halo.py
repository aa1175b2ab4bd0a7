"""Kernel #11: the fused metric chain (kernel #3) on the time shards of one
mesh row, with the overlap halo exchanged inside the kernel
(``csrc/chain_halo.cu``).

Replaces the fused-halo branch of
``libtsd_tpu/ops/pallas/chain.py::fir_periodogram4096`` (``halo_axis=``),
where each TPU shard pushes its input tail into its right neighbour's
VMEM with one ``make_async_remote_copy``.  Here each shard's kernel stores
its tail into the right neighbour's receive slot through a (peer) pointer
and publishes an epoch-tagged flag; the neighbour's first-frame blocks
acquire the flag and read the history from the slot.  The spectrum is
#3's own code (``csrc/chain_body.cuh``) and taps (:func:`chain.kernel_taps`,
checked and trimmed once per G and device), so one shard's partial
spectrum equals #3 called with its left neighbour's tail as ``hist0``.
What bounds it: #3's tensor-core FIR (the fp32 FMAs for "highest"), plus
(D - 1) 128 samples a channel pushed.

The host side of the protocol lives here and must stay in step with the
comment at the top of ``csrc/chain_halo.cu``: slot = epoch & 1, a row's
shards launched in time order on each device's stream, a shard's stream
waiting for its left neighbour's launch and, before overwriting a slot,
for the event after its right neighbour's kernel of the call two back.
:class:`HaloBuffers` holds the slots, flags, epoch and events of one
row; ``parallel.chain`` keeps one per mesh row and reuses it.

``tb``, ``pipe`` and ``interpret`` of the JAX function are TPU knobs and
are not ported, as for #3.  Rows across cards (peer stores over NVLink)
are checked on a four-card host by
``tests/test_torch_cuda.py::test_sharded_chain_across_cards``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _build
from .chain import (_L, _DTYPE_CODE, _history, _ingest, aligned,
                    fir_periodogram4096_plain, kernel_taps)
from .fft import twiddles
from .periodogram import NFFT

__all__ = ["HaloBuffers", "fir_periodogram4096_halo",
           "fir_periodogram4096_halo_plain"]


def _halo_len(G: torch.Tensor, N: int) -> int:
    """P = (D - 1) 128 samples pushed per channel; at most the shard."""
    P = (G.shape[0] - 1) * _L
    if P > N:
        raise ValueError(f"halo ({P}) exceeds the local shard length ({N}); "
                         f"use fewer/larger time shards")
    return P


class HaloBuffers:
    """Receive slots and flags of kernel #11 for one mesh row, kept over
    calls: per shard ``recv`` (2, C, P) in the ingest dtype and ``flags``
    (2, C) int32 on its device, both zeroed when made; the call ``epoch``;
    and per slot the event after each shard's kernel of the last call that
    used the slot (waited on only across streams).  Made empty: the wrapper
    sizes it at its first call, and again when the row changes."""

    def __init__(self):
        self.key = None
        self.recv, self.flags = [], []
        self.epoch = 0
        self.done = [[], []]

    def fit(self, devices: list, C: int, P: int, dtype: torch.dtype) -> None:
        """Allocate the slots for this row unless they already fit it."""
        key = (tuple(devices), C, P, dtype)
        if key == self.key:
            return
        if self.key is not None:
            # a kernel of the last call may still push into the old slots
            for d in set(self.key[0]):
                torch.cuda.synchronize(d)
        self.key = key
        self.recv = [torch.zeros((2, C, P), dtype=dtype, device=d)
                     for d in devices]
        self.flags = [torch.zeros((2, C), dtype=torch.int32, device=d)
                      for d in devices]
        self.epoch = 0
        self.done = [[None] * len(devices) for _ in range(2)]


def fir_periodogram4096_halo_plain(xs: Sequence[torch.Tensor],
                                   G: torch.Tensor,
                                   hist0: torch.Tensor | None = None,
                                   precision: str = "highest",
                                   fir_passes: int = 3) -> list:
    """Plain PyTorch version: shard t takes shard t - 1's last (D - 1) 128
    samples by slicing (shard 0 takes ``hist0``, or zeros) and runs #3's
    plain version.  Returns the per-shard partial spectra."""
    xs = [_ingest(x, precision) for x in xs]
    C, N = xs[0].shape
    D = G.shape[0]
    P = _halo_len(G, N)
    outs = []
    for t, x in enumerate(xs):
        h = hist0
        if t > 0:
            h = (xs[t - 1][:, N - P:].to(x.device).reshape(C, D - 1, _L)
                 if D > 1 else None)
        outs.append(fir_periodogram4096_plain(x, G.to(x.device), h,
                                              precision, fir_passes))
    return outs


def _check_row(xs: list) -> tuple[int, int]:
    C, N = xs[0].shape
    for x in xs:
        if x.ndim != 2 or tuple(x.shape) != (C, N) or x.dtype != xs[0].dtype:
            raise ValueError("every time shard must be (C, N_local) of one "
                             "dtype")
    if N % NFFT:
        raise ValueError(f"N_local must be a multiple of {NFFT}, got {N}")
    return C, N


def _plain_row(xs: list) -> bool:
    """Route of a row: True when every shard is a CPU tensor (the plain
    version), False when every shard is a CUDA tensor (the kernel, or an
    error).  A row that mixes the two raises: a shard on a card never runs
    the plain version."""
    plain = {_build.use_plain(x) for x in xs}
    if len(plain) > 1:
        raise ValueError("a row mixes CPU and CUDA shards; #11 runs every "
                         "shard of a row on a card, or every one on the CPU")
    return plain.pop()


def _enable_peer(devices: list) -> None:
    for a, b in zip(devices, devices[1:]):
        if a != b:
            _build.check(_build.lib().chain_halo_enable_peer(a.index,
                                                             b.index),
                         f"chain_halo_enable_peer({a}, {b})")


def fir_periodogram4096_halo(xs: Sequence[torch.Tensor], G: torch.Tensor,
                             hist0: torch.Tensor | None = None,
                             precision: str = "highest",
                             fir_passes: int = 3,
                             bufs: HaloBuffers | None = None) -> list:
    """xs: the time shards of one mesh row, in time order, each (C,
    N_local) on its device (N_local % 4096 == 0).  G: (D, 128, 128)
    Toeplitz tap matrices.  Returns the per-shard partial spectra (C, 4096)
    float32, each on its shard's device; their sum is #3 on the
    concatenated signal.

    hist0: the (C, max(D-1, 1), 128) history before shard 0 (None = zero
    state).  bufs: the row's :class:`HaloBuffers`, kept by the caller over
    calls (a fresh set when None).
    precision / fir_passes: as for ``chain.fir_periodogram4096``."""
    xs = list(xs)
    if not xs:
        raise ValueError("no time shards")
    if _plain_row(xs):
        return fir_periodogram4096_halo_plain(xs, G, hist0, precision,
                                              fir_passes)
    xs = [_ingest(x, precision).contiguous() for x in xs]
    C, N = _check_row(xs)
    D = G.shape[0]
    P = _halo_len(G, N)
    devices = [x.device for x in xs]
    if bufs is None:
        bufs = HaloBuffers()
    bufs.fit(devices, C, P, xs[0].dtype)
    multi = len(set(devices)) > 1
    if multi:
        _enable_peer(devices)
    h0 = _history(hist0, C, D, xs[0].dtype, devices[0])
    # flags hold the low 32 bits of the epoch: a slot's flag then holds
    # the value of the call two back, never this call's (the zeroed flags
    # precede epochs 1 and 2)
    bufs.epoch += 1
    epoch, s = bufs.epoch & 0xFFFFFFFF, bufs.epoch & 1
    null = ctypes.c_void_p(None)
    outs, started = [], None
    for t, x in enumerate(xs):
        dev = x.device
        with torch.cuda.device(dev):
            x = aligned(x)                  # 16-byte loads and pushes
            tp, K, passes = kernel_taps(G, precision, fir_passes, dev)
            tw = twiddles(12, dev)
            out = torch.zeros((C, NFFT), dtype=torch.float32, device=dev)
            hist = h0 if (t == 0 and h0 is not None) else x
            _build.require_cuda(x, hist, tp, tw, out)
            stream = torch.cuda.current_stream(dev)
            if multi:
                if t > 0 and devices[t - 1] != dev:
                    stream.wait_event(started)
                right = bufs.done[s][t + 1] if t + 1 < len(xs) else None
                if right is not None and devices[t + 1] != dev:
                    stream.wait_event(right)
                started = torch.cuda.Event()
                started.record(stream)
            has_left = t > 0 and P > 0
            has_right = t + 1 < len(xs) and P > 0
            err = _build.lib().fir_periodogram4096_halo(
                _build.ptr(x), _build.ptr(hist),
                _build.ptr(bufs.recv[t][s]) if has_left else null,
                _build.ptr(bufs.flags[t][s]) if has_left else null,
                _build.ptr(bufs.recv[t + 1][s]) if has_right else null,
                _build.ptr(bufs.flags[t + 1][s]) if has_right else null,
                _build.ptr(tp), _build.ptr(tw), _build.ptr(out),
                _DTYPE_CODE[x.dtype], passes, N, C, K, P,
                (D - 1) * _L if (t == 0 and h0 is not None) else 0,
                max(D - 1, 1) * _L, epoch, _build.stream_ptr(dev))
            _build.check(err, "fir_periodogram4096_halo")
            fir_periodogram4096_halo.launches += 1
            if multi:
                bufs.done[s][t] = torch.cuda.Event()
                bufs.done[s][t].record(stream)
        outs.append(out)
    return outs


fir_periodogram4096_halo.launches = 0
