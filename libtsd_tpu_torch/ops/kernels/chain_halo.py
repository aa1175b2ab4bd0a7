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
#3's own code and taps (:func:`chain.kernel_taps`, checked and trimmed once
per G and device), so one shard's partial spectrum equals #3 called with
its left neighbour's tail as ``hist0``.  Like #3, the tiers with one tap
plane at K <= ``chain.K_MAX_WG`` (:func:`chain.wg_route`) run the
persistent ``wgmma`` pipeline of ``csrc/chain_wg.cu`` (each block pushes
its share of the channels in its prologue; a FIR warpgroup waits for the
flag before a channel's first pair), the others ``chain_frames``
(``csrc/chain_body.cuh``).  ``fir_periodogram4096_halo.wg_launches``
counts the launches that took the ``wgmma`` body, beside ``launches``.
What bounds it: #3's tensor-core FIR (the fp32 FMAs for "highest"), plus
(D - 1) 128 samples a channel pushed.

The host side of the protocol lives here and must stay in step with the
comment at the top of ``csrc/chain_halo.cu``: slot = epoch & 1, a row's
shards launched in time order on each device's stream, a shard's stream
waiting for its left neighbour's launch and, before overwriting a slot,
for the event after its right neighbour's kernel of the call two back.
:class:`HaloBuffers` holds the slots, flags, epoch and events of one
row; ``parallel.chain`` keeps one per mesh row and reuses it.

Across processes (a mesh row over several processes on one host,
``HaloBuffers.link``), the receive slot of a process's first shard is a
``cudaMalloc`` segment exported by CUDA IPC and mapped into the process on
its left, which pushes there; the handles go round once per row.  The
host orders the processes' calls, so that call e writes a slot only after
its last reader, call e - 2, is done:

* "nccl" transport (the row's ranks on distinct cards), called by the
  sharded chain (``parallel.chain``, ``_ordered_by_sum=True``): nothing
  more is needed.  That caller all-reduces each call's partial spectra
  over the row's group on the first shard's stream before its next call;
  the sum completes only once every rank's kernels of the call have
  finished, and a rank's next kernels queue behind it.  So every rank's
  kernels of call e - 1 (and e - 2) are done before any rank's kernel of
  call e starts.  The first call after :meth:`HaloBuffers.fit` is ordered
  by ``fit``'s own ``all_gather_object`` of the slot handles (a slot is
  zeroed before its handle leaves).  A rank whose left neighbour's host
  is late waits inside #11: its first-frame blocks spin on the flag for
  up to the row group's timeout (``RowLink.timeout``), as long as the
  barrier would have waited, and then trap;
* "nccl" transport, the wrapper called on its own: a one-word all-reduce
  over the row's group on the first shard's stream before the launches
  (the row barrier, span ``tsd.parallel.order``) gives the same order,
  and the neighbours start together: a wait lasts about one kernel start,
  and one that lasts 10 s traps, as within a process;
* "gloo" transport (ranks that share a card, whose kernels time-slice
  and never overlap), whoever calls: each rank waits for a token from the
  rank on its left, which sends it once its kernels have finished,
  launches, waits for its own kernels and sends the token on; a row
  barrier ends the call.  A shard then never spins on a flag while its
  left neighbour waits for a time slice, and no slot is written before
  its last reader is done.

``tb``, ``pipe`` and ``interpret`` of the JAX function are TPU knobs and
are not ported, as for #3.  Rows across cards (peer stores over NVLink)
are checked on a four-card host by
``tests/test_torch_cuda.py::test_sharded_chain_across_cards``.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.distributed as dist

from ...utils.monitor import span, spanned
from . import _build
from .chain import (_L, _DTYPE_CODE, _history, _ingest, aligned,
                    fir_periodogram4096_plain, kernel_taps, wg_route)
from .fft import twiddles
from .periodogram import NFFT

__all__ = ["HaloBuffers", "fir_periodogram4096_halo",
           "fir_periodogram4096_halo_plain"]

# how long a shard waits for its flag before #11 traps, where its left
# neighbour starts with it: a broken exchange, not a late neighbour
_WAIT_NS = 10 * 10**9


def _halo_len(G: torch.Tensor, N: int) -> int:
    """P = (D - 1) 128 samples pushed per channel; at most the shard."""
    P = (G.shape[0] - 1) * _L
    if P > N:
        raise ValueError(f"halo ({P}) exceeds the local shard length ({N}); "
                         f"use fewer/larger time shards")
    return P


class _DeviceBytes:
    """A raw device allocation seen as an array (``torch.as_tensor`` reads
    ``__cuda_array_interface__``); the tensor does not own the memory."""

    _TYPESTR = {torch.int16: "<i2", torch.bfloat16: "<i2",
                torch.float32: "<f4", torch.int8: "|i1", torch.int32: "<i4"}

    def __init__(self, ptr: int, shape: tuple, dtype: torch.dtype):
        self.__cuda_array_interface__ = {
            "shape": tuple(shape), "typestr": self._TYPESTR[dtype],
            "data": (int(ptr), False), "version": 2}

    @classmethod
    def tensor(cls, ptr: int, shape: tuple, dtype: torch.dtype,
               dev: torch.device) -> torch.Tensor:
        t = torch.as_tensor(cls(ptr, shape, dtype), device=dev)
        return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def _ipc_layout(C: int, P: int, dtype: torch.dtype) -> tuple[int, int]:
    """(byte offset of the flags, total bytes) of an exported slot:
    recv (2, C, P) in the ingest dtype, then flags (2, C) int32."""
    es = torch.empty((), dtype=dtype).element_size()
    off = -(-2 * C * P * es // 256) * 256
    return off, off + 2 * C * 4


class HaloBuffers:
    """Receive slots and flags of kernel #11 for one mesh row (this
    process's segment of it), kept over calls: per shard ``recv`` (2, C, P)
    in the ingest dtype and ``flags`` (2, C) int32 on its device, both
    zeroed when made; the call ``epoch``; per slot the event after each
    shard's kernel of the last call that used the slot (waited on only
    across streams).  ``link``: the row's ``parallel.mesh.RowLink`` where it
    crosses processes (None: the whole row is in this process); then the
    first shard's slot is exported by CUDA IPC when a rank sits to its
    left, and the right rank's slot is mapped (``peer``).  Made empty: the
    wrapper sizes it at its first call, and again when the row changes."""

    def __init__(self, link=None):
        self.link = link
        self.key = None
        self.recv, self.flags = [], []
        self.epoch = 0
        self.done = [[], []]
        self.peer = None        # (device, base pointer) mapped from the right
        self._own = None        # (device, base pointer) exported to the left
        self.tick = None        # the "nccl" row barrier's word

    def fit(self, devices: list, C: int, P: int, dtype: torch.dtype) -> None:
        """Allocate the slots for this row unless they already fit it.
        Across processes every rank of the row calls this at the same
        call: the slot handles are exchanged over the row's group."""
        key = (tuple(devices), C, P, dtype)
        if key == self.key:
            return
        if self.key is not None:
            # a kernel of the last call may still push into the old slots
            for d in set(self.key[0]):
                torch.cuda.synchronize(d)
            self.release()
        self.key = key
        link = self.link
        self.recv = [torch.zeros((2, C, P), dtype=dtype, device=d)
                     for d in devices]
        self.flags = [torch.zeros((2, C), dtype=torch.int32, device=d)
                      for d in devices]
        self.epoch = 0
        self.done = [[None] * len(devices) for _ in range(2)]
        if link is None:
            return
        off, nbytes = _ipc_layout(C, P, dtype)
        handle = None
        if link.left is not None:
            d = devices[0]
            base = ctypes.c_void_p()
            buf = ctypes.create_string_buffer(64)
            _build.check(_build.lib().chain_halo_ipc_alloc(
                d.index, nbytes, ctypes.byref(base), buf),
                "chain_halo_ipc_alloc")
            self._own = (d, base.value)
            self.recv[0] = _DeviceBytes.tensor(base.value, (2, C, P), dtype, d)
            self.flags[0] = _DeviceBytes.tensor(base.value + off, (2, C),
                                                torch.int32, d)
            handle = buf.raw
        handles = [None] * len(link.ranks)
        with torch.cuda.device(link.device):
            dist.all_gather_object(handles, handle, group=link.group)
        if link.right is not None:
            d = devices[-1]
            h = handles[link.ranks.index(link.right)]
            base = ctypes.c_void_p()
            _build.check(_build.lib().chain_halo_ipc_open(
                d.index, ctypes.create_string_buffer(h, 64),
                ctypes.byref(base)), "chain_halo_ipc_open")
            self.peer = (d, base.value)
        if link.transport == "nccl":
            self.tick = torch.zeros(1, dtype=torch.int32, device=devices[0])

    def peer_slot(self, s: int) -> tuple:
        """(recv, flags) pointers of slot s of the right rank's first
        shard, in this process's mapping."""
        C, P, dtype = self.key[1:]
        off, _ = _ipc_layout(C, P, dtype)
        es = torch.empty((), dtype=dtype).element_size()
        base = self.peer[1]
        return (ctypes.c_void_p(base + s * C * P * es),
                ctypes.c_void_p(base + off + s * C * 4))

    def release(self) -> None:
        """Unmap the right rank's slot and free the exported one, once no
        rank of the row maps it any more (a row barrier between)."""
        if self.link is None:
            return
        if self.peer is not None:
            d, base = self.peer
            _build.check(_build.lib().chain_halo_ipc_close(
                d.index, ctypes.c_void_p(base)), "chain_halo_ipc_close")
            self.peer = None
        with torch.cuda.device(self.link.device):
            dist.barrier(group=self.link.group)
        if self._own is not None:
            d, base = self._own
            self.recv[0] = self.flags[0] = None
            _build.check(_build.lib().chain_halo_ipc_free(
                d.index, ctypes.c_void_p(base)), "chain_halo_ipc_free")
            self._own = None
        self.key = None


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


def _plain_across(xs: list, G: torch.Tensor, hist0, precision: str,
                  link) -> torch.Tensor | None:
    """The plain route's history of a segment whose row crosses
    processes: this segment's last tail goes to the rank on the right
    (point to point over the row's group) and the rank on the left's
    arrives as the first shard's history; the caller's hist0 where the
    segment starts the row."""
    from ...parallel.halo import send_recv_tail
    x0 = _ingest(xs[-1], precision)
    C, N = x0.shape
    D = G.shape[0]
    P = _halo_len(G, N)
    if P == 0:
        return hist0
    got = send_recv_tail(x0[:, N - P:], link)
    return hist0 if link.left is None else got.reshape(C, D - 1, _L)


def _order_before(bufs: HaloBuffers, devices: list, epoch: int) -> None:
    """Across processes, what a rank waits for before its launches when
    its caller does not order the calls (see the module's docstring): the
    "nccl" row barrier on the first shard's stream, or the "gloo" token
    from the rank on the left."""
    link = bufs.link
    if link.transport == "nccl":
        with torch.cuda.device(devices[0]):
            dist.all_reduce(bufs.tick, group=link.group)
    elif link.left is not None:
        token = torch.zeros(1, dtype=torch.int64)
        dist.recv(token, link.left, group=link.group)
        if int(token) != epoch:
            raise RuntimeError(f"#11 across processes: call {epoch} got the "
                               f"token of call {int(token)} from rank "
                               f"{link.left}")


def _order_after(bufs: HaloBuffers, devices: list, epoch: int) -> None:
    """Across processes on the "gloo" transport: wait for this rank's
    kernels, pass the token to the right, then a row barrier."""
    link = bufs.link
    if link.transport == "nccl":
        return
    for d in set(devices):
        torch.cuda.synchronize(d)
    if link.right is not None:
        dist.send(torch.tensor([epoch], dtype=torch.int64), link.right,
                  group=link.group)
    with torch.cuda.device(link.device):
        dist.barrier(group=link.group)


@spanned("tsd.kernels.fir_periodogram4096_halo")
def fir_periodogram4096_halo(xs: Sequence[torch.Tensor], G: torch.Tensor,
                             hist0: torch.Tensor | None = None,
                             precision: str = "highest",
                             fir_passes: int = 3,
                             bufs: HaloBuffers | None = None, *,
                             _ordered_by_sum: bool = False) -> list:
    """xs: the time shards of one mesh row (this process's segment of it),
    in time order, each (C, N_local) on its device (N_local % 4096 == 0).
    G: (D, 128, 128) Toeplitz tap matrices.  Returns the per-shard partial
    spectra (C, 4096) float32, each on its shard's device; their sum over
    the row is #3 on the concatenated signal.

    hist0: the (C, max(D-1, 1), 128) history before the row's first shard
    (None = zero state); a segment that does not start the row takes its
    history from the rank on its left instead.  bufs: the row's
    :class:`HaloBuffers`, kept by the caller over calls (a fresh set when
    None; across processes the mesh's, which carry the row's link).
    precision / fir_passes: as for ``chain.fir_periodogram4096``.
    _ordered_by_sum: for ``parallel.chain`` alone, which all-reduces each
    call's outputs over the row's group before its next call; on the
    "nccl" transport that sum orders the calls, and the row barrier is
    left out (the module's docstring)."""
    xs = list(xs)
    if not xs:
        raise ValueError("no time shards")
    link = bufs.link if bufs is not None else None
    if _plain_row(xs):
        if link is not None:
            hist0 = _plain_across(xs, G, hist0, precision, link)
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
    from_left = link is not None and link.left is not None
    h0 = None if from_left else _history(hist0, C, D, xs[0].dtype,
                                         devices[0])
    # flags hold the low 32 bits of the epoch: a slot's flag then holds
    # the value of the call two back, never this call's (the zeroed flags
    # precede epochs 1 and 2)
    bufs.epoch += 1
    epoch, s = bufs.epoch & 0xFFFFFFFF, bufs.epoch & 1
    by_sum = (link is not None and _ordered_by_sum
              and link.transport == "nccl")
    if link is not None and not by_sum:
        with span("tsd.parallel.order"):
            _order_before(bufs, devices, epoch)
    wait_ns = (int(link.timeout.total_seconds() * 1e9) if by_sum
               else _WAIT_NS)
    to_right = link is not None and link.right is not None
    null = ctypes.c_void_p(None)
    outs, started = [], None
    for t, x in enumerate(xs):
        dev = x.device
        last = t + 1 == len(xs)
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
                right = bufs.done[s][t + 1] if not last else None
                if right is not None and devices[t + 1] != dev:
                    stream.wait_event(right)
                started = torch.cuda.Event()
                started.record(stream)
            has_left = (t > 0 or from_left) and P > 0
            has_right = (not last or to_right) and P > 0
            if has_right and last:
                peer_recv, peer_flag = bufs.peer_slot(s)
            elif has_right:
                peer_recv = _build.ptr(bufs.recv[t + 1][s])
                peer_flag = _build.ptr(bufs.flags[t + 1][s])
            else:
                peer_recv = peer_flag = null
            err = _build.lib().fir_periodogram4096_halo(
                _build.ptr(x), _build.ptr(hist),
                _build.ptr(bufs.recv[t][s]) if has_left else null,
                _build.ptr(bufs.flags[t][s]) if has_left else null,
                peer_recv, peer_flag,
                _build.ptr(tp), _build.ptr(tw), _build.ptr(out),
                _DTYPE_CODE[x.dtype], passes, N, C, K, P,
                (D - 1) * _L if (t == 0 and h0 is not None) else 0,
                max(D - 1, 1) * _L, wait_ns, epoch,
                _build.stream_ptr(dev))
            _build.check(err, "fir_periodogram4096_halo")
            fir_periodogram4096_halo.launches += 1
            fir_periodogram4096_halo.wg_launches += wg_route(passes, K)
            if multi:
                bufs.done[s][t] = torch.cuda.Event()
                bufs.done[s][t].record(stream)
        outs.append(out)
    if link is not None:
        _order_after(bufs, devices, epoch)
    return outs


fir_periodogram4096_halo.launches = 0
fir_periodogram4096_halo.wg_launches = 0
