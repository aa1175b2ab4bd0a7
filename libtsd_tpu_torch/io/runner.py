"""Streaming executor: source -> device block -> host sink (PyTorch),
ported from ``libtsd_tpu/io/runner.py``.

The serving loop the reference runs inside its Sink/tampon callbacks
(core/src/tsd.cc:303-386, receiver loop recepteur.cc:404-650):

* the host side re-blocks arbitrary-size source reads into fixed blocks
  (``Rebuffer``, native ring buffer);
* each block is staged in a pinned host buffer and copied to the device
  with ``non_blocking=True``; the step is launched without waiting, its
  output copied back into pinned memory asynchronously, and one CUDA event
  per block marks when that output is on the host.  Up to ``depth`` blocks
  are in flight, so host transfers and device compute overlap;
* wall time over the whole stream is tracked in a Monitor (samples/s, the
  reference's MoniteurCpu stage counters).

On a CPU device the same loop runs synchronously.  There is no jit cache:
PyTorch runs the block's ``step`` eagerly.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..block import tree_flatten
from ..config import complex_dtype, device as _device, real_dtype
from ..utils.monitor import Monitor
from .streamio import Rebuffer

__all__ = ["StreamRunner"]


def _block_device(block, device=None) -> torch.device:
    """The device a block runs on: ``device`` when given, else that of its
    first buffer or parameter, else its ``device`` attribute, else the card
    (``config.device``, which raises without one)."""
    if device is not None:
        return _device(device)
    for t in list(block.buffers()) + list(block.parameters()):
        return t.device
    dev = getattr(block, "device", None)
    return _device(dev if dev is not None else "cuda")


class StreamRunner:
    """Drive a Block over an unbounded sample stream.

    block:      any ``state, y = block.step(state, x)`` block (Fir, OlaFft,
                Chain, a frame Receiver, ...); it runs on the device its
                buffers live on.
    block_len:  samples per device step (for OlaFft-like blocks a multiple
                of ``block.Ne``).
    sink:       callback receiving each output block as host numpy arrays
                (the output's tree structure kept), or None to collect
                them for ``run``.
    complex_in: whether the source samples are complex.
    depth:      the most device steps in flight (2 = double buffering).
    device:     where the blocks are staged (default: the device of the
                block's first tensor, else its ``device`` attribute, else
                the card; a block with neither raises without a card).
    """

    def __init__(self, block, block_len: int,
                 sink: Optional[Callable] = None, complex_in: bool = True,
                 depth: int = 2, device=None):
        self.block = block
        self.block_len = int(block_len)
        self.sink = sink
        self.complex_in = bool(complex_in)
        self.depth = int(depth)
        if self.depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.monitor = Monitor("stream_runner")
        self.device = _block_device(block, device)
        self._cuda = self.device.type == "cuda"
        dt = complex_dtype if self.complex_in else real_dtype
        # one pinned staging buffer per block in flight: block k uses
        # buffer k % depth, and at most depth - 1 earlier blocks are still
        # in flight when it is filled
        self._stage = [torch.empty(self.block_len, dtype=dt,
                                   pin_memory=self._cuda)
                       for _ in range(self.depth)]
        self._rebuf = self._new_rebuffer()
        self._state = None
        self._pending: deque = deque()
        self._out: list = []
        self._nsub = 0              # blocks dispatched

    def _new_rebuffer(self) -> Rebuffer:
        return Rebuffer(self.block_len, self._submit,
                        complex_iq=self.complex_in,
                        capacity=max(8 * self.block_len, 1 << 16))

    # ------------------------------------------------------------- core

    def _to_device(self, xb: np.ndarray) -> torch.Tensor:
        host = self._stage[self._nsub % self.depth]
        host.copy_(torch.from_numpy(np.ascontiguousarray(
            xb, np.complex64 if self.complex_in else np.float32)))
        return host.to(self.device, non_blocking=True)

    def _to_host(self, y):
        """Start the copy of every output leaf into pinned host memory;
        returns (event or None, unflatten, host leaves)."""
        leaves, unflatten = tree_flatten(y)
        host = []
        for l in leaves:
            h = torch.empty(l.shape, dtype=l.dtype, pin_memory=self._cuda)
            h.copy_(l, non_blocking=True)
            host.append(h)
        ev = None
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        return ev, unflatten, host

    def _emit(self, item):
        ev, unflatten, host = item
        if ev is not None:
            ev.synchronize()              # this block only
        y = unflatten([h.numpy() for h in host])
        if self.sink is not None:
            self.sink(y)
        else:
            self._out.append(y)

    def _submit(self, xb: np.ndarray):
        # the step is launched, not waited for: wall-clock over the whole
        # stream (run) is the honest throughput
        x = self._to_device(xb)
        if self._state is None:
            self._state = self.block.init_for(x)
        self._state, y = self.block.step(self._state, x)
        self._nsub += 1
        self._pending.append(self._to_host(y))
        while len(self._pending) >= self.depth:
            self._emit(self._pending.popleft())

    # -------------------------------------------------------------- API

    def push(self, x: np.ndarray) -> None:
        """Feed samples of any length; full blocks are dispatched."""
        self._rebuf.push(np.ascontiguousarray(x))

    def drain(self) -> None:
        """Wait for every step in flight and emit its output."""
        while self._pending:
            self._emit(self._pending.popleft())

    @property
    def residual(self) -> int:
        """Samples held back (< block_len) awaiting the next push."""
        return self._rebuf.rb.available

    def flush(self) -> int:
        """Zero-pad the held-back residue to one full block, dispatch it
        and drain.  Returns the number of REAL samples in that last block
        (0 if the stream ended block-aligned); the tail of the last output
        block belongs to the padding."""
        n = self._rebuf.rb.available
        if n:
            self.push(np.zeros(self.block_len - n,
                               np.complex64 if self.complex_in
                               else np.float32))
        self.drain()
        return n

    # ------------------------------------------------- checkpoint/resume

    def _state_like(self):
        """The state's structure, shapes and device for restore() on a
        runner that has not dispatched a block yet."""
        x = torch.zeros(self.block_len, dtype=complex_dtype if
                        self.complex_in else real_dtype, device=self.device)
        return self.block.init_for(x)

    def checkpoint(self, path: str) -> None:
        """Write the whole mid-stream serving state to ``path`` (.npz, the
        protocol of ``utils.checkpoint.save_stream_state``): the block's
        state, the host ring residue and the dispatch counter.  Steps in
        flight are drained first, so the cut is consistent; :meth:`restore`
        continues bit-identically."""
        from ..utils.checkpoint import save_stream_state
        self.drain()
        if self._state is None:
            raise RuntimeError("nothing dispatched yet -- push first or "
                               "checkpoint after restore+push")
        save_stream_state(path, self._state, self._rebuf.snapshot(),
                          {"nsub": self._nsub})

    def restore(self, path: str) -> None:
        """Load a :meth:`checkpoint` into this runner (same block and
        block_len), validated against the block's state structure.  Any
        stream this runner was carrying is abandoned: outputs in flight are
        discarded and collected outputs cleared."""
        from ..utils.checkpoint import load_stream_state
        like = self._state if self._state is not None else self._state_like()
        state, residue, ctr = load_stream_state(path, like)
        self._state = state
        self._rebuf = self._new_rebuffer()
        if len(residue):
            self._rebuf.rb.push(residue)
        self._nsub = ctr["nsub"]
        self._pending.clear()
        self._out.clear()

    def run(self, source: Iterable[np.ndarray],
            flush: bool = False) -> Optional[np.ndarray]:
        """Consume an iterable of sample arrays (e.g. an IqFileReader).
        Returns the concatenated output when no sink was given (a list of
        trees for tree outputs).  ``flush=True`` zero-pads and processes a
        tail shorter than a block; otherwise it stays in the ring
        (``residual``)."""
        n0 = self._nsub
        self.monitor.start()
        for chunk in source:
            self.push(chunk)
        if flush:
            self.flush()
        self.drain()
        self.monitor.stop(samples=(self._nsub - n0) * self.block_len)
        if self.sink is None and self._out:
            out = self._out
            self._out = []
            if all(isinstance(o, np.ndarray) for o in out):
                return np.concatenate(out, axis=-1)
            return out
        return None
