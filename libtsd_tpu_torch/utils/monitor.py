"""Performance monitors: named scoped timers with call counts and
throughput, aggregated stats, ``torch.profiler`` integration.  Ported from
``libtsd_tpu/utils/monitor.py``.

Parity: MoniteurCpu / MoniteursStats, core/src/moniteur-cpu.cc:22-236,
core/include/tsd/moniteur-cpu.hpp:10-38.  The reference tracks per-thread
CPU time; here scopes measure wall time around device work (synchronising
the device of the result for honest accounting) and expose samples/s --
the shape of the `moniteurs()` API is preserved (SURVEY §5.1).

:func:`span` names a phase of the port's own work for traces.  Spans are
on exactly while a ``torch.profiler`` session records, and cost one flag
read otherwise; :func:`profiler_trace` is the operator's way to get them,
with the device's activity on the same clock.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Dict, Optional

import torch

from ..block import tree_flatten

__all__ = ["Monitor", "Monitors", "MonitorStats", "block_until_ready",
           "profiler_trace", "span", "spanned"]


def block_until_ready(tree):
    """Wait until every CUDA device holding a tensor of ``tree`` is done
    (``torch.cuda.synchronize`` per device); CPU tensors are ready.
    Returns the tree."""
    devs = {l.device for l in tree_flatten(tree)[0]
            if isinstance(l, torch.Tensor) and l.device.type == "cuda"}
    for d in devs:
        torch.cuda.synchronize(d)
    return tree


@dataclasses.dataclass
class MonitorStats:
    """Parity: MoniteurCpu::Stats."""
    name: str = ""
    total_s: float = 0.0
    count: int = 0
    samples: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    @property
    def samples_per_s(self) -> float:
        return self.samples / self.total_s if self.total_s > 0 else 0.0


class Monitor:
    """Named scoped timer (parity: MoniteurCpu: commence_op/fin_op)."""

    def __init__(self, name: str):
        self.stats = MonitorStats(name=name)
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, samples: int = 0):
        if self._t0 is None:
            return
        self.stats.total_s += time.perf_counter() - self._t0
        self.stats.count += 1
        self.stats.samples += samples
        self._t0 = None

    @contextlib.contextmanager
    def scope(self, samples: int = 0):
        """Context manager yielding a holder: call ``holder.sync(y)`` on
        the result produced INSIDE the scope so that the timer stops only
        when the device that holds it is done (honest device timing --
        without it, PyTorch's asynchronous CUDA launches return at once
        and the scope measures dispatch latency, not compute)."""
        class _Holder:
            _y = None

            def sync(self, y):
                self._y = y
                return y

        h = _Holder()
        self.start()
        try:
            yield h
        finally:
            if h._y is not None:
                block_until_ready(h._y)
            self.stop(samples)


class Monitors:
    """Registry + aggregation (parity: MoniteursStats; e.g. the receiver's
    per-stage monitors "recepteur/ola", "recepteur/demod",
    recepteur.cc:83-85)."""

    def __init__(self):
        self._mons: Dict[str, Monitor] = {}

    def __getitem__(self, name: str) -> Monitor:
        if name not in self._mons:
            self._mons[name] = Monitor(name)
        return self._mons[name]

    def stats(self) -> Dict[str, MonitorStats]:
        return {k: m.stats for k, m in self._mons.items()}

    def report(self) -> str:
        total = sum(m.stats.total_s for m in self._mons.values()) or 1e-12
        lines = [f"{'scope':<30}{'calls':>8}{'total s':>12}{'%':>7}"
                 f"{'Msamp/s':>10}"]
        for k, m in sorted(self._mons.items()):
            s = m.stats
            lines.append(
                f"{k:<30}{s.count:>8}{s.total_s:>12.4f}"
                f"{100 * s.total_s / total:>6.1f}%"
                f"{s.samples_per_s / 1e6:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """``torch.profiler`` scope (host and, with a card, device activity;
    the device-level counterpart of the reference's CPU monitors).  Yields
    the profiler; on exit the trace goes to ``logdir/trace.json`` (chrome
    format)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NULL = contextlib.nullcontext()
_profiler = torch.autograd.profiler
# the range that ``torch.profiler.record_function`` opens, without the two
# operator calls around it (which the profiler records too): about a third
# of its cost under the profiler
_enter = torch.autograd._record_function_with_args_enter
_exit = torch.autograd._record_function_with_args_exit


def span(name: str):
    """A named phase of the port's work (the port's names start with
    ``tsd.``), as a context manager.

    Off -- whenever no ``torch.profiler`` session records -- it is one
    shared null context: a flag read and a call.  On, it is the range that
    ``torch.profiler.record_function(name)`` opens: the trace holds it as a
    ``user_annotation`` on the clock of the device's events, and, with
    CUDA activity recorded, as a ``gpu_user_annotation`` over the device
    work launched inside it.  It records nothing else and never waits for
    the device."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole of each call of the function is :func:`span`
    ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            h = _enter(name)
            try:
                return fn(*args, **kwargs)
            finally:
                _exit(h)
        return call
    return wrap


class _Span:
    __slots__ = ("name", "h")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.h = _enter(self.name)
        return self

    def __exit__(self, *exc):
        _exit(self.h)
        return False
