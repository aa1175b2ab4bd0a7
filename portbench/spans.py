"""Spans recorded from the benchmark's own files around each call into a
layer of the port.  Off (a shared null context) unless the run is traced;
on, each span is a ``torch.profiler.record_function`` range, which lands in
the trace as a ``user_annotation`` event."""
from __future__ import annotations

import contextlib

enabled = False
_NULL = contextlib.nullcontext()


def span(name: str):
    if not enabled:
        return _NULL
    import torch
    return torch.profiler.record_function(name)
