"""Shared set-up and comparison helpers of the port's CPU tests
(``tests/test_torch_*.py``; ``test_torch_cuda.py`` runs alone on the card
and keeps its own).

Importing this module caps torch at one intra-op thread, and at one
inter-op thread where torch still allows it, and numpy's BLAS and OpenMP
pools at one thread (through threadpoolctl, where it is installed).  The
tests run in several xdist workers, each of which imports every test
file; with the default of one thread per core in every pool, the workers'
thread pools and XLA's virtual CPU devices contend for the same cores and
a small loop runs tens of times slower, the more so on a machine that
other jobs share.  The tests use arrays of a few thousand samples, where
one thread loses little.  ``THREAD_ENV`` carries the same caps into the
subprocesses that a test starts.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)
try:
    torch.set_num_interop_threads(1)
except RuntimeError:     # raised once inter-op work has started
    pass
try:
    from threadpoolctl import threadpool_limits
except ImportError:      # the caps above still hold
    threadpool_limits = None
if threadpool_limits is not None:
    threadpool_limits(1)

THREAD_ENV = {k: "1" for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                               "MKL_NUM_THREADS")}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def rel(a, b) -> float:
    """max |a - b| / max |b|, in float64 (complex128 for complex input)."""
    a = _np(a).astype(np.complex128)
    b = _np(b).astype(np.complex128)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def bin_err(a, b, floor: float = 1e-6) -> float:
    """Per-bin error of a spectrum, |a - b| / (|b| + floor * max |b|): behind
    a lowpass most bins lie far below the peak, where rel() sees nothing."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.max(np.abs(a - b) / (np.abs(b) + floor * np.max(np.abs(b))))
