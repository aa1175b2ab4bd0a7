"""Kernel #1: one-shot real FIR, zero initial state (``csrc/fir.cu``).

Replaces ``libtsd_tpu/ops/pallas/fir.py::fir_pallas`` /
``fir_pallas_complex``.  What bounds the kernel on the H100 and what its
design does about it is set out at the top of ``csrc/fir.cu``: 2K flop per
sample against 8 bytes, so FMA issue and the shared-memory loads that feed
it bound it, and the register-blocked core issues ~1 load per 4 FMAs.

``fir_kernel(h, x)`` takes a CPU tensor to the plain version
(:func:`fir_plain`, the Toeplitz-matmul FIR of ``ops.filter_rt`` at fp32)
and a CUDA tensor to the kernel; there is no fallback between the two.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..filter_rt import fir_filter
from . import _build

__all__ = ["fir_kernel", "fir_kernel_complex", "fir_plain"]

_TILE = 4096            # outputs per block (FIR_TILE)
_TAP_QUANTUM = 256      # taps are zero-padded to a multiple (FIR_TAP_QUANTUM)


def _check_1d(x: torch.Tensor) -> None:
    if x.ndim != 1:
        # a (C, N) batch is ops.filter_rt.Fir / fir_filter's job; this
        # kernel is the single-stream form, as in the JAX package
        raise ValueError(
            f"fir_kernel takes a 1-D signal, got shape {tuple(x.shape)}; use "
            f"ops.filter_rt.Fir / fir_filter for batched (C, N) input")


def pad_taps(taps: torch.Tensor) -> tuple[torch.Tensor, int]:
    """fp32 taps zero-padded to kp, a multiple of the FIR core's tap
    quantum (FIR_TAP_QUANTUM in csrc/fir_tile.cuh).  Returns (taps, kp)."""
    K = taps.shape[0]
    kp = max(_TAP_QUANTUM, -(-K // _TAP_QUANTUM) * _TAP_QUANTUM)
    return F.pad(taps.to(torch.float32), (0, kp - K)).contiguous(), kp


def fir_plain(h, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: Toeplitz-matmul FIR at true fp32."""
    _check_1d(x)
    return fir_filter(np.asarray(h, np.float64), x.to(torch.float32))


def fir_kernel(h, x: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_k h[k] x[n-k], zero initial state, len(y) == len(x).
    h: host taps; x: (N,) real."""
    _check_1d(x)
    if _build.use_plain(x):
        return fir_plain(h, x)
    x = x.to(torch.float32).contiguous()
    y = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return y
    taps, kp = pad_taps(torch.as_tensor(np.asarray(h, np.float32),
                                        device=x.device))
    smem = (2 * kp - 1 + _TILE) * 4
    if smem > _build.SMEM_MAX:
        raise ValueError(f"{len(np.asarray(h))} taps exceed the kernel's "
                         f"shared-memory window")
    _build.require_cuda(x, taps, y)
    err = _build.lib().fir_f32(_build.ptr(x), _build.ptr(taps), _build.ptr(y),
                               n, kp, smem, _build.stream_ptr(x.device))
    _build.check(err, "fir_f32")
    fir_kernel.launches += 1
    return y


fir_kernel.launches = 0


def fir_kernel_complex(h, x: torch.Tensor) -> torch.Tensor:
    """Complex signal, real taps: two plane-wise calls."""
    return torch.complex(fir_kernel(h, x.real.contiguous()),
                         fir_kernel(h, x.imag.contiguous()))
