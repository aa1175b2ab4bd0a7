"""Kernel #1: one-shot real FIR, zero initial state (``csrc/fir.cu``).

Replaces ``libtsd_tpu/ops/pallas/fir.py::fir_pallas`` /
``fir_pallas_complex``.  What bounds the kernel on the H100 and what its
design does about it is set out at the top of ``csrc/fir.cu``: the FIR on
the tensor cores, x and h each split into three bf16 parts and the six
products xi hj with i + j <= 4 summed in fp32 (the accuracy of the JAX
kernel's HIGHEST), from a window staged one tile ahead; any tap count, in
chunks of 496 taps.

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

_TAP_QUANTUM = 256      # FIR_TAP_QUANTUM of fir_tile.cuh (chain's fp32 tier)


def _check_1d(x: torch.Tensor) -> None:
    if x.ndim != 1:
        # a (C, N) batch is ops.filter_rt.Fir / fir_filter's job; this
        # kernel is the single-stream form, as in the JAX package
        raise ValueError(
            f"fir_kernel takes a 1-D signal, got shape {tuple(x.shape)}; use "
            f"ops.filter_rt.Fir / fir_filter for batched (C, N) input")


def pad_taps(taps: torch.Tensor) -> tuple[torch.Tensor, int]:
    """fp32 taps zero-padded to kp, a multiple of the fp32 FIR core's tap
    quantum (FIR_TAP_QUANTUM in csrc/fir_tile.cuh, the fused chain's
    "highest" tier).  Returns (taps, kp)."""
    K = taps.shape[0]
    kp = max(_TAP_QUANTUM, -(-K // _TAP_QUANTUM) * _TAP_QUANTUM)
    return F.pad(taps.to(torch.float32), (0, kp - K)).contiguous(), kp


def fir_plain(h, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: Toeplitz-matmul FIR at true fp32."""
    _check_1d(x)
    return fir_filter(np.asarray(h, np.float64), x.to(torch.float32))


_taps_cache: dict = {}


def device_taps(h, device: torch.device) -> torch.Tensor:
    """The fp32 taps on the card, kept per (taps, device): a copy from host
    memory on every call would wait for the stream each time.  The key is
    the taps' bytes, hashed on every call.  At most 16 tap sets are kept:
    the 17th empties the cache, so a caller that cycles through more than
    16 (a filter bank) pays the host copy again on each call."""
    hf = np.ascontiguousarray(np.asarray(h, np.float32).ravel())
    if hf.size == 0:
        raise ValueError("fir_kernel needs at least one tap")
    key = (hf.tobytes(), str(device))
    taps = _taps_cache.get(key)
    if taps is None:
        if len(_taps_cache) >= 16:
            _taps_cache.clear()
        taps = _taps_cache[key] = torch.as_tensor(hf, device=device)
    return taps


def fir_kernel(h, x: torch.Tensor) -> torch.Tensor:
    """y[n] = sum_k h[k] x[n-k], zero initial state, len(y) == len(x).
    h: host taps; x: (N,) real."""
    _check_1d(x)
    if _build.use_plain(x):
        return fir_plain(h, x)
    x = x.to(torch.float32).contiguous()
    if x.data_ptr() % 16:
        x = x.clone()                 # the kernel copies 16 bytes at a time
    y = torch.empty_like(x)
    n = x.shape[0]
    if n == 0:
        return y
    taps = device_taps(h, x.device)
    _build.require_cuda(x, taps, y)
    err = _build.lib().fir_f32(_build.ptr(x), _build.ptr(taps), _build.ptr(y),
                               n, taps.numel(), _build.stream_ptr(x.device))
    _build.check(err, "fir_f32")
    fir_kernel.launches += 1
    return y


fir_kernel.launches = 0


def fir_kernel_complex(h, x: torch.Tensor) -> torch.Tensor:
    """Complex signal, real taps: two plane-wise calls."""
    return torch.complex(fir_kernel(h, x.real.contiguous()),
                         fir_kernel(h, x.imag.contiguous()))
