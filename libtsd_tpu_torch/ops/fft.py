"""Fourier transforms (PyTorch), ported from ``libtsd_tpu/ops/fft.py``.

Normalization: orthonormal, 1/sqrt(N) in both directions, applied as a
static scale outside the transform.

``engine="auto"`` sends a CUDA tensor whose transform length is an
unpadded power of two in 256..16384 to the hand-written FFT kernel
(``ops.kernels.fft``, reverse-mode autograd through :class:`FftPow2`);
everything else goes to ``torch.fft``.  ``engine="kernel"`` forces the
kernel wrapper (which takes its plain version for a CPU tensor),
``engine="torch"`` forces ``torch.fft``.

Not ported yet: ``czt``, ``goertzel``, ``goertzel_stream``, ``hadamard``,
``wht``, ``delay_signal``, ``resample_freq``, ``force_csym``,
``ola_complexity(_optimize)`` (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import complex_dtype, real_dtype
from .kernels.fft import NMAX, NMIN, FftPow2

__all__ = ["fft", "ifft", "rfft", "irfft", "fftshift", "ifftshift",
           "fft_freqs", "next_pow2"]

ENGINES = ("auto", "kernel", "torch")


def _kernel_eligible(x: torch.Tensor, axis: int) -> bool:
    """CUDA tensor, unpadded power-of-two length 256..16384."""
    N = x.shape[axis]
    if N < NMIN or N > NMAX or N & (N - 1) or x.numel() == 0:
        return False
    return x.is_cuda


def _fft_kernel(x: torch.Tensor, axis: int, inverse: bool) -> torch.Tensor:
    xm = torch.movedim(x.to(complex_dtype), axis, -1)
    shp = xm.shape
    y = FftPow2.apply(xm.reshape(-1, shp[-1]), inverse).reshape(shp)
    return torch.movedim(y, -1, axis)


def _fft_dispatch(x: torch.Tensor, n: Optional[int], axis: int, engine: str,
                  inverse: bool) -> torch.Tensor:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    axis = axis % x.ndim
    if n is not None and n != x.shape[axis]:
        # pad/truncate first for every engine (the kernel never pads)
        cur = x.shape[axis]
        if n < cur:
            x = x.narrow(axis, 0, n)
        else:
            x = F.pad(x, [0, 0] * (x.ndim - 1 - axis) + [0, n - cur])
    if engine == "kernel" or (engine == "auto" and _kernel_eligible(x, axis)):
        return _fft_kernel(x, axis, inverse)
    f = torch.fft.ifft if inverse else torch.fft.fft
    return f(x.to(complex_dtype), dim=axis)


def fft(x: torch.Tensor, n: Optional[int] = None, axis: int = -1,
        engine: str = "auto") -> torch.Tensor:
    """Orthonormal forward DFT.  ``n`` pads or truncates first."""
    N = n if n is not None else x.shape[axis]
    return (_fft_dispatch(x, n, axis, engine, inverse=False)
            * (1.0 / np.sqrt(N)))


def ifft(x: torch.Tensor, n: Optional[int] = None, axis: int = -1,
         engine: str = "auto") -> torch.Tensor:
    """Orthonormal inverse DFT (the transform applies 1/N; the ortho factor
    rescales)."""
    N = n if n is not None else x.shape[axis]
    return _fft_dispatch(x, n, axis, engine, inverse=True) * np.sqrt(N)


def rfft(x: torch.Tensor, n: Optional[int] = None,
         axis: int = -1) -> torch.Tensor:
    """Real-input forward DFT, orthonormal, n//2+1 bins."""
    N = n if n is not None else x.shape[axis]
    return torch.fft.rfft(x.to(real_dtype), n=n, dim=axis) * (1.0 / np.sqrt(N))


def irfft(x: torch.Tensor, n: Optional[int] = None,
          axis: int = -1) -> torch.Tensor:
    N = n if n is not None else 2 * (x.shape[axis] - 1)
    return torch.fft.irfft(x, n=n, dim=axis) * np.sqrt(N)


def fftshift(x: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.fft.fftshift(x, dim=axes)


def ifftshift(x: torch.Tensor, axes=None) -> torch.Tensor:
    return torch.fft.ifftshift(x, dim=axes)


def fft_freqs(n: int, fs: float = 1.0, shifted: bool = True,
              device=None) -> torch.Tensor:
    """Bin frequencies; ``shifted`` returns them increasing in
    [-fs/2, fs/2)."""
    f = torch.fft.fftfreq(n, d=1.0 / fs, device=device).to(real_dtype)
    return torch.fft.fftshift(f) if shifted else f


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()
