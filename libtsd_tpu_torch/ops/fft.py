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
``wht``, ``resample_freq``, ``force_csym`` (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import complex_dtype, device as _device, real_dtype
from .kernels.fft import NMAX, NMIN, FftPow2

__all__ = ["fft", "ifft", "rfft", "irfft", "fftshift", "ifftshift",
           "fft_freqs", "next_pow2", "delay_signal", "ola_complexity",
           "ola_complexity_optimize"]

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
              device="cuda") -> torch.Tensor:
    """Bin frequencies; ``shifted`` returns them increasing in
    [-fs/2, fs/2)."""
    f = torch.fft.fftfreq(n, d=1.0 / fs, device=_device(device)
                          ).to(real_dtype)
    return torch.fft.fftshift(f) if shifted else f


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def delay_signal(x: torch.Tensor, delay) -> torch.Tensor:
    """Delay a signal (last axis) by a possibly fractional number of
    samples (parity: tsd::fourier::délais, fourier.cc:608-707).  An integer
    delay shifts with zero fill; a fractional one multiplies the spectrum
    of a 2x zero-padded block by a phase ramp (``torch.fft``, as the JAX
    package uses ``jnp.fft``).  ``delay`` may be a tensor."""
    n = x.shape[-1]
    if not isinstance(delay, torch.Tensor) and float(delay) == int(delay):
        d = int(delay)
        if d == 0:
            return x
        z = torch.zeros_like(x[..., :abs(d)])
        if d > 0:
            return torch.cat([z, x[..., :-d]], dim=-1)
        return torch.cat([x[..., -d:], z], dim=-1)
    N = 2 * n
    pad_lo = n // 2
    is_real = not x.is_complex()
    X = torch.fft.fft(F.pad(x, (pad_lo, N - n - pad_lo)), dim=-1)
    kf = torch.fft.fftfreq(N, device=x.device).to(real_dtype)
    rot = torch.exp(-2j * np.pi * kf * delay).to(complex_dtype)
    if is_real:
        # keep the Nyquist bin real so that the output stays real
        rot[N // 2] = torch.cos(2 * np.pi * kf[N // 2] * delay)
    y = torch.fft.ifft(X * rot, dim=-1)[..., pad_lo:pad_lo + n]
    return y.real if is_real else y


# ---------------------------------------------------------- OLA cost model

def ola_complexity(M: int, Ne: int) -> Tuple[float, int, int]:
    """FLOPs/sample of overlap-add FFT filtering with pattern length M and
    input block Ne. Returns (C, Nf, Nz). Parity: ola_complexité,
    core/src/fourier/fourier.cc:708-714."""
    Nf = next_pow2(Ne + M - 1)
    Nz = Nf - Ne
    C = (1.0 / Ne) * 2 * 5 * Nf * np.log2(Nf)
    return C, Nf, Nz


def ola_complexity_optimize(M: int) -> Tuple[float, int, int, int]:
    """Pick the FFT size minimizing FLOPs/sample. Returns (C, Nf, Nz, Ne).
    Parity: ola_complexité_optimise, fourier.cc:715-739."""
    kmin = int(np.ceil(np.log2(max(M, 2))))
    best = None
    for k in range(kmin, min(kmin + 20, 31)):
        Ne = (1 << k) - (M - 1)
        if Ne <= 0:
            continue
        C, Nf, Nz = ola_complexity(M, Ne)
        if best is None or C < best[0]:
            best = (C, Nf, Nz, Ne)
    return best
