"""Fourier transforms (PyTorch), ported from ``libtsd_tpu/ops/fft.py``.

Normalization: orthonormal, 1/sqrt(N) in both directions, applied as a
static scale outside the transform.

``engine="auto"`` sends a CUDA tensor whose transform length is an
unpadded power of two in 256..16384 to the hand-written FFT kernel
(``ops.kernels.fft``, reverse-mode autograd through :class:`FftPow2`);
everything else goes to ``torch.fft``.  ``engine="kernel"`` forces the
kernel wrapper (which takes its plain version for a CPU tensor),
``engine="torch"`` forces ``torch.fft``.

``resample_freq`` resamples by zero-padding or truncating the spectrum,
and ``czt`` runs Bluestein's three transforms, on ``torch.fft``, as the
JAX package runs them on ``jnp.fft``.  ``goertzel`` and
``goertzel_stream`` are batched projections, ``wht`` log2(n) butterfly
passes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import complex_dtype, device as _device, real_dtype
from ..utils.monitor import spanned
from .kernels.fft import NMAX, NMIN, FftPow2

__all__ = ["fft", "ifft", "rfft", "irfft", "fftshift", "ifftshift",
           "fft_freqs", "force_csym", "czt", "goertzel", "goertzel_stream",
           "hadamard", "wht", "next_pow2", "delay_signal", "resample_freq",
           "ola_complexity", "ola_complexity_optimize"]

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


@spanned("tsd.fft.fft")
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


def force_csym(X: torch.Tensor) -> torch.Tensor:
    """Force conjugate symmetry so that ifft(X) is real (parity: force_csym,
    fourier.hpp): X'[k] = (X[k] + conj(X[-k])) / 2."""
    Xr = torch.roll(torch.flip(X, dims=(-1,)), 1, dims=-1).conj()
    return 0.5 * (X + Xr)


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


# ------------------------------------------------------------------- CZT

def czt(x: torch.Tensor, m: Optional[int] = None,
        W: Optional[complex] = None, z0: complex = 1.0 + 0.0j
        ) -> torch.Tensor:
    """Chirp-Z transform along the spiral contour z0 W^-k, k = 0..m-1, by
    Bluestein's three FFTs (parity: tsd::fourier::czt, fourier.cc:1347-1395,
    same contour convention).  The defaults give the unnormalised DFT.

    The chirps and the chirp filter's spectrum are made once a call on
    x's device in float64 (the JAX package makes them in float64 numpy on
    the host), then rounded to complex64."""
    n = x.shape[-1]
    if m is None:
        m = n
    if W is None:
        W = np.exp(-2j * np.pi / m)
    dev = x.device
    k = torch.arange(max(n, m), dtype=torch.float64, device=dev)
    h = torch.exp(-0.5 * k * k * complex(np.log(complex(W))))  # W^(-i^2/2)
    z0pow = torch.exp(-k[:n] * complex(np.log(complex(z0))))    # z0^-i
    g = x * (z0pow / h[:n]).to(complex_dtype)
    # linear convolution of g (length n) with the symmetric chirp over the
    # lags of outputs 0..m-1: y[kk] = sum_i g[i] h[|kk - i|]
    L = next_pow2(n + m - 1)
    hc = torch.zeros(L, dtype=torch.complex128, device=dev)
    hc[:m] = h[:m]
    hc[L - (n - 1):] = h[1:n].flip(0)
    G = torch.fft.fft(g.to(complex_dtype), n=L, dim=-1)
    y = torch.fft.ifft(G * torch.fft.fft(hc).to(complex_dtype),
                       dim=-1)[..., :m]
    return y * (1.0 / h[:m]).to(complex_dtype)


# --------------------------------------------------------------- Goertzel

def goertzel(x: torch.Tensor, f: float) -> torch.Tensor:
    """Normalised power of the single DFT bin at normalised frequency f,
    2 |X(f)|^2 / (energy n), so that a pure sinusoid at f gives ~1 (parity:
    tsd::fourier::goertzel, goertzel.cc:7-29).  The linear recursion is
    evaluated as the direct projection it equals."""
    n = x.shape[-1]
    k = torch.arange(n, dtype=real_dtype, device=x.device)
    X = torch.sum(x * torch.exp(-2j * np.pi * f * k), dim=-1)
    en = torch.sum(x.abs() ** 2, dim=-1)
    return 2.0 * X.abs() ** 2 / (en * n + 1e-30)


def goertzel_stream(x: torch.Tensor, f: float, R: int) -> torch.Tensor:
    """One normalised Goertzel value per R-sample block (parity:
    filtre_goertzel, goertzel.cc:32-79: restart every R samples, normalise
    by the block's energy), as one batched projection.  The length must be
    a multiple of R."""
    n = x.shape[-1]
    if n % R:
        raise ValueError(f"goertzel_stream: length {n} is not a multiple "
                         f"of R={R}")
    blocks = x.reshape(*x.shape[:-1], n // R, R)
    k = torch.arange(R, dtype=real_dtype, device=x.device)
    X = torch.sum(blocks * torch.exp(-2j * np.pi * f * k), dim=-1)
    en = torch.sum(blocks.abs() ** 2, dim=-1)
    return 2.0 * X.abs() ** 2 / (en * R + 1e-30)


# --------------------------------------------------------------- Hadamard

def hadamard(n: int, device="cuda") -> torch.Tensor:
    """Hadamard matrix of order n (a power of 2)."""
    if n & (n - 1):
        raise ValueError(f"hadamard: n={n} is not a power of 2")
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return torch.as_tensor(H, dtype=real_dtype, device=_device(device))


def wht(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh-Hadamard transform along the last axis, unnormalised
    (parity: core/src/fourier/hadamard.cc), in log2(n) butterfly passes."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"wht: length {n} is not a power of 2")
    lead = x.shape[:-1]
    y = x
    h = 1
    while h < n:
        y = y.reshape(*lead, n // (2 * h), 2, h)
        a, b = y[..., 0, :], y[..., 1, :]
        y = torch.cat([a + b, a - b], dim=-1).reshape(*lead, n)
        h *= 2
    return y


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

def resample_freq(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """Frequency-domain resampling by zero-padding or truncating the
    spectrum (parity: rééchan_freq, fourier.cc:1397-1434, with its
    sqrt(ratio) energy scaling)."""
    n = x.shape[-1]
    n2 = int(round(n * ratio))
    if n2 == n:
        # ratios that round to the same length too: a sqrt(ratio) gain on
        # an unchanged length would disagree with ratio == 1
        return x
    if n2 < 2 or n < 2:
        raise ValueError(
            f"resample_freq: lengths below 2 are degenerate (n={n}, "
            f"target n2={n2}): the half-spectrum split has no bins")
    X = torch.fft.fft(x) * (1.0 / np.sqrt(n))
    X2 = torch.zeros(tuple(x.shape[:-1]) + (n2,), dtype=complex_dtype,
                     device=x.device)
    if ratio > 1:
        # (n + 1) // 2 positive bins: the reference copies n / 2
        # (fourier.cc:1406), which for odd n drops positive bin (n - 1) / 2
        # and keeps its conjugate
        X2[..., :(n + 1) // 2] = X[..., :(n + 1) // 2]
        X2[..., n2 - n // 2:] = X[..., n - n // 2:]
    else:
        X2[..., :n2 // 2] = X[..., :n2 // 2]
        X2[..., n2 - n2 // 2:] = X[..., n - n2 // 2:]
    y = torch.fft.ifft(X2) * (np.sqrt(n2) * np.sqrt(ratio))
    return y if x.is_complex() else y.real


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
