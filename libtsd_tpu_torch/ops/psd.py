"""Power spectral densities (PyTorch), ported from
``libtsd_tpu/ops/psd.py``: correlogram, Welch, periodogram/STFT,
spectrogram, single-tone frequency estimation and the constant-Q
time/frequency matrix.  Orthonormal FFT (``ops.fft``, so power-of-two CUDA
frames go through the FFT kernel), fftshifted bins, dB where the reference
outputs dB.  ``freq_estim`` takes ``torch.fft`` directly, as the JAX
package takes ``jnp.fft``.

``psd_welch`` on the FFT kernel's route (float32 or complex64 input) runs
three hand-written passes and nothing else on the frame matrix: framing
(``ops.kernels.welch``), the FFT kernel on its planes, and the power sum
in dB.  Segment windows are made once per (fen, N, device).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import complex_dtype, device as _device, real_dtype
from . import fft as _fftmod
from .fft import fft as _fft, fftshift
from .kernels import welch as _welch
from .kernels.fft import fft_pow2
from .window import window as _window

__all__ = ["psd_freqs", "psd", "psd_welch", "periodogram_dft", "spectrogram",
           "freq_estim", "periodogram_cqt"]


def _make_win(fen: str, n: int, device) -> torch.Tensor:
    return torch.as_tensor(_window(fen, n, sym=False), dtype=real_dtype,
                           device=device)


_cached_win = functools.lru_cache(maxsize=16)(_make_win)


def _win(fen: str, n: int, device) -> torch.Tensor:
    """A segment's periodic window, made once per (fen, n, device); the
    16 last used are kept."""
    return _cached_win(fen, n, torch.device(device))


def _power(X: torch.Tensor) -> torch.Tensor:
    return fftshift(X.abs() ** 2, axes=-1)


def psd_freqs(n: int, complex_input: bool = True,
              device="cuda") -> torch.Tensor:
    """Frequency grid for a PSD display."""
    device = _device(device)
    if complex_input:
        if n % 2 == 0:
            return torch.linspace(-0.5, 0.5 - 1.0 / n, n, dtype=real_dtype,
                                  device=device)
        return torch.linspace(-0.5 + 1.0 / n, 0.5, n, dtype=real_dtype,
                              device=device)
    t1 = 0.5 - (1.0 / n if n % 2 else 0.0)
    return torch.linspace(0.0, t1, n // 2, dtype=real_dtype, device=device)


def psd(x: torch.Tensor, fen: str = "hn") -> Tuple[torch.Tensor, torch.Tensor]:
    """Windowed correlogram PSD of the whole signal, in dB, fftshifted."""
    n = x.shape[-1]
    # the whole signal's window, made anew: a cache would keep one a length
    S = _power(_fft(x * _make_win(fen, n, x.device)))
    return psd_freqs(n, device=x.device), 10.0 * torch.log10(S + 1e-30)


def _segments(x: torch.Tensor, N: int, hop: int, count: int) -> torch.Tensor:
    """The first ``count`` length-N segments at starts 0, hop, 2 hop, ...:
    one strided view (..., count, N), no copy."""
    return x.unfold(-1, N, hop)[..., :count, :]


def psd_welch(x: torch.Tensor, N: int,
              fen: str = "hn") -> Tuple[torch.Tensor, torch.Tensor]:
    """Welch PSD: 50%-overlapping windowed segments of length N, SUMMED
    (as the reference does), in dB.  On the FFT kernel's route (float32 or
    complex64 x that needs no gradient) the three kernel passes compute
    it; any other x takes the composed tensor ops."""
    n = x.shape[-1]
    if n < N:
        x = F.pad(x, (0, N - n))
        n = N
    # starts 0, N/2, ... below n - N (the start n - N itself is left out,
    # as in the reference); [0] when n == N
    nseg = max(len(range(0, n - N, N // 2)), 1)
    frames = _segments(x, N, N // 2, nseg)
    if (x.dtype in (torch.float32, complex_dtype)
            and _fftmod._kernel_eligible(frames, -1)
            and not (x.requires_grad and torch.is_grad_enabled())):
        return psd_freqs(N, device=x.device), _welch_kernels(x, N, nseg, fen)
    S = torch.sum(_power(_fft(frames * _win(fen, N, x.device))), dim=-2)
    return psd_freqs(N, device=x.device), 10.0 * torch.log10(S + 1e-30)


def _welch_kernels(x: torch.Tensor, N: int, nseg: int,
                   fen: str) -> torch.Tensor:
    """psd_welch's dB on the kernels: framing into #4's planes, #4, the
    power sum; leading dimensions flattened into channels."""
    xc = x.reshape(-1, x.shape[-1]).resolve_conj().contiguous()
    re, im = _welch.welch_frames(xc, _win(fen, N, x.device), N, nseg)
    yr, yi = fft_pow2(re, im)
    S = _welch.welch_power(yr, yi, xc.shape[0], nseg, N)
    return S.reshape(*x.shape[:-1], N)


def periodogram_dft(x: torch.Tensor, N: int) -> torch.Tensor:
    """STFT magnitude matrix: consecutive length-N frames, |FFT|^2, one
    row per frame, fftshifted."""
    nfrm = x.shape[-1] // N
    frames = x[..., :nfrm * N].reshape(*x.shape[:-1], nfrm, N)
    return _power(_fft(frames))


def spectrogram(x: torch.Tensor, N: int, overlap: float = 0.5,
                fen: str = "hn") -> torch.Tensor:
    """Windowed, overlapping STFT power matrix (rows = time frames)."""
    n = x.shape[-1]
    if n < N:
        x = F.pad(x, (0, N - n))
        n = N
    hop = max(1, int(N * (1 - overlap)))
    nseg = len(range(0, n - N + 1, hop))
    P = _power(_fft(_segments(x, N, hop, nseg) * _win(fen, N, x.device)))
    return torch.movedim(P, -2, 0)      # frames first, as in JAX


def freq_estim(x: torch.Tensor, method: str = "candan2") -> torch.Tensor:
    """Single-tone frequency estimate of a 1-D signal, normalised, in
    [-1/2, 1/2) (parity: freqestim, freqestim.cc:95-150):

    * ``fft``: the arg-max bin;
    * ``quadratic``: parabolic interpolation on |X|;
    * ``candan2``: Candan's 2013 refined estimator (the default).
    """
    if method not in ("fft", "quadratic", "candan2"):
        raise ValueError(f"unknown method {method!r}")
    n = x.shape[-1]
    X = torch.fft.fft(x.to(complex_dtype), dim=-1)
    a = X.abs()
    k = torch.argmax(a)
    if method == "fft":
        f = k.to(real_dtype) / n
    elif method == "quadratic":
        X1, X2, X3 = a[(k - 1) % n], a[k], a[(k + 1) % n]
        p = 0.5 * (X3 - X1) / (2 * X2 - X3 - X1)
        f = (k + p) / n
    else:
        X1, X2, X3 = X[(k - 1) % n], X[k], X[(k + 1) % n]
        p = ((X1 - X3) / (2.0 * X2 - X3 - X1)).real
        c = np.float32(np.tan(np.pi / n) / (np.pi / n))
        p = torch.atan(p * float(c) * np.pi / n) / (np.pi / n)
        f = (k + p) / n
    return torch.remainder(f + 0.5, 1.0) - 0.5      # wrap to [-1/2, 1/2)


def periodogram_cqt(x: torch.Tensor, fs: float, fmin: float, fmax: float,
                    gamma: float = 2 ** (1 / 12), ofs: float = 0.0):
    """Constant-Q time/frequency matrix (parity: periodogramme_cqt,
    cqt.cc:461-476, fourier.hpp:958-977): the streaming decimated CQT of
    a real signal on its device, its irregular per-bin outputs copied to
    the host once and resampled onto a regular grid at output rate
    ``ofs`` (default fs / 256).  Returns numpy (t_seconds, freqs_hz,
    A[nframes, nbins])."""
    from .cqt import cqt_interpolate, cqt_stream, cqt_stream_kernel
    if ofs <= 0:
        ofs = fs / 256.0
    if x.is_complex():
        # the CQT bank analyses real (audio) signals; the real plane of IQ
        # data would give wrong magnitudes silently
        raise ValueError(
            "periodogram_cqt expects a real signal; for complex IQ use "
            "ops.psd.psd/spectrogram or run the planes separately")
    K = cqt_stream_kernel(fmin / fs, fmax / fs, gamma)
    hop = K.N // 2
    npad = (-x.shape[-1]) % hop
    if npad:
        x = F.pad(x, (0, npad))
    times, mags, valid = cqt_stream(x, K)
    hop_out = max(1, int(round(fs / ofs)))
    grid, freqs, A = cqt_interpolate(times, mags, valid, K, hop_out)
    return grid / fs, freqs * fs, A
