"""Power spectral densities (PyTorch), ported from
``libtsd_tpu/ops/psd.py``: correlogram, Welch, periodogram/STFT,
spectrogram.  Orthonormal FFT (``ops.fft``, so power-of-two CUDA frames go
through the FFT kernel), fftshifted bins, dB where the reference outputs dB.

Not ported yet: ``freq_estim`` and ``periodogram_cqt`` (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import device as _device, real_dtype
from .fft import fft as _fft, fftshift
from .window import window as _window

__all__ = ["psd_freqs", "psd", "psd_welch", "periodogram_dft", "spectrogram"]


def _win(fen: str, n: int, device) -> torch.Tensor:
    return torch.as_tensor(_window(fen, n, sym=False), dtype=real_dtype,
                           device=device)


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
    S = _power(_fft(x * _win(fen, n, x.device)))
    return psd_freqs(n, device=x.device), 10.0 * torch.log10(S + 1e-30)


def _segments(x: torch.Tensor, N: int, starts) -> torch.Tensor:
    return torch.stack([x[..., int(i):int(i) + N] for i in starts])


def psd_welch(x: torch.Tensor, N: int,
              fen: str = "hn") -> Tuple[torch.Tensor, torch.Tensor]:
    """Welch PSD: 50%-overlapping windowed segments of length N, SUMMED
    (as the reference does), in dB."""
    n = x.shape[-1]
    if n < N:
        x = F.pad(x, (0, N - n))
        n = N
    starts = np.arange(0, n - N, N // 2)
    if len(starts) == 0:
        starts = np.array([0])
    S = torch.sum(_power(_fft(_segments(x, N, starts)
                              * _win(fen, N, x.device))), dim=0)
    return psd_freqs(N, device=x.device), 10.0 * torch.log10(S + 1e-30)


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
    starts = np.arange(0, n - N + 1, hop)
    return _power(_fft(_segments(x, N, starts) * _win(fen, N, x.device)))
