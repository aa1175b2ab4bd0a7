"""Window functions (design-time, host numpy, float64).

Parity: core/src/fenetres.cc:17-430, core/include/tsd/filtrage.hpp:119-251.

Design-time code runs once on host in float64; runtime kernels are JAX.  All
functions return ``np.ndarray`` (float64); convert with ``jnp.asarray`` when
feeding device code.

Sampling-grid convention (parity: ``fen_inter``, core/src/fenetres.cc:17-58):
returns n points t in [-1/2, 1/2] with either *symmetric* (endpoints included;
filter design) or *periodic* (spectral analysis) spacing.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

__all__ = [
    "window_interval",
    "window",
    "kaiser_window",
    "kaiser_param",
    "chebyshev_window",
    "slepian_window",
]


def window_interval(n: int, sym: bool = True) -> np.ndarray:
    """n points in [-1/2, 1/2], symmetric or periodic.

    Parity: fen_inter, core/src/fenetres.cc:17-58 (including its integer
    divisions for the endpoints).
    """
    if n <= 1:
        return np.zeros(max(n, 0))
    if n % 2 == 0:
        tmin = -(n // 2)
        tmax = (n // 2) if sym else (n - 1) // 2
    else:
        tmin = -(n // 2)
        tmax = (n // 2) if sym else n // 2 - (n - 1.0) / n
    return np.linspace(tmin / n, tmax / n, n)


def _generalized_hamming(a: float, n: int, sym: bool) -> np.ndarray:
    # Parity: Hamming_generalise, core/src/fenetres.cc:125-128
    return a + (1.0 - a) * np.cos(2.0 * np.pi * window_interval(n, sym))


def window(kind: str, n: int, sym: bool = True) -> np.ndarray:
    """Build a window by name.

    Names (EN + the reference's short codes, core/src/fenetres.cc:178-204):
    ``re``/``none``/``rect``, ``hn``/``hann``, ``hm``/``hamming``,
    ``tr``/``triangle``, ``bm``/``blackman``, ``ch``/``cheb`` (80 dB),
    ``kaiser`` (beta=default 0.5·π).
    """
    kind = kind.lower()
    if kind in ("", "re", "none", "rect", "aucune"):
        return np.ones(n)
    if kind in ("hn", "hann"):
        return _generalized_hamming(0.5, n, sym)
    if kind in ("hm", "hamming"):
        return _generalized_hamming(0.54, n, sym)
    if kind in ("tr", "triangle", "triangular"):
        t = window_interval(n, sym)
        return 2.0 * (0.5 - np.abs(t))
    if kind in ("bm", "blackman"):
        # Parity: core/src/fenetres.cc:243-251 (exact Blackman, alpha=0.16)
        t = 2.0 * np.pi * window_interval(n, sym) + np.pi
        alpha = 0.16
        a0, a1, a2 = (1 - alpha) / 2, 0.5, alpha / 2
        return a0 - a1 * np.cos(t) + a2 * np.cos(2 * t)
    if kind in ("ch", "cheb", "chebyshev"):
        return chebyshev_window(n, 80.0)
    if kind == "kaiser":
        return kaiser_window(n, 0.5)
    raise ValueError(f"unknown window kind {kind!r}")


def kaiser_window(n: int, beta: float, sym: bool = True) -> np.ndarray:
    """Kaiser window; ``beta`` is in units of pi (parity: fenêtre_kaiser1,
    core/src/fenetres.cc:61-84, which multiplies beta by pi on entry)."""
    b = beta * np.pi
    t = window_interval(n, sym)
    k = 2.0 * t
    return np.i0(b * np.sqrt(np.maximum(0.0, 1.0 - k * k))) / np.i0(b)


def kaiser_param(atten_db: float, df: float) -> Tuple[float, int]:
    """Kaiser order/beta from stop-band attenuation (dB) and transition width
    (normalized freq).  Returns (beta-in-units-of-pi, n) with n forced odd.

    Parity: kaiser_param, core/src/fenetres.cc:86-101.
    """
    dw = 2 * np.pi * df
    n = int(math.ceil((atten_db - 7.95) / (2.285 * dw)))
    if n <= 0:
        n = 1
    if n % 2 == 0:
        n += 1
    if atten_db > 50:
        beta = 0.1102 * (atten_db - 8.7)
    elif atten_db >= 21:
        beta = 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    else:
        beta = 0.0
    return beta / np.pi, n


def _cheb_eval(x: np.ndarray, n: int) -> np.ndarray:
    """Chebyshev polynomial T_n extended outside [-1,1] via cosh
    (parity: cheb_eval, core/src/fenetres.cc:268-277)."""
    x = np.asarray(x, dtype=float)
    out = np.empty_like(x)
    inside = np.abs(x) <= 1
    out[inside] = np.cos(n * np.arccos(x[inside]))
    hi = x > 1
    out[hi] = np.cosh(n * np.arccosh(x[hi]))
    lo = x < -1
    sign = -1.0 if (n & 1) else 1.0
    out[lo] = sign * np.cosh(n * np.arccosh(-x[lo]))
    return out


def chebyshev_window(n: int, atten_db: float = 80.0) -> np.ndarray:
    """Dolph-Chebyshev window by frequency-domain synthesis.

    Parity: fenêtre_chebychev, core/src/fenetres.cc:281-311 (same algorithm:
    sample the Chebyshev response on n-1 points, alternate signs in lieu of
    fftshift, inverse FFT, halve the first coefficient, mirror, normalize).
    """
    if n <= 1:
        return np.ones(n)
    alin = 10.0 ** (atten_db / 20.0)
    beta = np.real(np.cosh(np.arccosh(complex(alin)) / (n - 1)))
    i = np.arange(n - 1)
    x = beta * np.cos(np.pi * i / (n - 1))
    X = np.where(i % 2 == 1, -1.0, 1.0) * _cheb_eval(x, n - 1)
    w = np.empty(n)
    # reference ifft is orthonormal (1/sqrt(N)); constant factor is then
    # normalized away below, so plain numpy ifft works identically
    w[: n - 1] = np.real(np.fft.ifft(X))
    w[0] /= 2
    w[n - 1] = w[0]
    return w / w.max()


def slepian_window(n: int, bandwidth: float) -> np.ndarray:
    """DPSS (Slepian) window: dominant eigenvector of the sinc kernel matrix.

    Parity: fenêtre_slepian / slepian_matrice, core/src/fenetres.cc:314-342.
    """
    i = np.arange(n)
    d = i[:, None] - i[None, :]
    X = np.pi * bandwidth * np.sinc(d * bandwidth)
    _, vecs = np.linalg.eigh(X)
    w = vecs[:, -1]
    return w if w[n // 2] >= 0 else -w
