"""Correlations, coherence and delay estimation (PyTorch), ported from
``libtsd_tpu/ops/corr.py``.

Parity: core/src/fourier/fourier.cc:491-607 and
core/src/fourier/estimation-delais.cc.  The transforms are ``torch.fft``
calls, as the JAX package's are ``jnp.fft`` calls.

Lag conventions match the reference:

* ``ccorr``: circular, lags 0..m-1 (index k is lag +k, wrapping);
* ``xcorr`` / ``xcorrb``: linear, lags -(m-1)..(m-1); the biased form
  divides by n, the unbiased one by the number of overlapping samples.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import complex_dtype, real_dtype
from .signal import sliding_frames

__all__ = ["ccorr", "xcorr", "xcorrb", "coherence", "estimate_delay",
           "align_int"]


def _asc(x: torch.Tensor) -> torch.Tensor:
    return x.to(complex_dtype)


def ccorr(x0: torch.Tensor, x1: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Circular cross-correlation c[k] = (1/m) sum_n x0[n] conj(x1[n+k]).

    Returns (lags, c) with lags 0..m-1 (k >= m/2 are negative lags by
    periodicity).  Parity: tsd::fourier::ccorr, fourier.cc:544-550."""
    if x1 is None:
        x1 = x0
    m = x0.shape[-1]
    X0 = torch.fft.fft(_asc(x0), dim=-1)
    X1 = torch.fft.fft(_asc(x1), dim=-1)
    # c[k] = conj(ifft(conj(X0) X1)[k]), the JAX package's order of
    # conjugations
    c = torch.fft.ifft(X0.conj() * X1, dim=-1).conj()
    lags = torch.arange(m, dtype=real_dtype, device=x0.device)
    return lags, c / m


def xcorrb(x: torch.Tensor, y: Optional[torch.Tensor] = None,
           m: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased linear cross-correlation, lags -(m-1)..(m-1), normalised by
    n: c[k] = (1/n) sum_n x[n] conj(y[n+k]) (parity: tsd::fourier::xcorrb,
    fourier.cc:552-576).  Unequal lengths are zero-padded to the longer,
    as the reference does (estimation-delais.cc)."""
    if y is None:
        y = x
    n = max(x.shape[-1], y.shape[-1])
    if m is None:
        m = n
    if m > n:
        raise ValueError(f"lag range m={m} must be <= common length n={n}")
    # zero-pad both to n + 2m, then correlate circularly
    L = n + 2 * m

    def pad(v):
        out = torch.zeros(tuple(v.shape[:-1]) + (L,), dtype=complex_dtype,
                          device=v.device)
        out[..., m:m + v.shape[-1]] = _asc(v)
        return out

    _, r = ccorr(pad(x), pad(y))
    r = r * L                      # undo ccorr's 1/m
    pos = r[..., :m]               # lags 0..m-1
    neg = r[..., L - (m - 1):] if m > 1 else r[..., :0]   # -(m-1)..-1
    c = torch.cat([neg, pos], dim=-1) / n
    lags = torch.arange(-(m - 1), m, dtype=real_dtype, device=x.device)
    return lags, c


def xcorr(x: torch.Tensor, y: Optional[torch.Tensor] = None,
          m: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unbiased linear cross-correlation (divides by the overlap count).
    Parity: tsd::fourier::xcorr, fourier.cc:578-596."""
    n = max(x.shape[-1], (x if y is None else y).shape[-1])
    if m is None:
        m = n
    if m > n:
        raise ValueError(f"lag range m={m} must be <= signal length n={n}")
    lags, c = xcorrb(x, y, m)
    overlap = torch.clamp(n - lags.abs(), min=1.0) / n
    return lags, c / overlap.to(real_dtype)


def coherence(x: torch.Tensor, y: torch.Tensor, N: int = 0) -> torch.Tensor:
    """Magnitude-squared coherence |<X Y*>|^2 / (<|X|^2> <|Y|^2>),
    Welch-averaged over 50 %-overlapped length-N segments (N = 0: n // 8).

    The reference's coherence (fourier.cc:599-604) takes single
    whole-signal FFTs, where the ratio is identically 1; this is the
    standard estimator, as in the JAX package."""
    n = x.shape[-1]
    if N <= 0:
        N = max(n // 8, 8)
    hop = max(N // 2, 1)
    nseg = (n - N) // hop + 1
    w = torch.as_tensor(np.hanning(N), dtype=real_dtype, device=x.device)
    X = torch.fft.fft(sliding_frames(_asc(x), N, hop, nseg) * w, dim=-1)
    Y = torch.fft.fft(sliding_frames(_asc(y), N, hop, nseg) * w, dim=-1)
    Sxy = torch.sum(X * Y.conj(), dim=0)
    Sxx = torch.sum(X.abs() ** 2, dim=0)
    Syy = torch.sum(Y.abs() ** 2, dim=0)
    return Sxy.abs() ** 2 / (Sxx * Syy + 1e-30)


def estimate_delay(x: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Delay of y relative to x from the correlation peak, refined by
    parabolic interpolation; returns (delay, score), score in [0, 1] the
    normalised peak correlation.  Parity: estimation_délais,
    estimation-delais.cc:21-168.  Single signals only (1-D)."""
    if x.ndim != 1 or y.ndim != 1:
        raise ValueError("estimate_delay takes two 1-D signals")
    n = max(x.shape[-1], y.shape[-1])
    lags, c = xcorrb(x, y, n)
    a = c.abs()
    i = torch.argmax(a)
    last = a.shape[0] - 1
    # parabolic refinement, skipped at the ends (a clamped neighbour would
    # equal the peak; the reference skips there too)
    ym1 = a[torch.clamp(i - 1, min=0)]
    y0 = a[i]
    yp1 = a[torch.clamp(i + 1, max=last)]
    denom = ym1 - 2 * y0 + yp1
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    frac = torch.where(denom.abs() > 1e-12, 0.5 * (ym1 - yp1) / denom, zero)
    frac = torch.where((i == 0) | (i == last), zero, frac)
    frac = torch.clamp(frac, -0.5, 0.5)
    delay = lags[i] + frac
    ex = torch.sum(x.abs() ** 2)
    ey = torch.sum(y.abs() ** 2)
    score = (y0 * n) / (torch.sqrt(ex * ey) + 1e-30)
    return delay, torch.clamp(score, 0.0, 1.0)


def align_int(x: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Align two signals by the integer part of their estimated delay;
    returns (x_aligned, y_aligned, delay), both of the shorter length.
    y is shifted back with zero fill, as the reference trims (parity:
    aligne_entier, estimation-delais.cc)."""
    d, _ = estimate_delay(x, y)
    di = torch.round(d).to(torch.int32)
    n = min(x.shape[-1], y.shape[-1])
    idx = torch.arange(n, device=x.device) + di
    ok = (idx >= 0) & (idx < y.shape[-1])
    y2 = torch.where(ok, y[..., torch.clamp(idx, 0, y.shape[-1] - 1)],
                     torch.zeros((), dtype=y.dtype, device=y.device))
    return x[..., :n], y2, di
