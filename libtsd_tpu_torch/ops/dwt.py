"""Discrete wavelet transform (PyTorch), ported from
``libtsd_tpu/ops/dwt.py``: Haar / Daubechies-4 / biorthogonal wavelets,
multi-level analysis and synthesis, the 2-D image transform.

Parity: core/include/tsd/fourier/tod.hpp:28-131, core/src/fourier/tod.cc.

As in the JAX package, this is the filter-bank form (periodic convolution
and dyadic down/up sampling, by rolls); ``ops/lifting.py`` is the lifting
form.  Each reconstructs perfectly within itself, but their subbands are
not interchangeable (the causal convolution pairs (x[2m-1], x[2m]), the
lifting scheme (x[2m], x[2m+1])), and their orders differ: ``dwt`` returns
[a_L, d_L, ..., d_1], ``lifting.lift_dwt`` [d_1, ..., d_L, a_L].
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["wavelet_filters", "dwt_level", "idwt_level", "dwt", "idwt",
           "dwt2", "idwt2"]


def wavelet_filters(name: str):
    """(dec_lo, dec_hi, rec_lo, rec_hi, shift) for 'haar' | 'db4' |
    'bior' (host numpy, a copy of the JAX package's).

    Analysis is convolution and even-phase downsampling; synthesis is the
    CORRELATION of the zero-stuffed bands with (rec_lo, rec_hi), then a
    circular ``shift``.  For orthogonal wavelets rec == dec and shift == 0.
    'db4' is the 4-tap Daubechies D4 (the reference's "db4" lifting,
    tod.cc:211+); 'bior' is the CDF 5/3 (LeGall) pair."""
    if name == "haar":
        s = 1 / np.sqrt(2)
        lo = np.array([s, s])
        hi = np.array([s, -s])
        return lo, hi, lo, hi, 0
    if name in ("db4", "d4"):
        c = np.array([1 + np.sqrt(3), 3 + np.sqrt(3),
                      3 - np.sqrt(3), 1 - np.sqrt(3)]) / (4 * np.sqrt(2))
        lo = c
        hi = np.array([c[3], -c[2], c[1], -c[0]])
        return lo, hi, lo, hi, 0
    if name in ("bior", "legall", "cdf53"):
        dec_lo = np.array([-1, 2, 6, 2, -1]) / 8.0
        dec_hi = np.array([-1, 2, -1]) / 2.0
        rec_lo = np.array([0, 0, 1, 2, 1]) / 2.0
        rec_hi = np.array([-1, -2, 6, -2, -1]) / 8.0
        return dec_lo, dec_hi, rec_lo, rec_hi, 1
    raise ValueError(f"unknown wavelet {name!r}")


def _conv_periodic(x: torch.Tensor, h: np.ndarray) -> torch.Tensor:
    """Periodic convolution along the last axis (periodised boundary)."""
    out = torch.zeros_like(x)
    for k in range(len(h)):
        out = out + float(h[k]) * torch.roll(x, k, dims=-1)
    return out


def dwt_level(x: torch.Tensor, name: str = "haar"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One analysis level: (approx, detail), each half length
    (periodised)."""
    if x.shape[-1] % 2:
        raise ValueError(
            f"dwt needs an even length at every level (periodised "
            f"boundary); got n={x.shape[-1]}")
    lo, hi, _, _, _ = wavelet_filters(name)
    a = _conv_periodic(x, lo)[..., ::2]
    d = _conv_periodic(x, hi)[..., ::2]
    return a, d


def _stuff(v: torch.Tensor) -> torch.Tensor:
    """Zero-stuff the last axis by 2: out[2i] = v[i], out[2i+1] = 0."""
    return torch.stack([v, torch.zeros_like(v)], dim=-1).flatten(-2)


def idwt_level(a: torch.Tensor, d: torch.Tensor,
               name: str = "haar") -> torch.Tensor:
    """One synthesis level (inverse of dwt_level)."""
    _, _, rec_lo, rec_hi, shift = wavelet_filters(name)
    ua, ud = _stuff(a), _stuff(d)
    # synthesis: periodic correlation with the reconstruction filters
    ya = torch.zeros_like(ua)
    yd = torch.zeros_like(ud)
    for k in range(len(rec_lo)):
        ya = ya + float(rec_lo[k]) * torch.roll(ua, -k, dims=-1)
    for k in range(len(rec_hi)):
        yd = yd + float(rec_hi[k]) * torch.roll(ud, -k, dims=-1)
    y = ya + yd
    return torch.roll(y, shift, dims=-1) if shift else y


def dwt(x: torch.Tensor, name: str = "haar",
        levels: int = 1) -> List[torch.Tensor]:
    """Multi-level DWT: [a_L, d_L, d_{L-1}, ..., d_1] (parity: tod.cc dwt's
    in-place layout, as a coefficient list)."""
    if x.shape[-1] % (1 << levels):
        raise ValueError(
            f"dwt: n={x.shape[-1]} must be a multiple of 2^levels="
            f"{1 << levels} (each periodised level halves the length)")
    coeffs = []
    a = x
    for _ in range(levels):
        a, d = dwt_level(a, name)
        coeffs.append(d)
    return [a] + coeffs[::-1]


def idwt(coeffs: List[torch.Tensor], name: str = "haar") -> torch.Tensor:
    """Inverse multi-level DWT."""
    a = coeffs[0]
    for d in coeffs[1:]:
        a = idwt_level(a, d, name)
    return a


def dwt2(img: torch.Tensor, name: str = "haar"
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-level 2-D DWT: (LL, LH, HL, HH) (parity: 2-D image wavelets,
    tod.cc:500-560)."""
    a, d = dwt_level(img, name)                 # along the last axis
    ll, lh = dwt_level(a.transpose(-1, -2), name)
    hl, hh = dwt_level(d.transpose(-1, -2), name)
    return (ll.transpose(-1, -2), lh.transpose(-1, -2),
            hl.transpose(-1, -2), hh.transpose(-1, -2))


def idwt2(ll, lh, hl, hh, name: str = "haar") -> torch.Tensor:
    a = idwt_level(ll.transpose(-1, -2), lh.transpose(-1, -2), name
                   ).transpose(-1, -2)
    d = idwt_level(hl.transpose(-1, -2), hh.transpose(-1, -2), name
                   ).transpose(-1, -2)
    return idwt_level(a, d, name)
