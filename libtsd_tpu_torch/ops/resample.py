"""Resampling (PyTorch), ported from ``libtsd_tpu/ops/resample.py``: the
polyphase upsampler and the fractional-delay interpolators that the modem
needs.

* ``FirUps`` -- y[mR + r] = sum_i x[m - i] Hm[i, r]: Kp shifted slices and
  multiply-adds, elementwise fp32 as in the JAX package.
* ``Interpolator`` -- a (nphases + 1, K) table of fractional-delay taps;
  tau is quantised to the nearest of nphases phases (round half to even),
  the convention every clock loop of the package shares.

Not ported yet: ``HalfbandDecim``, ``Cic`` and its design helpers, the
rational and arbitrary-ratio resamplers, ``interp_irregular`` (ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype

__all__ = ["FirUps", "fir_ups_delay", "sinc_interp_coefs", "sinc_interp_lut",
           "cspline_coefs", "cspline_lut", "linear_coefs", "lagrange_coefs",
           "Interpolator", "make_interpolator"]


# ----------------------------------------------------------- upsampling

class FirUps(Block):
    """Polyphase upsampling FIR: insert R-1 zeros and the anti-image filter,
    taps scaled by R to keep the amplitude (parity: FiltreRIFUps,
    polyphase.cc:247-343).  ``Hm`` (Kp, R): Hm[i, r] = R h[i R + r], taps
    zero-padded at the END to a multiple of R."""

    def __init__(self, Hm: torch.Tensor, K: int, R: int, K0: int):
        super().__init__()
        self.register_buffer("Hm", Hm)
        self.K = int(K)      # padded tap count
        self.R = int(R)
        self.K0 = int(K0)    # original tap count

    @classmethod
    def create(cls, h, R: int, device="cuda") -> "FirUps":
        h = np.asarray(h, np.float64) * R
        K0 = len(h)
        if K0 % R:
            h = np.concatenate([h, np.zeros(R - K0 % R)])
        Hm = h.reshape(len(h) // R, R).astype(np.float32)
        return cls(torch.as_tensor(Hm, device=_device(device)), K=len(h),
                   R=R, K0=K0)

    def init(self):
        return torch.zeros((self.Hm.shape[0] - 1,), dtype=real_dtype,
                           device=self.Hm.device)

    def init_for(self, x: torch.Tensor):
        dt = complex_dtype if x.is_complex() else real_dtype
        return torch.zeros(tuple(x.shape[:-1]) + (self.Hm.shape[0] - 1,),
                           dtype=dt, device=self.Hm.device)

    @property
    def ratio(self) -> float:
        return float(self.R)

    @property
    def delay(self) -> float:
        # end-padded taps do not move the peak: (K0 - 1) / 2 output samples
        # (see fir_ups_delay)
        return (self.K0 - 1) / 2.0

    def step(self, state, x):
        n = x.shape[-1]
        Kp = self.Hm.shape[0]
        xx = torch.cat([state, x.to(state.dtype)], dim=-1)

        def branch(xr):
            acc = None
            for i in range(Kp):
                sl = xr[..., Kp - 1 - i:Kp - 1 - i + n]
                t = sl[..., :, None] * self.Hm[i]
                acc = t if acc is None else acc + t
            return acc                        # (..., n, R)

        if xx.is_complex():
            Y = torch.complex(branch(xx.real), branch(xx.imag))
        else:
            Y = branch(xx)
        y = Y.reshape(*x.shape[:-1], n * self.R)
        return xx[..., xx.shape[-1] - (Kp - 1):], y


def fir_ups_delay(nc: int, R: int) -> float:
    """Group delay of FirUps in output samples: (nc - 1) / 2 whatever R,
    since the taps are padded at the end (the reference pads in front,
    polyphase.cc:363-372, and so shifts its peak)."""
    del R
    return (nc - 1) / 2.0


# ------------------------------------------------- fractional interpolators

def sinc_interp_coefs(nc: int, fcut: float, tau: float,
                      fen: str = "hn") -> np.ndarray:
    """Windowed-sinc fractional-delay taps at offset tau in [0, 1] (parity:
    InterpolateurSinc::coefs_calcule, itrp.cc:24-39, with the tau-shifted
    Hann window)."""
    i = np.arange(nc)
    k = i - nc // 2 - tau
    h = 2 * fcut * np.sinc(2 * fcut * k)
    if fen == "hn":
        a, b = 0.5, 0.25
        t = (np.linspace(-(nc // 2), (nc - 1) // 2, nc) - tau) * (2 * np.pi
                                                                  / nc)
        h = h * (a + 2 * b * np.cos(t))
    s = h.sum()
    return h / s if abs(s) > 1e-12 else h


def sinc_interp_lut(nc: int = 15, nphases: int = 256, fcut: float = 0.5,
                    fen: str = "hn") -> np.ndarray:
    """(nphases + 1, nc) table of windowed-sinc taps (parity:
    InterpolateurSinc, itrp.cc:11-57)."""
    return np.stack([sinc_interp_coefs(nc, fcut, p / nphases, fen)
                     for p in range(nphases + 1)])


def cspline_coefs(t: float, c: float = 0.0) -> np.ndarray:
    """Cardinal cubic spline taps on (p-1, p0, p1, p2) (parity:
    cspline_filtre, itrp.cc:293-312; c = 0 is Catmull-Rom)."""
    h = np.array([(1 + 2 * t) * (t - 1) ** 2,
                  t * (t - 1) ** 2,
                  t * t * (3 - 2 * t),
                  t * t * (t - 1)])
    return np.array([-(1 - c) * h[1] / 2,
                     h[0] - (1 - c) * h[3] / 2,
                     h[2] + (1 - c) * h[1] / 2,
                     (1 - c) * h[3] / 2])


def cspline_lut(n: int = 256, c: float = 0.0) -> np.ndarray:
    """(n + 1, 4) spline table (parity: cspline_calc_lut,
    itrp.cc:315-321)."""
    return np.stack([cspline_coefs(i / n, c) for i in range(n + 1)])


def linear_coefs(t: float) -> np.ndarray:
    """Parity: InterpolateurLineaire, itrp.cc:82-95."""
    return np.array([1 - t, t])


def lagrange_coefs(d: int, tau: float) -> np.ndarray:
    """Lagrange interpolator of degree d (K = d + 1 taps) evaluated at
    (d - 1) / 2 + tau (parity: InterpolateurLagrange, itrp.cc:98-140)."""
    t = (d - 1.0) / 2 + tau
    pts = np.arange(d + 1, dtype=float)
    h = np.ones(d + 1)
    for i in range(d + 1):
        for j in range(d + 1):
            if i != j:
                h[i] *= (t - pts[j]) / (pts[i] - pts[j])
    return h


class Interpolator(torch.nn.Module):
    """Phase-table fractional interpolator: taps[phase] . window.

    With w[i] = x[s + i], ``taps(tau) @ w`` evaluates x at s + center + tau,
    center = K - 1 - delay_; when the window ends at the newest sample x[m]
    the output is x(m - delay_ + tau), so ``delay_`` is the causal group
    delay in input samples.  ``lut`` (nphases + 1, K) float32 buffer."""

    def __init__(self, lut: torch.Tensor, K: int, delay_: float):
        super().__init__()
        self.register_buffer("lut", lut)
        self.K = int(K)
        self.delay_ = float(delay_)

    @property
    def nphases(self) -> int:
        return self.lut.shape[0] - 1

    def taps(self, tau: torch.Tensor) -> torch.Tensor:
        """Taps for fractional offsets tau in [0, 1] (any shape)."""
        idx = torch.clamp(torch.round(tau * self.nphases).to(torch.int64),
                          0, self.nphases)
        return self.lut[idx]


def make_interpolator(kind: str = "sinc", device="cuda",
                      **kw) -> Interpolator:
    """Factory (parity: itrp_sinc / itrp_cspline / itrp_lineaire /
    itrp_lagrange, itrp.cc)."""
    nph = kw.get("nphases", 256)
    if kind == "sinc":
        nc = kw.get("ncoefs", 15)
        lut = sinc_interp_lut(nc, nph, kw.get("fcut", 0.5), kw.get("fen", "hn"))
        # kernel centre nc // 2 -> causal delay nc - 1 - nc // 2
        K, delay = nc, nc - 1 - nc // 2
    elif kind == "cspline":
        lut = cspline_lut(nph, kw.get("c", 0.0))
        K, delay = 4, 2.0
    elif kind == "linear":
        lut = np.stack([linear_coefs(i / nph) for i in range(nph + 1)])
        K, delay = 2, 1.0
    elif kind == "lagrange":
        d = kw.get("degree", 3)
        lut = np.stack([lagrange_coefs(d, i / nph) for i in range(nph + 1)])
        # evaluated at (d - 1) / 2 + tau -> causal delay (d + 1) / 2
        K, delay = d + 1, (d + 1) / 2
    else:
        raise ValueError(f"unknown interpolator {kind!r}")
    return Interpolator(torch.as_tensor(np.asarray(lut, np.float32),
                                        device=_device(device)),
                        K=K, delay_=delay)
