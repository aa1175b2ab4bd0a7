"""Kernel #8: the fused FM broadcast receiver chain (``csrc/fm.cu``).

Replaces ``libtsd_tpu/ops/pallas/fm.py`` (``FmChainPallas`` and its
``_fm_chain``): NCO mix to baseband -> channel-select lowpass and
decimation by R -> quadrature discriminator -> de-emphasis, in one pass.
:class:`FmChain` keeps the JAX class's constructor, its (xr, xi) float32
planes in and (C, N // R) audio out, its ``tb``, its divisibility and
history checks, and its zero state at the start of every call; the audio
scale is ``FmReceiver``'s (d / (2 pi deviation), de-emphasised).  What
bounds the kernel and what its design does about it is set out at the top
of ``csrc/fm.cu``.

The JAX kernel's polynomial ``_atan2_poly`` stood in for Mosaic's missing
atan2 and is not ported: the kernel calls ``atan2f``, the plain version
``torch.atan2``.  Both form z[q] conj(z[q-1]) as a complex product, so
that the first output, against the zero sample before the call, is
``FmReceiver``'s.

A wrapper given CPU tensors runs the plain version (:func:`fm_chain_plain`:
the phase in float64 cycles, the FIR as a sum over the taps, the
de-emphasis by the log-depth scan of ``filter_rt``); given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...config import device as _device, real_dtype
from ..filter_rt import _first_order_scan
from . import _build

__all__ = ["fir_decim_toeplitz_mats", "FmChain", "fm_chain",
           "fm_chain_plain", "fm_fir_plain"]

_L = 128
_Q = 1024          # outputs per block of the kernel


def fir_decim_toeplitz_mats(h: np.ndarray, R: int, L: int = _L
                            ) -> Tuple[np.ndarray, int]:
    """Strided banded-Toeplitz factors for FIR + decimate-by-R (a copy of
    the JAX package's; the port's kernel uses only ``r_max``, its history
    in frames).

    y[q L + i] = sum_r sum_u x[(q R - r) L + u] G[r][u, i] with G[r][u, i] =
    h[r L + i R - u] (zero outside [0, K)), r from r_min = -floor((L - 1) R
    / L) to r_max = floor((K + L - 2) / L).  Returns (G[j] for j = r -
    r_min, r_max)."""
    h = np.asarray(h, np.float64)
    K = len(h)
    r_min = -(((L - 1) * R) // L)
    r_max = (K + L - 2) // L
    Dr = r_max - r_min + 1
    G = np.zeros((Dr, L, L), np.float32)
    u = np.arange(L)[:, None]
    i = np.arange(L)[None, :]
    for j, r in enumerate(range(r_min, r_max + 1)):
        idx = r * L + i * R - u
        valid = (idx >= 0) & (idx < K)
        G[j] = np.where(valid, h[np.clip(idx, 0, K - 1)], 0.0)
    return G, r_max


class FmChain:
    """Fused FM receiver chain (the JAX package's ``FmChainPallas``), on
    ``device``: ``chain(xr, xi, tb=32)`` maps (C, N) float32 planes to
    (C, N // R) audio, from zero state."""

    def __init__(self, channel_freq: float, decim: int, chan_taps: int,
                 deviation: float, deemph_fc: float,
                 chan_h: Optional[np.ndarray] = None, device="cuda"):
        from ..fir_design import fir_design_windowed
        from ..iir_design import design_lexp
        R = int(decim)
        if chan_h is None:
            chan_h = np.asarray(
                fir_design_windowed(chan_taps, "lp", 0.4 / R, "hn"))
        _, r_max = fir_decim_toeplitz_mats(chan_h, R)
        self.hist = max(r_max, 1)
        if deemph_fc > 0:
            b, a = design_lexp(deemph_fc)
        else:
            b, a = np.array([1.0, 0.0]), np.array([1.0, 0.0])
        b = np.pad(np.asarray(b, np.float64), (0, 2))[:2] / a[0]
        a = np.pad(np.asarray(a, np.float64), (0, 2))[:2] / a[0]
        # transposed order-1 form: y = b0 d + w_prev, w = p w_prev + c d
        self.b0 = float(b[0])
        self.p = float(-a[1])
        self.c = float(b[1] - a[1] * b[0])
        self.h = torch.as_tensor(np.asarray(chan_h, np.float32),
                                 device=_device(device))
        self.f0 = float(channel_freq)
        self.R = R
        self.dev = float(deviation)

    def __call__(self, xr: torch.Tensor, xi: torch.Tensor,
                 tb: int = 32) -> torch.Tensor:
        """xr/xi: (C, N) float32 planes, N % (tb * 128 * R) == 0.  Returns
        audio (C, N // R) float32."""
        if tb * self.R < self.hist:
            raise ValueError(
                f"chunk too small for the channel filter: tb*R = "
                f"{tb * self.R} input frames/step < history {self.hist} "
                f"(~ceil((len(chan_h)-1)/128) frames) -- raise tb or "
                f"shorten chan_h")
        return fm_chain(xr, xi, self.h, R=self.R, f0=self.f0, dev=self.dev,
                        b0=self.b0, c=self.c, p=self.p, tb=tb)


def _check(xr, xi, h, R: int, tb: int):
    if xr.shape != xi.shape or xr.ndim != 2:
        raise ValueError(f"xr and xi must be (C, N) alike, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    C, N = xr.shape
    chunk = tb * _L * R
    if N % chunk:
        raise ValueError(f"N must be a multiple of {chunk} (tb * 128 * R), "
                         f"got {N}")
    if h.ndim != 1:
        raise ValueError(f"h must be 1-D, got {tuple(h.shape)}")
    return C, N


def fm_fir_plain(xr, xi, h, *, R: int, f0: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's first half, plain: the mix (phase in float64 cycles) and
    the FIR decimated by R, z[q] = sum_k h[k] b[R q - k] with the taps in
    ascending order.  Returns (zr, zi), each (C, N // R)."""
    C, N = xr.shape
    K = h.shape[0]
    n = torch.arange(N, dtype=torch.float64, device=xr.device)
    ph = torch.remainder(f0 * n, 1.0)
    cs = torch.cos(2 * np.pi * ph).to(real_dtype)
    sn = torch.sin(2 * np.pi * ph).to(real_dtype)
    xr, xi = xr.to(real_dtype), xi.to(real_dtype)
    br = xr * cs + xi * sn
    bi = xi * cs - xr * sn
    nout = N // R
    zr = torch.zeros((C, nout), dtype=real_dtype, device=xr.device)
    zi = torch.zeros_like(zr)
    bpr = torch.nn.functional.pad(br, (K - 1, 0))
    bpi = torch.nn.functional.pad(bi, (K - 1, 0))
    hs = h.to(real_dtype)
    for k in range(K):       # z[q] += h[k] b[R q - k], taps ascending
        zr = zr + hs[k] * bpr[:, K - 1 - k::R][:, :nout]
        zi = zi + hs[k] * bpi[:, K - 1 - k::R][:, :nout]
    return zr, zi


def fm_chain_plain(xr, xi, h, *, R: int, f0: float, dev: float, b0: float,
                   c: float, p: float, tb: int = 32) -> torch.Tensor:
    """Plain PyTorch version of :func:`fm_chain`."""
    _check(xr, xi, h, R, tb)
    zr, zi = fm_fir_plain(xr, xi, h, R=R, f0=f0)
    pr = torch.nn.functional.pad(zr[:, :-1], (1, 0))
    pi = torch.nn.functional.pad(zi[:, :-1], (1, 0))
    pin = -pi
    # z conj(z_prev) as a complex product
    wr = zr * pr - zi * pin
    wi = zr * pin + zi * pr
    d = torch.atan2(wi, wr) / (2 * np.pi * dev)
    w = _first_order_scan(p, c * d, 0.0)
    return b0 * d + torch.nn.functional.pad(w[:, :-1], (1, 0))


def fm_chain(xr: torch.Tensor, xi: torch.Tensor, h: torch.Tensor, *, R: int,
             f0: float, dev: float, b0: float, c: float, p: float,
             tb: int = 32) -> torch.Tensor:
    """The fused chain on (C, N) float32 planes with channel taps h (K,),
    decimation R, channel frequency f0 (cycles a sample), deviation dev and
    the de-emphasis y = b0 d + w_prev, w = p w_prev + c d.  Returns (C,
    N // R) audio."""
    C, N = _check(xr, xi, h, R, tb)
    if _build.use_plain(xr):
        return fm_chain_plain(xr, xi, h, R=R, f0=f0, dev=dev, b0=b0, c=c,
                              p=p, tb=tb)
    xr = xr.to(real_dtype).contiguous()
    xi = xi.to(real_dtype).contiguous()
    hc = h.to(real_dtype).contiguous()
    nout = N // R
    y = torch.empty((C, nout), dtype=real_dtype, device=xr.device)
    if C and N:
        nchunk = -(-nout // _Q)
        # the chained scan's status words and its ticket counter, zeroed
        scratch = torch.zeros(C * nchunk + 1, dtype=torch.int64,
                              device=xr.device)
        _build.require_cuda(xr, xi, hc, y, scratch)
        err = _build.lib().fm_chain_f32(
            _build.ptr(xr), _build.ptr(xi), _build.ptr(hc), _build.ptr(y),
            _build.ptr(scratch), C, N, R, hc.shape[0], float(f0),
            float(np.float32(2 * np.pi * dev)), b0, c, p,
            _build.stream_ptr(xr.device))
        _build.check(err, "fm_chain_f32")
        fm_chain.launches += 1
    return y


fm_chain.launches = 0
