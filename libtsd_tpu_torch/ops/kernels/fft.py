"""Kernel #4: batched complex power-of-two FFT on planes (``csrc/fft.cu``).

Replaces ``libtsd_tpu/ops/pallas/fft.py::fft_pow2`` / ``ifft_pow2``.  What
bounds it on the H100 and what its design does about it is set out at the
top of ``csrc/fft.cu``: ~3.75 flop per byte, so the FFT is memory-bound;
it runs on the register-resident core of ``csrc/fft_reg.cuh``, whose
twiddle table :func:`twiddles` makes once per (n, device).

``fft_pow2(xr, xi)`` keeps the JAX package's planes interface, (B, nfft)
float32 re/im in and out, nfft a power of two in 256..16384.  The inverse
scales by 1/nfft.  :class:`FftPow2` wraps it for complex tensors with a
backward that runs the same kernel in the other direction (the JAX package
gives this path a VJP).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build
from ...utils.monitor import spanned

__all__ = ["fft_pow2", "ifft_pow2", "fft_pow2_plain", "FftPow2",
           "twiddle_plan", "twiddle_table", "twiddles"]

NMIN, NMAX = 256, 16384
_tables: dict = {}


def twiddle_plan(log2n: int) -> list:
    """The passes of ``csrc/fft_reg.cuh`` for n = 2^log2n, in order, as
    (log2 M, log2 R, table offset): a first pass of radix 2^(log2n % 4)
    when log2n % 4 != 0, then radix-16 passes down to M = 16.  The last
    pass has no twiddles (its offset is the table's length)."""
    passes, m = [], log2n
    if log2n & 3:
        passes.append((m, log2n & 3))
        m -= log2n & 3
    while m >= 4:
        passes.append((m, 4))
        m -= 4
    out, off = [], 0
    for mL, rL in passes:
        out.append((mL, rL, off))
        if mL > 4:
            off += ((1 << rL) - 1) << (mL - rL)
    return out


def twiddle_table(log2n: int) -> np.ndarray:
    """complex128: for each pass but the last, T[k - 1][t] = W_M^(t k)
    (k = 1..R-1, t < M/R, t fastest), concatenated in pass order."""
    parts = []
    for mL, rL, _ in twiddle_plan(log2n)[:-1]:
        k = np.arange(1, 1 << rL)[:, None]
        t = np.arange(1 << (mL - rL))[None, :]
        parts.append(np.exp(-2j * np.pi * (t * k) / (1 << mL)).ravel())
    return np.concatenate(parts)


def twiddles(log2n: int, device: torch.device) -> torch.Tensor:
    """``twiddle_table`` on ``device`` as (entries, 2) float32 (float64
    rounded once), made once per (n, device)."""
    key = (log2n, torch.device(device))
    if key not in _tables:
        tw = twiddle_table(log2n).astype(np.complex64)
        _tables[key] = torch.from_numpy(tw.view(np.float32).reshape(-1, 2)) \
            .to(device)
    return _tables[key]


def _check(xr: torch.Tensor, xi: torch.Tensor, precision: str) -> int:
    if precision not in ("highest", "split"):
        raise ValueError(f"precision must be 'highest' or 'split', got "
                         f"{precision!r}")
    if xr.shape != xi.shape or xr.ndim != 2:
        raise ValueError(f"planes must both be (B, nfft), got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    n = xr.shape[1]
    if n < NMIN or n > NMAX or n & (n - 1):
        raise ValueError(f"nfft={n} out of the supported power-of-two range "
                         f"{NMIN}..{NMAX}")
    return n


def fft_pow2_plain(xr: torch.Tensor, xi: torch.Tensor, inverse: bool = False,
                   precision: str = "highest"):
    """Plain PyTorch version: torch.fft.fft / ifft on the planes."""
    _check(xr, xi, precision)
    z = torch.complex(xr.to(torch.float32), xi.to(torch.float32))
    y = torch.fft.ifft(z, dim=-1) if inverse else torch.fft.fft(z, dim=-1)
    return y.real.contiguous(), y.imag.contiguous()


@spanned("tsd.kernels.fft_pow2")
def fft_pow2(xr: torch.Tensor, xi: torch.Tensor, inverse: bool = False,
             precision: str = "highest"):
    """Batched nfft-point (I)FFT of complex data given as re/im planes.
    Returns (yr, yi), same shape, natural bin order.  precision: "highest"
    or "split" (the JAX tiers); both run in fp32 here."""
    n = _check(xr, xi, precision)
    if _build.use_plain(xr):
        return fft_pow2_plain(xr, xi, inverse, precision)
    xr = xr.to(torch.float32).contiguous()
    xi = xi.to(torch.float32).contiguous()
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)
    B = xr.shape[0]
    if B == 0:
        return yr, yi
    _build.require_cuda(xr, xi, yr, yi)
    log2n = n.bit_length() - 1
    tw = twiddles(log2n, xr.device)
    err = _build.lib().fft_pow2_f32(
        _build.ptr(xr), _build.ptr(xi), _build.ptr(yr), _build.ptr(yi),
        _build.ptr(tw), B, log2n, int(inverse), _build.stream_ptr(xr.device))
    _build.check(err, "fft_pow2_f32")
    fft_pow2.launches += 1
    return yr, yi


fft_pow2.launches = 0


def ifft_pow2(xr: torch.Tensor, xi: torch.Tensor, **kw):
    return fft_pow2(xr, xi, inverse=True, **kw)


def _complex_call(z: torch.Tensor, inverse: bool) -> torch.Tensor:
    yr, yi = fft_pow2(z.real.contiguous(), z.imag.contiguous(), inverse)
    return torch.complex(yr, yi)


class FftPow2(torch.autograd.Function):
    """Differentiable FFT of a complex (B, nfft) tensor through kernel #4.

    y = F x has the adjoint F^H g = nfft * ifft(g); y = ifft(x) = F^H x /
    nfft has the adjoint F g / nfft.  PyTorch's complex gradients are
    conjugate Wirtinger, so backward returns exactly that adjoint."""

    @staticmethod
    def forward(ctx, z: torch.Tensor, inverse: bool) -> torch.Tensor:
        ctx.inverse = inverse
        return _complex_call(z, inverse)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        n = g.shape[-1]
        scale = (1.0 / n) if ctx.inverse else float(n)
        grad = _complex_call(g.to(torch.complex64), not ctx.inverse) * scale
        return grad, None
