"""Kernel #4: batched complex power-of-two FFT on planes (``csrc/fft.cu``).

Replaces ``libtsd_tpu/ops/pallas/fft.py::fft_pow2`` / ``ifft_pow2``.  What
bounds it on the H100 and what its design does about it is set out at the
top of ``csrc/fft.cu``: 2.5-4.4 flop per byte, so a fast FFT is
memory-bound; this simple one (radix-16 passes in shared memory, one block
per transform) is not there yet.

``fft_pow2(xr, xi)`` keeps the JAX package's planes interface, (B, nfft)
float32 re/im in and out, nfft a power of two in 256..16384.  The inverse
scales by 1/nfft.  :class:`FftPow2` wraps it for complex tensors with a
backward that runs the same kernel in the other direction (the JAX package
gives this path a VJP).
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["fft_pow2", "ifft_pow2", "fft_pow2_plain", "FftPow2"]

NMIN, NMAX = 256, 16384


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
    err = _build.lib().fft_pow2_f32(
        _build.ptr(xr), _build.ptr(xi), _build.ptr(yr), _build.ptr(yi), B,
        n.bit_length() - 1, int(inverse), _build.stream_ptr(xr.device))
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
