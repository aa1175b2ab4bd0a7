"""Kernel #2: framed 4096-point periodogram (``csrc/periodogram.cu``).

Replaces ``libtsd_tpu/ops/pallas/periodogram.py::periodogram4096_acc``.
What bounds it on the H100 and what its design does about it is set out
at the top of ``csrc/periodogram.cu``: ~15 flop per byte read, so a fast
version would be near the memory bound; this simple one is held by the
shared-memory passes and barriers of its radix-16 FFT.

Partial spectra of the blocks that share a channel are combined with
``atomicAdd``, whose order changes from run to run: results agree with the
plain version to float32 rounding of the sum (~1e-6 relative to the peak),
not bit for bit.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["periodogram4096_acc", "periodogram4096_plain"]

NFFT = 4096


def _check(y: torch.Tensor, precision: str) -> None:
    if precision not in ("highest", "split"):
        raise ValueError(f"precision must be 'highest' or 'split', got "
                         f"{precision!r}")
    if y.ndim != 2 or y.shape[1] % NFFT:
        raise ValueError(f"y must be (C, N) with N % {NFFT} == 0, got "
                         f"{tuple(y.shape)}")


def periodogram4096_plain(y: torch.Tensor,
                          precision: str = "highest") -> torch.Tensor:
    """Plain PyTorch version: torch.fft on the frames, |X|^2, summed."""
    _check(y, precision)
    C, N = y.shape
    X = torch.fft.fft(y.to(torch.float32).reshape(C, N // NFFT, NFFT), dim=-1)
    return torch.view_as_real(X).square().sum(dim=(1, 3))


def periodogram4096_acc(y: torch.Tensor,
                        precision: str = "highest") -> torch.Tensor:
    """y: (C, N) float32, N % 4096 == 0 -> (C, 4096) sum over the N/4096
    frames of the unnormalized |FFT|^2, natural bin order.

    precision: "highest" or "split" (the JAX tiers); both are computed in
    fp32 here, which is at least as accurate as either."""
    _check(y, precision)
    if _build.use_plain(y):
        return periodogram4096_plain(y, precision)
    y = y.to(torch.float32).contiguous()
    C, N = y.shape
    out = torch.zeros((C, NFFT), dtype=torch.float32, device=y.device)
    if C == 0 or N == 0:
        return out
    _build.require_cuda(y, out)
    fpb = _build.frames_per_block(C, N // NFFT, y.device)
    err = _build.lib().periodogram4096_f32(
        _build.ptr(y), _build.ptr(out), C, N, fpb,
        _build.stream_ptr(y.device))
    _build.check(err, "periodogram4096_f32")
    periodogram4096_acc.launches += 1
    return out


periodogram4096_acc.launches = 0
