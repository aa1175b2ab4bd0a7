"""Welch's passes around kernel #4 (``csrc/welch.cu``), for
``ops.psd.psd_welch`` on the FFT kernel's route.

They replace no TPU kernel: they replace the JAX package's XLA glue around
``libtsd_tpu/ops/pallas/fft.py::fft_pow2`` in its ``psd_welch``.  What
bounds them on the H100 (device memory) and what their design does about
it is set out at the top of ``csrc/welch.cu``.

``welch_frames(x, w, N, nseg)``: x (C, n) float32 or complex64, w (N,)
float32; returns #4's input planes (re, im), (C nseg, N) float32, row
c nseg + s = x[c, s N/2 : s N/2 + N] w (im zeros for real x).

``welch_power(yr, yi, C, nseg, N)``: #4's output planes (C nseg, N) to the
(C, N) Welch PSD in dB: 10 log10(fftshift(sum_s (yr^2 + yi^2) / N) +
1e-30), the orthonormal transform's power summed over segments.  The sum
runs over fixed ranges of segments (:func:`power_ranges`, from the shapes
alone) with no atomics: a call is bit-identical from run to run.
"""
from __future__ import annotations

import torch

from . import _build
from .fft import NMAX, NMIN
from ...utils.monitor import spanned

__all__ = ["welch_frames", "welch_frames_plain", "welch_power",
           "welch_power_plain", "power_ranges"]

# the power pass's blocks a call, about; enough to fill 132 SMs
POWER_BLOCKS = 1024


def _check_n(N: int) -> int:
    if N < NMIN or N > NMAX or N & (N - 1):
        raise ValueError(f"N={N} out of the supported power-of-two range "
                         f"{NMIN}..{NMAX}")
    return N.bit_length() - 1


def _check_rows(C: int, nseg: int) -> None:
    if C < 1 or nseg < 1 or C * nseg >= 2 ** 31:
        raise ValueError(f"need 1 <= C, 1 <= nseg and C nseg < 2^31, got "
                         f"C={C}, nseg={nseg}")


def _check_frames(x: torch.Tensor, w: torch.Tensor, N: int,
                  nseg: int) -> int:
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"x must be (C, n) float32 or complex64, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.is_conj():
        raise ValueError("x is a conjugate view: resolve_conj() it first")
    log2n = _check_n(N)
    if tuple(w.shape) != (N,) or w.dtype != torch.float32:
        raise ValueError(f"w must be ({N},) float32, got {tuple(w.shape)} "
                         f"{w.dtype}")
    _check_rows(x.shape[0], nseg)
    if (nseg + 1) * (N // 2) > x.shape[1]:
        raise ValueError(f"{nseg} segments of {N} at hop {N // 2} need "
                         f"{(nseg + 1) * (N // 2)} samples, x has "
                         f"{x.shape[1]}")
    return log2n


def _check_power(yr: torch.Tensor, yi: torch.Tensor, C: int, nseg: int,
                 N: int) -> int:
    log2n = _check_n(N)
    _check_rows(C, nseg)
    for y in (yr, yi):
        if tuple(y.shape) != (C * nseg, N) or y.dtype != torch.float32:
            raise ValueError(f"planes must both be ({C * nseg}, {N}) "
                             f"float32, got {tuple(y.shape)} {y.dtype}")
    return log2n


def power_ranges(C: int, nseg: int, N: int) -> tuple:
    """(L, P): the power pass cuts each channel's segments into P ranges of
    L (the last may be shorter), so that about ``POWER_BLOCKS`` blocks of
    ``csrc/welch.cu``'s partial kernel (N / 1024 of them a range and
    channel, at least 1) run a call."""
    want = -(-POWER_BLOCKS // (C * max(1, N // 1024)))
    want = max(1, min(nseg, want))
    L = -(-nseg // want)
    return L, -(-nseg // L)


def welch_frames_plain(x: torch.Tensor, w: torch.Tensor, N: int,
                       nseg: int):
    """Plain PyTorch version: the segments as one strided view, times w."""
    _check_frames(x, w, N, nseg)
    seg = x.unfold(-1, N, N // 2)[:, :nseg]
    if x.is_complex():
        return ((seg.real * w).reshape(-1, N),
                (seg.imag * w).reshape(-1, N))
    re = (seg * w).reshape(-1, N)
    return re, torch.zeros_like(re)


@spanned("tsd.kernels.welch_frames")
def welch_frames(x: torch.Tensor, w: torch.Tensor, N: int, nseg: int):
    """#4's input planes of ``nseg`` windowed segments of each row of x at
    hop N/2.  Returns (re, im), each (C nseg, N) float32."""
    log2n = _check_frames(x, w, N, nseg)
    if _build.use_plain(x):
        return welch_frames_plain(x, w, N, nseg)
    if w.data_ptr() % 16:
        w = w.clone()
    rows = x.shape[0] * nseg
    re = torch.empty((rows, N), dtype=torch.float32, device=x.device)
    im = torch.empty_like(re)
    _build.require_cuda(x, w, re, im)
    err = _build.lib().welch_frames_f32(
        _build.ptr(x), _build.ptr(w), _build.ptr(re), _build.ptr(im),
        x.shape[0], x.shape[1], nseg, log2n, int(x.is_complex()),
        _build.stream_ptr(x.device))
    _build.check(err, "welch_frames_f32")
    welch_frames.launches += 1
    return re, im


welch_frames.launches = 0


def welch_power_plain(yr: torch.Tensor, yi: torch.Tensor, C: int, nseg: int,
                      N: int) -> torch.Tensor:
    """Plain PyTorch version: the same sum in PyTorch's order."""
    _check_power(yr, yi, C, nseg, N)
    S = (yr * yr + yi * yi).reshape(C, nseg, N).sum(1) * (1.0 / N)
    return 10.0 * torch.log10(torch.fft.fftshift(S, dim=-1) + 1e-30)


@spanned("tsd.kernels.welch_power")
def welch_power(yr: torch.Tensor, yi: torch.Tensor, C: int, nseg: int,
                N: int) -> torch.Tensor:
    """The (C, N) Welch PSD in dB of #4's output planes (C nseg, N)."""
    log2n = _check_power(yr, yi, C, nseg, N)
    if _build.use_plain(yr):
        return welch_power_plain(yr, yi, C, nseg, N)
    L, P = power_ranges(C, nseg, N)
    part = torch.empty((C, P, N), dtype=torch.float32, device=yr.device)
    out = torch.empty((C, N), dtype=torch.float32, device=yr.device)
    _build.require_cuda(yr, yi, part, out)
    err = _build.lib().welch_power_f32(
        _build.ptr(yr), _build.ptr(yi), _build.ptr(part), _build.ptr(out),
        C, nseg, log2n, L, P, _build.stream_ptr(yr.device))
    _build.check(err, "welch_power_f32")
    welch_power.launches += 1
    return out


welch_power.launches = 0
