"""Kernel #3, the metric kernel: fused FIR -> DFT-4096 -> |X|^2
accumulate (``csrc/chain.cu``).

Replaces ``libtsd_tpu/ops/pallas/chain.py::fir_periodogram4096``,
single-device branch.  What bounds it on the H100 and what its design does
about it is set out at the top of ``csrc/chain.cu``: 140-570 flop per
byte of input, so FMA issue and shared-memory loads bound it, never device
memory; the FIR output never leaves shared memory.

Tiers (``precision``), as in the JAX package:

==========  ============  =========================================
tier        ingest dtype  taps
==========  ============  =========================================
highest     float32       fp32
split       float32       fp32, or bf16-rounded if fir_passes == 2
bf16        bfloat16      bf16-rounded
int8        int8          bf16-rounded
int16       int16         fp32, or bf16-rounded if fir_passes == 2
==========  ============  =========================================

bf16 rounding of the taps is round-to-nearest-even, once, on the host
side of the launch.  The kernel reads x in the ingest dtype and computes
everything in fp32, including the DFT, which the JAX fast tiers round to
bf16 on purpose; the port is therefore closer to a float64 reference than
the JAX tier it is compared with.  ``tb`` and ``pipe`` (TPU scheduling
knobs that do not change results) are not ported.  The ``halo_axis`` form
is kernel #11, ``ops.kernels.chain_halo`` (``csrc/chain_halo.cu``), which
shares this kernel's body (``csrc/chain_body.cuh``) and :func:`kernel_taps`.

Partial spectra are combined by ``atomicAdd`` (order varies run to run:
~1e-6 relative to the peak against the plain version, not bit-exact).
"""
from __future__ import annotations

import torch

from ..filter_rt import _fir_frames, fir_toeplitz_mats
from . import _build
from .fir import pad_taps
from .periodogram import NFFT, periodogram4096_plain

__all__ = ["fir_periodogram4096", "fir_periodogram4096_plain"]

_L = 128
TIERS = ("highest", "split", "bf16", "int8", "int16")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.int16: 3}


def _ingest(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision not in TIERS:
        raise ValueError(f"precision must be one of {TIERS}, got "
                         f"{precision!r}")
    if precision in ("int8", "int16"):
        want = torch.int8 if precision == "int8" else torch.int16
        if x.dtype != want:
            raise ValueError(f"precision={precision!r} expects {want} input "
                             f"(raw ADC samples), got {x.dtype}")
        return x
    return x.to(torch.bfloat16 if precision == "bf16" else torch.float32)


def _round_taps(precision: str, fir_passes: int) -> bool:
    if fir_passes not in (2, 3):
        raise ValueError(f"fir_passes must be 2 or 3, got {fir_passes}")
    return (precision in ("bf16", "int8")
            or (precision in ("split", "int16") and fir_passes == 2))


def taps_from_G(G: torch.Tensor) -> torch.Tensor:
    """The taps of a banded Toeplitz G (D, 128, 128): G_d[0, i] = h[d L +
    i], so h = G[:, 0, :].reshape(-1)[:(D-1) L + 1], the longest filter
    whose G has D blocks (trailing taps may be zero).  Checks, on G's
    device, that fir_toeplitz_mats(h) reproduces G and raises if it does
    not: the kernel computes the FIR of a true Toeplitz G only."""
    if G.ndim != 3 or G.shape[1:] != (_L, _L) or G.is_complex():
        raise ValueError(f"G must be real (D, {_L}, {_L}), got "
                         f"{tuple(G.shape)} {G.dtype}")
    G = G.to(torch.float32)
    taps = G[:, 0, :].reshape(-1)[:(G.shape[0] - 1) * _L + 1].contiguous()
    if not torch.equal(fir_toeplitz_mats(taps), G):
        raise ValueError("G is not the banded Toeplitz form of any taps "
                         "(fir_toeplitz_mats); the fused kernel cannot run it")
    return taps


def kernel_taps(G: torch.Tensor, precision: str,
                fir_passes: int) -> tuple[torch.Tensor, int]:
    """(tp, kp): the fused kernels' fp32 taps on G's device, trailing zero
    taps dropped (they cost FMAs), bf16-rounded where the tier asks for it,
    zero-padded to kp (``pad_taps``).  Raises if the kernel's shared memory
    cannot hold them."""
    taps = taps_from_G(G)
    nz = torch.nonzero(taps)
    taps = taps[:int(nz[-1, 0]) + 1 if nz.numel() else 1]
    if _round_taps(precision, fir_passes):
        taps = taps.to(torch.bfloat16).to(torch.float32)
    tp, kp = pad_taps(taps)
    smem = (NFFT + NFFT // 16) * 8 + NFFT // 2 * 8 + (2 * kp - 1 + NFFT) * 4
    if smem > _build.SMEM_MAX:
        raise ValueError(f"{taps.shape[0]} taps exceed the fused kernel's "
                         f"shared memory")
    return tp, kp


def _history(hist0, C: int, D: int, xdt, device) -> torch.Tensor | None:
    H = max(D - 1, 1)
    if hist0 is None:
        return None
    if tuple(hist0.shape) != (C, H, _L):
        raise ValueError(f"hist0 must be {(C, H, _L)}, got "
                         f"{tuple(hist0.shape)}")
    return hist0.to(device=device, dtype=xdt).contiguous()


def fir_periodogram4096_plain(x: torch.Tensor, G: torch.Tensor,
                              hist0: torch.Tensor | None = None,
                              precision: str = "highest",
                              fir_passes: int = 3) -> torch.Tensor:
    """Plain PyTorch version: the Toeplitz-matmul FIR at fp32 (bf16-rounded
    taps where the tier asks for them), then the plain periodogram."""
    x = _ingest(x, precision)
    C, N = x.shape
    if N % NFFT:
        raise ValueError(f"N must be a multiple of {NFFT}, got {N}")
    taps = taps_from_G(G)
    if _round_taps(precision, fir_passes):
        taps = taps.to(torch.bfloat16).to(torch.float32)
    D = G.shape[0]
    Geff = fir_toeplitz_mats(taps)
    xf = x.to(torch.float32)
    if D > 1:
        h = _history(hist0, C, D, x.dtype, x.device)
        h = (torch.zeros((C, (D - 1) * _L), device=x.device) if h is None
             else h.reshape(C, -1).to(torch.float32))
        xf = torch.cat([h, xf], dim=-1)
    y = _fir_frames(xf.reshape(C, -1, _L), Geff, "highest").reshape(C, N)
    return periodogram4096_plain(y)


def fir_periodogram4096(x: torch.Tensor, G: torch.Tensor,
                        hist0: torch.Tensor | None = None,
                        precision: str = "highest",
                        fir_passes: int = 3) -> torch.Tensor:
    """x: (C, N), N % 4096 == 0; G: (D, 128, 128) Toeplitz tap matrices
    (fir_toeplitz_mats).  Returns (C, 4096) accumulated power spectra of
    the FIR-filtered signal, natural bin order.

    hist0: optional (C, max(D-1, 1), 128) initial FIR history per channel
    (the last (D-1)*128 input samples preceding x); None = zero state.
    precision / fir_passes: see the module docstring."""
    if _build.use_plain(x):
        return fir_periodogram4096_plain(x, G, hist0, precision, fir_passes)
    x = _ingest(x, precision).contiguous()
    if x.ndim != 2 or x.shape[1] % NFFT:
        raise ValueError(f"x must be (C, N) with N % {NFFT} == 0, got "
                         f"{tuple(x.shape)}")
    C, N = x.shape
    G = G.to(x.device)
    D = G.shape[0]
    tp, kp = kernel_taps(G, precision, fir_passes)
    out = torch.zeros((C, NFFT), dtype=torch.float32, device=x.device)
    if C == 0 or N == 0:
        return out
    h = _history(hist0, C, D, x.dtype, x.device)
    hist_len = (D - 1) * _L if h is not None else 0
    hist = h if h is not None else x          # unread when hist_len == 0
    hist_stride = max(D - 1, 1) * _L
    _build.require_cuda(x, hist, tp, out)
    fpb = _build.frames_per_block(C, N // NFFT, x.device)
    err = _build.lib().fir_periodogram4096(
        _build.ptr(x), _build.ptr(hist), _build.ptr(tp), _build.ptr(out),
        _DTYPE_CODE[x.dtype], N, C, kp, hist_len, hist_stride, fpb,
        _build.stream_ptr(x.device))
    _build.check(err, "fir_periodogram4096")
    fir_periodogram4096.launches += 1
    return out


fir_periodogram4096.launches = 0
