"""Kernel #3, the metric kernel: fused FIR -> DFT-4096 -> |X|^2
accumulate (``csrc/chain.cu``).

Replaces ``libtsd_tpu/ops/pallas/chain.py::fir_periodogram4096``,
single-device branch.  What bounds it on the H100 and what its design does
about it is set out at the top of ``csrc/chain_body.cuh``: the FIR of the
bf16 tiers runs on the tensor cores (``mma.sync`` bf16 -> fp32, the JAX
kernel's banded-Toeplitz products), the fp32 one on the FMA pipes, and the
FFT-4096 takes two real frames per complex transform on the
register-resident core ``csrc/fft_reg.cuh``; the FIR output never leaves
shared memory.  The tensor-core tiers with one tap plane (passes 1 and 2:
bf16, int8, int16/2, split/2) with K <= ``K_MAX_WG`` taps take the body
of ``csrc/chain_wg.cu`` instead (:func:`wg_route`): the FIR on ``wgmma``,
issued by two warpgroups on alternate pairs while two others run the FFT
of the pairs before.  ``fir_periodogram4096.wg_launches`` counts the
launches that took it, beside ``launches``.

Tiers (``precision``), as in the JAX package.  x1 = bf16(x), x2 = bf16(x
- x1), x3 = bf16(x - x1 - x2), and h1, h2, h3 likewise from the taps h;
bf16 products summed in fp32 on the tensor cores:

==========  ============  ==============================================
tier        ingest dtype  FIR
==========  ============  ==============================================
highest     float32       fp32 taps and products (FMA pipes)
split       float32       x1 h1 + x2 h1; fir_passes == 3: every xi hj
                          with i + j <= 4
bf16        bfloat16      x1 h1
int8        int8          x1 h1
int16       int16         as split (x3 == 0: x1 + x2 == x exactly)
==========  ============  ==============================================

With ``fir_passes == 2`` (and for bf16 and int8) the taps are
bf16-rounded (round-to-nearest-even) on the host, so h1 == h: the JAX
kernel's arithmetic.  With ``fir_passes == 3`` the JAX kernel sums x1 h1
+ x2 h1 + x1 h2 (~2^-17 relative); the port adds x2 h2, x1 h3 and x3 h1,
which leaves only terms below 2^-24 (x1 + x2 + x3 == x and h1 + h2 + h3
== h exactly), so that tier stays as close to the fp32 plain version as
fp32 arithmetic, frame by frame.  The DFT is fp32, which the JAX fast
tiers round to bf16 on purpose; the port is therefore closer to a float64
reference than the JAX tier it is compared with.  ``tb`` and ``pipe``
(TPU scheduling knobs that do not change results) are not ported.  The
``halo_axis`` form is kernel #11, ``ops.kernels.chain_halo``
(``csrc/chain_halo.cu``), which shares this kernel's two bodies, their
route (:func:`wg_route`) and :func:`kernel_taps`.

:func:`kernel_taps` checks and trims a G once: its result is cached per G
(a weak reference, so the cache never keeps G alive), G's version counter
(an in-place edit of G is checked anew; an edit through ``G.data`` is not
seen), device, tier and pass count.  A call with a cached G makes no host
sync before its launch.

Partial spectra are combined by ``atomicAdd`` (order varies run to run:
~1e-6 relative to the peak against the plain version, not bit-exact).
"""
from __future__ import annotations

import functools
import weakref

import torch

from ...utils.monitor import spanned
from ..filter_rt import _fir_frames, fir_toeplitz_mats
from . import _build
from .fft import twiddles
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


def _passes(precision: str, fir_passes: int) -> int:
    """The kernels' FIR mode: 0 the fp32 FIR ("highest"); 1 x1 h1, 2 x1 h1
    + x2 h1, 3 every x_i h_j with i + j <= 4 on the tensor cores (the
    module docstring)."""
    if precision == "highest":
        return 0
    return 1 if precision in ("bf16", "int8") else fir_passes


K_MAX_WG = 257   # chain_wg::K_MAX: E_MAX = 5 tap blocks of 64


def wg_route(passes: int, K: int) -> bool:
    """True where #3 and #11 run the wgmma body (``csrc/chain_wg.cu``; the
    C entries' ``chain_wg_launch`` and ``chain_wg_halo_launch`` decide the
    same): passes 1 or 2 with at most ``K_MAX_WG`` taps."""
    return passes in (1, 2) and K <= K_MAX_WG


def smem_bytes(passes: int, K: int, sample_bytes: int) -> int:
    """Dynamic shared memory of a fused-chain block, of the body #3 and
    #11 take (``chain_wg::smem_bytes`` in ``csrc/chain_wg.cu`` on
    :func:`wg_route`, else ``chain::smem_bytes`` in
    ``csrc/chain_body.cuh``; keep them in step): passes 0 with K padded
    taps, passes >= 1 with K taps, samples of ``sample_bytes``."""
    if wg_route(passes, K):
        xplane = 8 * 16 * ((256 + 2 * NFFT) // 64 + 1)
        planes = 2 * (NFFT + NFFT // 32) * 8    # two pairs, float2 slots
        return 128 + planes + 5 * 64 * 64 * 2 + 2 * passes * xplane
    planes = 2 * (NFFT + NFFT // 32) * 4
    if passes == 0:
        return planes + (2 * NFFT + K) * 4 + K * 4
    E = (K + 14) // 16 + 1
    words = 32 * ((8 * E + 8 + 31) // 32) + 16 + 8 * E + 8
    rows = (2 * NFFT // 16 + E - 1 + 3) // 4 * 4
    xp = 1 if passes == 1 else 3 if (passes == 3 and sample_bytes == 4) \
        else 2
    stage = (2 * NFFT // 16 + E - 1) * 32 if sample_bytes == 2 else 0
    return (planes + xp * rows * 32 + (3 if passes == 3 else 1) * words * 4
            + stage)


_taps_cache: dict = {}


def _forget(key, ref) -> None:
    hit = _taps_cache.get(key)
    if hit is not None and hit[0] is ref:
        del _taps_cache[key]


def kernel_taps(G: torch.Tensor, precision: str, fir_passes: int,
                device: torch.device | None = None
                ) -> tuple[torch.Tensor, int, int]:
    """(tp, K, passes): the fused kernels' fp32 taps on ``device`` (G's by
    default), trailing zero taps dropped (they cost work), bf16-rounded
    where the tier asks for it; for the fp32 FIR (passes 0) zero-padded to
    K = kp (``pad_taps``).  Raises if G is not Toeplitz or the kernel's
    shared memory cannot hold the taps.  Cached per (G, G's version,
    device, tier, fir_passes): the check and the trim, which sync the host,
    run once per G."""
    rounded = _round_taps(precision, fir_passes)
    device = G.device if device is None else torch.device(device)
    key = (id(G), device, precision, fir_passes)
    hit = _taps_cache.get(key)
    if hit is not None and hit[0]() is G and hit[1] == G._version:
        return hit[2]
    taps = taps_from_G(G)
    nz = torch.nonzero(taps)
    taps = taps[:int(nz[-1, 0]) + 1 if nz.numel() else 1]
    if rounded:
        taps = taps.to(torch.bfloat16).to(torch.float32)
    passes = _passes(precision, fir_passes)
    if passes == 0:
        tp, K = pad_taps(taps)
    else:
        tp, K = taps.contiguous(), taps.shape[0]
    nbytes = {"int8": 1, "int16": 2, "bf16": 2}.get(precision, 4)
    if smem_bytes(passes, K, nbytes) > _build.SMEM_MAX:
        raise ValueError(f"{taps.shape[0]} taps exceed the fused kernel's "
                         f"shared memory")
    val = (tp.to(device), K, passes)
    _taps_cache[key] = (weakref.ref(G, functools.partial(_forget, key)),
                        G._version, val)
    return val


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it if its data is not 16-byte aligned (the kernels
    read 8 samples at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _history(hist0, C: int, D: int, xdt, device) -> torch.Tensor | None:
    H = max(D - 1, 1)
    if hist0 is None:
        return None
    if tuple(hist0.shape) != (C, H, _L):
        raise ValueError(f"hist0 must be {(C, H, _L)}, got "
                         f"{tuple(hist0.shape)}")
    return aligned(hist0.to(device=device, dtype=xdt).contiguous())


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


@spanned("tsd.kernels.fir_periodogram4096")
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
    x = aligned(_ingest(x, precision).contiguous())
    if x.ndim != 2 or x.shape[1] % NFFT:
        raise ValueError(f"x must be (C, N) with N % {NFFT} == 0, got "
                         f"{tuple(x.shape)}")
    C, N = x.shape
    D = G.shape[0]
    tp, K, passes = kernel_taps(G, precision, fir_passes, x.device)
    out = torch.zeros((C, NFFT), dtype=torch.float32, device=x.device)
    if C == 0 or N == 0:
        return out
    h = _history(hist0, C, D, x.dtype, x.device)
    hist_len = (D - 1) * _L if h is not None else 0
    hist = h if h is not None else x          # unread when hist_len == 0
    hist_stride = max(D - 1, 1) * _L
    tw = twiddles(12, x.device)
    _build.require_cuda(x, hist, tp, tw, out)
    err = _build.lib().fir_periodogram4096(
        _build.ptr(x), _build.ptr(hist), _build.ptr(tp), _build.ptr(tw),
        _build.ptr(out), _DTYPE_CODE[x.dtype], passes, N, C, K, hist_len,
        hist_stride, _build.stream_ptr(x.device))
    _build.check(err, "fir_periodogram4096")
    fir_periodogram4096.launches += 1
    fir_periodogram4096.wg_launches += wg_route(passes, K)
    return out


fir_periodogram4096.launches = 0
fir_periodogram4096.wg_launches = 0
