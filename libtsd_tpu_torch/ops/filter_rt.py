"""Streaming filter runtime, FIR half (PyTorch).

Ported from ``libtsd_tpu/ops/filter_rt.py``.  The FIR is the same banded
Toeplitz product: frame the signal into rows of L = 128 samples, then
``Y[r] = sum_d X[r - d] @ G_d`` with ``G_d[m, i] = h[d L + i - m]``.  On the
GPU these are plain ``torch.matmul`` calls (the JAX package left them to
XLA too); the hand-written FIR kernels are ``ops.kernels.fir`` (1-D) and the
FIR stage of ``ops.kernels.chain``.

Precision tiers of every matmul (``_mm_prec``):

* ``"highest"``: true fp32.  Its matmuls run with
  ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default),
  so a caller that enabled TF32 cannot silently drop it to ~1e-3; the
  caller's setting is restored after each matmul.
* ``"split"``: 3-pass bf16 hi/lo decomposition (a@b ~ ah@bh + al@bh +
  ah@bl), ~1e-5 relative.
* ``"bf16"``: one pass on bf16-rounded operands, ~2.5e-3.

bf16 products are formed exactly in fp32 (bf16 operands rounded, then
multiplied as fp32) and accumulated in fp32, as the MXU does.

Not ported yet: ``DelayLine``, ``Decimator``, ``FirDecim``, ``filtfilt``,
the recursive blocks and ``OlaFft`` (see ROADMAP.md).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from ..block import Block
from ..config import complex_dtype, real_dtype

__all__ = ["fir_toeplitz_mats", "fir_filter", "fir_filter_valid", "Fir",
           "filter_signal"]

_L = 128  # frame size
PRECISIONS = ("highest", "split", "bf16")


def fir_toeplitz_mats(h, L: int = _L):
    """Precompute the banded Toeplitz tap matrices G_d.

    G_d[m, i] = h[d*L + i - m] (0 <= m,i < L), zero outside [0, K).
    Then y[r*L + i] = sum_d sum_m x[(r-d)*L + m] * G_d[m, i].
    h: taps as a tensor (G is a tensor on h's device) or as a numpy array
    (G is a numpy array); G has h's dtype.
    """
    if not isinstance(h, torch.Tensor):
        return fir_toeplitz_mats(torch.as_tensor(np.ascontiguousarray(h)),
                                 L).numpy()
    K = h.shape[0]
    D = (K - 2) // L + 2  # number of diagonal blocks covering lag K-1
    ar = torch.arange(L, device=h.device)
    idx = (torch.arange(D, device=h.device)[:, None, None] * L
           + ar[None, None, :] - ar[None, :, None])
    valid = (idx >= 0) & (idx < K)
    return torch.where(valid, h[idx.clamp(0, K - 1)],
                       torch.zeros((), dtype=h.dtype, device=h.device))


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (round-to-nearest-even) and widen back to fp32."""
    return v.to(torch.bfloat16).to(real_dtype)


@contextlib.contextmanager
def _fp32_matmul():
    """Turn TF32 off for the matmuls inside, then restore the caller's
    setting (even if the matmul raises)."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        yield
    finally:
        flags.allow_tf32 = saved


def _mm_prec(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """Real matmul at a precision tier (see the module docstring)."""
    if prec == "highest":
        with _fp32_matmul():
            return torch.matmul(a, b)
    if prec == "bf16":
        return torch.matmul(_bf16(a), _bf16(b))
    if prec != "split":
        raise ValueError(
            f"precision must be one of {PRECISIONS}, got {prec!r}")
    ah, bh = _bf16(a), _bf16(b)
    al, bl = _bf16(a - ah), _bf16(b - bh)
    return torch.matmul(ah, bh) + torch.matmul(al, bh) + torch.matmul(ah, bl)


def _cmatmul(a: torch.Tensor, b: torch.Tensor,
             prec: str = "highest") -> torch.Tensor:
    """Complex matmul via 4 real matmuls at a precision tier."""
    ar, ai = a.real, a.imag
    br, bi = b.real, b.imag
    rr = _mm_prec(ar, br, prec) - _mm_prec(ai, bi, prec)
    ri = _mm_prec(ar, bi, prec) + _mm_prec(ai, br, prec)
    return torch.complex(rr, ri)


def _fir_frames(xf: torch.Tensor, G: torch.Tensor,
                prec: str = "highest") -> torch.Tensor:
    """Apply the Toeplitz matmul to framed input.

    xf: (..., nf + D - 1, L), including D - 1 history frames in front.
    G:  (D, L, L).  Returns (..., nf, L).

    A complex xf with REAL taps runs as one batched real matmul over
    stacked re/im planes (half the passes of casting G to complex).
    """
    if xf.is_complex() and not G.is_complex():
        planes = torch.stack([xf.real, xf.imag])
        out = _fir_frames(planes, G, prec)
        return torch.complex(out[0], out[1])
    D = G.shape[0]
    nf = xf.shape[-2] - (D - 1)
    out = None
    for d in range(D):
        seg = xf[..., D - 1 - d:D - 1 - d + nf, :]
        if seg.is_complex() or G.is_complex():
            term = _cmatmul(seg.to(complex_dtype), G[d].to(complex_dtype),
                            prec)
        else:
            term = _mm_prec(seg, G[d], prec)
        out = term if out is None else out + term
    return out


def fir_filter(h, x: torch.Tensor) -> torch.Tensor:
    """One-shot FIR, same-length output, zero initial state:
    y[n] = sum_k h[k] x[n-k].  x may have leading batch axes; filtering
    runs along the last axis.  h: host taps (numpy or CPU tensor)."""
    x = torch.as_tensor(x)
    blk = Fir.create(h, device=x.device)
    _, y = blk.step(blk.init_for(x), x)
    return y


def fir_filter_valid(h, x: torch.Tensor) -> torch.Tensor:
    """FIR with 'valid' output: only the len(x)-K+1 samples with full
    overlap."""
    y = fir_filter(h, x)
    return y[..., len(np.asarray(h)) - 1:]


class Fir(Block):
    """Streaming FIR block (Toeplitz-matmul path).

    State: the last K-1 input samples per channel.  Output sample n depends
    on inputs n-K+1..n, so output aligns with input (group delay (K-1)/2
    for linear phase).

    ``G`` is a registered buffer: (D, L, L) float32, or complex64 for
    complex taps.
    """

    def __init__(self, G: torch.Tensor, K: int, precision: str = "highest"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.register_buffer("G", G)
        self.K = int(K)
        self.precision = precision

    @classmethod
    def create(cls, h, precision: str = "highest", device=None) -> "Fir":
        h = np.ascontiguousarray(h)
        cplx = bool(np.iscomplexobj(h))
        G = fir_toeplitz_mats(torch.as_tensor(
            h, dtype=torch.complex128 if cplx else torch.float64))
        G = G.to(device=device,
                 dtype=complex_dtype if cplx else real_dtype)
        return cls(G, K=len(h), precision=precision)

    @property
    def complex_taps(self) -> bool:
        return self.G.is_complex()

    @property
    def tail_state(self) -> bool:
        # state = the last K-1 INPUT samples: the overlap-save contract
        return True

    @property
    def delay(self) -> float:
        return (self.K - 1) / 2

    def init(self):
        dt = complex_dtype if self.complex_taps else real_dtype
        return torch.zeros((self.K - 1,), dtype=dt, device=self.G.device)

    def init_for(self, x: torch.Tensor):
        """State for batched input (leading axes of x)."""
        dt = (complex_dtype if (self.complex_taps or x.is_complex())
              else real_dtype)
        return torch.zeros(tuple(x.shape[:-1]) + (self.K - 1,), dtype=dt,
                           device=self.G.device)

    def step(self, state, x: torch.Tensor):
        n = x.shape[-1]
        D = self.G.shape[0]
        hist = (D - 1) * _L
        # compute dtypes are f32/c64 whatever the input (int ADC samples,
        # float64 host arrays); cat promotes real x to a complex state
        x = x.to(complex_dtype if x.is_complex() else real_dtype)
        xx = torch.cat([state, x], dim=-1)
        # place state (K-1 samples) right before x, pad front to frame align
        xp = F.pad(xx, (hist - (self.K - 1), (-n) % _L))
        xf = xp.reshape(*xp.shape[:-1], -1, _L)
        if self.complex_taps:
            xf = xf.to(complex_dtype)
        yf = _fir_frames(xf, self.G, self.precision)
        y = yf.reshape(*x.shape[:-1], -1)[..., :n]
        # NOT [-(K-1):]: for K=1 that slice is [-0:] = everything
        new_state = xx[..., xx.shape[-1] - (self.K - 1):]
        return new_state, y


def _as_design(h):
    """Normalize a filter spec: taps -> FIR; (b, a) tuple or ZPK -> IIR."""
    if isinstance(h, tuple) and len(h) == 2:
        return "iir"
    if hasattr(h, "to_ba") and hasattr(h, "p"):
        return "iir"
    return "fir"


def filter_signal(h, x: torch.Tensor, mode: str = "direct") -> torch.Tensor:
    """One-shot filtering.  h: FIR taps (direct mode).  IIR designs and
    mode="fft" are not ported yet and raise."""
    if _as_design(h) == "iir":
        raise NotImplementedError(
            "IIR filtering (iir_filter, IirFrame, Sos) is not ported yet: "
            "ROADMAP.md slice 6")
    if mode == "fft":
        raise NotImplementedError(
            "mode='fft' (OlaFft overlap-save) is not ported yet: "
            "ROADMAP.md slice 7")
    if mode != "direct":
        raise ValueError(f"mode must be 'direct' or 'fft', got {mode!r}")
    return fir_filter(h, x)
