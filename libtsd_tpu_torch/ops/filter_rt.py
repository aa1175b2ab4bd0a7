"""Streaming filter runtime (PyTorch).

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

``MovingAverage`` (the detector's window energy) and the overlap FFT block
``OlaFft``/``FirFft`` are ported too.  ``OlaFft`` has two engines: "torch"
(the JAX package's "xla": ``torch.fft`` overlap-add, state = the carried
output residue) and "cuda" (the JAX package's "pallas": kernel #9,
overlap-save, state = the last V inputs, ``tail_state`` True).

The recursive half: ``ExpSmoother``, ``DcBlocker`` and order-1 ``Iir`` solve
their first-order recursion by log-depth doubling (``_first_order_scan``:
ceil(log2 n) passes of shifted multiply-add, the JAX package's
``lax.associative_scan``); never by a cumprod/cumsum divide, whose a^-n
overflows float32 within a few hundred samples at a pole of 0.73.
``IirFrame`` restates the recursion over 128-sample frames as the same
exact state-space algebra as the JAX package (``_iir_frame_mats``), the
frame-to-frame state hop again by doubling (``_affine_matrix_scan``, k x k
matmuls).  ``Iir`` of order >= 2 and ``Sos`` run a Python loop over the
samples (the JAX package's ``lax.scan``): right, but only for test sizes.
The fused SOS cascade on the card is kernel #7 (``ops.kernels.iir``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype

__all__ = ["fir_toeplitz_mats", "fir_filter", "fir_filter_valid", "Fir",
           "DelayLine", "Decimator", "FirDecim", "MovingAverage", "OlaFft",
           "FirFft", "OLA_ENGINES", "ExpSmoother", "DcBlocker", "Iir",
           "IirFrame", "iir_filter", "sos_frame_chain", "Sos", "filter_signal",
           "filtfilt"]

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
    def create(cls, h, precision: str = "highest",
               device="cuda") -> "Fir":
        device = _device(device)
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


class DelayLine(Block):
    """Integer delay of d samples (parity: LigneARetard,
    filtre-rt.cc:13-46).  State: the last d input samples."""

    def __init__(self, d: int, dtype=real_dtype, device="cuda"):
        super().__init__()
        self.d = int(d)
        self.dtype = dtype
        self.device = _device(device)

    def init(self):
        return torch.zeros((self.d,), dtype=self.dtype, device=self.device)

    @property
    def delay(self) -> float:
        return float(self.d)

    def step(self, state, x):
        if self.d == 0:
            return state, x
        xx = torch.cat([state, x], dim=-1)
        return xx[..., -self.d:], xx[..., :x.shape[-1]]


class Decimator(Block):
    """Keep 1 sample in R with the phase carried across blocks (parity:
    Decimateur, filtre-rt.cc:120-170).  The block length must be a multiple
    of R, so the phase never changes and the output shape is fixed."""

    def __init__(self, R: int):
        super().__init__()
        self.R = int(R)

    def init(self):
        return 0     # index of the next kept sample

    @property
    def ratio(self) -> float:
        return 1.0 / self.R

    def step(self, state, x):
        n = x.shape[-1]
        if n % self.R:
            raise ValueError("block length must be a multiple of R")
        xf = x.reshape(*x.shape[:-1], n // self.R, self.R)
        return state, xf[..., int(state)]


class FirDecim(Block):
    """Polyphase decimating FIR: filter and keep 1 in R, computing only the
    kept outputs (parity: FiltreRIFDecim, polyphase.cc:157-245).

    ``P`` (Kp, R) holds the polyphase taps, P[j, r] = h[j R + r].  The
    state is the last Kp R input samples.  y[m] = sum_k h[k] x[mR - k]:
    the input framed as rows of R samples, reversed within the row, gives
    z[t, r] = x[(t - Kp + 1) R - r] and each lag j is a static row slice
    of z dotted with P[j], in fp32 (the JAX package's HIGHEST einsum)."""

    def __init__(self, P: torch.Tensor, K: int, R: int):
        super().__init__()
        self.register_buffer("P", P)
        self.K = int(K)
        self.R = int(R)

    @classmethod
    def create(cls, h, R: int, device="cuda") -> "FirDecim":
        h = np.asarray(h, np.float64)
        K = len(h)
        Kp = (K + R - 1) // R
        P = np.zeros(Kp * R)
        P[:K] = h
        return cls(torch.as_tensor(P.reshape(Kp, R), dtype=real_dtype,
                                   device=_device(device)), K=K, R=R)

    def init(self):
        return torch.zeros((self.P.shape[0] * self.R,), dtype=real_dtype,
                           device=self.P.device)

    def init_for(self, x: torch.Tensor):
        dt = complex_dtype if x.is_complex() else real_dtype
        return torch.zeros(tuple(x.shape[:-1]) + (self.P.shape[0] * self.R,),
                           dtype=dt, device=self.P.device)

    @property
    def ratio(self) -> float:
        return 1.0 / self.R

    @property
    def delay(self) -> float:
        return (self.K - 1) / 2 / self.R

    def step(self, state, x):
        n = x.shape[-1]
        R = self.R
        if n % R:
            raise ValueError("block length must be a multiple of R")
        Kp = self.P.shape[0]
        xx = torch.cat([state, x.to(state.dtype)], dim=-1)
        nout = n // R
        Text = nout + Kp - 1
        Fr = xx[..., 1:1 + Text * R].reshape(*xx.shape[:-1], Text, R)
        Fr = Fr.flip(-1)

        def accum(fr):
            y = None
            for j in range(Kp):
                seg = fr[..., Kp - 1 - j:Kp - 1 - j + nout, :]
                with _fp32_matmul():
                    term = torch.matmul(seg, self.P[j])
                y = term if y is None else y + term
            return y

        if Fr.is_complex():
            y = torch.complex(accum(Fr.real.contiguous()),
                              accum(Fr.imag.contiguous()))
        else:
            y = accum(Fr)
        return xx[..., xx.shape[-1] - Kp * R:], y


class MovingAverage(Block):
    """K-sample moving average with double accumulation (parity:
    MoyenneGlissante, filtre-rt.cc:634-724): a float32 cumsum difference
    per block with the last K - 1 inputs carried, as the JAX package
    computes it.  The detector's "torch" and "cuda" engines take their
    window energy from it."""

    def __init__(self, K: int, device="cuda"):
        super().__init__()
        self.K = int(K)
        self.device = _device(device)

    def init(self):
        return torch.zeros((self.K - 1,), dtype=real_dtype,
                           device=self.device)

    def init_for(self, x: torch.Tensor):
        dt = complex_dtype if x.is_complex() else real_dtype
        return torch.zeros(tuple(x.shape[:-1]) + (self.K - 1,), dtype=dt,
                           device=self.device)

    @property
    def delay(self) -> float:
        return (self.K - 1) / 2

    def step(self, state, x):
        xx = torch.cat([state, x.to(state.dtype)], dim=-1)
        c = torch.cumsum(xx.to(complex_dtype if xx.is_complex()
                               else real_dtype), dim=-1)
        c = F.pad(c, (1, 0))
        y = (c[..., self.K:] - c[..., :-self.K]) / self.K
        # xx.shape-based slice: [-(K-1):] would be [-0:] for K = 1
        return xx[..., xx.shape[-1] - (self.K - 1):], y.to(x.dtype)


class ExpSmoother(Block):
    """First-order exponential smoother y = g x + (1 - g) y_prev (parity:
    FiltreLExp, filtre-rt.cc:726-780).  State: the last output."""

    def __init__(self, g: float, device="cuda"):
        super().__init__()
        self.register_buffer("g", torch.tensor(g, dtype=real_dtype,
                                               device=_device(device)))

    @classmethod
    def create(cls, gamma: float, device="cuda") -> "ExpSmoother":
        return cls(gamma, device=device)

    def init(self):
        return torch.zeros((), dtype=real_dtype, device=self.g.device)

    def step(self, state, x):
        y = _first_order_scan(1.0 - self.g, self.g * x, state)
        return y[..., -1], y


class DcBlocker(Block):
    """DC blocker y[n] = r ((x[n] - x[n-1]) + y[n-1]) (parity: FiltreDC,
    filtre-rt.cc:605-633).  State: (previous input, previous output)."""

    def __init__(self, r: float, device="cuda"):
        super().__init__()
        self.register_buffer("r", torch.tensor(r, dtype=real_dtype,
                                               device=_device(device)))

    @classmethod
    def create(cls, fc: float, device="cuda") -> "DcBlocker":
        from .iir_design import lexp_coef
        return cls(1.0 - lexp_coef(fc), device=device)

    def init(self):
        z = torch.zeros((), dtype=real_dtype, device=self.r.device)
        return (z, z.clone())

    def step(self, state, x):
        x_prev, y_prev = state
        xd = x - torch.cat([x_prev[..., None].expand(
                                tuple(x.shape[:-1]) + (1,)),
                            x[..., :-1]], dim=-1)
        # seeded with y_prev itself: y[0] = r y_prev + r xd[0]
        y = _first_order_scan(self.r, self.r * xd, y_prev)
        return (x[..., -1], y[..., -1]), y


def _first_order_scan(a, b: torch.Tensor, y0) -> torch.Tensor:
    """Solve y[n] = a y[n-1] + b[n] along the last axis with y[-1] = y0,
    by log-depth doubling: after the pass of shift s, y[n] holds the sum
    over the last 2s terms and the multiplier a^(2s) (the JAX package's
    associative scan with (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2)).
    ``a`` is a scalar (number or 0-d tensor); no cumprod divide."""
    n = b.shape[-1]
    a = torch.as_tensor(a, dtype=b.dtype, device=b.device)
    y = b.clone()
    y[..., :1] = y[..., :1] + a * torch.as_tensor(y0, device=b.device)[
        ..., None]
    m = a
    s = 1
    while s < n:
        y = torch.cat([y[..., :s], y[..., s:] + m * y[..., :-s]], dim=-1)
        m = m * m
        s *= 2
    return y


class Iir(Block):
    """Transposed direct-form-II IIR from (b, a) (parity: FiltreRII,
    filtre-rt.cc:178-284).  Order 0 is a gain, order 1 the log-depth
    scan, order >= 2 a Python loop over the samples.  State: the k delay
    elements."""

    def __init__(self, b: torch.Tensor, a: torch.Tensor):
        super().__init__()
        self.register_buffer("b", b)
        self.register_buffer("a", a)

    @classmethod
    def create(cls, b, a, device="cuda") -> "Iir":
        device = _device(device)
        b = np.atleast_1d(np.asarray(b, np.float64))
        a = np.atleast_1d(np.asarray(a, np.float64))
        b, a = b / a[0], a / a[0]
        n = max(len(b), len(a))
        b = np.pad(b, (0, n - len(b)))
        a = np.pad(a, (0, n - len(a)))
        return cls(torch.as_tensor(b, dtype=real_dtype, device=device),
                   torch.as_tensor(a, dtype=real_dtype, device=device))

    @property
    def order(self) -> int:
        return self.b.shape[0] - 1

    def init(self):
        return torch.zeros((self.order,), dtype=real_dtype,
                           device=self.b.device)

    def init_for(self, x: torch.Tensor):
        dt = complex_dtype if x.is_complex() else real_dtype
        return torch.zeros(tuple(x.shape[:-1]) + (self.order,), dtype=dt,
                           device=self.b.device)

    def step(self, state, x):
        order = self.order
        if order == 0:
            return state, self.b[0] * x
        if order == 1:
            # y[n] = b0 x[n] + w[n-1]; w[n] = -a1 w[n-1] + (b1 - a1 b0) x[n]
            b0, b1, a1 = self.b[0], self.b[1], self.a[1]
            w = _first_order_scan(-a1, (b1 - a1 * b0) * x, state[..., 0])
            wprev = torch.cat([state[..., 0:1].expand(
                tuple(x.shape[:-1]) + (1,)), w[..., :-1]], dim=-1)
            return w[..., -1:], b0 * x + wprev
        return self._scan_step(state, x)

    def _scan_step(self, state, x):
        b, a = self.b, self.a
        w = state
        ys = []
        for i in range(x.shape[-1]):
            xn = x[..., i]
            yn = b[0] * xn + w[..., 0]
            w = (torch.cat([w[..., 1:], torch.zeros_like(w[..., :1])], dim=-1)
                 + b[1:] * xn[..., None] - a[1:] * yn[..., None])
            ys.append(yn)
        return w, torch.stack(ys, dim=-1)


def _iir_frame_mats(b: np.ndarray, a: np.ndarray, L: int = _L):
    """Frame operators of an LTI recursion, float64 on the host, returned
    as float32 (a copy of the JAX package's).

    Controller-canonical state s before each sample: s[n+1] = A s[n] +
    B x[n], y[n] = C s[n] + D x[n].  Over an L-sample frame from state s0,
    y[j] = (C A^j) s0 + sum_{i<=j} h[j-i] x[i] and s_end = A^L s0 +
    sum_i A^(L-1-i) B x[i].  Returns T (L, L) the in-frame Toeplitz, S
    (L, k) state -> output, W (k, L) with W[:, m] = A^m B, and the powers
    Apow (L+1, k, k) of A."""
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b, a = b / a[0], a / a[0]
    k = max(len(a), len(b)) - 1
    if k == 0:
        raise ValueError("IirFrame needs order >= 1 (a pure gain has no "
                         "state); use iir_filter or Iir for order 0.")
    a = np.pad(a, (0, k + 1 - len(a)))
    bp = np.pad(b, (0, k + 1 - len(b)))
    A = np.zeros((k, k))
    A[0, :] = -a[1:]
    A[1:, :-1] = np.eye(k - 1)
    B = np.zeros(k)
    B[0] = 1.0
    C = bp[1:] - a[1:] * bp[0]
    D = bp[0]
    Apow = np.empty((L + 1, k, k))
    Apow[0] = np.eye(k)
    for m in range(1, L + 1):
        Apow[m] = A @ Apow[m - 1]
    h = np.empty(L)
    h[0] = D
    for m in range(1, L):
        h[m] = C @ Apow[m - 1] @ B
    i = np.arange(L)
    idx = i[:, None] - i[None, :]
    T = np.where(idx >= 0, h[np.clip(idx, 0, L - 1)], 0.0)
    S = np.stack([C @ Apow[j] for j in range(L)])
    W = np.stack([Apow[m] @ B for m in range(L)], axis=1)
    f32 = lambda M: np.asarray(M, np.float32)   # noqa: E731
    return f32(T), f32(S), f32(W), f32(Apow)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _fp32_matmul():
        return torch.matmul(a, b)


def _affine_matrix_scan(M: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """s_m = M s_{m-1} + u_m over the frame axis of u (..., nf, k), s_{-1}
    folded into u_0; returns every s_m.  Log-depth doubling: the pass of
    shift s adds M^s s_{m-s}, then squares the power (k x k matmuls)."""
    nf = u.shape[-2]
    s = u
    P = M
    sh = 1
    while sh < nf:
        s = torch.cat([s[..., :sh, :],
                       s[..., sh:, :] + _mm(s[..., :-sh, :], P.T)], dim=-2)
        P = _mm(P, P)
        sh *= 2
    return s


class IirFrame(Block):
    """Frame-parallel IIR (the JAX package's runtime for order >= 2): the
    recursion as exact state-space algebra over L = 128-sample frames
    (``_iir_frame_mats``): in-frame work is one (nf, L) @ (L, L) product,
    the k-dimensional state hop between frames a log-depth scan.  Same
    outputs and streaming protocol as ``Iir``.  State: the k-dim canonical
    state vector.  Step lengths are multiples of 128."""

    def __init__(self, T, S, Wf, M):
        super().__init__()
        self.register_buffer("T", T)     # (L, L) in-frame Toeplitz
        self.register_buffer("S", S)     # (L, k) state -> output
        self.register_buffer("Wf", Wf)   # (L, k) flipped input -> state
        self.register_buffer("M", M)     # (k, k) = A^L

    @classmethod
    def create(cls, b, a, L: int = _L, device="cuda") -> "IirFrame":
        device = _device(device)
        T, S, W, Apow = _iir_frame_mats(b, a, L)
        t = lambda v: torch.as_tensor(np.ascontiguousarray(v),   # noqa
                                      device=device)
        return cls(t(T), t(S), t(W[:, ::-1].T), t(Apow[L]))

    @property
    def order(self) -> int:
        return self.S.shape[1]

    def init(self):
        return torch.zeros((self.order,), dtype=real_dtype,
                           device=self.T.device)

    def init_for(self, x: torch.Tensor):
        dt = complex_dtype if x.is_complex() else real_dtype
        return torch.zeros(tuple(x.shape[:-1]) + (self.order,), dtype=dt,
                           device=self.T.device)

    def step(self, state, x):
        L = self.T.shape[0]
        n = x.shape[-1]
        if n % L:
            raise ValueError(f"IirFrame.step needs len(x) % {L} == 0, "
                             f"got {n}")
        if x.is_complex():
            sr, yr = self.step(state.real, x.real)
            si, yi = self.step(state.imag, x.imag)
            return torch.complex(sr, si), torch.complex(yr, yi)
        x = x.to(real_dtype)
        state = state.to(real_dtype)
        xf = x.reshape(tuple(x.shape[:-1]) + (n // L, L))
        u = _mm(xf, self.Wf)
        u = torch.cat([u[..., :1, :] + _mm(state[..., None, :], self.M.T),
                       u[..., 1:, :]], dim=-2)
        s_end = _affine_matrix_scan(self.M, u)
        s_start = torch.cat([state[..., None, :], s_end[..., :-1, :]], dim=-2)
        y = _mm(xf, self.T.T) + _mm(s_start, self.S.T)
        return s_end[..., -1, :], y.reshape(x.shape)


def iir_filter(b, a, x: torch.Tensor) -> torch.Tensor:
    """One-shot IIR, zero initial state, through ``IirFrame`` on x's
    device.  x is padded to a multiple of 128 inside (zero padding does not
    change the first len(x) outputs).  Leading zeros of b are a pure delay
    (filter with the trimmed numerator, then shift); order > 4 is factored
    into second-order sections (``sos_frame_chain``), as the JAX package
    does for float32 conditioning."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    a_np = np.atleast_1d(np.asarray(a, np.float64))
    b_np = np.atleast_1d(np.asarray(b, np.float64))
    nz = np.flatnonzero(b_np)
    if nz.size == 0:
        return torch.zeros_like(x)
    d = int(nz[0])
    if d:
        y = iir_filter(b_np[d:], a_np, x)
        return F.pad(y, (d, 0))[..., :n]
    order = max(len(a_np), len(b_np)) - 1
    if order == 0:
        return (b_np[0] / a_np[0]) * x
    if order > 4:
        from .iir_design import ZPK, zpk_to_sos
        zpk = ZPK(z=np.roots(b_np / b_np[0]), p=np.roots(a_np / a_np[0]),
                  k=float(b_np[0] / a_np[0]))
        sos, k = zpk_to_sos(zpk)
        blk = sos_frame_chain(sos, k, device=x.device)
    else:
        blk = IirFrame.create(b_np, a_np, device=x.device)
    xp = F.pad(x, (0, (-n) % _L))
    _, y = blk.step(blk.init_for(xp), xp)
    return y[..., :n]


def sos_frame_chain(sos, k: float = 1.0, L: int = _L, device="cuda"):
    """Each second-order section as an ``IirFrame``, composed with
    ``Chain`` (the gain k on the first section)."""
    from ..block import Chain
    sos = np.asarray(sos, np.float64)
    return Chain([IirFrame.create(sos[s, :3] * (k if s == 0 else 1.0),
                                  sos[s, 3:], L=L, device=device)
                  for s in range(sos.shape[0])])


class Sos(Block):
    """Cascade of second-order sections, transposed DF-II each, one
    Python loop over the samples (parity: SOIS/ChaineSOIS/filtre_sois,
    filtre-rt.cc:295-581).  sos (nsec, 6) rows [b0 b1 b2 1 a1 a2]; the
    gain k is applied once at the input.  State (..., nsec, 2)."""

    def __init__(self, sos: torch.Tensor, k: torch.Tensor):
        super().__init__()
        self.register_buffer("sos", sos)
        self.register_buffer("k", k)

    @classmethod
    def create(cls, sos, k: float = 1.0, device="cuda") -> "Sos":
        device = _device(device)
        return cls(torch.as_tensor(np.asarray(sos, np.float64),
                                   dtype=real_dtype, device=device),
                   torch.tensor(k, dtype=real_dtype, device=device))

    @classmethod
    def from_zpk(cls, zpk, device="cuda") -> "Sos":
        from .iir_design import zpk_to_sos
        sos, k = zpk_to_sos(zpk)
        return cls.create(sos, k, device=device)

    def init(self):
        return torch.zeros((self.sos.shape[0], 2), dtype=real_dtype,
                           device=self.sos.device)

    def init_for(self, x: torch.Tensor):
        dt = complex_dtype if x.is_complex() else real_dtype
        return torch.zeros(tuple(x.shape[:-1]) + (self.sos.shape[0], 2),
                           dtype=dt, device=self.sos.device)

    def step(self, state, x):
        sos = self.sos
        b0, b1, b2 = sos[:, 0], sos[:, 1], sos[:, 2]
        a1, a2 = sos[:, 4], sos[:, 5]
        w = state
        ys = []
        for i in range(x.shape[-1]):
            v = self.k * x[..., i]
            new_w = []
            for s in range(sos.shape[0]):
                y = b0[s] * v + w[..., s, 0]
                new_w.append(torch.stack([b1[s] * v - a1[s] * y + w[..., s, 1],
                                          b2[s] * v - a2[s] * y], dim=-1))
                v = y
            w = torch.stack(new_w, dim=-2)
            ys.append(v)
        return w, torch.stack(ys, dim=-1)


OLA_ENGINES = ("torch", "cuda")
_JAX_OLA_ENGINES = {"xla": "torch", "pallas": "cuda"}


class OlaFft(Block):
    """Overlap FFT block filter with a frozen frequency response (parity:
    filtre_fft / FiltreFFT, fourier.cc:708-935; the reference's user
    callback mode is not ported, as in the JAX package).

    ``step`` takes blocks whose length is a multiple of ``Ne``.  Engine
    "torch": each Ne-sample block is zero-padded to Nf = next_pow2(Ne + M
    - 1), transformed, multiplied by H, inverse-transformed and
    overlap-added with the carried output residue (Nf - Ne samples).
    Engine "cuda": kernel #9 (``ops.kernels.ola``), overlap-save with the
    last V inputs as the state; Nf and Ne follow its plan.  ``H`` is a
    complex64 buffer in natural bin order on both engines."""

    def __init__(self, H: torch.Tensor, Ne: int, Nf: int, M: int,
                 engine: str = "torch", complex_taps: bool = False,
                 precision: str = "highest"):
        super().__init__()
        if engine not in OLA_ENGINES:
            raise ValueError(_engine_error(engine))
        self.register_buffer("H", H)
        self.Ne, self.Nf, self.M = int(Ne), int(Nf), int(M)
        self.engine = engine
        self.complex_taps = bool(complex_taps)
        self.precision = precision

    @classmethod
    def create(cls, h, Ne: Optional[int] = None, engine: str = "torch",
               precision: str = "highest", device="cuda") -> "OlaFft":
        """engine: "torch" or "cuda" (kernel #9; its plan sets Nf and Ne,
        and a requested Ne is the least hop wanted).  precision ("highest"
        or "split", the JAX tiers of the kernel) runs fp32 on both."""
        from .fft import next_pow2, ola_complexity_optimize
        from .kernels.ola import ola_plan
        if engine not in OLA_ENGINES:
            raise ValueError(_engine_error(engine))
        device = _device(device)
        h = np.asarray(h)
        M = len(h)
        if engine == "cuda":
            if Ne is None:
                Nf, Ne, _ = ola_plan(M)
            else:
                # the smallest valid FFT size whose hop covers the request
                V = max(128, -(-(M - 1) // 128) * 128)
                Nf = min(max(next_pow2(Ne + V), 256), 16384)
                if Nf < V + 128:
                    raise ValueError(
                        f"filter too long for the cuda OLA engine: "
                        f"ntaps={M} needs Nf > {V + 128}, max 16384")
                Nf, Ne, _ = ola_plan(M, Nf)
        elif Ne is None:
            _, Nf, _, Ne = ola_complexity_optimize(M)
        else:
            Nf = next_pow2(Ne + M - 1)
        H = torch.as_tensor(np.fft.fft(h, Nf).astype(np.complex64),
                            device=device)
        return cls(H, Ne=Ne, Nf=Nf, M=M, engine=engine,
                   complex_taps=bool(np.iscomplexobj(h)), precision=precision)

    @property
    def tail_state(self) -> bool:
        # overlap-save ("cuda"): the state is the last V INPUT samples;
        # overlap-add ("torch"): the carried OUTPUT residue, which a
        # neighbour's input halo must not be seeded into
        return self.engine == "cuda"

    @property
    def V(self) -> int:
        return self.Nf - self.Ne

    def init(self):
        return torch.zeros((self.Nf - self.Ne,), dtype=complex_dtype,
                           device=self.H.device)

    def init_for(self, x: torch.Tensor):
        return torch.zeros(tuple(x.shape[:-1]) + (self.Nf - self.Ne,),
                           dtype=complex_dtype, device=self.H.device)

    @property
    def delay(self) -> float:
        return (self.M - 1) / 2

    def step(self, state, x):
        n = x.shape[-1]
        Ne, Nf = self.Ne, self.Nf
        if n % Ne:
            raise ValueError(f"input length {n} is not a multiple of "
                             f"Ne={Ne}")
        real_out = not x.is_complex() and not self.complex_taps
        if self.engine == "cuda":
            from .kernels.ola import ola_stream
            lead = tuple(x.shape[:-1])
            y, st = ola_stream(x.reshape(-1, n).to(complex_dtype),
                               state.reshape(-1, self.V), self.H, self.M, Nf)
            y = y.reshape(lead + (n,))
            st = st.reshape(lead + (self.V,))
            return st, (y.real if real_out else y)
        nblk = n // Ne
        lead = tuple(x.shape[:-1])
        xb = x.to(complex_dtype).reshape(lead + (nblk, Ne))
        yb = torch.fft.ifft(torch.fft.fft(xb, n=Nf, dim=-1) * self.H, dim=-1)
        # overlap-add: block b's Nf outputs start at b Ne; m = ceil(Nf/Ne)
        # hop-long pieces per block, summed over the blocks they overlap,
        # then the carried residue added to the first Nf - Ne samples
        m = -(-Nf // Ne)
        yb = F.pad(yb, (0, m * Ne - Nf)).reshape(lead + (nblk, m, Ne))
        acc = torch.zeros(lead + ((nblk + m - 1) * Ne,), dtype=complex_dtype,
                          device=yb.device)
        for j in range(m):
            acc[..., j * Ne:(j + nblk) * Ne] += yb[..., j, :].reshape(
                lead + (nblk * Ne,))
        acc[..., :Nf - Ne] += state
        y = acc[..., :n]
        return acc[..., n:n + Nf - Ne], (y.real if real_out else y)


class FirFft(OlaFft):
    """FIR filtering through the OLA engine (parity: filtre_rif_fft,
    fourier.cc:974-1010)."""


def _engine_error(engine: str) -> str:
    hint = (f" (the JAX package's {engine!r} is the port's "
            f"{_JAX_OLA_ENGINES[engine]!r})" if engine in _JAX_OLA_ENGINES
            else "")
    return (f"engine={engine!r}: the port's OLA engines are "
            f"{OLA_ENGINES}{hint}")


def _as_design(h):
    """Normalize a filter spec: taps -> FIR; (b, a) tuple or ZPK -> IIR."""
    if isinstance(h, tuple) and len(h) == 2:
        return ("iir", h[0], h[1])
    if hasattr(h, "to_ba") and hasattr(h, "p"):
        b, a = h.to_ba()
        return ("iir", b, a)
    return ("fir", h, None)


def filter_signal(h, x: torch.Tensor, mode: str = "direct") -> torch.Tensor:
    """One-shot filtering (parity: the filtrer one-shot wrappers,
    filtrage.hpp:1684-1744).  h: FIR taps, a (b, a) tuple or a ZPK design
    (IIR, through ``iir_filter``); mode="fft" runs the OLA FFT path
    (``OlaFft``, "torch" engine, on x's device; FIR only)."""
    kind, b, a = _as_design(h)
    if kind == "iir":
        return iir_filter(b, a, x)
    if mode == "fft":
        from ..block import pad_to_multiple
        x = torch.as_tensor(x)
        blk = OlaFft.create(np.asarray(h), device=x.device)
        n = x.shape[-1]
        xp = pad_to_multiple(x, blk.Ne, axis=x.ndim - 1)
        _, y = blk.step(blk.init_for(xp), xp)
        return y[..., :n]
    if mode != "direct":
        raise ValueError(f"mode must be 'direct' or 'fft', got {mode!r}")
    return fir_filter(h, x)


def filtfilt(h, x: torch.Tensor) -> torch.Tensor:
    """Zero-phase forward-backward filtering, FIR or IIR (parity:
    filtfilt, filtrage.hpp:1663-1782)."""
    kind, b, a = _as_design(h)

    def one(v):
        return iir_filter(b, a, v) if kind == "iir" else fir_filter(h, v)
    return one(one(x).flip(-1)).flip(-1)
