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

``MovingAverage`` (the detector's window energy) and the overlap FFT block
``OlaFft``/``FirFft`` are ported too.  ``OlaFft`` has two engines: "torch"
(the JAX package's "xla": ``torch.fft`` overlap-add, state = the carried
output residue) and "cuda" (the JAX package's "pallas": kernel #9,
overlap-save, state = the last V inputs, ``tail_state`` True).

Not ported yet: ``filtfilt`` and the recursive blocks other than
``MovingAverage`` (see ROADMAP.md).
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
           "FirFft", "OLA_ENGINES", "filter_signal"]

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
        return "iir"
    if hasattr(h, "to_ba") and hasattr(h, "p"):
        return "iir"
    return "fir"


def filter_signal(h, x: torch.Tensor, mode: str = "direct") -> torch.Tensor:
    """One-shot filtering.  h: FIR taps; mode="fft" runs the OLA FFT path
    (``OlaFft``, "torch" engine, on x's device).  IIR designs are not
    ported yet and raise."""
    if _as_design(h) == "iir":
        raise NotImplementedError(
            "IIR filtering (iir_filter, IirFrame, Sos) is not ported yet: "
            "ROADMAP.md slice 6")
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
