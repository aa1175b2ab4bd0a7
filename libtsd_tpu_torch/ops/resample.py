"""Resampling (PyTorch), ported from ``libtsd_tpu/ops/resample.py``:
polyphase forms, the polyphase upsampler, the half-band decimator, CIC,
the fractional-delay interpolators and the rational and arbitrary-ratio
resamplers (BASELINE config 3).

* ``FirUps`` -- y[mR + r] = sum_i x[m - i] Hm[i, r]: Kp shifted slices and
  multiply-adds, elementwise fp32 as in the JAX package.
* ``Cic`` -- int32 with two's-complement wraparound, as the JAX package
  (``torch.cumsum`` is given ``dtype=torch.int32`` every time: without it
  an int32 cumsum returns int64).  Complex IQ runs as a leading (2,) plane
  axis.
* ``Interpolator`` -- a (nphases + 1, K) table of fractional-delay taps;
  tau is quantised to the nearest of nphases phases (round half to even),
  the convention every clock loop of the package shares.
* ``RationalResampler`` -- the p fractional phases repeat every q input
  samples, so one cycle is a (p, q + K) matrix ``A`` built on the host;
  a block of whole cycles is the hop-q frames of the input (one strided
  view) times ``A``, one fp32 contraction with TF32 off (the JAX package's
  HIGHEST).  Other blocks, and ratios whose ``A`` would pass 2^23
  entries, take the per-output window gather.
"""
from __future__ import annotations

import fractions
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..block import Block, pad_to_multiple
from ..config import complex_dtype, device as _device, real_dtype
from .filter_rt import FirDecim, _fp32_matmul
from .fir_design import fir_design_windowed, fir_halfband

__all__ = [
    "polyphase_form", "ipolyphase_form",
    "FirUps", "fir_ups_delay", "HalfbandDecim", "CicConfig", "Cic",
    "cic_design_ba", "cic_freq", "cic_bits", "cic_bit_growth",
    "cic_comp_design",
    "sinc_interp_coefs", "sinc_interp_lut", "cspline_coefs", "cspline_lut",
    "linear_coefs", "lagrange_coefs", "Interpolator", "make_interpolator",
    "RationalResampler", "resample", "Resampler", "interp_irregular",
]


def polyphase_form(x: torch.Tensor, M: int) -> torch.Tensor:
    """Signal -> (M, n/M) polyphase matrix, row p = x[p::M] (parity:
    forme_polyphase, core/include/tsd/filtrage.hpp:1225-1254)."""
    n = (x.shape[-1] // M) * M
    return x[..., :n].reshape(*x.shape[:-1], n // M, M).transpose(-1, -2)


def ipolyphase_form(X: torch.Tensor) -> torch.Tensor:
    """Inverse of polyphase_form (parity: iforme_polyphase)."""
    return X.transpose(-1, -2).reshape(*X.shape[:-2], -1)


# ----------------------------------------------------------- upsampling

class FirUps(Block):
    """Polyphase upsampling FIR: insert R-1 zeros and the anti-image filter,
    taps scaled by R to keep the amplitude (parity: FiltreRIFUps,
    polyphase.cc:247-343).  ``Hm`` (Kp, R): Hm[i, r] = R h[i R + r], taps
    zero-padded at the END to a multiple of R."""

    def __init__(self, Hm: torch.Tensor, K: int, R: int, K0: int):
        super().__init__()
        self.register_buffer("Hm", Hm)
        self.K = int(K)      # padded tap count
        self.R = int(R)
        self.K0 = int(K0)    # original tap count

    @classmethod
    def create(cls, h, R: int, device="cuda") -> "FirUps":
        h = np.asarray(h, np.float64) * R
        K0 = len(h)
        if K0 % R:
            h = np.concatenate([h, np.zeros(R - K0 % R)])
        Hm = h.reshape(len(h) // R, R).astype(np.float32)
        return cls(torch.as_tensor(Hm, device=_device(device)), K=len(h),
                   R=R, K0=K0)

    def init(self):
        return torch.zeros((self.Hm.shape[0] - 1,), dtype=real_dtype,
                           device=self.Hm.device)

    def init_for(self, x: torch.Tensor):
        dt = complex_dtype if x.is_complex() else real_dtype
        return torch.zeros(tuple(x.shape[:-1]) + (self.Hm.shape[0] - 1,),
                           dtype=dt, device=self.Hm.device)

    @property
    def ratio(self) -> float:
        return float(self.R)

    @property
    def delay(self) -> float:
        # end-padded taps do not move the peak: (K0 - 1) / 2 output samples
        # (see fir_ups_delay)
        return (self.K0 - 1) / 2.0

    def step(self, state, x):
        n = x.shape[-1]
        Kp = self.Hm.shape[0]
        xx = torch.cat([state, x.to(state.dtype)], dim=-1)

        def branch(xr):
            acc = None
            for i in range(Kp):
                sl = xr[..., Kp - 1 - i:Kp - 1 - i + n]
                t = sl[..., :, None] * self.Hm[i]
                acc = t if acc is None else acc + t
            return acc                        # (..., n, R)

        if xx.is_complex():
            Y = torch.complex(branch(xx.real), branch(xx.imag))
        else:
            Y = branch(xx)
        y = Y.reshape(*x.shape[:-1], n * self.R)
        return xx[..., xx.shape[-1] - (Kp - 1):], y


def fir_ups_delay(nc: int, R: int) -> float:
    """Group delay of FirUps in output samples: (nc - 1) / 2 whatever R,
    since the taps are padded at the end (the reference pads in front,
    polyphase.cc:363-372, and so shifts its peak)."""
    del R
    return (nc - 1) / 2.0


class HalfbandDecim(Block):
    """Decimate-by-2 with a half-band FIR (zeros at odd taps), over the
    polyphase decimator (parity: FiltreRIFDemiBande, polyphase.cc:55-155;
    the dense contraction already costs what the zero-tap trick would
    save)."""

    def __init__(self, inner: FirDecim):
        super().__init__()
        self.inner = inner

    @classmethod
    def create(cls, h=None, n: int = 31, device="cuda") -> "HalfbandDecim":
        if h is None:
            h = fir_halfband(n)
        return cls(FirDecim.create(h, 2, device=device))

    def init(self):
        return self.inner.init()

    def init_for(self, x: torch.Tensor):
        return self.inner.init_for(x)

    @property
    def ratio(self) -> float:
        return 0.5

    @property
    def delay(self) -> float:
        return self.inner.delay

    def step(self, state, x):
        return self.inner.step(state, x)


# ------------------------------------------------------------------- CIC

@dataclass(frozen=True)
class CicConfig:
    """Parity: CICConfig, core/include/tsd/filtrage.hpp:1014-1024."""
    R: int = 4      # decimation ratio
    N: int = 4      # number of stages
    M: int = 1      # design delay


def _set_col(a: torch.Tensor, i: int, v: torch.Tensor) -> torch.Tensor:
    """a with a[..., i] = v, as a new tensor (the state given stays)."""
    a = a.clone()
    a[..., i] = v
    return a


class Cic(Block):
    """CIC decimator ("d") or interpolator ("i"/"u") with int32 wraparound
    arithmetic (parity: FiltreCIC, cic.cc:12-101).

    The input is rounded to int32 (as the reference's as<Ti>); ``scale``
    pre-quantises float signals (y is scaled back).  State: (integrator
    carries, comb memories), int32, a leading (2,) plane axis for complex
    input."""

    def __init__(self, config: CicConfig = CicConfig(), mode: str = "d",
                 scale: float = 1.0, device="cuda"):
        super().__init__()
        assert config.M == 1, "only M=1 supported (like the reference)"
        assert mode in ("d", "i", "u")
        self.config = config
        self.mode = mode
        self.scale = float(scale)
        self.device = _device(device)

    @property
    def gain(self) -> float:
        RM = self.config.R * self.config.M
        N = self.config.N
        if self.mode == "d":
            return 1.0 / RM ** N
        return float(self.config.R) / RM ** N

    @property
    def ratio(self) -> float:
        return (1.0 / self.config.R if self.mode == "d"
                else float(self.config.R))

    def init(self):
        N = self.config.N
        z = torch.zeros((N,), dtype=torch.int32, device=self.device)
        return (z, z.clone())

    def init_for(self, x: torch.Tensor):
        N = self.config.N
        lead = (2,) if x.is_complex() else ()
        shape = lead + tuple(x.shape[:-1]) + (N,)
        return (torch.zeros(shape, dtype=torch.int32, device=x.device),
                torch.zeros(shape, dtype=torch.int32, device=x.device))

    def step(self, state, x):
        if x.is_complex():
            # the re/im planes through the same integer pipeline
            state, y = self.step(state, torch.stack([x.real, x.imag]))
            return state, torch.complex(y[0], y[1])
        integ, combs = state
        N, R = self.config.N, self.config.R
        if self.mode == "d":
            # the decimation phase restarts at each step, so streaming
            # needs whole-R blocks (as FirDecim)
            assert x.shape[-1] % R == 0, \
                f"Cic decimator block length must be a multiple of R={R}"
        xi = torch.round(x * self.scale).to(torch.int32)

        def integrate(v, integ):
            for i in range(N):
                v = torch.cumsum(v, dim=-1, dtype=torch.int32) \
                    + integ[..., i:i + 1]
                integ = _set_col(integ, i, v[..., -1])
            return v, integ

        def comb(v, combs):
            for i in range(N):
                prev = torch.cat([combs[..., i:i + 1], v[..., :-1]], dim=-1)
                combs = _set_col(combs, i, v[..., -1])
                v = v - prev
            return v, combs

        if self.mode == "d":
            xi, integ = integrate(xi, integ)
            xd, combs = comb(xi[..., ::R], combs)
        else:
            # interpolation: combs, zero-stuffing, then integrators
            xi, combs = comb(xi, combs)
            n = xi.shape[-1]
            up = torch.zeros(tuple(xi.shape[:-1]) + (n, R), dtype=torch.int32,
                             device=xi.device)
            up[..., 0] = xi
            xd, integ = integrate(up.reshape(*xi.shape[:-1], n * R), integ)
        y = xd.to(real_dtype) * (self.gain / self.scale)
        return (integ, combs), y


def cic_design_ba(config: CicConfig) -> Tuple[np.ndarray, np.ndarray]:
    """CIC equivalent FIR transfer function ((1/RM) sum z^-i)^N (parity:
    design_cic, cic.cc:107-115)."""
    RM = config.R * config.M
    h = np.ones(RM) / RM
    out = np.array([1.0])
    for _ in range(config.N):
        out = np.convolve(out, h)
    return out, np.array([1.0])


def cic_freq(config: CicConfig, f: np.ndarray) -> np.ndarray:
    """|H(f)| of the CIC (parity: cic_freq, cic.cc:222-235)."""
    f = np.asarray(f, float)
    RM = config.R * config.M
    d = RM * np.sin(np.pi * f)
    with np.errstate(divide="ignore", invalid="ignore"):
        mag = np.abs(np.sin(RM * np.pi * f) / d) ** config.N
    return np.where(d == 0, 1.0, mag)


def cic_bits(config: CicConfig) -> int:
    """Additional accumulator bits needed (parity: cic_analyse,
    cic.cc:209-211)."""
    return int(np.ceil(config.N * np.log2(config.R) - 1))


def _poly_div_1mz(c: np.ndarray) -> np.ndarray:
    """Exact division of a polynomial in z^-1 by (1 - z^-1): the quotient's
    coefficients are the running partial sums (exact when c sums to
    zero)."""
    q = np.cumsum(c)[:-1]
    assert abs(np.sum(c)) < 1e-9 * np.abs(c).sum()
    return q


def cic_bit_growth(config: CicConfig, bin_bits: int = 16,
                   bout_bits: Optional[int] = None) -> dict:
    """Per-stage register analysis of the integer decimating CIC (Hogenauer
    1981, IEEE Trans. ASSP; the reference's ``cic_analyse`` reports only
    the total extra bits, cic.cc:209-211).

    Every register holds ``bmax = bin_bits + ceil(N log2(R M))`` bits
    (two's-complement wraparound makes one width enough at every node);
    ``prunable[j]`` least-significant bits may be dropped after stage j (1
    .. 2N, integrators then combs) under the equal-noise rule, from the
    noise gains F_j (L2 norms of the stage-to-output impulse responses).

    Returns dict(bmax, growth_bits (per integrator, ceil(j log2 RM)), F (2N
    noise gains), prunable (2N))."""
    R, N, M = config.R, config.N, config.M
    RM = R * M
    if bout_bits is None:
        bout_bits = bin_bits
    G = int(np.ceil(N * np.log2(RM)))
    bmax = bin_bits + G
    base = np.zeros(RM + 1)
    base[0], base[RM] = 1.0, -1.0
    numc = np.array([1.0])
    for _ in range(N):
        numc = np.convolve(numc, base)
    F = []
    for j in range(1, N + 1):            # after integrator j
        c = numc.copy()
        for _ in range(N - j):
            c = _poly_div_1mz(c)
        F.append(float(np.sqrt(np.sum(c * c))))
    cb = np.zeros(M + 1)
    cb[0], cb[M] = 1.0, -1.0
    for j in range(N + 1, 2 * N + 1):    # after comb j-N (decimated)
        c = np.array([1.0])
        for _ in range(2 * N - j):
            c = np.convolve(c, cb)
        F.append(float(np.sqrt(np.sum(c * c))))
    # output discard budget, spread equally over the 2N stages
    b_out_discard = max(bmax - bout_bits, 0)
    prunable = [
        int(np.clip(np.floor(b_out_discard - np.log2(max(f, 1e-300))
                             - 0.5 * np.log2(2 * N)), 0, bmax))
        for f in F]
    growth_bits = [int(np.ceil(j * np.log2(RM))) for j in range(1, N + 1)]
    return dict(bmax=bmax, growth_bits=growth_bits, F=F,
                prunable=prunable)


def cic_comp_design(config: CicConfig, fe: float, R2: int, fc: float,
                    ncoefs: int) -> np.ndarray:
    """FIR compensation of the CIC droop, by frequency sampling of the
    inverse CIC response with a cutoff at fc (parity: design_cic_comp,
    cic.cc:238-331).  ``R2`` is kept for the signature; as in the
    reference it does not change the design."""
    from .fir_design import fir_design_freq_sampling
    fs = fe / config.R
    m = (ncoefs + 1) // 2
    # frequency grid of the freq-sampling design, at the decimated rate
    fr = np.linspace(0, 0.5 * (1 - 1.0 / m), m) * fs
    mag = cic_freq(config, fr / fe)
    ideal = 1.0 / np.maximum(mag, 1e-9)
    idx = np.searchsorted(fr, fc)
    idx = min(max(idx, 2), m - 2)
    ideal[idx - 1] = ideal[idx - 2] / 2
    ideal[idx] = ideal[idx - 1] / 2
    ideal[idx + 1] = ideal[idx] / 2
    ideal[idx + 2:] = 0.0
    return fir_design_freq_sampling(ncoefs, ideal)


# ------------------------------------------------- fractional interpolators

def sinc_interp_coefs(nc: int, fcut: float, tau: float,
                      fen: str = "hn") -> np.ndarray:
    """Windowed-sinc fractional-delay taps at offset tau in [0, 1] (parity:
    InterpolateurSinc::coefs_calcule, itrp.cc:24-39, with the tau-shifted
    Hann window)."""
    i = np.arange(nc)
    k = i - nc // 2 - tau
    h = 2 * fcut * np.sinc(2 * fcut * k)
    if fen == "hn":
        a, b = 0.5, 0.25
        t = (np.linspace(-(nc // 2), (nc - 1) // 2, nc) - tau) * (2 * np.pi
                                                                  / nc)
        h = h * (a + 2 * b * np.cos(t))
    s = h.sum()
    return h / s if abs(s) > 1e-12 else h


def sinc_interp_lut(nc: int = 15, nphases: int = 256, fcut: float = 0.5,
                    fen: str = "hn") -> np.ndarray:
    """(nphases + 1, nc) table of windowed-sinc taps (parity:
    InterpolateurSinc, itrp.cc:11-57)."""
    return np.stack([sinc_interp_coefs(nc, fcut, p / nphases, fen)
                     for p in range(nphases + 1)])


def cspline_coefs(t: float, c: float = 0.0) -> np.ndarray:
    """Cardinal cubic spline taps on (p-1, p0, p1, p2) (parity:
    cspline_filtre, itrp.cc:293-312; c = 0 is Catmull-Rom)."""
    h = np.array([(1 + 2 * t) * (t - 1) ** 2,
                  t * (t - 1) ** 2,
                  t * t * (3 - 2 * t),
                  t * t * (t - 1)])
    return np.array([-(1 - c) * h[1] / 2,
                     h[0] - (1 - c) * h[3] / 2,
                     h[2] + (1 - c) * h[1] / 2,
                     (1 - c) * h[3] / 2])


def cspline_lut(n: int = 256, c: float = 0.0) -> np.ndarray:
    """(n + 1, 4) spline table (parity: cspline_calc_lut,
    itrp.cc:315-321)."""
    return np.stack([cspline_coefs(i / n, c) for i in range(n + 1)])


def linear_coefs(t: float) -> np.ndarray:
    """Parity: InterpolateurLineaire, itrp.cc:82-95."""
    return np.array([1 - t, t])


def lagrange_coefs(d: int, tau: float) -> np.ndarray:
    """Lagrange interpolator of degree d (K = d + 1 taps) evaluated at
    (d - 1) / 2 + tau (parity: InterpolateurLagrange, itrp.cc:98-140)."""
    t = (d - 1.0) / 2 + tau
    pts = np.arange(d + 1, dtype=float)
    h = np.ones(d + 1)
    for i in range(d + 1):
        for j in range(d + 1):
            if i != j:
                h[i] *= (t - pts[j]) / (pts[i] - pts[j])
    return h


class Interpolator(torch.nn.Module):
    """Phase-table fractional interpolator: taps[phase] . window.

    With w[i] = x[s + i], ``taps(tau) @ w`` evaluates x at s + center + tau,
    center = K - 1 - delay_; when the window ends at the newest sample x[m]
    the output is x(m - delay_ + tau), so ``delay_`` is the causal group
    delay in input samples.  ``lut`` (nphases + 1, K) float32 buffer."""

    def __init__(self, lut: torch.Tensor, K: int, delay_: float):
        super().__init__()
        self.register_buffer("lut", lut)
        self.K = int(K)
        self.delay_ = float(delay_)

    @property
    def nphases(self) -> int:
        return self.lut.shape[0] - 1

    def taps(self, tau: torch.Tensor) -> torch.Tensor:
        """Taps for fractional offsets tau in [0, 1] (any shape)."""
        idx = torch.clamp(torch.round(tau * self.nphases).to(torch.int64),
                          0, self.nphases)
        return self.lut[idx]


def make_interpolator(kind: str = "sinc", device="cuda",
                      **kw) -> Interpolator:
    """Factory (parity: itrp_sinc / itrp_cspline / itrp_lineaire /
    itrp_lagrange, itrp.cc)."""
    nph = kw.get("nphases", 256)
    if kind == "sinc":
        nc = kw.get("ncoefs", 15)
        lut = sinc_interp_lut(nc, nph, kw.get("fcut", 0.5), kw.get("fen", "hn"))
        # kernel centre nc // 2 -> causal delay nc - 1 - nc // 2
        K, delay = nc, nc - 1 - nc // 2
    elif kind == "cspline":
        lut = cspline_lut(nph, kw.get("c", 0.0))
        K, delay = 4, 2.0
    elif kind == "linear":
        lut = np.stack([linear_coefs(i / nph) for i in range(nph + 1)])
        K, delay = 2, 1.0
    elif kind == "lagrange":
        d = kw.get("degree", 3)
        lut = np.stack([lagrange_coefs(d, i / nph) for i in range(nph + 1)])
        # evaluated at (d - 1) / 2 + tau -> causal delay (d + 1) / 2
        K, delay = d + 1, (d + 1) / 2
    else:
        raise ValueError(f"unknown interpolator {kind!r}")
    return Interpolator(torch.as_tensor(np.asarray(lut, np.float32),
                                        device=_device(device)),
                        K=K, delay_=delay)


# ------------------------------------------------- rational rate adapter

class RationalResampler(Block):
    """Resample by the exact rational ratio p/q (output rate = input rate
    x p/q) with a fractional interpolator bank: the static-shape form of
    the reference's phase-accumulator loop (AdaptationRythmeSimple,
    ra.cc:14-80).  Output j interpolates input time j q / p (plus the
    interpolator's delay); n p must be a multiple of q.

    The p phases repeat every q input samples, so one cycle (p outputs
    from a (q + K)-sample window) is the matrix ``A`` (p, q + K), built on
    the host at creation; a block of whole cycles is the hop-q frames of
    the input times ``A``.  ``A`` is (1, 1) when p (q + K) > 2^23: such
    ratios, and blocks that are not whole cycles, take the per-output
    window gather."""

    def __init__(self, itrp: Interpolator, A: torch.Tensor, p: int, q: int):
        super().__init__()
        self.itrp = itrp
        self.register_buffer("A", A)
        self.p = int(p)
        self.q = int(q)

    @classmethod
    def create(cls, ratio: float, itrp: Optional[Interpolator] = None,
               max_den: int = 1 << 16, device="cuda") -> "RationalResampler":
        dev = _device(device)
        fr = fractions.Fraction(ratio).limit_denominator(max_den)
        if itrp is None:
            # anti-alias at half the lower of the two rates (ra.cc:151)
            fcut = min(0.4, 0.5 * min(1.0, float(fr)))
            itrp = make_interpolator("sinc", ncoefs=15, fcut=fcut,
                                     device=dev)
        p, q = fr.numerator, fr.denominator
        K = itrp.K
        if p * (q + K) <= (1 << 23):
            # output r of a cycle reads window samples ip_r + 1 + i (i < K)
            # of the (q + K)-sample frame with taps(tau_r)
            nph = itrp.lut.shape[0] - 1
            r = np.arange(p)
            ip = (r * q) // p
            tau = ((r * q) % p) / p
            ph = np.minimum(np.round(tau * nph).astype(np.int64), nph)
            taps = itrp.lut.cpu().numpy()[ph]                 # (p, K)
            cols = np.arange(q + K)[None, :] - (ip[:, None] + 1)
            valid = (cols >= 0) & (cols < K)
            A = np.where(valid, np.take_along_axis(
                taps, np.clip(cols, 0, K - 1), axis=1), 0.0)
            A = torch.as_tensor(A.astype(np.float32), device=dev)
        else:
            A = torch.zeros((1, 1), dtype=real_dtype, device=dev)
        return cls(itrp, A, p, q)

    @property
    def ratio(self) -> float:
        return self.p / self.q

    @property
    def delay(self) -> float:
        return self.itrp.delay_ * self.ratio

    def init(self):
        return torch.zeros((self.itrp.K,), dtype=real_dtype,
                           device=self.A.device)

    def init_for(self, x: torch.Tensor):
        dt = complex_dtype if x.is_complex() else real_dtype
        return torch.zeros(tuple(x.shape[:-1]) + (self.itrp.K,), dtype=dt,
                           device=self.A.device)

    def step(self, state, x):
        n = x.shape[-1]
        p, q, K = self.p, self.q, self.itrp.K
        if (n * p) % q:
            raise ValueError("block length * p must be a multiple of q")
        nout = n * p // q
        xx = torch.cat([state, x.to(state.dtype)], dim=-1)   # (..., n + K)
        if n % q == 0 and tuple(self.A.shape) == (p, q + K):
            # frame c = xx[c q : c q + q + K], c < n / q: one strided view
            frames = xx.unfold(-1, q + K, q)           # (..., n / q, q + K)
            with _fp32_matmul():
                if frames.is_complex():
                    y = torch.complex(frames.real @ self.A.T,
                                      frames.imag @ self.A.T)
                else:
                    y = frames @ self.A.T
            return xx[..., -K:], y.reshape(*x.shape[:-1], nout)
        # per-output window gather: output j reads x[ip - K + 1 .. ip]
        # (xx index of x[t] is K + t), taps at tau = (j q mod p) / p
        j = torch.arange(nout, device=xx.device)
        ip = (j * q) // p
        tau = ((j * q) % p).to(real_dtype) / p
        widx = ip[:, None] + 1 + torch.arange(K, device=xx.device)[None, :]
        W = xx[..., widx]                              # (..., nout, K)
        T = self.itrp.taps(tau.to(self.itrp.lut.device)).to(xx.device)
        y = (W * T.to(W.dtype)).sum(-1)
        return xx[..., -K:], y


class Resampler(Block):
    """Arbitrary-ratio resampler: half-band decimators or polyphase x2
    upsamplers bring the ratio into [0.5, 2), then a rational resampler
    (parity: AdaptationRythmeArbitraire, ra.cc:85-179)."""

    def __init__(self, stages):
        super().__init__()
        self.stages = torch.nn.ModuleList(stages)

    @classmethod
    def create(cls, ratio: float, device="cuda") -> "Resampler":
        dev = _device(device)
        stages = []
        post = ratio
        h = fir_design_windowed(15, "lp", 0.25, "hn")
        while post < 0.5:
            stages.append(HalfbandDecim.create(n=15, device=dev))
            post *= 2
        while post >= 2:
            stages.append(FirUps.create(h, 2, device=dev))
            post /= 2
        if abs(post - 1.0) > 1e-9:
            # a small denominator for the residual stage: ~1e-6 relative
            # rate error, where a huge p/q would force block lengths of
            # multiples of q and an unbuildable cycle matrix
            stages.append(RationalResampler.create(post, max_den=1024,
                                                   device=dev))
        return cls(stages)

    @property
    def ratio(self) -> float:
        r = 1.0
        for s in self.stages:
            r *= s.ratio
        return r

    def init(self):
        return tuple(s.init() for s in self.stages)

    def init_for(self, x: torch.Tensor):
        return tuple(s.init_for(x) for s in self.stages)

    def step(self, state, x):
        new_states = []
        for s, st in zip(self.stages, state):
            st, x = s.step(st, x)
            new_states.append(st)
        return tuple(new_states), x


def resample(x, ratio: float, device="cuda") -> torch.Tensor:
    """One-shot arbitrary-ratio resampling (parity: filtre_reechan one-shot
    use / rééchan).  A tensor stays on its device; other input goes to
    ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x), device=_device(device))
    blk = Resampler.create(ratio, device=x.device)
    n = x.shape[-1]
    # the block-length constraints multiply across stages: d half-band
    # decimators need a multiple of 2^d, the rational stage a multiple of
    # its q of what reaches it
    q = 1
    for s in blk.stages:
        if isinstance(s, RationalResampler):
            q *= s.q
        elif isinstance(s, HalfbandDecim):
            q *= 2
    xp = pad_to_multiple(x, q, axis=x.ndim - 1)
    _, y = blk.step(blk.init_for(xp), xp)
    # the padding's images are not signal: ~n ratio samples
    nout = int(round(n * blk.ratio))
    return y[..., :nout] if y.shape[-1] > nout else y


def _interp1(x2: torch.Tensor, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of real y at x2, held at y[0] below x[0] and
    y[-1] above x[-1] (``jnp.interp``'s arithmetic)."""
    i = torch.clamp(torch.searchsorted(x, x2, right=True), 1, len(x) - 1)
    df = y[i] - y[i - 1]
    dx = x[i] - x[i - 1]
    delta = x2 - x[i - 1]
    eps = np.spacing(np.finfo(np.float32).eps)
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, y[i - 1],
                    y[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x2 < x[0], y[0], f)
    return torch.where(x2 > x[-1], y[-1], f)


def interp_irregular(x, y, x2, mode: str = "linear",
                     device="cuda") -> torch.Tensor:
    """Interpolate an irregularly sampled function: given knots (x, y), x
    strictly increasing, evaluate at the points x2 (parity:
    tsd::filtrage::interp, filtrage.hpp:2048-2068, InterpOption LINEAIRE /
    CSPLINE natural cubic splines).

    mode "linear", or "cspline" (natural cubic spline, zero second
    derivative at both ends; the tridiagonal system solved densely, for
    the usual few thousand knots).  Outside [x[0], x[-1]] the end values
    are held, as the reference's boundary handling.  A tensor y keeps its
    device; other input goes to ``device``."""
    dev = y.device if isinstance(y, torch.Tensor) else _device(device)
    x = torch.as_tensor(x, device=dev).to(real_dtype)
    y = torch.as_tensor(y, device=dev)
    # float up front: the spline divides by knot spacings cast to y's dtype
    y = y.to(complex_dtype if y.is_complex() else real_dtype)
    x2 = torch.as_tensor(x2, device=dev).to(real_dtype)
    if mode == "linear":
        if y.is_complex():
            return torch.complex(_interp1(x2, x, y.real),
                                 _interp1(x2, x, y.imag))
        return _interp1(x2, x, y)
    assert mode == "cspline", mode
    n = x.shape[0]
    h = torch.diff(x)                                  # (n - 1,)
    # natural spline: interior second derivatives m[1 .. n-2] (m[0] =
    # m[n-1] = 0) from the standard tridiagonal system
    dy = torch.diff(y) / h.to(y.dtype)
    rhs = 6.0 * torch.diff(dy)                         # (n - 2,)
    A = (torch.diag(2.0 * (h[:-1] + h[1:])) + torch.diag(h[1:-1], 1)
         + torch.diag(h[1:-1], -1))
    with _fp32_matmul():
        if y.is_complex():
            m_int = torch.complex(
                torch.linalg.solve(A, rhs.real.contiguous()),
                torch.linalg.solve(A, rhs.imag.contiguous()))
        else:
            m_int = torch.linalg.solve(A, rhs)
    zero = torch.zeros((1,), dtype=m_int.dtype, device=dev)
    m = torch.cat([zero, m_int, zero])
    # the piecewise cubic at each query point
    k = torch.clamp(torch.searchsorted(x, x2, right=True) - 1, 0, n - 2)
    xk, hk = x[k], h[k]
    t = torch.clamp((x2 - xk) / hk, 0.0, 1.0)
    yk, yk1, mk, mk1 = y[k], y[k + 1], m[k], m[k + 1]
    hk = hk.to(y.dtype)
    t_ = t.to(y.dtype)
    a = yk
    b = (yk1 - yk) / hk - hk * (2.0 * mk + mk1) / 6.0
    c = mk / 2.0
    d = (mk1 - mk) / (6.0 * hk)
    dx = t_ * hk
    return a + dx * (b + dx * (c + dx * d))
