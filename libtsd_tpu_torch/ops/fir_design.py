"""FIR filter design (design-time, host numpy, float64).

Parity: core/src/filtrage/rif-fen.cc, rif-eq.cc, rif-freq.cc, rif-cs.cc,
core/src/reechan/hb.cc, core/src/filtrage/hilbert.cc,
core/src/filtrage/filtrage.cc (differentiator), core/include/tsd/filtrage.hpp.

Frequency convention: normalized frequency in cycles/sample, Nyquist = 0.5.
Design runs once on host; returned coefficient arrays feed the JAX runtime.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from .window import chebyshev_window, kaiser_param, kaiser_window, window

__all__ = [
    "check_normalized_freq",
    "sinc2", "fir_lowpass", "fir_design_windowed", "fir_design_kaiser",
    "fir_design_chebyshev", "FreqIntervalSpec", "fir_design_equiripple",
    "fir_design_equiripple_grid", "fir_design_freq_sampling",
    "fir_freq_sampling_freqs", "raised_cosine", "root_raised_cosine",
    "gaussian_fir", "gaussian_fir_telecom", "bt_to_sigma",
    "fir_halfband", "fir_hilbert", "fir_differentiator",
    "fir_amplitude", "fir_type", "fir_product", "lowpass_to_highpass_is",
    "lowpass_to_highpass_rs", "lowpass_to_bandpass",
]


def sinc2(T: float, f) -> np.ndarray:
    """Two-argument sinc: sin(pi*T*f) / (pi*f), value T at f=0
    (parity: tsd::sinc, core/src/divers.cc:6-13)."""
    f = np.asarray(f, dtype=float)
    return T * np.sinc(T * f)


def _sinc_taps(n: int, fc: float) -> np.ndarray:
    """Ideal-lowpass taps 2fc*sinc(2fc*k), k centered (parity:
    coefs_filtre_sinc, rif-fen.cc:30-41 — same centering for even n)."""
    k = np.arange(n) - (n - 1) // 2
    return sinc2(2 * fc, k)


def check_normalized_freq(f: float, msg: str = "") -> None:
    """Raise if f is not a normalized frequency in [0, 0.5] (parity:
    verifie_frequence_normalisee, filtrage.cc:110-117)."""
    if not (0.0 <= f <= 0.5):
        what = f"{msg}: f" if msg else "F"
        raise ValueError(
            f"{what}requency must be normalized (cycles/sample) in "
            f"[0, 0.5]; got {f}.")


def fir_design_windowed(n: int, typ: str, fcut: float, fen: str = "hn",
                        fcut2: float = 0.0) -> np.ndarray:
    """Windowed-sinc FIR: 'lp'/'hp'/'bp'/'sb' (parity: design_rif_fen,
    rif-fen.cc:83-116; lp is normalized to unit DC gain)."""
    return _design_with_window(typ, fcut, window(fen, n, sym=True), fcut2)


def fir_lowpass(n: int, fc: float, fen: str = "hn") -> np.ndarray:
    """Convenience: windowed-sinc lowpass with unit DC gain."""
    return fir_design_windowed(n, "lp", fc, fen)


def fir_design_kaiser(typ: str, fcut: float, atten_db: float, df: float,
                      fcut2: float = 0.0) -> np.ndarray:
    """Kaiser-window FIR with order chosen from attenuation / transition width
    (parity: design_rif_fen_kaiser, rif-fen.cc:118-123)."""
    beta, n = kaiser_param(atten_db, df)
    f = kaiser_window(n, beta, sym=True)
    return _design_with_window(typ, fcut, f, fcut2)


def fir_design_chebyshev(n: int, typ: str, fcut: float, atten_db: float,
                         fcut2: float = 0.0) -> np.ndarray:
    """Dolph-Chebyshev-window FIR (parity: design_rif_fen_chebychev)."""
    f = chebyshev_window(n, atten_db)
    return _design_with_window(typ, fcut, f, fcut2)


def _design_with_window(typ: str, fcut: float, f: np.ndarray,
                        fcut2: float) -> np.ndarray:
    """One copy of the lp/hp/bp/sb tap construction for all windowed
    designs (plain / kaiser / chebyshev) — previously duplicated, and
    the kaiser/chebyshev entry points skipped frequency validation."""
    check_normalized_freq(fcut, "windowed FIR design")
    if typ in ("bp", "pm", "sb"):
        check_normalized_freq(fcut2, "windowed FIR design (fcut2)")
    n = len(f)
    no2 = (n - 1) // 2
    if typ in ("lp", "pb"):
        h = _sinc_taps(n, fcut)
    elif typ in ("hp", "ph"):
        h = -_sinc_taps(n, fcut)
        h[no2] += 1.0
    elif typ in ("bp", "pm"):
        wc = np.pi * (fcut + fcut2)
        k = np.arange(n) - no2
        h = _sinc_taps(n, (fcut2 - fcut) / 2) * 2 * np.cos(wc * k)
    elif typ == "sb":
        wc = np.pi * (fcut + fcut2)
        k = np.arange(n) - no2
        h = -_sinc_taps(n, (fcut2 - fcut) / 2) * 2 * np.cos(wc * k)
        h[no2] += 1.0
    else:
        raise ValueError(f"unknown FIR type {typ!r}")
    h2 = h * f
    if typ in ("lp", "pb"):
        h2 = h2 / h2.sum()
    return h2


# ------------------------------------------------------------ equiripple

def _lsi(A: np.ndarray, b: np.ndarray, w: np.ndarray,
         max_iter: int = 100) -> np.ndarray:
    """Iteratively reweighted least squares driving towards minimax
    (parity: lsi, core/src/filtrage/rif-eq.cc:132-199 — same update rule:
    p *= 1 + alpha/(emax-emin)*(Ea-emin), alpha=0.5)."""
    x = np.linalg.lstsq(A, b, rcond=None)[0]
    p = np.ones(len(b))
    for _ in range(max_iter):
        e = A @ x - b
        Ea = np.abs(e) * w
        # NOTE: min over ALL rows, like the reference's minCoeff — with
        # zero-weight rows (half-band specs) emin==0 and the tolerance
        # never fires, so both implementations run the full max_iter and
        # reach the same fixpoint (the golden pins this to 3e-7); do not
        # "fix" this to masked-min without re-pinning the golden
        emax, emin = Ea.max(), Ea.min()
        if emax <= 0 or (emax - emin) / emax < 1e-5:
            break
        alpha = 0.5
        p = p * (1 + (alpha / (emax - emin)) * (Ea - emin))
        p = p / p.sum()
        x = np.linalg.lstsq(A * p[:, None], b * p, rcond=None)[0]
    return x


def fir_design_equiripple_grid(nc: int, D: np.ndarray,
                               W: np.ndarray) -> np.ndarray:
    """Equiripple (IRLS) linear-phase FIR from a dense desired-amplitude grid
    D with weights W over frequencies Omega_i = i*pi/len(D)
    (parity: design_rif_eq, rif-eq.cc:205-246)."""
    n = len(D)
    m = (nc + 1) // 2
    i = np.arange(n)[:, None]
    k = np.arange(m)[None, :]
    Om = i * np.pi / n
    A = 2 * np.cos(Om * (k - (nc - 1) / 2.0))
    if nc % 2:
        A[:, m - 1] = 1.0
    x = _lsi(A, np.asarray(D, float), np.asarray(W, float))
    h = np.empty(nc)
    h[: nc // 2] = x[: nc // 2]
    h[-(nc // 2):] = x[: nc // 2][::-1]
    if nc % 2:
        h[nc // 2] = x[nc // 2]
    return h


@dataclasses.dataclass
class FreqIntervalSpec:
    """One band of an equiripple spec (parity: SpecFreqIntervalle,
    core/include/tsd/filtrage.hpp)."""
    fb: float           # band start (normalized)
    fh: float           # band end
    atten: float = 1.0  # desired amplitude in the band
    poids: float = 1.0  # weight


def fir_design_equiripple(nc: int,
                          spec: Sequence[FreqIntervalSpec]) -> np.ndarray:
    """Equiripple FIR from band specs (parity: design_rif_eq(interval),
    rif-eq.cc:248-282; same 16*nc grid and inter-band linear ramps)."""
    eps = 1e-10
    l = 16 * nc
    W = np.zeros(l) + eps
    D = np.ones(l)
    spec = list(spec)
    for i, s in enumerate(spec):
        ib = min(int(round(2 * s.fb * l)), l - 1)
        ih = min(int(round(2 * s.fh * l)), l - 1)
        D[ib:ih + 1] = s.atten
        W[ib:ih + 1] = s.poids + eps
        if i + 1 < len(spec):
            ib2 = min(int(round(2 * spec[i + 1].fb * l)), l - 1)
            cnt = (ib2 - ih) + 1
            if cnt > 1:
                D[ih:ih + cnt] = np.linspace(s.atten, spec[i + 1].atten, cnt)
    return fir_design_equiripple_grid(nc, D, W)


# ---------------------------------------------------- frequency sampling

def fir_freq_sampling_freqs(n: int) -> np.ndarray:
    """Sampling frequencies of the freq-sampling design (parity:
    design_rif_freq_freqs, rif-freq.cc:6-10)."""
    m = (n + 1) // 2
    return np.linspace(0, (m - 1.0) / (2 * m - 1), m)


def fir_design_freq_sampling(nc: int, f: np.ndarray) -> np.ndarray:
    """Linear-phase FIR whose amplitude matches samples ``f`` at
    ``fir_freq_sampling_freqs`` (parity: design_rif_freq,
    rif-freq.cc:35-100: conjugate-symmetric spectrum -> ifft -> fftshift)."""
    F = np.asarray(f, float)
    M = len(F)
    if nc == 0:
        nc = 2 * M - 1
    if nc != 2 * M - 1:
        if nc % 2 == 0:
            nc += 1
        M2 = (nc + 1) // 2
        xi = np.linspace(0, 0.5 * (1 - 1.0 / len(F)), len(F))
        xo = np.linspace(0, 0.5 * (1 - 1.0 / M2), M2)
        F = np.interp(xo, xi, F)
        M = M2
    Hd = np.zeros(nc, dtype=complex)
    Hd[:M] = F
    # conjugate symmetry: Hd[nc-k] = conj(Hd[k])
    Hd[M:] = np.conj(Hd[1:nc - M + 1][::-1])
    hc = np.fft.fftshift(np.fft.ifft(Hd))
    assert np.abs(hc.imag).max() < 1e-3, "real filter expected"
    # reference divides by sqrt(Nc) to undo its orthonormal ifft; with numpy's
    # 1/N ifft the net reference scaling is ifft_np * sqrt(Nc) / sqrt(Nc) = ifft_np
    return hc.real


# ------------------------------------------------------- pulse shaping

def _cs_scalar(t: float, beta: float) -> float:
    # parity: cs(), rif-cs.cc:22-28 (F.J. Harris, Multirate signal
    # processing for communication systems, p.89)
    if beta > 0 and abs(abs(t) - 1 / (2 * beta)) < 1e-7:
        return float(np.sinc(t) * np.pi / 4)
    return float(np.sinc(t) * np.cos(np.pi * beta * t)
                 / (1 - (2 * beta * t) ** 2))


def _rcs_scalar(t: float, beta: float) -> float:
    # parity: rcs(), rif-cs.cc:32-43 (Harris p.90)
    if t == 0:
        return (1 - beta) + 4 * beta / np.pi
    if beta > 0 and abs(abs(t) - 1 / (4 * beta)) < 1e-7:
        return (beta / np.sqrt(2)) * ((1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                                      + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
    return ((np.sin(np.pi * t * (1 - beta))
             + 4 * beta * t * np.cos(np.pi * t * (1 + beta)))
            / (np.pi * t * (1 - (4 * beta * t) ** 2)))


def raised_cosine(n: int, beta: float, fcut: float) -> np.ndarray:
    """Raised-cosine FIR, cutoff fcut=fsymb/2, unit DC gain (parity:
    design_rif_cs, rif-cs.cc:157-177)."""
    m = n // 2
    h = np.array([_cs_scalar((i - m) * fcut * 2, beta) for i in range(n)])
    return h / h.sum()


def root_raised_cosine(n: int, beta: float, osf: float,
                       nrm: str = "s") -> np.ndarray:
    """Root-raised-cosine FIR; ``osf`` = samples per symbol.  ``nrm='e'``
    normalizes energy, else DC sum (parity: design_rif_rcs1,
    rif-cs.cc:126-148)."""
    m = n // 2
    h = np.array([_rcs_scalar((i - m) / osf, beta) for i in range(n)])
    if nrm == "e":
        return h / np.sqrt(np.sum(h * h))
    return h / h.sum()


def bt_to_sigma(BT: float) -> float:
    """GFSK bandwidth-time product -> Gaussian sigma (parity:
    design_rif_gaussien_telecom_BT_vers_sigma, rif-cs.cc:103-106)."""
    return np.sqrt(np.log(2.0)) / (2 * BT * np.pi)


def gaussian_fir(n: int, sigma: float, dt: float = 0.0) -> np.ndarray:
    """Gaussian FIR, unit sum (parity: design_rif_gaussien_gen,
    rif-cs.cc:47-54)."""
    t = np.linspace(-(n - 1) / 2.0, (n - 1) / 2.0, n) + dt
    h = np.exp(-t * t / (2 * sigma * sigma))
    s = h.sum()
    return h / s if s > 0 else h


def gaussian_fir_telecom(n: int, BT: float, osf: int) -> np.ndarray:
    """GFSK pulse-shaping filter: Gaussian (sigma from BT, scaled by osf,
    pre-shifted) convolved with an osf-long moving average (parity:
    design_rif_gaussien_telecom, rif-cs.cc:110-151; verified against the
    reference binary in tests/test_golden_ref2.py).

    The reference's ``convol`` is causal same-length (filtrage.hpp:1673-1680
    — as many outputs as inputs, zeros prepended), so the result keeps n
    taps and the moving average's half-tail is truncated before the final
    renormalization."""
    dec_nrz = (osf - 1.0) / 2
    sigma = bt_to_sigma(BT)
    h1 = gaussian_fir(n, sigma * osf, dec_nrz)
    if np.abs(h1).max() == 0:
        h1 = np.zeros(n)
        h1[n // 2] = 1
    h0 = np.ones(osf) / osf
    h2 = np.convolve(h0, h1)[:n]
    return h2 / h2.sum()


# ----------------------------------------------------------- half-band

def fir_halfband(n: int, fc: float = 0.25) -> np.ndarray:
    """Half-band FIR via the Vaidyanathan-Nguyen trick: design the
    half-length prototype equiripple, then interleave zeros and set the
    center tap to 1/2 (parity: design_rif_demi_bande,
    core/src/reechan/hb.cc:6-96)."""
    assert n % 2 == 1, "half-band filter must have odd length (type I)"
    if not 0.0 < fc <= 0.25:
        raise ValueError(
            f"half-band cutoff must be in (0, 0.25] (the stopband edge "
            f"0.5 - fc cannot fall below the passband); got fc={fc} — "
            f"the clipped design grid would silently fit a near-allpass")
    m = (n - 1) // 2
    pad = False
    if m % 2 == 0:
        n -= 2
        m -= 1
        pad = True
    L = 16 * m
    D = np.ones(L)
    W = np.ones(L)
    idp = int(np.ceil((2 * fc * L) / 0.5))
    idp = min(max(idp, 0), L - 2)
    W[idp:] = 0.0
    g = fir_design_equiripple_grid(m + 1, D, W)
    h = np.zeros(n)
    h[m] = 0.5
    h[0::2] = 0.5 * g
    if pad:
        h = np.concatenate([[0.0], h, [0.0]])
    return h


# ------------------------------------------------------------- Hilbert

def fir_hilbert(n: int, fen: str = "hn") -> np.ndarray:
    """FIR Hilbert transformer (type III), windowed (parity:
    design_rif_hilbert, core/src/filtrage/hilbert.cc:9-22)."""
    assert n % 2 == 1, "n must be odd"
    k = np.arange(n) - n // 2
    h = np.where(k % 2 == 0, 0.0, 2.0 / (np.pi * np.where(k == 0, 1, k)))
    return h * window(fen, n, sym=True)


def fir_differentiator(n: int, centered: bool = False) -> np.ndarray:
    """Differentiator FIR (parity: design_rif_diff,
    core/src/filtrage/filtrage.cc)."""
    if n < 2:
        raise ValueError("n must be >= 2")
    if n == 2:
        return np.array([-1.0, 1.0])
    k = np.arange(n) - n // 2
    if not centered:
        return np.where((k + 1) % 2 == 1, -1.0, 1.0) / (np.pi * (0.5 + k) ** 2)
    h = np.where(k % 2 == 1, -1.0, 1.0) / np.where(k == 0, 1, k)
    h[n // 2] = 0.0
    return h


# ------------------------------------------------------------ analysis

def fir_type(h: np.ndarray) -> int:
    """Linear-phase FIR type 1..4 (parity concept: riftype,
    rif-eq.cc:24-34 — but classified on the WHOLE tap vector, not just the
    endpoints: an antisymmetric filter whose end taps are ~0 (e.g. a
    Hann-windowed Hilbert with zero endpoints) is indistinguishable from
    symmetric at h[0] vs h[-1] alone)."""
    h = np.asarray(h, float)
    n = len(h)
    even = n % 2 == 0
    sym = np.linalg.norm(h - h[::-1])
    asym = np.linalg.norm(h + h[::-1])
    if sym <= asym:
        return 2 if even else 1
    return 4 if even else 3


def fir_amplitude(h: np.ndarray, L: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """Real amplitude response A(f) of a linear-phase FIR on L points in
    [0, 0.5) (parity: rifamp, rif-eq.cc:92-128: FFT, unwrap the linear
    phase)."""
    h = np.asarray(h, float)
    N = len(h)
    M = (N - 1) / 2
    dim = max(2 * L, N)
    H = np.fft.fft(h, dim)[: dim // 2]
    w = np.arange(dim // 2) * np.pi / (dim // 2)
    H = H * np.exp(1j * M * w)
    t = fir_type(h)
    if t in (3, 4):
        H = H * (-1j)
    fr = np.linspace(0, 0.5 - 0.5 / L, L)
    A = np.real(H)
    if dim // 2 != L:
        A = np.interp(fr, np.linspace(0, 0.5 - 0.5 / (dim // 2), dim // 2), A)
    return fr, A


# ---------------------------------------------------------- transforms

def fir_product(h1: np.ndarray, h2: np.ndarray) -> np.ndarray:
    """Cascade of two FIRs = convolution of taps (parity: design_rif_prod)."""
    return np.convolve(h1, h2)


def lowpass_to_highpass_is(h: np.ndarray) -> np.ndarray:
    """LP -> HP by spectral inversion (parity: design_rif_pb2ph_is)."""
    g = -np.asarray(h, float).copy()
    g[len(g) // 2] += 1.0
    return g


def lowpass_to_highpass_rs(h: np.ndarray) -> np.ndarray:
    """LP -> HP by spectral reversal (multiply by (-1)^k)
    (parity: design_rif_pb2ph_rs)."""
    k = np.arange(len(h))
    return np.asarray(h, float) * np.where(k % 2 == 0, 1.0, -1.0)


def lowpass_to_bandpass(h: np.ndarray, fc: float) -> np.ndarray:
    """LP -> BP by modulation to center frequency fc
    (parity: design_rif_pb2pm)."""
    k = np.arange(len(h)) - (len(h) - 1) / 2
    return 2 * np.asarray(h, float) * np.cos(2 * np.pi * fc * k)
