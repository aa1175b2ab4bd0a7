"""IIR filter design from analog prototypes (design-time, host numpy float64).

A copy of ``libtsd_tpu/ops/iir_design.py`` (numpy only), so that the port
imports nothing of the JAX package.

Parity: core/src/filtrage/rii.cc (Butterworth/Chebyshev I+II/elliptic analog
prototypes, LP->HP analog transform, bilinear transform with prewarping,
RBJ biquads) and core/src/filtrage/filtrage.cc:110-216 (first-order designs).

Representation: ``ZPK`` (zeros, poles, gain) — numerically robust root form,
the equivalent of the reference's factored ``FRat``/``Poly`` root mode
(core/include/tsd/filtrage/frat.hpp).  Conversions to (b, a) coefficients and
to second-order sections feed the runtime.

Improvement over the reference: full LP->BP and LP->BS analog transforms (the
reference's pban_vers_pbda, rii.cc:148-171, is an unfinished copy of the HP
transform and design_riia rejects band-pass/stop, rii.cc:432).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

__all__ = [
    "ZPK", "bilinear", "fd_to_fa", "fa_to_fd",
    "butterworth_analog", "cheby1_analog", "cheby2_analog", "elliptic_analog",
    "lp_to_lp", "lp_to_hp", "lp_to_bp", "lp_to_bs",
    "design_iir", "BiquadSpec", "design_biquad",
    "lexp_coef", "lexp_coef_to_fc", "lexp_tc_to_coef", "lexp_coef_to_tc",
    "design_lexp", "design_dc_blocker", "design_notch", "design_mg",
    "zpk_to_sos",
]


@dataclasses.dataclass
class ZPK:
    """Zeros / poles / gain transfer function, analog (s) or digital (z)."""
    z: np.ndarray
    p: np.ndarray
    k: float

    def to_ba(self) -> Tuple[np.ndarray, np.ndarray]:
        b = np.atleast_1d(np.real_if_close(self.k * np.poly(self.z), tol=1000))
        a = np.atleast_1d(np.real_if_close(np.poly(self.p), tol=1000))
        return np.real(b), np.real(a)

    def freq_response(self, f: np.ndarray, analog: bool = False) -> np.ndarray:
        """Evaluate H at normalized frequencies f (digital: z=e^{2*pi*i*f};
        analog: s = 2*pi*i*f)."""
        f = np.asarray(f, float)
        s = (2j * np.pi * f) if analog else np.exp(2j * np.pi * f)
        num = self.k * np.ones_like(s, dtype=complex)
        for z0 in self.z:
            num = num * (s - z0)
        den = np.ones_like(s, dtype=complex)
        for p0 in self.p:
            den = den * (s - p0)
        return num / den


# ------------------------------------------------------ bilinear transform

def fd_to_fa(fd: float) -> float:
    """Digital frequency -> prewarped analog frequency (parity: fd_vers_fa,
    rii.cc:29-32)."""
    return np.tan(np.pi * fd) / np.pi


def fa_to_fd(fa: float) -> float:
    """Parity: fa_vers_fd, rii.cc:34-37."""
    return np.arctan(np.pi * fa) / np.pi


def bilinear(ha: ZPK, fe: float = 1.0) -> ZPK:
    """Analog -> digital via the bilinear transform s = 2fe (z-1)/(z+1)
    (parity: trf_bilineaire, rii.cc:40-72: maps each root r -> (2fe+r)/(2fe-r),
    pads the shorter side with roots at -1, gain = prod(2fe-z)/prod(2fe-p))."""
    K = 2.0 * fe
    zd = (K + ha.z) / (K - ha.z)
    pd = (K + ha.p) / (K - ha.p)
    nz, npo = len(ha.z), len(ha.p)
    gain = ha.k * np.real(np.prod(K - ha.z) / np.prod(K - ha.p))
    if nz < npo:
        zd = np.concatenate([zd, -np.ones(npo - nz)])
    elif npo < nz:
        pd = np.concatenate([pd, -np.ones(nz - npo)])
    return ZPK(zd, pd, gain)


# ------------------------------------------------------- analog prototypes

def butterworth_analog(n: int) -> ZPK:
    """Normalized Butterworth prototype, wc=1 (parity:
    butterworth_analogique, rii.cc:196-218)."""
    k = np.arange(1, n + 1)
    poles = np.exp(1j * np.pi * (2 * k + n - 1) / (2 * n))
    return ZPK(np.array([], complex), poles, 1.0)


def cheby1_analog(n: int, rp: float) -> ZPK:
    """Chebyshev type I prototype, passband ripple rp dB, DC gain forced to 1
    (parity: tchebychev_I_analogique, rii.cc:339-370)."""
    m = np.arange(1, n + 1)
    theta = (2 * m - 1) * np.pi / (2 * n)
    eps = np.sqrt(10 ** (rp / 10.0) - 1)
    ash = np.arcsinh(1.0 / eps) / n
    s, c = np.sinh(ash), np.cosh(ash)
    poles = -np.abs(np.sin(theta)) * abs(s) + 1j * np.cos(theta) * c
    k = np.real(np.prod(-poles))
    return ZPK(np.array([], complex), poles, k)


def cheby2_analog(n: int, rs: float) -> ZPK:
    """Chebyshev type II (inverse) prototype, stopband attenuation rs dB
    (parity: tchebychev_II_analogique, rii.cc:372-404)."""
    m = np.arange(1, n + 1)
    theta = (2 * m - 1) * np.pi / (2 * n)
    eps = 1.0 / np.sqrt(10 ** (rs / 10.0) - 1)
    ash = np.arcsinh(1.0 / eps) / n
    s, c = np.sinh(ash), np.cosh(ash)
    poles = 1.0 / (-np.abs(np.sin(theta)) * abs(s) + 1j * np.cos(theta) * c)
    zeros = 1.0 / (-1j * np.cos(np.pi / 2 * (2 * m - 1) / n))
    # even n: all zeros finite; odd n: the middle zero is at infinity
    if n % 2:
        zeros = np.delete(zeros, n // 2)
    k = np.real(np.prod(-poles) / np.prod(-zeros))
    return ZPK(zeros, poles, k)


def elliptic_analog(n: int, rp: float, rs: float) -> ZPK:
    """Elliptic (Cauer) prototype after Orchard & Willson, "Elliptic Functions
    for Filter Design", IEEE Trans. CAS, 1997 — the same algorithm the
    reference transcribes (elliptique_analogique, rii.cc:221-338): Landen
    descent on the modulus, pole/zero recovery through the ek recursion."""
    if n == 1:
        p = -np.sqrt(1.0 / (10 ** (rp / 10.0) - 1))
        return ZPK(np.array([], complex), np.array([p], complex), -p.real)

    dbn = np.log(10.0) / 20.0
    apn = dbn * rp
    asn_ = dbn * rs
    g = []
    e0 = np.sqrt(2 * np.exp(apn) * np.sinh(apn))
    g.append(e0 / np.sqrt(np.exp(2 * asn_) - 1))
    v = g[0]
    while v > 1e-150:
        v = (v / (1 + np.sqrt(1 - v * v))) ** 2
        g.append(v)
    m2 = len(g)
    ek = np.zeros(m2 + 11)
    m1 = m2
    for index in range(11):
        m1 = m2 + index
        ek[m1 - 1] = 4 * (g[m2 - 1] / 4) ** ((1 << index) / n)
        if ek[m1 - 1] < 1e-14:
            break
    for i in range(m1 - 1, 0, -1):
        ek[i - 1] = 2 * np.sqrt(ek[i]) / (1 + ek[i])

    e = np.zeros(m2)
    e[0] = e0
    for i in range(1, m2):
        a = (1 + g[i]) * e[i - 1] / 2
        e[i] = a + np.sqrt(a * a + g[i])
    u2 = np.log((1 + np.sqrt(1 + e[m2 - 1] ** 2)) / e[m2 - 1]) / n

    def cosc(x: complex) -> complex:
        return complex(np.cos(x.real) * np.cosh(x.imag),
                       -np.sin(x.real) * np.sinh(x.imag))

    poles: List[complex] = []
    zeros: List[complex] = []
    for i in range(n // 2):
        u1 = (2 * i + 1) * np.pi / (2 * n)
        c = -1j / cosc(complex(-u1, u2))
        d = 1.0 / np.cos(u1)
        for j in range(m1, 1, -1):
            c = (c - ek[j - 1] / c) / (1 + ek[j - 1])
            d = (d + ek[j - 1] / d) / (1 + ek[j - 1])
        poles.append(1.0 / c)
        poles.append(np.conj(1.0 / c))
        zeros.append(1j * d / ek[0])
        zeros.append(-1j * d / ek[0])
    if n % 2:
        a = 1.0 / np.sinh(u2)
        # NOTE: the reference indexes ek(j) here (rii.cc:315) where its
        # complex-pole loop uses ek(j-1) — an off-by-one vs the published
        # Orchard-Willson recursion.  We use ek[j-1], which matches the
        # paper and scipy.ellipap exactly.
        for j in range(m1, 1, -1):
            a = (a - ek[j - 1] / a) / (1.0 + ek[j - 1])
        poles.append(-1.0 / a)
    hz = np.array(zeros, complex)
    hp = np.array(poles, complex)
    k = np.real(np.prod(-hp) / np.prod(-hz))
    if n % 2 == 0:
        # even order: passband edge (not DC) touches 0 dB -> scale DC down
        k /= np.sqrt(1 + (np.exp(apn * 2) - 1))
    return ZPK(hz, hp, k)


# ----------------------------------------------------- analog transforms

def lp_to_lp(ha: ZPK, wc: float) -> ZPK:
    """Scale the normalized prototype to cutoff wc (parity: pban_vers_pba,
    rii.cc:175-189)."""
    deg = len(ha.p) - len(ha.z)
    return ZPK(ha.z * wc, ha.p * wc, ha.k * wc ** deg)


def lp_to_hp(ha: ZPK, wc: float) -> ZPK:
    """Normalized LP -> HP at wc (parity: pban_vers_pha, rii.cc:124-144)."""
    z, p, k = ha.z, ha.p, ha.k
    deg = len(p) - len(z)
    zh = wc / z if len(z) else np.array([], complex)
    ph = wc / p
    # s^deg zeros at origin from the inversion
    zh = np.concatenate([zh, np.zeros(deg, complex)])
    kh = k * np.real(np.prod(-z) / np.prod(-p))
    return ZPK(zh, ph, kh)


def lp_to_bp(ha: ZPK, w0: float, bw: float) -> ZPK:
    """Normalized LP -> band-pass centered w0 with bandwidth bw (standard
    transform s -> (s^2 + w0^2)/(bw*s); completes the reference's unfinished
    pban_vers_pbda, rii.cc:148-171)."""
    z, p, k = ha.z, ha.p, ha.k
    deg = len(p) - len(z)
    zs = z * bw / 2
    ps = p * bw / 2
    zb = np.concatenate([zs + np.sqrt(zs ** 2 - w0 ** 2),
                         zs - np.sqrt(zs ** 2 - w0 ** 2)]) if len(z) else np.array([], complex)
    pb = np.concatenate([ps + np.sqrt(ps ** 2 - w0 ** 2),
                         ps - np.sqrt(ps ** 2 - w0 ** 2)])
    zb = np.concatenate([zb, np.zeros(deg, complex)])
    kb = k * bw ** deg
    return ZPK(zb, pb, kb)


def lp_to_bs(ha: ZPK, w0: float, bw: float) -> ZPK:
    """Normalized LP -> band-stop (standard transform s -> bw*s/(s^2+w0^2))."""
    z, p, k = ha.z, ha.p, ha.k
    deg = len(p) - len(z)
    zi = bw / 2 / z if len(z) else np.array([], complex)
    pi = bw / 2 / p
    zb = np.concatenate([zi + np.sqrt(zi ** 2 - w0 ** 2),
                         zi - np.sqrt(zi ** 2 - w0 ** 2)]) if len(z) else np.array([], complex)
    pb = np.concatenate([pi + np.sqrt(pi ** 2 - w0 ** 2),
                         pi - np.sqrt(pi ** 2 - w0 ** 2)])
    # zeros at +-j w0 from the transform
    extra = np.concatenate([np.full(deg, 1j * w0), np.full(deg, -1j * w0)])
    zb = np.concatenate([zb, extra])
    kb = k * np.real(np.prod(-z) / np.prod(-p))
    return ZPK(zb, pb, kb)


# -------------------------------------------------------------- top level

_PROTOS = {
    "butt": "butt", "butterworth": "butt",
    "cheb1": "cheb1", "cheb2": "cheb2",
    "ellip": "ellip", "elliptic": "ellip",
}


def design_iir(n: int, typ: str, proto: str, fcut: float,
               rp: float = 1.0, rs: float = 40.0,
               fcut2: float = 0.0) -> ZPK:
    """Digital IIR from an analog prototype via prewarped bilinear transform.

    typ: 'lp' | 'hp' | 'bp' | 'sb';  proto: 'butt' | 'cheb1' | 'cheb2' |
    'ellip'; rp = passband ripple dB, rs = stopband attenuation dB.
    Parity: design_riia, rii.cc:406-449 (+ band-pass/stop completed here).
    """
    key = next((v for k, v in _PROTOS.items() if proto.lower().startswith(k)), None)
    if key is None:
        raise ValueError(f"unknown prototype {proto!r}")
    # strict (0, 0.5) for the prewarped bilinear transform: tan(pi*f)
    # flips sign past Nyquist and the designed filter comes out UNSTABLE
    # with no other symptom
    if not (0.0 < fcut < 0.5):
        raise ValueError(
            f"design_iir: fcut={fcut} must be in (0, 0.5) "
            f"(normalized cycles/sample, Nyquist excluded)")
    if typ in ("bp", "pm", "sb"):   # "pm" = passe-milieu alias of "bp":
        # the dispatch below accepts it, so it must NOT bypass the
        # band-edge check (fcut2=0 degenerates lp_to_bp to a marginally
        # unstable pole at z=1)
        if not (fcut < fcut2 < 0.5):
            raise ValueError(
                f"design_iir: band edges need fcut < fcut2 < 0.5 "
                f"(got {fcut}, {fcut2})")
    if key == "butt":
        ha = butterworth_analog(n)
    elif key == "cheb1":
        ha = cheby1_analog(n, rp)
    elif key == "cheb2":
        ha = cheby2_analog(n, rs)
    else:
        ha = elliptic_analog(n, rp, rs)

    wa = 2 * np.tan(2 * np.pi * fcut / 2)  # prewarp, fe=1 (rii.cc:408)
    if typ in ("lp", "pb"):
        ha = lp_to_lp(ha, wa)
    elif typ in ("hp", "ph"):
        ha = lp_to_hp(ha, wa)
    elif typ in ("bp", "pm"):
        wa2 = 2 * np.tan(np.pi * fcut2)
        w0 = np.sqrt(wa * wa2)
        ha = lp_to_bp(ha, w0, wa2 - wa)
    elif typ == "sb":
        wa2 = 2 * np.tan(np.pi * fcut2)
        w0 = np.sqrt(wa * wa2)
        ha = lp_to_bs(ha, w0, wa2 - wa)
    else:
        raise ValueError(f"unknown filter type {typ!r}")
    return bilinear(ha, 1.0)


# ----------------------------------------------------------------- biquads

@dataclasses.dataclass
class BiquadSpec:
    """Parity: BiquadSpec, core/include/tsd/filtrage.hpp:564-652."""
    type: str = "lp"     # lp/hp/bp/notch/res/lowshelf/highshelf
    f: float = 0.25      # characteristic frequency (normalized)
    Q: float = 0.707
    gain_db: float = 0.0


def design_biquad(spec: BiquadSpec) -> Tuple[np.ndarray, np.ndarray]:
    """RBJ audio-EQ-cookbook biquad -> (b, a), a0 normalized to 1
    (parity: design_biquad, rii.cc:578-640)."""
    A = np.sqrt(10 ** (spec.gain_db / 20.0))
    w = 2 * np.pi * spec.f
    sn, cs = np.sin(w), np.cos(w)
    alpha = sn / (2 * spec.Q)
    beta = np.sqrt(2 * A)
    t = spec.type
    if t in ("lp", "pb"):
        b = [(1 - cs) / 2, 1 - cs, (1 - cs) / 2]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif t in ("hp", "ph"):
        b = [(1 + cs) / 2, -(1 + cs), (1 + cs) / 2]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif t == "bp":
        b = [alpha, 0.0, -alpha]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif t in ("notch", "cb", "sb"):
        b = [1.0, -2 * cs, 1.0]
        a = [1 + alpha, -2 * cs, 1 - alpha]
    elif t == "res":
        b = [1 + alpha * A, -2 * cs, 1 - alpha * A]
        a = [1 + alpha / A, -2 * cs, 1 - alpha / A]
    elif t in ("lowshelf", "plateau-bf"):
        b = [A * ((A + 1) - (A - 1) * cs + beta * sn),
             2 * A * ((A - 1) - (A + 1) * cs),
             A * ((A + 1) - (A - 1) * cs - beta * sn)]
        a = [(A + 1) + (A - 1) * cs + beta * sn,
             -2 * ((A - 1) + (A + 1) * cs),
             (A + 1) + (A - 1) * cs - beta * sn]
    elif t in ("highshelf", "plateau-hf"):
        b = [A * ((A + 1) + (A - 1) * cs + beta * sn),
             -2 * A * ((A - 1) + (A + 1) * cs),
             A * ((A + 1) + (A - 1) * cs - beta * sn)]
        a = [(A + 1) - (A - 1) * cs + beta * sn,
             2 * ((A - 1) - (A + 1) * cs),
             (A + 1) - (A - 1) * cs - beta * sn]
    else:
        raise ValueError(f"unknown biquad type {t!r}")
    b, a = np.asarray(b, float), np.asarray(a, float)
    return b / a[0], a / a[0]


# ---------------------------------------------------- first-order designs

def lexp_coef(fc: float) -> float:
    """Exponential smoother forget factor from cutoff (parity: lexp_coef,
    filtrage.cc:121-124)."""
    return 1.0 - np.exp(-fc * 2 * np.pi)


def lexp_tc_to_coef(tau: float) -> float:
    return lexp_coef(1.0 / (2 * np.pi * tau))


def lexp_coef_to_fc(gamma: float) -> float:
    return -np.log(1.0 - gamma) / (2 * np.pi)


def lexp_coef_to_tc(gamma: float) -> float:
    return 1.0 / (2 * np.pi * lexp_coef_to_fc(gamma))


def design_lexp(fc: float) -> Tuple[np.ndarray, np.ndarray]:
    """First-order exponential smoother y = g*x + (1-g)*y'  -> (b, a)
    (parity: design_lexp, filtrage.cc:160-167)."""
    g = lexp_coef(fc)
    return np.array([g]), np.array([1.0, -(1.0 - g)])


def design_dc_blocker(fc: float) -> Tuple[np.ndarray, np.ndarray]:
    """DC blocker r(z-1)/(z-r) (parity: design_bloqueur_dc,
    filtrage.cc:152-158)."""
    r = 1.0 - lexp_coef(fc)
    return np.array([r, -r]), np.array([1.0, -r])


def design_notch(f0: float, fc: float) -> Tuple[np.ndarray, np.ndarray]:
    """Second-order notch at f0 with width set by fc (parity: design_notch,
    filtrage.cc:140-150)."""
    g = lexp_coef(fc)
    r = 1.0 - g
    c = np.cos(2 * np.pi * f0)
    b = r * np.array([1.0, -2 * c, 1.0])
    a = np.array([1.0, -2 * r * c, r * r])
    return b, a


def design_mg(K: int) -> Tuple[np.ndarray, np.ndarray]:
    """Moving-average FIR as a TF (parity: design_mg, filtrage.cc:205-214)."""
    return np.ones(K) / K, np.array([1.0])


# ----------------------------------------------------------------- SOS

def zpk_to_sos(h: ZPK) -> Tuple[np.ndarray, float]:
    """Pair poles/zeros into second-order sections.

    Returns (sos, k) where sos has shape (nsec, 6) rows [b0 b1 b2 1 a1 a2]
    and k is the overall gain.  Pairing: sort poles by closeness to the unit
    circle, pair each conjugate pole pair with the nearest zero pair —
    the strategy of the reference's SOS decomposition
    (core/src/filtrage/filtre-rt.cc:295-581).
    """
    z = list(np.asarray(h.z, complex))
    p = list(np.asarray(h.p, complex))
    n = max(len(z), len(p))
    nsec = (n + 1) // 2
    # pad to even counts with zeros at origin / poles at origin
    while len(z) < 2 * nsec:
        z.append(0.0 + 0j)
    while len(p) < 2 * nsec:
        p.append(0.0 + 0j)

    # group into conjugate pairs (reals paired together)
    def pair_up(roots):
        roots = sorted(roots, key=lambda r: (abs(r.imag) < 1e-12, -abs(r)))
        cplx = [r for r in roots if abs(r.imag) >= 1e-12 and r.imag > 0]
        reals = [r.real for r in roots if abs(r.imag) < 1e-12]
        pairs = [(c, np.conj(c)) for c in cplx]
        for i in range(0, len(reals) - 1, 2):
            pairs.append((reals[i], reals[i + 1]))
        if len(reals) % 2:
            pairs.append((reals[-1], None))
        return pairs

    ppairs = pair_up(p)
    zpairs = pair_up(z)
    # pole pairs closest to the unit circle FIRST, so they get first pick
    # of the nearest zero pair (best cancellation where conditioning is
    # most critical)
    ppairs.sort(key=lambda pr: abs(1 - abs(pr[0])))
    # match each pole pair with nearest zero pair
    sos_rows = []
    zleft = list(zpairs)
    for pp in ppairs:
        if zleft:
            dists = [abs(pp[0] - zp[0]) for zp in zleft]
            zp = zleft.pop(int(np.argmin(dists)))
        else:
            zp = (0.0, 0.0)
        def poly2(pair):
            r1, r2 = pair
            if r2 is None:
                return np.array([1.0, -np.real(r1), 0.0])
            return np.array([1.0, -np.real(r1 + r2), np.real(r1 * r2)])
        brow = poly2(zp)
        arow = poly2(pp)
        sos_rows.append(np.concatenate([brow, arow]))
    sos = np.array(sos_rows) if sos_rows else np.zeros((0, 6))
    return sos, float(np.real(h.k))
