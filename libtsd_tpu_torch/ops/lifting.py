"""Lifting-scheme wavelets (PyTorch), ported from
``libtsd_tpu/ops/lifting.py``: Laurent polynomials, lifting steps,
polyphase form, QMF extraction, and automatic lifting factorization.

Parity: the reference's live lifting machinery — Laurent/`FormePolyphase`/
`QMF` (core/src/fourier/tod.cc:40-205), `Lift`/`LiftElem`
step lists with `lift_haar`/`lift_db2` factories (tod.cc:163-206), and the
generic `OndeletteGen` step engine (tod.cc:211-266).  Beyond the
reference: `factor_lifting` implements the Daubechies-Sweldens Euclidean
factorization numerically, so ANY biorthogonal pair — in particular the
real CDF/bior-3.5, which upstream left as dead code (tod.cc:271-313) —
gets lifting steps automatically; `cdf_filters` builds the CDF(N, Nt)
spline biorthogonal banks from the Daubechies halfband construction.

The algebra (Laurent polynomials, factorization, filter banks) is host
numpy and Python, copied from the JAX package.  The transform is torch: a
lifting step is a short correlation on the half-rate bands, by rolls
(periodised boundary), batched over leading axes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

__all__ = ["Laurent", "LiftStep", "Lift", "lift_haar", "lift_db2",
           "lift_cdf53", "lift_bior35", "cdf_filters", "lift_polyphase",
           "lift_qmf", "factor_lifting", "lift_dwt_level",
           "lift_idwt_level", "lift_dwt", "lift_idwt"]


# ---------------------------------------------------------------------------
# Laurent polynomials  p(z) = sum_i coefs[i] z^(n0+i)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Laurent:
    """Parity: the reference's Laurent wrapper (tod.cc:20-57)."""
    coefs: np.ndarray
    n0: int = 0

    @staticmethod
    def make(coefs, n0: int = 0) -> "Laurent":
        c = np.atleast_1d(np.asarray(coefs, np.float64))
        return Laurent(c, n0).trim()

    def trim(self) -> "Laurent":
        c, n0 = self.coefs, self.n0
        nz = np.nonzero(np.abs(c) > 1e-12)[0]
        if len(nz) == 0:
            return Laurent(np.zeros(1), 0)
        return Laurent(c[nz[0]: nz[-1] + 1].copy(), n0 + int(nz[0]))

    @property
    def is_zero(self) -> bool:
        return np.all(np.abs(self.coefs) <= 1e-12)

    @property
    def lo(self) -> int:
        return self.n0

    @property
    def hi(self) -> int:
        return self.n0 + len(self.coefs) - 1

    def __add__(self, o: "Laurent") -> "Laurent":
        lo = min(self.lo, o.lo)
        hi = max(self.hi, o.hi)
        c = np.zeros(hi - lo + 1)
        c[self.lo - lo: self.lo - lo + len(self.coefs)] += self.coefs
        c[o.lo - lo: o.lo - lo + len(o.coefs)] += o.coefs
        return Laurent(c, lo).trim()

    def __neg__(self) -> "Laurent":
        return Laurent(-self.coefs, self.n0)

    def __sub__(self, o: "Laurent") -> "Laurent":
        return self + (-o)

    def __mul__(self, o) -> "Laurent":
        if isinstance(o, (int, float)):
            return Laurent(self.coefs * o, self.n0).trim()
        return Laurent(np.convolve(self.coefs, o.coefs),
                       self.n0 + o.n0).trim()

    def eval(self, z: complex) -> complex:
        return sum(c * z ** (self.n0 + i)
                   for i, c in enumerate(self.coefs))


def _laurent_div(a: Laurent, b: Laurent) -> Tuple[Laurent, Laurent]:
    """One Euclidean division a = q*b + r with support(r) < support(b),
    cancelling from whichever end keeps the quotient well-defined
    (Laurent division is not unique; this choice suffices for the
    Daubechies-Sweldens factorization of FIR polyphase pairs)."""
    q = Laurent.make(0.0)
    r = a
    nb = len(b.trim().coefs)
    # cancelling the high end strictly reduces r.hi each time, and once
    # r.hi - b.hi < r.lo - b.lo we have len(r) < len(b): guaranteed to
    # terminate with a proper remainder
    while not r.is_zero and len(r.coefs) >= nb:
        qh = Laurent(np.array([r.coefs[-1] / b.coefs[-1]]), r.hi - b.hi)
        q, r = q + qh, (r - qh * b).trim()
    return q, r


# ---------------------------------------------------------------------------
# Lifting schemes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LiftStep:
    """One lifting step (parity: LiftElem): target += p(z) applied to the
    other band; ``predict`` True modifies the detail (odd) band from the
    approximation (even) band, False the reverse."""
    coefs: Tuple[float, ...]
    n0: int
    predict: bool


@dataclasses.dataclass(frozen=True)
class Lift:
    """Parity: Lift (tod.cc:163-206 factories).  ``shift`` is a residual
    diagonal delay z^shift on the approximation band (z^-shift on the
    detail band) that the Euclidean factorization may leave; it is exact
    under the periodized boundary (a roll)."""
    name: str
    steps: Tuple[LiftStep, ...]
    K: float = 1.0
    shift: int = 0
    # False: diag(K z^s, ..) applied AFTER the steps (reference order,
    # tod.cc:69-72); True: applied BEFORE (the order the Euclidean
    # peeling produces: P = M(q1)...M(qn) . D)
    k_first: bool = False


def lift_haar() -> Lift:
    """Parity: lift_haar, tod.cc:163-177."""
    return Lift("haar",
                (LiftStep((-1.0,), 0, True), LiftStep((0.5,), 0, False)),
                K=np.sqrt(2.0))


def lift_db2() -> Lift:
    """Parity: lift_db2, tod.cc:179-206."""
    s3 = np.sqrt(3.0)
    return Lift("db2",
                (LiftStep((s3,), 0, False),
                 LiftStep((-(s3 - 2) / 4, -s3 / 4), -1, True),
                 LiftStep((-1.0,), 1, False)),
                K=(s3 - 1) / np.sqrt(2.0))


def lift_cdf53() -> Lift:
    """LeGall 5/3 — the integer-lifting scheme the reference's dead
    'bior-3-5' code actually encodes (tod.cc:271-313, sans rounding)."""
    return Lift("cdf53",
                (LiftStep((-0.5, -0.5), 0, True),
                 LiftStep((0.25, 0.25), -1, False)),
                K=np.sqrt(2.0))


# ---------------------------------------------------------------------------
# Polyphase form and QMF extraction
# ---------------------------------------------------------------------------

def lift_polyphase(lift: Lift):
    """Accumulate the analysis polyphase matrix [[H00, H01], [H10, H11]]
    from the lifting steps (parity: FormePolyphase, tod.cc:51-73)."""
    zs = Laurent.make(np.array([1.0]), lift.shift)
    zsi = Laurent.make(np.array([1.0]), -lift.shift)
    if lift.k_first:
        H00, H11 = zs * lift.K, zsi * (1.0 / lift.K)
    else:
        H00, H11 = Laurent.make(1.0), Laurent.make(1.0)
    H01, H10 = Laurent.make(0.0), Laurent.make(0.0)
    for st in lift.steps:
        p = Laurent.make(np.asarray(st.coefs), st.n0)
        if st.predict:
            H10 = H10 + p * H00
            H11 = H11 + p * H01
        else:
            H00 = H00 + p * H10
            H01 = H01 + p * H11
    if lift.k_first:
        return ((H00, H01), (H10, H11))
    return ((H00 * lift.K * zs, H01 * lift.K * zs),
            (H10 * (1.0 / lift.K) * zsi, H11 * (1.0 / lift.K) * zsi))


def lift_qmf(lift: Lift) -> Tuple[np.ndarray, np.ndarray]:
    """Causal analysis filters (h_lo, h_hi) from the polyphase form
    (parity: QMF, tod.cc:75-97): H(z) = He(z^2) + z He(z^2)-interleave."""
    (H00, H01), (H10, H11) = lift_polyphase(lift)
    md = -min(H00.lo, H01.lo, H10.lo, H11.lo)

    def interleave(He: Laurent, Ho: Laurent) -> np.ndarray:
        he = Laurent(He.coefs, He.n0 + md)
        ho = Laurent(Ho.coefs, Ho.n0 + md)
        n = 2 * max(he.hi, ho.hi) + 2
        h = np.zeros(n + 1)
        for i, c in enumerate(he.coefs):
            h[2 * (he.n0 + i)] += c
        for i, c in enumerate(ho.coefs):
            h[2 * (ho.n0 + i) + 1] += c
        return np.trim_zeros(h, "b")

    return interleave(H00, H01), interleave(H10, H11)


# ---------------------------------------------------------------------------
# Daubechies-Sweldens factorization (beyond the reference)
# ---------------------------------------------------------------------------

def factor_lifting(h_even, h_odd, g_even, g_odd,
                   name: str = "factored") -> Lift:
    """Factor an analysis polyphase matrix into lifting steps by the
    Euclidean algorithm on Laurent polynomials (Daubechies & Sweldens,
    "Factoring wavelet transforms into lifting steps", 1998).

    Rows: (h_even, h_odd) = lowpass, (g_even, g_odd) = highpass polyphase
    components, det must be a monomial (complementary pair).  Returns a
    Lift whose lift_polyphase reproduces the input (up to fp roundoff).
    """
    def mk(p):
        return p if isinstance(p, Laurent) else Laurent.make(p)
    rows = [[mk(h_even), mk(h_odd)], [mk(g_even), mk(g_odd)]]

    steps_rev: List[LiftStep] = []
    for _ in range(64):
        (a, b), (c, d) = rows
        la = max(len(a.trim().coefs), len(b.trim().coefs))
        lc = max(len(c.trim().coefs), len(d.trim().coefs))
        if la <= 1 and lc <= 1 and b.is_zero and c.is_zero:
            break
        def sc(p):
            return 0 if p.is_zero else len(p.trim().coefs)

        def peel(dst, src):
            # divide the longest dst component by its src counterpart
            # (classic Euclid: quotient length = len(dst)-len(src)+1,
            # remainder strictly shorter); progress = total support shrank
            cands = sorted(range(2), key=lambda j: -sc(dst[j]))
            for j in cands:
                if src[j].is_zero:
                    continue
                q, _ = _laurent_div(dst[j], src[j])
                if q.is_zero:
                    continue
                new = [dst[0] - q * src[0], dst[1] - q * src[1]]
                if sc(new[0]) + sc(new[1]) < sc(dst[0]) + sc(dst[1]):
                    return q, new
            return None, None
        if la >= lc and not (rows[1][0].is_zero and rows[1][1].is_zero):
            q, new = peel(rows[0], rows[1])
            if new is not None:
                rows[0] = new
                steps_rev.append(LiftStep(tuple(q.coefs), q.n0,
                                          predict=False))
                continue
        q, new = peel(rows[1], rows[0])
        if new is None:
            break
        rows[1] = new
        steps_rev.append(LiftStep(tuple(q.coefs), q.n0, predict=True))
    (a, b), (c, d) = rows
    assert b.is_zero and c.is_zero, "factorization did not terminate"
    assert len(a.coefs) == 1 and len(d.coefs) == 1, (a, d)
    K = float(a.coefs[0])
    assert abs(K * d.coefs[0] - 1.0) < 1e-8, \
        f"non-complementary pair: K*1/K = {K * d.coefs[0]}"
    # a residual diagonal delay is carried as Lift.shift (a roll under
    # the periodized boundary)
    assert a.n0 == -d.n0, (a.n0, d.n0)
    lift = Lift(name, tuple(reversed(steps_rev)), K=K, shift=a.n0,
                k_first=True)
    # verify: the polyphase of the factored steps reproduces the input
    (rh0, rh1), (rg0, rg1) = lift_polyphase(lift)
    for got, want in ((rh0, mk(h_even)), (rh1, mk(h_odd)),
                      (rg0, mk(g_even)), (rg1, mk(g_odd))):
        diff = (got - want).trim()
        assert diff.is_zero or np.max(np.abs(diff.coefs)) < 1e-8, \
            (got, want)
    return lift


def cdf_filters(N: int, Nt: int):
    """CDF(N, Nt) biorthogonal spline filters via the Daubechies halfband
    construction: synthesis lowpass = B-spline of order N, analysis
    lowpass = spline(Nt) * Q(y) with Q the binomial halfband completion.
    Returns (dec_lo, rec_lo) as centered numpy arrays summing to sqrt(2).
    bior-3.5 = cdf_filters(3, 5): lengths (12, 4)."""
    assert (N + Nt) % 2 == 0, "N and Nt must have the same parity"
    m = (N + Nt) // 2
    # Q(y) = sum_j C(m-1+j, j) y^j,  y = (2 - z - 1/z)/4
    from math import comb
    y = Laurent.make(np.array([-0.25, 0.5, -0.25]), -1)
    Q = Laurent.make(0.0)
    ypow = Laurent.make(1.0)
    for j in range(m):
        Q = Q + ypow * float(comb(m - 1 + j, j))
        ypow = ypow * y
    spline = Laurent.make(1.0)
    half = Laurent.make(np.array([0.5, 0.5]), 0)
    for _ in range(Nt):
        spline = spline * half
    dec = spline * Q
    rec = Laurent.make(1.0)
    for _ in range(N):
        rec = rec * half
    dec_lo = dec.coefs * np.sqrt(2.0)
    rec_lo = rec.coefs * np.sqrt(2.0)
    return dec_lo, rec_lo


def lift_bior35() -> Lift:
    """The REAL CDF/bior-3.5 lifting scheme, factored automatically from
    the spline construction (the reference's hand-coded version is dead
    code, tod.cc:271-313)."""
    dec_lo, rec_lo = cdf_filters(3, 5)
    # analysis highpass from the synthesis lowpass: g~[n] = (-1)^n g[n]
    # (complementary pair up to centering); build polyphase components
    # with the centering that makes det a constant
    return _lift_from_banks(dec_lo, rec_lo, "bior35")


def _lift_from_banks(dec_lo: np.ndarray, rec_lo: np.ndarray,
                     name: str) -> Lift:
    nh, ng = len(dec_lo), len(rec_lo)
    # center both filters symmetrically around 0: h_k for k in
    # [-(nh-1)/2 .. ] — both CDF filters here have even length? bior3.5:
    # 12 and 4 (even).  Use offsets giving det(P) constant; search small
    # shifts for the one that factors.
    for sh in range(-3, 4):
        for sg in range(-3, 4):
            h = Laurent.make(dec_lo, -(nh // 2) + sh)
            g0 = Laurent.make(rec_lo, -(ng // 2) + sg)
            # analysis highpass g~(z) = z^{-1} g0(-z^{-1}) (alternating
            # signs + reversal)
            gc = np.array([(-1) ** k * c for k, c in
                           enumerate(g0.coefs)])
            gt = Laurent.make(gc[::-1], -(g0.hi) - 1)
            he, ho = _poly_split(h)
            ge, go = _poly_split(gt)
            det = he * go - ho * ge
            d = det.trim()
            if len(d.coefs) == 1 and abs(abs(d.coefs[0]) - 1.0) < 1e-6 \
                    and d.n0 == 0:
                try:
                    return factor_lifting(he, ho, ge, go, name)
                except AssertionError:
                    continue
    raise ValueError("could not find a factorable centering")


def _poly_split(p: Laurent) -> Tuple[Laurent, Laurent]:
    """Polyphase split p(z) = pe(z^2) + z pо(z^2)."""
    ce, ne0, co, no0 = [], None, [], None
    for i, c in enumerate(p.coefs):
        k = p.n0 + i
        if k % 2 == 0:
            if ne0 is None:
                ne0 = k // 2
            ce.append((k // 2, c))
        else:
            if no0 is None:
                no0 = (k - 1) // 2
            co.append(((k - 1) // 2, c))

    def build(entries):
        if not entries:
            return Laurent.make(0.0)
        lo = min(k for k, _ in entries)
        hi = max(k for k, _ in entries)
        c = np.zeros(hi - lo + 1)
        for k, v in entries:
            c[k - lo] += v
        return Laurent(c, lo).trim()

    return build(ce), build(co)


# ---------------------------------------------------------------------------
# Lifting transform on tensors (periodised boundary)
# ---------------------------------------------------------------------------

def _apply_step(target: torch.Tensor, src: torch.Tensor, st: LiftStep,
                sign: float) -> torch.Tensor:
    """target += sign * sum_l coefs[l] src[j + n0 + l] (periodic)."""
    acc = torch.zeros_like(target)
    for l, c in enumerate(st.coefs):
        acc = acc + float(c) * torch.roll(src, -(st.n0 + l), dims=-1)
    return target + sign * acc


def lift_dwt_level(x: torch.Tensor, lift: Lift):
    """One analysis level: (approx, detail), each n/2 long (parity:
    OndeletteGen::lift_step, tod.cc:220-240)."""
    if x.shape[-1] % 2:
        raise ValueError(
            f"lift_dwt needs an even length at every level; got "
            f"n={x.shape[-1]}")
    s, d = x[..., ::2], x[..., 1::2]

    def scale(s, d):
        if lift.shift:
            s = torch.roll(s, -lift.shift, dims=-1)
            d = torch.roll(d, lift.shift, dims=-1)
        return s * float(lift.K), d * (1.0 / float(lift.K))

    if lift.k_first:
        s, d = scale(s, d)
    for st in lift.steps:
        if st.predict:
            d = _apply_step(d, s, st, +1.0)
        else:
            s = _apply_step(s, d, st, +1.0)
    if not lift.k_first:
        s, d = scale(s, d)
    return s, d


def lift_idwt_level(s: torch.Tensor, d: torch.Tensor,
                    lift: Lift) -> torch.Tensor:
    """Inverse level (parity: OndeletteGen::ilift_step, tod.cc:241-265)."""
    def unscale(s, d):
        s = s * (1.0 / float(lift.K))
        d = d * float(lift.K)
        if lift.shift:
            s = torch.roll(s, lift.shift, dims=-1)
            d = torch.roll(d, -lift.shift, dims=-1)
        return s, d

    if not lift.k_first:
        s, d = unscale(s, d)
    for st in reversed(lift.steps):
        if st.predict:
            d = _apply_step(d, s, st, -1.0)
        else:
            s = _apply_step(s, d, st, -1.0)
    if lift.k_first:
        s, d = unscale(s, d)
    # interleave: out[2i] = s[i], out[2i+1] = d[i]
    return torch.stack([s, d], dim=-1).flatten(-2)


def lift_dwt(x: torch.Tensor, lift: Lift, levels: int = 1):
    """Multi-level analysis: [d1, d2, ..., a_last] (parity: dwt,
    tod.cc:569-583)."""
    if x.shape[-1] % (1 << levels):
        raise ValueError(
            f"lift_dwt: n={x.shape[-1]} must be a multiple of "
            f"2^levels={1 << levels}")
    coeffs = []
    a = x
    for _ in range(levels):
        a, d = lift_dwt_level(a, lift)
        coeffs.append(d)
    coeffs.append(a)
    return coeffs


def lift_idwt(coeffs, lift: Lift) -> torch.Tensor:
    a = coeffs[-1]
    for d in reversed(coeffs[:-1]):
        a = lift_idwt_level(a, d, lift)
    return a
