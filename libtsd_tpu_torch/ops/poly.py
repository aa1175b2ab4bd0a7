"""Polynomials and rational transfer functions (design-time, host numpy),
a copy of ``libtsd_tpu/ops/poly.py`` (tests/test_torch_poly.py holds the
two equal).

Parity: core/include/tsd/filtrage/frat.hpp (Poly<T>/FRat<T>) and
core/src/filtrage/frat.cc (roots via companion matrix).  What remains
useful at design time of the reference's expression templates is root
finding, evaluation, and the coefficient<->root conversions, which numpy
provides directly; thin wrappers keep the reference's conventions
(coefficients in ascending power order, like Poly<T>::coefs).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "poly_roots", "poly_from_roots", "horner", "polymul", "polyadd",
    "chebyshev_T", "chebyshev_U", "freq_response_ba", "group_delay_ba",
]


def poly_roots(coefs: np.ndarray) -> np.ndarray:
    """Roots of a polynomial given ascending-order coefficients (parity:
    Poly::roots via companion-matrix eigensolver, frat.cc:40-86)."""
    c = np.trim_zeros(np.asarray(coefs), "b")
    if len(c) <= 1:
        return np.array([], complex)
    return np.roots(c[::-1])


def poly_from_roots(roots: np.ndarray) -> np.ndarray:
    """Ascending-order coefficients from roots (monic)."""
    return np.poly(np.asarray(roots))[::-1]


def horner(coefs: np.ndarray, x):
    """Evaluate ascending-order polynomial at x (parity: horner,
    frat.hpp)."""
    acc = np.zeros_like(np.asarray(x), dtype=np.result_type(coefs, x))
    for c in np.asarray(coefs)[::-1]:
        acc = acc * x + c
    return acc


def polymul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.convolve(a, b)


def polyadd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    n = max(len(a), len(b))
    out = np.zeros(n, dtype=np.result_type(a, b))
    out[: len(a)] += a
    out[: len(b)] += b
    return out


def chebyshev_T(n: int) -> np.ndarray:
    """Chebyshev polynomial of the first kind, ascending coefficients
    (parity: Chebychev_T, core/src/divers.cc:55-91)."""
    t0 = np.array([1.0])
    t1 = np.array([0.0, 1.0])
    if n == 0:
        return t0
    for _ in range(n - 1):
        t2 = polyadd(np.concatenate([[0.0], 2 * t1]), -t0)
        t0, t1 = t1, t2
    return t1


def chebyshev_U(n: int) -> np.ndarray:
    """Chebyshev polynomial of the second kind (parity: Chebychev_U)."""
    t0 = np.array([1.0])
    t1 = np.array([0.0, 2.0])
    if n == 0:
        return t0
    for _ in range(n - 1):
        t2 = polyadd(np.concatenate([[0.0], 2 * t1]), -t0)
        t0, t1 = t1, t2
    return t1


def freq_response_ba(b: np.ndarray, a: np.ndarray,
                     f: np.ndarray) -> np.ndarray:
    """H(e^{2 pi i f}) for coefficients in z^-1 (b, a descending delays:
    b[0] + b[1] z^-1 + ...) — the digital-filter convention of the runtime."""
    z = np.exp(-2j * np.pi * np.asarray(f, float))
    num = horner(np.asarray(b), z)
    den = horner(np.asarray(a), z)
    return num / den


def group_delay_ba(b: np.ndarray, a: np.ndarray,
                   f: np.ndarray) -> np.ndarray:
    """Group delay in samples via the derivative-of-phase ramp trick."""
    f = np.asarray(f, float)
    df = 1e-5
    h0 = freq_response_ba(b, a, f - df / 2)
    h1 = freq_response_ba(b, a, f + df / 2)
    dphi = np.angle(h1 * np.conj(h0))
    return -dphi / (2 * np.pi * df)


# ---------------------------------------------------------------------------
# Rational functions (transfer functions)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FRat:
    """Rational function num/den, coefficients in ASCENDING powers of the
    variable (z^-1 for digital transfer functions, s for analog).

    Parity: FRat<T>, core/include/tsd/filtrage/frat.hpp:
    16-916 — construction from coefficients or zeros/poles/gain, pointwise
    evaluation (horner), product/sum/inverse algebra, factored-form
    simplification (``simplify``: cancel matching zero/pole pairs) and
    display.
    """
    num: np.ndarray
    den: np.ndarray

    @staticmethod
    def make(num, den=(1.0,)) -> "FRat":
        trim = lambda c: np.trim_zeros(np.atleast_1d(
            np.asarray(c, np.complex128 if np.iscomplexobj(c)
                       else np.float64)), "b")
        n, d = trim(num), trim(den)
        return FRat(n if len(n) else np.zeros(1),
                    d if len(d) else np.ones(1))

    @staticmethod
    def from_zpk(zeros, poles, k: float = 1.0) -> "FRat":
        """Parity: FRat::z_pôles_gain (factored construction)."""
        def p(roots):
            r = np.asarray(roots)
            if r.size == 0:
                return np.ones(1)
            return np.atleast_1d(poly_from_roots(r))   # ascending
        return FRat.make(k * p(zeros), p(poles))

    # --- evaluation -----------------------------------------------------
    def __call__(self, x):
        return horner(self.num, x) / horner(self.den, x)

    # --- zeros/poles ----------------------------------------------------
    @property
    def zeros(self) -> np.ndarray:
        return poly_roots(self.num)

    @property
    def poles(self) -> np.ndarray:
        return poly_roots(self.den)

    @property
    def gain(self) -> float:
        return self.num[-1] / self.den[-1] if len(self.den) else self.num[-1]

    # --- algebra (parity: frat.hpp operator*/+, inv) --------------------
    def __mul__(self, o) -> "FRat":
        if isinstance(o, (int, float, complex)):
            return FRat.make(self.num * o, self.den)
        # NO auto-simplify: simplify() round-trips through np.roots,
        # which scatters repeated/clustered roots (a (1-z)^2 cascaded 8x
        # evaluated with 59x relative error after the round-trip) — the
        # reference's 'simplifier' is an explicit call too
        return FRat.make(np.convolve(self.num, o.num),
                         np.convolve(self.den, o.den))

    __rmul__ = __mul__

    def __add__(self, o) -> "FRat":
        if isinstance(o, (int, float, complex)):
            o = FRat.make([o])
        num = polyadd(np.convolve(self.num, o.den),
                      np.convolve(o.num, self.den))
        return FRat.make(num, np.convolve(self.den, o.den))

    def inv(self) -> "FRat":
        """Parity: FRat::inv."""
        return FRat.make(self.den, self.num)

    # --- simplification (parity: frat.hpp 'simplifier') -----------------
    def simplify(self, tol: float = 1e-8) -> "FRat":
        """Cancel zero/pole pairs that match within ``tol`` (the factored
        form's common-root elimination; parity: the reference's explicit
        `simplifier`).  CAVEAT: works through np.roots/np.poly, which is
        ill-conditioned for repeated/clustered roots — only call when a
        cancellation is actually expected.  Returns self unchanged when
        nothing cancels (skipping the lossy round-trip)."""
        z = list(self.zeros)
        p = list(self.poles)
        kept_z = []
        for zz in z:
            hit = None
            for i, pp in enumerate(p):
                if abs(zz - pp) < tol * max(1.0, abs(pp)):
                    hit = i
                    break
            if hit is None:
                kept_z.append(zz)
            else:
                p.pop(hit)
        if len(kept_z) == len(self.zeros):
            return self          # nothing cancelled: skip the round-trip
        out = FRat.from_zpk(np.asarray(kept_z), np.asarray(p), 1.0)
        # rescale so the function value is preserved (probe away from
        # the remaining roots/poles)
        probe = 1.2345 + 0.6789j
        scale = complex(self(probe)) / complex(out(probe))
        num = np.real_if_close(out.num * scale, tol=1e6)
        den = np.real_if_close(out.den, tol=1e6)
        if not np.iscomplexobj(self.num):
            num, den = np.real(num), np.real(den)
        return FRat.make(num, den)

    # --- display (parity: frat.hpp operator<<) --------------------------
    def factored_str(self, var: str = "z") -> str:
        def fmt(roots):
            return " ".join(f"({var} - {r:.4g})" for r in roots)
        return (f"{self.gain:.4g} * [{fmt(self.zeros)}] / "
                f"[{fmt(self.poles)}]")

    def __str__(self) -> str:
        return self.factored_str()
