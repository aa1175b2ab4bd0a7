"""The port's ``ops/poly.py`` is a copy of the JAX package's (numpy, host):
same inputs, bit-identical outputs (np.array_equal)."""
import numpy as np
import pytest

from libtsd_tpu.ops import poly as Pj
from libtsd_tpu_torch.ops import poly as Pt
import torch_compare  # noqa: F401  (caps the thread pools)

rng = np.random.default_rng(9)
A = np.array([2.0, -3.0, 0.5, 1.0])
B = np.array([1.0, 0.25])
ROOTS = np.array([0.5, -0.25 + 0.5j, -0.25 - 0.5j])
F = np.linspace(0.0, 0.5, 33)


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,args", [
    ("poly_roots", (A,)), ("poly_roots", (np.array([3.0, 0.0]),)),
    ("poly_from_roots", (ROOTS,)), ("horner", (A, 0.3 + 0.2j)),
    ("horner", (A, F)), ("polymul", (A, B)), ("polyadd", (A, B)),
    ("chebyshev_T", (7,)), ("chebyshev_U", (6,)),
    ("freq_response_ba", (B, A[::-1], F)),
    ("group_delay_ba", (B, np.array([1.0, -0.5]), F))],
    ids=lambda v: v if isinstance(v, str) else "")
def test_functions_identical(name, args):
    assert same(getattr(Pt, name)(*args), getattr(Pj, name)(*args))


def test_frat_identical():
    """FRat's construction, evaluation, roots, algebra, simplification and
    display."""
    fj = Pj.FRat.from_zpk([0.5, -0.2], [0.9, 0.1], 2.0)
    ft = Pt.FRat.from_zpk([0.5, -0.2], [0.9, 0.1], 2.0)
    for a, b in ((ft.num, fj.num), (ft.den, fj.den), (ft(F), fj(F)),
                 (ft.zeros, fj.zeros), (ft.poles, fj.poles),
                 ((ft * ft).num, (fj * fj).num), ((ft + 1.5).num,
                                                  (fj + 1.5).num),
                 (ft.inv().num, fj.inv().num), ((2.0 * ft).num,
                                                (2.0 * fj).num)):
        assert same(a, b)
    cj = Pj.FRat.from_zpk([0.5, 0.3], [0.5, 0.7])
    ct = Pt.FRat.from_zpk([0.5, 0.3], [0.5, 0.7])
    assert same(ct.simplify().num, cj.simplify().num)
    assert same(ct.simplify().den, cj.simplify().den)
    assert str(ft) == str(fj) and ft.gain == fj.gain
    x = rng.standard_normal(5)
    assert same(Pt.FRat.make(x, [1.0, 0.0]).den, Pj.FRat.make(x, [1.0, 0.0]).den)
