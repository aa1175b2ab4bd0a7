"""The port's numpy design modules (window, fir_design) are copies of the
JAX package's: same inputs, bit-identical outputs (np.array_equal)."""
import numpy as np
import pytest

from libtsd_tpu.ops import fir_design as FDj, window as Wj
from libtsd_tpu_torch.ops import fir_design as FDt, window as Wt


@pytest.mark.parametrize("kind", ["re", "hn", "hm", "tr", "bm", "ch",
                                  "kaiser"])
@pytest.mark.parametrize("n,sym", [(31, True), (64, False), (257, True)])
def test_window_identical(kind, n, sym):
    assert np.array_equal(Wt.window(kind, n, sym), Wj.window(kind, n, sym))


DESIGNS = [
    ("fir_lowpass", (256, 0.2)),
    ("fir_lowpass", (31, 0.25, "hm")),
    ("fir_design_windowed", (31, "lp", 0.25, "hn")),
    ("fir_design_windowed", (63, "hp", 0.1, "bm")),
    ("fir_design_kaiser", ("lp", 0.2, 60.0, 0.05)),
    ("fir_design_chebyshev", (41, "lp", 0.15, 60.0)),
    ("raised_cosine", (63, 0.25, 0.125)),
    ("root_raised_cosine", (65, 0.25, 4.0)),
    ("gaussian_fir_telecom", (33, 0.3, 4)),
    ("fir_halfband", (31,)),
    ("fir_hilbert", (31,)),
    ("fir_differentiator", (16,)),
]


@pytest.mark.parametrize("name,args", DESIGNS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(DESIGNS)])
def test_fir_design_identical(name, args):
    a = getattr(FDt, name)(*args)
    b = getattr(FDj, name)(*args)
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_kaiser_param_and_window_identical():
    assert FDt.kaiser_param(60.0, 0.05) == FDj.kaiser_param(60.0, 0.05)
    assert np.array_equal(Wt.kaiser_window(40, 2.0), Wj.kaiser_window(40, 2.0))
    assert np.array_equal(Wt.chebyshev_window(40, 70.0),
                          Wj.chebyshev_window(40, 70.0))
