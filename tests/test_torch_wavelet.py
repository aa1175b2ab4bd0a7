"""The port's wavelets (ops.dwt, ops.lifting), sampled continuous-time
functions (ops.ct) and filter analysis (ops.filter_analysis) against the
JAX package on the same numpy inputs, on the CPU, and the reference
binary's round-2 DWT goldens through the port.

Tolerances: float32 transforms within 1e-5 of the JAX output's peak
(both sides fp32; the port multiplies by float32-rounded taps as JAX
does, in the same order); perfect reconstruction within 1e-5 of the
input's peak; the host-side algebra (Laurent polynomials, factored
lifting steps, CDF banks, filter analysis: copies) exactly; the goldens
with the JAX tests' bound, 1e-5 (tests/test_golden_ref2.py:226-253)."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.ops import (ct as CTj, dwt as Dj, filter_analysis as FAj,
                            lifting as Lj)
from libtsd_tpu_torch.ops import (ct as CTt, dwt as Dt,
                                  filter_analysis as FAt, lifting as Lt)
from torch_compare import rel

GOLD = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------ dwt

@pytest.mark.parametrize("name", ["haar", "db4", "bior"])
@pytest.mark.parametrize("levels", [1, 3])
def test_dwt_idwt_match_jax(name, levels):
    x = _x((2, 64), 1)
    cj = Dj.dwt(jnp.asarray(x), name, levels)
    ct = Dt.dwt(torch.as_tensor(x), name, levels)
    assert len(ct) == len(cj) == levels + 1
    for a, b in zip(ct, cj):
        assert a.shape == tuple(b.shape)
        assert rel(a, b) < TOL
    rj = Dj.idwt(cj, name)
    rt = Dt.idwt(ct, name)
    assert rel(rt, rj) < TOL
    assert rel(rt, x) < TOL               # perfect reconstruction


@pytest.mark.parametrize("name", ["haar", "db4", "bior"])
def test_dwt2_idwt2_match_jax(name):
    img = _x((3, 16, 32), 2)
    bj = Dj.dwt2(jnp.asarray(img), name)
    bt = Dt.dwt2(torch.as_tensor(img), name)
    for a, b in zip(bt, bj):
        assert a.shape == tuple(b.shape)
        assert rel(a, b) < TOL
    assert rel(Dt.idwt2(*bt, name=name), Dj.idwt2(*bj, name=name)) < TOL
    assert rel(Dt.idwt2(*bt, name=name), img) < TOL


def test_dwt_filters_and_errors():
    for name in ("haar", "db4", "d4", "bior", "legall", "cdf53"):
        for a, b in zip(Dt.wavelet_filters(name), Dj.wavelet_filters(name)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        Dt.wavelet_filters("nope")
    with pytest.raises(ValueError):
        Dt.dwt_level(torch.zeros(7))
    with pytest.raises(ValueError):
        Dt.dwt(torch.zeros(12), levels=3)


# -------------------------------------------------------------- lifting

LIFTS = ["lift_haar", "lift_db2", "lift_cdf53", "lift_bior35"]


@pytest.mark.parametrize("lift", LIFTS)
@pytest.mark.parametrize("levels", [1, 2])
def test_lift_dwt_idwt_match_jax(lift, levels):
    lj, lt = getattr(Lj, lift)(), getattr(Lt, lift)()
    assert dataclasses.asdict(lj) == dataclasses.asdict(lt)
    x = _x((2, 128), 3)
    cj = Lj.lift_dwt(jnp.asarray(x), lj, levels)
    ct = Lt.lift_dwt(torch.as_tensor(x), lt, levels)
    for a, b in zip(ct, cj):
        assert a.shape == tuple(b.shape)
        assert rel(a, b) < TOL
    rt = Lt.lift_idwt(ct, lt)
    assert rel(rt, Lj.lift_idwt(cj, lj)) < TOL
    assert rel(rt, x) < TOL


def test_lifting_algebra_is_a_copy():
    for lift in LIFTS:
        pj = Lj.lift_polyphase(getattr(Lj, lift)())
        pt = Lt.lift_polyphase(getattr(Lt, lift)())
        for rj, rt in zip(pj, pt):
            for a, b in zip(rj, rt):
                assert np.array_equal(a.coefs, b.coefs) and a.n0 == b.n0
        for a, b in zip(Lj.lift_qmf(getattr(Lj, lift)()),
                        Lt.lift_qmf(getattr(Lt, lift)())):
            assert np.array_equal(a, b)
    for a, b in zip(Lj.cdf_filters(3, 5), Lt.cdf_filters(3, 5)):
        assert np.array_equal(a, b)
    # a scheme of tests/test_lifting.py, polyphase and factored back
    lf = Lt.Lift("rand", (Lt.LiftStep((0.4, -0.3), -1, True),
                          Lt.LiftStep((0.25, 0.1), 0, False),
                          Lt.LiftStep((-0.7,), 1, True)), K=1.3)
    (a, b), (c, d) = Lt.lift_polyphase(lf)
    ft = Lt.factor_lifting(a, b, c, d, "re")
    fj = Lj.factor_lifting(*(Lj.Laurent(p.coefs, p.n0)
                             for p in (a, b, c, d)), "re")
    assert dataclasses.asdict(fj) == dataclasses.asdict(ft)
    x = torch.as_tensor(_x((64,), 4))
    for u, v in zip(Lt.lift_dwt_level(x, lf), Lt.lift_dwt_level(x, ft)):
        assert rel(v, u) < TOL
    a = Lt.Laurent.make([1.0, 2.0, 0.0], -1) * Lt.Laurent.make([3.0, 1.0])
    assert np.array_equal(a.coefs, [3.0, 7.0, 2.0]) and a.n0 == -1


def test_lift_errors():
    with pytest.raises(ValueError):
        Lt.lift_dwt_level(torch.zeros(7), Lt.lift_haar())
    with pytest.raises(ValueError):
        Lt.lift_dwt(torch.zeros(12), Lt.lift_haar(), 3)


def test_g2_dwt_goldens_through_port():
    """Haar at depth 3 in full, db2 at depth 1 on the interior, as
    tests/test_golden_ref2.py:226-253 holds JAX's."""
    x = torch.as_tensor(g("g2_dwt_x"))
    d1, d2, d3, a3 = Lt.lift_dwt(x, Lt.lift_haar(), 3)
    K = np.sqrt(2.0)
    ours = np.concatenate([a3.numpy() / K ** 3, d3.numpy() / K,
                           d2.numpy(), d1.numpy() * K])
    assert np.abs(ours - g("g2_dwt_haar")).max() < 1e-5
    d1, a1 = Lt.lift_dwt(x, Lt.lift_db2(), 1)
    Kd = (np.sqrt(3) - 1) / np.sqrt(2)
    ours = np.concatenate([a1.numpy() / Kd, d1.numpy() * Kd])
    ref = g("g2_dwt_db2")
    assert np.abs(ours[4:124] - ref[4:124]).max() < 1e-5
    assert np.abs(ours[132:252] - ref[132:252]).max() < 1e-5


# ------------------------------------------------------------------- ct

def test_sampled_function_matches_jax():
    fj = CTj.sample_function(lambda t: jnp.exp(-t * t) * jnp.cos(3 * t),
                             -4.0, 6.0, 501)
    ft = CTt.sample_function(lambda t: torch.exp(-t * t) * torch.cos(3 * t),
                             -4.0, 6.0, 501, device="cpu")
    assert ft.n == fj.n and ft.fs == fj.fs
    assert rel(ft.values, fj.values) < TOL
    assert rel(ft.times(), fj.times()) < 1e-7
    t = np.linspace(-5.0, 7.0, 77).astype(np.float32)
    assert rel(ft(t), fj(jnp.asarray(t))) < TOL
    (f1, X1), (f2, X2) = ft.fourier(), fj.fourier()
    assert rel(f1, f2) < 1e-6
    assert rel(X1, X2) < TOL
    assert abs(float(ft.energy()) - float(fj.energy())) < TOL * float(
        fj.energy())


def test_dirichlet_matches_jax():
    w = np.linspace(-7.0, 7.0, 1001).astype(np.float32)
    w[500] = 0.0
    for N in (1, 4, 9):
        dt = CTt.dirichlet(N, torch.as_tensor(w))
        dj = CTj.dirichlet(N, jnp.asarray(w))
        assert rel(dt, dj) < TOL
        assert float(dt[500]) == 2 * N + 1
    assert CTt.dirichlet(3, [0.0], device="cpu").device.type == "cpu"


# ------------------------------------------------------ filter_analysis

@pytest.mark.parametrize("h", [
    np.hanning(31) / np.hanning(31).sum(),
    (np.array([0.2, 0.4, 0.2]), np.array([1.0, -0.3, 0.1])),
    np.array([0.5, -0.5]),
])
def test_filter_analysis_is_a_copy(h):
    for fn in ("frmag", "frphase", "frgroup"):
        for a, b in zip(getattr(FAt, fn)(h, 256), getattr(FAj, fn)(h, 256)):
            assert np.array_equal(a, b), fn
    for fn in ("repimp", "repech"):
        assert np.array_equal(getattr(FAt, fn)(h, 64),
                              getattr(FAj, fn)(h, 64))
    assert FAt.filter_type_of(h) == FAj.filter_type_of(h)
    assert (dataclasses.asdict(FAt.analyze_filter(h))
            == dataclasses.asdict(FAj.analyze_filter(h)))
    w = np.kaiser(64, 6.0)
    assert (dataclasses.asdict(FAt.analyze_window(w))
            == dataclasses.asdict(FAj.analyze_window(w)))
