"""The port's spectral ops against the JAX package on the same numpy
inputs, on the CPU: the rest of ops.fft (force_csym, czt, goertzel,
goertzel_stream, hadamard, wht), ops.corr, psd.freq_estim, and the
reference binary's round-2 goldens through the port.

Tolerances: float32 paths within 1e-5 of the JAX output's peak (both
sides fp32, other FFT algorithms and summation orders; xcorr's lags
weighted by their overlap, see the test); hadamard and wht
on integer-valued inputs exactly; integer lags and delays exactly; the
goldens with the JAX tests' own bounds (tests/test_golden_ref2.py:156-213:
goertzel 1e-5, xcorr 1e-4, delay and score 1e-4, czt 1e-5 of the direct
sum's peak, freq_estim 1e-6)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.ops import corr as Cj, fft as Fj, psd as Pj
from libtsd_tpu_torch.ops import corr as Ct, fft as Ft, psd as Pt
from libtsd_tpu_torch.ops.signal import sigcos, sigexp, sigsin
from torch_compare import rel

GOLD = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def _signal(shape, cplx, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        return (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x.astype(np.float32)


def _both(fn_j, fn_t, *arrays, **kw):
    """Run the JAX and the port function on the same numpy arrays."""
    rj = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    rt = fn_t(*(torch.as_tensor(a) for a in arrays), **kw)
    return rj, rt


# ------------------------------------------------------------ ops.fft rest

@pytest.mark.parametrize("cplx", [False, True])
def test_force_csym_matches_jax(cplx):
    X = _signal((3, 257), cplx, 1)
    rj, rt = _both(Fj.force_csym, Ft.force_csym, X)
    assert rel(rt, rj) < TOL
    # ifft of the result is real
    assert np.abs(np.fft.ifft(rt.numpy()).imag).max() < 1e-5


@pytest.mark.parametrize("n,m,W,z0", [
    (256, None, None, 1.0 + 0.0j),                 # the DFT
    (200, 300, np.exp(-2j * np.pi * 0.0013), np.exp(1j * 0.3)),
    (301, 64, np.exp(-2j * np.pi / 512), 0.98 * np.exp(0.2j)),
])
@pytest.mark.parametrize("cplx", [False, True])
def test_czt_matches_jax(n, m, W, z0, cplx):
    x = _signal((2, n), cplx, 2)
    rj = Fj.czt(jnp.asarray(x), m, W=W, z0=z0)
    rt = Ft.czt(torch.as_tensor(x), m, W=W, z0=z0)
    assert rt.shape == tuple(rj.shape)
    assert rt.dtype == torch.complex64
    assert rel(rt, rj) < TOL


@pytest.mark.parametrize("f", [0.1, 0.17, 0.3, 0.0])
@pytest.mark.parametrize("cplx", [False, True])
def test_goertzel_matches_jax(f, cplx):
    x = _signal((3, 500), cplx, 3)
    rj, rt = _both(lambda v: Fj.goertzel(v, f), lambda v: Ft.goertzel(v, f),
                   x)
    assert rel(rt, rj) < TOL
    rj, rt = _both(lambda v: Fj.goertzel_stream(v, f, 100),
                   lambda v: Ft.goertzel_stream(v, f, 100), x)
    assert rt.shape == tuple(rj.shape) == (3, 5)
    assert rel(rt, rj) < TOL


def test_goertzel_stream_rejects_partial_block():
    with pytest.raises(ValueError):
        Ft.goertzel_stream(torch.zeros(101), 0.1, 10)


@pytest.mark.parametrize("n", [1, 2, 8, 64])
def test_hadamard_wht_match_jax(n):
    assert np.array_equal(Ft.hadamard(n, device="cpu").numpy(),
                          np.asarray(Fj.hadamard(n)))
    x = np.random.default_rng(n).integers(-50, 50, (3, n)).astype(
        np.float32)
    rj, rt = _both(Fj.wht, Ft.wht, x)
    assert np.array_equal(rt.numpy(), np.asarray(rj))
    # the fast transform is the matrix product
    assert np.array_equal(rt.numpy(), x @ np.asarray(Fj.hadamard(n)))


# ---------------------------------------------------------------- ops.corr

@pytest.mark.parametrize("cplx", [False, True])
def test_ccorr_matches_jax(cplx):
    x0, x1 = _signal((2, 300), cplx, 4), _signal((2, 300), cplx, 5)
    (lj, cj), (lt, ct) = _both(Cj.ccorr, Ct.ccorr, x0, x1)
    assert np.array_equal(lt.numpy(), np.asarray(lj))
    assert rel(ct, cj) < TOL
    (_, cj), (_, ct) = _both(Cj.ccorr, Ct.ccorr, x0)
    assert rel(ct, cj) < TOL


@pytest.mark.parametrize("fn", ["xcorrb", "xcorr"])
@pytest.mark.parametrize("ny,m", [(400, None), (400, 37), (250, None),
                                  (400, 1)])
@pytest.mark.parametrize("cplx", [False, True])
def test_xcorr_family_matches_jax(fn, ny, m, cplx):
    x, y = _signal((400,), cplx, 6), _signal((ny,), cplx, 7)
    (lj, cj), (lt, ct) = _both(lambda a, b: getattr(Cj, fn)(a, b, m),
                               lambda a, b: getattr(Ct, fn)(a, b, m), x, y)
    assert np.array_equal(lt.numpy(), np.asarray(lj))
    assert ct.shape == tuple(cj.shape)
    # xcorr divides lag k by its overlap (n - |k|) / n, which magnifies
    # float32 noise at the far lags up to n-fold: held there within TOL of
    # the peak, times n / (n - |k|)
    n = max(400, ny)
    ov = np.maximum(n - np.abs(lt.numpy()), 1.0) / n if fn == "xcorr" else 1
    assert rel(ct.numpy() * ov, np.asarray(cj) * ov) < TOL


def test_xcorr_rejects_long_lag_range():
    with pytest.raises(ValueError):
        Ct.xcorr(torch.zeros(10), torch.zeros(10), 11)


@pytest.mark.parametrize("N", [0, 64])
def test_coherence_matches_jax(N):
    rng = np.random.default_rng(8)
    x = rng.standard_normal(4000).astype(np.float32)
    y = (0.7 * x + 0.5 * rng.standard_normal(4000)).astype(np.float32)
    rj, rt = _both(lambda a, b: Cj.coherence(a, b, N),
                   lambda a, b: Ct.coherence(a, b, N), x, y)
    assert rt.shape == tuple(rj.shape)
    assert rel(rt, rj) < TOL


@pytest.mark.parametrize("delay", [5.5, -12.25, 0.0, 40.0])
def test_estimate_delay_and_align_match_jax(delay):
    x = _signal((512,), False, 9)
    y = np.array(Fj.delay_signal(jnp.asarray(x), delay))
    (dj, sj), (dt, st) = _both(Cj.estimate_delay, Ct.estimate_delay, x, y)
    assert abs(float(dt) - float(dj)) < 1e-4
    assert abs(float(st) - float(sj)) < 1e-5
    rj, rt = _both(Cj.align_int, Ct.align_int, x, y[:500])
    assert int(rt[2]) == int(rj[2])
    for a, b in zip(rt[:2], rj[:2]):
        assert rel(a, b) < TOL


# ------------------------------------------------------- psd.freq_estim

@pytest.mark.parametrize("method", ["fft", "quadratic", "candan2"])
@pytest.mark.parametrize("f0", [0.12347, -0.31, 0.4999, 0.0])
def test_freq_estim_matches_jax(method, f0):
    rng = np.random.default_rng(10)
    n = 1000
    x = (np.exp(2j * np.pi * f0 * np.arange(n))
         + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    rj, rt = _both(lambda v: Pj.freq_estim(v, method),
                   lambda v: Pt.freq_estim(v, method), x)
    assert abs(float(rt) - float(rj)) < 1e-6
    assert -0.5 <= float(rt) < 0.5


def test_freq_estim_rejects_unknown_method():
    with pytest.raises(ValueError):
        Pt.freq_estim(torch.ones(8, dtype=torch.complex64), "nope")


# ------------------------------------- round-2 goldens, through the port

def test_g2_goertzel_through_port():
    x = sigcos(0.1, 500, device="cpu") + 0.5 * sigsin(0.17, 500,
                                                      device="cpu")
    ref = g("g2_goertzel")
    for i, f0 in enumerate((0.1, 0.17, 0.3)):
        assert abs(float(Ft.goertzel(x, f0)) - ref[i]) < 1e-5


def test_g2_xcorr_and_delay_through_port():
    x = torch.as_tensor(g("g2_xcorr_x"))
    y = Ft.delay_signal(x, 5.5)
    _, c = Ct.xcorr(x, y, 127)
    ref = g("g2_xcorr")
    assert c.shape == ref.shape
    assert np.abs(c.numpy() - ref).max() < 1e-4
    d, s = Ct.estimate_delay(x, y)
    ref = g("g2_delay_est")
    assert abs(float(d) - ref[0]) < 1e-4
    assert abs(float(s) - ref[1]) < 1e-4


def test_g2_czt_through_port():
    """The port matches the brute-force contour sum; the reference's czt
    does not match its own formula (tests/test_golden_ref2.py:186-204)."""
    x = g("g2_xcorr_x").astype(np.complex128)
    n = len(x)
    k = np.arange(n)
    W = np.exp(-2j * np.pi * 0.0013)
    z0 = np.exp(1j * 0.3)
    direct = np.array([np.sum(x * ((1 / z0) ** k) * (W ** (m * k)))
                       for m in range(n)])
    scale = np.abs(direct).max()
    ours = Ft.czt(torch.as_tensor(x.astype(np.complex64)), n, W=W,
                  z0=z0).numpy()
    assert (np.abs(ours - direct) / scale).max() < 1e-5
    assert (np.abs(g("g2_czt") - direct) / scale).max() > 0.5


def test_g2_freqestim_through_port():
    tone = sigexp(0.12347, 1000, device="cpu")
    ref = g("g2_freqestim")
    for i, m in enumerate(("fft", "candan2", "quadratic")):
        assert abs(float(Pt.freq_estim(tone, m)) - ref[i]) < 1e-6, m
