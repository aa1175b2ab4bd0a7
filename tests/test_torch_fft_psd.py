"""The port's ops.fft and ops.psd against the JAX package on the same numpy
inputs, and the reference binary's config-2 goldens through the port.

Tolerances: 1e-5 relative to the peak for transforms (fp32 FFTs, different
algorithms); spectra compared in linear power, 1e-5 relative to the peak
(dB values of near-empty bins amplify float32 noise); the goldens keep the
gates of tests/test_golden_ref.py."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.ops import fft as Fj, psd as Pj
from libtsd_tpu_torch.ops import fft as Ft, psd as Pt

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def rel(a, b):
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _signal(shape, cplx, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape,axis,n", [((3, 4096), -1, None),
                                          ((256, 5), 0, None),
                                          ((2, 1000), -1, None),
                                          ((2, 1000), -1, 1024),
                                          ((2, 1000), 1, 600)])
@pytest.mark.parametrize("cplx", [False, True])
def test_fft_ifft_match_jax(shape, axis, n, inverse, cplx):
    x = _signal(shape, cplx)
    ft, fj = (Ft.ifft, Fj.ifft) if inverse else (Ft.fft, Fj.fft)
    yt = ft(torch.as_tensor(x), n=n, axis=axis).numpy()
    yj = np.asarray(fj(jnp.asarray(x), n=n, axis=axis))
    assert yt.shape == yj.shape and yt.dtype == yj.dtype == np.complex64
    assert rel(yt, yj) < 1e-5


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_kernel_engine_matches_jax_pallas_engine(inverse):
    """engine="kernel" (the kernel wrapper; its plain version on the CPU)
    against the JAX Pallas engine, interpreted on the CPU."""
    x = _signal((4, 2048), True, 1)
    ft, fj = (Ft.ifft, Fj.ifft) if inverse else (Ft.fft, Fj.fft)
    yt = ft(torch.as_tensor(x), engine="kernel").numpy()
    yj = np.asarray(fj(jnp.asarray(x), engine="pallas"))
    assert rel(yt, yj) < 1e-5


@pytest.mark.parametrize("n", [None, 300])
def test_rfft_irfft_match_jax(n):
    x = _signal((2, 512), False, 2)
    Xt = Ft.rfft(torch.as_tensor(x), n=n)
    Xj = Fj.rfft(jnp.asarray(x), n=n)
    assert rel(Xt.numpy(), Xj) < 1e-5
    yt = Ft.irfft(Xt, n=n).numpy()
    yj = np.asarray(Fj.irfft(Xj, n=n))
    assert yt.shape == yj.shape and rel(yt, yj) < 1e-5


def test_shifts_freqs_next_pow2_match_jax():
    x = _signal((3, 10), False, 3)
    assert np.array_equal(Ft.fftshift(torch.as_tensor(x), axes=-1).numpy(),
                          np.asarray(Fj.fftshift(jnp.asarray(x), axes=-1)))
    assert np.array_equal(Ft.ifftshift(torch.as_tensor(x)).numpy(),
                          np.asarray(Fj.ifftshift(jnp.asarray(x))))
    for n, shifted in ((8, True), (9, False)):
        np.testing.assert_allclose(Ft.fft_freqs(n, 2.0, shifted,
                                                 device="cpu").numpy(),
                                   np.asarray(Fj.fft_freqs(n, 2.0, shifted)),
                                   rtol=0, atol=1e-7)
    assert [Ft.next_pow2(v) for v in (1, 5, 64, 65)] == \
        [Fj.next_pow2(v) for v in (1, 5, 64, 65)]


@pytest.mark.parametrize("n,cplx", [(512, True), (511, True), (100, False)])
def test_psd_freqs_match_jax(n, cplx):
    np.testing.assert_allclose(Pt.psd_freqs(n, cplx, device="cpu").numpy(),
                               np.asarray(Pj.psd_freqs(n, cplx)),
                               rtol=0, atol=1e-7)


def _lin(db):
    return 10.0 ** (np.asarray(db, np.float64) / 10)


@pytest.mark.parametrize("fn,args", [
    ("psd", ()),
    ("psd_welch", (256,)),
    ("psd_welch", (4096,)),        # shorter than the segment: zero-padded
    ("periodogram_dft", (512,)),
    ("spectrogram", (256,)),
    ("spectrogram", (256, 0.75, "hm")),
])
@pytest.mark.parametrize("cplx", [False, True])
def test_psd_family_matches_jax(fn, args, cplx):
    x = _signal((2, 3000), cplx, 4)
    rt = getattr(Pt, fn)(torch.as_tensor(x), *args)
    rj = getattr(Pj, fn)(jnp.asarray(x), *args)
    if isinstance(rt, tuple):
        np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]),
                                   rtol=0, atol=1e-7)
        rt, rj = rt[1], rj[1]
        assert rt.shape == tuple(rj.shape)
        assert rel(_lin(rt.numpy()), _lin(rj)) < 1e-5
    else:
        assert rt.shape == tuple(rj.shape)
        assert rel(rt.numpy(), np.asarray(rj)) < 1e-5


# ---------------------------------------- config 2 goldens, through the port

def test_cfg2_fft_golden_through_port():
    X = Ft.fft(torch.as_tensor(g("cfg2_x"))).numpy()
    assert np.abs(X - g("cfg2_X")).max() < 2e-6


def test_cfg2_correlogram_golden_through_port():
    from libtsd_tpu_torch.ops.window import window
    x = g("cfg2_x")
    w = np.asarray(window("hann", 4096, sym=False))
    Y = Ft.fft(torch.as_tensor(x * w)).numpy()
    S = 10 * np.log10(np.abs(Y[:2048]) ** 2 + 1e-300)
    d = np.abs(S - g("cfg2_psd"))
    assert np.percentile(d, 99) < 0.2 and d.max() < 1.0


def test_cfg2_welch_golden_through_port():
    _, S = Pt.psd_welch(torch.as_tensor(g("cfg2_x")).to(torch.complex64),
                        512, "hann")
    assert np.abs(S.numpy() - g("cfg2_welch")).max() < 0.05  # dB
