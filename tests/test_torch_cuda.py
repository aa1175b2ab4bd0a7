"""Each CUDA kernel of libtsd_tpu_torch against its plain PyTorch version,
on the card.  Every test is marked ``cuda`` and skips without a GPU.

This file imports no jax, so it runs on a GPU machine without one:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips tests/conftest.py, which configures jax.)

Tolerance: 1e-4 relative to the plain version's peak.  Both sides are
fp32; they differ in summation order, and the periodogram and chain
kernels combine partial spectra with atomicAdd in a run-dependent order.
Chain spectra are also held to 1e-3 per bin, with a floor of 1e-6 of the
peak, so that the stopband bins behind the lowpass count.
"""
import numpy as np
import pytest
import torch

from libtsd_tpu_torch.ops import fft as F, psd
from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
from libtsd_tpu_torch.ops.fir_design import fir_lowpass
from libtsd_tpu_torch.ops.kernels import chain, fft, fir, periodogram

pytestmark = pytest.mark.cuda
TOL = 1e-4
TOL_BIN = 1e-3   # spectra per bin, floor 1e-6 of the peak (bin_err)
TIERS = ["highest", "split", "bf16", "int8", "int16"]


@pytest.fixture
def dev():
    """The card, or a skip: decided at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel vs its plain version)")
    return torch.device("cuda")


def rel(a, b):
    torch.cuda.synchronize()
    a = torch.view_as_real(a) if a.is_complex() else a
    b = torch.view_as_real(b) if b.is_complex() else b
    return ((a.double() - b.double()).abs().max()
            / b.double().abs().max()).item()


def bin_err(a, b, floor=1e-6):
    """Per-bin error of a spectrum, floored at 1e-6 of b's peak, so that the
    stopband bins far below the peak count too."""
    torch.cuda.synchronize()
    a, b = a.double(), b.double()
    return ((a - b).abs() / (b.abs() + floor * b.abs().max())).max().item()


def _G(h, dev):
    return torch.as_tensor(fir_toeplitz_mats(np.asarray(h, np.float64))
                           .astype(np.float32), device=dev)


@pytest.mark.parametrize("K,n", [(256, 100003), (3, 4096), (600, 50000)])
def test_fir_kernel(dev, K, n):
    g = torch.Generator(device=dev).manual_seed(K)
    h = np.random.default_rng(K).standard_normal(K)
    x = torch.randn(n, generator=g, device=dev)
    before = fir.fir_kernel.launches
    y = fir.fir_kernel(h, x)
    assert fir.fir_kernel.launches == before + 1
    assert rel(y, fir.fir_plain(h, x)) < TOL
    z = torch.complex(x, x.flip(0))
    assert rel(fir.fir_kernel_complex(h, z),
               torch.complex(fir.fir_plain(h, z.real),
                             fir.fir_plain(h, z.imag))) < TOL


@pytest.mark.parametrize("C,frames", [(1, 3), (3, 64), (300, 2)])
def test_periodogram_kernel(dev, C, frames):
    g = torch.Generator(device=dev).manual_seed(C)
    y = torch.randn(C, frames * 4096, generator=g, device=dev)
    assert rel(periodogram.periodogram4096_acc(y),
               periodogram.periodogram4096_plain(y)) < TOL


@pytest.mark.parametrize("hist", [False, True])
@pytest.mark.parametrize("fir_passes", [2, 3])
@pytest.mark.parametrize("precision", TIERS)
def test_chain_kernel(dev, precision, fir_passes, hist):
    g = torch.Generator(device=dev).manual_seed(fir_passes)
    G = _G(fir_lowpass(256, 0.2), dev)
    shape = (3, 32 * 4096)
    if precision in ("int8", "int16"):
        lim = 127 if precision == "int8" else 20000
        dt = torch.int8 if precision == "int8" else torch.int16
        x = torch.randint(-lim, lim + 1, shape, generator=g, device=dev,
                          dtype=dt)
        h0 = torch.randint(-lim, lim + 1, (3, 2, 128), generator=g,
                           device=dev, dtype=dt)
    else:
        x = torch.randn(shape, generator=g, device=dev)
        h0 = torch.randn(3, 2, 128, generator=g, device=dev)
    h0 = h0 if hist else None
    k = chain.fir_periodogram4096(x, G, h0, precision, fir_passes)
    p = chain.fir_periodogram4096_plain(x, G, h0, precision, fir_passes)
    assert rel(k, p) < TOL
    assert bin_err(k, p) < TOL_BIN


@pytest.mark.parametrize("K", [1, 31, 300])
def test_chain_kernel_tap_counts(dev, K):
    """Short and long filters (tap padding, D = 2 and 4)."""
    g = torch.Generator(device=dev).manual_seed(K)
    G = _G(np.random.default_rng(K).standard_normal(K), dev)
    x = torch.randn(2, 8 * 4096, generator=g, device=dev)
    assert rel(chain.fir_periodogram4096(x, G),
               chain.fir_periodogram4096_plain(x, G)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n,B", [(256, 37), (512, 8), (2048, 3), (4096, 5),
                                 (8192, 2), (16384, 3)])
def test_fft_kernel(dev, n, B, inverse):
    g = torch.Generator(device=dev).manual_seed(n)
    xr = torch.randn(B, n, generator=g, device=dev)
    xi = torch.randn(B, n, generator=g, device=dev)
    assert rel(torch.stack(fft.fft_pow2(xr, xi, inverse=inverse)),
               torch.stack(fft.fft_pow2_plain(xr, xi, inverse=inverse))) < TOL


def test_fft_engine_auto_and_gradient(dev):
    """ops.fft sends a CUDA power-of-two transform to the kernel, whose
    gradient matches torch.fft's."""
    g = torch.Generator(device=dev).manual_seed(1)
    z = torch.randn(6, 1024, generator=g, device=dev, dtype=torch.complex64)
    before = fft.fft_pow2.launches
    assert rel(F.fft(z), torch.fft.fft(z, norm="ortho")) < TOL
    assert fft.fft_pow2.launches == before + 1
    assert rel(F.ifft(z, axis=0, n=8), torch.fft.ifft(z, n=8, dim=0,
                                                      norm="ortho")) < TOL
    w = torch.arange(1024, device=dev, dtype=torch.float32)
    za = z.clone().requires_grad_(True)
    ga = torch.autograd.grad((F.fft(za).abs() ** 2 * w).sum(), za)[0]
    zb = z.clone().requires_grad_(True)
    gb = torch.autograd.grad(
        (torch.fft.fft(zb, norm="ortho").abs() ** 2 * w).sum(), zb)[0]
    assert rel(ga, gb) < TOL
    _, S = psd.psd_welch(z.real[:2], 256)
    assert torch.isfinite(S).all()
