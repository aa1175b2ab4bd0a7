"""The port's kernel modules (libtsd_tpu_torch.ops.kernels) against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

On the CPU each wrapper runs its plain PyTorch version.  The CUDA kernels
are compared with those plain versions on the card by
tests/test_torch_cuda.py, which imports no jax.

Tolerances, relative to the reference's peak:
* 1e-5 where both sides compute in fp32 (the JAX "highest" tier, the FFT);
* 1e-2 against the JAX fast tiers (split/bf16/int8/int16), whose DFT
  stages round to bf16 on purpose (the gate of tests/test_pallas.py); the
  port computes them in fp32, so it is ALSO held to 1e-5 against a float64
  reference with the tier's own input and (bf16-rounded) taps;
* and, against that float64 reference, 1e-3 per bin with a floor of 1e-6
  of the peak (``bin_err``; fp32 gives ~2e-5), so that a wrong stopband,
  orders of magnitude below the peak, cannot pass.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.ops.filter_rt import fir_toeplitz_mats
from libtsd_tpu.ops.fir_design import fir_lowpass
from libtsd_tpu.ops.pallas.chain import fir_periodogram4096 as chain_j
from libtsd_tpu.ops.pallas.fft import fft_pow2 as fft_j
from libtsd_tpu.ops.pallas.fir import fir_pallas, fir_pallas_complex
from libtsd_tpu.ops.pallas.periodogram import periodogram4096_acc as pg_j
from libtsd_tpu_torch.ops.kernels import chain, fft, fir, periodogram
from torch_compare import rel, bin_err

TIERS = ["highest", "split", "bf16", "int8", "int16"]


def _pgram64(y):
    """float64 reference: sum over 4096-frames of |FFT|^2."""
    C = y.shape[0]
    return (np.abs(np.fft.fft(y.reshape(C, -1, 4096), axis=-1)) ** 2).sum(1)


# ------------------------------------------------------------ kernel #1

@pytest.mark.parametrize("K,cplx", [(256, False), (3, False), (256, True)])
def test_fir_plain_matches_pallas(K, cplx):
    rng = np.random.default_rng(K)
    h = rng.standard_normal(K)
    x = rng.standard_normal(40000).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(40000)).astype(np.complex64)
        yt = fir.fir_kernel_complex(h, torch.as_tensor(x)).numpy()
        yj = np.asarray(fir_pallas_complex(h, jnp.asarray(x), interpret=True))
    else:
        yt = fir.fir_kernel(h, torch.as_tensor(x)).numpy()
        yj = np.asarray(fir_pallas(h, jnp.asarray(x), interpret=True))
    assert yt.shape == yj.shape == x.shape
    assert rel(yt, yj) < 1e-5


def test_fir_rejects_batched_input():
    with pytest.raises(ValueError, match="1-D"):
        fir.fir_kernel(np.ones(5), torch.zeros(2, 4096))


# ------------------------------------------------------------ kernel #2

@pytest.mark.parametrize("precision,tol", [("highest", 1e-5), ("split", 1e-2)])
def test_periodogram_plain_matches_pallas(precision, tol):
    y = np.random.default_rng(2).standard_normal((2, 16 * 4096)) \
        .astype(np.float32)
    pt = periodogram.periodogram4096_acc(torch.as_tensor(y), precision)
    pj = np.asarray(pg_j(jnp.asarray(y), interpret=True, precision=precision))
    assert pt.shape == (2, 4096)
    assert rel(pt.numpy(), pj) < tol
    assert rel(pt.numpy(), _pgram64(y.astype(np.float64))) < 1e-5


# ------------------------------------------------------------ kernel #3

def _chain_inputs(rng, precision, C, N):
    if precision == "int8":
        return rng.integers(-127, 128, size=(C, N)).astype(np.int8)
    if precision == "int16":
        return rng.integers(-20000, 20000, size=(C, N)).astype(np.int16)
    return rng.standard_normal((C, N)).astype(np.float32)


def _as_ingested(a, precision):
    """The samples as the kernel sees them, in float64."""
    if precision == "bf16":
        return torch.as_tensor(a).to(torch.bfloat16).double().numpy()
    return np.asarray(a, np.float64)


@pytest.mark.parametrize("with_hist", [False, True])
@pytest.mark.parametrize("fir_passes", [2, 3])
@pytest.mark.parametrize("precision", TIERS)
def test_chain_plain_matches_pallas(precision, fir_passes, with_hist):
    rng = np.random.default_rng(TIERS.index(precision) * 4 + fir_passes)
    h = fir_lowpass(256, 0.2)
    G = fir_toeplitz_mats(np.asarray(h, np.float64)).astype(np.float32)
    C, N = (2, 2 * 65536) if precision == "highest" else (1, 2 * 65536)
    x = _chain_inputs(rng, precision, C, N)
    hist = (_chain_inputs(rng, precision, C * 2 * 128, 1).reshape(C, 2, 128)
            if with_hist else None)
    pt = chain.fir_periodogram4096(
        torch.as_tensor(x), torch.as_tensor(G),
        None if hist is None else torch.as_tensor(hist),
        precision=precision, fir_passes=fir_passes).numpy()
    pj = np.asarray(chain_j(jnp.asarray(x), jnp.asarray(G),
                            None if hist is None else jnp.asarray(hist),
                            interpret=True, precision=precision,
                            fir_passes=fir_passes))
    assert pt.shape == pj.shape == (C, 4096)
    assert rel(pt, pj) < (1e-5 if precision == "highest" else 1e-2)
    # float64 reference with the tier's effective taps and input
    rounded = precision in ("bf16", "int8") or (
        fir_passes == 2 and precision in ("split", "int16"))
    taps = np.asarray(h, np.float32)
    if rounded:
        taps = torch.as_tensor(taps).to(torch.bfloat16).float().numpy()
    xe = _as_ingested(x, precision)
    if hist is not None:
        xe = np.concatenate([_as_ingested(hist, precision).reshape(C, -1),
                             xe], axis=1)
    y = np.stack([np.convolve(r, taps.astype(np.float64))[:xe.shape[1]]
                  for r in xe])[:, xe.shape[1] - N:]
    ref = _pgram64(y)
    assert rel(pt, ref) < 1e-5
    assert bin_err(pt, ref) < 1e-3


def test_chain_ingest_and_taps_checks():
    G = torch.as_tensor(fir_toeplitz_mats(np.ones(5)).astype(np.float32))
    x = torch.zeros(1, 4096, dtype=torch.int16)
    with pytest.raises(ValueError, match="int8"):
        chain.fir_periodogram4096(x, G, precision="int8")
    with pytest.raises(ValueError, match="fir_passes"):
        chain.fir_periodogram4096(x, G, precision="int16", fir_passes=1)
    bad = G.clone()
    bad[1, 5, 7] += 1.0
    with pytest.raises(ValueError, match="Toeplitz"):
        chain.fir_periodogram4096(x, bad, precision="int16")
    taps = chain.taps_from_G(G)
    assert torch.equal(taps, torch.cat([torch.ones(5), torch.zeros(124)]))


def test_kernel_taps_checks_a_G_once(monkeypatch):
    """The fused kernels' taps are checked and trimmed once per G (and
    device, tier, pass count): a second call with the same unedited G does
    not reach taps_from_G (whose torch.equal and the trim's nonzero sync
    the host); an in-place edit of G, or a new G, is checked anew, and an
    edit that breaks the Toeplitz form raises.  The cache holds G weakly:
    dropping a G drops its entries."""
    G = torch.as_tensor(fir_toeplitz_mats(np.hanning(40)).astype(np.float32))
    calls = []
    real = chain.taps_from_G
    monkeypatch.setattr(chain, "taps_from_G",
                        lambda g: calls.append(1) or real(g))
    a = chain.kernel_taps(G, "int16", 2)
    b = chain.kernel_taps(G, "int16", 2)
    assert len(calls) == 1 and b[0] is a[0]
    assert a[1:] == (39, 2)                  # 40 taps, the last one zero
    chain.kernel_taps(G, "highest", 3)
    assert len(calls) == 2
    G.mul_(2.0)                              # bumps G's version counter
    c = chain.kernel_taps(G, "int16", 2)
    assert len(calls) == 3 and torch.equal(c[0], 2 * a[0])
    G2 = G.clone()
    chain.kernel_taps(G2, "int16", 2)
    assert len(calls) == 4
    n = len(chain._taps_cache)
    del G2
    assert len(chain._taps_cache) == n - 1
    G[1, 5, 7] += 1.0
    with pytest.raises(ValueError, match="Toeplitz"):
        chain.kernel_taps(G, "int16", 2)
    assert len(calls) == 5


# ------------------------------------------------------------ kernel #4

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("nfft", [256, 1024, 4096])
def test_fft_plain_matches_pallas(nfft, inverse):
    rng = np.random.default_rng(nfft)
    xr = rng.standard_normal((8, nfft)).astype(np.float32)
    xi = rng.standard_normal((8, nfft)).astype(np.float32)
    yr, yi = fft.fft_pow2(torch.as_tensor(xr), torch.as_tensor(xi),
                          inverse=inverse)
    jr, ji = fft_j(jnp.asarray(xr), jnp.asarray(xi), inverse=inverse,
                   interpret=True)
    assert rel(yr.numpy() + 1j * yi.numpy(),
               np.asarray(jr) + 1j * np.asarray(ji)) < 1e-5


def test_fft_autograd_function_matches_torch_fft():
    """FftPow2's backward (the kernel in the other direction, scaled) gives
    torch.fft's gradient, forward and inverse (1e-5)."""
    rng = np.random.default_rng(7)
    z0 = torch.as_tensor((rng.standard_normal((4, 512))
                          + 1j * rng.standard_normal((4, 512)))
                         .astype(np.complex64))
    w = torch.as_tensor(rng.standard_normal(512).astype(np.float32))
    for inverse, ref in ((False, torch.fft.fft), (True, torch.fft.ifft)):
        z = z0.clone().requires_grad_(True)
        g1 = torch.autograd.grad(
            (fft.FftPow2.apply(z, inverse).abs() ** 2 * w).sum(), z)[0]
        z = z0.clone().requires_grad_(True)
        g2 = torch.autograd.grad((ref(z).abs() ** 2 * w).sum(), z)[0]
        assert rel(g1.numpy(), g2.numpy()) < 1e-5


def test_fft_rejects_unsupported_lengths():
    with pytest.raises(ValueError, match="nfft"):
        fft.fft_pow2(torch.zeros(2, 128), torch.zeros(2, 128))
    with pytest.raises(ValueError, match="nfft"):
        fft.fft_pow2(torch.zeros(2, 3000), torch.zeros(2, 3000))
