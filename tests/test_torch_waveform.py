"""The port's PSK and ASK waveforms, differential coding and the carrier
loops' power and tan PEDs against the JAX package on the same numpy
inputs (the functions no other port test names): within 1e-5 of the JAX
output's peak, symbol indices and bits exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import carrier_rec as Cj, waveform as Wj
from libtsd_tpu_torch.models import carrier_rec as Ct, waveform as Wt
from torch_compare import rel

TOL = 1e-5
WAVEFORMS = [("psk", 2), ("psk", 4), ("psk", 8), ("psk", 16), ("ask", 2),
             ("ask", 4)]


def pair(kind, M):
    if kind == "psk":
        return Wj.wf_psk(M), Wt.wf_psk(M, device="cpu")
    return Wj.wf_ask(M), Wt.wf_ask(M, device="cpu")


@pytest.mark.parametrize("kind,M", WAVEFORMS)
def test_waveform_matches_jax(kind, M):
    """Constellation, make_symbols, gen_samples (samples and delay) and
    decode_symbols of noisy symbols."""
    wj, wt = pair(kind, M)
    assert rel(wt.symbols, np.asarray(wj.symbols)) < TOL
    rng = np.random.default_rng(M)
    bits = rng.integers(0, 2, wt.info.k * 96).astype(np.int32)
    sj = np.asarray(wj.make_symbols(jnp.asarray(bits)))
    st = wt.make_symbols(torch.as_tensor(bits))
    assert rel(st, sj) < TOL
    yj, dj = wj.gen_samples(jnp.asarray(bits), osf=4)
    yt, dt = wt.gen_samples(torch.as_tensor(bits), osf=4)
    assert yt.shape == np.shape(yj) and dt == dj
    assert rel(yt, np.asarray(yj)) < TOL
    noisy = (sj + 0.05 * (rng.standard_normal(sj.shape)
                          + 1j * rng.standard_normal(sj.shape))
             ).astype(np.complex64)
    dec = wt.decode_symbols(torch.as_tensor(noisy)).numpy()
    assert np.array_equal(dec, np.asarray(wj.decode_symbols(
        jnp.asarray(noisy))))


@pytest.mark.parametrize("M", [2, 4, 8])
def test_diff_coding_matches_jax(M):
    idx = np.random.default_rng(M).integers(0, M, (3, 50)).astype(np.int32)
    ej = np.asarray(Wj.diff_encode(jnp.asarray(idx), M))
    et = Wt.diff_encode(torch.as_tensor(idx), M)
    assert np.array_equal(et.numpy(), ej)
    dt = Wt.diff_decode(et, M)
    assert np.array_equal(dt.numpy(),
                          np.asarray(Wj.diff_decode(jnp.asarray(ej), M)))
    assert np.array_equal(dt.numpy(), idx)


@pytest.mark.parametrize("M", [1, 2, 4])
@pytest.mark.parametrize("ped", ["ped_ploop", "ped_tloop"])
def test_power_and_tan_peds_match_jax(ped, M):
    """On random complex samples (and an exact zero), for a unit reference
    and for QPSK's pi/4 point."""
    rng = np.random.default_rng(M)
    x = (rng.standard_normal(200) + 1j * rng.standard_normal(200)
         ).astype(np.complex64)
    x[7] = 0
    for ref in (1.0 + 0j, np.exp(1j * np.pi / 4)):
        fj, ft = getattr(Cj, ped)(M, ref), getattr(Ct, ped)(M, ref)
        assert rel(ft(torch.as_tensor(x)), np.asarray(fj(jnp.asarray(x)))) \
            < TOL
