"""The port's polyphase channelizer (models.channelizer) against the JAX
package on the same numpy inputs, on the CPU.

Tolerances: outputs and states, and the WOLA pair, within 1e-5 of the JAX
output's peak (both sides fp32, other FFT and summation orders); the
round trips within the bounds of tests/test_advanced.py:302-345."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import channelizer as CHj
from libtsd_tpu_torch.models import channelizer as CHt
from libtsd_tpu_torch.utils.convert import (channelizer_from_jax,
                                            channelizer_state_from_jax)
from torch_compare import rel

TOL = 1e-5


@pytest.mark.parametrize("M,tpb", [(16, 8), (64, 8), (8, 1), (1, 8)])
def test_channelizer_streams_as_jax(M, tpb):
    """Three chained steps, the block and each step's state built from
    JAX's through the converters (M = 1 and K = 1 exercise the guarded
    state slices)."""
    bj = CHj.Channelizer.create(M, tpb)
    bt = channelizer_from_jax(bj, device="cpu")
    assert torch.equal(bt.P, CHt.Channelizer.create(M, tpb,
                                                    device="cpu").P)
    rng = np.random.default_rng(M)
    sj = bj.init()
    st = channelizer_state_from_jax(sj, device="cpu")
    for step in range(3):
        x = (rng.standard_normal(M * 40) + 1j * rng.standard_normal(M * 40)
             ).astype(np.complex64)
        sj, yj = bj.step(sj, jnp.asarray(x))
        st, yt = bt.step(st, torch.as_tensor(x))
        assert yt.shape == tuple(yj.shape) == (40, M)
        assert rel(yt, yj) < TOL
        sjc = channelizer_state_from_jax(sj, device="cpu")
        for k in ("hist", "raw"):
            assert st[k].shape == sjc[k].shape and st[k].dtype == \
                torch.complex64
            assert rel(st[k], sjc[k]) < TOL if st[k].numel() else True
        if step == 1:      # carry on from JAX's state, converted
            st = sjc


def test_channelizer_step_rejects_partial_block():
    bt = CHt.Channelizer.create(8, device="cpu")
    with pytest.raises(ValueError):
        bt.step(bt.init(), torch.zeros(12, dtype=torch.complex64))


def test_channelize_dechannelize_match_jax():
    """One-shot analysis (with padding) and synthesis, and the round trip
    bounds of tests/test_advanced.py."""
    M = 16
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(M * 64 - 5)
         + 1j * rng.standard_normal(M * 64 - 5)).astype(np.complex64)
    yj = CHj.channelize(jnp.asarray(x), M)
    yt = CHt.channelize(torch.as_tensor(x), M)
    assert yt.shape == tuple(yj.shape)
    assert rel(yt, yj) < TOL
    rj = CHj.dechannelize(yj, M)
    rt = CHt.dechannelize(yt, M)
    assert rt.shape == tuple(rj.shape)
    assert rel(rt, rj) < TOL
    # tests/test_advanced.py:302-323 on the port: a channel-centre tone
    # within 0.01 rms, broadband within 0.35 (crossover aliasing)
    n, d = 1 << 13, 128
    m = slice(500, n - d - 500)
    bank = CHt.Channelizer.create(M, device="cpu")
    tone = np.exp(2j * np.pi * (3 / M) * np.arange(n)).astype(np.complex64)
    xb = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    for v, bound in ((tone, 0.01), (xb, 0.35)):
        back = CHt.dechannelize(CHt.channelize(torch.as_tensor(v), M,
                                               bank=bank), M,
                                bank=bank).numpy()
        err = np.sqrt(np.mean(np.abs(v[:n - d][m] - back[d:][m]) ** 2)
                      / np.mean(np.abs(v[:n - d][m]) ** 2))
        assert err < bound, err


@pytest.mark.parametrize("M,R,tpb", [(16, None, 16), (32, 8, 8)])
def test_wola_pair_matches_jax(M, R, tpb):
    rng = np.random.default_rng(4)
    n = 4096
    x = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
         ).astype(np.complex64)
    cj = CHj.wola_analysis(jnp.asarray(x), M, R, tpb)
    ct = CHt.wola_analysis(torch.as_tensor(x), M, R, tpb)
    assert ct.shape == tuple(cj.shape)
    assert rel(ct, cj) < TOL
    rj = CHj.wola_synthesis(cj, M, R, tpb)
    rt = CHt.wola_synthesis(ct, M, R, tpb)
    assert rt.shape == tuple(rj.shape)
    assert rel(rt, rj) < TOL
    # the round trip: tests/test_advanced.py:326-345's bound, 6e-4 rms
    # relative, index aligned
    if tpb == 16:
        L = min(rt.shape[-1], n)
        m = slice(900, L - 900)
        a, b = x[:, :L][:, m], rt.numpy()[:, :L][:, m]
        err = np.sqrt(np.mean(np.abs(a - b) ** 2) / np.mean(np.abs(a) ** 2))
        assert err < 6e-4, err
