"""The port's FIR runtime (libtsd_tpu_torch.ops.filter_rt, block) against
the JAX package on the same numpy inputs.

Tolerances, relative to the reference's peak: 1e-6 for the "highest" tier
(both sides true fp32, different summation order), and the JAX package's
own gates for the bf16 tiers (ops/filter_rt.py Fir docstring): 1e-5 for
"split", 2.5e-3 for "bf16"."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu import block as Bj
from libtsd_tpu.ops import filter_rt as FRj
from libtsd_tpu_torch import block as Bt
from libtsd_tpu_torch.ops import filter_rt as FRt
from libtsd_tpu_torch.utils.convert import fir_from_jax

GOLD = os.path.join(os.path.dirname(__file__), "golden")
TOL = {"highest": 1e-6, "split": 1e-5, "bf16": 2.5e-3}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _taps(rng, K, cplx):
    h = rng.standard_normal(K)
    return h + 1j * rng.standard_normal(K) if cplx else h


@pytest.mark.parametrize("K", [1, 3, 31, 128, 129, 256, 300])
@pytest.mark.parametrize("cplx", [False, True])
def test_fir_toeplitz_mats_identical(K, cplx):
    """numpy taps give numpy G, tensor taps a tensor G: both equal to the
    JAX package's, in h's dtype."""
    h = _taps(np.random.default_rng(K), K, cplx)
    ref = FRj.fir_toeplitz_mats(h)
    g = FRt.fir_toeplitz_mats(h)
    assert g.dtype == ref.dtype and np.array_equal(g, ref)
    gt = FRt.fir_toeplitz_mats(torch.as_tensor(h))
    assert gt.dtype == torch.as_tensor(ref).dtype
    assert torch.equal(gt, torch.as_tensor(ref))


@pytest.mark.parametrize("caller_tf32", [False, True])
def test_highest_tier_restores_callers_tf32_setting(caller_tf32):
    """The "highest" tier turns TF32 off only around its own matmuls: the
    caller's process-wide setting is the same afterwards, also when the
    matmul raises."""
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    seen = []
    real_matmul = torch.matmul

    def spy(a, b):
        seen.append(flags.allow_tf32)
        return real_matmul(a, b)

    try:
        flags.allow_tf32 = caller_tf32
        blk = FRt.Fir.create(np.ones(5), precision="highest",
                              device="cpu")
        x = torch.ones(2, 300)
        torch.matmul = spy
        try:
            blk.step(blk.init_for(x), x)
        finally:
            torch.matmul = real_matmul
        assert seen and not any(seen)
        assert flags.allow_tf32 is caller_tf32
        with pytest.raises(RuntimeError):
            FRt._mm_prec(torch.ones(2, 3), torch.ones(4, 5), "highest")
        assert flags.allow_tf32 is caller_tf32
    finally:
        flags.allow_tf32 = saved


@pytest.mark.parametrize("kind", ["real", "complex_x", "complex_taps"])
def test_fir_filter_and_valid_match_jax(kind):
    rng = np.random.default_rng(1)
    h = _taps(rng, 37, kind == "complex_taps")
    x = rng.standard_normal((2, 1000)).astype(np.float32)
    if kind == "complex_x":
        x = (x + 1j * rng.standard_normal((2, 1000))).astype(np.complex64)
    yt = FRt.fir_filter(h, torch.as_tensor(x)).numpy()
    yj = np.asarray(FRj.fir_filter(h, jnp.asarray(x)))
    assert yt.dtype == yj.dtype and yt.shape == yj.shape
    assert rel(yt, yj) < 1e-6
    vt = FRt.fir_filter_valid(h, torch.as_tensor(x)).numpy()
    vj = np.asarray(FRj.fir_filter_valid(h, jnp.asarray(x)))
    assert vt.shape == vj.shape and rel(vt, vj) < 1e-6


def test_filter_signal_direct_matches_jax_and_rest_raises():
    rng = np.random.default_rng(2)
    h = rng.standard_normal(64)
    x = rng.standard_normal(3000).astype(np.float32)
    yt = FRt.filter_signal(h, torch.as_tensor(x)).numpy()
    yj = np.asarray(FRj.filter_signal(h, jnp.asarray(x)))
    assert rel(yt, yj) < 1e-6
    # an IIR design (ported with the FM slice) goes through iir_filter, as
    # in the JAX package: float32 scans in another order, 1e-5 of the peak
    ba = ([1.0], [1.0, -0.5])
    assert rel(FRt.filter_signal(ba, torch.as_tensor(x)).numpy(),
               np.asarray(FRj.filter_signal(ba, jnp.asarray(x)))) < 1e-5
    with pytest.raises(ValueError, match="mode"):
        FRt.filter_signal(h, torch.as_tensor(x), mode="wola")
    # mode="fft" (OlaFft, ported with the frame receiver): fp32 FFTs on
    # both sides in another order, 1e-5 of the peak
    ft = FRt.filter_signal(h, torch.as_tensor(x), mode="fft").numpy()
    fj = np.asarray(FRj.filter_signal(h, jnp.asarray(x), mode="fft"))
    assert ft.dtype == fj.dtype and ft.shape == fj.shape
    assert rel(ft, fj) < 1e-5


@pytest.mark.parametrize("precision", ["highest", "split", "bf16"])
@pytest.mark.parametrize("kind", ["real", "complex_x", "complex_taps"])
@pytest.mark.parametrize("K", [3, 31, 256])
def test_fir_step_streamed_matches_jax(precision, kind, K):
    """Fir.step over 3 chunks, the port's Fir converted from the JAX one;
    outputs and carried state agree at the tier's tolerance."""
    rng = np.random.default_rng(K)
    h = _taps(rng, K, kind == "complex_taps")
    x = rng.standard_normal((2, 3 * 300)).astype(np.float32)
    if kind == "complex_x":
        x = (x + 1j * rng.standard_normal(x.shape)).astype(np.complex64)
    fj = FRj.Fir.create(h, precision=precision)
    ft = fir_from_jax(fj, device="cpu")
    assert ft.K == K and ft.precision == precision
    assert ft.complex_taps == (kind == "complex_taps")
    sj = fj.init_for(jnp.asarray(x))
    st = ft.init_for(torch.as_tensor(x))
    for i in range(3):
        chunk = x[:, i * 300:(i + 1) * 300]
        sj, yj = fj.step(sj, jnp.asarray(chunk))
        st, yt = ft.step(st, torch.as_tensor(chunk))
        assert yt.shape == tuple(yj.shape)
        assert rel(yt.numpy(), yj) < TOL[precision], (i, rel(yt.numpy(), yj))
    assert np.array_equal(st.numpy(), np.asarray(sj))


def test_fir_from_jax_leaves_dict():
    h = np.random.default_rng(3).standard_normal(20) * (1 + 1j)
    fj = FRj.Fir.create(h, precision="split")
    ft = fir_from_jax({"G_": np.asarray(fj.G_), "K": fj.K,
                       "complex_taps": fj.complex_taps,
                       "precision": fj.precision}, device="cpu")
    assert np.array_equal(ft.G.numpy(), np.asarray(fj.G))
    assert ft.delay == fj.delay and ft.tail_state


def test_to_ri_from_ri_match_jax():
    from libtsd_tpu import config as Cj
    from libtsd_tpu_torch import config as Ct
    z = (np.arange(6) * (1 - 0.5j)).reshape(2, 3).astype(np.complex64)
    assert np.array_equal(Ct.to_ri(z).numpy(), np.asarray(Cj.to_ri(z)))
    assert np.array_equal(Ct.to_ri(torch.as_tensor(z)).numpy(),
                          np.asarray(Cj.to_ri(z)))
    assert np.array_equal(Ct.from_ri(np.array(Cj.to_ri(z))).numpy(), z)


def test_cfg1_filtering_golden_through_port():
    """filtrer(h, x) golden of the reference binary (config 1)."""
    h = np.load(os.path.join(GOLD, "cfg1_h.npy"))
    x = np.load(os.path.join(GOLD, "cfg1_x.npy"))
    y = FRt.filter_signal(h, torch.as_tensor(x)).numpy()
    assert np.abs(y[:500] - np.load(os.path.join(GOLD, "cfg1_y.npy"))).max() \
        < 2e-6


def test_stream_chain_and_pad_match_jax():
    """block.stream (with a remainder chunk), Chain bookkeeping and
    pad_to_multiple agree with the JAX package."""
    rng = np.random.default_rng(4)
    h1, h2 = rng.standard_normal(17), rng.standard_normal(9)
    x = rng.standard_normal(1000).astype(np.float32)
    cj = Bj.chain(FRj.Fir.create(h1), FRj.Fir.create(h2))
    ct = Bt.chain(FRt.Fir.create(h1, device="cpu"),
                  FRt.Fir.create(h2, device="cpu"), Bt.Identity())
    assert ct.delay == cj.delay and ct.ratio == cj.ratio
    _, yj = Bj.stream(cj, jnp.asarray(x), 128)
    st, yt = Bt.stream(ct, torch.as_tensor(x), 128)
    assert yt.shape == tuple(yj.shape) and rel(yt.numpy(), yj) < 1e-6
    assert len(st) == 3
    np.testing.assert_array_equal(
        Bt.pad_to_multiple(torch.as_tensor(x[None]), 128, axis=1).numpy(),
        np.asarray(Bj.pad_to_multiple(jnp.asarray(x[None]), 128, axis=1)))
    assert torch.equal(ct.apply(torch.as_tensor(x)),
                       ct.step(ct.init_for(torch.as_tensor(x)),
                               torch.as_tensor(x))[1])
