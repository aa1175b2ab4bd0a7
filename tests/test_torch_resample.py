"""The port's resampling (libtsd_tpu_torch.ops.resample, fft.resample_freq)
against the JAX package on the same numpy inputs, on the CPU: BASELINE
config 3.

Tolerances: the integer CIC pipeline bit for bit (int32 wraparound
included), the polyphase forms, the host design helpers and the
one-cycle matrix exactly; float paths within 1e-5 of the JAX output's
peak (both sides fp32, different summation order); the reference goldens
with the JAX tests' own bounds (cfg3 5e-3, tests/test_golden_ref.py:
84-94; g3_cic exact, g3_itrp 1e-6, tests/test_golden_ref3.py:126-136,
212-230)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.ops import fft as Fj, resample as Rj
from libtsd_tpu_torch.ops import fft as Ft, resample as Rt
from torch_compare import rel

GOLD = os.path.join(os.path.dirname(__file__), "golden")
TOL = 1e-5


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def cpu(a):
    return torch.as_tensor(np.asarray(a))


def signal(rng, shape, cplx=False):
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


# ------------------------------------------------------- polyphase forms

@pytest.mark.parametrize("n,M", [(40, 4), (42, 4), (45, 3)])
def test_polyphase_form_round_trip(n, M):
    x = signal(np.random.default_rng(n), (3, n))
    P = Rt.polyphase_form(cpu(x), M)
    assert np.array_equal(P.numpy(), np.asarray(Rj.polyphase_form(x, M)))
    assert np.array_equal(Rt.ipolyphase_form(P).numpy(),
                          x[:, :n // M * M])
    assert np.array_equal(Rt.ipolyphase_form(P).numpy(),
                          np.asarray(Rj.ipolyphase_form(
                              Rj.polyphase_form(x, M))))


# ------------------------------------------------------------------ CIC

def _cic_input(rng, n, cplx, overflow):
    """Integer-valued samples; with overflow, full-scale int16 steps of
    one sign, so that the integrators pass 2^31 within the block."""
    if overflow:
        x = np.where(rng.random(n) < 0.9, 32767.0, -32768.0)
        if cplx:
            x = x + 1j * np.where(rng.random(n) < 0.8, 30000.0, -30000.0)
    else:
        x = rng.integers(-2000, 2000, n).astype(np.float64)
        if cplx:
            x = x + 1j * rng.integers(-2000, 2000, n)
    return x.astype(np.complex64 if cplx else np.float32)


def _peak_int64(x, R, N, mode):
    """The largest |value| at any node of the CIC pipeline computed in int64
    without wraparound (the real plane, one shot)."""
    v = np.round(x.real).astype(np.int64)
    peak = np.abs(v).max()
    for stage in (("int", "dec", "comb") if mode == "d"
                  else ("comb", "up", "int")):
        if stage == "dec":
            v = v[::R]
        elif stage == "up":
            u = np.zeros(len(v) * R, np.int64)
            u[::R] = v
            v = u
        else:
            for _ in range(N):
                v = np.cumsum(v) if stage == "int" else np.diff(v, prepend=0)
                peak = max(peak, np.abs(v).max())
    return peak


@pytest.mark.parametrize("overflow", [False, True])
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("mode", ["d", "i"])
def test_cic_bit_for_bit(mode, cplx, overflow):
    """Decimator and interpolator, real and complex, streamed in 3 blocks
    with the state carried; y and the int32 state equal to JAX's bit for
    bit, through an int32 overflow where asked (the decimator's
    integrators at full-scale int16 input; the interpolator's nodes with
    the input scaled by 2^14)."""
    cfg = dict(R=8, N=4)
    scale = 2.0 ** 14 if mode == "i" and overflow else 1.0
    bj = Rj.Cic(config=Rj.CicConfig(**cfg), mode=mode, scale=scale)
    bt = Rt.Cic(Rt.CicConfig(**cfg), mode=mode, scale=scale, device="cpu")
    rng = np.random.default_rng(7 + 2 * cplx + overflow)
    x = _cic_input(rng, 3 * 512, cplx, overflow)
    sj, st = bj.init_for(jnp.asarray(x)), bt.init_for(cpu(x))
    for k in range(3):
        xb = x[k * 512:(k + 1) * 512]
        sj, yj = bj.step(sj, jnp.asarray(xb))
        st, yt = bt.step(st, cpu(xb))
        assert yt.dtype == (torch.complex64 if cplx else torch.float32)
        assert np.array_equal(yt.numpy(), np.asarray(yj))
        for a, b in zip(st, sj):
            assert a.dtype == torch.int32
            assert np.array_equal(a.numpy(), np.asarray(b))
    if overflow:         # int32 wrapped around
        assert _peak_int64(x * scale, cfg["R"], cfg["N"], mode) >= 1 << 31


def test_cic_golden_through_port():
    """g3_cic (R 8, N 3) through the port's decimator: exact."""
    cic = Rt.Cic(Rt.CicConfig(R=8, N=3, M=1), mode="d", device="cpu")
    _, y = cic.step(cic.init(), cpu(g("g3_cic_x")))
    assert np.array_equal(y.numpy(), g("g3_cic_y"))


def test_cic_rejects_partial_blocks_and_m():
    cic = Rt.Cic(Rt.CicConfig(R=4, N=2), scale=1 << 10, device="cpu")
    with pytest.raises(AssertionError, match="multiple of R"):
        cic.step(cic.init(), torch.zeros(6))
    with pytest.raises(AssertionError):
        Rt.Cic(Rt.CicConfig(M=2), device="cpu")


@pytest.mark.parametrize("R,N,M", [(4, 4, 1), (8, 3, 1), (64, 5, 1),
                                   (16, 2, 2)])
def test_cic_host_helpers_identical(R, N, M):
    cj, ct = Rj.CicConfig(R=R, N=N, M=M), Rt.CicConfig(R=R, N=N, M=M)
    for a, b in zip(Rt.cic_design_ba(ct), Rj.cic_design_ba(cj)):
        assert np.array_equal(a, b)
    f = np.linspace(0, 0.5, 101)
    assert np.array_equal(Rt.cic_freq(ct, f), Rj.cic_freq(cj, f))
    assert Rt.cic_bits(ct) == Rj.cic_bits(cj)
    assert Rt.cic_bit_growth(ct) == Rj.cic_bit_growth(cj)
    assert Rt.cic_bit_growth(ct, 12, 14) == Rj.cic_bit_growth(cj, 12, 14)
    if M == 1:
        assert np.array_equal(Rt.cic_comp_design(ct, 1.0, 2, 0.1, 31),
                              Rj.cic_comp_design(cj, 1.0, 2, 0.1, 31))
    c = np.convolve(np.r_[1.0, np.zeros(R - 1), -1.0], [1.0, 2.0])
    assert np.array_equal(Rt._poly_div_1mz(c), Rj._poly_div_1mz(c))


# ----------------------------------------------------- half-band, ratios

@pytest.mark.parametrize("cplx", [False, True])
def test_halfband_decim_matches_jax(cplx):
    x = signal(np.random.default_rng(11), (2, 3 * 256), cplx)
    bj, bt = Rj.HalfbandDecim.create(n=31), Rt.HalfbandDecim.create(
        n=31, device="cpu")
    sj, st = bj.init_for(jnp.asarray(x)), bt.init_for(cpu(x))
    for k in range(3):
        sj, yj = bj.step(sj, jnp.asarray(x[:, k * 256:(k + 1) * 256]))
        st, yt = bt.step(st, cpu(x[:, k * 256:(k + 1) * 256]))
        assert rel(yt, yj) < TOL
    assert (bt.ratio, bt.delay) == (bj.ratio, bj.delay)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("route", ["cycle", "gather"])
def test_rational_resampler_147_160(route, cplx):
    """48 k -> 44.1 k (p/q = 147/160) on 2 channels, streamed in 3 blocks of
    whole cycles (2, 3 and 1 x 160 samples), through the one-cycle matrix
    or (A replaced by the (1, 1) marker on both sides) the per-output
    window gather: within 1e-5 of JAX's peak; the two routes of the port
    alike; A equal to JAX's."""
    rj = Rj.RationalResampler.create(44100 / 48000)
    rt = Rt.RationalResampler.create(44100 / 48000, device="cpu")
    assert (rt.p, rt.q) == (rj.p, rj.q) == (147, 160)
    assert np.array_equal(rt.A.numpy(), np.asarray(rj.A))
    cyc = Rt.RationalResampler(rt.itrp, rt.A, rt.p, rt.q)
    if route == "gather":
        rj = rj.replace(A=jnp.zeros((1, 1), jnp.float32))
        rt = Rt.RationalResampler(rt.itrp, torch.zeros(1, 1), rt.p, rt.q)
    x = signal(np.random.default_rng(5 + cplx), (2, 6 * 160), cplx)
    sj, st, sc = (rj.init_for(jnp.asarray(x)), rt.init_for(cpu(x)),
                  cyc.init_for(cpu(x)))
    i = 0
    for m in (2, 3, 1):
        xb = x[:, i:i + 160 * m]
        i += 160 * m
        sj, yj = rj.step(sj, jnp.asarray(xb))
        st, yt = rt.step(st, cpu(xb))
        sc, yc = cyc.step(sc, cpu(xb))
        assert yt.shape == (2, 147 * m) and yt.is_complex() == cplx
        assert rel(yt, yj) < TOL
        assert rel(yt, yc) < TOL
    assert rel(st, np.asarray(sj)) == 0.0
    assert rt.delay == rj.delay and rt.ratio == rj.ratio


@pytest.mark.parametrize("ratio", [0.3, 0.91875, 2.5])
def test_resample_matches_jax(ratio):
    """resample at 0.3 (one half-band stage, then 0.6), 147/160 (the
    rational stage alone) and 2.5 (one x2 upsampler, then 1.25), on 2
    channels of 2000 samples; the Resampler's stages and ratio those of
    JAX."""
    x = signal(np.random.default_rng(int(ratio * 100)), (2, 2000))
    yt = Rt.resample(cpu(x), ratio)
    yj = np.asarray(Rj.resample(jnp.asarray(x), ratio))
    assert yt.shape == yj.shape
    assert rel(yt, yj) < TOL
    bj, bt = Rj.Resampler.create(ratio), Rt.Resampler.create(ratio,
                                                             device="cpu")
    assert [type(s).__name__ for s in bt.stages] == \
        [type(s).__name__ for s in bj.stages]
    assert bt.ratio == bj.ratio


def test_resample_config3_golden_through_port():
    """BASELINE config 3: the reference's filtre_reechan 48 k -> 44.1 k on
    cfg3_x, through the port (the JAX test's bound and trim)."""
    y = Rt.resample(cpu(g("cfg3_x")), 44100 / 48000).numpy()
    y_ref = g("cfg3_y")
    assert y.shape == y_ref.shape
    assert np.abs(y[50:-50] - y_ref[50:-50]).max() < 5e-3


def test_interpolator_goldens_through_port():
    """g3_itrp (cspline, linear, Lagrange 3 at tau 0.25, 0.75) and
    g3_itrp_sinc (15 taps, normalised) through the port's coefficients."""
    ours = []
    for tau in (0.25, 0.75):
        ours += [Rt.cspline_coefs(tau), Rt.linear_coefs(tau),
                 Rt.lagrange_coefs(3, tau)]
    ours = np.concatenate([np.asarray(c, np.float32) for c in ours])
    assert np.abs(ours - g("g3_itrp")).max() < 1e-6
    ref = g("g3_itrp_sinc")
    for i, tau in enumerate((0.25, 0.75)):
        r = ref[i * 15:(i + 1) * 15]
        assert np.abs(Rt.sinc_interp_coefs(15, 0.5, tau)
                      - r / r.sum()).max() < 1e-6


# ------------------------------------------------------ irregular, freq

@pytest.mark.parametrize("mode", ["linear", "cspline"])
@pytest.mark.parametrize("kind", ["real", "complex", "int"])
def test_interp_irregular_matches_jax(mode, kind):
    """Knots at irregular spacing, queries inside and outside [x0, x-1]."""
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.uniform(0.2, 1.5, 200)).astype(np.float32)
    y = {"real": signal(rng, 200), "complex": signal(rng, 200, True),
         "int": rng.integers(-50, 50, 200).astype(np.int32)}[kind]
    x2 = np.sort(rng.uniform(x[0] - 3, x[-1] + 3, 777)).astype(np.float32)
    yt = Rt.interp_irregular(cpu(x), cpu(y), cpu(x2), mode, device="cpu")
    yj = np.asarray(Rj.interp_irregular(jnp.asarray(x), jnp.asarray(y),
                                        jnp.asarray(x2), mode))
    assert yt.shape == yj.shape and yt.is_complex() == (kind == "complex")
    assert rel(yt, yj) < TOL


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n,ratio", [(256, 2.0), (255, 2.0), (256, 0.5),
                                     (255, 0.37), (101, 1.5)])
def test_resample_freq_matches_jax(n, ratio, cplx):
    x = signal(np.random.default_rng(n), (2, n), cplx)
    yt = Ft.resample_freq(cpu(x), ratio)
    yj = np.asarray(Fj.resample_freq(jnp.asarray(x), ratio))
    assert yt.shape == yj.shape and yt.is_complex() == cplx
    assert rel(yt, yj) < TOL


def test_resample_freq_guards():
    x = torch.zeros(8)
    assert Ft.resample_freq(x, 1.01) is x
    with pytest.raises(ValueError, match="degenerate"):
        Ft.resample_freq(torch.zeros(3), 0.3)
