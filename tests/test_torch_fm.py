"""The FM slice of the port against the JAX package on the CPU, on the same
numpy inputs: ``fir_decim_toeplitz_mats``, kernel #8's plain version
(``ops.kernels.fm``) against JAX ``FmChainPallas`` (interpret mode, the
file's one Pallas call) and against the composed ``FmReceiver``,
``FmReceiver`` one shot and streamed, its JAX carriers, ``models.analog``,
the rest of ``ops.signal`` and ``ops.rng``; and the reference-binary
goldens cfg4, g3_am_* and g4_fm_* run on the port.

Tolerances and why:

* exact: ``fir_decim_toeplitz_mats`` (a copy of a numpy function), the
  discrete generators, index helpers.
* 1e-5 absolute on audio: #8's plain version against JAX's kernel and
  against the composed chain after the first 4 outputs (the JAX gate,
  tests/test_pallas_iir_fm.py:101-102); float32 both sides, the NCO phase
  in float64 here and in float32 tables there.
* 1e-5 of the peak: FmReceiver, analog modems and trig generators against
  JAX (float32, another summation order); 1e-3 for streamed against one
  shot (tests/test_receivers.py:85-86); 1e-4 for FM modulation, whose
  phase is a float32 running sum of tens of radians summed in another
  order, and for a receiver continued from a carried JAX state.
* The goldens keep the gates of their JAX tests
  (tests/test_golden_ref.py:99-110, test_golden_ref3.py:140-150,
  test_golden_ref4.py:37-55).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import analog as ANj
from libtsd_tpu.models import receivers as RXj
from libtsd_tpu.ops import signal as SGj
from libtsd_tpu.ops.pallas.fm import FmChainPallas
from libtsd_tpu.ops.pallas.fm import fir_decim_toeplitz_mats as fdtm_j
from libtsd_tpu_torch.models import analog as ANt
from libtsd_tpu_torch.models import receivers as RXt
from libtsd_tpu_torch.models.demod import quadrature_discriminator
from libtsd_tpu_torch.ops import rng as RNt
from libtsd_tpu_torch.ops import signal as SGt
from libtsd_tpu_torch.ops.kernels import fm as KF
from libtsd_tpu_torch.utils import convert

CPU = "cpu"
GOLD = os.path.join(os.path.dirname(__file__), "golden")


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def rel(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def t_(a):
    return torch.as_tensor(np.array(a))


def fm_tone(cfg, N, phases, seed=0, noise=0.001):
    """FM-modulated tone at the channel frequency (the signal of
    tests/test_pallas_iir_fm.py:86-95), one channel per carrier phase."""
    rng = np.random.default_rng(seed)
    n = np.arange(N)
    audio = 0.4 * np.sin(2 * np.pi * 0.002 * n)
    ph = 2 * np.pi * np.cumsum(cfg.deviation / cfg.decim * audio)
    car = np.exp(1j * (2 * np.pi * cfg.channel_freq * n + ph))
    x = np.stack([car * np.exp(1j * a) for a in phases])
    x = x + noise * (rng.standard_normal(x.shape)
                     + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


@pytest.mark.parametrize("K,R", [(63, 4), (255, 4), (63, 2), (129, 8)])
def test_fir_decim_toeplitz_mats_exact(K, R):
    h = np.random.default_rng(K).standard_normal(K)
    Gt, rt = KF.fir_decim_toeplitz_mats(h, R)
    Gj, rj = fdtm_j(h, R)
    assert rt == rj and np.array_equal(Gt, Gj)


@pytest.fixture(scope="module")
def fm_case():
    cfg = RXj.FmReceiverConfig(channel_freq=0.25, decim=4, chan_taps=63,
                               deviation=0.1, deemph_fc=0.05)
    N = 4 * 32 * 128 * 2          # two JAX kernel chunks at tb = 32
    x = fm_tone(cfg, N, (0.0, 0.3))
    fj = FmChainPallas(cfg.channel_freq, cfg.decim, cfg.chan_taps,
                       cfg.deviation, cfg.deemph_fc)
    yj = np.asarray(fj(jnp.asarray(x.real), jnp.asarray(x.imag), tb=32,
                       interpret=True))
    return dict(cfg=cfg, x=x, fj=fj, yj=yj)


def test_fm_chain_plain_vs_jax_kernel_and_composed(fm_case):
    cfg, x = fm_case["cfg"], fm_case["x"]
    ft = KF.FmChain(cfg.channel_freq, cfg.decim, cfg.chan_taps,
                    cfg.deviation, cfg.deemph_fc, device=CPU)
    y = ft(t_(x.real), t_(x.imag), tb=32)
    assert y.shape == (2, x.shape[1] // 4)
    assert np.abs(y.numpy() - fm_case["yj"]).max() < 1e-5
    rx = RXt.FmReceiver.create(RXt.FmReceiverConfig(
        **vars(cfg)), device=CPU)
    xt = t_(x)
    _, yc = rx.step(rx.init_for(xt), xt)
    assert (y[:, 4:] - yc[:, 4:]).abs().max().item() < 1e-5
    # the JAX operators carried into the port give the same chain
    fc = convert.fm_chain_from_jax(fm_case["fj"], device=CPU)
    assert torch.equal(fc.h, ft.h) and fc.hist == ft.hist
    assert (fc(t_(x.real), t_(x.imag)) - y).abs().max().item() < 1e-6


def test_fm_chain_checks():
    fc = KF.FmChain(0.25, 4, 63, 0.1, 0.05, device=CPU)
    with pytest.raises(ValueError, match="multiple of 16384"):
        fc(torch.zeros(1, 4096), torch.zeros(1, 4096))
    long = KF.FmChain(0.25, 4, 0, 0.1, 0.0, chan_h=np.ones(1000),
                      device=CPU)
    with pytest.raises(ValueError, match="chunk too small"):
        long(torch.zeros(1, 512), torch.zeros(1, 512), tb=1)
    # no de-emphasis: the chain ends at the discriminator
    assert (fc.b0, fc.c) != (1.0, 0.0)
    off = KF.FmChain(0.25, 4, 63, 0.1, 0.0, device=CPU)
    assert (off.b0, off.c, off.p) == (1.0, 0.0, 0.0)


@pytest.mark.parametrize("f0,deemph", [(0.22, 0.05), (0.15, 0.0)])
def test_fm_receiver_vs_jax_one_shot_and_streamed(f0, deemph):
    cfg = dict(channel_freq=f0, decim=4, deviation=0.1, deemph_fc=deemph)
    rj = RXj.FmReceiver.create(RXj.FmReceiverConfig(**cfg))
    rt = RXt.FmReceiver.create(RXt.FmReceiverConfig(**cfg), device=CPU)
    x = fm_tone(RXt.FmReceiverConfig(**cfg), 4096, (0.5, 2.5), noise=0.05)
    step = jax.jit(rj.step)
    sj, yj = step(rj.init_for(jnp.asarray(x)), jnp.asarray(x))
    st, yt = rt.step(rt.init_for(t_(x)), t_(x))
    assert rel(yt, yj) < 1e-5
    assert abs(float(st["nco"]) - float(sj["nco"])) < 1e-6
    # streamed in 512-sample blocks
    s, ys = rt.init_for(t_(x)), []
    for i in range(0, 4096, 512):
        s, yb = rt.step(s, t_(x[:, i:i + 512]))
        ys.append(yb)
    assert (torch.cat(ys, -1) - yt).abs().max().item() < 1e-3
    # a JAX receiver and its state after the first half, carried over
    s1, _ = step(rj.init_for(jnp.asarray(x)), jnp.asarray(x[:, :2048]))
    rc = convert.fm_receiver_from_jax(rj, device=CPU)
    sc = convert.fm_receiver_state_from_jax(s1, device=CPU)
    assert set(sc) == set(st)
    _, y2 = rc.step(sc, t_(x[:, 2048:]))
    assert rel(y2, yj[:, 512:]) < 1e-4


def test_fm_receiver_recovers_each_channels_tone():
    """The gate of tests/test_receivers.py:48-66: each channel's recovered
    audio peaks at its own tone frequency."""
    cfg = RXt.FmReceiverConfig(channel_freq=0.15, deemph_fc=0.0)
    rx = RXt.FmReceiver.create(cfg, device=CPU)
    n, freqs = 4096, (0.003, 0.006)
    k = torch.arange(n)
    xs = torch.stack([ANt.fm_modulate(torch.sin(2 * np.pi * f * k).float(),
                                      cfg.deviation / cfg.decim)
                      * SGt.sigexp(cfg.channel_freq, n, device=CPU)
                      for f in freqs])
    _, audio = rx.step(rx.init_for(xs), xs)
    assert audio.shape == (2, n // 4)
    for c, f in enumerate(freqs):
        seg = audio[c, 100:-100].numpy()
        sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        assert abs(np.argmax(sp) / len(seg) - 4 * f) < 0.003


# ------------------------------------------------------------ analog

def test_analog_modems_vs_jax():
    rng = np.random.default_rng(3)
    au = np.convolve(rng.standard_normal(3000), np.ones(16) / 16,
                     "same").astype(np.float32)
    for mode in ("dsb", "dsb-sc", "usb", "lsb"):
        c = ANt.AMConfig(mode=mode, index=0.7, f_rf=0.12)
        cj = ANj.AMConfig(mode=mode, index=0.7, f_rf=0.12)
        xm = ANt.am_modulate(t_(au), c)
        xj = ANj.am_modulate(jnp.asarray(au), cj)
        assert rel(xm, xj) < 1e-5
        assert rel(ANt.am_demodulate(xm, c),
                   ANj.am_demodulate(jnp.asarray(xm.numpy()), cj)) < 1e-5
    with pytest.raises(ValueError, match="AM mode"):
        ANt.am_modulate(t_(au), ANt.AMConfig(mode="vsb"))
    assert rel(ANt.hilbert_tfd(t_(au)), ANj.hilbert_tfd(jnp.asarray(au))) \
        < 1e-5
    assert rel(ANt.hilbert_analytic(t_(au)),
               ANj.hilbert_analytic(jnp.asarray(au))) < 1e-5
    xf = ANj.fm_modulate(jnp.asarray(au), 0.1)
    # the phase is a float32 running sum of tens of radians, summed in
    # another order: 1e-4
    assert rel(ANt.fm_modulate(t_(au), 0.1), xf) < 1e-4
    assert rel(ANt.fm_demodulate(t_(xf), 0.1, 0.05),
               ANj.fm_demodulate(xf, 0.1, 0.05)) < 1e-5


def test_fm_broadcast_stereo_vs_jax():
    """Multiplex, mono, the pilot PLL and the stereo outputs on a stereo
    pair of tones (the same multiplex fed to both sides)."""
    fe, n = 240e3, 6000
    tt = np.arange(n) / fe
    left = (0.5 * np.sin(2 * np.pi * 1000 * tt)).astype(np.float32)
    right = (0.5 * np.sin(2 * np.pi * 2500 * tt)).astype(np.float32)
    xj = ANj.fm_broadcast_multiplex(jnp.asarray(left), jnp.asarray(right), fe)
    assert rel(ANt.fm_broadcast_multiplex(t_(left), t_(right), fe), xj) < 1e-4
    Lt, Rt, dt = ANt.fm_broadcast_debug(t_(xj), fe)
    Lj, Rj, dj = ANj.fm_broadcast_debug(xj, fe)
    for k in ("mpx", "pilot", "sub38", "lpr", "lmr"):
        assert rel(dt[k], dj[k]) < 1e-5, k
    assert rel(Lt, Lj) < 1e-5 and rel(Rt, Rj) < 1e-5
    L2, R2 = ANt.fm_broadcast_demodulate(t_(xj), fe)
    assert torch.equal(L2, Lt) and torch.equal(R2, Rt)
    assert rel(ANt.fm_broadcast_mono(t_(xj), fe),
               ANj.fm_broadcast_mono(xj, fe)) < 1e-5


# --------------------------------------------------------- the goldens

def test_cfg4_fm_discriminator_golden():
    """tests/test_golden_ref.py:99-110 on the port."""
    y = quadrature_discriminator(t_(g("cfg4_x")),
                                 torch.zeros(1, dtype=torch.complex64))
    assert np.abs(y.numpy()[1:] - g("cfg4_y")[1:]).max() < 1e-6


def test_g3_am_modulator_goldens():
    """tests/test_golden_ref3.py:138-150 on the port."""
    audio = t_(g("g3_am_audio"))
    for mode, name, tol in (("dsb", "g3_am_dsb", 2e-6),
                            ("dsb-sc", "g3_am_dsbsc", 2e-6),
                            ("usb", "g3_am_usb", 2e-3)):
        y = ANt.am_modulate(audio, ANt.AMConfig(mode=mode, index=0.8,
                                                f_rf=0.1)).numpy()
        ref = g(name)
        assert np.abs(y[:len(ref)] - ref).max() < tol, mode


def test_g4_fm_broadcast_mono_golden():
    """tests/test_golden_ref4.py:37-55 on the port."""
    fe = 600e3
    x = t_(g("g4_fm_x"))
    a3, fech2, R = ANt._fm_broadcast_front(x, fe)
    assert R == 4 and fech2 == fe / 4
    ref_a3 = g("g4_fm_a3")
    a3 = a3.numpy()[:len(ref_a3)]
    s = np.abs(ref_a3).max()
    assert np.abs(a3[64:] - ref_a3[64:]).max() < 1e-4 * s
    ref = g("g4_fm_lpr")
    lpr = ANt.fm_broadcast_mono(x, fe).numpy()
    assert np.abs(lpr[384:len(ref)] - ref[384:]).max() < 1e-4 * s


# ------------------------------------------------------- signal, rng

def test_signal_generators_vs_jax():
    for name, args in (("sigexp", (0.123, 5000)), ("sigsin", (0.01, 300)),
                       ("sigcos", (0.3, 70000)), ("siggauss", (64,)),
                       ("siggsin", (0.05, 128)),
                       ("trange", (10, 8.0)), ("linspace", (-1.0, 2.0, 9)),
                       ("logspace", (1.0, 1000.0, 7)),
                       ("nco_phase", (0.01, 1000))):
        assert rel(getattr(SGt, name)(*args, device=CPU),
                   getattr(SGj, name)(*args)) < 1e-5, name
    # the chirp's phase is a float32 running sum, summed in another order
    assert rel(SGt.sigchirp(0.01, 0.2, 500, device=CPU),
               SGj.sigchirp(0.01, 0.2, 500)) < 1e-4
    for name, args in (("sigtri", (7, 50)), ("sigsquare", (5, 40)),
                       ("sigsawtooth", (6, 30)), ("sigimp", (9, 3)),
                       ("signyquist", (11,)), ("irange", (-3, 4))):
        assert np.array_equal(getattr(SGt, name)(*args, device=CPU).numpy(),
                              np.asarray(getattr(SGj, name)(*args))), name


def test_signal_utilities_vs_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(40).astype(np.float32)
    ph = np.cumsum(rng.uniform(-3, 3, 50)).astype(np.float32)
    xt, xj = t_(x), jnp.asarray(x)
    pairs = [(SGt.downsample(xt, 3, 1), SGj.downsample(xj, 3, 1)),
             (SGt.upsample(xt, 3), SGj.upsample(xj, 3)),
             (SGt.sample_hold(xt, 2), SGj.sample_hold(xj, 2)),
             (SGt.zero_pad(xt, 50), SGj.zero_pad(xj, 50)),
             (SGt.rotate_vec(xt, 5), SGj.rotate_vec(xj, 5)),
             (SGt.diff(xt), SGj.diff(xj)),
             (SGt.find(xt > 1), SGj.find(xj > 1)),
             (SGt.find(xt > 1, size=12), SGj.find(xj > 1, size=12)),
             (SGt.find_first(xt > 1), SGj.find_first(xj > 1)),
             (SGt.find_last(xt > 1), SGj.find_last(xj > 1)),
             (SGt.find_first(xt > 9), SGj.find_first(xj > 9)),
             (SGt.find_first_local_max(xt), SGj.find_first_local_max(xj)),
             (SGt.sliding_frames(xt, 8, 3, 11),
              SGj.sliding_frames(xj, 8, 3, 11))]
    for a, b in pairs:
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert rel(SGt.cumsum(xt), SGj.cumsum(xj)) < 1e-6
    assert rel(SGt.unwrap_phase(t_(ph)), SGj.unwrap_phase(jnp.asarray(ph))) \
        < 1e-6
    for f in ("wrap_2pi", "wrap_pm_pi", "sinc", "db2mag", "db2pow"):
        assert rel(getattr(SGt, f)(t_(ph)),
                   getattr(SGj, f)(jnp.asarray(ph))) < 1e-5, f
    a, b = SGt.length_match(xt[:5], xt)
    assert a.shape == b.shape == (40,)
    nj, nt = SGj.NCO.create(0.137), SGt.NCO.create(0.137, device=CPU)
    sj, st = nj.init(), nt.init()
    for n in (100, 333):
        sj, zj = nj.gen(sj, n)
        st, zt = nt.gen(st, n)
        assert rel(zt, zj) < 1e-5 and abs(float(st) - float(sj)) < 1e-5
    assert rel(nt.step(st, t_(x))[1], nj.step(sj, xj)[1]) < 1e-5


def test_rng_draws():
    gen = torch.Generator().manual_seed(0)
    n = RNt.randn(gen, 20000)
    assert n.dtype == torch.float32 and abs(n.std().item() - 1) < 0.03
    c = RNt.randcn(gen, 20000)
    assert c.dtype == torch.complex64
    assert abs((c.abs() ** 2).mean().item() - 1) < 0.05
    u = RNt.randu(gen, 1000, 2, lo=2.0, hi=3.0)
    assert u.shape == (1000, 2) and u.min() >= 2.0 and u.max() < 3.0
    b = RNt.randb(gen, 1000)
    assert b.dtype == torch.bool and 400 < int(b.sum()) < 600
    i = RNt.randi(gen, 5, 1000)
    assert i.dtype == torch.int32 and set(i.tolist()) == set(range(5))
    r = RNt.Rng(3, device=CPU)
    assert torch.equal(r.randn(4), RNt.Rng(3, device=CPU).randn(4))
    assert RNt.seed(1, device=CPU).randi(3, 2).shape == (2,)
