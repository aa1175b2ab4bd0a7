"""The QAM receive slice's modules in the port against the JAX package on
the CPU, on the same numpy inputs: iir_design, cycles, the decimators,
FirUps, the interpolators, delay_signal, bit vectors, waveforms, the
modulator, BER tooling, loop filters and PEDs, Cpll/Rpll, ClockRec and
DecisionDemod; and the rule that entry points build on the card unless
asked for the CPU.

Tolerances and why:

* exact: ``iir_design`` (a copy of a numpy module), ``cycles`` (float64
  on the host, then the same float32 sums), interpolator tables (float64
  on the host, then float32), constellations, symbol indices, bits and
  the BER counts (integer work); 1e-6 for pi/4-QPSK's rotated symbols
  and constellation (a complex product).
* 1e-5 of the peak: filters, ``delay_signal``, waveform samples and the
  modulator -- float32 on both sides, in another summation order or
  through another FFT.
* 1e-6: the closed-form interpolator taps against the JAX package's
  (float32 formulas in another operation order); loop filters and TEDs
  on the same samples; PEDs to 1e-5, and 1e-4 relative where the power
  loop raises a QAM-16 sample to the 16th power.
* 1e-4: the per-sample PLLs and clock recovery after hundreds of
  feedback steps (float32 differences carried through the loop).
* DecisionDemod: equal masks, max |dsymbol| < 1e-3, bit mismatch < 1e-4,
  the gate tests/test_demod_sb.py:174-178 sets between two float32
  versions of one decision-directed loop.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import ber as BERj
from libtsd_tpu.models import bitstream as BSj
from libtsd_tpu.models import carrier_rec as CRj
from libtsd_tpu.models import clock_rec as CKj
from libtsd_tpu.models import demod_dec as DDj
from libtsd_tpu.models import modulator as MODj
from libtsd_tpu.models import waveform as WFj
from libtsd_tpu.models.demod_sb import _POLY_TAPS
from libtsd_tpu.ops import fft as FFj
from libtsd_tpu.ops import filter_rt as FRj
from libtsd_tpu.ops import iir_design as IIRj
from libtsd_tpu.ops import resample as RSj
from libtsd_tpu.ops import signal as SGj
from libtsd_tpu_torch.models import ber as BERt
from libtsd_tpu_torch.models import bitstream as BSt
from libtsd_tpu_torch.models import carrier_rec as CRt
from libtsd_tpu_torch.models import clock_rec as CKt
from libtsd_tpu_torch.models import demod_dec as DDt
from libtsd_tpu_torch.models import modulator as MODt
from libtsd_tpu_torch.models import waveform as WFt
from libtsd_tpu_torch.ops import fft as FFt
from libtsd_tpu_torch.ops import filter_rt as FRt
from libtsd_tpu_torch.ops import iir_design as IIRt
from libtsd_tpu_torch.ops import resample as RSt
from libtsd_tpu_torch.ops import signal as SGt
from libtsd_tpu_torch.ops.kernels.demod_sb import interp_taps
from libtsd_tpu_torch.utils import convert

CPU = "cpu"


def rel(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def cplx(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


WAVEFORMS = ["bpsk", "qpsk", "pi4-qpsk", "qam", "ask", "fsk", "gmsk"]


def _wf_pair(name, **kw):
    wj = WFj.make_waveform(name, **kw)
    return wj, convert.waveform_from_jax(wj, device=CPU)


# ------------------------------------------------------------ ops


def test_iir_design_is_an_exact_copy():
    for fn, args in [("butterworth_analog", (5,)),
                     ("cheby1_analog", (4, 1.0)),
                     ("cheby2_analog", (4, 40.0)),
                     ("elliptic_analog", (5, 0.5, 50.0))]:
        a, b = getattr(IIRj, fn)(*args), getattr(IIRt, fn)(*args)
        assert np.array_equal(a.z, b.z) and np.array_equal(a.p, b.p)
        assert a.k == b.k
    for args in [(4, "lp", "butt", 0.1), (3, "hp", "cheb1", 0.2, 1.0),
                 (4, "bp", "cheb2", 0.1, 1.0, 40.0, 0.2)]:
        assert np.array_equal(np.asarray(IIRj.design_iir(*args).to_ba()),
                              np.asarray(IIRt.design_iir(*args).to_ba()))
    for fn, v in [("lexp_coef", 0.01), ("lexp_tc_to_coef", 32.0),
                  ("lexp_coef_to_fc", 0.1), ("lexp_coef_to_tc", 0.05)]:
        assert getattr(IIRj, fn)(v) == getattr(IIRt, fn)(v)
    for fn in ("design_lexp", "design_dc_blocker"):
        for u, v in zip(getattr(IIRj, fn)(0.02), getattr(IIRt, fn)(0.02)):
            assert np.array_equal(u, v)
    z = IIRj.design_iir(6, "lp", "ellip", 0.15, 0.5, 60.0)
    (sj, kj), (st, kt) = (IIRj.zpk_to_sos(z),
                          IIRt.zpk_to_sos(IIRt.ZPK(z.z, z.p, z.k)))
    assert np.array_equal(sj, st) and kj == kt


@pytest.mark.parametrize("f,n", [(0.1234567, 1000), (-0.3, 5000),
                                 (0.0123457, 70001)])
def test_cycles_exact(f, n):
    np.testing.assert_array_equal(SGt.cycles(f, n, device=CPU).numpy(),
                                  np.asarray(SGj.cycles(f, n)))
    ft = torch.tensor(f)
    np.testing.assert_allclose(SGt.cycles(ft, 64).numpy(),
                               np.asarray(SGj.cycles(jnp.asarray(f), 64)),
                               rtol=0, atol=1e-6)


def test_delay_line_decimator_fir_decim():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(480).astype(np.float32)
    dj, dt = FRj.DelayLine(d=5), FRt.DelayLine(5, device=CPU)
    sj, yj = dj.step(dj.init(), jnp.asarray(x[:240]))
    st, yt = dt.step(dt.init(), torch.as_tensor(x[:240]))
    assert np.array_equal(yt.numpy(), np.asarray(yj))
    assert np.array_equal(dt.step(st, torch.as_tensor(x[240:]))[1].numpy(),
                          np.asarray(dj.step(sj, jnp.asarray(x[240:]))[1]))
    assert np.array_equal(
        FRt.Decimator(4).step(0, torch.as_tensor(x))[1].numpy(),
        np.asarray(FRj.Decimator(R=4).step(0, jnp.asarray(x))[1]))
    h = rng.standard_normal(21)
    for xin in (x, cplx(rng, 2, 480)):
        fj, ft = FRj.FirDecim.create(h, 4), FRt.FirDecim.create(h, 4,
                                                                device=CPU)
        assert ft.delay == fj.delay and ft.ratio == fj.ratio
        sj, st = fj.init_for(jnp.asarray(xin)), ft.init_for(
            torch.as_tensor(xin))
        for blk in (slice(0, 240), slice(240, 480)):
            sj, yj = fj.step(sj, jnp.asarray(xin[..., blk]))
            st, yt = ft.step(st, torch.as_tensor(xin[..., blk]))
            assert rel(yt, yj) < 1e-5
    wj, wt = _wf_pair("qpsk")
    md = wt.shaping.matched_filter_decim(0, 4, device=CPU)
    mj = wj.shaping.matched_filter_decim(0, 4)
    np.testing.assert_allclose(md.P.numpy(), np.asarray(mj.P), rtol=0,
                               atol=1e-7)


def test_fir_ups():
    rng = np.random.default_rng(2)
    h = rng.standard_normal(21)
    for xin in (rng.standard_normal(100).astype(np.float32),
                cplx(rng, 3, 100)):
        fj, ft = RSj.FirUps.create(h, 4), RSt.FirUps.create(h, 4,
                                                            device=CPU)
        assert ft.delay == fj.delay == RSt.fir_ups_delay(21, 4)
        sj, st = fj.init_for(jnp.asarray(xin)), ft.init_for(
            torch.as_tensor(xin))
        for blk in (slice(0, 50), slice(50, 100)):
            sj, yj = fj.step(sj, jnp.asarray(xin[..., blk]))
            st, yt = ft.step(st, torch.as_tensor(xin[..., blk]))
            assert yt.shape == yj.shape and rel(yt, yj) < 1e-5


@pytest.mark.parametrize("kind,kw", [("sinc", {}), ("cspline", {}),
                                     ("linear", {}),
                                     ("lagrange", {"degree": 3}),
                                     ("sinc", {"ncoefs": 8, "nphases": 64})])
def test_interpolators(kind, kw):
    ij = RSj.make_interpolator(kind, **kw)
    it = RSt.make_interpolator(kind, device=CPU, **kw)
    assert np.array_equal(it.lut.numpy(), np.asarray(ij.lut))
    assert it.K == ij.K and it.delay_ == ij.delay_
    tau = np.linspace(0, 1, 37).astype(np.float32)
    assert np.array_equal(it.taps(torch.as_tensor(tau)).numpy(),
                          np.asarray(ij.taps(jnp.asarray(tau))))
    if not kw:
        # the closed forms that kernels #5 and #6 evaluate
        ct = interp_taps(kind, torch.as_tensor(tau), 256, it.K).numpy()
        cj = np.asarray(_POLY_TAPS[kind](jnp.asarray(tau), 256))
        assert np.abs(ct - cj).max() < 1e-6
        assert np.abs(ct - it.taps(torch.as_tensor(tau)).numpy()).max() \
            < 1e-6


@pytest.mark.parametrize("delay", [3, -2, 1.7, 0.25])
def test_delay_signal(delay):
    rng = np.random.default_rng(3)
    for x in (rng.standard_normal(300).astype(np.float32),
              cplx(rng, 2, 300)):
        yt = FFt.delay_signal(torch.as_tensor(x), delay)
        yj = FFj.delay_signal(jnp.asarray(x), delay)
        assert yt.dtype.is_complex == np.iscomplexobj(np.asarray(yj))
        assert rel(yt, yj) < 1e-5


# ------------------------------------------------------ bits, waveforms


def test_bitstream_and_ber_counts():
    rng = np.random.default_rng(4)
    s = "0110100111"
    assert BSt.bits_to_string(BSt.bits_from_string(s, device=CPU)) == s
    assert np.array_equal(BSt.altbits(7, device=CPU).numpy(),
                          np.asarray(BSj.altbits(7)))
    b = rng.integers(0, 2, 37).astype(np.int8)
    assert np.array_equal(BSt.pad_bits(torch.as_tensor(b), 8).numpy(),
                          np.asarray(BSj.pad_bits(jnp.asarray(b), 8)))
    by = bytes(range(7))
    assert np.array_equal(BSt.bits_from_bytes(by, device=CPU).numpy(),
                          np.asarray(BSj.bits_from_bytes(by)))
    assert BSt.bits_to_bytes(torch.as_tensor(b)) == BSj.bits_to_bytes(b)
    r = b.copy()
    r[[3, 9]] ^= 1
    assert int(BSt.hamming_distance(torch.as_tensor(b),
                                    torch.as_tensor(r))) == 2
    g = torch.Generator().manual_seed(0)
    rb = BSt.randbits(g, 1000)
    assert rb.dtype == torch.int8 and 400 < int(rb.sum()) < 600
    tx = rng.integers(0, 2, 800).astype(np.int8)
    rx = np.concatenate([rng.integers(0, 2, 7), tx]).astype(np.int8)
    rx[100] ^= 1
    assert BERt.cmp_bits(tx, rx) == BERj.cmp_bits(tx, rx)
    assert BERt.ber_count(tx, rx) == BERj.ber_count(jnp.asarray(tx),
                                                   jnp.asarray(rx))
    for k in (2, 3):
        assert BERt.cmp_bits_psk(tx, rx, k) == BERj.cmp_bits_psk(
            tx, jnp.asarray(rx), k)


@pytest.mark.parametrize("name", WAVEFORMS)
def test_waveforms(name):
    wj, wt = _wf_pair(name)
    assert np.array_equal(wt.symbols.numpy(), np.asarray(wj.symbols))
    assert wt.info == WFt.WaveformInfo(**dataclasses.asdict(wj.info))
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, 60 * wj.info.k).astype(np.int8)
    assert np.array_equal(
        WFt.bits_to_symbol_indices(torch.as_tensor(bits), wj.info.k).numpy(),
        np.asarray(WFj.bits_to_symbol_indices(jnp.asarray(bits),
                                              wj.info.k)))
    # pi/4-QPSK's rotation is a complex product: 1e-6
    np.testing.assert_allclose(
        wt.make_symbols(torch.as_tensor(bits), parity=1).numpy(),
        np.asarray(wj.make_symbols(jnp.asarray(bits), parity=1)),
        rtol=0, atol=1e-6)
    yt, dt = wt.gen_samples(torch.as_tensor(bits), osf=4)
    yj, dj = wj.gen_samples(jnp.asarray(bits), osf=4)
    assert dt == dj and rel(yt, yj) < 1e-5
    if wj.info.is_linear:
        x = cplx(rng, 200) * 0.8
        assert np.array_equal(wt.closest(torch.as_tensor(x)).numpy(),
                              np.asarray(wj.closest(jnp.asarray(x))))
        assert np.array_equal(
            wt.decode_symbols(torch.as_tensor(x)).numpy(),
            np.asarray(wj.decode_symbols(jnp.asarray(x))))
    eb = np.array([0.0, 4.0, 8.0])
    np.testing.assert_allclose(wt.ber(eb).numpy(), np.asarray(wj.ber(eb)),
                               rtol=1e-5)
    np.testing.assert_allclose(wt.constellation().numpy(),
                               np.asarray(wj.constellation()), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name,fi,real", [("qam", 0.0, False),
                                          ("pi4-qpsk", 0.0, False),
                                          ("qpsk", 0.1234, True),
                                          ("gmsk", 0.05, False)])
def test_modulator_streaming(name, fi, real):
    wj, wt = _wf_pair(name)
    cfg = dict(fe=4.0, fsymb=1.0, fi=fi, real_output=real)
    mj = MODj.Modulator.create(MODj.ModConfig(wf=wj, **cfg))
    mt = MODt.Modulator.create(MODt.ModConfig(wf=wt, **cfg), device=CPU)
    assert mt.delay == mj.delay and mt.ratio == mj.ratio
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, 2 * 30 * wj.info.k).astype(np.int8)
    h = len(bits) // 2 + wj.info.k      # an odd number of symbols first
    sj, st = mj.init(), mt.init()
    for blk in (slice(0, h), slice(h, None)):
        sj, yj = mj.step(sj, jnp.asarray(bits[blk]))
        st, yt = mt.step(st, torch.as_tensor(bits[blk]))
        assert rel(yt, yj) < 1e-5
    assert int(st[3]) == int(sj[3])
    yt, _ = mt.modulate(torch.as_tensor(bits))
    yj, _ = mj.modulate(jnp.asarray(bits))
    assert yt.shape == yj.shape and rel(yt, yj) < 1e-5


def test_cmp_bits_rot_resolves_qam_rotation():
    wj, wt = _wf_pair("qam")
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 4 * 300).astype(np.int8)
    idx = WFt.bits_to_symbol_indices(torch.as_tensor(bits), 4)
    syms = (wt.symbols[idx.long()] * 1j).numpy()
    out = BERt.cmp_bits_rot(bits, syms, wt)
    assert out == BERj.cmp_bits_rot(jnp.asarray(bits), syms, wj)
    assert out[1] == 0 and out[2] == 0


# ------------------------------------------------- loops and recovery


def test_loop_filters_teds_peds():
    rng = np.random.default_rng(8)
    e = rng.standard_normal(50).astype(np.float32) * 0.1
    for lj, lt in [(CRj.LoopFilter2(0.02, 0.7), CRt.LoopFilter2(0.02, 0.7)),
                   (CRj.LoopFilter1(8.0), CRt.LoopFilter1(8.0))]:
        sj, st = lj.init(), lt.init(CPU)
        for v in e:
            sj, tj = lj.step(sj, jnp.float32(v))
            st, tt = lt.step(st, torch.tensor(v))
            assert abs(float(tt) - float(tj)) < 1e-6
    x0, x1, x2 = (cplx(rng, 40) for _ in range(3))
    a = [torch.as_tensor(v) for v in (x0, x1, x2)]
    b = [jnp.asarray(v) for v in (x0, x1, x2)]
    for fj, ft in [(CKj.ted_gardner, CKt.ted_gardner),
                   (CKj.ted_early_late, CKt.ted_early_late)]:
        assert rel(ft(*a), fj(*b)) < 1e-6
    assert rel(CKt.ted_mm(a[0], a[1], a[2], a[0]),
               CKj.ted_mm(b[0], b[1], b[2], b[0])) < 1e-6
    for name in ("qpsk", "bpsk", "qam", "ask"):
        wj, wt = _wf_pair(name)
        for kind in ("auto", "dec", "ploop", "tloop"):
            pj, pt = CRj.make_ped(kind, wj), CRt.make_ped(kind, wt)
            # the JAX PEDs take one symbol (the loops vmap them)
            np.testing.assert_allclose(pt(a[0]).numpy(),
                                       np.asarray(jax.vmap(pj)(b[0])),
                                       rtol=1e-4, atol=1e-5)
    for M in (2, 4):
        assert rel(CRt.ped_costas(M)(a[1]), CRj.ped_costas(M)(b[1])) < 1e-6


def _qpsk_samples(n, seed, fo=0.0):
    """JAX-modulated QPSK at osf 4 (numpy), with a carrier offset."""
    wj = WFj.wf_qpsk(WFj.PulseShape.rcs(0.25))
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, 2 * (n // 4 + 8)).astype(np.int8)
    m = MODj.Modulator.create(MODj.ModConfig(wf=wj, fe=4.0, fsymb=1.0))
    x = np.asarray(m.modulate(jnp.asarray(bits))[0])[:n]
    x = x * np.exp(2j * np.pi * (fo * np.arange(n) + 0.1))
    x = x + 0.03 * cplx(rng, n)
    return wj, bits, x.astype(np.complex64)


def test_cpll_rpll():
    wj, _, x = _qpsk_samples(1200, 9, fo=1e-3)
    wt = convert.waveform_from_jax(wj, device=CPU)
    s = x[::4][:200]
    cfg = dict(ped="ploop", BL=0.02)
    cj = CRj.Cpll(cfg=CRj.CpllConfig(**cfg), wf=wj)
    ct = CRt.Cpll(CRt.CpllConfig(**cfg), wf=wt)
    sj, yj = cj.step(cj.init(), jnp.asarray(s))
    st, yt = ct.step(ct.init(), torch.as_tensor(s))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-4
    assert abs(float(st[0]) - float(sj[0])) < 1e-4
    sj, yj = cj.step_grouped(cj.init(), jnp.asarray(s), 8)
    st, yt = ct.step_grouped(ct.init(), torch.as_tensor(s), 8)
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-4
    mask = np.arange(200) < 40
    sj, yj = cj.step_aided(cj.init(), jnp.asarray(s), jnp.asarray(s),
                           jnp.asarray(mask))
    st, yt = ct.step_aided(ct.init(), torch.as_tensor(s), torch.as_tensor(s),
                           torch.as_tensor(mask))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-4
    r = np.cos(2 * np.pi * 0.2 * np.arange(512) + 0.3).astype(np.float32)
    rj, rt = CRj.Rpll.create(0.2), CRt.Rpll.create(0.2, device=CPU)
    _, yj = rj.step(rj.init(), jnp.asarray(r))
    _, yt = rt.step(rt.init(), torch.as_tensor(r))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-4
    fj, snj = CRj.peak_frequency(jnp.asarray(x))
    ft, snt = CRt.peak_frequency(torch.as_tensor(x))
    assert abs(float(ft) - float(fj)) < 1e-6
    assert abs(float(snt) / float(snj) - 1) < 1e-4


@pytest.mark.parametrize("ted", ["gardner", "el", "mm"])
def test_clock_rec(ted):
    _, _, x = _qpsk_samples(800, 10)
    cfg = dict(osf=4, tc=5.0, ted=ted)
    kj = CKj.ClockRec.create(CKj.ClockRecConfig(**cfg))
    kt = CKt.ClockRec.create(CKt.ClockRecConfig(**cfg), device=CPU)
    sj, (yj, mj) = kj.step(kj.init(), jnp.asarray(x))
    st, (yt, mt) = kt.step(kt.init(), torch.as_tensor(x))
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    assert np.abs(yt.numpy() - np.asarray(yj)).max() < 1e-4
    assert abs(float(st["phase"]) - float(sj["phase"])) < 1e-4
    ys, ms = CKt.clock_rec(torch.as_tensor(x),
                           CKt.ClockRecConfig(**cfg))
    assert torch.equal(ms, mt) and torch.equal(ys, yt)


def test_decision_demod():
    wj, bits, x = _qpsk_samples(1000, 11, fo=2e-4)
    cfg = dict(osf=4, BL=0.01, tc=10.0)
    dj = DDj.DecisionDemod.create(wj, DDj.DecDemodConfig(**cfg))
    dt = DDt.DecisionDemod.create(convert.waveform_from_jax(wj, CPU),
                                  DDt.DecDemodConfig(**cfg), device=CPU)
    sj, oj = dj.step(dj.init(), jnp.asarray(x))
    st, ot = dt.step(dt.init(), torch.as_tensor(x))
    bt, yt, mt, bmt = (a.numpy() for a in ot)
    bj, yj, mj, bmj = (np.asarray(a) for a in oj)
    assert np.array_equal(mt, mj) and np.array_equal(bmt, bmj)
    assert np.abs(yt - yj)[mj].max() < 1e-3
    assert np.mean(bt != bj) < 1e-4
    assert set(st) == set(sj)


# ------------------------------------------------ the device rule


def test_entry_points_default_to_the_card(monkeypatch):
    """Entry points build on the card unless the caller names the CPU;
    without a card they raise instead of carrying on on the CPU."""
    from libtsd_tpu.models.demod_sb import DecisionDemodSB as DSBj
    from libtsd_tpu.models.demod_sb import SBDemodConfig as CFj
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig)
    from libtsd_tpu.models import receivers as RXj
    from libtsd_tpu.ops.pallas.iir import IirCascadePallas
    from libtsd_tpu_torch.models import demod as DMt
    from libtsd_tpu_torch.models import receivers as RXt
    from libtsd_tpu_torch.models.clock_rec2 import ClockRec2 as CR2t
    from libtsd_tpu_torch.models.demod_dec2 import DecisionDemod2 as DD2t
    from libtsd_tpu_torch.ops import psd
    from libtsd_tpu_torch.ops import rng as RNt
    from libtsd_tpu_torch.ops.kernels import fm as KF, iir as KI
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    wj = WFj.wf_qpsk()
    wt = convert.waveform_from_jax(wj, device=CPU)
    dj = DSBj.create(wj, CFj())
    calls = [
        lambda: FRt.Fir.create(np.ones(5)),
        lambda: convert.fir_from_jax(FRj.Fir.create(np.ones(5))),
        lambda: FFt.fft_freqs(8),
        lambda: psd.psd_freqs(8),
        lambda: FRt.FirDecim.create(np.ones(8), 4),
        lambda: FRt.DelayLine(3),
        lambda: RSt.FirUps.create(np.ones(8), 4),
        lambda: RSt.make_interpolator("cspline"),
        lambda: SGt.cycles(0.1, 16),
        lambda: BSt.zerobits(8),
        lambda: WFt.wf_qam(16),
        lambda: WFt.make_waveform("qpsk"),
        lambda: wt.shaping.matched_filter(0, 4),
        lambda: MODt.Modulator.create(MODt.ModConfig(wf=wt, fe=4.0,
                                                     fsymb=1.0)),
        lambda: CRt.LoopFilter2().init(),
        lambda: CRt.Cpll(CRt.CpllConfig()),
        lambda: CRt.Rpll.create(0.2),
        lambda: CKt.ClockRec.create(CKt.ClockRecConfig()),
        lambda: DDt.DecisionDemod.create(wt, DDt.DecDemodConfig()),
        lambda: DecisionDemodSB.create(wt, SBDemodConfig()),
        lambda: convert.waveform_from_jax(wj),
        lambda: convert.demod_sb_from_jax(dj),
        lambda: convert.demod_state_from_jax(dj.init()),
        # the FM and IIR slice
        lambda: FRt.ExpSmoother.create(0.1),
        lambda: FRt.DcBlocker.create(0.01),
        lambda: FRt.Iir.create([1.0, 0.5], [1.0, -0.5]),
        lambda: FRt.IirFrame.create([1.0, 0.5], [1.0, -0.5]),
        lambda: FRt.Sos.create(np.array([[1.0, 0, 0, 1.0, -0.5, 0]])),
        lambda: FRt.sos_frame_chain(np.array([[1.0, 0, 0, 1.0, -0.5, 0]])),
        lambda: KI.IirCascade([([1.0, 0.5], [1.0, -0.5])]),
        lambda: KF.FmChain(0.25, 4, 63, 0.1, 0.05),
        lambda: RXt.FmReceiver.create(RXt.FmReceiverConfig()),
        lambda: RXt.Qam16Modem.create(),
        lambda: CR2t.create(CKt.ClockRecConfig()),
        lambda: DD2t.create(wt, DDt.DecDemodConfig()),
        lambda: DMt.Demodulator.create(DMt.DemodConfig(wf=wt, fe=4.0,
                                                       fsymb=1.0)),
        lambda: SGt.sigexp(0.1, 16),
        lambda: SGt.NCO.create(0.1),
        lambda: RNt.Rng(0).randn(3),
        lambda: convert.fm_receiver_from_jax(RXj.FmReceiver.create(
            RXj.FmReceiverConfig())),
        lambda: convert.iir_cascade_from_jax(IirCascadePallas(
            [([1.0, 0.5], [1.0, -0.5])])),
        lambda: convert.qam16_modem_from_jax(RXj.Qam16Modem.create()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert FRt.Fir.create(np.ones(5), device=CPU).G.device.type == "cpu"
