"""The QAM-16 modem slice of the port against the JAX package on the CPU,
on the same numpy inputs: ClockRec2, DecisionDemod2, the non-decision
Demodulator with ``llr``, and Qam16Modem (``__graft_entry__.entry()``) in
both ``rx_mode``s and with both clocks; then the gates of
tests/test_receivers.py:89-119 on the port.  No Pallas call.

Tolerances and why:

* equal masks and bits, symbols to 1e-3 on valid slots: the gate
  tests/test_demod_sb.py:174-178 sets between two float32 versions of one
  decision-directed loop (the JAX package and the port sum the
  interpolator taps and the matched filter in other orders); for
  DecisionDemod2 under a carrier offset, 5e-3 at most (one step of the
  256-phase interpolator table that a last-bit difference can select) and
  a median under 1e-5.
* 1e-4 for the loop states and the composed receiver's symbols.
* 1e-5 of the peak for the transmitted samples and the LLRs (float32
  products on both sides).
* The receiver gates of tests/test_receivers.py: BER < 0.01 after 400
  symbols and tail EVM < 0.15 on 2,000 symbols delayed by 1.3 samples;
  0.03 < EVM < 0.15 and BER < max(10 x theory, 0.01) at Eb/N0 = 18 dB.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import clock_rec as CKj
from libtsd_tpu.models import demod as DMj
from libtsd_tpu.models import demod_dec as DDj
from libtsd_tpu.models import modulator as MODj
from libtsd_tpu.models import receivers as RXj
from libtsd_tpu.models import waveform as WFj
from libtsd_tpu.models.clock_rec2 import ClockRec2 as CR2j
from libtsd_tpu.models.demod_dec2 import DecisionDemod2 as DD2j
from libtsd_tpu_torch.models import ber as BERt
from libtsd_tpu_torch.models import clock_rec as CKt
from libtsd_tpu_torch.models import demod as DMt
from libtsd_tpu_torch.models import demod_dec as DDt
from libtsd_tpu_torch.models import receivers as RXt
from libtsd_tpu_torch.models.clock_rec2 import ClockRec2 as CR2t
from libtsd_tpu_torch.models.demod_dec2 import DecisionDemod2 as DD2t
from libtsd_tpu_torch.ops.fft import delay_signal
from libtsd_tpu_torch.utils import convert

CPU = "cpu"


def rel(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _samples(wj, nsym, seed, fo=0.0, noise=0.03, fi=0.0, fe=4.0):
    """JAX-modulated symbols at osf 4 (numpy), a carrier offset and
    noise."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, wj.info.k * (nsym + 8)).astype(np.int8)
    m = MODj.Modulator.create(MODj.ModConfig(wf=wj, fe=fe, fi=fi,
                                             fsymb=1.0))
    x = np.asarray(m.modulate(jnp.asarray(bits))[0])[:4 * nsym]
    n = len(x)
    x = x * np.exp(2j * np.pi * (fo * np.arange(n) + 0.1))
    x = x + noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return bits, x.astype(np.complex64)


def test_clock_rec2_one_shot_and_streamed():
    wj = WFj.wf_qam(16, WFj.PulseShape.rcs(0.25))
    _, x = _samples(wj, 300, 1)
    x = np.asarray(delay_signal(torch.as_tensor(x), 0.7))
    cfg = dict(osf=4, tc=10.0)
    kj = CR2j.create(CKj.ClockRecConfig(**cfg))
    kt = CR2t.create(CKt.ClockRecConfig(**cfg), device=CPU)
    sj, st = kj.init(), kt.init()
    for blk in (x[:500], x[500:]):
        sj, (yj, mj) = kj.step(sj, jnp.asarray(blk))
        st, (yt, mt) = kt.step(st, torch.as_tensor(blk))
        assert np.array_equal(mt.numpy(), np.asarray(mj))
        assert np.abs(yt.numpy() - np.asarray(yj))[np.asarray(mj)].max() < 1e-4
        assert abs(float(st["ptr"]) - float(sj["ptr"])) < 1e-4
        assert rel(st["tail"], sj["tail"]) < 1e-5


def test_decision_demod2():
    wj = WFj.wf_qam(16, WFj.PulseShape.rcs(0.25))
    _, x = _samples(wj, 400, 2, fo=2e-4)
    cfg = dict(osf=4, BL=0.01, tc=10.0, agc_tc=10.0)
    dj = DD2j.create(wj, DDj.DecDemodConfig(**cfg))
    dt = DD2t.create(convert.waveform_from_jax(wj, CPU),
                     DDt.DecDemodConfig(**cfg), device=CPU)
    sj, oj = dj.step(dj.init(clock_offset=0.25), jnp.asarray(x))
    st, ot = dt.step(dt.init(clock_offset=0.25), torch.as_tensor(x))
    bt, yt, mt, bmt = (a.numpy() for a in ot)
    bj, yj, mj, bmj = (np.asarray(a) for a in oj)
    assert np.array_equal(mt, mj) and np.array_equal(bmt, bmj)
    # a last-bit difference can pick the neighbouring phase of the
    # 256-phase interpolator table: one such step, 5e-3, at most
    d = np.abs(yt - yj)[mj]
    assert d.max() < 5e-3 and np.median(d) < 1e-5
    assert np.mean(bt != bj) < 1e-4
    assert set(st) == set(sj)
    # the carrier loop integrates those symbol differences: 1e-3 rad
    assert abs(float(st["theta"]) - float(sj["theta"])) < 1e-3


@pytest.mark.parametrize("wave,fi", [("qpsk", 0.0), ("qpsk", 0.5),
                                     ("pi4-qpsk", 0.0), ("fsk", 0.0)])
def test_demodulator_and_llr(wave, fi):
    """The non-decision chain, with the NCO transposition (fi), a rotating
    constellation and the FSK discriminator branch."""
    sh = WFj.PulseShape.rcs(0.25)
    wj = {"qpsk": lambda: WFj.wf_qpsk(sh),
          "pi4-qpsk": lambda: WFj.wf_pi4_qpsk(sh),
          "fsk": lambda: WFj.wf_fsk(2, 0.8)}[wave]()
    _, x = _samples(wj, 250, 3, noise=0.02, fi=fi, fe=4.0)
    wt = convert.waveform_from_jax(wj, CPU)
    cfg = dict(fe=4.0, fi=fi, fsymb=1.0)
    dj = DMj.Demodulator.create(DMj.DemodConfig(wf=wj, **cfg))
    dt = DMt.Demodulator.create(DMt.DemodConfig(wf=wt, **cfg), device=CPU)
    sj, oj, dbj = dj.step(dj.init(), jnp.asarray(x), debug=True)
    st, ot, dbt = dt.step(dt.init(), torch.as_tensor(x), debug=True)
    bj, yj, mj, bmj = (np.asarray(a) for a in oj)
    bt, yt, mt, bmt = (a.numpy() for a in ot)
    assert np.array_equal(mt, mj) and np.array_equal(bmt, bmj)
    assert np.abs(yt - yj)[mj].max() < 1e-4
    assert np.array_equal(bt[bmj], bj[bmj])
    assert set(dbt) == set(dbj) and set(st) == set(sj)
    assert int(st["par"]) == int(sj["par"])
    lj = np.asarray(DMj.llr(wj, jnp.asarray(yj[mj])))
    lt = DMt.llr(wt, torch.as_tensor(yj[mj]))
    assert lt.shape == lj.shape and rel(lt, lj) < 1e-5
    assert all(torch.equal(a, b) for a, b in zip(
        dt.demodulate(torch.as_tensor(x)), ot))


@pytest.mark.parametrize("rx_mode,clock", [("composed", "ptr"),
                                           ("fused", "ptr"),
                                           ("composed", "sample")])
def test_qam16_modem_vs_jax_entry(rx_mode, clock):
    """The entry() workload of __graft_entry__.py (512 symbols, osf 4,
    bits from numpy's default_rng(0)) through both modems; the port's also
    from the JAX modem's parameters."""
    mj = RXj.Qam16Modem.create(osf=4, clock=clock, rx_mode=rx_mode)
    mt = RXt.Qam16Modem.create(osf=4, clock=clock, rx_mode=rx_mode,
                               device=CPU)
    bits = np.random.default_rng(0).integers(0, 2, 4 * 512).astype(np.int32)
    xj = mj.transmit(jnp.asarray(bits))
    xt = mt.transmit(torch.as_tensor(bits))
    assert rel(xt, xj) < 1e-5
    oj = [np.asarray(a) for a in mj.receive(xj)]
    ot = [a.numpy() for a in mt.receive(torch.as_tensor(np.asarray(xj)))]
    assert np.array_equal(ot[2], oj[2])
    assert np.abs(ot[1] - oj[1])[oj[2]].max() < 1e-3
    assert np.mean(ot[0] != oj[0]) < 1e-4
    assert abs(float(ot[3]) - float(oj[3])) < 1e-4
    mc = convert.qam16_modem_from_jax(mj, device=CPU)
    assert mc.rx_mode == rx_mode and type(mc.cr) is type(mt.cr)
    oc = mc.receive(torch.as_tensor(np.asarray(xj)))
    assert all(torch.equal(a, b) for a, b in zip(oc, mt.receive(
        torch.as_tensor(np.asarray(xj)))))


@pytest.mark.parametrize("rx_mode", ["composed", "fused"])
def test_qam16_modem_clean_gate(rx_mode):
    """tests/test_receivers.py:89-102 on the port: 2,000 symbols delayed
    by 1.3 samples, BER < 0.01 after 400 symbols, tail EVM < 0.15."""
    modem = RXt.Qam16Modem.create(osf=4, rx_mode=rx_mode, device=CPU)
    bits = torch.as_tensor(np.random.default_rng(7).integers(0, 2, 4 * 2000))
    x = delay_signal(modem.transmit(bits), 1.3)
    rx_bits, syms, mask, ev = modem.receive(x)
    rb = rx_bits[mask.repeat_interleave(4)]
    ber, errs, _ = BERt.cmp_bits(bits[4 * 400:], rb[4 * 400:], max_lag=64)
    assert ber < 0.01, (ber, errs)
    assert float(ev) < 0.15


def test_qam16_modem_awgn_gate():
    """tests/test_receivers.py:105-119 on the port: Eb/N0 = 18 dB, the
    noise drawn with numpy at the JAX channel's sigma."""
    modem = RXt.Qam16Modem.create(osf=4, device=CPU)
    rng = np.random.default_rng(1)
    bits = torch.as_tensor(rng.integers(0, 2, 4 * 3000))
    x = modem.transmit(bits)
    EbN0 = 18.0
    sigma = (x.abs() ** 2).mean().sqrt().item() * np.sqrt(
        0.5 * (4 / 4) / 10 ** (EbN0 / 10))
    w = rng.standard_normal((2, x.shape[0])).astype(np.float32) * sigma
    y = x + torch.complex(torch.as_tensor(w[0]), torch.as_tensor(w[1]))
    rx_bits, syms, mask, ev = modem.receive(y)
    assert 0.03 < float(ev) < 0.15
    rb = rx_bits[mask.repeat_interleave(4)]
    ber, _, _ = BERt.cmp_bits(bits[4 * 500:], rb[4 * 500:], max_lag=64)
    th = float(modem.wf.ber(EbN0))
    assert ber < max(10 * th, 0.01), (ber, th)
