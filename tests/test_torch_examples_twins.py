"""The port's twins of the examples (``libtsd_tpu_torch/examples``) held
piece by piece against the JAX demos' own functions (``examples/*.py``,
loaded by path and left as they are), on the CPU, on the same numpy
inputs.

Tolerances and why:

* doa_demo: angles within 0.01 degree (one grid step of Nf = 2048 is
  0.09), eigenvalues within 1e-4 of the largest (float32 covariance and
  eigensolver on both sides), MDL counts equal.
* fm_demo: the band within 1e-5 of its peak (float32 cumulative phase
  summed in other orders), the audio within 1e-4 of its peak on the same
  band (tests/test_torch_fm.py's bound for the composed receiver), the
  correlations within 1e-3.
* iq_stream_demo: the mixer within 1e-5 over three blocks with the phase
  carried (float32 phase ramps), the chain through FirDecim within 1e-4.
* serving_loop, protocols_demo, ber_sweep, qam_serving: decisions, so the
  frame positions and bits, the decoded messages, the error counts and
  the bit count are equal; the tail EVM within 1e-5.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.io import IqFileReader as IqFileReaderJ
from libtsd_tpu.io import StreamRunner as StreamRunnerJ
from libtsd_tpu.io import cs16_to_cf32 as cs16_to_cf32J
from libtsd_tpu.models import ber as BERj
from libtsd_tpu.models import demod as DMj
from libtsd_tpu.models import waveform as WFj
from libtsd_tpu.models.bitstream import randbits as randbitsJ
from libtsd_tpu.models.demod_sb import DecisionDemodSB as DDSBj
from libtsd_tpu.models.demod_sb import SBDemodConfig as SBCj
from libtsd_tpu.models.detector import DetectorConfig as DCj
from libtsd_tpu.models.frame import FrameFormat as FFj
from libtsd_tpu.models.frame import Receiver as RXj
from libtsd_tpu.models.modulator import ModConfig as MCj
from libtsd_tpu.models.modulator import Modulator as MODj
from libtsd_tpu.models.receivers import FmReceiver as FMRj
from libtsd_tpu.models.receivers import FmReceiverConfig as FMCj
from libtsd_tpu.models.stats import mdl_source_count as mdl_j
from libtsd_tpu.ops.fft import delay_signal as delay_j
from libtsd_tpu.ops.filter_rt import FirDecim as FirDecimJ
from libtsd_tpu.ops.fir_design import fir_lowpass as fir_lowpass_j
from libtsd_tpu.block import chain as chain_j
from libtsd_tpu_torch.examples import ber_sweep as tbs
from libtsd_tpu_torch.examples import doa_demo as tdoa
from libtsd_tpu_torch.examples import fm_demo as tfm
from libtsd_tpu_torch.examples import iq_stream_demo as tiq
from libtsd_tpu_torch.examples import protocols_demo as tpd
from libtsd_tpu_torch.examples import qam_serving as tqam
from libtsd_tpu_torch.examples import serving_loop as tsl
from libtsd_tpu_torch.io import cs16_to_cf32
from libtsd_tpu_torch.models import waveform as WFt
from libtsd_tpu_torch.models.demod_sb import DecisionDemodSB as DDSBt
from libtsd_tpu_torch.models.demod_sb import SBDemodConfig as SBCt
from libtsd_tpu_torch.models.detector import DetectorConfig as DCt
from libtsd_tpu_torch.models.frame import Receiver as RXt
from torch_compare import rel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _demo(name: str):
    """A JAX demo of examples/, loaded by path as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_demo_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- doa_demo

@pytest.mark.parametrize("coherent", [False, True],
                         ids=["incoherent", "coherent"])
def test_doa_estimate(coherent):
    jd = _demo("doa_demo")
    X = jd.snapshots(coherent)
    assert np.array_equal(tdoa.snapshots(coherent), X)
    mr, ms, cp, evr, evs, Rs = jd.estimate(jnp.asarray(X))
    tr, ts, tc, tevr, tevs, R_t, Rs_t = tdoa.estimate(torch.as_tensor(X))
    for a, b in ((tr, mr), (ts, ms), (tc, cp)):
        assert np.abs(np.rad2deg(a.numpy())
                      - np.rad2deg(np.asarray(b))).max() < 0.01
    assert rel(tevr, np.asarray(evr)) < 1e-4
    assert rel(tevs, np.asarray(evs)) < 1e-4
    T = X.shape[1]
    want = (mdl_j(X @ X.conj().T / T, T)[0], mdl_j(np.asarray(Rs), T)[0])
    got = (tdoa.mdl_source_count(R_t, T)[0],
           tdoa.mdl_source_count(Rs_t, T)[0])
    assert got == want == ((1, 2) if coherent else (2, 2))


# ----------------------------------------------------------------- fm_demo

def test_fm_band_audio_and_corr():
    n = 1 << 13
    jf = _demo("fm_demo")
    jf.N = n
    band_j, audios_j = jf.synth_band(0)
    band_t, audios_t = tfm.synth_band(n, CPU)
    assert rel(band_t, band_j) < 1e-5
    assert all(np.array_equal(a, b) for a, b in zip(audios_t, audios_j))

    rxs_j = [FMRj.create(FMCj(channel_freq=fc, decim=jf.DECIM,
                              deviation=jf.DEVIATION, deemph_fc=0.02))
             for fc, _ in jf.STATIONS]

    @jax.jit
    def receive_all(rxs, x):
        return jnp.stack([rx.step(rx.init_for(x), x)[1] for rx in rxs])

    audio_j = np.asarray(receive_all(rxs_j, jnp.asarray(band_j)))
    rxs_t = tfm.receivers(CPU)
    audio_t = tfm.receive_all(rxs_t, torch.as_tensor(band_j)).numpy()
    assert audio_t.shape == audio_j.shape and rel(audio_t, audio_j) < 1e-4

    # fm_demo.py:103-117's correlation, on the JAX receivers' audio
    from scipy.signal import lfilter
    b, a = jf.design_lexp(0.02)
    corr_j = []
    for rx, aud, true in zip(rxs_j, audio_j, audios_j):
        d = int(rx.chan_filt.delay)
        seg = aud[50:-50]
        ref_f = lfilter(np.asarray(b, float), np.asarray(a, float),
                        true.astype(float))
        ref = ref_f[50 - d: 50 - d + len(seg)]
        m = min(len(seg), len(ref))
        corr_j.append(float(np.corrcoef(seg[:m], ref[:m])[0, 1]))
    corr_t = [c for c, _, _ in tfm.correlations(rxs_t, audio_t, audios_t)]
    assert np.abs(np.subtract(corr_t, corr_j)).max() < 1e-3


# ----------------------------------------------------------- iq_stream_demo

def _iq_blocks(k: int = 3) -> np.ndarray:
    raw = tiq.capture()[:k * tiq.BLOCK]
    return cs16_to_cf32(raw.reshape(-1)).reshape(k, tiq.BLOCK)


def test_iq_mixer_carries_phase():
    jq = _demo("iq_stream_demo")
    mj, mt = jq.Mixer(f0=jq.F_WANTED), tiq.Mixer(tiq.F_WANTED)
    blocks = _iq_blocks()
    sj = mj.init()
    st = mt.init_for(torch.as_tensor(blocks[0]))
    for xb in blocks:
        sj, yj = mj.step(sj, jnp.asarray(xb))
        st, yt = mt.step(st, torch.as_tensor(xb))
        assert rel(yt, np.asarray(yj)) < 1e-5
    assert abs(float(st) - float(sj)) < 1e-5


def test_iq_chain_through_firdecim():
    jq = _demo("iq_stream_demo")
    h = fir_lowpass_j(127, 0.4 / jq.DECIM)
    cj = chain_j(jq.Mixer(f0=jq.F_WANTED), FirDecimJ.create(h, jq.DECIM))
    ct = tiq.make_chain(CPU)
    blocks = _iq_blocks()
    sj = cj.init_for(jnp.asarray(blocks[0]))
    st = ct.init_for(torch.as_tensor(blocks[0]))
    yj, yt = [], []
    for xb in blocks:
        sj, y = cj.step(sj, jnp.asarray(xb))
        yj.append(np.asarray(y))
        st, y = ct.step(st, torch.as_tensor(xb))
        yt.append(y.numpy())
    assert rel(np.concatenate(yt), np.concatenate(yj)) < 1e-4


# ------------------------------------------------------------ serving_loop

def test_serving_loop_on_the_jax_capture(tmp_path, monkeypatch):
    js = _demo("serving_loop")
    js.NFRAMES = 3
    monkeypatch.setattr(tsl, "NFRAMES", 3)
    hdr = np.asarray(randbitsJ(jax.random.PRNGKey(42), 64))
    fmt_j = FFj(modulation=MCj(wf=WFj.wf_qpsk(WFj.PulseShape.rcs(0.25)),
                               fe=4.0, fsymb=1.0),
                header_bits=tuple(int(b) for b in hdr),
                payload_bits=js.PAYLOAD)
    path = str(tmp_path / "capture.cs16")
    payloads, _ = js.synthesize_capture(fmt_j, path)

    # serving_loop.py:112-124, the JAX serving loop
    rx_j = RXj.create(fmt_j, DCj(threshold=0.5))
    ne = rx_j.det.Ne
    bl = ((max(4096, rx_j.frame_len + 2 * rx_j.itp.K) + ne - 1) // ne) * ne
    got = []
    runner = StreamRunnerJ(rx_j, block_len=bl, sink=got.append, depth=2)
    with IqFileReaderJ(path, "cs16", block_iq=1 << 14) as rd:
        runner.run(cs16_to_cf32J(b) for b in rd)
    runner.push(np.zeros(bl * 2, np.complex64))
    runner.drain()
    ref_j = js.valid_frames(got)

    rx_t = RXt.create(tsl.make_format(hdr, CPU), DCt(threshold=0.5),
                      device=CPU)
    assert tsl.block_len(rx_t) == bl
    ref_t, at_t, _ = tsl.serve(rx_t, path, bl)
    assert len(ref_t) == len(ref_j) == len(at_t) == 3
    for ft, fj in zip(ref_t, ref_j):
        assert int(ft.detection.position) == int(fj.detection.position)
        assert np.array_equal(ft.bits, fj.bits)
    assert tsl.tally(payloads, ref_t) == (3, 0, 0)
    x = cs16_to_cf32(np.fromfile(path, np.int16).reshape(-1, 2))
    res, cut = tsl.resume(rx_t, x, bl, str(tmp_path / "ck.npz"))
    assert cut % bl and tsl.identical(ref_t, res)


@pytest.mark.parametrize("engine", ["cuda", "cuda-fused"])
def test_serving_loop_engine_against_torch_at_its_ne(engine):
    """The twin's main on a kernel engine (its plain route here) and on
    "torch" at the same granularity Ne: the same block length, the same
    detections (stream samples, payload bits) and scores within 1e-5."""
    r = tsl.main(engine, CPU)
    ref = tsl.main("torch", CPU, r["ne"])
    assert ref["block_len"] == r["block_len"] and r["ne"] != 0
    a, b = ref["detections"], r["detections"]
    assert [p for p, _, _ in a] == [p for p, _, _ in b] and len(a) >= 12
    assert all(np.array_equal(x, y) for (_, _, x), (_, _, y) in zip(a, b))
    assert max(abs(x - y) for (_, x, _), (_, y, _) in zip(a, b)) < 1e-5


# ---------------------------------------------------------- protocols_demo

def test_protocols_adsb_and_pocsag(capsys):
    jp = _demo("protocols_demo")
    jp.adsb_demo()
    jp.pocsag_demo()
    want = capsys.readouterr().out.splitlines()
    frames, fix = tpd.adsb_demo(CPU)
    msgs, baud = tpd.pocsag_demo(CPU)
    capsys.readouterr()
    assert [f.position for f in frames] == sorted(tpd.ADSB_FRAMES)
    lines = [f"  @{f.position:6d} score {f.score:.2f}  {f.text}"
             for f in frames]
    lines.append(f"  CPR global fix: lat {fix[0]:.5f}  lon {fix[1]:.5f}")
    lines.append(f"  detected baud: {baud}")
    lines += [f"  RIC {m.ric}  fn {m.function}  text: {m.text!r}"
              for m in msgs]
    assert [w for w in want if not w.startswith("==")] == lines
    assert [(m.ric, m.function, m.text) for m in msgs] == [tpd.POCSAG_PAGE]


# --------------------------------------------------------------- ber_sweep

BER_POINTS = {"BPSK": 6.0, "QPSK": 4.0, "pi4-QPSK": 8.0, "8PSK": 8.0,
              "QAM16": 8.0, "4FSK": 10.0}
_WF_J = {
    "BPSK": lambda: WFj.wf_bpsk(WFj.PulseShape.rcs(0.25)),
    "QPSK": lambda: WFj.wf_qpsk(WFj.PulseShape.rcs(0.25)),
    "pi4-QPSK": lambda: WFj.wf_pi4_qpsk(WFj.PulseShape.rcs(0.25)),
    "8PSK": lambda: WFj.wf_psk(8, WFj.PulseShape.rcs(0.25)),
    "QAM16": lambda: WFj.wf_qam(16, WFj.PulseShape.rcs(0.25)),
    "4FSK": lambda: WFj.wf_fsk(4, 1.0, WFj.PulseShape.gaussian(2.0)),
}


@pytest.mark.parametrize("name", list(BER_POINTS))
def test_ber_point_error_count(name):
    """ber_sweep.py:37-63 on given bits and noise: the same error count
    (the JAX chain jitted, as a caller runs it; eager it takes ~4x as
    long)."""
    nbits, EbN0, osf = 2048, BER_POINTS[name], tbs.OSF
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, nbits).astype(np.int8)
    wj = _WF_J[name]()
    wt = dict(tbs.waveforms(CPU))[name]
    mod = MODj.create(MCj(wf=wj, fe=float(osf), fsymb=1.0,
                          ncoefs=tbs.NCOEFS))
    xj = jax.jit(mod.modulate)(jnp.asarray(bits))[0]
    xt = tbs.transmit(wt, torch.as_tensor(bits))
    assert xt.shape == xj.shape and rel(xt, np.asarray(xj)) < 1e-4
    w = rng.standard_normal((2, xt.shape[-1])).astype(np.float32)
    scale = np.sqrt(0.5 * (osf / wt.info.k) / 10.0 ** (EbN0 / 10.0))

    # channel.awgn's scaling: the rms of the signal times the scale
    yj = xj + (jnp.sqrt(jnp.mean(jnp.abs(xj) ** 2)) * scale
               * (w[0] + 1j * w[1])).astype(jnp.complex64)
    yt = xt + (torch.sqrt(torch.mean(xt.abs() ** 2)) * scale
               * torch.complex(torch.as_tensor(w[0]),
                               torch.as_tensor(w[1])))
    dm = DMj.Demodulator.create(DMj.DemodConfig(
        wf=wj, fe=float(osf), fsymb=1.0, ncoefs_mf=tbs.NCOEFS))
    rx_bits, _, _, bmask = jax.jit(dm.demodulate)(yj)
    rx = np.asarray(rx_bits)[np.asarray(bmask)]
    skip = nbits // 4
    if wj.info.is_psk or wj.info.is_qam:
        _, ej, _ = BERj.cmp_bits_psk(bits[skip:], jnp.asarray(rx[skip:]),
                                     wj.info.k, max_lag=64)
    else:
        _, ej, _ = BERj.cmp_bits(bits[skip:], jnp.asarray(rx[skip:]),
                                 max_lag=64)
    _, et = tbs.count(wt, torch.as_tensor(bits), yt)
    assert et == int(ej)


# ------------------------------------------------------------- qam_serving

def test_qam_tail_evm_and_bit_count():
    C, osf, nsym = 8, tqam.OSF, tqam.NSYM
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 4 * nsym).astype(np.int8)
    wj = WFj.wf_qam(16, WFj.PulseShape.rcs(0.25))
    x, _ = MODj.create(MCj(wf=wj, fe=float(osf), fsymb=1.0)).modulate(
        jnp.asarray(bits))
    n = (x.shape[0] // 64) * 64
    xs = np.stack([np.asarray(delay_j(x[:n], 0.3 + 0.001 * c))
                   for c in range(C)])
    w = rng.standard_normal((2, C, n)).astype(np.float32) * tqam.NOISE
    xs = (xs + (w[0] + 1j * w[1])).astype(np.complex64)

    dj = DDSBj.create(wj, SBCj(osf=osf, S=16, engine="auto"))
    st = jax.jit(dj.init_for)(jnp.asarray(xs))
    _, (_, syms_j, mask_j, _) = jax.jit(dj.step)(st, jnp.asarray(xs))
    # qam_serving.py:66-72 and :77-88, the JAX demo's readout
    sym = dj.wf.symbols
    t = syms_j[:, syms_j.shape[1] // 2:]
    d2 = jnp.min(jnp.abs(t[..., None] - sym) ** 2, axis=-1)
    ev_j = np.asarray(jnp.sqrt(jnp.mean(d2, axis=-1)
                               / jnp.mean(jnp.abs(sym) ** 2)))
    nerr_j = 0
    for c in range(0, C, max(C // 4, 1)):
        sy = np.asarray(syms_j[c])[np.asarray(mask_j[c])]
        nerr_j += int(BERj.cmp_bits_rot(bits[4 * 600:], jnp.asarray(sy[600:]),
                                        wj, max_lag=64)[1])

    wt = WFt.wf_qam(16, WFt.PulseShape.rcs(0.25), device=CPU)
    dt = DDSBt.create(wt, SBCt(osf=osf, S=16, engine=tqam.engine_for(CPU)),
                      device=CPU)
    xt = torch.as_tensor(xs)
    _, (_, syms_t, mask_t, _) = dt.step(dt.init_for(xt), xt)
    ev_t = tqam.tail_evm(wt, syms_t).numpy()
    assert np.abs(ev_t - ev_j).max() < 1e-5 and ev_j.max() < tqam.TOL_EVM
    assert tqam.bit_errors(wt, torch.as_tensor(bits), syms_t,
                           mask_t) == nerr_j
