"""The port's DecisionDemodSB against the JAX package on the CPU, on the
same numpy inputs: the 1-D path, the batched engine (kernel #5's plain
version) and the fused engine (kernel #6's plain version), with the gates
of tests/test_demod_sb.py.

Inputs: the JAX modulator's signal as numpy, fractional delays by the JAX
delay_signal, numpy noise; both sides get the same arrays.

Tolerances and why:

* port vs JAX ``engine="xla"`` (1-D, batched, QPSK and QAM-16): equal
  valid masks, max |dsymbol| < 1e-3, bit mismatch share < 1e-4 -- the
  gate that test_demod_sb.py:174-178 and :201-202 set between the JAX
  Pallas kernel and its XLA scan.  Both are the same float32 loop; they
  differ in summation order, atan2, and the LUT versus closed-form taps
  of the 1-D path (measured ~3e-5).
* the port's batched path against its 1-D path: max 1e-4, mean 1e-5
  (test_demod_sb.py:59, the same loop math).
* two halves against one shot: at most one sub-block deferred, max
  |d| < 0.06, mean < 5e-3 (test_demod_sb.py:83-87: float32 pointer
  re-basing through the feedback loop).
* the fused engine against JAX ``"pallas-fused-interpret"``, the one
  interpreter call (C = 128 at 8 delays; 18 sub-blocks, i.e. nine
  superframes of 2, the smallest superframe the fused kernel takes, which
  keeps the interpreter cheap while most delays lock): median
  |dsymbol| < 0.02 over the second half (test_demod_sb.py:229), and zero
  bit errors there on every delay that JAX decodes without one (the
  steady state; at least half of the eight).  The JAX kernel's matched filter runs on
  bf16-rounded x and taps (an MXU choice), the port's in float32, so the
  symbols differ by ~1e-3 and are not held to 1e-3.  288 symbols are too
  few for every delay to lock, so decoding with zero errors after warm-up
  is checked on the port's own longer run (``test_slice_*``), as
  test_demod_sb.py:42-45 and :219-224 check it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.models import waveform as WFj
from libtsd_tpu.models.demod_sb import (DecisionDemodSB as DDj,
                                        SBDemodConfig as CFj)
from libtsd_tpu.models.modulator import ModConfig as MCj, Modulator as Mj
from libtsd_tpu.ops.fft import delay_signal as delay_j
from libtsd_tpu_torch.models import ber as BERt
from libtsd_tpu_torch.models import waveform as WFt
from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB, SBDemodConfig,
                                              pack_state)
from libtsd_tpu_torch.models.modulator import ModConfig, Modulator
from libtsd_tpu_torch.ops.kernels import _build, demod_sb as KSB
from libtsd_tpu_torch.utils.convert import (demod_sb_from_jax,
                                            demod_state_from_jax)


def _signal(M, nsym, seed, fo=2e-4, ebn0=15.0, delay=1.7):
    """numpy: (wf_j, bits, x) -- JAX-modulated QPSK (M=4) or QAM-16, RRC
    0.25 at osf 4, delayed, frequency offset fo, AWGN at Eb/N0, cut to a
    multiple of 64 samples."""
    rng = np.random.default_rng(seed)
    sh = WFj.PulseShape.rcs(0.25)
    wf = WFj.wf_qam(16, sh) if M == 16 else WFj.wf_qpsk(sh)
    k = wf.info.k
    bits = rng.integers(0, 2, k * nsym).astype(np.int8)
    mod = Mj.create(MCj(wf=wf, fe=4.0, fsymb=1.0))
    x = np.asarray(delay_j(mod.modulate(jnp.asarray(bits))[0], delay))
    x = x * np.exp(2j * np.pi * fo * np.arange(len(x)))
    sigma = np.sqrt(np.mean(np.abs(x) ** 2) * 0.5 * (4 / k)
                    / 10 ** (ebn0 / 10))
    x = x + sigma * (rng.standard_normal(len(x))
                     + 1j * rng.standard_normal(len(x)))
    n = (len(x) // 64) * 64
    return wf, bits, x[:n].astype(np.complex64)


def _delayed(x, delays):
    return np.stack([np.asarray(delay_j(jnp.asarray(x), d))
                     for d in delays]).astype(np.complex64)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _gates(out_t, out_j):
    """Port vs JAX: equal masks, max |dsym| < 1e-3, bit mismatch < 1e-4."""
    bt, st, mt = (_np(a) for a in out_t[:3])
    bj, sj, mj = (_np(a) for a in out_j[:3])
    assert np.array_equal(mt, mj)
    assert mt.mean() > 0.9
    assert np.abs(st - sj)[mj].max() < 1e-3
    assert np.mean(bt != bj) < 1e-4


@pytest.fixture(scope="module")
def qpsk():
    return _signal(4, 1500, 40)


CUT = 4800


@pytest.fixture(scope="module")
def xla_batched(qpsk):
    """The JAX XLA scan on two channels (x and x delayed 0.9) over the
    first CUT samples, and the same demodulator converted to the port."""
    wf, bits, x = qpsk
    xb = _delayed(x, [0.0, 0.9])
    dj = DDj.create(wf, CFj(osf=4, S=16, engine="xla"))
    sj, oj = dj.step(dj.init_for(jnp.asarray(xb[:, :CUT])),
                     jnp.asarray(xb[:, :CUT]))
    return xb, demod_sb_from_jax(dj, device="cpu"), sj, oj


def test_1d_path_matches_jax(qpsk):
    wf, bits, x = qpsk
    dj = DDj.create(wf, CFj(osf=4, S=16, engine="xla"))
    dt = demod_sb_from_jax(dj, device="cpu")
    _, oj = dj.step(dj.init(), jnp.asarray(x))
    st, ot = dt.step(dt.init(), torch.as_tensor(x))
    _gates(ot, oj)
    assert st["tail"].shape == (dt.T,) and st["ptr"].shape == ()


def test_batched_matches_jax_and_1d(qpsk, xla_batched):
    """Kernel #5's plain version (engine "auto" on CPU tensors) against the
    JAX XLA scan, and against the port's own 1-D path."""
    xb, dt, _, oj = xla_batched
    assert dt.cfg.engine == "auto"
    xt = torch.as_tensor(xb[:, :CUT])
    _, ot = dt.step(dt.init_for(xt), xt)
    _gates(ot, oj)
    _, o1 = dt.step(dt.init(), xt[0])
    both = o1[2].numpy() & ot[2][0].numpy()
    d = np.abs(o1[1].numpy()[both] - ot[1][0].numpy()[both])
    assert d.max() < 1e-4 and d.mean() < 1e-5


def test_qam16_slice_same_bits_as_jax():
    """The slice as a whole: demod_sb_from_jax -> step on a QAM-16 batch
    -> the same bits as the JAX demodulator (engine "xla")."""
    wf, bits, x = _signal(16, 800, 50, fo=0.0, ebn0=18.0, delay=1.3)
    xb = _delayed(x, [0.0, 0.4, 0.8])
    dj = DDj.create(wf, CFj(osf=4, S=16, engine="pallas"))
    dt = demod_sb_from_jax(dj, device="cpu")
    assert dt.cfg.engine == "cuda"
    dj = DDj.create(wf, CFj(osf=4, S=16, engine="xla"))
    _, oj = dj.step(dj.init_for(jnp.asarray(xb)), jnp.asarray(xb))
    _, ot = dt.step(dt.init_for(torch.as_tensor(xb)), torch.as_tensor(xb))
    _gates(ot, oj)
    assert ot[0].dtype == torch.int8 and ot[0].shape == oj[0].shape
    assert np.array_equal(ot[3].numpy(), np.asarray(oj[3]))


def test_streaming_halves_and_state_conversion(xla_batched):
    """Two half blocks against one shot on the port (carried MF tail,
    pointer re-basing, loop state); JAX's state after the block converts
    key for key and shape for shape, holds the port's state, and the port
    continues from it as from its own."""
    xb, dt, sj, _ = xla_batched
    xt = torch.as_tensor(xb[:, :CUT])
    st1, (_, s1, m1, _) = dt.step(dt.init_for(xt), xt)
    half = CUT // 2
    st = dt.init_for(xt)
    st, (_, sa, ma, _) = dt.step(st, xt[:, :half])
    _, (_, sb, mb, _) = dt.step(st, xt[:, half:])
    for c in range(2):
        one = s1[c][m1[c]].numpy()
        two = np.concatenate([sa[c][ma[c]].numpy(), sb[c][mb[c]].numpy()])
        ncmp = min(len(one), len(two))
        assert ncmp >= len(one) - 16
        d = np.abs(one[:ncmp] - two[:ncmp])
        assert d.max() < 0.06 and d.mean() < 5e-3
    conv = demod_state_from_jax(sj, device="cpu")
    assert set(conv) == set(st1) == {"mf", "lf", "theta", "gain", "ptr",
                                     "yprev_ri", "tail"}
    for k in conv:
        a = conv[k] if k != "lf" else torch.stack(conv[k])
        b = st1[k] if k != "lf" else torch.stack(st1[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        assert (a - b).abs().max() < 1e-3, k
    nxt = torch.as_tensor(xb[:, CUT:])
    _, (_, sc, mc, _) = dt.step(conv, nxt)
    _, (_, so, mo, _) = dt.step(st1, nxt)
    assert torch.equal(mc, mo)
    assert (sc - so).abs()[mo].max() < 1e-3


@pytest.fixture(scope="module")
def fused_runs():
    """The one interpreter call: JAX engine "pallas-fused-interpret" at
    C = 128 (8 delays), n = 1152 (18 sub-blocks = 9 superframes of 2), and
    the port's "cuda-fused" engine (the plain version on CPU tensors) on
    the same input, each from its own fresh state."""
    wf, bits, x = _signal(4, 400, 41)
    xb = np.tile(_delayed(x[:1152], np.linspace(0.0, 0.9, 8)), (16, 1))
    dj = DDj.create(wf, CFj(osf=4, S=16, engine="pallas-fused-interpret"))
    dt = demod_sb_from_jax(dj, device="cpu")
    sj, oj = dj.step(dj.init_for(jnp.asarray(xb)), jnp.asarray(xb))
    st, ot = dt.step(dt.init_for(torch.as_tensor(xb)), torch.as_tensor(xb))
    return dt, bits, (sj, oj), (st, ot)


def test_fused_matches_jax_interpret(fused_runs):
    dt, bits, (sj, oj), (st, ot) = fused_runs
    assert dt.cfg.engine == "cuda-fused"
    mj, mt = np.asarray(oj[2]), ot[2].numpy()
    assert np.array_equal(mj, mt)
    late = mj.copy()
    late[:, :late.shape[1] // 2] = False          # the second half
    d = np.abs(np.asarray(oj[1]) - ot[1].numpy())[late]
    assert np.median(d) < 0.02
    # steady state: on every delay that JAX decodes without a bit error
    # over the second half, the port does too
    steady = 0
    for c in range(8):
        rx = {}
        for side, (b, bm) in {"jax": (np.asarray(oj[0][c]),
                                      np.asarray(oj[3][c])),
                              "port": (ot[0][c].numpy(),
                                       ot[3][c].numpy())}.items():
            rb = b[bm]
            w = len(rb) // 2
            rx[side] = BERt.cmp_bits_psk(bits[w:], rb[w:], 2, max_lag=64)[1]
        if rx["jax"] == 0:
            steady += 1
            assert rx["port"] == 0, c
    assert steady >= 4
    # the fused state converts key for key, shape for shape
    conv = demod_state_from_jax(sj, device="cpu")
    assert set(conv) == set(st) == {"lf", "theta", "gain", "ptr",
                                    "yprev_ri", "p_ema", "xtail"}
    for k in ("theta", "gain", "ptr", "yprev_ri", "p_ema", "xtail"):
        assert conv[k].shape == st[k].shape, k
    assert torch.equal(conv["xtail"], st["xtail"])
    rel = (conv["p_ema"] - st["p_ema"]).abs() / st["p_ema"]
    assert rel.max() < 1e-2       # bf16 against fp32 matched filter


@pytest.mark.parametrize("engine", ["cuda", "cuda-fused"])
def test_slice_port_modulator_to_decoded_bits(engine):
    """The port end to end on the CPU: its modulator makes QAM-16 at 4
    fractional delays, both engines decode with zero bit errors after 600
    warm-up symbols (cmp_bits_rot resolves the blind loop's 90-degree
    ambiguity), over two consecutive blocks with the state carried."""
    wf = WFt.wf_qam(16, WFt.PulseShape.rcs(0.25), device="cpu")
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                           device="cpu")
    bits = torch.as_tensor(np.random.default_rng(3).integers(
        0, 2, 4 * 1600).astype(np.int8))
    x, _ = mod.modulate(bits)
    x = torch.as_tensor(_delayed(x.numpy(), [0.3, 0.5, 0.7, 0.9])[:, :6144])
    x = x + 0.02 * torch.complex(*torch.as_tensor(
        np.random.default_rng(4).standard_normal((2,) + x.shape),
        dtype=torch.float32))
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  engine=engine),
                                device="cpu")
    st = dd.init_for(x)
    syms, mask = [], []
    for xb in (x[:, :3072], x[:, 3072:]):
        st, (_, s, m, _) = dd.step(st, xb)
        syms.append(s)
        mask.append(m)
    syms, mask = torch.cat(syms, 1), torch.cat(mask, 1)
    for c in range(4):
        _, errs, _ = BERt.cmp_bits_rot(bits[4 * 600:],
                                       syms[c][mask[c]][600:], wf,
                                       max_lag=64)
        assert errs == 0, (engine, c)


def test_engines_and_block_rules():
    """The JAX engine names raise naming the port's; the fused engine's
    block rules raise with the JAX messages; 1-D input is refused by the
    fused engine; odd osf is refused."""
    wf = WFt.wf_qpsk(WFt.PulseShape.rcs(0.25), device="cpu")
    for eng in ("xla", "pallas", "pallas-fused", "pallas-interpret"):
        with pytest.raises(ValueError, match="cuda-fused"):
            DecisionDemodSB.create(wf, SBDemodConfig(engine=eng),
                                   device="cpu")
    with pytest.raises(ValueError, match="even osf"):
        DecisionDemodSB.create(wf, SBDemodConfig(osf=3), device="cpu")
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  engine="cuda-fused"),
                                device="cpu")
    x = torch.zeros(3, 1000, dtype=torch.complex64)
    with pytest.raises(ValueError, match="whole 64-sample"):
        dd.step(dd.init_for(x), x)
    x = torch.zeros(3, 192, dtype=torch.complex64)
    with pytest.raises(ValueError, match="at least 256"):
        dd.step(dd.init_for(x), x)
    with pytest.raises(ValueError, match="batched-only"):
        dd.step(dd.init(), torch.zeros(256, dtype=torch.complex64))


def test_any_channel_count_and_leading_axes(qpsk):
    """C need not be a multiple of 128; a (B, C, n) input is flattened,
    run and unflattened; mf_precision reaches the matched filter."""
    wf, bits, x = qpsk
    xs = torch.as_tensor(_delayed(x[:2048], [0.0, 0.3, 0.6]))
    dd = demod_sb_from_jax(DDj.create(wf, CFj(osf=4, S=16)), device="cpu")
    _, o3 = dd.step(dd.init_for(xs), xs)
    x4 = xs[[0, 1, 2, 0, 1, 2]].reshape(2, 3, -1)
    st, o4 = dd.step(dd.init_for(x4), x4)
    assert o4[1].shape == (2, 3, 512) and st["tail"].shape == (2, 3, dd.T)
    # the same loop; the matched filter's matmul may block the two batch
    # shapes differently (last-bit differences, the JAX gate of
    # test_demod_sb.py:174-178)
    for b in range(2):
        assert torch.equal(o4[2][b], o3[2])
        assert (o4[1][b] - o3[1]).abs()[o3[2]].max() < 1e-3
    sp = DecisionDemodSB.create(dd.wf, SBDemodConfig(mf_precision="split"),
                                device="cpu")
    assert sp.mf.precision == "split"


def test_frames_bf16_rounds_the_loop_input(qpsk):
    """frames_bf16 rounds the matched filter's output to bf16 before the
    loop (both routes); after acquisition the symbols move by about the
    rounding (during it a rounded sample can change a decision)."""
    wf, bits, x = qpsk
    xs = torch.as_tensor(_delayed(x, [0.0, 0.5]))
    dd = DecisionDemodSB.create(
        WFt.wf_qpsk(WFt.PulseShape.rcs(0.25), device="cpu"),
        SBDemodConfig(osf=4, S=16), device="cpu")
    db = DecisionDemodSB.create(dd.wf, SBDemodConfig(osf=4, S=16,
                                                     frames_bf16=True),
                                device="cpu")
    _, o = dd.step(dd.init_for(xs), xs)
    _, ob = db.step(db.init_for(xs), xs)
    assert torch.equal(o[2], ob[2])
    late = o[2].clone()
    late[:, :late.shape[1] // 2] = False       # after acquisition
    d = (o[1] - ob[1]).abs()[late]
    assert 0 < d.max() < 0.05 and d.mean() < 5e-3


def test_pointer_outside_margins_recovers(qpsk):
    """A pointer far past the forward margin re-anchors to the nominal
    grid and the loops re-acquire (test_demod_sb.py:108-127)."""
    wf, bits, x = qpsk
    xb = torch.as_tensor(x[None, :6144])
    dd = demod_sb_from_jax(DDj.create(wf, CFj(osf=4, S=16)), device="cpu")
    st = dd.init_for(xb)
    st = dict(st, ptr=st["ptr"] + 40.0)
    _, (_, syms, mask, _) = dd.step(st, xb)
    assert mask[0].any()
    tail = syms[0][mask[0]][-400:]
    d2 = ((tail[:, None] - dd.wf.symbols).abs() ** 2).min(1).values
    evm = torch.sqrt(d2.mean() / (dd.wf.symbols.abs() ** 2).mean())
    assert evm < 0.25


def test_demod_wrappers_have_no_fallback(monkeypatch):
    """Kernels #5 and #6: a tensor neither on the CPU nor on CUDA gets no
    path; a wrapper routed to its kernel raises where it cannot launch it
    instead of running its plain version."""
    dd = DecisionDemodSB.create(
        WFt.wf_qpsk(WFt.PulseShape.rcs(0.25), device="cpu"),
        SBDemodConfig(osf=4, S=16), device="cpu")
    ddf = DecisionDemodSB.create(dd.wf, SBDemodConfig(osf=4, S=16,
                                                      engine="cuda-fused"),
                                 device="cpu")
    x = torch.zeros(2, 512, dtype=torch.complex64)
    st, stf = dd.init_for(x), ddf.init_for(x)
    _, zp = dd.matched_zp(st, x)
    p = dd.loop_params(512)
    calls = [lambda z: KSB.demod_sb(z, pack_state(st), dd.wf.symbols, p),
             lambda z: KSB.demod_sb_fused(
                 z[:, :512], stf["xtail"], pack_state(stf), dd.wf.symbols,
                 dd.h_mf, p, dd.rms_ref)]
    for call in calls:
        with pytest.raises(ValueError, match="device"):
            call(torch.empty(zp.shape, dtype=zp.dtype, device="meta"))
    monkeypatch.setattr(_build, "use_plain", lambda t: False)
    for call in calls:
        with pytest.raises(ValueError, match="expected CUDA"):
            call(zp)
