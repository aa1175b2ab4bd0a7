"""The frame receiver and its serving layer in the port against the JAX
package on the CPU, on the same numpy inputs: ``Transmitter``,
``Receiver`` (streaming over block edges, batched and 1-D, every
detector engine, the reference goldens of tests/test_golden_ref8.py),
``StreamReceiver`` (chunked pushes, checkpoint/restore, a JAX checkpoint),
``StreamRunner`` over kernel #9's engine, the converters of
``utils.convert``, checkpoints, monitors and ``io.streamio``; and the rule
that the new entry points build on the card unless asked for the CPU.

Tolerances and why:

* exact: detections' valid slots and positions, decoded bits, restored
  states and everything downstream of a checkpoint (the same float32
  operations on the same inputs in one process), the host converters of
  ``io.streamio``.
* EbN0 within 0.1 dB, gain and theta within 1e-3: the detector's
  correlation and the PLL run in float32 in another summation order
  (JAX's FFT against PyTorch's, or the port's fp32 kernels' plain
  versions against JAX's "xla" engine).
* The ``g8_rx1`` golden through the "cuda-fused" engine: the gates of
  tests/test_golden_ref8.py:221-248 (3 frames, bits equal, gain and theta
  within 0.015 of the reference binary's).
* 1e-5 of the peak: the transmitter's samples and ``StreamRunner`` over
  the "cuda" OLA engine against JAX's Pallas OLA kernel and against
  one-shot filtering (float32 FFTs in other orders).

The file's one Pallas-interpreter call is JAX's ``ola_filter`` at Nf = 256.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libtsd_tpu.io import streamio as SIOj
from libtsd_tpu.models import frame as FRMj
from libtsd_tpu.models import waveform as WFj
from libtsd_tpu.models.detector import DetectorConfig as DCj
from libtsd_tpu.models.modulator import ModConfig as MCj
from libtsd_tpu.ops.pallas import ola as OLj
from libtsd_tpu.utils import checkpoint as CKj
from libtsd_tpu_torch.block import tree_flatten
from libtsd_tpu_torch.io import streamio as SIOt
from libtsd_tpu_torch.io.runner import StreamRunner
from libtsd_tpu_torch.models import frame as FRMt
from libtsd_tpu_torch.models.detector import DetectorConfig as DCt
from libtsd_tpu_torch.models.modulator import ModConfig as MCt
from libtsd_tpu_torch.ops import filter_rt as FRt
from libtsd_tpu_torch.ops.kernels import ola as OLt
from libtsd_tpu_torch.utils import checkpoint as CKt
from libtsd_tpu_torch.utils import convert
from libtsd_tpu_torch.utils import monitor as MONt

CPU = "cpu"
GOLD = os.path.join(os.path.dirname(__file__), "golden")
C, NB = 2, 8192          # channels, nominal block length of the stream


def rel(a, b):
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    b = np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def lcg_bits(seed: int, n: int) -> np.ndarray:
    """The bit source of refbuild/golden_gen8.cc (as in
    tests/test_golden_ref8.py)."""
    s, out = seed, []
    for _ in range(n):
        s = (s * 1103515245 + 12345) & 0xFFFFFFFF
        out.append((s >> 16) & 1)
    return np.asarray(out, np.uint8)


def _formats(wfj, hdr, payload_bits, hdr_wfj=None):
    """The same FrameFormat in both packages (the port's waveforms
    converted from the JAX ones)."""
    fj = FRMj.FrameFormat(modulation=MCj(wf=wfj, fe=4.0, fsymb=1.0),
                          header_bits=hdr, payload_bits=payload_bits,
                          header_wf=hdr_wfj)
    ft = FRMt.FrameFormat(
        modulation=MCt(wf=convert.waveform_from_jax(wfj, CPU), fe=4.0,
                       fsymb=1.0),
        header_bits=hdr, payload_bits=payload_bits,
        header_wf=(convert.waveform_from_jax(hdr_wfj, CPU)
                   if hdr_wfj is not None else None))
    return fj, ft


@pytest.fixture(scope="module")
def setup():
    """QPSK RRC 0.25, osf 4, a 64-bit header, 256-bit payloads: three
    frames per channel made by JAX's Transmitter, one of them across the
    first block edge of the "torch" engine's blocks, gain and phase per
    channel, noise 0.02 per dimension."""
    rng = np.random.default_rng(0)
    hdr = tuple(int(b) for b in rng.integers(0, 2, 64))
    wfj = WFj.wf_qpsk(WFj.PulseShape.rcs(0.25))
    fj, ft = _formats(wfj, hdr, 256)
    pay = rng.integers(0, 2, (3, 256)).astype(np.int8)
    txj = FRMj.Transmitter.create(fj)
    frames = np.stack([np.asarray(txj.transmit(jnp.asarray(p)))
                       for p in pay])
    x = (0.02 * (rng.standard_normal((C, 2 * NB))
                 + 1j * rng.standard_normal((C, 2 * NB)))
         ).astype(np.complex64)
    L = frames.shape[1]
    for c in range(C):
        for j, pos in enumerate((300, 3000 + 100 * c, 7800)):
            x[c, pos:pos + L] += (0.9 + 0.2 * c) * np.exp(1j * (0.3 + c)) \
                * frames[j]
    cfg = dict(threshold=0.5, max_peaks=5)
    rxj = FRMj.Receiver.create(fj, DCj(**cfg), pll_stride=8)
    rxt = FRMt.Receiver.create(ft, DCt(**cfg), pll_stride=8, device=CPU)
    nb = (NB // rxt.det.Ne) * rxt.det.Ne
    # JAX, channel by channel (the JAX package vmaps the step instead)
    states, outs = [], []
    for c in range(C):
        st = rxj.init()
        sts, frs = [st], []
        for b in range(2):
            st, fr = rxj.step(st, jnp.asarray(x[c, b * nb:(b + 1) * nb]))
            sts.append(st)
            frs.append(jax.tree_util.tree_map(np.asarray, fr))
        states.append(sts)
        outs.append(frs)
    return dict(fj=fj, ft=ft, pay=pay, frames=frames, x=x, rxj=rxj,
                rxt=rxt, nb=nb, cfg=cfg, jstates=states, jframes=outs)


def _same_frames(ft, fj, ebn0=0.1):
    """Port frames (one channel's slots) against JAX's: valid slots,
    positions and bits equal; EbN0, gain and theta close."""
    v = ft.valid.numpy()
    assert np.array_equal(v, np.asarray(fj.valid))
    assert np.array_equal(ft.detection.position.numpy()[v],
                          np.asarray(fj.detection.position)[v])
    assert np.array_equal(ft.bits.numpy()[v], np.asarray(fj.bits)[v])
    assert np.abs(ft.EbN0_db.numpy()[v]
                  - np.asarray(fj.EbN0_db)[v]).max(initial=0) < ebn0
    for f in ("gain", "theta"):
        a = getattr(ft.detection, f).numpy()[v]
        assert np.abs(a - np.asarray(getattr(fj.detection, f))[v]
                      ).max(initial=0) < 1e-3
    return int(v.sum())


def _sel(fr, c):
    return dataclasses.replace(
        fr, bits=fr.bits[c], symbols=fr.symbols[c], EbN0_db=fr.EbN0_db[c],
        valid=fr.valid[c],
        detection=dataclasses.replace(fr.detection, **{
            f.name: getattr(fr.detection, f.name)[c]
            for f in dataclasses.fields(fr.detection)}))


def test_transmitter_matches_jax(setup):
    tx = FRMt.Transmitter.create(setup["ft"], device=CPU)
    y = tx.transmit(torch.as_tensor(setup["pay"]))
    assert y.shape == setup["frames"].shape
    assert rel(y, setup["frames"]) < 1e-5
    assert rel(tx.transmit(torch.as_tensor(setup["pay"][1])),
               setup["frames"][1]) < 1e-5


def test_receiver_streaming_matches_jax(setup):
    """Two blocks at C = 2 with the state carried (a frame deferred over
    the block edge), batched, against JAX channel by channel; then the
    batched run against 1-D runs of each channel."""
    rxt, x, nb = setup["rxt"], setup["x"], setup["nb"]
    st = rxt.init_for(torch.zeros(C, nb))
    found = 0
    batched = []
    for b in range(2):
        st, fr = rxt.step(st, torch.as_tensor(x[:, b * nb:(b + 1) * nb]))
        batched.append(fr)
        for c in range(C):
            found += _same_frames(_sel(fr, c), setup["jframes"][c][b])
    assert found == 3 * C
    assert int(batched[1].valid.sum()) == C     # the deferred frames
    for c in range(C):
        s1 = rxt.init()
        for b in range(2):
            s1, f1 = rxt.step(s1, torch.as_tensor(x[c, b * nb:(b + 1) * nb]))
            fb = _sel(batched[b], c)
            assert torch.equal(f1.valid, fb.valid)
            v = f1.valid
            assert torch.equal(f1.bits[v], fb.bits[v])
            assert torch.equal(f1.detection.position[v],
                               fb.detection.position[v])
            assert (f1.EbN0_db[v] - fb.EbN0_db[v]).abs().max(
            ).item() < 1e-3 if v.any() else True


@pytest.mark.parametrize("engine", ["cuda", "cuda-fused"])
def test_receiver_kernel_engines_receive_like_jax(setup, engine):
    """The kernel engines (plain versions on the CPU) in a one-shot
    receive over both channels find JAX's frames with its bits."""
    rxt = FRMt.Receiver.create(setup["ft"], DCt(engine=engine,
                                                **setup["cfg"]),
                               pll_stride=8, device=CPU)
    x = setup["x"]
    fr = rxt.receive(torch.as_tensor(x))
    for c in range(C):
        fj = setup["rxj"].receive(jnp.asarray(x[c]))
        _same_frames(_sel(fr, c), fj)
        assert int(np.asarray(fj.valid).sum()) == 3


def test_receiver_state_and_receiver_from_jax(setup):
    """receiver_from_jax + receiver_state_from_jax: the JAX receiver's
    state after block 0 (vmapped shape: channels stacked), stepped by the
    port on block 1, gives JAX's frames; every state leaf keeps its key
    and shape."""
    rxj, nb, x = setup["rxj"], setup["nb"], setup["x"]
    rxc = convert.receiver_from_jax(rxj, device=CPU)
    assert (rxc.frame_len, rxc.hist_len, rxc.pll_stride, rxc.det.Ne) == \
        (rxj.frame_len, rxj.hist_len, rxj.pll_stride, rxj.det.Ne)
    stj = jax.tree_util.tree_map(lambda *a: np.stack(a),
                                 *[s[1] for s in setup["jstates"]])
    st = convert.receiver_state_from_jax(stj, device=CPU)
    assert set(st) == {"det", "hist", "phi0", "pending"}
    assert set(st["det"]) == {"corr", "en", "tail_c", "tail_e", "seg_prev"}
    assert set(st["det"]["seg_prev"]) == {"m", "pe", "ok_left", "ref5"}
    assert st["hist"].shape == (C, rxj.hist_len)
    st2, fr = rxc.step(st, torch.as_tensor(x[:, nb:2 * nb]))
    for c in range(C):
        _same_frames(_sel(fr, c), setup["jframes"][c][1])
    # the state after the step matches JAX's, leaf by leaf
    want = jax.tree_util.tree_leaves(setup["jstates"][0][2])
    leaves = tree_flatten(st2)[0]
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert tuple(a.shape[1:]) == tuple(np.shape(b))


@pytest.mark.parametrize("tag", ["rxh", "rxp", "rxf"])
def test_golden_receivers_match_jax(tag):
    """The reference binary's receiver signals (tests/golden/g8_*) of the
    receiver's other branches: a BPSK header on QAM-16 (data-aided PLL),
    pi/4-QPSK (rotating constellation) and 2-FSK (the discriminator),
    one-shot, the port's "torch" engine against JAX's "xla"."""
    hdr = tuple(int(b) for b in lcg_bits(0xACE1, 64))
    ps = WFj.PulseShape.rcs(0.25)
    wf, hw, thr = {
        "rxh": (WFj.wf_qam(16, ps), WFj.wf_bpsk(ps), 0.6),
        "rxp": (WFj.wf_pi4_qpsk(ps), None, 0.6),
        "rxf": (WFj.wf_fsk(2, index=1.0, shaping=WFj.PulseShape.nrz()),
                None, 0.7)}[tag]
    fj, ft = _formats(wf, hdr, 512, hw)
    x = np.load(os.path.join(GOLD, f"g8_{tag}_x.npy"))
    frj = FRMj.Receiver.create(fj, DCj(threshold=thr)).receive(
        jnp.asarray(x))
    frt = FRMt.Receiver.create(ft, DCt(threshold=thr), device=CPU).receive(
        torch.as_tensor(x))
    assert _same_frames(frt, frj) >= 2


def test_golden_rx1_through_the_fused_engine():
    """g8_rx1 through "cuda-fused" (#10's plain version on the CPU) with
    the stride-8 PLL: the gates of tests/test_golden_ref8.py:221-248."""
    hdr = tuple(int(b) for b in lcg_bits(0xACE1, 64))
    _, ft = _formats(WFj.wf_qpsk(WFj.PulseShape.rcs(0.25)), hdr, 512)
    rx = FRMt.Receiver.create(ft, DCt(threshold=0.6, engine="cuda-fused"),
                              pll_stride=8, device=CPU)
    fr = rx.receive(torch.as_tensor(np.load(os.path.join(GOLD,
                                                         "g8_rx1_x.npy"))))
    idx = np.nonzero(fr.valid.numpy())[0]
    assert len(idx) == 3
    meta = np.load(os.path.join(GOLD, "g8_rx1_meta.npy")).reshape(-1, 8)
    for j, i in enumerate(idx):
        assert np.array_equal(fr.bits[i].numpy(),
                              lcg_bits([1001, 1002, 1003][j], 512))
        assert abs(fr.detection.gain[i].item() - meta[j, 2]) < 0.015
        assert abs(fr.detection.theta[i].item() - meta[j, 3]) < 0.015


def _frames_key(frames):
    return [(int(f.detection.position), f.bits.tobytes(),
             float(f.EbN0_db)) for f in frames]


def test_stream_receiver_chunks_checkpoint_and_jax_checkpoint(setup,
                                                             tmp_path):
    """StreamReceiver ("cuda-fused", plain on the CPU) fed 1,001-sample
    chunks equals one push; a checkpoint halfway restored into a fresh
    StreamReceiver continues bit-identically; a checkpoint written by the
    JAX package (save_stream_state of its receiver state) restores into
    the port's StreamReceiver of the same receiver and continues with
    JAX's frames."""
    x = setup["x"][0]
    rx = FRMt.Receiver.create(setup["ft"], DCt(engine="cuda-fused",
                                               **setup["cfg"]),
                              pll_stride=8, device=CPU)
    one = FRMt.StreamReceiver(rx, block_len=4096)
    one.push(x)
    one.flush()
    assert one.nframes == 3 == len(one.frames)
    assert [f.bits.tolist() for f in one.frames] == setup["pay"].tolist()
    got = []
    a = FRMt.StreamReceiver(rx, block_len=4096, callback=got.append)
    for off in range(0, 7007, 1001):
        a.push(x[off:off + 1001])
    ck = str(tmp_path / "srx.npz")
    a.checkpoint(ck)
    b = FRMt.StreamReceiver(rx, block_len=4096, callback=got.append)
    b.restore(ck)
    assert b.nframes == a.nframes
    for off in range(7007, len(x), 1001):
        b.push(x[off:off + 1001])
    b.flush()
    assert _frames_key(got) == _frames_key(one.frames)
    # a JAX checkpoint of channel 0 after block 0 ("torch" = JAX "xla")
    rxj, nb = setup["rxj"], setup["nb"]
    ckj = str(tmp_path / "jax.npz")
    CKj.save_stream_state(ckj, setup["jstates"][0][1],
                          x[nb:nb + 100].astype(np.complex64), {"nframes": 2})
    c = FRMt.StreamReceiver(setup["rxt"], block_len=nb)
    c.restore(ckj)
    assert c.nframes == 2
    c.push(x[nb + 100:2 * nb])
    fj = setup["jframes"][0][1]
    vj = np.asarray(fj.valid)
    assert [int(f.detection.position) for f in c.frames] == \
        np.asarray(fj.detection.position)[vj].tolist()
    assert [f.bits.tolist() for f in c.frames] == \
        np.asarray(fj.bits)[vj].tolist()


def test_stream_runner_over_the_cuda_ola_engine(tmp_path):
    """StreamRunner over OlaFft(engine="cuda") (#9's plain version on the
    CPU): chunked pushes equal one-shot filtering and JAX's Pallas OLA
    kernel (interpret mode); a checkpoint restored into a fresh runner
    continues bit-identically."""
    rng = np.random.default_rng(9)
    h = rng.standard_normal(100) + 1j * rng.standard_normal(100)
    blk = FRt.OlaFft.create(h, Ne=128, engine="cuda", device=CPU)
    assert (blk.Nf, blk.Ne) == (256, 128)
    x = (rng.standard_normal(12 * 128)
         + 1j * rng.standard_normal(12 * 128)).astype(np.complex64)
    r = StreamRunner(blk, block_len=4 * 128)
    for off in range(0, len(x), 333):
        r.push(x[off:off + 333])
    y = r.run([], flush=False)
    assert y.shape == x.shape
    one = OLt.ola_filter(torch.as_tensor(x), h, Nf=256).numpy()
    assert rel(y, one) < 1e-5
    yj = np.asarray(OLj.ola_filter(jnp.asarray(x), h, Nf=256,
                                   interpret=True))
    assert rel(y, yj) < 1e-5
    a = StreamRunner(blk, block_len=4 * 128)
    ya = a.run([x[:700]])
    ck = str(tmp_path / "run.npz")
    a.checkpoint(ck)
    b = StreamRunner(blk, block_len=4 * 128)
    b.restore(ck)
    yb = b.run([x[700:]])
    assert np.array_equal(np.concatenate([ya, yb]), y)
    assert a.monitor.stats.count == 1 and a.monitor.stats.samples == 512


def test_checkpoint_layout_and_mismatch(setup, tmp_path):
    """The .npz keys and leaf order are the JAX package's (dict keys
    sorted, Detection fields in order); a state of another structure is
    refused; bytes round-trip."""
    rxt = setup["rxt"]
    st = rxt.init()
    pj = str(tmp_path / "j.npz")
    CKj.save_state(pj, setup["rxj"].init())
    back = CKt.load_state(pj, st)
    assert tree_flatten(back)[0][0].shape == st["det"]["corr"].shape
    pt = str(tmp_path / "t.npz")
    CKt.save_state(pt, st)
    kj, kt = np.load(pj), np.load(pt)
    assert sorted(k for k in kj.files if k.startswith("leaf_")) == \
        sorted(k for k in kt.files if k.startswith("leaf_"))
    jback = CKj.load_state(pt, setup["rxj"].init())
    assert all(np.array_equal(np.asarray(a), b.numpy()) for a, b in zip(
        jax.tree_util.tree_leaves(jback), tree_flatten(st)[0]))
    other = dict(st, extra=torch.zeros(3))
    with pytest.raises(ValueError, match="structure"):
        CKt.load_state(pt, other)
    bad = dict(st, hist=torch.zeros(5, dtype=torch.complex64))
    with pytest.raises(ValueError, match="shape"):
        CKt.state_from_bytes(CKt.state_bytes(st), bad)
    r = CKt.state_from_bytes(CKt.state_bytes(st), st)
    assert all(torch.equal(a, b) for a, b in zip(tree_flatten(r)[0],
                                                 tree_flatten(st)[0]))


def test_monitored_receiver_debug_and_profiler(setup, tmp_path):
    """MonitoredReceiver gives Receiver's frames and counts its stages;
    step_debug's captures belong to the first valid slot; the profiler
    scope writes a trace."""
    rxt, x = setup["rxt"], setup["x"]
    mr = FRMt.MonitoredReceiver(rxt)
    a = mr.receive(torch.as_tensor(x[0]))
    b = rxt.receive(torch.as_tensor(x[0]))
    assert torch.equal(a.bits, b.bits) and torch.equal(a.valid, b.valid)
    stats = mr.moniteurs()
    assert stats["recepteur/ola"].count == stats["recepteur/demod"].count == 1
    assert "recepteur/misc" in mr.monitors.report()
    nb = setup["nb"]
    _, fr, dbg = rxt.step_debug(rxt.init(), torch.as_tensor(x[0, :nb]))
    _, frj, dbgj = setup["rxj"].step_debug(setup["rxj"].init(),
                                           jnp.asarray(x[0, :nb]))
    assert bool(dbg["has_detection"]) and bool(dbgj["has_detection"])
    assert set(dbg) == set(dbgj)
    assert rel(dbg["syms_c"], np.asarray(dbgj["syms_c"])) < 1e-3
    assert rel(dbg["corr_score"], np.asarray(dbgj["corr_score"])) < 5e-4
    with MONt.profiler_trace(str(tmp_path / "prof")):
        MONt.block_until_ready(rxt.receive(torch.as_tensor(x[0, :nb])))
    assert os.path.exists(tmp_path / "prof" / "trace.json")


def test_streamio_matches_jax():
    """The host converters and re-blocker are the JAX package's, the
    native library built into the port's build directory."""
    rng = np.random.default_rng(4)
    raw16 = rng.integers(-2000, 2000, 64, dtype=np.int16)
    raw8 = rng.integers(0, 255, 64, dtype=np.uint8)
    assert np.array_equal(SIOt.cs16_to_cf32(raw16), SIOj.cs16_to_cf32(raw16))
    assert np.array_equal(SIOt.cu8_to_cf32(raw8), SIOj.cu8_to_cf32(raw8))
    z = (rng.standard_normal(50) + 1j * rng.standard_normal(50)).astype(
        np.complex64)
    assert np.array_equal(SIOt.deinterleave(z), SIOj.deinterleave(z))
    blocks = []
    rb = SIOt.Rebuffer(16, blocks.append, complex_iq=True)
    rb.push(z[:7])
    rb.push(z[7:])
    assert len(blocks) == 3 and np.array_equal(np.concatenate(blocks),
                                               z[:48])
    assert SIOt.native_available() == SIOj.native_available()


def test_frame_entry_points_default_to_the_card(setup, monkeypatch):
    """The frame slice's entry points build on the card unless the caller
    names the CPU; without a card they raise instead of carrying on."""
    from libtsd_tpu_torch.models.detector import Detector
    from libtsd_tpu_torch.ops.kernels.detfront import DetFront
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pat = np.ones(64, np.complex64)
    calls = [
        lambda: Detector.create(pat),
        lambda: Detector.create(pat, DCt(engine="cuda-fused")),
        lambda: FRt.OlaFft.create(np.ones(8)),
        lambda: FRt.FirFft.create(np.ones(8), engine="cuda"),
        lambda: FRt.MovingAverage(8),
        lambda: DetFront.create(pat),
        lambda: FRMt.Transmitter.create(setup["ft"]),
        lambda: FRMt.Receiver.create(setup["ft"]),
        lambda: convert.detector_from_jax(setup["rxj"].det),
        lambda: convert.receiver_from_jax(setup["rxj"]),
        lambda: convert.receiver_state_from_jax(setup["rxj"].init()),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert FRt.MovingAverage(8, device=CPU).init().device.type == "cpu"
