"""Production serving loop on the port: SDR capture -> frames, with a
mid-stream checkpoint/resume and per-stage monitors.  The twin of
``examples/serving_loop.py``.

    IqFileReader  ->  cs16_to_cf32  ->  StreamRunner(frame Receiver)
        ->  sink (decoded payloads)

* the capture: NFRAMES QPSK frames (payloads drawn from a
  ``torch.Generator`` on the device, transmitted by the port's
  ``Transmitter``) at irregular offsets with gain 1.6, carrier phase 0.8
  rad and light AWGN (numpy), written as interleaved cs16;
* the serving loop: the file through the runner (pinned staging, up to 2
  blocks in flight) into a frame ``Receiver`` on the device; every
  payload must come back with no bit error.  Detections that match no
  payload are printed as false alarms: at threshold 0.5 the 64-bit header
  can correlate that well with a stretch of random payload, and which of
  them a block keeps depends on the block length (``max_peaks`` a
  block);
* checkpoint/resume: a second runner is cut at a sample offset that is not
  block-aligned, its whole state saved to .npz and restored into a fresh
  runner; the continuation must be bit-identical to the uninterrupted run;
* ``StreamReceiver(monitor=True).moniteurs()``: the detection front end
  and the extraction timed as separate stages (parity:
  RécepteurImpl::moniteurs(), recepteur.cc:83-110).

The detector engine is the caller's: ``"torch"`` (default), ``"cuda"``
(kernel #9, overlap-save correlation) or ``"cuda-fused"`` (kernel #10);
``main`` also takes its block granularity ``ne`` (0: the engine's own),
which sets the serving block length.

    python -m libtsd_tpu_torch.examples.serving_loop [--device cpu]
        [--engine torch|cuda|cuda-fused]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..block import tree_flatten, tree_map
from ..config import device as _device
from ..io import IqFileReader, StreamRunner, cs16_to_cf32
from ..models import ber as BER
from ..models import waveform as WF
from ..models.bitstream import randbits
from ..models.detector import DetectorConfig
from ..models.frame import (FrameFormat, Receiver, StreamReceiver,
                            Transmitter)
from ..models.modulator import ModConfig

NFRAMES = 12
PAYLOAD = 256


def make_format(hdr_bits, device) -> FrameFormat:
    """QPSK (RRC 0.25, osf 4) frames: the given 64-bit header, PAYLOAD
    payload bits."""
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25), device=device)
    return FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                       header_bits=tuple(int(b) for b in hdr_bits),
                       payload_bits=PAYLOAD)


def synthesize_capture(fmt: FrameFormat, path: str, gen: torch.Generator):
    """NFRAMES frames at irregular offsets, 1.6x gain, 0.8 rad carrier
    phase, light AWGN, written as an interleaved cs16 capture.  Returns
    (payloads as numpy, number of IQ samples)."""
    tx = Transmitter.create(fmt, device=gen.device)
    ps = torch.stack([randbits(gen, PAYLOAD) for _ in range(NFRAMES)])
    frames = tx.transmit(ps).cpu().numpy()
    payloads = list(ps.cpu().numpy())
    rng = np.random.default_rng(11)
    flen = frames.shape[-1]
    gaps = rng.integers(900, 2600, NFRAMES)
    n = int(np.sum(gaps) + NFRAMES * flen + 4000)
    x = np.zeros(n, np.complex64)
    pos = 0
    for g, fr in zip(gaps, frames):
        pos += int(g)
        x[pos:pos + flen] += (1.6 * np.exp(1j * 0.8) * fr
                              ).astype(np.complex64)
        pos += flen
    x += (0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    raw = np.empty((n, 2), np.int16)
    raw[:, 0] = np.clip(x.real * 8192, -32768, 32767)
    raw[:, 1] = np.clip(x.imag * 8192, -32768, 32767)
    raw.tofile(path)
    return payloads, n


def block_len(rx: Receiver) -> int:
    """A block holding a whole frame and the interpolator's margins,
    rounded up to the detector's granularity (a multiple of 128 on the
    fused engine)."""
    ne = rx.det.Ne
    return ((max(4096, rx.frame_len + 2 * rx.itp.K) + ne - 1) // ne) * ne


def valid_frames(blocks) -> list:
    """The valid slots of the sink's host FrameRx trees, one tree each."""
    out = []
    for fr in blocks:
        for i in np.nonzero(fr.valid)[0]:
            out.append(tree_map(lambda a, i=i: a[i], fr))
    return out


def starts(blocks, bl: int) -> list:
    """The valid slots' header detections in the stream: (sample, score),
    one per frame of :func:`valid_frames`, in its order."""
    return [(i * bl + int(fr.detection.position[j]),
             float(fr.detection.score[j]))
            for i, fr in enumerate(blocks) for j in np.nonzero(fr.valid)[0]]


def serve(rx: Receiver, path: str, bl: int):
    """The serving loop: file -> runner -> frames.  Returns (frames, their
    :func:`starts`, the runner's monitor stats)."""
    got = []
    runner = StreamRunner(rx, block_len=bl, sink=got.append, depth=2)
    with IqFileReader(path, "cs16", block_iq=1 << 14) as rd:
        runner.run(cs16_to_cf32(b) for b in rd)
    runner.push(np.zeros(bl * 2, np.complex64))  # trailing detections
    runner.drain()
    return valid_frames(got), starts(got, bl), runner.monitor.stats


def resume(rx: Receiver, x: np.ndarray, bl: int, ck: str) -> tuple:
    """Cut a runner at a sample that is not block-aligned, checkpoint it to
    ``ck``, restore into a fresh runner and finish the stream.  Returns
    (frames, the cut)."""
    tail = np.zeros(bl * 2, np.complex64)
    cut = len(x) // 2 + 321
    out_a = []
    r1 = StreamRunner(rx, block_len=bl, sink=out_a.append)
    r1.push(x[:cut])
    r1.checkpoint(ck)
    out_b = []
    r2 = StreamRunner(rx, block_len=bl, sink=out_b.append)
    r2.restore(ck)
    r2.push(x[cut:])
    r2.push(tail)
    r2.drain()
    return valid_frames(out_a) + valid_frames(out_b), cut


def tally(payloads: list, frames: list) -> tuple:
    """(payloads received, their bit errors, false alarms): each payload is
    held to the frame whose bits are closest to it (``cmp_bits``, lags up
    to 4), found when under a tenth of its bits differ; a frame that is no
    payload's closest is a false alarm."""
    if not frames:
        return 0, 0, 0
    errs = np.array([[BER.cmp_bits(p, f.bits, 4)[1] for f in frames]
                     for p in payloads])
    best, emin = errs.argmin(1), errs.min(1)
    hit = emin < PAYLOAD // 10
    return (int(hit.sum()), int(emin[hit].sum()),
            len(frames) - len(set(best[hit].tolist())))


def identical(a: list, b: list) -> bool:
    """Two frame lists equal leaf for leaf, bit for bit."""
    return len(a) == len(b) and all(
        np.array_equal(la, lb) for fa, fb in zip(a, b)
        for la, lb in zip(tree_flatten(fa)[0], tree_flatten(fb)[0]))


def main(engine: str = "torch", device="cuda", ne: int = 0) -> dict:
    """The capture, the serving loop, the resume and the monitors on
    ``device`` with the detector ``engine`` at granularity ``ne``.
    Returns the detections (stream sample, score, payload bits), the
    payloads received, their bit errors, the false alarms, the block
    length, the loop's Msamples/s and the monitors' stage times."""
    device = _device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    fmt = make_format(randbits(gen, 64).cpu().numpy(), device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "serving_capture.cs16")
        payloads, n = synthesize_capture(fmt, path, gen)
        print(f"capture: {n} IQ samples, {NFRAMES} frames; engine {engine}"
              f" on {device}")
        rx = Receiver.create(fmt, DetectorConfig(threshold=0.5,
                                                 engine=engine, Ne=ne),
                             device=device)
        bl = block_len(rx)

        # ---- 1. the serving loop: file -> runner -> frames -------------
        ref, at, st = serve(rx, path, bl)
        found, nerr, false = tally(payloads, ref)
        rate = st.samples / max(st.total_s, 1e-9) / 1e6
        print(f"serving loop: {len(ref)} frames detected (block {bl}), "
              f"{found}/{NFRAMES} payloads received, {nerr} bit errors, "
              f"{false} false alarms, {rate:.2f} Msamp/s (incl. host IO + "
              "conversion)")
        assert found == NFRAMES and nerr == 0, (found, nerr)

        # ---- 2. mid-stream checkpoint/resume, bit-identical ------------
        x = cs16_to_cf32(np.fromfile(path, np.int16).reshape(-1, 2))
        ck = os.path.join(tmp, "serving_ckpt.npz")
        res, cut = resume(rx, x, bl, ck)
        print(f"checkpointed at sample {cut} ({os.path.getsize(ck)} bytes)")
        assert identical(ref, res), (len(res), len(ref))
        print(f"resume: {len(res)} frames, bit-identical to the "
              "uninterrupted run")

    # ---- 3. per-stage monitors (recepteur.cc moniteurs parity) ---------
    srx = StreamReceiver(rx, monitor=True)
    srx.push(x)
    srx.flush()
    print(f"per-stage monitors ({srx.nframes} frames):")
    stages = {}
    for name, s in sorted(srx.moniteurs().items()):
        stages[name] = s.total_s
        print(f"  {name:<18} {s.count:>4} calls  {s.total_s:8.4f} s  "
              f"{s.samples_per_s / 1e6:8.2f} Msamp/s")
    return {"engine": engine, "ne": rx.det.Ne, "block_len": bl,
            "detections": [(p, s, f.bits) for (p, s), f in zip(at, ref)],
            "payloads": found, "bit_errors": nerr, "false_alarms": false,
            "msamples_per_s": rate, "stages_s": stages}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", default="torch",
                    choices=("torch", "cuda", "cuda-fused"))
    a = ap.parse_args()
    main(a.engine, a.device)
