"""Per-stage debug observability on the port: run the receivers with debug
capture on and render each stage into an HTML report.  The twin of
``examples/debug_report_demo.py``.

Parity: the reference's debug_actif workflow — intermediate-signal figures
collected into a per-run index.html by the stdo sink (recepteur.cc:144-150,
demod-dec.cc:347-371, stdo.cc:38-130).  The captures run on the chosen
device (the card by default); ``viz`` brings each signal to the host to
draw it (matplotlib, the ``viz`` extra).

    python -m libtsd_tpu_torch.examples.debug_report_demo [--device cpu]
        [--out DIR]

Reports land in DIR/{frame_rx,demod,fm_stereo}/index.html (DIR defaults
to build/report/torch at the root of the checkout).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..block import pad_to_multiple
from ..config import complex_dtype
from ..models.detector import DetectorConfig
from ..models.frame import FrameFormat, Receiver, Transmitter
from ..models.modulator import ModConfig
from ..models.waveform import PulseShape, wf_qpsk
from ..ops.fft import delay_signal

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "report", "torch")


def frame_rx_report(device, out: str, payload_bits: int = 512) -> str:
    """``Receiver.step_debug`` on one QPSK frame with gain, phase and a
    fractional delay, plus noise."""
    from ..viz.debug import debug_report
    rng = np.random.RandomState(0)
    hdr = tuple(rng.randint(0, 2, 64).tolist())
    wf = wf_qpsk(PulseShape.rcs(0.25), device=device)
    fmt = FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                      header_bits=hdr, payload_bits=payload_bits)
    tx = Transmitter.create(fmt, device=device)
    pay = torch.as_tensor(rng.randint(0, 2, payload_bits).astype(np.int8),
                          device=device)
    frame = tx.transmit(pay)
    x = torch.zeros(6144, dtype=complex_dtype, device=device)
    x[900:900 + frame.shape[-1]] = 0.8 * np.exp(1j * 0.4) * frame
    x = delay_signal(x, 0.3)
    noise = 0.02 * (rng.standard_normal(x.shape[-1])
                    + 1j * rng.standard_normal(x.shape[-1]))
    x = x + torch.as_tensor(noise.astype(np.complex64), device=device)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5), device=device)
    extra = max(rx.frame_len, 2 * rx.det.M) + 2 * rx.itp.K
    xp = pad_to_multiple(F.pad(x, (0, extra)), rx.det.Ne, axis=0)
    _, frames, dbg = rx.step_debug(rx.init(), xp)
    path = debug_report("frame receiver (QPSK, gain/phase/frac-delay)",
                        dbg, os.path.join(out, "frame_rx"))
    nval = int(frames.valid.sum())
    print(f"frame_rx: {nval} frame(s) decoded -> {path}")
    return path


def demod_report(device, out: str, nbits: int = 2048) -> str:
    """The non-decision demodulator's ``step(debug=True)`` on QPSK with a
    gain and a phase."""
    from ..models.demod import DemodConfig, Demodulator
    from ..models.modulator import Modulator
    from ..viz.debug import debug_report
    rng = np.random.RandomState(1)
    wf = wf_qpsk(PulseShape.rcs(0.25), device=device)
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                           device=device)
    bits = torch.as_tensor(rng.randint(0, 2, nbits).astype(np.int8),
                           device=device)
    w, _ = mod.modulate(bits)
    y = w * (1.3 * np.exp(1j * 0.25))
    dm = Demodulator.create(DemodConfig(wf=wf, fe=4.0, fsymb=1.0),
                            device=device)
    _, _, dbg = dm.step(dm.init(), y, debug=True)
    path = debug_report("non-decision demodulator (QPSK)", dbg,
                        os.path.join(out, "demod"))
    print(f"demod: -> {path}")
    return path


def fm_report(device, out: str, n: int = 1 << 15) -> str:
    """``fm_broadcast_debug`` on a stereo multiplex of two tones."""
    from ..models.analog import fm_broadcast_debug, fm_broadcast_multiplex
    from ..ops.signal import cycles
    from ..viz.debug import debug_report
    fe = 250e3
    al = 0.8 * torch.sin(2 * np.pi * cycles(1000.0 / fe, n, device=device))
    ar = 0.6 * torch.sin(2 * np.pi * cycles(2500.0 / fe, n, device=device))
    x = fm_broadcast_multiplex(al, ar, fe)
    L, R, dbg = fm_broadcast_debug(x, fe)
    dbg = dict(dbg, audio_L=L, audio_R=R)
    path = debug_report("broadcast FM stereo receiver", dbg,
                        os.path.join(out, "fm_stereo"))
    print(f"fm_stereo: -> {path}")
    return path


def main(device="cuda", out: str = OUT, payload_bits: int = 512,
         nbits: int = 2048, n_fm: int = 1 << 15) -> list:
    """The three reports, captured on ``device``; returns their paths."""
    device = torch.device(device)
    return [frame_rx_report(device, out, payload_bits),
            demod_report(device, out, nbits),
            fm_report(device, out, n_fm)]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    a = ap.parse_args()
    main(a.device, a.out)
