"""FM broadcast receiver on the port, BASELINE config 4 end to end.  The
twin of ``examples/fm_demo.py``.

A band of three FM stations at carriers 0.10, 0.22 and 0.36 of the
sample rate, each modulated by its own tone mix (the audio in numpy, the
modulation by the port's ``fm_modulate`` on the device, the carriers and
the noise in numpy), received by one ``FmReceiver`` a station
(channelise, decimate by 4, quadrature discriminator, de-emphasis) on the
device.  Each station's audio must correlate above 0.97 with its true
audio through the same de-emphasis (``scipy.signal.lfilter``).  The
audio goes to WAV files always; the band's Welch PSD (2048 bins, kernel
#4 on a card) is computed always and drawn, with the recovered audio,
into an HTML report unless ``--no-report`` (the report needs
matplotlib, the ``viz`` extra).

    python -m libtsd_tpu_torch.examples.fm_demo [--device cpu]
        [--report DIR | --no-report]

Parity anchor: the reference's FM demod chain
(core/src/telecom/analogique.cc:18-76,381-658).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import device as _device
from ..models.analog import fm_modulate
from ..models.receivers import FmReceiver, FmReceiverConfig
from ..ops.iir_design import design_lexp
from ..ops.psd import psd_welch
from ..utils.wav import wav_save

DECIM = 4
DEVIATION = 0.1           # at the decimated rate
DEEMPH_FC = 0.02
STATIONS = [              # (carrier freq, audio tone freqs at decim rate)
    (0.10, (0.010, 0.023)),
    (0.22, (0.015,)),
    (0.36, (0.008, 0.031)),
]
N = 1 << 15               # band samples
NPSD = 2048
TOL_CORR = 0.97

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "report", "torch", "fm_demo")


def synth_band(n: int = N, device="cuda"):
    """(band (n,) complex64 on ``device``, [true audio of each station at
    the decimated rate])."""
    device = _device(device)
    t = np.arange(n)
    band = np.zeros(n, np.complex64)
    audios = []
    for fc, tones in STATIONS:
        audio = sum(np.sin(2 * np.pi * f / DECIM * t) for f in tones)
        audio = (audio / max(len(tones), 1)).astype(np.float32)
        audios.append(audio[::DECIM])
        x = fm_modulate(torch.as_tensor(audio, device=device),
                        deviation=DEVIATION / DECIM).cpu().numpy()
        band += (x * np.exp(2j * np.pi * fc * t)).astype(np.complex64)
    noise = np.random.default_rng(0).standard_normal(2 * n).view(
        np.complex128).astype(np.complex64) * 0.02
    return torch.as_tensor(band + noise, device=device), audios


def receivers(device) -> list:
    return [FmReceiver.create(FmReceiverConfig(
        channel_freq=fc, decim=DECIM, deviation=DEVIATION,
        deemph_fc=DEEMPH_FC), device=device) for fc, _ in STATIONS]


def receive_all(rxs: list, x: torch.Tensor) -> torch.Tensor:
    """Each station's audio (3, n / DECIM), on x's device."""
    return torch.stack([rx.step(rx.init_for(x), x)[1] for rx in rxs])


def correlations(rxs: list, audio: np.ndarray, audios_true: list) -> list:
    """Per station: (correlation, recovered segment, reference segment),
    the transients skipped and the channel filter's delay compensated, the
    true audio through the receiver's de-emphasis."""
    from scipy.signal import lfilter
    b, a = design_lexp(DEEMPH_FC)
    out = []
    for rx, aud, true in zip(rxs, audio, audios_true):
        d = int(rx.chan_filt.delay)
        seg = aud[50:-50]
        ref_f = lfilter(np.asarray(b, float), np.asarray(a, float),
                        true.astype(float))
        ref = ref_f[50 - d: 50 - d + len(seg)]
        m = min(len(seg), len(ref))
        out.append((float(np.corrcoef(seg[:m], ref[:m])[0, 1]), seg, ref))
    return out


def _report(out: str, fr, pdb, corrs) -> str:
    from ..viz import Figure
    from ..viz.report import Report
    rep = Report(out)
    rep.printf("FM broadcast receiver demo (config 4): three stations, "
               "channelize -> decimate -> quadrature demod -> de-emphasis")
    f = Figure()
    f.plot(fr, pdb, "b-")
    f.titles("band PSD (3 FM stations)", "frequency", "dB")
    rep.add_figure(f, "band PSD")
    for i, ((fc, _), (corr, seg, ref)) in enumerate(zip(STATIONS, corrs)):
        f = Figure()
        f.plot(seg[:1024], "g-", label="recovered")
        f.plot(ref[:1024], "r:", label="original")
        f.titles(f"station {i} @ {fc:.2f} (corr {corr:.3f})",
                 "sample", "audio")
        rep.add_figure(f, f"station {i}")
    rep.flush()
    return os.path.join(out, "index.html")


def main(device="cuda", out: str = OUT, report: bool = True) -> dict:
    """Receive the three stations on ``device``; WAVs into ``out`` and,
    with ``report``, index.html there too.  Returns each station's
    correlation, the band's Welch PSD in dB and its peak frequency."""
    device = _device(device)
    band, audios_true = synth_band(N, device)
    os.makedirs(out, exist_ok=True)
    rxs = receivers(device)
    audio = receive_all(rxs, band).cpu().numpy()
    fr, pdb = psd_welch(band, NPSD)
    fr, pdb = fr.cpu().numpy(), pdb.cpu().numpy()

    corrs = correlations(rxs, audio, audios_true)
    print(f"{'station':>8} {'carrier':>8} {'corr':>7}")
    for i, ((fc, _), aud, (corr, _, _)) in enumerate(zip(STATIONS, audio,
                                                         corrs)):
        print(f"{i:>8} {fc:>8.2f} {corr:>7.3f}")
        wav_save(os.path.join(out, f"station{i}.wav"),
                 aud / (np.max(np.abs(aud)) + 1e-9), rate=8000)
    print(f"band PSD: {NPSD} bins, peak at f={fr[np.argmax(pdb)]:+.4f}")
    if report:
        print(f"report: {_report(out, fr, pdb, corrs)}")
    for i, (corr, _, _) in enumerate(corrs):
        assert corr > TOL_CORR, (i, corr)
    return {"corr": [c for c, _, _ in corrs], "psd_db": pdb,
            "psd_peak": float(fr[np.argmax(pdb)])}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--report", default=OUT, metavar="DIR",
                    help="where the WAVs and the report go")
    ap.add_argument("--no-report", action="store_true",
                    help="write the WAVs only (no matplotlib needed)")
    a = ap.parse_args()
    main(a.device, a.report, not a.no_report)
