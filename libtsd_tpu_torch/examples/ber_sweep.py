"""BER vs Eb/N0 across waveforms on the port: the reference's benchmark
machinery (parity: bench_recepteur, core/tests/test-telecom.cc:731-809:
BPSK/QPSK/pi4-QPSK/8-PSK/16-QAM/4-FSK, an Eb/N0 sweep, measured against
theoretical BER).  The twin of ``examples/ber_sweep.py``.

Each point: random bits (a ``torch.Generator`` on the device) -> the
port's ``Modulator`` (63-tap shaping) -> ``channel.awgn`` -> the
non-decision ``Demodulator`` (63-tap matched filter, clock and carrier
loops on) -> ``cmp_bits_psk`` / ``cmp_bits`` after the first quarter of
the bits.  Prints a table; draws the curves into an HTML report unless
``--no-report`` (the report needs matplotlib, the ``viz`` extra).

    python -m libtsd_tpu_torch.examples.ber_sweep [--device cpu]
        [--nbits 16384] [--snrs -4,0,4] [--report DIR | --no-report]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import device as _device
from ..models import ber as BER
from ..models import channel as CH
from ..models import waveform as WF
from ..models.bitstream import randbits
from ..models.demod import DemodConfig, Demodulator
from ..models.modulator import ModConfig, Modulator

OSF = 4
NCOEFS = 63          # the reference bench's filters (test-telecom.cc:769)
SNRS = np.arange(-4.0, 16.1, 2.0)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "build", "report", "torch", "ber_sweep")


def waveforms(device) -> list:
    """The reference's six (test-telecom.cc:736-744): 4-FSK at index 1.0
    with Gaussian BT=2 shaping, everything else RRC 0.25."""
    rcs = WF.PulseShape.rcs(0.25)
    return [
        ("BPSK", WF.wf_bpsk(rcs, device=device)),
        ("QPSK", WF.wf_qpsk(rcs, device=device)),
        ("pi4-QPSK", WF.wf_pi4_qpsk(rcs, device=device)),
        ("8PSK", WF.wf_psk(8, rcs, device=device)),
        ("QAM16", WF.wf_qam(16, rcs, device=device)),
        ("4FSK", WF.wf_fsk(4, 1.0, WF.PulseShape.gaussian(2.0),
                           device=device)),
    ]


def transmit(wf, bits: torch.Tensor, osf: int = OSF,
             ncoefs: int = NCOEFS) -> torch.Tensor:
    mod = Modulator.create(ModConfig(wf=wf, fe=float(osf), fsymb=1.0,
                                     ncoefs=ncoefs), device=bits.device)
    return mod.modulate(bits)[0]


def count(wf, bits: torch.Tensor, y: torch.Tensor, osf: int = OSF,
          ncoefs: int = NCOEFS) -> tuple:
    """Demodulate y and count errors against bits after the first quarter
    (the loops' convergence): (ber, errors)."""
    dm = Demodulator.create(DemodConfig(wf=wf, fe=float(osf), fsymb=1.0,
                                        ncoefs_mf=ncoefs), device=y.device)
    rx_bits, _, _, bmask = dm.demodulate(y)
    rx = rx_bits[bmask]
    skip = len(bits) // 4
    if wf.info.is_psk or wf.info.is_qam:
        b, e, _ = BER.cmp_bits_psk(bits[skip:], rx[skip:], wf.info.k,
                                   max_lag=64)
    else:
        b, e, _ = BER.cmp_bits(bits[skip:], rx[skip:], max_lag=64)
    return b, e


def measure_ber(wf, EbN0_db: float, nbits: int, seed: int,
                osf: int = OSF, ncoefs: int = NCOEFS) -> float:
    """One TX -> AWGN -> demod -> count run; bits from ``seed``, noise from
    a generator seeded by the Eb/N0 (as the JAX demo keys its noise)."""
    dev = wf.device
    bits = randbits(torch.Generator(device=dev).manual_seed(seed), nbits)
    x = transmit(wf, bits, osf, ncoefs)
    gn = torch.Generator(device=dev).manual_seed(
        (1 << 20) + int(EbN0_db * 10))
    y = CH.awgn(gn, x, EbN0_db, osf=osf, k_bits=wf.info.k)
    return count(wf, bits, y, osf, ncoefs)[0]


def main(nbits: int = 16384, snrs=None, device="cuda", out: str = OUT,
         report: bool = True) -> list:
    """The sweep on ``device`` over ``snrs`` (default -4..16 dB by 2) for
    every waveform.  Returns [(waveform, Eb/N0, measured, theory)]."""
    device = _device(device)
    snrs = SNRS if snrs is None else snrs
    rows, curves = [], []
    print(f"{'waveform':<10}{'Eb/N0':>7}{'measured':>12}{'theory':>12}"
          f"   ({nbits} bits a point)")
    for name, wf in waveforms(device):
        meas, theo = [], []
        for i, s in enumerate(snrs):
            b = measure_ber(wf, float(s), nbits, 1000 + i)
            t = float(wf.ber(float(s)))
            meas.append(max(b, 1e-7))
            theo.append(max(t, 1e-7))
            rows.append((name, float(s), b, t))
            print(f"{name:<10}{s:>7.1f}{b:>12.2e}{t:>12.2e}")
        curves.append((name, np.asarray(snrs, float), meas, theo))
    if report:
        from ..viz import Figure
        from ..viz.report import Report
        rep = Report(out)
        for name, s, meas, theo in curves:
            f = Figure(f"{name}: BER vs Eb/N0")
            f.plot(s, np.log10(theo), fmt="g-", label="theory")
            f.plot(s, np.log10(meas), fmt="r-o", label="measured")
            f.titles(f"{name}", "Eb/N0 (dB)", "log10 BER")
            rep.add_figure(f, name)
        rep.flush()
        print(f"report: {os.path.join(out, 'index.html')}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nbits", type=int, default=16384)
    ap.add_argument("--snrs", type=lambda v: [float(t) for t in v.split(",")],
                    help="comma-separated Eb/N0 points in dB (default "
                         "-4..16 by 2)")
    ap.add_argument("--report", default=OUT, metavar="DIR")
    ap.add_argument("--no-report", action="store_true",
                    help="print the table only (no matplotlib needed)")
    a = ap.parse_args()
    main(a.nbits, a.snrs, a.device, a.report, not a.no_report)
