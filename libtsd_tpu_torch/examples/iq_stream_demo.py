"""IQ capture serving on the port: file -> prefetching reader ->
StreamRunner.  The twin of ``examples/iq_stream_demo.py``.

A raw cs16 capture (a tone at +0.08 of the sample rate and an interferer
at -0.23, light noise; numpy) is read by ``IqFileReader``, converted to
complex floats, re-blocked and served by ``StreamRunner`` through a
channel-select chain on the device: a streaming NCO mix (``Mixer``, the
phase carried across blocks) then a 127-tap lowpass decimating by 8
(``FirDecim``).  The output must be a clean baseband tone: its spectral
peak within 1e-3 of DC and the interferer more than 40 dB down.

    python -m libtsd_tpu_torch.examples.iq_stream_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..block import Block, chain
from ..config import device as _device, real_dtype
from ..io import IqFileReader, StreamRunner, cs16_to_cf32
from ..ops import fir_design as FD
from ..ops.filter_rt import FirDecim

F_WANTED, F_INTERF = 0.08, -0.23
DECIM = 8
N_IQ = 1 << 18
BLOCK = 1 << 14


class Mixer(Block):
    """Baseband transposition: multiply by exp(-2j pi f0 n), the phase
    (float32, wrapped to [0, 2 pi)) carried across blocks (a streaming
    NCO)."""

    def __init__(self, f0: float):
        super().__init__()
        self.f0 = float(f0)

    def init_for(self, x: torch.Tensor):
        return torch.zeros((), dtype=real_dtype, device=x.device)

    def step(self, state, x):
        n = x.shape[-1]
        ph = state + 2 * np.pi * self.f0 * torch.arange(
            n, dtype=real_dtype, device=x.device)
        y = x * torch.exp(-1j * ph)
        return torch.remainder(state + 2 * np.pi * self.f0 * n,
                               2 * np.pi), y


def capture(n: int = N_IQ) -> np.ndarray:
    """The band as (n, 2) int16 interleaved IQ."""
    rng = np.random.default_rng(0)
    t = np.arange(n)
    band = (1.0 * np.exp(2j * np.pi * F_WANTED * t)
            + 0.8 * np.exp(2j * np.pi * F_INTERF * t)
            + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    raw = np.empty((n, 2), np.int16)
    raw[:, 0] = np.clip(band.real * 8192, -32768, 32767)
    raw[:, 1] = np.clip(band.imag * 8192, -32768, 32767)
    return raw


def make_chain(device):
    """Mixer(F_WANTED) -> FirDecim(127-tap lowpass at 0.4 / DECIM,
    DECIM)."""
    h = FD.fir_lowpass(127, 0.4 / DECIM)
    return chain(Mixer(F_WANTED), FirDecim.create(h, DECIM, device=device))


def selectivity(out: np.ndarray) -> tuple:
    """(frequency of the spectral peak, interferer rejection in dB) of
    8192 output samples after the filter's transient."""
    X = np.fft.fftshift(np.abs(np.fft.fft(out[512:512 + 8192])))
    f = np.fft.fftshift(np.fft.fftfreq(8192))
    peak = f[np.argmax(X)]
    interf_bin = np.argmin(np.abs(f - (F_INTERF - F_WANTED) * DECIM))
    return float(peak), float(20 * np.log10(X.max()
                                            / max(X[interf_bin], 1e-9)))


def firdecim_ms(blk: FirDecim, device, reps: int = 5) -> float:
    """Median wall time of one FirDecim step on a BLOCK-sample block
    (synchronised on a card)."""
    x = torch.ones(BLOCK, dtype=torch.complex64, device=device)
    st = blk.init_for(x)
    ts = []
    for _ in range(reps + 1):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        blk.step(st, x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts[1:]))


def main(device="cuda") -> dict:
    """Serve the capture through the chain on ``device``; returns the
    peak frequency, the rejection, the loop's Msamples/s and FirDecim's
    time a block."""
    device = _device(device)
    raw = capture()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "demo_capture.cs16")
        raw.tofile(path)
        print(f"capture: {raw.nbytes / 1e6:.1f} MB cs16")
        rx = make_chain(device)
        runner = StreamRunner(rx, block_len=BLOCK)
        with IqFileReader(path, "cs16", block_iq=BLOCK) as rd:
            out = runner.run(cs16_to_cf32(blk.reshape(-1)) for blk in rd)
        runner.drain()

    st = runner.monitor.stats
    rate = st.samples_per_s / 1e6
    print(f"served {st.samples} samples in {st.samples // BLOCK} device "
          "blocks "
          f"({rate:.1f} Msamp/s incl. host IO)")
    peak, rej_db = selectivity(out)
    print(f"channel peak at f={peak:+.4f} (expect 0), interferer rejection "
          f"{rej_db:.0f} dB")
    assert abs(peak) < 1e-3 and rej_db > 40, (peak, rej_db)
    ms = firdecim_ms(rx.blocks[1], device)
    print(f"FirDecim step ({BLOCK} samples, 127 taps, R {DECIM}): "
          f"{ms:.3f} ms (host clock)")
    print("OK")
    return {"peak": peak, "rejection_db": rej_db, "msamples_per_s": rate,
            "firdecim_ms": ms}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
