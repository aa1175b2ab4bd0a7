"""Multichannel QAM-16 serving on the port: one card demodulating a fleet
of channels in one batched step (BASELINE config 5).  The twin of
``examples/qam_serving.py``.

Flow: one QAM-16 stream from the port's modulator (RRC 0.25, osf 4), 8
distinct fractional delays repeated over C channels, independent noise
(all made on the device from a ``torch.Generator``), then every channel
demodulated by ``DecisionDemodSB`` in one step:

* on a CUDA device the ``"cuda-fused"`` engine (kernel #6: matched filter,
  AGC, timing and carrier loops and decisions in one kernel);
* on the CPU the ``"auto"`` engine (the same loop in plain PyTorch).

The engine follows the device the caller names, never whether a card is
present.  Gates on every run: tail EVM below 0.2 on every channel and no
bit error after 600 warm-up symbols on C / 4-spaced channels.

    python -m libtsd_tpu_torch.examples.qam_serving [C] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..config import device as _device
from ..models import ber as BER
from ..models import waveform as WF
from ..models.bitstream import randbits
from ..models.demod_sb import DecisionDemodSB, SBDemodConfig
from ..models.modulator import ModConfig, Modulator
from ..ops.fft import delay_signal

OSF, NSYM = 4, 2048
NOISE = 0.02           # noise std per real dimension
WARMUP = 600           # symbols before the bit-error count starts
TOL_EVM = 0.2


def engine_for(device: torch.device) -> str:
    """The batched engine for the device the caller named."""
    return "cuda-fused" if device.type == "cuda" else "auto"


def make_signal(mod: Modulator, C: int, gen: torch.Generator):
    """(bits, x (C, n)): one stream, fractional delays 0.3 + 0.001 c on
    the first 8 channels, tiled over C, plus independent noise."""
    bits = randbits(gen, 4 * NSYM)
    x, _ = mod.modulate(bits)
    n = (x.shape[-1] // 64) * 64
    x = x[:n]
    xs = torch.stack([delay_signal(x, 0.3 + 0.001 * c)
                      for c in range(min(C, 8))])
    xs = xs.repeat(C // xs.shape[0] + 1, 1)[:C]
    w = torch.randn(2, C, n, generator=gen, device=gen.device) * NOISE
    return bits, xs + torch.complex(w[0], w[1])


def tail_evm(wf, syms: torch.Tensor) -> torch.Tensor:
    """Per-channel EVM of the second half of the symbols (C,), on their
    device."""
    sym = wf.symbols
    t = syms[:, syms.shape[1] // 2:]
    d2 = ((t[..., None] - sym).abs() ** 2).min(-1).values
    return torch.sqrt(d2.mean(-1) / (sym.abs() ** 2).mean())


def bit_errors(wf, bits: torch.Tensor, syms: torch.Tensor,
               mask: torch.Tensor) -> int:
    """Bit errors after WARMUP symbols on channels 0, C/4, C/2, 3C/4 (the
    blind loop's 90-degree ambiguity resolved by ``cmp_bits_rot``)."""
    C = syms.shape[0]
    nerr = 0
    for c in range(0, C, max(C // 4, 1)):
        sy = syms[c][mask[c]]
        _, errs, _ = BER.cmp_bits_rot(bits[4 * WARMUP:], sy[WARMUP:], wf,
                                      max_lag=64)
        nerr += int(errs)
    return nerr


def main(C: int = 128, device="cuda") -> dict:
    """Demodulate C channels in one step; returns the engine, the tail
    EVM's mean and max, the sampled channels' bit errors and the step's
    wall time."""
    device = _device(device)
    engine = engine_for(device)
    print(f"device={device}  C={C}  engine={engine}")
    gen = torch.Generator(device=device).manual_seed(0)
    wf = WF.wf_qam(16, WF.PulseShape.rcs(0.25), device=device)
    mod = Modulator.create(ModConfig(wf=wf, fe=float(OSF), fsymb=1.0),
                           device=device)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=OSF, S=16,
                                                  engine=engine),
                                device=device)
    bits, x = make_signal(mod, C, gen)
    st = dd.init_for(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    st, (_, syms, mask, _) = dd.step(st, x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    step_s = time.perf_counter() - t0

    ev = tail_evm(wf, syms).cpu()
    print(f"tail EVM: mean={ev.mean():.4f} max={ev.max():.4f}")
    assert ev.max() < TOL_EVM, ev.max()
    nerr = bit_errors(wf, bits, syms, mask)
    print(f"steady-state bit errors over sampled channels: {nerr}")
    assert nerr == 0
    print(f"first step: {C} x {x.shape[-1]} samples in "
          f"{1e3 * step_s:.2f} ms (host clock, "
          f"{C * x.shape[-1] / step_s / 1e6:.1f} Msamp/s)")
    print("QAM serving demo OK")
    return {"C": C, "engine": engine, "evm_mean": float(ev.mean()),
            "evm_max": float(ev.max()), "bit_errors": nerr,
            "step_ms": 1e3 * step_s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("C", nargs="?", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    main(a.C, a.device)
