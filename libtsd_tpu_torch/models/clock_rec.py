"""Clock (symbol timing) recovery (PyTorch), ported from
``libtsd_tpu/models/clock_rec.py``.

Parity: core/src/telecom/clock-rec.cc (TEDs :11-95, ClockRec :97-392) and
core/include/tsd/telecom.hpp:703-745 (ClockRecConfig).  The per-sample
feedback loop is a Python loop over the input samples (the JAX package's
``lax.scan``); the symbols are emitted with a validity mask and compacted
into a static-length buffer, as there.

Loop per input sample (parity: ClockRec::step, clock-rec.cc:186-310)::

    phase -= 1; push the sample into the interpolator window
    if phase < 1:
        y = interp(window, frac(phase)); phase += K1 / K2
        every K2-th interpolation -> output symbol;
        TED e = Re((x2 - x0) conj(x1)); phase -= clamp(gain e, +-K1 / 4)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.resample import make_interpolator

__all__ = ["ted_gardner", "ted_mm", "ted_early_late",
           "ClockRecConfig", "ClockRec", "clock_rec"]


def ted_gardner(x0, x1, x2):
    """Gardner TED (parity: TedGardner, clock-rec.cc:61-77):
    e = Re((x2 - x0) conj(x1)), x0/x2 the previous/current symbol samples
    and x1 the midpoint."""
    return ((x2 - x0) * x1.conj()).real


def _slicer(y):
    """Nearest-quadrant decision (clock-rec.cc:20-24)."""
    s = torch.complex(torch.sign(y.real), torch.sign(y.imag))
    return (s / np.sqrt(2.0)).to(complex_dtype)


def ted_mm(d0, x0, d1, x1):
    """Mueller & Müller decision-directed TED at 1 sample/symbol (parity:
    TedMM, clock-rec.cc:11-28): e = Re(conj(d0) x1 - conj(d1) x0)."""
    return (d0.conj() * x1 - d1.conj() * x0).real


def ted_early_late(x0, x1, x2):
    """Early-late gate TED (parity: TedEL, clock-rec.cc:30-46):
    e = -Re(conj(x1) (x2 - x0)), x0/x2 the half-symbol early/late
    samples."""
    return -(x1.conj() * (x2 - x0)).real


@dataclasses.dataclass(frozen=True)
class ClockRecConfig:
    """Parity: ClockRecConfig, telecom.hpp:703-745."""
    osf: int = 4          # input oversampling factor (K1)
    tc: float = 5.0       # loop time constant, in symbols
    ted_osf: int = 2      # TED working rate (K2); Gardner/early-late = 2
    itrp: str = "cspline"  # interpolator kind
    ted: str = "gardner"  # "gardner" | "mm" | "el"

    @property
    def loop_gain(self) -> float:
        """First-order loop gain from the time constant (clock-rec.cc)."""
        K1 = self.osf
        return K1 * (1 - np.exp(-1.0 / (self.tc * K1)))


class ClockRec(Block):
    """Streaming Gardner clock recovery.  ``step(state, x)`` returns
    ``(state, (symbols, valid))``; symbols has the static length
    ``n // osf + 2 + n // (64 osf)`` (nominal symbols plus headroom for
    timing drift) and ``valid`` marks the real outputs."""

    def __init__(self, itrp, cfg: ClockRecConfig):
        super().__init__()
        self.itrp = itrp
        self.cfg = cfg

    @classmethod
    def create(cls, cfg: ClockRecConfig, device="cuda") -> "ClockRec":
        if cfg.ted not in ("gardner", "mm", "el"):
            raise ValueError(f"unknown TED {cfg.ted!r}")
        if cfg.ted == "mm":
            cfg = dataclasses.replace(cfg, ted_osf=1)   # M&M: 1 sample/sym
        if cfg.ted_osf >= 2 * cfg.osf:
            # at most 2 interpolations per input sample: at ted_osf >=
            # 2 osf the average need equals the cap and a timing deficit
            # becomes a permanent phase underflow
            raise ValueError(
                f"ClockRecConfig: ted_osf={cfg.ted_osf} must be < "
                f"2*osf={2 * cfg.osf} (the interpolation budget is 2 "
                f"per input sample; use a higher osf or lower ted_osf)")
        return cls(make_interpolator(cfg.itrp, device=device), cfg)

    @property
    def gain(self) -> float:
        return self.cfg.loop_gain

    def init(self, clock_offset: float = 0.0):
        """``clock_offset``: initial clock phase preset in symbols, in
        [-1, 1] (parity: Démodulateur::regle_horloge, telecom.hpp:935)."""
        dev = self.itrp.lut.device
        zc = torch.zeros((), dtype=complex_dtype, device=dev)
        return dict(
            phase=torch.tensor(self.cfg.osf / 2.0 + clock_offset
                               * self.cfg.osf, dtype=real_dtype, device=dev),
            window=torch.zeros((self.itrp.K,), dtype=complex_dtype,
                               device=dev),
            x0=zc, x1=zc.clone(), x2=zc.clone(), d1=zc.clone(),
            cnt=torch.zeros((), dtype=torch.int32, device=dev))

    @property
    def ratio(self) -> float:
        return 1.0 / self.cfg.osf

    def step(self, state, x: torch.Tensor):
        K1, K2 = self.cfg.osf, self.cfg.ted_osf
        gain = self.gain
        ted = self.cfg.ted
        max_interp = 2 if K1 <= K2 else 1   # interpolations per sample

        def interp_once(c):
            ph, win, x0, x1, x2, d1, cnt = c
            taps = self.itrp.taps(torch.clamp(ph, 0.0, 1.0))
            y = (win * taps.to(complex_dtype)).sum()
            ph = ph + K1 / K2
            x0, x1, x2 = x1, x2, y
            if ted == "mm":
                emit = torch.ones((), dtype=torch.bool, device=x.device)
                d2 = _slicer(y)
                dec = torch.clamp(gain * ted_mm(d1, x1, d2, x2),
                                  -K1 / 4.0, K1 / 4.0)
                ph = ph + dec        # positive e -> sample later
                d1 = d2
            elif ted == "el":
                # the TED fires on the midpoint interpolation after the
                # symbol, when (x0, x1, x2) = (early, on time, late)
                emit = cnt == (K2 - 1)
                fire = cnt == 0
                dec = torch.clamp(gain * ted_early_late(x0, x1, x2),
                                  -K1 / 4.0, K1 / 4.0)
                ph = torch.where(fire, ph - dec, ph)
                cnt = torch.where(emit, torch.zeros_like(cnt), cnt + 1)
            else:
                emit = cnt == (K2 - 1)
                dec = torch.clamp(gain * ted_gardner(x0, x1, x2),
                                  -K1 / 4.0, K1 / 4.0)
                ph = torch.where(emit, ph - dec, ph)
                cnt = torch.where(emit, torch.zeros_like(cnt), cnt + 1)
            return (ph, win, x0, x1, x2, d1, cnt), y, emit

        c = (state["phase"], state["window"], state["x0"], state["x1"],
             state["x2"], state["d1"], state["cnt"])
        syms, valids = [], []
        for i in range(x.shape[-1]):
            win = torch.cat([c[1][1:], x[i:i + 1].to(complex_dtype)])
            c = (c[0] - 1.0, win) + c[2:]
            sym = torch.zeros((), dtype=complex_dtype, device=x.device)
            valid = torch.zeros((), dtype=torch.bool, device=x.device)
            for _ in range(max_interp):
                do = c[0] < 1.0
                nc, y, emit = interp_once(c)
                c = tuple(torch.where(do, b, a) for a, b in zip(c, nc))
                sym = torch.where(do & emit, y, sym)
                valid = valid | (do & emit)
            syms.append(sym)
            valids.append(valid)
        state = dict(zip(("phase", "window", "x0", "x1", "x2", "d1", "cnt"),
                         c))
        n = x.shape[-1]
        nmax = n // K1 + 2 + n // (64 * K1)
        if n == 0:
            return state, (torch.zeros(nmax, dtype=complex_dtype,
                                       device=x.device),
                           torch.zeros(nmax, dtype=torch.bool,
                                       device=x.device))
        return state, _compact(torch.stack(syms), torch.stack(valids), nmax)


def _compact(vals: torch.Tensor, valid: torch.Tensor, nmax: int):
    """Pack the valid entries to the front of a length-nmax buffer;
    returns (buffer, mask).  Entries beyond nmax are dropped."""
    pos = torch.cumsum(valid.to(torch.int64), 0) - 1
    pos = torch.where(valid, pos, torch.full_like(pos, nmax)).clamp(max=nmax)
    out = torch.zeros(nmax + 1, dtype=vals.dtype, device=vals.device)
    out[pos] = vals
    count = valid.sum()
    return out[:nmax], torch.arange(nmax, device=vals.device) < count


def clock_rec(x: torch.Tensor, cfg: ClockRecConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot clock recovery; returns (symbols, valid mask)."""
    blk = ClockRec.create(cfg, device=x.device)
    _, (syms, mask) = blk.step(blk.init(), x)
    return syms, mask
