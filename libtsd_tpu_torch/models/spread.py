"""Spread spectrum: DSSS chip modulation and FHSS frequency hopping, plus
baseband transposition (PyTorch), ported from
``libtsd_tpu/models/spread.py``.

Parity: core/src/telecom/canalisation/etalement-spectre.cc (FHSS :13-63,
DSSS :93-160), transpo-bb.cc:15-70.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.filter_rt import Fir
from ..ops.fir_design import fir_design_windowed
from ..ops.signal import cycles

__all__ = ["dsss_modulate", "dsss_demodulate", "fhss_modulate",
           "TranspoBBConfig", "TranspoBB"]


def _chips(chips, like: torch.Tensor) -> torch.Tensor:
    if isinstance(chips, torch.Tensor):
        return chips.to(device=like.device, dtype=real_dtype)
    return torch.as_tensor(np.asarray(chips), dtype=real_dtype,
                           device=like.device)


def dsss_modulate(x: torch.Tensor, chips, osf_in: int = 1) -> torch.Tensor:
    """Direct-sequence spreading: upsample the symbol stream to the chip
    rate and multiply by the repeated chip sequence (parity:
    DSSSModulation, etalement-spectre.cc:93-160)."""
    chips = _chips(chips, x)
    nchips = chips.shape[0]
    if nchips % osf_in:
        raise ValueError("chips length must be a multiple of osf_in")
    rep = nchips // osf_in
    # rectangular interpolation (sample-and-hold) to the chip rate
    y = torch.repeat_interleave(x, rep, dim=-1)
    n = y.shape[-1]
    seq = chips.repeat(n // nchips + 1)[:n]
    return y * seq.to(y.dtype)


def dsss_demodulate(y: torch.Tensor, chips, osf_in: int = 1) -> torch.Tensor:
    """Despread: multiply by the chip sequence and integrate over each
    symbol period."""
    chips = _chips(chips, y)
    nchips = chips.shape[0]
    rep = nchips // osf_in
    n = (y.shape[-1] // nchips) * nchips
    z = y[..., :n] * chips.repeat(n // nchips).to(y.dtype)
    return z.reshape(*z.shape[:-1], -1, rep).mean(dim=-1)


def fhss_modulate(x: torch.Tensor, hop_seq, slot_len: int,
                  nfreqs: int) -> torch.Tensor:
    """Frequency-hopping: each slot of ``slot_len`` samples is mixed with
    the oscillator at frequency seq[i]/nfreqs (parity: FHSSModulation,
    etalement-spectre.cc:13-63; phase-continuous per frequency).

    ``hop_seq`` may be a tensor, an array, a list or a tuple (the JAX
    function reads ``hop_seq.shape`` before converting and so raises on a
    list, spread.py:67-68)."""
    n = (x.shape[-1] // slot_len) * slot_len
    x = x[..., :n]
    nslots = n // slot_len
    if nfreqs > 46340:
        # the modular product below is bounded by nfreqs^2, which must fit
        # int32 (the JAX package's arithmetic, kept so that both agree)
        raise ValueError(f"nfreqs={nfreqs} > 46340 would overflow the "
                         f"int32 exact-phase arithmetic")
    hop = (hop_seq if isinstance(hop_seq, torch.Tensor)
           else torch.as_tensor(np.asarray(hop_seq)))
    hop = hop.to(device=x.device, dtype=torch.int32)
    hop = hop[torch.arange(nslots, device=x.device) % hop.shape[0]]
    hop = hop % nfreqs
    # EXACT phase by integer modular arithmetic: f = hop/nfreqs, so the
    # phase in cycles is (hop*k mod nfreqs)/nfreqs, computed in int32 (both
    # factors < nfreqs <= 46340): no bit is lost at any signal length
    k = torch.arange(n, dtype=torch.int32, device=x.device)
    hop_per_sample = torch.repeat_interleave(hop, slot_len)
    ph_int = (hop_per_sample * (k % nfreqs)) % nfreqs
    cyc = ph_int.to(real_dtype) / nfreqs
    lo = torch.exp(2j * np.pi * cyc).to(complex_dtype)
    return x * lo


@dataclasses.dataclass(frozen=True)
class TranspoBBConfig:
    """Parity: TranspoBBConfig, telecom.hpp:649-691."""
    fi: float = 0.25     # intermediate frequency (normalized)
    ntaps: int = 63


class TranspoBB(Block):
    """Baseband transposition: mix down by fi and (for real inputs) filter
    the image (parity: TranspoBB, transpo-bb.cc:15-70).  State: (mixer
    phase in wrapped cycles, the image filter's state)."""

    def __init__(self, img_filter: Fir, cfg: TranspoBBConfig,
                 real_input: bool = True):
        super().__init__()
        self.img_filter = img_filter
        self.cfg = cfg
        self.real_input = real_input

    @classmethod
    def create(cls, cfg: TranspoBBConfig, real_input: bool = True,
               device="cuda") -> "TranspoBB":
        fc = cfg.fi if cfg.fi < 0.25 else 0.5 - cfg.fi
        h = fir_design_windowed(cfg.ntaps, "lp", max(fc, 0.01))
        return cls(Fir.create(h, device=_device(device)), cfg,
                   real_input=real_input)

    @property
    def device(self) -> torch.device:
        return self.img_filter.G.device

    def init(self):
        return self.init_for(torch.zeros((0,), dtype=complex_dtype,
                                         device=self.device))

    def init_for(self, x: torch.Tensor):
        # mixer phase carried in CYCLES (wrapped to [0, 1) every block);
        # the filter's state takes x's leading axes
        xc = torch.zeros(tuple(x.shape[:-1]) + (0,), dtype=complex_dtype,
                         device=self.device)
        return (torch.zeros((), dtype=real_dtype, device=self.device),
                self.img_filter.init_for(xc))

    @property
    def delay(self):
        return self.img_filter.delay if self.real_input else 0.0

    def step(self, state, x: torch.Tensor):
        ph, fstate = state
        n = x.shape[-1]
        f = self.cfg.fi
        # the phase in wrapped cycles, the per-block increment reduced mod
        # 1 in host float64 (ops.signal.cycles, the NCO of every mixer)
        cyc = ph + cycles(f, n, device=x.device)
        lo = torch.exp(-2j * np.pi * cyc).to(complex_dtype)
        y = x.to(complex_dtype) * lo
        ph = torch.remainder(ph + torch.as_tensor(
            (f * n) % 1.0, dtype=real_dtype, device=ph.device), 1.0)
        if self.real_input:
            fstate, y = self.img_filter.step(fstate, y)
        return (ph, fstate), y
