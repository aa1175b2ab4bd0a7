"""Modulator: bits -> shaped I/Q (or real IF) samples, streaming (PyTorch),
ported from ``libtsd_tpu/models/modulator.py``.

Parity: Modulateur / ModConfig, core/src/telecom/modulateur.cc:19-250,
core/include/tsd/telecom.hpp:852-875.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.signal import cycles
from .waveform import Waveform

__all__ = ["ModConfig", "Modulator"]


@dataclasses.dataclass(frozen=True)
class ModConfig:
    """Parity: ModConfig, telecom.hpp:852-875."""
    wf: Waveform = None
    fe: float = 1.0        # sample rate
    fi: float = 0.0        # intermediate (carrier) frequency
    fsymb: float = 0.25    # symbol rate
    real_output: bool = False  # sortie_réelle
    ncoefs: int = 0

    @property
    def osf(self) -> int:
        osf = self.fe / self.fsymb
        if abs(osf - round(osf)) >= 1e-6:
            raise ValueError("fe/fsymb must be an integer")
        return int(round(osf))


class Modulator(Block):
    """bits -> symbols -> pulse shaping (polyphase x osf) -> optional IF
    upconversion (parity: Modulateur::step, modulateur.cc:~130-237).

    State: (shaping filter state, NCO phase in cycles, FSK phase, symbol
    parity).  ``delay`` is in output samples to the centre of the first
    symbol."""

    def __init__(self, shaper, wf: Waveform, config: ModConfig, nc: int):
        super().__init__()
        self.shaper = shaper
        self.wf = wf
        self.config = dataclasses.replace(config, wf=None)
        self.nc = int(nc)

    @classmethod
    def create(cls, config: ModConfig, device="cuda") -> "Modulator":
        wf = config.wf.on(device)
        osf = config.osf
        shaper = wf.shaping.shaping_filter(config.ncoefs, osf,
                                           device=wf.device)
        nc = len(wf.shaping.get_coefs(config.ncoefs, osf))
        return cls(shaper, wf, config, nc)

    @property
    def delay(self) -> float:
        # end-padded FirUps taps: (nc - 1) / 2 output samples
        return (self.nc - 1) / 2.0

    @property
    def ratio(self) -> float:
        return self.config.osf / self.wf.info.k

    def init(self):
        dev = self.wf.device
        return (self.shaper.init_for(torch.zeros((0,), dtype=complex_dtype,
                                                 device=dev)),
                torch.zeros((), dtype=real_dtype, device=dev),  # NCO phase
                torch.zeros((), dtype=real_dtype, device=dev),  # FSK phase
                torch.zeros((), dtype=torch.int32, device=dev))  # parity

    def init_for(self, symbs: torch.Tensor):
        """State for a batch of symbol rows (leading axes of ``symbs``):
        one shaping-filter history per row, shared scalar phases."""
        st = self.init()
        return (self.shaper.init_for(symbs.to(complex_dtype)),) + st[1:]

    def _post_shaper(self, y, ph, fsk_ph):
        """FSK phase integration, IF upconversion, real output."""
        cfg = self.config
        if self.wf.info.is_fsk and y.shape[-1] > 0:
            om_max = np.pi * self.wf.info.index / cfg.osf
            # normalised by the constellation extreme, not the block's
            # data maximum: the RF must not depend on the blocking
            vmax = self.wf.symbols.real.abs().max()
            vf = y.real * (om_max / torch.clamp(vmax, min=1e-30))
            phases = fsk_ph[..., None] + torch.cumsum(vf, dim=-1)
            y = torch.exp(1j * phases).to(complex_dtype)
            fsk_ph = torch.remainder(phases[..., -1], 2 * np.pi)
        if cfg.fi != 0.0:
            # NCO phase in wrapped cycles, the per-block increment reduced
            # mod 1 in host float64
            n = y.shape[-1]
            f = cfg.fi / cfg.fe
            cyc = ph[..., None] + cycles(f, n, device=y.device)
            y = y * torch.exp(2j * np.pi * cyc).to(complex_dtype)
            ph = torch.remainder(ph + np.float32((f * n) % 1.0), 1.0)
        if cfg.real_output:
            y = np.sqrt(2.0) * y.real
        return y, ph, fsk_ph

    def step(self, state, bits: torch.Tensor):
        # the carried symbol parity continues the pi/4-QPSK rotation
        symbs = self.wf.make_symbols(bits, parity=state[3])
        return self.step_symbols(state, symbs)

    def step_symbols(self, state, symbs: torch.Tensor):
        """Feed already-mapped symbols through the shaping filter and the
        IF chain (the hook for a distinct header waveform, fo_entete:
        modulateur.cc:43-46)."""
        sh_state, ph, fsk_ph, par = state
        sh_state, y = self.shaper.step(sh_state, symbs)
        y, ph, fsk_ph = self._post_shaper(y, ph, fsk_ph)
        par = (par + symbs.shape[-1]) % 2
        return (sh_state, ph, fsk_ph, par), y

    def flush(self, state) -> Tuple[tuple, torch.Tensor]:
        """Push zero symbols through to drain the filter delay (zero bits
        would map to constellation point 0 and transmit phantom
        symbols)."""
        nflush = (self.nc + self.config.osf - 1) // self.config.osf
        sh_state, ph, fsk_ph, par = state
        zsym = torch.zeros(tuple(sh_state.shape[:-1]) + (nflush,),
                           dtype=complex_dtype, device=self.wf.device)
        sh_state, y = self.shaper.step(sh_state, zsym)
        y, ph, fsk_ph = self._post_shaper(y, ph, fsk_ph)
        return (sh_state, ph, fsk_ph, par), y

    def modulate(self, bits: torch.Tensor) -> Tuple[torch.Tensor, float]:
        """One-shot: modulate and flush; returns (samples, delay)."""
        st, y1 = self.step(self.init(), bits)
        _, y2 = self.flush(st)
        return torch.cat([y1, y2]), float(self.delay)
