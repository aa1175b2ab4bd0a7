"""Flagship receiver pipelines (BASELINE configs 4 and 5, PyTorch), ported
from ``libtsd_tpu/models/receivers.py``.

* :class:`FmReceiver`: the FM broadcast chain, channelise (NCO mix) ->
  lowpass + decimate (``FirDecim``) -> quadrature discriminator ->
  de-emphasis (order-1 ``Iir``), streaming, batched over leading axes
  (config 4).  Its fused counterpart on the card is kernel #8
  (``ops.kernels.fm.FmChain``), which starts every call from zero state.
* :class:`Qam16Modem`: QAM-16 with an RRC matched filter, clock recovery
  (``ClockRec2`` or ``ClockRec``) and a decision-directed carrier loop, or
  the fused symbol-rate loop ``DecisionDemod2`` (config 5, and the
  model of ``__graft_entry__.entry()``).

Parity anchors: the reference's FM demod chain
(core/src/telecom/analogique.cc:381-658) and QAM modem test
(core/tests/test-telecom.cc:206-234).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..block import Block
from ..config import (complex_dtype, device as _device, from_ri, real_dtype,
                      to_ri)
from ..ops.filter_rt import FirDecim, Iir
from ..ops.fir_design import fir_design_windowed
from ..ops.iir_design import design_lexp
from ..ops.signal import cycles
from .carrier_rec import Cpll, CpllConfig
from .clock_rec import ClockRec, ClockRecConfig
from .clock_rec2 import ClockRec2
from .demod import quadrature_discriminator
from .demod_dec import DecDemodConfig
from .demod_dec2 import DecisionDemod2
from .modulator import ModConfig, Modulator
from .waveform import PulseShape, Waveform, symbol_indices_to_bits, wf_qam

__all__ = ["FmReceiverConfig", "FmReceiver", "Qam16Modem", "evm"]


# --------------------------------------------------------- FM receiver

@dataclasses.dataclass(frozen=True)
class FmReceiverConfig:
    """Config 4: channelise -> decimate -> quadrature demod -> de-emphasis."""
    channel_freq: float = 0.25    # channel centre (normalised, input rate)
    decim: int = 4                # decimation to the audio rate
    chan_taps: int = 63           # channel-select lowpass taps
    deviation: float = 0.1        # FM deviation at the DECIMATED rate
    deemph_fc: float = 0.05       # de-emphasis cutoff (decimated rate)


class FmReceiver(Block):
    """Streaming FM broadcast receiver, batched over leading axes: input
    (..., n) complex IF samples -> (..., n / decim) audio.  State: the NCO
    phase in cycles, the channel filter's input tail, the discriminator's
    previous decimated sample (re/im planes) and the de-emphasis state."""

    def __init__(self, chan_filt: FirDecim, deemph: Iir,
                 cfg: FmReceiverConfig):
        super().__init__()
        self.chan_filt = chan_filt
        self.deemph = deemph
        self.cfg = cfg

    @classmethod
    def create(cls, cfg: FmReceiverConfig, device="cuda") -> "FmReceiver":
        h = fir_design_windowed(cfg.chan_taps, "lp", 0.4 / cfg.decim, "hn")
        if cfg.deemph_fc > 0:
            b, a = design_lexp(cfg.deemph_fc)
        else:
            b, a = np.array([1.0]), np.array([1.0])   # no de-emphasis
        return cls(FirDecim.create(h, cfg.decim, device=device),
                   Iir.create(b, a, device=device), cfg)

    @property
    def ratio(self):
        return 1.0 / self.cfg.decim

    def init(self):
        dev = self.deemph.b.device
        return dict(
            nco=torch.zeros((), dtype=real_dtype, device=dev),
            chan=self.chan_filt.init_for(
                torch.zeros((0,), dtype=complex_dtype, device=dev)),
            prev_ri=torch.zeros((2, 1), dtype=real_dtype, device=dev),
            de=self.deemph.init(),
        )

    def init_for(self, x: torch.Tensor):
        dev = self.deemph.b.device
        lead = tuple(x.shape[:-1])
        return dict(
            nco=torch.zeros((), dtype=real_dtype, device=dev),
            chan=self.chan_filt.init_for(x.to(complex_dtype)),
            prev_ri=torch.zeros((2,) + lead + (1,), dtype=real_dtype,
                                device=dev),
            de=self.deemph.init_for(x.real if x.is_complex() else x),
        )

    def step(self, state, x: torch.Tensor):
        cfg = self.cfg
        n = x.shape[-1]
        # (1) channelise: the NCO phase in wrapped cycles, float64 on the
        # host within the block (signal.cycles)
        f = cfg.channel_freq
        cyc = state["nco"] + cycles(f, n, device=x.device)
        xb = x.to(complex_dtype) * torch.exp(-2j * np.pi * cyc).to(
            complex_dtype)
        nco = torch.remainder(state["nco"] + np.float32((f * n) % 1.0), 1.0)
        # (2) channel-select lowpass + decimate
        cst, xd = self.chan_filt.step(state["chan"], xb)
        # (3) quadrature discriminator
        d = quadrature_discriminator(xd, from_ri(state["prev_ri"]))
        audio = d / (2 * np.pi * cfg.deviation)
        # (4) de-emphasis (first-order IIR, log-depth scan)
        dst, audio = self.deemph.step(state["de"], audio)
        return dict(nco=nco, chan=cst, prev_ri=to_ri(xd[..., -1:]),
                    de=dst), audio


# --------------------------------------------------------- QAM-16 modem

def evm(symbols: torch.Tensor, wf: Waveform) -> torch.Tensor:
    """Error-vector magnitude (rms, relative) against the nearest
    constellation points."""
    s = wf.symbols
    e2 = ((symbols[..., None] - s).abs() ** 2).min(-1).values
    return torch.sqrt(e2.mean(-1) / (s.abs() ** 2).mean())


def _tail_evm(syms: torch.Tensor, mask: torch.Tensor,
              wf: Waveform) -> torch.Tensor:
    """EVM over the converged tail (the second half of the valid
    symbols)."""
    nmask = mask.sum()
    tail = torch.where(torch.arange(syms.shape[0], device=syms.device)
                       >= nmask // 2, mask, torch.zeros_like(mask))
    s = wf.symbols
    d2 = ((syms[..., None] - s).abs() ** 2).min(-1).values
    p_ref = (s.abs() ** 2).mean()
    return torch.sqrt(torch.where(tail, d2, torch.zeros_like(d2)).sum()
                      / (torch.clamp(tail.sum(), min=1) * p_ref))


class Qam16Modem(nn.Module):
    """QAM-16 modem: RRC shaping TX; RX = matched filter -> clock recovery
    -> decision-directed carrier loop -> decisions + EVM (``rx_mode=
    "composed"``), or the fused symbol-rate loop (``"fused"``,
    ``DecisionDemod2``).  ``clock``: "ptr" (``ClockRec2``, a loop over
    symbols) or "sample" (``ClockRec``, per sample)."""

    def __init__(self, wf, mod, mf, cr, pll, dd2, osf: int = 4,
                 rx_mode: str = "composed"):
        super().__init__()
        self.wf, self.mod, self.mf, self.cr = wf, mod, mf, cr
        self.pll, self.dd2 = pll, dd2
        self.osf = int(osf)
        self.rx_mode = rx_mode

    @classmethod
    def create(cls, osf: int = 4, beta: float = 0.25, clock: str = "ptr",
               rx_mode: str = "composed", device="cuda") -> "Qam16Modem":
        device = _device(device)
        wf = wf_qam(16, PulseShape.rcs(beta), device=device)
        mod = Modulator.create(ModConfig(wf=wf, fe=float(osf), fsymb=1.0),
                               device=device)
        mf = wf.shaping.matched_filter(0, osf, device=device)
        crc = ClockRecConfig(osf=osf, tc=10.0)
        cr = (ClockRec2.create(crc, device=device) if clock == "ptr"
              else ClockRec.create(crc, device=device))
        pll = Cpll(CpllConfig(ped="dec", M=16, order=2, BL=0.01), wf=wf)
        dd2 = DecisionDemod2.create(
            wf, DecDemodConfig(osf=osf, tc=10.0, BL=0.01, agc_tc=10.0),
            device=device)
        return cls(wf, mod, mf, cr, pll, dd2, osf=osf, rx_mode=rx_mode)

    def transmit(self, bits: torch.Tensor) -> torch.Tensor:
        return self.mod.modulate(bits)[0]

    def receive(self, x: torch.Tensor):
        """x: (n,) baseband samples -> (bits, symbols, mask, evm)."""
        if self.rx_mode == "fused":
            _, (bits, syms, mask, _) = self.dd2.step(self.dd2.init(), x)
            return bits, syms, mask, _tail_evm(syms, mask, self.wf)
        _, z = self.mf.step(self.mf.init_for(x), x)
        _, (syms, mask) = self.cr.step(self.cr.init(), z)
        # AGC to the constellation's RMS (QAM-16's E|s|^2 = 10/9)
        nv = torch.clamp(mask.sum(), min=1)
        p = torch.where(mask, syms.abs() ** 2,
                        torch.zeros((), device=syms.device)).sum() / nv
        rms_ref = torch.sqrt((self.wf.symbols.abs() ** 2).mean())
        syms = syms * (rms_ref / torch.sqrt(p + 1e-20))
        # carrier loop, frozen on the invalid slots
        _, syms = self.pll.step(self.pll.init(), syms, valid=mask)
        bits = symbol_indices_to_bits(self.wf.closest(syms), 4)
        return bits, syms, mask, _tail_evm(syms, mask, self.wf)
