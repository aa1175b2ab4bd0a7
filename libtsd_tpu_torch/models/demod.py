"""Demodulators (PyTorch), ported from ``libtsd_tpu/models/demod.py``.

Parity: the reference's non-decision architecture (DemodGen,
core/src/telecom/demod-ndec.cc:17-408): baseband transposition -> (FSK:
quadrature discriminator) -> matched filter -> clock recovery -> carrier
PLL -> decisions, composed from the port's blocks; plus the quadrature
discriminator and max-log LLRs.  The decision-directed architecture is
``demod_dec``/``demod_dec2``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, real_dtype
from ..ops.signal import cycles
from .carrier_rec import Cpll, CpllConfig
from .clock_rec import ClockRec, ClockRecConfig
from .waveform import Waveform, symbol_indices_to_bits

__all__ = ["DemodConfig", "Demodulator", "quadrature_discriminator", "llr"]


def quadrature_discriminator(x: torch.Tensor,
                             prev: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Instantaneous frequency arg(x[n] conj(x[n-1])) along the last axis
    (parity: the FSK discriminator in demod-ndec.cc and FM demod,
    analogique.cc:18-76).  ``prev`` is the sample before x[0] (default:
    x[0] itself, so the first output is 0)."""
    if prev is None:
        prev = x[..., :1]
    xm1 = torch.cat([prev, x[..., :-1]], dim=-1)
    return torch.angle(x * xm1.conj())


def llr(wf: Waveform, y: torch.Tensor, sigma2: float = 0.1) -> torch.Tensor:
    """Max-log-MAP bit LLRs of symbols y (..., n) -> (..., n k) (parity:
    the reference's soft decode, telecom.hpp:409-494)."""
    symbols = wf.symbols
    k = wf.info.k
    d2 = (y[..., None] - symbols).abs() ** 2
    idx = torch.arange(symbols.shape[0], device=y.device)
    inf = torch.tensor(float("inf"), device=y.device)
    out = []
    for b in range(k):
        bit = (idx >> b) & 1
        d0 = torch.where(bit == 0, d2, inf).min(-1).values
        d1 = torch.where(bit == 1, d2, inf).min(-1).values
        out.append((d0 - d1) / sigma2)
    return torch.stack(out, dim=-1).reshape(tuple(y.shape[:-1]) + (-1,))


@dataclasses.dataclass(frozen=True)
class DemodConfig:
    """Parity: DemodConfig, telecom.hpp:1029-1109."""
    wf: Waveform = None
    fe: float = 1.0
    fi: float = 0.0
    fsymb: float = 0.25
    ncoefs_mf: int = 0
    clock_rec: ClockRecConfig = None
    carrier: CpllConfig = None
    # False = no carrier PLL (bench_recepteur's carrier_rec_bl = 0,
    # test-telecom.cc:768)
    carrier_active: bool = True
    architecture: str = "ndec"   # 'ndec' | 'dec'

    @property
    def osf(self) -> int:
        return int(round(self.fe / self.fsymb))


class Demodulator(Block):
    """Non-decision demodulator chain (parity: DemodGen,
    demod-ndec.cc:172-400).  step(state, x) -> (state, (bits, symbols,
    mask, bit_mask))."""

    def __init__(self, mf, cr: ClockRec, pll: Cpll, wf: Waveform,
                 cfg: DemodConfig):
        super().__init__()
        self.mf = mf
        self.cr = cr
        self.pll = pll
        self.wf = wf
        self.cfg = cfg

    @classmethod
    def create(cls, cfg: DemodConfig, device="cuda") -> "Demodulator":
        wf = cfg.wf.on(device)
        osf = cfg.osf
        mf = wf.shaping.matched_filter(cfg.ncoefs_mf, osf, device=device)
        crc = cfg.clock_rec or ClockRecConfig(osf=osf)
        if crc.osf != osf:
            crc = dataclasses.replace(crc, osf=osf)
        cr = ClockRec.create(crc, device=device)
        # rotating constellations (pi/4-QPSK) break the power-loop PED
        default_ped = "dec" if wf.rotating else "auto"
        pc = cfg.carrier or CpllConfig(ped=default_ped, M=None, order=2,
                                       BL=0.01)
        return cls(mf, cr, Cpll(pc, wf=wf), wf,
                   dataclasses.replace(cfg, wf=None))

    def init(self):
        dev = self.wf.device
        return dict(
            nco=torch.zeros((), dtype=real_dtype, device=dev),
            prev=torch.zeros((1,), dtype=complex_dtype, device=dev),
            mf=self.mf.init(),
            cr=self.cr.init(),
            pll=self.pll.init(),
            # pi/4-QPSK rotation parity of the next symbol; -1 = unknown
            par=torch.tensor(-1, dtype=torch.int32, device=dev),
        )

    def step(self, state, x: torch.Tensor, debug: bool = False):
        """``debug=True`` also returns a dict of the stages' signals
        (parity: DemodConfig.debug_actif)."""
        cfg = self.cfg
        n = x.shape[-1]
        dbg = {}
        st = dict(state)
        # (1) baseband transposition, the NCO phase in wrapped cycles
        if cfg.fi != 0.0:
            f = cfg.fi / cfg.fe
            cyc = st["nco"] + cycles(f, n, device=x.device)
            x = x * torch.exp(-2j * np.pi * cyc).to(complex_dtype)
            st["nco"] = torch.remainder(st["nco"] + np.float32((f * n) % 1.0),
                                        1.0)
        if debug:
            dbg["post_transpo"] = x
        # (2) FSK: quadrature discriminator -> real frequency signal
        if self.wf.info.is_fsk:
            d = quadrature_discriminator(x, st["prev"])
            st["prev"] = x[..., -1:]
            om_max = np.pi * self.wf.info.index / cfg.osf
            x = (d / om_max).to(complex_dtype)
            if debug:
                dbg["post_discri"] = x
        # (3) matched filter
        st["mf"], z = self.mf.step(st["mf"], x)
        if debug:
            dbg["post_mf"] = z
        # (4) clock recovery
        st["cr"], (syms, mask) = self.cr.step(st["cr"], z)
        if debug:
            dbg["clockrec_syms"] = syms
            dbg["clockrec_mask"] = mask
        # (5) block AGC to the constellation's RMS
        nvalid = torch.clamp(mask.sum(), min=1)
        power = torch.where(mask, syms.abs() ** 2,
                            torch.zeros((), device=syms.device)).sum() / nvalid
        rms_ref = torch.sqrt((self.wf.symbols.abs() ** 2).mean())
        syms = syms * (rms_ref / torch.sqrt(power + 1e-20))
        if debug:
            dbg["agc_syms"] = syms
        # (6) carrier recovery, frozen on the invalid slots
        if not self.wf.info.is_fsk and cfg.carrier_active:
            pre_pll = syms
            st["pll"], syms = self.pll.step(st["pll"], syms, valid=mask)
            if debug:
                dbg["pll_syms"] = syms
                dbg["pll_phase"] = torch.angle(pre_pll * syms.conj()
                                               + 1e-30)
        # (7) decisions; a rotating constellation carries its parity
        if self.wf.rotating:
            detected = self.wf.detect_parity(syms, mask)
            par = torch.where(st["par"] >= 0, st["par"], detected)
            idx = self.wf.closest(syms, parity=par)
            st["par"] = (par + mask.to(torch.int32).sum()) % 2
        else:
            idx = self.wf.closest(syms)
        bits = symbol_indices_to_bits(idx, self.wf.info.k)
        bmask = mask.repeat_interleave(self.wf.info.k)
        if debug:
            return st, (bits, syms, mask, bmask), dbg
        return st, (bits, syms, mask, bmask)

    def demodulate(self, x: torch.Tensor):
        """One-shot: (bits, symbols, mask, bit_mask)."""
        _, out = self.step(self.init(), x)
        return out
