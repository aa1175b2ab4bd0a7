"""Pointer-based decision-directed demodulator, one loop over symbols
(PyTorch), ported from ``libtsd_tpu/models/demod_dec2.py``.

Each step advances a fractional read pointer through the matched-filtered
signal, interpolates the symbol and the Gardner midpoint, applies the NCO
phase and AGC corrections, decides, and updates the timing (Gardner),
carrier (second-order DD loop) and gain trackers: the loop dynamics of
``demod_dec`` / the reference's DemodGen2 (core/src/telecom/demod-dec.cc)
with the clock recovery in the pointer form of ``clock_rec2``.  A Python
loop over the symbols (the JAX package's ``lax.scan``).
"""
from __future__ import annotations

import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.iir_design import lexp_tc_to_coef
from ..ops.resample import make_interpolator
from .carrier_rec import LoopFilter2, _angle, _where
from .clock_rec import ted_gardner
from .clock_rec2 import interp_window
from .demod_dec import DecDemodConfig
from .waveform import symbol_indices_to_bits

__all__ = ["DecisionDemod2"]


class DecisionDemod2(Block):
    """step(state, x) -> (state, (bits, symbols, valid, bit_valid)); the
    output length is len(x) // osf + 1 + len(x) // (64 osf) symbols (as
    ``ClockRec2``); consumers filter by the masks."""

    def __init__(self, itrp, mf, wf, cfg: DecDemodConfig):
        super().__init__()
        self.itrp = itrp
        self.mf = mf
        self.wf = wf
        self.cfg = cfg

    @classmethod
    def create(cls, wf, cfg: DecDemodConfig,
               device="cuda") -> "DecisionDemod2":
        device = _device(device)
        return cls(make_interpolator(cfg.itrp, device=device),
                   wf.shaping.matched_filter(0, cfg.osf, device=device),
                   wf.on(device), cfg)

    @property
    def _timing_gain(self) -> float:
        return self.cfg.osf * lexp_tc_to_coef(self.cfg.tc)

    @property
    def _agc_alpha(self) -> float:
        return lexp_tc_to_coef(self.cfg.agc_tc)

    @property
    def T(self) -> int:
        """Carried matched-filter-output tail."""
        return self.itrp.K + 2 * self.cfg.osf

    def init(self, clock_offset: float = 0.0):
        """``clock_offset``: initial clock phase in symbols, in [-1, 1]
        (parity: Démodulateur::regle_horloge, telecom.hpp:935)."""
        dev = self.itrp.lut.device
        return dict(
            mf=self.mf.init(),
            lf=LoopFilter2(self.cfg.BL, self.cfg.eta).init(dev),
            theta=torch.zeros((), dtype=real_dtype, device=dev),
            gain=torch.ones((), dtype=real_dtype, device=dev),
            ptr=torch.tensor(self.cfg.osf / 2.0 + clock_offset * self.cfg.osf,
                             dtype=real_dtype, device=dev),
            yprev_ri=torch.zeros((2,), dtype=real_dtype, device=dev),
            tail=torch.zeros((self.T,), dtype=complex_dtype, device=dev),
        )

    def step(self, state, x: torch.Tensor):
        cfg = self.cfg
        osf = cfg.osf
        K, T = self.itrp.K, self.T
        lf = LoopFilter2(cfg.BL, cfg.eta)
        symbols = self.wf.symbols
        tgain = self._timing_gain
        aga = self._agc_alpha
        n = x.shape[-1]
        nsym = n // osf + 1 + n // (64 * osf)
        mf_state, z = self.mf.step(state["mf"], x)
        if cfg.agc_active:
            rms_ref = torch.sqrt((symbols.abs() ** 2).mean())
            z = z * (rms_ref / torch.sqrt((z.abs() ** 2).mean() + 1e-20))
        zp = torch.cat([state["tail"], z,
                        torch.zeros(K + osf, dtype=z.dtype, device=z.device)])
        zero = torch.zeros((), dtype=real_dtype, device=z.device)
        st = {k: state[k] for k in ("lf", "theta", "gain", "ptr", "yprev_ri")}
        ys, sidxs, valids = [], [], []
        for t in range(nsym):
            p = st["ptr"]
            inlow = p > -(1.0 * osf)
            ready = (p < n) & inlow
            nom = zero + t * osf
            pc = torch.where(ready, p, torch.where(inlow, zero, nom))
            rot = torch.exp(-1j * st["theta"]).to(complex_dtype)
            y = interp_window(self.itrp, zp, T, pc) * rot * st["gain"]
            ymid = (interp_window(self.itrp, zp, T, pc - osf / 2.0) * rot
                    * st["gain"])
            yprev = torch.complex(st["yprev_ri"][0], st["yprev_ri"][1])
            # decision
            s_idx = torch.argmin((y - symbols).abs() ** 2).to(torch.int32)
            ye = symbols[s_idx]
            # Gardner timing from the corrected samples
            dec = torch.clamp(tgain * ted_gardner(yprev, ymid, y),
                              -osf / 4.0, osf / 4.0)
            # carrier loop
            lf_state, theta = lf.step(st["lf"], _angle(y * ye.conj()))
            if not cfg.carrier_active:
                lf_state, theta = st["lf"], st["theta"]
            # AGC tracking
            gain = st["gain"]
            if cfg.agc_active:
                eg = y.abs() / torch.clamp(ye.abs(), min=1e-9)
                gain = (1 - aga) * gain + aga / torch.clamp(eg, min=1e-9)
            # loop updates only on consumed symbols
            st = dict(
                lf=_where(ready, lf_state, st["lf"]),
                theta=torch.where(ready, theta, st["theta"]),
                gain=torch.where(ready, gain, st["gain"]),
                ptr=torch.where(
                    ready, p + osf - (dec if cfg.clock_active else 0.0),
                    torch.where(inlow, p, nom + osf)),
                yprev_ri=torch.where(ready, torch.stack([y.real, y.imag]),
                                     st["yprev_ri"]),
            )
            ys.append(torch.where(ready, y, 0.0 * y))
            sidxs.append(torch.where(ready, s_idx, torch.zeros_like(s_idx)))
            valids.append(ready)
        syms, sidx, valid = (torch.stack(ys), torch.stack(sidxs),
                             torch.stack(valids))
        new_state = dict(st, mf=mf_state, ptr=st["ptr"] - n,
                         tail=zp[n:n + T])
        k = self.wf.info.k
        return new_state, (symbol_indices_to_bits(sidx, k), syms, valid,
                           valid.repeat_interleave(k))
