"""Decision-directed demodulator, the reference's second architecture
(PyTorch), ported from ``libtsd_tpu/models/demod_dec.py``.

Parity: DemodGen2 / RecHorloge, core/src/telecom/demod-dec.cc:38-625:
per sample, NCO phase correction -> AGC -> interpolating clock recovery
-> decision -> decision-directed phase, timing and gain updates.  One
Python loop over the matched filter's output carries the whole loop state
(the JAX package's ``lax.scan``); symbols are emitted with a validity mask
and compacted, as in ``clock_rec``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.iir_design import lexp_tc_to_coef
from ..ops.resample import make_interpolator
from .carrier_rec import LoopFilter2, _angle, _where
from .clock_rec import _compact
from .waveform import symbol_indices_to_bits

__all__ = ["DecDemodConfig", "DecisionDemod"]


@dataclasses.dataclass(frozen=True)
class DecDemodConfig:
    """Parity: DemodDecConfig, telecom.hpp (dec.* fields)."""
    osf: int = 4
    # carrier loop
    carrier_active: bool = True
    BL: float = 0.01
    eta: float = 1.0
    # clock recovery
    clock_active: bool = True
    tc: float = 10.0           # timing loop time constant, symbols
    itrp: str = "cspline"
    # AGC
    agc_active: bool = True
    agc_tc: float = 10.0


class DecisionDemod(Block):
    """Fused decision-directed demodulator (after the matched filter).
    step(state, x) -> (state, (bits, symbols, mask, bit_mask))."""

    def __init__(self, itrp, mf, wf, cfg: DecDemodConfig):
        super().__init__()
        self.itrp = itrp
        self.mf = mf
        self.wf = wf
        self.cfg = cfg

    @classmethod
    def create(cls, wf, cfg: DecDemodConfig,
               device="cuda") -> "DecisionDemod":
        device = _device(device)
        return cls(make_interpolator(cfg.itrp, device=device),
                   wf.shaping.matched_filter(0, cfg.osf, device=device),
                   wf.on(device), cfg)

    @property
    def _timing_gain(self) -> float:
        # parity: RecHorloge gain = osf * lexp_tc_vers_coef(tc),
        # demod-dec.cc:89
        return self.cfg.osf * lexp_tc_to_coef(self.cfg.tc)

    @property
    def _agc_alpha(self) -> float:
        return lexp_tc_to_coef(self.cfg.agc_tc)

    def init(self):
        dev = self.itrp.lut.device
        z = lambda *s: torch.zeros(s, dtype=real_dtype, device=dev)  # noqa
        return dict(
            mf=self.mf.init_for(torch.zeros((0,), dtype=complex_dtype,
                                            device=dev)),
            lf=LoopFilter2(self.cfg.BL, self.cfg.eta).init(dev),
            theta=z(),
            gain=torch.ones((), dtype=real_dtype, device=dev),
            phase=torch.tensor(self.cfg.osf / 2.0 + 1.0, dtype=real_dtype,
                               device=dev),
            window=z(2, self.itrp.K),          # re/im planes
            lyi=z(2), lye=z(2),
            cnt=torch.zeros((), dtype=torch.int32, device=dev))

    def step(self, state, x: torch.Tensor):
        cfg = self.cfg
        osf = cfg.osf
        lf = LoopFilter2(cfg.BL, cfg.eta)
        symbols = self.wf.symbols
        tgain = self._timing_gain
        aga = self._agc_alpha

        mf_state, z = self.mf.step(state["mf"], x)
        if cfg.agc_active:
            # coarse block AGC to the constellation's rms before the loop;
            # the decision-directed AGC then tracks the residual
            rms_ref = torch.sqrt((symbols.abs() ** 2).mean())
            rms_in = torch.sqrt((z.abs() ** 2).mean() + 1e-20)
            z = z * (rms_ref / rms_in)

        st = {k: v for k, v in state.items() if k != "mf"}
        yis, sidxs, valids = [], [], []
        for i in range(z.shape[-1]):
            theta = st["theta"]
            # NCO phase correction + AGC (demod-dec.cc:379-392)
            y = z[i] * torch.exp(-1j * theta).to(complex_dtype)
            if cfg.agc_active:
                y = y * st["gain"]
            # interpolating clock recovery
            ph = st["phase"] - 1.0
            win = torch.cat([st["window"][:, 1:],
                             torch.stack([y.real, y.imag])[:, None]], dim=1)
            do = ph < 1.0
            taps = self.itrp.taps(torch.clamp(ph, 0.0, 1.0))
            wc = torch.complex(win[0], win[1])
            yi = (wc * taps.to(complex_dtype)).sum()
            ph_after = torch.where(do, ph + osf, ph)
            # decision
            s_idx = torch.argmin((yi - symbols).abs() ** 2).to(torch.int32)
            ye = symbols[s_idx]
            # AGC update (demod-dec.cc:447-454)
            gain = st["gain"]
            if cfg.agc_active:
                eg = yi.abs() / torch.clamp(ye.abs(), min=1e-9)
                gain_new = (1 - aga) * gain + aga / torch.clamp(eg, min=1e-9)
                gain = torch.where(do, gain_new, gain)
            # phase error + carrier loop (demod-dec.cc:456-471)
            lye = torch.complex(st["lye"][0], st["lye"][1])
            lyi = torch.complex(st["lyi"][0], st["lyi"][1])
            lf_new, theta_new = lf.step(st["lf"], _angle(yi * ye.conj()))
            update = do & (st["cnt"] >= 1) & cfg.carrier_active
            lf_state = _where(update, lf_new, st["lf"])
            theta = torch.where(update, theta_new, theta)
            # decision-directed Mueller & Muller timing update:
            # e = Re(conj(lye) yi - conj(ye) lyi); positive e -> later
            if cfg.clock_active:
                e_t = (lye.conj() * yi - ye.conj() * lyi).real
                dec = torch.clamp(tgain * e_t, -osf / 4.0, osf / 4.0)
                ph_after = torch.where(do & (st["cnt"] >= 1),
                                       ph_after + dec, ph_after)
            st = dict(
                lf=lf_state, theta=theta, gain=gain, phase=ph_after,
                window=win,
                lyi=torch.where(do, torch.stack([yi.real, yi.imag]),
                                st["lyi"]),
                lye=torch.where(do, torch.stack([ye.real, ye.imag]),
                                st["lye"]),
                cnt=st["cnt"] + do.to(torch.int32))
            yis.append(yi)
            sidxs.append(s_idx)
            valids.append(do)

        nmax = x.shape[-1] // osf + 2 + x.shape[-1] // (64 * osf)
        valid = torch.stack(valids)
        syms, mask = _compact(torch.stack(yis), valid, nmax)
        sidx, _ = _compact(torch.stack(sidxs), valid, nmax)
        k = self.wf.info.k
        bits = symbol_indices_to_bits(sidx, k)
        return dict(st, mf=mf_state), (bits, syms, mask,
                                       mask.repeat_interleave(k))
