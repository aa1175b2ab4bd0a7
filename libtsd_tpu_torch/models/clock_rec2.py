"""Pointer-based clock recovery, a loop over SYMBOLS (PyTorch), ported from
``libtsd_tpu/models/clock_rec2.py``.

Fills the reference's second clock-recovery slot (ClockRec2 after Mengali,
core/src/telecom/clock-rec.cc:399-626): each step advances a fractional
read pointer by ~osf input samples and interpolates the symbol and its
Gardner midpoint straight from the input block (the JAX package's
``dynamic_slice``, here an index gather with the same clamp).  The loop is
a Python loop over the symbols (the JAX package's ``lax.scan``).
"""
from __future__ import annotations

import torch

from ..block import Block
from ..config import complex_dtype, real_dtype
from ..ops.resample import make_interpolator
from .clock_rec import ClockRecConfig, ted_gardner

__all__ = ["ClockRec2", "interp_window"]


def interp_window(itrp, xp: torch.Tensor, T: int, p: torch.Tensor):
    """The interpolator's value at fractional position p of a block laid
    out at offset T in xp: the causal window x[ip - K + 1 .. ip], its start
    clamped into xp as ``lax.dynamic_slice`` clamps it."""
    K = itrp.K
    ip = torch.floor(p)
    tau = p - ip
    start = torch.clamp(T + ip.to(torch.int64) + 1 - K, 0, xp.shape[-1] - K)
    win = xp[start + torch.arange(K, device=xp.device)]
    return (win * itrp.taps(tau).to(win.dtype)).sum()


class ClockRec2(Block):
    """step(state, x) -> (state, (symbols, valid)), the static output length
    len(x) // osf + 1 + len(x) // (64 osf): the nominal symbol count plus
    catch-up headroom for an RX clock faster than fe / osf."""

    def __init__(self, itrp, cfg: ClockRecConfig):
        super().__init__()
        self.itrp = itrp
        self.cfg = cfg

    @classmethod
    def create(cls, cfg: ClockRecConfig, device="cuda") -> "ClockRec2":
        return cls(make_interpolator(cfg.itrp, device=device), cfg)

    @property
    def gain(self) -> float:
        return self.cfg.loop_gain

    @property
    def ratio(self) -> float:
        return 1.0 / self.cfg.osf

    @property
    def T(self) -> int:
        """Carried input-tail length: the symbol's and its midpoint's
        windows stay inside [tail | x] for pointers down to -osf."""
        return self.itrp.K + 2 * self.cfg.osf

    def init(self):
        dev = self.itrp.lut.device
        return dict(
            ptr=torch.tensor(self.cfg.osf / 2.0, dtype=real_dtype,
                             device=dev),
            tail=torch.zeros((self.T,), dtype=complex_dtype, device=dev),
            yprev_ri=torch.zeros((2,), dtype=real_dtype, device=dev),
        )

    def step(self, state, x: torch.Tensor):
        osf = self.cfg.osf
        K, T = self.itrp.K, self.T
        gain = self.gain
        n = x.shape[-1]
        nsym = n // osf + 1 + n // (64 * osf)
        x = x.to(complex_dtype)
        xp = torch.cat([state["tail"], x,
                        torch.zeros(K + osf, dtype=x.dtype, device=x.device)])
        zero = torch.zeros((), dtype=real_dtype, device=x.device)
        p, yprev_ri = state["ptr"], state["yprev_ri"]
        syms, valid = [], []
        for t in range(nsym):
            # a pointer past the block end waits for the next block (an
            # invalid bubble); one below the carried tail re-anchors to
            # the nominal grid
            inlow = p > -(1.0 * osf)
            ready = (p < n) & inlow
            nom = zero + t * osf
            pc = torch.where(ready, p, torch.where(inlow, zero, nom))
            y = interp_window(self.itrp, xp, T, pc)
            ymid = interp_window(self.itrp, xp, T, pc - osf / 2.0)
            yprev = torch.complex(yprev_ri[0], yprev_ri[1])
            e = ted_gardner(yprev, ymid, y)
            dec = torch.clamp(gain * e, -osf / 4.0, osf / 4.0)
            p = torch.where(ready, p + osf - dec,
                            torch.where(inlow, p, nom + osf))
            yprev_ri = torch.where(ready, torch.stack([y.real, y.imag]),
                                   yprev_ri)
            syms.append(torch.where(ready, y, 0.0 * y))
            valid.append(ready)
        return dict(ptr=p - n, yprev_ri=yprev_ri, tail=xp[n:n + T]), \
            (torch.stack(syms), torch.stack(valid))
