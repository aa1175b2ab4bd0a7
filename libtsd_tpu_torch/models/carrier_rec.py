"""Carrier (phase/frequency) recovery: loop filters, phase-error detectors,
PLLs, FFT peak frequency (PyTorch), ported from
``libtsd_tpu/models/carrier_rec.py``.

Parity: core/src/telecom/carrier-rec.cc and
core/include/tsd/telecom.hpp:774-792.  The per-sample PLL is a Python loop
over the samples (the JAX package's ``lax.scan``), time on the last axis
and any leading axes run as independent loops (the JAX package vmaps);
the PEDs are elementwise functions of the symbols.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype
from ..ops.iir_design import lexp_tc_to_coef
from ..ops.signal import cycles

__all__ = [
    "LoopFilter1", "LoopFilter2", "ped_costas", "ped_ploop", "ped_tloop",
    "ped_decision", "make_ped", "Cpll", "CpllConfig", "Rpll",
    "peak_frequency",
]


def _where(c, a, b):
    """Elementwise select of two states (tensors or tuples of tensors)."""
    if isinstance(a, tuple):
        return tuple(_where(c, x, y) for x, y in zip(a, b))
    return torch.where(c, a, b)


def _angle(z: torch.Tensor) -> torch.Tensor:
    """arg(z), 0 where z == 0, as float32."""
    return torch.where(z.abs() > 0, torch.angle(z),
                       torch.zeros((), dtype=real_dtype, device=z.device))


# ------------------------------------------------------------ loop filters

@dataclasses.dataclass(frozen=True)
class LoopFilter1:
    """First-order loop: theta += alpha e (parity: LF1,
    carrier-rec.cc:38-56; alpha from the time constant)."""
    tau: float = 10.0

    @property
    def alpha(self) -> float:
        return lexp_tc_to_coef(self.tau)

    def init(self, device="cuda"):
        return torch.zeros((), dtype=real_dtype, device=_device(device))

    def step(self, st, e):
        theta = st + self.alpha * e
        return theta, theta


@dataclasses.dataclass(frozen=True)
class LoopFilter2:
    """Second-order loop (parity: LF2, carrier-rec.cc:13-36):
    gamma = 16 eta^2 BL / (1 + 4 eta^2); rho = 4 BL / (1 + 4 eta^2);
    theta += mu; mu += gamma ((1 + rho) e - e_prev)."""
    BL: float = 0.01
    eta: float = 1.0

    @property
    def gamma(self) -> float:
        return (16 * self.eta ** 2 * self.BL) / (1 + 4 * self.eta ** 2)

    @property
    def rho(self) -> float:
        return (4 * self.BL) / (1 + 4 * self.eta ** 2)

    def init(self, device="cuda"):
        z = torch.zeros((), dtype=real_dtype, device=_device(device))
        return (z, z.clone(), z.clone())   # theta, mu, last PED output

    def step(self, st, e):
        theta, mu, last = st
        theta = theta + mu
        mu = mu + self.gamma * ((1 + self.rho) * e - last)
        return (theta, mu, e), theta


# --------------------------------------------------------------- PEDs

_ROT45 = complex(np.exp(1j * np.pi / 4))


def ped_costas(M: int) -> Callable:
    """Costas loop PED for BPSK/QPSK (parity: ped_costa,
    carrier-rec.cc:70-97)."""
    if M == 2:
        return lambda x: x.real * x.imag
    if M != 4:
        raise ValueError("the Costas PED takes M = 2 or 4")

    def f(x):
        z = x * _ROT45
        return z.imag * torch.sign(z.real) - z.real * torch.sign(z.imag)
    return f


def _ref_rot(ref, M: int):
    """conj(ref^M) / |ref^M| (1 when |ref^M| is ~0)."""
    r = complex(ref) ** M
    return r.conjugate() / abs(r) if abs(r) > 1e-9 else 1.0 + 0j


def ped_ploop(M: int, ref=1.0 + 0j) -> Callable:
    """Power loop: Im(x^M conj(ref^M)) / M (parity: ped_ploop,
    carrier-rec.cc:98-105; needs an AGC upstream).  ``ref`` is an ideal
    constellation point, so that x^M is derotated by the constellation's
    M-th-power phase (QPSK at pi/4 offsets has ref^4 = -1)."""
    rot = _ref_rot(ref, M)
    return lambda x: (x ** M * rot).imag / M


def ped_tloop(M: int, ref=1.0 + 0j) -> Callable:
    """Tan loop: arg(x^M conj(ref^M)) / M (parity: ped_tloop,
    carrier-rec.cc:106-113)."""
    rot = _ref_rot(ref, M)

    def f(x):
        a = torch.angle(x ** M * rot) / M
        return torch.where(x.abs() > 0, a, torch.zeros_like(a)).to(
            real_dtype)
    return f


def ped_decision(wf) -> Callable:
    """Decision-directed PED: arg(x conj(nearest symbol)) (parity:
    ped_decision, carrier-rec.cc:114-123).  A rotating constellation
    (pi/4-QPSK) decides on the union constellation, so the PED needs no
    parity."""
    symbols = (wf.constellation() if getattr(wf, "rotating", False)
               else wf.symbols)

    def f(x):
        d = (x[..., None] - symbols).abs() ** 2
        s = symbols[torch.argmin(d, dim=-1)]
        return _angle(x * s.conj())
    return f


def make_ped(kind: str, wf=None, M: Optional[int] = None) -> Callable:
    """Parity: ped_init, carrier-rec.cc:126-154 (with the AUTO choice)."""
    if M is None and wf is not None:
        M = 2 if wf.info.is_ask else wf.info.M
    if kind == "auto":
        if wf is not None and wf.info.is_psk:
            kind = "ploop"
        elif wf is not None and wf.info.is_ask:
            kind = "tloop"
        else:
            kind = "dec"
    ref = 1.0 + 0j
    if wf is not None:
        ref = complex(wf.symbols[wf.info.M - 1 if wf.info.is_ask else 0])
    if kind in ("costa", "costas"):
        return ped_costas(M)
    if kind == "ploop":
        return ped_ploop(M, ref)
    if kind == "tloop":
        return ped_tloop(M, ref)
    if kind in ("dec", "decision"):
        return ped_decision(wf)
    raise ValueError(f"unknown PED {kind!r}")


# ---------------------------------------------------------------- PLLs

@dataclasses.dataclass(frozen=True)
class CpllConfig:
    """Complex PLL config (parity: PLLConfig, telecom.hpp).  ``M`` None
    takes the PED order from the attached waveform (QPSK -> 4), else 2."""
    ped: str = "costas"
    M: Optional[int] = None
    order: int = 2
    BL: float = 0.01      # normalised loop bandwidth (order 2)
    eta: float = 1.0
    tau: float = 10.0     # time constant (order 1)


class Cpll(Block):
    """Complex PLL: y[n] = x[n] exp(-i theta[n]), theta from the PED and
    the loop filter (parity: CPLL, carrier-rec.cc:295-384).  Its state
    lives on ``device`` (the waveform's device when one is attached)."""

    def __init__(self, cfg: CpllConfig, wf=None, device=None):
        super().__init__()
        self.cfg = cfg
        self.wf = wf
        self.device = (_device(device) if device is not None else
                       (wf.device if wf is not None else _device("cuda")))
        # built once: make_ped reads a constellation point to the host
        # (a device sync), which a step must not do
        M = cfg.M
        if M is None and wf is None:
            M = 2     # a PED of the wrong order would not strip the modulation
        self._ped = make_ped(cfg.ped, wf=wf, M=M)

    @property
    def _lf(self):
        return (LoopFilter2(self.cfg.BL, self.cfg.eta)
                if self.cfg.order == 2 else LoopFilter1(self.cfg.tau))

    def init(self):
        return self._lf.init(self.device)

    @staticmethod
    def _theta(st):
        return st[0] if isinstance(st, tuple) else st

    def step(self, state, x: torch.Tensor,
             valid: Optional[torch.Tensor] = None):
        """Time runs along the last axis of x; leading axes are independent
        loops (one per frame of the frame receiver), whose state takes
        those leading axes after the first step.  ``valid``: optional
        per-sample mask shaped like x; the loop freezes on invalid entries
        (e.g. the zero pad of a clock-recovery block)."""
        lf, ped = self._lf, self._ped
        ys = []
        for i in range(x.shape[-1]):
            y = x[..., i] * torch.exp(-1j * self._theta(state)).to(
                complex_dtype)
            st2, _ = lf.step(state, ped(y))
            state = st2 if valid is None else _where(valid[..., i], st2,
                                                     state)
            ys.append(y)
        return state, (torch.stack(ys, dim=-1) if ys
                       else x.to(complex_dtype))

    def _grouped_lf(self, G: int):
        """Loop filter at the per-group update rate (bandwidth scaled by G,
        capped for stability)."""
        cfg = self.cfg
        return (LoopFilter2(min(0.2, cfg.BL * G), cfg.eta)
                if cfg.order == 2 else LoopFilter1(max(1.0, cfg.tau / G)))

    def step_grouped(self, state, x: torch.Tensor, G: int,
                     err_fn=None, aux: tuple = ()):
        """One loop update per group of ``G`` symbols: the current phase is
        applied to the whole group, the per-symbol errors are averaged, and
        the loop filter advances once (per-update bandwidth scaled by G).
        ``err_fn(y, *aux)`` replaces the PED (``step_aided``); ``aux`` are
        tensors grouped alongside x (their time axis is the last one, their
        leading axes broadcast against x's).  Time on the last axis, as in
        :meth:`step`."""
        if G <= 1 and err_fn is None:
            return self.step(state, x)
        lf = self._grouped_lf(G) if G > 1 else self._lf
        if err_fn is None:
            err_fn = self._ped
        n = x.shape[-1]
        ng = -(-n // G)
        pad = ng * G - n

        def prep(a):
            # pad by repeating the last entry: a zero would inject a bogus
            # error term into the group mean
            if pad:
                a = torch.cat([a, a[..., -1:].expand(
                    tuple(a.shape[:-1]) + (pad,))], dim=-1)
            return a.reshape(tuple(a.shape[:-1]) + (ng, G))

        xs = prep(x)
        auxs = tuple(prep(a) for a in aux)
        ys = []
        for g in range(ng):
            th = self._theta(state)
            y = xs[..., g, :] * torch.exp(-1j * th[..., None]).to(
                complex_dtype)
            e = err_fn(y, *(a[..., g, :] for a in auxs)).mean(-1)
            state, _ = lf.step(state, e)
            ys.append(y)
        y = torch.stack(ys, dim=-2)
        return state, y.reshape(tuple(y.shape[:-2]) + (ng * G,))[..., :n]

    def step_aided(self, state, x: torch.Tensor, ref: torch.Tensor,
                   ref_mask: torch.Tensor, G: int = 1):
        """Data-aided phase errors arg(y conj(ref)) where ``ref_mask`` is
        True (known symbols, e.g. a frame's header), the configured PED
        elsewhere.  ``G > 1`` delegates to :meth:`step_grouped`.  Time on
        the last axis; ``ref`` and ``ref_mask`` broadcast against x."""
        ped = self._ped

        def err(y, r, use_r):
            e_da = torch.angle(y * r.conj() + 1e-30)
            return torch.where(use_r, e_da, ped(y))

        if G > 1:
            return self.step_grouped(state, x, G, err_fn=err,
                                     aux=(ref, ref_mask))
        lf = self._lf
        ys = []
        for i in range(x.shape[-1]):
            y = x[..., i] * torch.exp(-1j * self._theta(state)).to(
                complex_dtype)
            state, _ = lf.step(state, err(y, ref[..., i], ref_mask[..., i]))
            ys.append(y)
        return state, torch.stack(ys, dim=-1)


class Rpll(Block):
    """Real-input PLL: downconvert by a nominal frequency, lowpass the
    image, then the complex PLL (parity: RPLL, carrier-rec.cc:201-293).
    ``regen_carrier``: return real(conj(lo) y), the regenerated carrier
    (carrier-rec.cc:242-253), instead of the locked baseband signal."""

    def __init__(self, cpll: Cpll, bb_filter, freq: float = 0.25,
                 regen_carrier: bool = False):
        super().__init__()
        self.cpll = cpll
        self.bb_filter = bb_filter
        self.freq = freq
        self.regen_carrier = regen_carrier

    @classmethod
    def create(cls, freq: float, cfg: Optional[CpllConfig] = None,
               bb_cut: float = 0.1, ncoefs_bb: int = 63,
               regen_carrier: bool = False, device="cuda") -> "Rpll":
        from ..ops.filter_rt import Fir
        from ..ops.fir_design import raised_cosine
        device = _device(device)
        h = raised_cosine(ncoefs_bb, 0.1, bb_cut / 2)
        return cls(cpll=Cpll(cfg or CpllConfig(ped="tloop", M=1, order=2,
                                               BL=0.02), device=device),
                   bb_filter=Fir.create(h, device=device), freq=freq,
                   regen_carrier=regen_carrier)

    def init(self):
        dev = self.cpll.device
        return (torch.zeros((), dtype=real_dtype, device=dev),
                self.bb_filter.init_for(
                    torch.zeros((0,), dtype=complex_dtype, device=dev)),
                self.cpll.init())

    def step(self, state, x: torch.Tensor):
        ph, fst, pst = state
        n = x.shape[-1]
        # NCO phase in cycles, host-float64-exact ramp (signal.cycles)
        cyc = ph / (2 * np.pi) + cycles(self.freq, n, device=x.device)
        lo = torch.exp(-2j * np.pi * cyc).to(complex_dtype)
        xb = x.to(complex_dtype) * lo
        ph = torch.remainder(ph + 2 * np.pi * ((self.freq * n) % 1.0),
                             2 * np.pi)
        fst, xb = self.bb_filter.step(fst, xb)
        pst, y = self.cpll.step(pst, xb)
        if self.regen_carrier:
            y = (lo.conj() * y).real
        return (ph, fst, pst), y


# ----------------------------------------------- coarse frequency tracking

def peak_frequency(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dominant frequency by FFT peak with barycentric refinement; returns
    (freq, snr) (parity: localise_pic_frequence / SuiviPicFrequence,
    carrier-rec.cc:155-199)."""
    n = x.shape[-1]
    a2 = torch.fft.fft(x.to(complex_dtype)).abs() ** 2
    i2 = int(torch.argmax(a2))
    snr = a2[i2] / a2.mean()
    y1, y2, y3 = a2[(i2 - 1) % n], a2[i2], a2[(i2 + 1) % n]
    i2s = float(i2 - n if i2 >= n // 2 else i2)
    d = (y3 - y1) / (y1 + y2 + y3 + 1e-30)
    return (i2s + d) / n, snr
