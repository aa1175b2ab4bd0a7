"""Waveforms: symbol mappings, pulse shaping, theoretical BER (PyTorch),
ported from ``libtsd_tpu/models/waveform.py``.

Parity: FormeOnde and its subclasses (core/src/telecom/modulations.cc:
260-793, core/include/tsd/telecom.hpp:26-339).  Mapping and decisions are
vectorised over whole blocks; pi/4-QPSK alternates by index parity.

Bit order: LSB first within a symbol (parity: symmap_binaire,
modulations.cc:78-106).  The constellation is a complex64 buffer
``symbols`` (the JAX package keeps (2, M) re/im planes, ``symbols_ri``;
``utils.convert`` crosses between the two).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import complex_dtype, device as _device, real_dtype
from ..ops import fir_design as FD
from ..ops.filter_rt import Fir, FirDecim
from ..ops.resample import FirUps, fir_ups_delay

__all__ = [
    "PulseShape", "Waveform", "WaveformInfo", "make_waveform",
    "wf_bpsk", "wf_qpsk", "wf_pi4_qpsk", "wf_psk", "wf_ask", "wf_qam",
    "wf_fsk", "bits_to_symbol_indices", "symbol_indices_to_bits",
    "diff_encode", "diff_decode",
]

_ROT45 = complex(np.exp(1j * np.pi / 4))


# ------------------------------------------------------- symbol mapping

def bits_to_symbol_indices(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Pack k bits (LSB first, last axis) into symbol indices; a trailing
    partial symbol is zero-padded (parity: symmap_binaire,
    modulations.cc:78-106).  Leading axes are kept."""
    n = bits.shape[-1]
    nsymb = (n + k - 1) // k
    lead = tuple(bits.shape[:-1])
    b = torch.cat([bits.to(torch.int32),
                   bits.new_zeros(lead + (nsymb * k - n,),
                                  dtype=torch.int32)], dim=-1)
    weights = 2 ** torch.arange(k, dtype=torch.int32, device=bits.device)
    return (b.reshape(lead + (nsymb, k)) * weights).sum(-1).to(torch.int32)


def symbol_indices_to_bits(idx: torch.Tensor, k: int) -> torch.Tensor:
    """Unpack symbol indices (last axis) to bits, LSB first (parity:
    symdemap_binaire): (..., n) -> (..., n k) int8."""
    j = torch.arange(k, dtype=idx.dtype, device=idx.device)
    b = (idx[..., None] >> j) & 1
    return b.reshape(*idx.shape[:-1], -1).to(torch.int8)


def diff_encode(idx: torch.Tensor, M: int) -> torch.Tensor:
    """y[n] = (y[n-1] + x[n]) mod M (parity: diff_encode, telecom.cc)."""
    return torch.cumsum(idx, dim=-1) % M


def diff_decode(idx: torch.Tensor, M: int) -> torch.Tensor:
    rest = (idx[..., 1:] - idx[..., :-1]) % M
    return torch.cat([idx[..., :1], rest], dim=-1)


# ---------------------------------------------------------- pulse shaping

@dataclasses.dataclass(frozen=True)
class PulseShape:
    """Pulse-shaping filter spec (parity: SpecFiltreMiseEnForme,
    telecom.hpp:26-121).  type: 'nrz' | 'none' | 'gaussian' | 'rcs'."""

    type: str = "rcs"
    BT: float = 0.8
    beta: float = 0.2

    @classmethod
    def none(cls):
        return cls(type="none")

    @classmethod
    def nrz(cls):
        return cls(type="nrz")

    @classmethod
    def gaussian(cls, BT: float = 0.8):
        return cls(type="gaussian", BT=BT)

    @classmethod
    def rcs(cls, beta: float = 0.2):
        return cls(type="rcs", beta=beta)

    def get_coefs(self, ncoefs: int, osf: int) -> np.ndarray:
        """Parity: SpecFiltreMiseEnForme::get_coefs, modulations.cc:797-856."""
        if osf == 1:
            return np.array([1.0])
        if ncoefs == 0:
            ncoefs = 5 * osf + 1
            if ncoefs % 2 == 0:
                ncoefs += 1
        if self.type == "nrz":
            return np.ones(osf) / osf
        if self.type == "none":
            return np.ones(1)
        if self.type == "gaussian":
            return FD.gaussian_fir_telecom(ncoefs, self.BT, osf)
        if self.type == "rcs":
            return FD.root_raised_cosine(ncoefs, self.beta, osf)
        raise ValueError(f"unknown pulse shape {self.type!r}")

    def matched_taps(self, ncoefs: int, osf: int) -> np.ndarray:
        """Matched-filter taps, energy-normalised: h / sqrt(energy osf)."""
        h = self.get_coefs(ncoefs, osf)
        return h / np.sqrt(np.sum(h * h) * osf)

    def shaping_filter(self, ncoefs: int, R: int, device="cuda") -> FirUps:
        """Upsampling shaping filter, energy-normalised so that input and
        output powers match (parity: filtre_mise_en_forme,
        modulations.cc:858-876)."""
        h = self.get_coefs(ncoefs, R)
        h = h * (np.sqrt(R) / np.sqrt(np.sum(h * h))) / R
        return FirUps.create(h, R, device=device)

    def matched_filter(self, ncoefs: int, osf: int, device="cuda") -> Fir:
        """Matched filter at the sample rate (parity: filtre_adapté)."""
        return Fir.create(self.matched_taps(ncoefs, osf), device=device)

    def matched_filter_decim(self, ncoefs: int, osf: int,
                             device="cuda") -> FirDecim:
        """Matched filter and decimation to the symbol rate (parity:
        filtre_adapté_décimation)."""
        return FirDecim.create(self.matched_taps(ncoefs, osf), osf,
                               device=device)


# -------------------------------------------------------------- waveforms

@dataclasses.dataclass(frozen=True)
class WaveformInfo:
    """Parity: FormeOnde::Infos, telecom.hpp:205-230."""
    is_linear: bool = True
    is_psk: bool = False
    is_ask: bool = False
    is_fsk: bool = False
    is_qam: bool = False
    index: float = 1.0   # FSK modulation index
    M: int = 2
    k: int = 1


def _psk_constellation(M: int) -> np.ndarray:
    # parity: psk_constellation, modulations.cc:43-52 (QPSK offset pi/4)
    if M == 2:
        return np.array([-1.0 + 0j, 1.0 + 0j])
    dec = np.pi / 4 if M == 4 else 0.0
    return np.exp(1j * (dec + 2 * np.pi * np.arange(M) / M))


def _ask_constellation(M: int, K1: float, K2: float) -> np.ndarray:
    # parity: ask_constellation, modulations.cc:54-57
    return (K1 + np.linspace(0, M - 1, M) * (K2 / (M - 1))).astype(complex)


def _qam_constellation(M: int) -> np.ndarray:
    # parity: FormeOndeQAM ctor, modulations.cc:500-530 (column-major grid)
    M2 = int(np.sqrt(M))
    if M2 * M2 != M:
        raise ValueError("QAM M must be a perfect square")
    x = np.arange(M2) / (M2 - 1) * 2 - 1
    re, im = np.meshgrid(x, x, indexing="ij")
    return (re + 1j * im).reshape(M2 * M2, order="F")


class Waveform(torch.nn.Module):
    """A linear waveform (ASK/PSK/QAM) or FSK, with vectorised mapping.
    ``rotating``: pi/4-QPSK, odd symbols use the constellation turned by
    pi/4 (parity: FormeOnde_π4QPSK, modulations.cc:407-489)."""

    def __init__(self, symbols: torch.Tensor, info: WaveformInfo,
                 shaping: PulseShape, rotating: bool = False,
                 name: str = "wf"):
        super().__init__()
        self.register_buffer("symbols", symbols.to(complex_dtype))
        self.info = info
        self.shaping = shaping
        self.rotating = rotating
        self.name = name

    @property
    def device(self) -> torch.device:
        return self.symbols.device

    def on(self, device) -> "Waveform":
        """This waveform on ``device``: itself when it is there already,
        else a copy (``nn.Module.to`` would move the caller's object)."""
        device = _device(device)
        here = self.symbols.device
        if here.type == device.type and device.index in (None, here.index):
            return self
        return Waveform(self.symbols.to(device), self.info, self.shaping,
                        self.rotating, self.name)

    def _rot(self, n: int, parity, angle: complex) -> torch.Tensor:
        """Rotation of n symbols along the last axis; a tensor ``parity``
        may carry leading axes (one parity per row)."""
        if isinstance(parity, torch.Tensor) and parity.ndim:
            parity = parity[..., None]
        odd = (torch.arange(n, device=self.device) + parity) % 2 == 1
        one = torch.ones((), dtype=complex_dtype, device=self.device)
        return torch.where(odd, one * angle, one)

    # --- symbol generation ----------------------------------------------
    def make_symbols(self, bits: torch.Tensor, parity=0) -> torch.Tensor:
        """bits -> I/Q symbols (parity: génère_symboles,
        modulations.cc:108-120).  ``parity``: rotation parity of the first
        symbol of a rotating constellation, carried by streaming
        modulators."""
        idx = bits_to_symbol_indices(bits, self.info.k)
        s = self.symbols[idx.long()]
        if self.rotating and not self.info.is_fsk:
            s = s * self._rot(idx.shape[-1], parity, _ROT45)
        return s

    def gen_samples(self, bits: torch.Tensor, ncoefs: int = 0,
                    osf: int = 8) -> Tuple[torch.Tensor, float]:
        """bits -> shaped I/Q samples; returns (samples, delay in samples)
        (parity: génère_échantillons, modulations.cc:163-207, with the FSK
        phase integration)."""
        symbs = self.make_symbols(bits)
        h = self.shaping.get_coefs(ncoefs, osf)
        nc = len(h)
        nflush = (nc + osf - 1) // osf
        symbs = torch.cat([symbs, symbs.new_zeros(nflush)])
        f = self.shaping.shaping_filter(ncoefs, osf, device=self.device)
        _, y = f.step(f.init_for(symbs), symbs)
        if self.info.is_fsk:
            om_max = np.pi * self.info.index / osf
            # normalised by the constellation extreme, as Modulator does
            vmax = self.symbols.real.abs().max()
            vf = y.real * (om_max / torch.clamp(vmax, min=1e-30))
            y = torch.exp(1j * torch.cumsum(vf, dim=-1)).to(complex_dtype)
        return y, float(fir_ups_delay(nc, osf))

    # --- decisions -------------------------------------------------------
    def _derotate(self, x: torch.Tensor, parity) -> torch.Tensor:
        return x * self._rot(x.shape[-1], parity, _ROT45.conjugate())

    def detect_parity(self, x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pi/4-QPSK rotation parity of the first symbol (last axis; one
        parity per leading row): the one of the two with the lower total
        decision error."""
        def err(p):
            xs = self._derotate(x, p)
            e = ((xs[..., None] - self.symbols).abs() ** 2).min(-1).values
            if mask is not None:
                e = torch.where(mask, e, torch.zeros_like(e))
            return e.sum(-1)
        return (err(1) < err(0)).to(torch.int32)

    def closest(self, x: torch.Tensor, parity=None) -> torch.Tensor:
        """Nearest constellation index (parity: symbole_plus_proche,
        modulations.cc:260-276).  ``parity`` de-rotates a rotating
        constellation, None detects it."""
        if self.info.is_psk and self.info.M == 2 and not self.rotating:
            return (x.real >= 0).to(torch.int32)
        if self.rotating:
            if parity is None:
                parity = self.detect_parity(x)
            x = self._derotate(x, parity)
        d = (x[..., None] - self.symbols).abs() ** 2
        return torch.argmin(d, dim=-1).to(torch.int32)

    def decode_symbols(self, x: torch.Tensor) -> torch.Tensor:
        """I/Q symbols -> bits (parity: decode_symboles,
        modulations.cc:238-250)."""
        return symbol_indices_to_bits(self.closest(x), self.info.k)

    # --- theory ----------------------------------------------------------
    def ber(self, EbN0_db) -> torch.Tensor:
        """Theoretical BER (parity: each FormeOnde::ber; Proakis)."""
        erfc = torch.special.erfc
        e = 10.0 ** (torch.as_tensor(EbN0_db, dtype=real_dtype,
                                     device=self.device) / 10.0)
        M, k = self.info.M, self.info.k
        if self.info.is_fsk:
            if k == 1:
                rho = float(np.sinc(2.0 * self.info.index))
                return 0.5 * erfc(torch.sqrt(e * (1.0 - rho) / 2))
            return 0.5 * erfc(torch.sqrt(e / 2))
        if self.info.is_ask:
            return ((M - 1.0) / M) * erfc(
                torch.sqrt(3.0 * k * e / (M * M - 1.0))) / k
        if self.info.is_qam:
            return (2.0 / k) * (1 - 1 / np.sqrt(M)) * erfc(
                torch.sqrt(3.0 * k * e / (2.0 * (M - 1))))
        b = erfc(torch.sqrt(k * e) * np.sin(np.pi / M)) / k
        return b / 2 if M == 2 else b

    def constellation(self) -> torch.Tensor:
        if self.rotating:
            return torch.cat([self.symbols, self.symbols * _ROT45])
        return self.symbols

    @property
    def excursion(self) -> float:
        return self.info.index if self.info.is_fsk else 1.0


# ---------------------------------------------------------------- factories

def _wf(syms, info, shaping, device, **kw) -> Waveform:
    return Waveform(torch.as_tensor(np.asarray(syms, np.complex64),
                                    device=_device(device)),
                    info, shaping, **kw)


def wf_psk(M: int, shaping: PulseShape = PulseShape(),
           device="cuda") -> Waveform:
    name = f"{M}PSK" if M > 4 else ("BPSK" if M == 2 else "QPSK")
    return _wf(_psk_constellation(M),
               WaveformInfo(is_psk=True, M=M, k=int(np.log2(M))), shaping,
               device, name=name)


def wf_bpsk(shaping: PulseShape = PulseShape(), device="cuda") -> Waveform:
    return wf_psk(2, shaping, device)


def wf_qpsk(shaping: PulseShape = PulseShape(), device="cuda") -> Waveform:
    return wf_psk(4, shaping, device)


def wf_pi4_qpsk(shaping: PulseShape = PulseShape(),
                device="cuda") -> Waveform:
    return _wf(_psk_constellation(4), WaveformInfo(is_psk=True, M=4, k=2),
               shaping, device, rotating=True, name="pi4-QPSK")


def wf_ask(M: int = 2, K1: float = -1.0, K2: float = 2.0,
           shaping: PulseShape = PulseShape.nrz(), device="cuda") -> Waveform:
    return _wf(_ask_constellation(M, K1, K2),
               WaveformInfo(is_ask=True, M=M, k=int(np.log2(M))), shaping,
               device, name=f"{M}-ASK")


def wf_qam(M: int, shaping: PulseShape = PulseShape(),
           device="cuda") -> Waveform:
    return _wf(_qam_constellation(M),
               WaveformInfo(is_qam=True, M=M, k=int(np.log2(M))), shaping,
               device, name=f"QAM{M}")


def wf_fsk(M: int = 2, index: float = 0.4,
           shaping: PulseShape = PulseShape.nrz(), device="cuda") -> Waveform:
    lv = (np.arange(M) / (M - 1)) * 2 - 1      # frequency levels -1..1
    name = (("G" if shaping.type == "gaussian" else "")
            + ("MSK" if index == 0.5 else "FSK"))
    return _wf(lv.astype(complex),
               WaveformInfo(is_linear=False, is_fsk=True, index=index, M=M,
                            k=int(np.log2(M))), shaping, device, name=name)


def make_waveform(name: str, device="cuda", **kw) -> Waveform:
    """Factory by name (parity: forme_onde_* factories,
    telecom.hpp:268-339)."""
    name = name.lower()
    sh = kw.pop("shaping", None)
    if name == "bpsk":
        return wf_bpsk(sh or PulseShape(), device)
    if name == "qpsk":
        return wf_qpsk(sh or PulseShape(), device)
    if name in ("pi4-qpsk", "pi4qpsk", "π4-qpsk"):
        return wf_pi4_qpsk(sh or PulseShape(), device)
    if name == "psk":
        return wf_psk(kw.pop("M", 8), sh or PulseShape(), device)
    if name == "ask":
        return wf_ask(kw.pop("M", 2), shaping=sh or PulseShape.nrz(),
                      device=device, **kw)
    if name == "qam":
        return wf_qam(kw.pop("M", 16), sh or PulseShape(), device)
    if name in ("fsk", "msk", "gfsk", "gmsk"):
        index = kw.pop("index", 0.5 if "msk" in name else 0.4)
        default_sh = (PulseShape.gaussian(kw.pop("BT", 0.8))
                      if name.startswith("g") else PulseShape.nrz())
        return wf_fsk(kw.pop("M", 2), index, sh or default_sh, device)
    raise ValueError(f"unknown waveform {name!r}")
