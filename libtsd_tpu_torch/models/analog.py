"""Analog modems: AM (DSB/SSB) and FM modulation and demodulation, the
Hilbert helpers, and the broadcast FM receiver (mono, pilot, stereo)
(PyTorch), ported from ``libtsd_tpu/models/analog.py``.

Parity: core/src/telecom/analogique.cc (FM discriminator :18-76, AM
modulator :78-200, AM demod :200-379, FM demod with de-emphasis :381-658),
core/include/tsd/telecom.hpp:1893-1997.  Signals are processed on the
device of their input.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import complex_dtype, real_dtype
from ..ops.filter_rt import Iir, fir_filter
from ..ops.fir_design import fir_hilbert, fir_lowpass, raised_cosine
from ..ops.iir_design import design_lexp
from ..ops.signal import cycles, downsample

__all__ = [
    "fm_discriminator", "fm_modulate", "fm_demodulate",
    "AMConfig", "am_modulate", "am_demodulate", "hilbert_analytic",
    "hilbert_tfd",
    "fm_broadcast_mono", "fm_broadcast_demodulate", "fm_broadcast_debug",
    "fm_broadcast_multiplex", "fm_pilot_unit",
]


def fm_discriminator(x: torch.Tensor, prev=None) -> torch.Tensor:
    """Polar quadrature discriminator y[n] = arg(x[n] conj(x[n-1]))
    (parity: FMDiscri, analogique.cc:18-66); ``prev`` continues a
    stream."""
    from .demod import quadrature_discriminator
    return quadrature_discriminator(x, prev)


def fm_modulate(audio: torch.Tensor, deviation: float = 0.1) -> torch.Tensor:
    """FM: phase = 2 pi deviation cumsum(audio) (audio in [-1, 1],
    deviation the peak normalised frequency)."""
    ph = 2 * np.pi * deviation * torch.cumsum(audio, dim=-1)
    return torch.exp(1j * ph).to(complex_dtype)


def fm_demodulate(x: torch.Tensor, deviation: float = 0.1,
                  deemph_fc: float = 0.0) -> torch.Tensor:
    """FM demod: discriminator + optional first-order de-emphasis lowpass
    (parity: FMDemod, analogique.cc:381-658)."""
    y = fm_discriminator(x) / (2 * np.pi * deviation)
    if deemph_fc > 0:
        b, a = design_lexp(deemph_fc)
        blk = Iir.create(b, a, device=y.device)
        _, y = blk.step(blk.init_for(y), y)
    return y


def hilbert_tfd(x: torch.Tensor) -> torch.Tensor:
    """Analytic signal by DFT masking, exactly the reference's convention
    (hilbert_tfd, hilbert.cc:59-70): bins n/2..n-1 zeroed, then
    ifft(2 X); DC doubles and Nyquist is dropped, as in the binary."""
    n = x.shape[-1]
    X = torch.fft.fft(x.to(complex_dtype), dim=-1)
    mask = torch.as_tensor(np.r_[np.ones(n // 2), np.zeros(n - n // 2)],
                           dtype=real_dtype, device=x.device)
    return torch.fft.ifft(2.0 * X * mask, dim=-1).to(complex_dtype)


def hilbert_analytic(x: torch.Tensor, ntaps: int = 255) -> torch.Tensor:
    """Real -> analytic signal by FIR Hilbert + delay compensation
    (parity: HilbertTransformeur, hilbert.cc:27-58)."""
    xi = fir_filter(fir_hilbert(ntaps, "hn"), x)
    d = ntaps // 2
    xr = torch.cat([torch.zeros_like(x[..., :d]), x[..., :-d]], dim=-1)
    return torch.complex(xr.to(real_dtype), xi.to(real_dtype))


@dataclasses.dataclass(frozen=True)
class AMConfig:
    """Parity: AMConfig, telecom.hpp:1893-1950."""
    mode: str = "dsb"     # dsb | dsb-sc | usb | lsb
    index: float = 0.5    # modulation index (dsb)
    f_rf: float = 0.25    # carrier frequency (normalised)


def am_modulate(audio: torch.Tensor, cfg: AMConfig) -> torch.Tensor:
    """AM modulation (parity: ModulateurAM, analogique.cc:78-200).  The
    carrier phase is reduced mod 1 in float64 (``cycles``) before the
    float32 trig; the frequency is first rounded to float32, like the
    reference's OHConfig.freq."""
    audio = torch.as_tensor(audio)
    n = audio.shape[-1]
    cyc = cycles(float(np.float32(cfg.f_rf)), n, device=audio.device)
    if cfg.mode == "dsb":
        mx = audio.abs().max() + 1e-30
        return (1 + cfg.index * audio / mx) * torch.cos(2 * np.pi * cyc)
    if cfg.mode in ("dsb-sc", "dsb_suppressed_carrier"):
        return audio * torch.cos(2 * np.pi * cyc)
    if cfg.mode in ("usb", "lsb"):
        z = hilbert_analytic(audio)
        lo = torch.exp(2j * np.pi * cyc).to(complex_dtype)
        # the reference's formula (analogique.cc:121-126) and its sideband
        # labels, which are swapped against the spectrum it produces; kept
        # as the binary has them (golden-diffed)
        if cfg.mode == "usb":
            lo = lo.conj()
        return (z * lo).real
    raise ValueError(f"unknown AM mode {cfg.mode!r}")


def am_demodulate(x: torch.Tensor, cfg: AMConfig,
                  audio_cut: float = 0.1) -> torch.Tensor:
    """AM demodulation: envelope (dsb) or coherent product detection, then
    an audio lowpass (parity: DemodulateurAM, analogique.cc:200-379)."""
    x = torch.as_tensor(x)
    n = x.shape[-1]
    cyc = cycles(float(np.float32(cfg.f_rf)), n, device=x.device)
    h = fir_lowpass(63, audio_cut)
    if cfg.mode == "dsb":
        env = hilbert_analytic(x).abs()
        return fir_filter(h, env - env.mean())
    if cfg.mode in ("dsb-sc", "dsb_suppressed_carrier"):
        return fir_filter(h, x * 2 * torch.cos(2 * np.pi * cyc))
    if cfg.mode in ("usb", "lsb"):
        lo = torch.exp(-2j * np.pi * cyc).to(complex_dtype)
        return fir_filter(h, (hilbert_analytic(x) * lo).real)
    raise ValueError(f"unknown AM mode {cfg.mode!r}")


# ------------------------------------------------ broadcast FM (stereo)

def _fm_broadcast_front(x: torch.Tensor, fe: float):
    """Front half of the broadcast FM receiver (parity: FMDemod,
    analogique.cc:460-478, 515-527): wideband raised-cosine channel FIR
    (+-100 kHz) -> polar discriminator scaled by the reference's 1/75 kHz
    -> 65 kHz lowpass -> decimation R = floor(fe / 130 kHz).  Returns
    (mpx, fech2, R)."""
    y1 = fir_filter(raised_cosine(255, 0.2, 100e3 / fe), x)
    a = fm_discriminator(y1) / 75e3
    a2 = fir_filter(raised_cosine(255, 0.1, 65e3 / fe), a)
    R = max(int(np.floor(fe / (65e3 * 2))), 1)
    a3 = downsample(a2, R) if R > 1 else a2
    return a3, fe / R, R


def fm_broadcast_mono(x: torch.Tensor, fe: float) -> torch.Tensor:
    """Mono (L + R) audio from a broadcast FM IF signal: the front end and
    a 15 kHz audio lowpass (parity: analogique.cc:460-478, 515-527, 583;
    golden-diffed in tests/test_golden_ref4.py)."""
    a3, fech2, _ = _fm_broadcast_front(x, fe)
    return fir_filter(raised_cosine(255, 0.1, 15e3 / fech2), a3)


def fm_pilot_unit(a3: torch.Tensor, fech2: float) -> torch.Tensor:
    """The 19 kHz stereo pilot of a multiplex as a unit-magnitude analytic
    signal: exact downconversion to DC, a 500 Hz lowpass, a complex PLL,
    and the loop phase re-applied (its square is the 38 kHz L-R carrier,
    its cube the 57 kHz RDS carrier)."""
    from .carrier_rec import Cpll, CpllConfig
    f19 = 19e3 / fech2
    n = a3.shape[-1]
    lo = torch.exp(-2j * np.pi * cycles(f19, n, device=a3.device)).to(
        complex_dtype)
    h_bb = raised_cosine(127, 0.1, (500.0 / fech2) / 2)
    xb = fir_filter(h_bb, a3.to(complex_dtype) * lo)
    cpll = Cpll(CpllConfig(ped="tloop", M=1, order=2, BL=250.0 / fech2),
                device=a3.device)
    _, x3 = cpll.step(cpll.init(), xb)
    rot = xb * x3.conj()
    # a floor RELATIVE to the largest |rot| (|rot| scales with the square
    # of the tiny pilot amplitude)
    mag = rot.abs()
    zu = rot / torch.maximum(mag, 1e-3 * mag.max() + 1e-30)
    return zu * lo.conj()


def fm_broadcast_demodulate(x: torch.Tensor, fe: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Broadcast FM stereo receiver -> (L, R) audio (structure parity:
    FMDemod, analogique.cc:381-658, without RDS; the unit-normalised pilot
    squared regenerates the 38 kHz subcarrier)."""
    L, R, _ = fm_broadcast_debug(x, fe)
    return L, R


def fm_broadcast_multiplex(audio_l: torch.Tensor, audio_r: torch.Tensor,
                           fe: float, pilot_level: float = 0.1,
                           rds: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """A broadcast FM stereo IF signal: m = 0.5 (L + R) + pilot
    cos(2 pi 19k t) + 0.5 (L - R) cos(2 pi 38k t) [+ rds], FM-modulated at
    75 kHz excursion."""
    n = audio_l.shape[-1]
    dev = audio_l.device
    c19 = torch.cos(2 * np.pi * cycles(19e3 / fe, n, device=dev))
    c38 = torch.cos(2 * np.pi * cycles(38e3 / fe, n, device=dev))
    m = (0.5 * (audio_l + audio_r) + pilot_level * c19
         + 0.5 * (audio_l - audio_r) * c38)
    if rds is not None:
        m = m + rds
    ph = 2 * np.pi * (75e3 / fe) * torch.cumsum(m, dim=-1)
    return torch.exp(1j * ph).to(complex_dtype)


def fm_broadcast_debug(x: torch.Tensor, fe: float):
    """``fm_broadcast_demodulate`` plus the stages' signals: (L, R, debug)
    with ``mpx``, ``pilot``, ``sub38``, ``lpr``, ``lmr`` and ``fech2``."""
    a3, fech2, _ = _fm_broadcast_front(x, fe)
    h_audio = raised_cosine(255, 0.1, 15e3 / fech2)
    x_lpr = fir_filter(h_audio, a3)
    z19 = fm_pilot_unit(a3, fech2)
    sub38 = (z19 * z19).real
    x_lmr = fir_filter(h_audio, a3 * 2.0 * sub38)
    dbg = dict(mpx=a3, pilot=z19, sub38=sub38, lpr=x_lpr, lmr=x_lmr,
               fech2=torch.full((16,), fech2, dtype=real_dtype,
                                device=a3.device))
    return x_lpr + x_lmr, x_lpr - x_lmr, dbg
