"""Channel models: AWGN, propagation emulator (ECP), dispersive fading,
thermal noise (PyTorch), ported from ``libtsd_tpu/models/channel.py``.

Parity: core/src/telecom/telecom.cc:176-192, ecp.cc:10-115,
simulation.cc:22-168, limits.cc:7.

Random draws come from a ``torch.Generator`` where the JAX package takes a
key (the port's ``ops/rng.py`` convention); the generator must live on the
signal's device.  Its streams differ from ``jax.random``'s: compare the
deterministic parts draw for draw and the noise by its statistics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import as_tensor, complex_dtype, real_dtype
from ..ops.fft import delay_signal
from ..ops.signal import cycles

__all__ = [
    "awgn_noise", "awgn", "ChannelConfig", "propagation_channel",
    "doppler_psd", "dispersive_channel", "thermal_noise_power",
    "shannon_capacity",
]


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=real_dtype,
                       device=gen.device)


def awgn_noise(gen: torch.Generator, x: torch.Tensor,
               sigma) -> torch.Tensor:
    """x + sigma*randn per real dimension (parity: bruit_awgn,
    telecom.cc:176-188)."""
    if x.is_complex():
        nr = _normal(gen, x.shape)
        ni = _normal(gen, x.shape)
        return x + sigma * torch.complex(nr, ni).to(complex_dtype)
    return x + sigma * _normal(gen, x.shape)


def awgn(gen: torch.Generator, x: torch.Tensor, EbN0_db: float,
         osf: float = 1.0, k_bits: float = 1.0) -> torch.Tensor:
    """Add noise for a target Eb/N0 given oversampling and bits/symbol.

    sigma = level * sqrt(0.5 * (fe/fbit) / EbN0_lin) with fe/fbit =
    osf / k_bits (parity: ECP::step noise calc, ecp.cc:44-62); the level is
    the RMS over the whole array, every channel together (channel.py:43).
    """
    level = torch.sqrt(torch.mean(x.abs() ** 2))
    ebn0 = 10.0 ** (float(EbN0_db) / 10.0)
    sigma = level * float(np.sqrt(0.5 * (osf / k_bits) / ebn0))
    return awgn_noise(gen, x, sigma)


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Propagation-channel emulator config (parity: ECPConfig,
    telecom.hpp)."""
    fe: float = 1.0
    fsymb: float = 0.25
    fbit: float = 0.25
    Eb_N0: float = 20.0
    freq_offset: float = 0.0      # décalage_fréquence (Hz)
    phase_offset: float = 0.0     # décalage_phase (rad)
    phase_noise_db_hz: float = -np.inf  # phase noise level
    clock_delay: float = 0.0      # délais_horloge (samples; <0 = random)


def propagation_channel(gen: torch.Generator, x: torch.Tensor,
                        cfg: ChannelConfig) -> torch.Tensor:
    """Impairment chain: freq/phase offset -> phase noise -> AWGN -> clock
    delay (parity: ECP::step, ecp.cc:27-105).  Time runs along the last
    axis; the phase ramp and the phase-noise walk are shared by the leading
    axes, as in the JAX package."""
    n = x.shape[-1]
    y = x
    # frequency + phase offset: the ramp in wrapped cycles, float64-exact
    # (ops.signal.cycles), so that it keeps its accuracy at any length
    f = cfg.freq_offset / cfg.fe
    if f != 0.0 or cfg.phase_offset != 0.0:
        cyc = cycles(f, n, device=x.device)
        y = y * torch.exp(1j * (cfg.phase_offset + 2 * np.pi * cyc)
                          ).to(complex_dtype)
    # phase noise (random walk scaled from dBc/Hz)
    if np.isfinite(cfg.phase_noise_db_hz):
        pn_var = 10.0 ** (cfg.phase_noise_db_hz / 10.0) * cfg.fe
        dphi = float(np.sqrt(pn_var)) * _normal(gen, (n,))
        y = y * torch.exp(1j * torch.cumsum(dphi, 0)).to(complex_dtype)
    # AWGN at Eb/N0
    y = awgn(gen, y, cfg.Eb_N0, osf=cfg.fe / cfg.fbit)
    # clock delay; a negative config draws one per call
    d = cfg.clock_delay
    if d < 0:
        y = delay_signal(y, torch.randint(
            0, int(cfg.fe / cfg.fsymb), (), generator=gen,
            device=gen.device).to(real_dtype))
    elif d:
        y = delay_signal(y, float(d))
    return y


def doppler_psd(f, fd: float, device="cuda") -> torch.Tensor:
    """Classic Jakes Doppler spectrum (parity: doppler_distri,
    simulation.cc:22-42).  ``f``: a tensor (its device) or an array (it goes
    to ``device``)."""
    f = as_tensor(f, real_dtype, device)
    r = torch.where(f.abs() < fd,
                    1.0 / (np.pi * fd * torch.sqrt(
                        torch.clamp(1 - (f / fd) ** 2, min=1e-12))),
                    torch.zeros((), dtype=real_dtype, device=f.device))
    return r


def dispersive_channel(gen: torch.Generator, x: torch.Tensor, fd: float,
                       fe: float = 1.0,
                       rice_factor: float = 0.0) -> torch.Tensor:
    """Flat Rayleigh/Rice fading with Jakes-shaped Doppler (parity:
    CanalDispersif, simulation.cc:44-140: white Gaussian process filtered to
    the Doppler PSD, optional LOS term).

    rice_factor K: 0 = Rayleigh; K>0 adds a unit LOS path with power ratio K.
    """
    n = x.shape[-1]
    # frequency-domain shaping of complex white noise
    gr = _normal(gen, (n,))
    gi = _normal(gen, (n,))
    g = torch.complex(gr, gi) / np.sqrt(2)
    freqs = torch.fft.fftfreq(n, device=x.device).to(real_dtype) * fe
    shape = torch.sqrt(doppler_psd(freqs, max(fd, fe / n)))
    fad = torch.fft.ifft(torch.fft.fft(g) * shape)
    fad = fad / torch.sqrt(torch.mean(fad.abs() ** 2) + 1e-30)
    if rice_factor > 0:
        K = rice_factor
        fad = float(np.sqrt(K / (K + 1))) + fad * float(np.sqrt(1 / (K + 1)))
    return x * fad.to(complex_dtype)


def thermal_noise_power(bandwidth_hz: float, temp_k: float = 290.0) -> float:
    """Thermal noise power in Watts = k_B * T * B (parity:
    simulation.cc:141+)."""
    kb = 1.380649e-23
    return kb * temp_k * bandwidth_hz


def shannon_capacity(snr_db: float, bandwidth_hz: float = 1.0) -> float:
    """C = B log2(1 + SNR) (parity: limits.cc:7)."""
    return bandwidth_hz * float(np.log2(1 + 10 ** (snr_db / 10.0)))
