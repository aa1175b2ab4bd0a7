"""Real-time spectrum analyser (PyTorch), ported from
``libtsd_tpu/ops/spectrum.py``: a streaming block spectrum with
exponential averaging, windowing and frequency-sweep composition.

Parity: rt_spectrum / SpectrumConfig, core/src/fourier/fourier.cc:1150-1337,
core/include/tsd/fourier.hpp:908-957.  The reference's OpenMP loop over
sub-FFTs (fourier.cc:1242-1248) is one batched ``torch.fft``.

Sweep mode (fourier.cc:1188-1196, 1259-1266): an input block of
``nsubs * N`` samples holds ``nsubs`` consecutive captures, each taken at
an LO frequency stepped by ``sweep_step`` bins.  Each capture's fftshifted
power spectrum is masked (``mask_hf`` bins at the band edges, ``mask_bf``
around DC) and added into its span of the composite ``Ns``-bin spectrum;
the per-bin hit count normalises overlapping spans.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..block import Block
from ..config import complex_dtype, device as _device, real_dtype
from .window import window as make_window

__all__ = ["SpectrumConfig", "RtSpectrum"]


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    """Parity: SpectrumConfig, fourier.hpp:908-949 (BS = nsubs * N)."""
    N: int = 1024             # FFT size of a capture (reference Nf = BS/nsubs)
    navg: int = 4             # exponential averaging factor (blocks)
    window: str = "hn"
    nsubs: int = 1            # captures per input block (sweep positions)
    sweep_step: int = 0       # LO step between captures, in bins (0 = off)
    mask_hf: int = 0          # masked bins at each band edge
    mask_bf: int = 0          # masked bins around DC (2 mask_bf in all)

    @property
    def sweep_active(self) -> bool:
        return self.nsubs > 1 and self.sweep_step > 0

    @property
    def Ns(self) -> int:
        """Composite spectrum size (parity: SpectrumConfig::Ns)."""
        if self.sweep_active:
            return self.N + (self.nsubs - 1) * self.sweep_step
        return self.N


class RtSpectrum(Block):
    """step(state, x) -> (state, spectrum_db).

    Without sweep: the last axis of x is a multiple of N; the output is the
    exponentially averaged fftshifted power spectrum (N bins, dB).  With
    sweep: the last axis is a multiple of nsubs N (one whole sweep a
    block); the output is the composite Ns-bin spectrum (dB).  Leading axes
    are independent channels."""

    def __init__(self, win: torch.Tensor, mask: torch.Tensor,
                 cnt: torch.Tensor, cfg: SpectrumConfig):
        super().__init__()
        self.register_buffer("win", win)
        self.register_buffer("mask", mask)
        self.register_buffer("cnt", cnt)     # hits per composite bin
        self.cfg = cfg

    @classmethod
    def create(cls, cfg: SpectrumConfig, device="cuda") -> "RtSpectrum":
        dev = _device(device)
        N = cfg.N
        w = np.asarray(make_window(cfg.window, N, sym=False), np.float64)
        # unit window energy a bin, so that the total power is kept
        # (fourier.cc:1203-1205)
        w = w * np.sqrt(N / np.sum(w * w))
        mask = np.ones(N, np.float32)
        if cfg.mask_hf > 0:
            mask[:cfg.mask_hf] = 0.0
            mask[-cfg.mask_hf:] = 0.0
        if cfg.mask_bf > 0:
            mask[N // 2 - cfg.mask_bf:N // 2 + cfg.mask_bf] = 0.0
        cnt = np.zeros(cfg.Ns, np.float32)
        if cfg.sweep_active:
            for i in range(cfg.nsubs):
                cnt[i * cfg.sweep_step:i * cfg.sweep_step + N] += mask
            cnt = np.maximum(cnt, 1.0)     # fourier.cc:1195
        else:
            cnt[:] = 1.0

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=real_dtype,
                                   device=dev)
        return cls(t(w), t(mask), t(cnt), cfg)

    def init(self):
        return torch.zeros((self.cfg.Ns,), dtype=real_dtype,
                           device=self.win.device)      # averaged power

    def step(self, state, x: torch.Tensor):
        cfg = self.cfg
        N = cfg.N
        n = x.shape[-1]
        lead = tuple(x.shape[:-1])
        if not cfg.sweep_active:
            if n % N:
                raise ValueError(f"RtSpectrum: length {n} is not a "
                                 f"multiple of N={N}")
            frames = x.reshape(*lead, n // N, N)
            X = torch.fft.fft(frames.to(complex_dtype) * self.win, dim=-1)
            P = torch.fft.fftshift(torch.mean(X.abs() ** 2, dim=-2),
                                   dim=-1) * self.mask / N
        else:
            BS = cfg.nsubs * N
            if n % BS:
                raise ValueError(f"RtSpectrum: length {n} is not a "
                                 f"multiple of nsubs * N = {BS}")
            # (sweeps, nsubs, N): row i of a sweep was captured at LO
            # position i
            frames = x.reshape(*lead, n // BS, cfg.nsubs, N)
            X = torch.fft.fft(frames.to(complex_dtype) * self.win, dim=-1)
            Psub = torch.fft.fftshift(torch.mean(X.abs() ** 2, dim=-3),
                                      dim=-1) * self.mask   # (nsubs, N)
            P = torch.zeros(lead + (cfg.Ns,), dtype=real_dtype,
                            device=x.device)
            for i in range(cfg.nsubs):     # nsubs static offsets
                o = i * cfg.sweep_step
                P[..., o:o + N] += Psub[..., i, :]
            P = P / (self.cnt * N)
        g = 1.0 / cfg.navg
        avg = (1 - g) * state + g * P
        return avg, 10.0 * torch.log10(avg + 1e-30)
