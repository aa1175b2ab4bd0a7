"""Sampled continuous-time functions and their Fourier transforms
(PyTorch), ported from ``libtsd_tpu/ops/ct.py``.

Parity: core/include/tsd/ct.hpp:16-122, core/src/ct.cc
(FonctionEchantillonnée / TF): a function sampled on a uniform time grid,
evaluated, resampled, and its continuous spectrum approximated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from ..config import complex_dtype, device as _device, real_dtype

__all__ = ["SampledFunction", "sample_function", "dirichlet"]


@dataclasses.dataclass(frozen=True)
class SampledFunction:
    """A function sampled uniformly on [t0, t1] (parity:
    FonctionEchantillonnée); ``values`` is a tensor, time on its last
    axis."""
    values: torch.Tensor
    t0: float
    t1: float

    @property
    def n(self) -> int:
        return self.values.shape[-1]

    @property
    def fs(self) -> float:
        return (self.n - 1) / (self.t1 - self.t0)

    def times(self) -> torch.Tensor:
        return torch.linspace(self.t0, self.t1, self.n, dtype=real_dtype,
                              device=self.values.device)

    def __call__(self, t) -> torch.Tensor:
        """Linear interpolation at arbitrary times."""
        t = torch.as_tensor(t, dtype=real_dtype, device=self.values.device)
        pos = (t - self.t0) * self.fs
        i = torch.clamp(torch.floor(pos).to(torch.int64), 0, self.n - 2)
        frac = pos - i
        return ((1 - frac) * self.values[..., i]
                + frac * self.values[..., i + 1])

    def fourier(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Continuous FT approximation: (freqs_Hz, spectrum), with the dt
        scaling and the phase referred to t0 (parity: TF, ct.cc)."""
        dt = 1.0 / self.fs
        X = torch.fft.fftshift(torch.fft.fft(self.values, dim=-1),
                               dim=-1) * dt
        f = torch.fft.fftshift(torch.fft.fftfreq(
            self.n, dt, dtype=real_dtype, device=self.values.device))
        X = X * torch.exp(-2j * np.pi * f * self.t0).to(complex_dtype)
        return f, X

    def energy(self) -> torch.Tensor:
        return torch.sum(self.values.abs() ** 2) / self.fs


def sample_function(fn: Callable, t0: float, t1: float, n: int,
                    device="cuda") -> SampledFunction:
    """Sample fn (a function of a time tensor) on n points of [t0, t1]
    (parity: échantillonne)."""
    t = torch.linspace(t0, t1, n, dtype=real_dtype, device=_device(device))
    return SampledFunction(values=fn(t), t0=t0, t1=t1)


def dirichlet(N: int, omega, device="cuda") -> torch.Tensor:
    """Dirichlet kernel sin((N + 1/2) w) / sin(w / 2), 2N + 1 at w = 0
    (parity: Dirichlet, core/src/divers.cc:21-37).  A tensor omega stays on
    its device; other input goes to ``device``."""
    dev = omega.device if isinstance(omega, torch.Tensor) else _device(device)
    w = torch.remainder(torch.as_tensor(omega, dtype=real_dtype, device=dev),
                        2 * np.pi)
    s = torch.sin(w / 2)
    safe = s.abs() > 1e-7
    return torch.where(safe,
                       torch.sin((N + 0.5) * w) / torch.where(
                           safe, s, torch.ones_like(s)),
                       torch.full_like(s, 2.0 * N + 1.0))
