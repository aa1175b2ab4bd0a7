"""Random signal generation on ``torch.Generator`` (PyTorch), ported from
``libtsd_tpu/ops/rng.py``.

Parity: tsd.hpp:1001-1092 (randn/randu/randb/randi and a global
generator).  The explicit-generator functions come first; ``Rng`` is the
stateful convenience wrapper that mirrors the reference's global
generator.  A torch generator draws other numbers than a JAX key of the
same seed: compare distributions, never draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import complex_dtype, device as _device, real_dtype

__all__ = ["randn", "randcn", "randu", "randb", "randi", "Rng",
           "default_rng", "seed"]


def randn(gen: torch.Generator, n, *shape) -> torch.Tensor:
    """Standard normal, float32, on the generator's device."""
    return torch.randn((n, *shape), generator=gen, dtype=real_dtype,
                       device=gen.device)


def randcn(gen: torch.Generator, n, *shape) -> torch.Tensor:
    """Circular complex normal of unit total variance (real and imaginary
    parts each N(0, 1/2))."""
    s = 1.0 / np.sqrt(2.0)
    re = randn(gen, n, *shape) * s
    im = randn(gen, n, *shape) * s
    return torch.complex(re, im).to(complex_dtype)


def randu(gen: torch.Generator, n, *shape, lo: float = -1.0,
          hi: float = 1.0) -> torch.Tensor:
    """Uniform in [lo, hi) (the reference's randu(n) is in [-1, 1])."""
    u = torch.rand((n, *shape), generator=gen, dtype=real_dtype,
                   device=gen.device)
    return lo + (hi - lo) * u


def randb(gen: torch.Generator, n, *shape) -> torch.Tensor:
    """Random booleans (bits)."""
    return torch.rand((n, *shape), generator=gen, device=gen.device) < 0.5


def randi(gen: torch.Generator, M: int, n, *shape) -> torch.Tensor:
    """Uniform integers in [0, M), int32."""
    return torch.randint(0, M, (n, *shape), generator=gen,
                         dtype=torch.int32, device=gen.device)


class Rng:
    """Stateful convenience wrapper around one ``torch.Generator`` (the
    reference's ``generateur_aleatoire``), made at the first draw on
    ``device``."""

    def __init__(self, seed: int = 0, device="cuda"):
        self._seed = seed
        self._device = device
        self._gen = None

    @property
    def gen(self) -> torch.Generator:
        if self._gen is None:
            self._gen = torch.Generator(
                device=_device(self._device)).manual_seed(self._seed)
        return self._gen

    def randn(self, n, *shape):
        return randn(self.gen, n, *shape)

    def randcn(self, n, *shape):
        return randcn(self.gen, n, *shape)

    def randu(self, n, *shape, lo=-1.0, hi=1.0):
        return randu(self.gen, n, *shape, lo=lo, hi=hi)

    def randb(self, n, *shape):
        return randb(self.gen, n, *shape)

    def randi(self, M, n, *shape):
        return randi(self.gen, M, n, *shape)


default_rng = Rng(0)


def seed(s: int, device="cuda"):
    """Re-seed the global convenience generator."""
    global default_rng
    default_rng = Rng(s, device=device)
    return default_rng
