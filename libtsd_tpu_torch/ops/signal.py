"""Base signal toolbox (PyTorch), ported from ``libtsd_tpu/ops/signal.py``.

Only the exact wrapped-cycles ramp that the modulator and the carrier
loops use is ported so far; the generators and vector utilities are queued
(ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import device as _device, real_dtype

__all__ = ["cycles"]

_L = 4096   # table length of the two-table form (n > 2^16)


def cycles(f, n: int, device="cuda") -> torch.Tensor:
    """Wrapped cycle ramp (f*k) mod 1 for k = 0..n-1, float32.

    A host scalar f is multiplied in float64 and reduced mod 1 BEFORE the
    float32 cast, so the phase handed to sin/cos keeps full float32
    precision for any n (the float32 product f*k alone is ~1e-5 cycle off
    by k ~ 2000).  Above 2^16 samples two float64-exact tables, t1[q] =
    (f L q) mod 1 and t0[r] = (f r) mod 1, are summed in float32 and
    reduced again: the same values as the JAX package.  A tensor f is
    multiplied in float32 on its own device."""
    if isinstance(f, torch.Tensor):
        k = torch.arange(n, dtype=real_dtype, device=f.device)
        return torch.remainder(f.to(real_dtype) * k, 1.0)
    dev = _device(device)
    f = np.float64(f)
    if n <= (1 << 16):
        c = np.mod(f * np.arange(n, dtype=np.float64), 1.0)
        return torch.as_tensor(c.astype(np.float32), device=dev)
    nq = -(-n // _L)
    t0 = np.mod(f * np.arange(_L, dtype=np.float64), 1.0).astype(np.float32)
    t1 = np.mod(f * _L * np.arange(nq, dtype=np.float64),
                1.0).astype(np.float32)
    c = torch.remainder(torch.as_tensor(t1, device=dev)[:, None]
                        + torch.as_tensor(t0, device=dev)[None, :], 1.0)
    return c.reshape(-1)[:n]
