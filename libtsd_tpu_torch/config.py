"""Dtype policy for the PyTorch port.

float32 / complex64 are the compute dtypes; design-time numerics (filter
design, windows) run in float64 numpy on the host, once.

Complex values are native ``complex64`` tensors.  ``to_ri``/``from_ri``
convert to and from the real ``(2, ...)`` re/im planes layout that the JAX
package stores complex leaves in (``libtsd_tpu.config.to_ri``); they serve
only at that boundary (``utils.convert``, the comparison tests).

The choice between a hand-written CUDA kernel and its plain PyTorch version
is made per call by the device of the tensor (see ``ops/kernels``), so there
is no global "use kernels" switch.

Entry points that make tensors from nothing (``create()``, grids, random
bits) put them on the card unless the caller names another device
(``device="cuda"`` by default); :func:`device` raises when that card is
absent, so nothing carries on on the CPU by accident.
"""
from __future__ import annotations

import numpy as np
import torch

real_dtype = torch.float32
complex_dtype = torch.complex64


def device(dev="cuda") -> torch.device:
    """Resolve a caller's device.  A CUDA device without a card raises
    instead of building on the CPU."""
    dev = torch.device(dev)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass "
            "device='cpu' to build on the CPU (plain PyTorch versions)")
    return dev


def to_ri(x) -> torch.Tensor:
    """Pack a complex array (numpy or tensor) into real (2, ...) float32
    planes."""
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        return torch.as_tensor(
            np.stack([x.real.astype(np.float32), x.imag.astype(np.float32)]))
    return torch.stack([x.real, x.imag]).to(real_dtype)


def from_ri(a) -> torch.Tensor:
    """Unpack (2, ...) float32 planes (numpy or tensor) into complex64."""
    a = torch.as_tensor(a)
    return torch.complex(a[0].to(real_dtype), a[1].to(real_dtype))
