"""Demodulator pieces (PyTorch), ported from ``libtsd_tpu/models/demod.py``.

Only the quadrature discriminator is ported so far: the frame receiver's
FSK branch needs it.  The non-decision ``Demodulator`` and ``llr`` come
with the FM slice (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["quadrature_discriminator"]


def quadrature_discriminator(x: torch.Tensor,
                             prev: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Instantaneous frequency arg(x[n] conj(x[n-1])) along the last axis
    (parity: the FSK discriminator in demod-ndec.cc and FM demod,
    analogique.cc:18-76).  ``prev`` is the sample before x[0] (default:
    x[0] itself, so the first output is 0)."""
    if prev is None:
        prev = x[..., :1]
    xm1 = torch.cat([prev, x[..., :-1]], dim=-1)
    return torch.angle(x * xm1.conj())
