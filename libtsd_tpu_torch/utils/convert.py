"""Turn the JAX package's block parameters into the port's blocks.

Leaves are copied with ``np.array`` (a JAX array's host view is
read-only), so this module needs neither jax nor
``libtsd_tpu``: pass a JAX ``Fir`` (any object with the attributes below)
or a mapping of its leaves as numpy arrays.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from ..config import from_ri
from ..ops.filter_rt import Fir

__all__ = ["fir_from_jax"]


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def fir_from_jax(src, device=None) -> Fir:
    """Build the port's ``Fir`` on ``device`` from a JAX ``Fir`` or its
    leaves ``{"G_", "K", "complex_taps", "precision"}``.  ``G_`` is
    (D, L, L) real taps, or (2, D, L, L) re/im planes when
    ``complex_taps``."""
    G_ = np.array(_field(src, "G_"))
    G = (from_ri(G_) if bool(_field(src, "complex_taps"))
         else torch.as_tensor(G_.astype(np.float32)))
    return Fir(G.to(device), K=int(_field(src, "K")),
               precision=str(_field(src, "precision")))
