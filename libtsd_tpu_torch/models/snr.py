"""SNR estimators (PyTorch), ported from ``libtsd_tpu/models/snr.py``.

Parity: core/src/telecom/snr.cc.

Vectorized block estimators along the last axis; the reference's
per-sample exponential moment trackers become first-order recursions
solved by log-depth doubling (``ops.filter_rt._first_order_scan``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import device as _device, real_dtype
from ..ops.filter_rt import _first_order_scan

__all__ = ["snr_matzner", "snr_bpsk_abs", "MatznerTracker"]


def snr_matzner(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matzner M2/M4 moment SNR estimator over a block; returns (S, N)
    powers (parity: Matzner, snr.cc:9-43 with ke=1, kn=2 i.e. constant
    modulus constellations)."""
    a2 = x.abs() ** 2
    e2 = torch.mean(a2, dim=-1)
    e4 = torch.mean(a2 * a2, dim=-1)
    S = torch.sqrt(torch.clamp(2 * e2 * e2 - e4, min=0.0))
    N = e2 - S
    return S, N


def snr_bpsk_abs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """|real| based estimator for BPSK (parity: BPSKAbsSNREstimator,
    snr.cc:45-90): S = mean(|re|)^2, N = E|x|^2 - S."""
    re = x.real if x.is_complex() else x
    m = torch.mean(re.abs(), dim=-1)
    e2 = torch.mean(x.abs() ** 2, dim=-1)
    S = m * m
    N = torch.clamp(e2 - S, min=1e-30)
    return S, N


class MatznerTracker:
    """Streaming Matzner estimator with forget factor gamma, returning
    per-sample S and N tracks (parity: Matzner::step's exponential
    averaging, snr.cc:9-43).  Time runs along the last axis; leading axes
    are independent channels, whose state takes those axes after a step.

    Reference-parity NaN behaviour (default): wherever 2*e2^2 - e4 goes
    negative the reference's sqrt returns NaN and so does this tracker:
    during warm-up from the zero state, and on noise-dominated input, where
    the statistic fluctuates around zero (the JAX module explains both,
    snr.py:40-56).  ``clamp=True`` floors S at 0, like the block
    ``snr_matzner``."""

    def __init__(self, gamma: float = 0.1, clamp: bool = False,
                 device="cuda"):
        self.gamma = gamma
        self.clamp = clamp
        self.device = device

    def step(self, state, x: torch.Tensor):
        e2_0, e4_0 = state
        g = self.gamma
        e2i = x.abs() ** 2
        e4i = e2i * e2i
        e2 = _first_order_scan(1 - g, g * e2i, e2_0)
        e4 = _first_order_scan(1 - g, g * e4i, e4_0)
        stat = 2 * e2 * e2 - e4
        if self.clamp:
            S = torch.sqrt(torch.clamp(stat, min=0.0))
        else:
            S = torch.sqrt(stat)      # NaN where negative, like the ref
        N = e2 - S
        return (e2[..., -1], e4[..., -1]), (S, N)

    def init(self):
        """The zero state, on ``device`` (the card unless the tracker was
        made with another)."""
        dev = _device(self.device)
        return (torch.zeros((), dtype=real_dtype, device=dev),
                torch.zeros((), dtype=real_dtype, device=dev))
