"""Turn the JAX package's block parameters and states into the port's.

Leaves are copied with ``np.array`` (a JAX array's host view is
read-only), so this module needs neither jax nor ``libtsd_tpu``: pass a
JAX block (any object with the attributes named below) or, for ``Fir``, a
mapping of its leaves as numpy arrays.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from ..config import device as _device, from_ri
from ..ops.filter_rt import Fir
from ..ops.resample import Interpolator

__all__ = ["fir_from_jax", "waveform_from_jax", "demod_sb_from_jax",
           "demod_state_from_jax"]

# the JAX package's batched engines -> the port's
_ENGINES = {"auto": "auto", "xla": "auto", "pallas": "cuda",
            "pallas-interpret": "cuda", "pallas-fused": "cuda-fused",
            "pallas-fused-interpret": "cuda-fused"}


def _field(src, name):
    return src[name] if isinstance(src, Mapping) else getattr(src, name)


def fir_from_jax(src, device="cuda") -> Fir:
    """Build the port's ``Fir`` on ``device`` from a JAX ``Fir`` or its
    leaves ``{"G_", "K", "complex_taps", "precision"}``.  ``G_`` is
    (D, L, L) real taps, or (2, D, L, L) re/im planes when
    ``complex_taps``."""
    G_ = np.array(_field(src, "G_"))
    G = (from_ri(G_) if bool(_field(src, "complex_taps"))
         else torch.as_tensor(G_.astype(np.float32)))
    return Fir(G.to(_device(device)), K=int(_field(src, "K")),
               precision=str(_field(src, "precision")))


def waveform_from_jax(wf, device="cuda"):
    """The port's ``Waveform`` from a JAX one: its (2, M) symbol planes,
    info, pulse shape, rotation and name."""
    from ..models import waveform as W
    sym = from_ri(np.array(wf.symbols_ri, np.float32))
    info = W.WaveformInfo(**dataclasses.asdict(wf.info))
    sh = W.PulseShape(type=wf.shaping.type, BT=wf.shaping.BT,
                      beta=wf.shaping.beta)
    return W.Waveform(sym.to(_device(device)), info, sh,
                      rotating=bool(wf.rotating), name=str(wf.name))


def demod_sb_from_jax(dd, device="cuda"):
    """The port's ``DecisionDemodSB`` from a JAX one: its configuration
    (the JAX engine mapped to the port's: ``xla`` -> ``auto``, ``pallas``
    -> ``cuda``, ``pallas-fused`` -> ``cuda-fused``), the waveform's
    symbols, the matched filter's taps and the interpolator's table."""
    from ..models.demod_sb import DecisionDemodSB, SBDemodConfig
    device = _device(device)
    fields = dataclasses.asdict(dd.cfg)
    fields["engine"] = _ENGINES[fields["engine"]]
    cfg = SBDemodConfig(**fields)
    lut = torch.as_tensor(np.array(dd.itrp.lut, np.float32), device=device)
    itrp = Interpolator(lut, K=int(dd.itrp.K), delay_=float(dd.itrp.delay_))
    return DecisionDemodSB(itrp, fir_from_jax(dd.mf, device),
                           waveform_from_jax(dd.wf, device), cfg)


def demod_state_from_jax(state: Mapping, device="cuda") -> dict:
    """A JAX ``DecisionDemodSB`` state as the port's, key for key and
    shape for shape: the batched layout (``mf``, ``lf``, ``theta``,
    ``gain``, ``ptr``, ``yprev_ri``, ``tail``) or the fused one (``lf``,
    ``theta``, ``gain``, ``ptr``, ``yprev_ri``, ``p_ema``, ``xtail``)."""
    device = _device(device)

    def conv(a):
        if isinstance(a, (tuple, list)):
            return tuple(conv(v) for v in a)
        return torch.as_tensor(np.array(a), device=device)
    return {k: conv(v) for k, v in state.items()}
