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
           "demod_state_from_jax", "detector_from_jax", "receiver_from_jax",
           "receiver_state_from_jax"]

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


# the JAX package's detector engines -> the port's
_DET_ENGINES = {"xla": "torch", "pallas": "cuda", "fused": "cuda-fused"}


def _toeplitz_taps(G: np.ndarray, K: int) -> np.ndarray:
    """Taps back from Toeplitz matrices G[d, m, i] = h[d L + i - m]: row
    m = 0 of every block, end to end."""
    return G[:, 0, :].reshape(-1)[:K]


def detector_from_jax(det, device="cuda"):
    """The port's ``Detector`` from a JAX one, engine mapped (``xla`` ->
    ``torch``, ``pallas`` -> ``cuda``, ``fused`` -> ``cuda-fused``): the
    OLA engine's frequency response and plan, the fused engine's taps (row
    0 of its Toeplitz matrices) or the RIF engine's ``Fir``."""
    from ..models.detector import Detector, DetectorConfig
    from ..ops.filter_rt import MovingAverage, OlaFft
    from ..ops.kernels.detfront import DetFront, _taps_mats
    device = _device(device)
    fields = dataclasses.asdict(det.cfg)
    fields["engine"] = _DET_ENGINES[fields["engine"]]
    cfg = DetectorConfig(**fields)
    c = det.corr
    if hasattr(c, "H_ri"):
        H = from_ri(np.array(c.H_ri, np.float32)).to(device)
        corr = OlaFft(H, Ne=int(c.Ne), Nf=int(c.Nf), M=int(c.M),
                      engine=_DET_ENGINES[c.engine],
                      complex_taps=bool(c.complex_taps),
                      precision=str(c.precision))
    elif hasattr(c, "Gr"):
        G = np.array(c.Gr, np.float64) + 1j * np.array(c.Gi, np.float64)
        hp, M, D, _ = _taps_mats(_toeplitz_taps(G, int(c.M)))
        corr = DetFront(torch.as_tensor(hp, device=device), M, D)
    else:
        corr = fir_from_jax(c, device)
    return Detector(corr=corr, energy=MovingAverage(int(det.energy.K),
                                                    device=device),
                    pattern_norm=float(det.pattern_norm), M=int(det.M),
                    cfg=cfg)


def receiver_from_jax(rx, device="cuda"):
    """The port's frame ``Receiver`` from a JAX one: its format, waveforms,
    matched filter, interpolator table, detector (``detector_from_jax``),
    PLL configuration, sizes and ``pll_stride``."""
    from ..models.carrier_rec import Cpll, CpllConfig
    from ..models.frame import FrameFormat, Receiver
    from ..models.modulator import ModConfig
    device = _device(device)
    wf = waveform_from_jax(rx.wf, device)
    hdr_wf = (waveform_from_jax(rx.hdr_wf, device) if rx.hdr_wf is not None
              else None)
    m = rx.fmt.modulation
    mod = ModConfig(wf=None, fe=m.fe, fi=m.fi, fsymb=m.fsymb,
                    real_output=m.real_output, ncoefs=m.ncoefs)
    fmt = FrameFormat(modulation=mod, header_bits=tuple(rx.fmt.header_bits),
                      payload_bits=int(rx.fmt.payload_bits))
    lut = torch.as_tensor(np.array(rx.itp.lut, np.float32), device=device)
    itp = Interpolator(lut, K=int(rx.itp.K), delay_=float(rx.itp.delay_))
    pll = Cpll(CpllConfig(**dataclasses.asdict(rx.pll.cfg)), wf=wf)
    return Receiver(det=detector_from_jax(rx.det, device),
                    mf=fir_from_jax(rx.mf, device), pll=pll, wf=wf,
                    hdr_wf=hdr_wf, itp=itp, fmt=fmt,
                    nsym_header=rx.nsym_header,
                    nsym_payload=rx.nsym_payload, frame_len=rx.frame_len,
                    hist_len=rx.hist_len, mod_delay=rx.mod_delay,
                    dt_mod=rx.dt_mod, pll_stride=rx.pll_stride)


def receiver_state_from_jax(state: Mapping, device="cuda") -> dict:
    """A JAX frame ``Receiver`` state (one channel, or channels stacked by
    ``vmap``) as the port's, key for key and shape for shape: ``det``
    (``corr``, ``en``, ``tail_c``, ``tail_e``, ``seg_prev`` with ``m``,
    ``pe``, ``ok_left``, ``ref5``), ``hist``, ``phi0`` and ``pending`` (a
    ``Detection``)."""
    from ..models.detector import Detection
    device = _device(device)

    def conv(a):
        if isinstance(a, Mapping):
            return {k: conv(v) for k, v in a.items()}
        if hasattr(a, "position") and hasattr(a, "valid"):
            return Detection(**{f.name: conv(getattr(a, f.name))
                                for f in dataclasses.fields(Detection)})
        return torch.as_tensor(np.array(a), device=device)
    return conv(state)
