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
           "receiver_state_from_jax", "iir_frame_from_jax", "sos_from_jax",
           "iir_cascade_from_jax", "fm_chain_from_jax",
           "fm_receiver_from_jax", "fm_receiver_state_from_jax",
           "qam16_modem_from_jax", "channelizer_from_jax",
           "channelizer_state_from_jax", "rt_spectrum_from_jax",
           "lms_equalizer_from_jax", "equalizer_state_from_jax",
           "transpo_bb_from_jax", "matzner_state_from_jax",
           "linear_ssm_from_jax"]

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


def _tensor(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _interp_from_jax(itrp, device) -> Interpolator:
    return Interpolator(_tensor(itrp.lut, device, torch.float32),
                        K=int(itrp.K), delay_=float(itrp.delay_))


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
    return DecisionDemodSB(_interp_from_jax(dd.itrp, device),
                           fir_from_jax(dd.mf, device),
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
    itp = _interp_from_jax(rx.itp, device)
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


# ------------------------------------------------ the FM and IIR slice


def iir_frame_from_jax(blk, device="cuda"):
    """The port's ``IirFrame`` from a JAX one (its T, S, Wf, M)."""
    from ..ops.filter_rt import IirFrame
    device = _device(device)
    return IirFrame(*(_tensor(getattr(blk, k), device, torch.float32)
                      for k in ("T", "S", "Wf", "M")))


def sos_from_jax(blk, device="cuda"):
    """The port's ``Sos`` from a JAX one (its sections and gain)."""
    from ..ops.filter_rt import Sos
    device = _device(device)
    return Sos(_tensor(blk.sos, device, torch.float32),
               _tensor(blk.k, device, torch.float32))


def iir_cascade_from_jax(casc, device="cuda"):
    """The port's ``IirCascade`` (kernel #7) from a JAX
    ``IirCascadePallas``: its stacked operators, the same layout."""
    from ..ops.kernels.iir import IirCascade
    device = _device(device)
    return IirCascade.from_operators(
        *(_tensor(getattr(casc, k), device, torch.float32)
          for k in ("T", "S", "W", "M")), k=int(casc.k))


def fm_chain_from_jax(fm, device="cuda"):
    """The port's ``FmChain`` (kernel #8) from a JAX ``FmChainPallas``.
    The JAX class keeps operators, not designs: the channel taps are read
    back from its strided Toeplitz factors G (trailing zeros dropped) and
    the de-emphasis from the first row of its in-frame Toeplitz T, whose
    entries are the impulse response b0, c, c p, ... (float32 values)."""
    from ..ops.kernels.fm import FmChain, _L
    device = _device(device)
    G = np.array(fm.G[0], np.float64)            # (Dr, L, L)
    R = int(fm.R)
    r_min = -(((_L - 1) * R) // _L)
    r_max = G.shape[0] - 1 + r_min
    h = np.zeros((r_max + 1) * _L)
    for kk in range(len(h)):                     # h[k] = G[r - r_min][u, i]
        r = kk // _L
        i = -(-(kk - r * _L) // R)
        h[kk] = G[r - r_min, i * R - (kk - r * _L), i]
    h = h[:np.flatnonzero(h)[-1] + 1]
    t = np.array(fm.T[0, 0], np.float64)         # (b0, c, c p, ...)
    out = FmChain(fm.f0, R, len(h), fm.dev, 0.0, chan_h=h, device=device)
    out.b0, out.c = float(t[0]), float(t[1])
    out.p = float(t[2] / t[1]) if t[1] else 0.0
    return out


def fm_receiver_from_jax(rx, device="cuda"):
    """The port's ``FmReceiver`` from a JAX one: the channel filter's
    polyphase taps, the de-emphasis (b, a) and the configuration."""
    from ..models.receivers import FmReceiver, FmReceiverConfig
    from ..ops.filter_rt import FirDecim, Iir
    device = _device(device)
    cf = rx.chan_filt
    chan = FirDecim(_tensor(cf.P, device, torch.float32), K=int(cf.K),
                    R=int(cf.R))
    de = Iir(_tensor(rx.deemph.b, device, torch.float32),
             _tensor(rx.deemph.a, device, torch.float32))
    return FmReceiver(chan, de,
                      FmReceiverConfig(**dataclasses.asdict(rx.cfg)))


def fm_receiver_state_from_jax(state: Mapping, device="cuda") -> dict:
    """A JAX ``FmReceiver`` state as the port's, key for key and shape for
    shape: ``nco``, ``chan`` (complex input tail), ``prev_ri``, ``de``."""
    device = _device(device)
    return {k: _tensor(v, device) for k, v in state.items()}


def qam16_modem_from_jax(m, device="cuda"):
    """The port's ``Qam16Modem`` from a JAX one: waveform, modulator
    configuration, matched filter, clock recovery (``ClockRec2`` or
    ``ClockRec``, with its interpolator table), PLL configuration, the
    fused ``DecisionDemod2``, ``osf`` and ``rx_mode``."""
    from ..models.carrier_rec import Cpll, CpllConfig
    from ..models.clock_rec import ClockRec, ClockRecConfig
    from ..models.clock_rec2 import ClockRec2
    from ..models.demod_dec import DecDemodConfig
    from ..models.demod_dec2 import DecisionDemod2
    from ..models.modulator import ModConfig, Modulator
    from ..models.receivers import Qam16Modem
    device = _device(device)
    wf = waveform_from_jax(m.wf, device)
    c = m.mod.config
    mod = Modulator.create(ModConfig(wf=wf, fe=c.fe, fi=c.fi, fsymb=c.fsymb,
                                     real_output=c.real_output,
                                     ncoefs=c.ncoefs), device=device)
    crc = ClockRecConfig(**dataclasses.asdict(m.cr.cfg))
    kind = ClockRec2 if type(m.cr).__name__ == "ClockRec2" else ClockRec
    cr = kind(_interp_from_jax(m.cr.itrp, device), crc)
    pll = Cpll(CpllConfig(**dataclasses.asdict(m.pll.cfg)), wf=wf)
    d = m.dd2
    dd2 = DecisionDemod2(_interp_from_jax(d.itrp, device),
                         fir_from_jax(d.mf, device), wf,
                         DecDemodConfig(**dataclasses.asdict(d.cfg)))
    return Qam16Modem(wf, mod, fir_from_jax(m.mf, device), cr, pll, dd2,
                      osf=int(m.osf), rx_mode=str(m.rx_mode))


# ------------------------------------------ the spectral and channelizer slice


def channelizer_from_jax(src, device="cuda"):
    """The port's ``Channelizer`` from a JAX one, or from its leaves
    ``{"P", "M"}``: the (M, K) branch taps and M."""
    from ..models.channelizer import Channelizer
    return Channelizer(_tensor(_field(src, "P"), _device(device),
                               torch.float32), int(_field(src, "M")))


def channelizer_state_from_jax(state: Mapping, device="cuda") -> dict:
    """A JAX ``Channelizer`` state, whose ``hist`` (2, M, K-1) and ``raw``
    (2, M-1) are re/im planes, as the port's complex64 ``hist`` (M, K-1)
    and ``raw`` (M-1,)."""
    device = _device(device)
    return {k: from_ri(np.array(state[k])).to(device)
            for k in ("hist", "raw")}


def rt_spectrum_from_jax(src, device="cuda"):
    """The port's ``RtSpectrum`` from a JAX one, or from its leaves
    ``{"win", "mask", "cnt", "cfg"}``: window, mask, hit counts and the
    ``SpectrumConfig`` (its fields copied)."""
    from ..ops.spectrum import RtSpectrum, SpectrumConfig
    device = _device(device)
    cfg = _field(src, "cfg")
    return RtSpectrum(*(_tensor(_field(src, k), device, torch.float32)
                        for k in ("win", "mask", "cnt")),
                      SpectrumConfig(**dataclasses.asdict(cfg)))


def lms_equalizer_from_jax(eq, device="cuda"):
    """The port's ``LmsEqualizer`` from a JAX one: its waveform (see
    :func:`waveform_from_jax`) and its configuration."""
    from ..models.equalizer import LmsEqualizer
    return LmsEqualizer(waveform_from_jax(eq.wf, device),
                        structure=str(eq.structure), errf=str(eq.errf),
                        K=int(eq.K), alpha=float(eq.alpha), N1=int(eq.N1),
                        N2=int(eq.N2), ref_mode=bool(eq.ref_mode))


def equalizer_state_from_jax(state: Mapping, device="cuda") -> dict:
    """A JAX ``LmsEqualizer`` state as the port's, key for key: the taps
    ``h_fwd`` (and ``h_bwd``), real in ``ref_mode`` and complex64
    otherwise, the windows ``wnd`` (and ``wnd_d``) and the int32 ``cnt``."""
    device = _device(device)
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in state.items()}


def transpo_bb_from_jax(tb, device="cuda"):
    """The port's ``TranspoBB`` from a JAX one: its image filter (see
    :func:`fir_from_jax`), configuration and ``real_input``."""
    from ..models.spread import TranspoBB, TranspoBBConfig
    return TranspoBB(fir_from_jax(tb.img_filter, device),
                     TranspoBBConfig(**dataclasses.asdict(tb.cfg)),
                     real_input=bool(tb.real_input))


def matzner_state_from_jax(state, device="cuda") -> tuple:
    """A JAX ``MatznerTracker`` state (e2, e4), 0-d or one per channel, as
    the port's float32 tensors."""
    device = _device(device)
    return tuple(torch.as_tensor(np.array(v, np.float32), device=device)
                 for v in state)


def linear_ssm_from_jax(ssm):
    """The port's ``LinearSSM`` from a JAX one: its A, C, Q and R as host
    arrays (the model keeps them on the host, as the JAX one does)."""
    from ..models.kalman import LinearSSM
    return LinearSSM(*(np.array(getattr(ssm, k)) for k in "ACQR"))
