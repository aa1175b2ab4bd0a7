"""Filter analysis: frequency/phase/group-delay responses, impulse/step
responses, lobe metrics, pole-zero data, filter-type classification.

Parity: core/src/filtrage/filtre-analyse.cc:280-331, filtre-plot.cc,
core/include/tsd/filtrage.hpp:474-534 (AnalyseFiltre), frmag/frphase/
frgroup/repimp/repech.

Design-time, host numpy: a copy of ``libtsd_tpu/ops/filter_analysis.py``
(tests/test_torch_wavelet.py holds the two equal), on the port's
``ops.poly``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from .poly import freq_response_ba, group_delay_ba

__all__ = [
    "frmag", "frphase", "frgroup", "repimp", "repech",
    "FilterAnalysis", "analyze_filter", "analyze_window", "filter_type_of",
]


def _as_ba(h) -> Tuple[np.ndarray, np.ndarray]:
    """Accept FIR taps, (b, a) tuple, or a ZPK object."""
    if isinstance(h, tuple) and len(h) == 2:
        return np.asarray(h[0]), np.asarray(h[1])
    if hasattr(h, "to_ba"):
        return h.to_ba()
    return np.asarray(h), np.array([1.0])


def frmag(h, npts: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """Magnitude response on [0, 0.5) (parity: frmag,
    filtre-analyse.cc)."""
    b, a = _as_ba(h)
    fr = np.linspace(0, 0.5 - 0.5 / npts, npts)
    return fr, np.abs(freq_response_ba(b, a, fr))


def frphase(h, npts: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """Unwrapped phase response (parity: frphase)."""
    b, a = _as_ba(h)
    fr = np.linspace(0, 0.5 - 0.5 / npts, npts)
    return fr, np.unwrap(np.angle(freq_response_ba(b, a, fr)))


def frgroup(h, npts: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """Group delay in samples (parity: frgroup)."""
    b, a = _as_ba(h)
    fr = np.linspace(1e-4, 0.5 - 0.5 / npts, npts)
    return fr, group_delay_ba(b, a, fr)


def repimp(h, n: int = 128) -> np.ndarray:
    """Impulse response (parity: repimp)."""
    b, a = _as_ba(h)
    from scipy.signal import lfilter
    x = np.zeros(n)
    x[0] = 1.0
    return lfilter(b, a, x)


def repech(h, n: int = 128) -> np.ndarray:
    """Step response (parity: repech)."""
    b, a = _as_ba(h)
    from scipy.signal import lfilter
    return lfilter(b, a, np.ones(n))


@dataclasses.dataclass
class FilterAnalysis:
    """Parity: AnalyseFiltre, filtrage.hpp:474-534."""
    main_lobe_width: float = 0.0        # largeur_lp (normalized freq)
    first_sidelobe_atten_db: float = 0.0  # atten_pls
    worst_sidelobe_atten_db: float = 0.0  # atten_ls
    passband_ripple_db: float = 0.0
    dc_gain_db: float = 0.0


def analyze_filter(h, npts: int = 4096) -> FilterAnalysis:
    """Lowpass-style lobe analysis (parity: analyse_filtre /
    filtre_pb_analyse, fenetres.cc:348-430): -3 dB main lobe width, first
    and worst sidelobe attenuations."""
    fr, mag = frmag(h, npts)
    magdb = 20 * np.log10(np.abs(mag) + 1e-30)
    magdb = magdb - magdb[0]
    res = FilterAnalysis(dc_gain_db=float(
        20 * np.log10(np.abs(mag[0]) + 1e-30)))
    # main lobe width: first crossing under -3 dB
    below = np.where(magdb < -3.0)[0]
    if len(below):
        res.main_lobe_width = float(fr[below[0]])
    # find first local minimum (end of main lobe), then sidelobe peaks;
    # a true inter-lobe null must sit well below the passband (guards
    # against float noise in flat regions)
    d = np.diff(magdb)
    minima = np.where((d[:-1] < 0) & (d[1:] >= 0)
                      & (magdb[1:-1] < -6.0))[0] + 1
    if len(minima):
        m0 = minima[0]
        tail = magdb[m0:]
        # first sidelobe = first local max after m0
        dm = np.diff(tail)
        maxima = np.where((dm[:-1] > 0) & (dm[1:] <= 0))[0] + 1
        if len(maxima):
            res.first_sidelobe_atten_db = float(-tail[maxima[0]])
        res.worst_sidelobe_atten_db = float(-tail.max())
        # passband ripple up to the -3 dB point
        if len(below):
            pb = magdb[: below[0]]
            res.passband_ripple_db = float(pb.max() - pb.min())
    return res


def analyze_window(w) -> FilterAnalysis:
    """Window lobe analysis (parity: analyse_fenêtre, fenetres.cc:425-430:
    normalizes to unit sum then analyzes)."""
    w = np.asarray(w, float)
    return analyze_filter(w / w.sum())


def filter_type_of(h, npts: int = 512) -> str:
    """Classify lp/hp/bp/bs by comparing band magnitudes (parity: the
    reference's filter-type classification, filtre-analyse.cc)."""
    fr, mag = frmag(h, npts)
    lo = mag[: npts // 8].mean()
    mid = mag[3 * npts // 8: 5 * npts // 8].mean()
    hi = mag[-npts // 8:].mean()
    ref = max(lo, mid, hi)
    lo, mid, hi = lo / ref, mid / ref, hi / ref
    if lo > 0.7 and hi < 0.3:
        return "lp"
    if hi > 0.7 and lo < 0.3:
        return "hp"
    if mid > 0.7 and lo < 0.3 and hi < 0.3:
        return "bp"
    if lo > 0.7 and hi > 0.7 and mid < 0.3:
        return "bs"
    return "other"
