"""Matlab-like figure API (host-side).

Ported from ``libtsd_tpu/viz/figure.py``.  Parity: Figure/Figures,
core/include/tsd/vue.hpp:483-830, core/src/vue/figure.cc — the reference
ships its own software rasterizer; here the rendering backend is
matplotlib (host-side by nature, SURVEY §2.7) while preserving the API
capabilities used throughout the library: plot / plot_psd / plot_img /
plot_iq, format strings, subplots, titles, save-to-PNG.

Every function takes tensors (on any device: they come to the host
through ``.detach().cpu().numpy()``) or numpy arrays.  ``plot_filter``,
``plot_plz``, ``plot_eye`` and ``cic_analyse`` run on the port's host ops
(``ops.filter_analysis``, ``ops.resample``, ``ops.poly``).  matplotlib is
the optional ``viz`` extra: ``libtsd_tpu_torch`` itself never imports this
package.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

__all__ = ["Figure", "Figures", "plot_eye", "plot_plz",
           "cic_analyse", "plot_covariance_ellipse", "host"]


def host(a, dtype=None) -> np.ndarray:
    """``a`` as a numpy array on the host: a tensor (any device) through
    ``.detach().cpu().numpy()``, anything else through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


_COLORS = {"b": "tab:blue", "g": "tab:green", "r": "tab:red",
           "m": "tab:purple", "c": "tab:cyan", "y": "tab:olive",
           "k": "black", "a": "gray", "w": "white"}


def _parse_fmt(fmt: str):
    """Parse the reference's format strings like 'b-o', 'r-', 'gs'
    (figure.cc format parsing)."""
    color = None
    line = "-"
    marker = None
    for c in fmt:
        if c in _COLORS:
            color = _COLORS[c]
        elif c in "-|:":
            line = {"-": "-", "|": "-", ":": ":"}[c]
        elif c in "os^vd*+x.":
            marker = c if c != "." else "."
    return color, line, marker


class Figure:
    """One axes with accumulated curves (parity: tsd::vue::Figure)."""

    def __init__(self, title: str = ""):
        self._title = title
        self._ops: List = []
        self._xlabel = ""
        self._ylabel = ""
        self._xunit = None
        self._yunit = None

    # --- plot API --------------------------------------------------------
    def plot(self, x, y=None, fmt: str = "", label: str = ""):
        # Matlab-style plot(y, "b-o") — a string second argument is the
        # format (parity: Figure::plot(y, format), vue.hpp:520-560)
        if isinstance(y, str):
            fmt = y
            y = None
        if y is None:
            y = x
            x = None
        y = host(y)
        x = None if x is None else host(x)
        if np.iscomplexobj(y):
            # distinguishable halves: imag gets a dashed variant of the
            # fmt; suffix labels only when the caller labeled the curve
            # (otherwise every unlabeled complex plot would sprout a
            # legend of blank " (re)"/" (im)" entries)
            lre = f"{label} (re)" if label else ""
            lim = f"{label} (im)" if label else ""
            fim = fmt.replace("-", "--") if "-" in fmt else \
                (fmt + "--" if fmt else "--")
            self._ops.append(("plot", x, y.real, fmt, lre))
            self._ops.append(("plot", x, y.imag, fim, lim))
        else:
            self._ops.append(("plot", x, y, fmt, label))
        return self

    def plot_psd(self, x, fs: float = 1.0, label: str = ""):
        x = host(x)
        n = len(x)
        X = np.fft.fftshift(np.abs(np.fft.fft(x * np.hanning(n))) ** 2)
        f = np.fft.fftshift(np.fft.fftfreq(n, 1.0 / fs))
        self._ops.append(("plot", f, 10 * np.log10(X + 1e-30), "b-", label))
        self._xlabel = "Frequency"
        self._ylabel = "PSD (dB)"
        return self

    def plot_iq(self, x, fmt: str = "b.", label: str = ""):
        x = host(x)
        self._ops.append(("scatter", x.real, x.imag, fmt, label))
        return self

    def plot_img(self, Z, extent=None):
        self._ops.append(("img", host(Z), extent, "", ""))
        return self

    def titles(self, title: str = "", xlabel: str = "", ylabel: str = ""):
        # empty arguments PRESERVE existing labels (titles("t") after
        # plot_psd must not erase the frequency/PSD axis labels)
        self._title = title or self._title
        self._xlabel = xlabel or self._xlabel
        self._ylabel = ylabel or self._ylabel
        return self

    # alias parity with the reference naming
    titres = titles

    def set_units(self, xunit: str = None, yunit: str = None):
        """SI-prefixed tick labels with a shared exponent per axis
        (parity: the reference axes' engineering-unit ticks,
        axes.cc via tsd::vue::unites / viz/units.py)."""
        self._xunit = xunit
        self._yunit = yunit
        return self

    # --- rendering -------------------------------------------------------
    def _render(self, ax):
        has_label = False
        for op in self._ops:
            kind, a, b, fmt, label = op
            color, line, marker = _parse_fmt(fmt or "")
            if kind == "plot":
                xx = np.arange(len(b)) if a is None else a
                ax.plot(xx, b, color=color, linestyle=line, marker=marker,
                        markersize=4, label=label or None, linewidth=1.0)
            elif kind == "scatter":
                ax.plot(a, b, linestyle="", marker=marker or ".",
                        color=color, markersize=3, label=label or None)
                ax.set_aspect("equal", adjustable="datalim")
            elif kind == "img":
                ax.imshow(a, aspect="auto", origin="lower",
                          extent=b, cmap="viridis")
            if label:
                has_label = True
        if self._title:
            ax.set_title(self._title, fontsize=9)
        if self._xlabel:
            ax.set_xlabel(self._xlabel, fontsize=8)
        if self._ylabel:
            ax.set_ylabel(self._ylabel, fontsize=8)
        if has_label:
            ax.legend(fontsize=7)
        for unit, axis in ((self._xunit, ax.xaxis), (self._yunit, ax.yaxis)):
            if unit is not None:
                from .units import si_tick_formatter
                from matplotlib.ticker import FixedFormatter, FixedLocator
                tics = [t for t in axis.get_ticklocs()]
                axis.set_major_locator(FixedLocator(tics))
                axis.set_major_formatter(
                    FixedFormatter(si_tick_formatter(tics, unit)))
        ax.grid(True, alpha=0.3)

    def save(self, path: str, dpi: int = 100):
        fig, ax = plt.subplots(figsize=(8, 4.5))
        self._render(ax)
        fig.tight_layout()
        fig.savefig(path, dpi=dpi)
        plt.close(fig)

    # parity alias
    enregistrer = save

    def show(self, title: str = ""):
        """Send to the active report (parity: Figure::afficher ->
        stdo)."""
        from .report import get_report
        get_report().add_figure(self, title or self._title)

    afficher = show


def plot_eye(x, osf: int, nsym: int = 2, ntraces: int = 200) -> "Figure":
    """Eye diagram: overlay ntraces segments of nsym symbol periods
    (parity: plot_eye, core/src/telecom/graphiques.cc:6-70)."""
    x = host(x)
    seg = nsym * osf
    f = Figure("Eye diagram")
    nmax = min(ntraces, (len(x) - 1) // seg)
    t = np.arange(seg + 1) / osf
    for i in range(nmax):
        tr = x[i * seg: i * seg + seg + 1]
        f._ops.append(("plot", t, np.real(tr), "b-", ""))
    f._xlabel = "Symbol periods"
    return f


class Figures:
    """Subplot collection (parity: tsd::vue::Figures)."""

    def __init__(self):
        self._subs: List[Figure] = []

    def subplot(self, *_ignored) -> Figure:
        f = Figure()
        self._subs.append(f)
        return f

    def save(self, path: str, dpi: int = 100):
        n = max(len(self._subs), 1)
        ncols = 1 if n <= 3 else 2
        nrows = (n + ncols - 1) // ncols
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(8 * ncols, 3 * nrows))
        axes = np.atleast_1d(axes).ravel()
        for f, ax in zip(self._subs, axes):
            f._render(ax)
        for ax in axes[len(self._subs):]:
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(path, dpi=dpi)
        plt.close(fig)

    enregistrer = save

    def show(self, title: str = ""):
        from .report import get_report
        get_report().add_figure(self, title)

    afficher = show


def plot_filter(h, a=(1.0,), complete: bool = False,
                fs: float = 1.0) -> "Figures":
    """One-call filter-design figure (parity: plot_filtre,
    core/src/filtrage/filtre-plot.cc /
    filtrage.hpp:370): magnitude (dB) + impulse response, and with
    ``complete=True`` also phase, group delay, step response and the
    pole/zero map — the reference's standard design-debug panel.

    ``h`` is FIR taps or the numerator of (h, a); frequencies are
    labeled in units of ``fs``."""
    from ..ops import filter_analysis as FA
    ba = (host(h, float), host(a, float))
    f, mag = FA.frmag(ba if len(ba[1]) > 1 else ba[0])
    figs = Figures()
    g = figs.subplot()
    g.plot(f * fs, 20 * np.log10(np.maximum(np.abs(mag), 1e-12)), "b-")
    g.titles(title="Frequency response", xlabel="frequency",
             ylabel="dB")
    g = figs.subplot()
    hi = FA.repimp(ba if len(ba[1]) > 1 else ba[0])
    g.plot(np.asarray(hi), "b-o")
    g.titles(title="Impulse response", xlabel="sample")
    if complete:
        fp, ph = FA.frphase(ba if len(ba[1]) > 1 else ba[0])
        g = figs.subplot()
        g.plot(fp * fs, ph, "b-")
        g.titles(title="Phase", xlabel="frequency", ylabel="rad")
        fg, gd = FA.frgroup(ba if len(ba[1]) > 1 else ba[0])
        g = figs.subplot()
        g.plot(fg * fs, gd, "b-")
        g.titles(title="Group delay", xlabel="frequency",
                 ylabel="samples")
        g = figs.subplot()
        g.plot(np.asarray(FA.repech(ba if len(ba[1]) > 1 else ba[0])),
               "b-")
        g.titles(title="Step response", xlabel="sample")
        figs._subs.append(plot_plz(ba[0], ba[1]))
    return figs


def plot_plz(b, a=(1.0,), title: str = "Poles / zeros") -> Figure:
    """Pole-zero map of a digital transfer function (taps in time order,
    i.e. descending powers of z).  Parity: plot_plz / filtre-plot
    (core/src/filtrage/filtre-plot.cc)."""
    b = np.trim_zeros(host(b, float), "f")
    a = np.trim_zeros(host(a, float), "f")
    zeros = np.roots(b) if len(b) > 1 else np.array([])
    poles = np.roots(a) if len(a) > 1 else np.array([])
    f = Figure(title)
    t = np.linspace(0, 2 * np.pi, 256)
    f.plot(np.cos(t), np.sin(t), "b-")
    if len(zeros):
        f.plot_iq(zeros.astype(complex), "bo", label="zeros")
    if len(poles):
        f.plot_iq(poles.astype(complex), "rx", label="poles")
    f.titles(title, "Re", "Im")
    return f


def covariance_ellipse(P, center=(0.0, 0.0), nsig: float = 1.0,
                       npts: int = 91):
    """Points of the nsig-sigma ellipse of a 2x2 covariance (parity: the
    SSM covariance ellipse, core/src/kalman/kalman.cc:
    656-699).  Returns (xs, ys)."""
    P = host(P, float)
    if P.shape != (2, 2):
        raise ValueError(f"a 2 x 2 covariance, got {P.shape}")
    center = host(center, float)
    w, V = np.linalg.eigh(P)
    w = np.maximum(w, 0.0)
    t = np.linspace(0, 2 * np.pi, npts)
    pts = V @ (nsig * np.sqrt(w)[:, None] * np.vstack([np.cos(t),
                                                       np.sin(t)]))
    return pts[0] + center[0], pts[1] + center[1]


def plot_covariance_ellipse(f: Figure, P, center=(0.0, 0.0),
                            nsig: float = 1.0, fmt: str = "g-",
                            label: str = "") -> Figure:
    xs, ys = covariance_ellipse(P, center, nsig)
    f.plot(xs, ys, fmt, label=label)
    return f


def cic_analyse(config, fe: float = 1.0, fc: float = None,
                comp_ncoefs: int = 0, R2: int = 1, bin_bits: int = 16,
                bout_bits=None):
    """CIC frequency analysis with figures (parity: cic_analyse,
    core/src/reechan/cic.cc:102-327): response at the
    input rate, droop at the passband edge, worst-alias rejection, and —
    if ``comp_ncoefs`` — the droop-compensated response.
    ``bin_bits``/``bout_bits`` set the ADC input / kept output width for
    the Hogenauer register analysis (default 16/16).

    Returns (figures, metrics-dict)."""
    from ..ops.resample import cic_freq, cic_bits, cic_comp_design
    from ..ops.poly import freq_response_ba
    R = config.R
    fs_out = fe / R
    if fc is None:
        fc = 0.25 * fs_out
    fr = np.linspace(0, 0.5, 2048)
    mag = cic_freq(config, fr)
    db = 20 * np.log10(np.maximum(mag, 1e-12))

    droop = cic_freq(config, np.array([fc / fe]))[0]
    # worst alias: image of fc around the first null (1/R)
    alias_f = 1.0 / (R * config.M) - fc / fe
    alias = cic_freq(config, np.array([alias_f]))[0]
    # per-stage integer growth: integrator stage i (1-based) accumulates
    # gain (R M)^i, i.e. ceil(i log2(RM)) extra bits.  The reference's
    # cic_analyse reports only the TOTAL (cic.cc:209-211); the per-stage
    # profile and the Hogenauer register-pruning analysis below are
    # documented improvements (ops/resample.cic_bit_growth).
    from ..ops.resample import cic_bit_growth
    bg = cic_bit_growth(config, bin_bits=bin_bits, bout_bits=bout_bits)
    stage_bits = bg["growth_bits"]
    metrics = dict(
        droop_db=float(20 * np.log10(max(droop, 1e-12))),
        alias_rejection_db=float(-20 * np.log10(max(alias, 1e-12))),
        add_bits=cic_bits(config),
        stage_bits=stage_bits,
        bmax_bits=bg["bmax"],
        prunable_bits=bg["prunable"],
    )

    figs = Figures()
    f1 = figs.subplot()
    f1.plot(fr * fe, db, "b-", label="CIC")
    f1.titles(f"CIC N={config.N} R={R} M={config.M}",
              "frequency", "|H| (dB)")
    fb = figs.subplot()
    fb.plot(np.arange(1, config.N + 1), np.asarray(stage_bits, float),
            "b-o", label="integrator growth")
    fb.titles("per-stage accumulator growth", "stage", "extra bits")
    if comp_ncoefs:
        h = cic_comp_design(config, fe, R2, fc, comp_ncoefs)
        frc = np.linspace(0, 0.5, 1024)
        magc = freq_response_ba(h, np.array([1.0]), frc)
        # combined response over the decimated band
        f2 = figs.subplot()
        cic_dec = cic_freq(config, frc / R)
        f2.plot(frc * fs_out, 20 * np.log10(np.maximum(cic_dec, 1e-12)),
                "b-", label="CIC (decimated band)")
        f2.plot(frc * fs_out, 20 * np.log10(np.maximum(np.abs(magc), 1e-12)),
                "g-", label="compensator")
        comb = cic_dec * np.abs(magc)
        f2.plot(frc * fs_out, 20 * np.log10(np.maximum(comb, 1e-12)),
                "r-", label="combined")
        f2.titles("CIC + compensation", "frequency", "dB")
        i_fc = np.searchsorted(frc * fs_out, fc)
        band = comb[: max(i_fc, 1)]
        metrics["comp_ripple_db"] = float(
            20 * np.log10(band.max() / max(band.min(), 1e-12)))
    return figs, metrics
