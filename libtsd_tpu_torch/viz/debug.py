"""Per-stage debug reports: render a dict of named intermediate signals
into the HTML report sink.

Ported from ``libtsd_tpu/viz/debug.py``; the signals may be tensors on any
device (``figure.host`` brings them over).

Parity: the reference's debug_actif observability — every major block
emits intermediate-signal figures into the stdo HTML report when enabled
(demod debug arrays demod-dec.cc:347-371, receiver recepteur.cc:144-150,
sink stdo.cc:38-130).  Here the capture side is functional
(Receiver.step_debug / Demodulator.step(debug=True) /
fm_broadcast_debug return pytrees of named signals) and this module is
the rendering side.
"""
from __future__ import annotations

import numpy as np

from .figure import Figure, host
from .report import Report

__all__ = ["debug_report", "debug_figures"]


def _is_symbols(name: str) -> bool:
    return ("sym" in name) or name in ("x1",)


def debug_figures(signals: dict):
    """Build one Figure per named signal.  Complex signals plot re/im
    traces (plus an IQ constellation when the name suggests symbols);
    real signals plot directly; boolean masks plot as 0/1 stems."""
    figs = []
    for name in sorted(signals):
        sig = host(signals[name])
        if sig.ndim == 0 or sig.size <= 1:
            continue
        if sig.ndim > 1:
            sig = sig.reshape(-1)
        if np.iscomplexobj(sig):
            f = Figure()
            f.plot(sig.real, fmt="b-", label="re")
            f.plot(sig.imag, fmt="g-", label="im")
            f.titles(title=name, xlabel="sample")
            figs.append((f, name))
            if _is_symbols(name):
                fc = Figure()
                fc.plot_iq(sig, "b.")
                fc.titles(title=f"{name} (constellation)")
                figs.append((fc, f"{name} (constellation)"))
        else:
            f = Figure()
            f.plot(sig.astype(np.float64), fmt="b-")
            f.titles(title=name, xlabel="sample")
            figs.append((f, name))
    return figs


def debug_report(name: str, signals: dict, outdir: str) -> str:
    """Write an HTML report of every captured stage (parity: the stdo
    per-test index.html + img/*.png workflow, stdo.cc:38-130).  Returns
    the report's index.html path."""
    import os
    rep = Report(outdir)
    rep.printf(f"Debug capture: {name}")
    if "has_detection" in signals and not bool(
            host(signals["has_detection"])):
        rep.printf("WARNING: the block contained NO valid detection — "
                   "the per-stage captures below are the extraction of "
                   "an arbitrary (invalid) slot and carry no signal.")
    rep.printf(f"{len(signals)} stages: {', '.join(sorted(signals))}")
    for fig, title in debug_figures(signals):
        rep.add_figure(fig, title)
    rep.flush()
    return os.path.join(outdir, "index.html")
