"""HTML report sink: collects figures + log lines into per-run
index.html + img/*.png.

Parity: stdo, core/src/vue/stdo.cc:17-146, core/include/tsd/vue.hpp:835-864
(the reference's per-test report workflow, used by its test harness
tests-gen.cc:106).  A copy of ``libtsd_tpu/viz/report.py``.
"""
from __future__ import annotations

import html
import os
from typing import List, Optional

__all__ = ["Report", "get_report", "set_output_dir"]


class Report:
    def __init__(self, outdir: str = "./build/report"):
        self.outdir = outdir
        self._items: List = []       # ("fig", path, title) | ("text", s)
        self._fig_count = 0

    def set_output_dir(self, outdir: str):
        """Parity: stdo.def_dossier_sortie."""
        self.flush()
        self.outdir = outdir
        self._items = []
        self._fig_count = 0

    def printf(self, msg: str):
        """Parity: stdo << text."""
        self._items.append(("text", msg))

    def add_figure(self, fig, title: str = ""):
        """Parity: stdo_ajoute_figure / Figure::afficher."""
        os.makedirs(os.path.join(self.outdir, "img"), exist_ok=True)
        name = f"img-{self._fig_count}.png"
        self._fig_count += 1
        path = os.path.join(self.outdir, "img", name)
        fig.save(path)
        self._items.append(("fig", os.path.join("img", name), title))

    def flush(self):
        """Write index.html (parity: stdo.affiche/fin)."""
        if not self._items:
            return
        os.makedirs(self.outdir, exist_ok=True)
        parts = ["<html><head><meta charset='utf-8'>"
                 "<title>libtsd-tpu report</title>"
                 "<style>body{font-family:sans-serif;max-width:1000px;"
                 "margin:auto}img{max-width:100%}</style></head><body>",
                 "<h1>libtsd-tpu report</h1>"]
        for item in self._items:
            if item[0] == "text":
                parts.append(f"<p>{html.escape(item[1])}</p>")
            else:
                _, rel, title = item
                if title:
                    parts.append(f"<h3>{html.escape(title)}</h3>")
                parts.append(f"<img src='{rel}'/>")
        parts.append("</body></html>")
        with open(os.path.join(self.outdir, "index.html"), "w") as f:
            f.write("\n".join(parts))


_report: Optional[Report] = None


def get_report() -> Report:
    global _report
    if _report is None:
        _report = Report()
    return _report


def set_output_dir(outdir: str):
    get_report().set_output_dir(outdir)
