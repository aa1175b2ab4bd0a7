"""Reduction of a traced run's ``torch.profiler`` trace to what the per-layer
metrics read: device activity (kernels, copies, sets) clipped to the
measured window, the benchmark's own spans, and the breakdown the result
line carries."""
from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_ident(name: str) -> str:
    """The function name of a demangled kernel name: "void
    ns::chain_kernel<short>(short const*, ...)" -> "chain_kernel", "void
    (anonymous namespace)::fft_kernel<12>(...)" -> "fft_kernel"."""
    name = name.replace("(anonymous namespace)::", "")
    head = name.split("(")[0].split("<")[0].split()[-1:] or [""]
    return head[0].split("::")[-1]


def _merge(iv):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Times in the trace are microseconds; every public number is in
    seconds."""

    def __init__(self, events: list, cell, steps: int, window_s: float):
        self.cell = cell
        self.steps = steps
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and "dur" in e]
        win = [e for e in spans if e["name"] == "portbench.window"]
        if win:
            self.w0, self.w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        else:
            self.w0, self.w1 = 0.0, 1e6 * window_s
        self.spans = [(e["name"], e["ts"], e["dur"]) for e in spans
                      if e["name"] != "portbench.window"]
        self.device = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                s = max(e["ts"], self.w0)
                t = min(e["ts"] + e["dur"], self.w1)
                if t > s:
                    self.device.append((e["name"], e.get("cat"), s, t - s))
        self.busy = _merge([(s, s + d) for _, _, s, d in self.device])
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6
        self.window_s = (self.w1 - self.w0) / 1e6

    @classmethod
    def from_profiler(cls, prof, cell, steps: int, window_s: float):
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return cls(events, cell, steps, window_s)

    def kernel_seconds(self, ident: str) -> tuple:
        """(total seconds, launches) of the kernels whose function is
        ``ident``."""
        d = [dur for name, cat, _, dur in self.device
             if cat == "kernel" and kernel_ident(name) == ident]
        return sum(d) / 1e6, len(d)

    def kernels_other_than(self, ident: str) -> float:
        """Seconds of the kernels whose function is not ``ident``."""
        return sum(dur for name, cat, _, dur in self.device
                   if cat == "kernel" and kernel_ident(name) != ident) / 1e6

    def span_seconds(self, name: str) -> tuple:
        d = [dur for n, _, dur in self.spans if n == name]
        return sum(d) / 1e6, len(d)

    def _host_label(self, t: float) -> str:
        """The innermost span covering t: spans nest, so it is the latest
        started one that has not ended (a few steps back at most)."""
        k = bisect.bisect_right(self._starts, t)
        for n, s, d in reversed(self._sorted[max(0, k - 8):k]):
            if t <= s + d:
                return f"host in {n}"
        return "host outside any span"

    def breakdown(self) -> dict:
        by_op = {}
        for name, _, _, dur in self.device:
            by_op[name] = by_op.get(name, 0.0) + dur
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        self._sorted = sorted(self.spans, key=lambda x: x[1])
        self._starts = [s for _, s, _ in self._sorted]
        gaps, prev = {}, self.w0
        for s, e in self.busy + [[self.w1, self.w1]]:
            if s > prev:
                lab = self._host_label(0.5 * (s + prev))
                gaps[lab] = gaps.get(lab, 0.0) + (s - prev)
            prev = max(prev, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], v / 1e6] for n, v in ops],
                "idle_gaps": [[n, v / 1e6] for n, v in idle]}
