"""The port's spans (``utils.monitor.span``): off, one shared null context
that records nothing; under ``torch.profiler``, the paths of the
benchmark's one-card cells -- ``DecisionDemodSB.step`` on the
``cuda-fused`` engine, ``psd_welch`` on the FFT kernel's route (its three
kernel wrappers) and ``fir_periodogram4096`` -- emit their ``tsd.`` spans
as ``user_annotation`` events, nested as their calls are, once a step, at
most five a step, with outputs bit for bit those of an untraced run.
The CPU runs each kernel's plain version under the same wrapper, so the
spans are the card's; on the card each span also covers its device work
as a ``gpu_user_annotation`` (the ``cuda`` cases:
``python -m pytest tests/test_torch_trace.py --noconftest -m cuda``).
"""
import json
import os
import tempfile
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libtsd_tpu_torch.ops import fft as FFT
from libtsd_tpu_torch.utils import monitor
import torch_compare  # noqa: F401  (importing it caps the threads)

STEPS = 2


def _demod(dev):
    """Two blocks of a 4-channel QAM-16 bank through the fused engine,
    the state carried."""
    from libtsd_tpu_torch.models import waveform as W
    from libtsd_tpu_torch.models.demod_sb import (DecisionDemodSB,
                                                  SBDemodConfig)
    wf = W.wf_qam(16, W.PulseShape.rcs(0.25), device=dev)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  engine="cuda-fused"),
                                device=dev)
    g = torch.Generator().manual_seed(5)
    x = torch.complex(*torch.randn(2, 4, STEPS * 1024, generator=g)).to(dev)
    box = {"st": dd.init_for(x[:, :1024])}

    def step(i):
        box["st"], out = dd.step(box["st"], x[:, 1024 * i:1024 * (i + 1)])
        return list(out) + [box["st"]["xtail"]]
    return step


def _welch(dev):
    from libtsd_tpu_torch.ops.psd import psd_welch
    g = torch.Generator().manual_seed(6)
    x = torch.randn(STEPS, 2, 4096 * 4, generator=g).to(dev)
    return lambda i: list(psd_welch(x[i], 4096))


def _chain(dev):
    from libtsd_tpu_torch.ops.filter_rt import fir_toeplitz_mats
    from libtsd_tpu_torch.ops.fir_design import fir_lowpass
    from libtsd_tpu_torch.ops.kernels.chain import fir_periodogram4096
    G = fir_toeplitz_mats(torch.as_tensor(
        np.asarray(fir_lowpass(256, 0.2), np.float32), device=dev))
    g = torch.Generator().manual_seed(7)
    x = torch.randint(-2000, 2000, (STEPS, 2, 4096 * 2), generator=g,
                      dtype=torch.int16).to(dev)
    return lambda i: [fir_periodogram4096(x[i], G, None, "int16", 2)]


# each path's spans, with the port span each one sits in: the model's
# phases and #6's wrapper; the Welch route's three wrappers (framing, #4,
# the power sum); #3's wrapper alone
PATHS = {
    "demod_sb": (_demod, {
        "tsd.demod_sb.pack_state": None,
        "tsd.kernels.demod_sb_fused": None,
        "tsd.demod_sb.carry": None,
        "tsd.demod_sb.outputs": None}),
    "psd_welch": (_welch, {
        "tsd.kernels.welch_frames": None,
        "tsd.kernels.fft_pow2": None,
        "tsd.kernels.welch_power": None}),
    "fir_periodogram4096": (_chain, {
        "tsd.kernels.fir_periodogram4096": None}),
}


# spans that launch nothing on the card: #6 writes the fused step's bits,
# state and input tail, so the phases around it only build views and tuples
HOST_ONLY = {"tsd.demod_sb.pack_state", "tsd.demod_sb.carry",
             "tsd.demod_sb.outputs"}


@pytest.fixture
def kernel_route(monkeypatch):
    """The FFT's route on a card (#4's wrapper, its plain version here)."""
    monkeypatch.setattr(FFT, "_kernel_eligible", lambda x, axis: True)


def _events(prof) -> list:
    fd, name = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(name)
        with open(name) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(name)


def _spans(ev: list, cat: str = "user_annotation") -> list:
    return sorted(((e["name"], e["ts"], e["dur"]) for e in ev
                   if e.get("cat") == cat and e["name"].startswith("tsd.")),
                  key=lambda s: s[1])


def _run(path: str, dev, traced: bool):
    """(outputs of every step, the trace's events, or None untraced)."""
    step = PATHS[path][0](dev)
    if not traced:
        return [step(i) for i in range(STEPS)], None
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        outs = [step(i) for i in range(STEPS)]
    return outs, _events(prof)


def _parents(spans: list) -> dict:
    """{name: {the innermost port span around it, or None}}."""
    out = {}
    for i, (n, s, d) in enumerate(spans):
        around = [m for m, ms, md in spans[:i]
                  if ms <= s and s + d <= ms + md]
        out.setdefault(n, set()).add(around[-1] if around else None)
    return out


@pytest.fixture(scope="module")
def traced():
    """Each path traced once on the CPU (the FFT on #4's route)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(FFT, "_kernel_eligible", lambda x, axis: True)
    try:
        return {p: _run(p, torch.device("cpu"), True) for p in PATHS}
    finally:
        mp.undo()


def test_span_off_is_the_shared_null_context():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert monitor.span("tsd.a") is monitor.span("tsd.b") is monitor._NULL


def test_spans_are_on_exactly_while_the_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with monitor.span("tsd.inside"):
            pass
    with monitor.span("tsd.after"):
        pass
    assert [n for n, _, _ in _spans(_events(prof))] == ["tsd.inside"]
    assert monitor.span("tsd.after") is monitor._NULL


def test_spanned_keeps_the_function():
    @monitor.spanned("tsd.f")
    def f(a, b=2):
        """doc"""
        return a * b
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = f(3, b=4)
    assert (got, f(5), f.__name__, f.__doc__) == (12, 10, "f", "doc")
    assert [n for n, _, _ in _spans(_events(prof))] == ["tsd.f"]


@pytest.mark.parametrize("form", ["span", "spanned"])
def test_a_span_closes_when_its_phase_raises(form):
    """The range ends with the phase, and the error goes on; a span opened
    after it is not nested in it."""
    @monitor.spanned("tsd.fails")
    def fails():
        raise ValueError("phase")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError, match="phase"):
            if form == "span":
                with monitor.span("tsd.fails"):
                    raise ValueError("phase")
            else:
                fails()
        with monitor.span("tsd.next"):
            pass
    spans = _spans(_events(prof))
    assert [n for n, _, _ in spans] == ["tsd.fails", "tsd.next"]
    assert _parents(spans) == {"tsd.fails": {None}, "tsd.next": {None}}


@pytest.mark.parametrize("path", list(PATHS))
def test_spans_nest_once_a_step(traced, path):
    spans = _spans(traced[path][1])
    want = PATHS[path][1]
    assert dict(Counter(n for n, _, _ in spans)) == {
        n: STEPS for n in want}
    assert _parents(spans) == {n: {p} for n, p in want.items()}


@pytest.mark.parametrize("path", list(PATHS))
def test_at_most_five_port_spans_a_step(traced, path):
    # the benchmark labels an idle gap with the innermost of the last 8
    # spans started: its own 2 a step (the step and the call) and the
    # port's must fit, so that the step's span stays among them
    assert len(_spans(traced[path][1])) <= 5 * STEPS


@pytest.mark.parametrize("path", list(PATHS))
def test_outputs_identical_with_spans_on_and_off(traced, kernel_route,
                                                 path):
    off, _ = _run(path, torch.device("cpu"), False)
    on = traced[path][0]
    for a, b in zip(off, on):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and torch.equal(u, v)


@pytest.fixture
def dev():
    """The card, or a skip: decided at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device side of the spans)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_spans_cover_their_device_work_on_the_card(dev, path):
    """On the card: each span once a step on the host and, unless it
    launches nothing (``HOST_ONLY``), once a step on the device
    (``gpu_user_annotation``), a wrapper's spans as many as its launches,
    its kernels inside its device span, and the outputs of an untraced
    run."""
    from libtsd_tpu_torch.ops.kernels import chain, demod_sb, fft, welch
    # each wrapper's span, the wrapper and the kernels it launches
    wrappers = {
        "demod_sb": [("tsd.kernels.demod_sb_fused",
                      demod_sb.demod_sb_fused_step,
                      ["demod_sb_fused_kernel"])],
        "psd_welch": [
            ("tsd.kernels.welch_frames", welch.welch_frames,
             ["welch_frames_kernel"]),
            ("tsd.kernels.fft_pow2", fft.fft_pow2, ["fft_kernel"]),
            ("tsd.kernels.welch_power", welch.welch_power,
             ["welch_partial_kernel", "welch_db_kernel"])],
        "fir_periodogram4096": [("tsd.kernels.fir_periodogram4096",
                                 chain.fir_periodogram4096,
                                 ["chain_kernel"])],
    }[path]
    off, _ = _run(path, dev, False)
    before = [w.launches for _, w, _ in wrappers]
    on, ev = _run(path, dev, True)
    want = {n: STEPS for n in PATHS[path][1]}
    assert dict(Counter(n for n, _, _ in _spans(ev))) == want
    on_dev = _spans(ev, "gpu_user_annotation")
    assert dict(Counter(n for n, _, _ in on_dev)) == {
        n: c for n, c in want.items() if n not in HOST_ONLY}
    for (kname, wrapper, names), b in zip(wrappers, before):
        assert wrapper.launches - b == STEPS
        for kernel in names:
            kernels = [(e["ts"], e["dur"]) for e in ev
                       if e.get("cat") == "kernel" and kernel in e["name"]]
            assert len(kernels) == STEPS
            for (s, d), (_, ws, wd) in zip(kernels, [x for x in on_dev
                                                      if x[0] == kname]):
                assert ws <= s and s + d <= ws + wd + 1
    for a, b in zip(off, on):
        for u, v in zip(a, b):
            assert torch.equal(u, v)
