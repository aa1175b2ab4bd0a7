"""The per-layer metrics that read the port's own spans (``tsd.*``,
``program_span`` in BENCHMARK.json) and the row's NCCL kernels, and the
number of spans a step opens, on the CPU at tiny sizes.  What each cell
must read comes from BENCHMARK.json; a cell across cards runs over gloo in
its workers."""
from __future__ import annotations

import inspect
import time

import pytest

from portbench import harness
from portbench.harness import ROOT, Cell, load_module
from portbench.tests.test_portbench_contract import BENCH, CELLS, _run, _tiny
from portbench.trace import Trace

# portbench/trace.py labels an idle gap with the innermost of the last 8
# spans started: a step may open 8, its own span included, so that the
# step's span stays among them at the step's end
LOOK_BACK = 8


def _metrics_of(cell: str, source: str, bench: dict = BENCH) -> list:
    return [m["name"] for m in Cell(cell, bench).per_layer
            if m["source"] == source]


@pytest.fixture
def kernel_route(monkeypatch):
    """The FFT on kernel #4's route, as on a card (its plain version
    here)."""
    from libtsd_tpu_torch.ops import fft
    monkeypatch.setattr(fft, "_kernel_eligible", lambda x, axis: True)


def reads_its_span_metrics(cell: str, bench: dict = BENCH) -> None:
    """A traced tiny run of the cell reads a positive number for every
    ``program_span`` metric listed for it (host times), and nothing for
    its ``device_trace`` metrics: the CPU runs no kernel (over gloo, a row
    runs no NCCL kernel either)."""
    got = _run(cell, trace=True, bench=bench)["metrics"]
    for name in _metrics_of(cell, "program_span", bench):
        assert name in got and got[name]["value"] > 0, name
    for name in _metrics_of(cell, "device_trace", bench):
        assert name not in got, name


@pytest.mark.parametrize("cell", CELLS)
def test_new_metrics_read_a_traced_tiny_run(kernel_route, cell):
    reads_its_span_metrics(cell)


def most_spans_a_step(tr: Trace) -> int:
    """The most spans any step opens, the step's own span included."""
    starts = [s for _, s, _ in tr.spans]
    return max(sum(s <= t <= s + d for t in starts)
               for n, s, d in tr.spans if n == "portbench.step")


# a worker of a cell across cards whose traced breakdown also says how many
# spans its steps opened at most
_COUNTING_RUN = f"""
import sys, time
T0 = time.perf_counter()
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness
from portbench.trace import Trace
{inspect.getsource(most_spans_a_step)}
plain = Trace.breakdown
Trace.breakdown = lambda tr: dict(plain(tr), most_spans=most_spans_a_step(tr))
sys.exit(harness.main(sys.argv[1:], T0))
"""


def opens_at_most_eight_spans(cell: str, monkeypatch, tmp_path,
                              bench: dict = BENCH) -> None:
    """Every span a traced step opens, the harness's and torch's included
    (on a row's workers, gloo's ranges stand in for NCCL's)."""
    c = _tiny(cell, bench)
    if c.chips == 1:
        plain = Trace.breakdown
        monkeypatch.setattr(Trace, "breakdown", lambda tr: dict(
            plain(tr), most_spans=most_spans_a_step(tr)))
        counts = [_run(cell, trace=True, bench=bench)["breakdown"]
                  ["most_spans"]]
    else:
        (tmp_path / "run.py").write_text(_COUNTING_RUN)
        monkeypatch.setattr(harness, "PB", tmp_path)
        parts = harness.spawn_row(c, 12345678901, 0.2, True,
                                  time.perf_counter(), "cpu", c.chips)
        counts = [p["breakdown"]["most_spans"] for p in parts]
    assert all(2 <= n <= LOOK_BACK for n in counts), counts


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_opens_at_most_eight_spans(kernel_route, monkeypatch,
                                          tmp_path, cell):
    opens_at_most_eight_spans(cell, monkeypatch, tmp_path)


def _trace(spans: list, kernels: list, steps: int) -> Trace:
    ev = [{"cat": "user_annotation", "name": n, "ts": s, "dur": d}
          for n, s, d in spans]
    ev += [{"cat": "kernel", "name": n, "ts": s, "dur": d}
           for n, s, d in kernels]
    return Trace(ev, cell=None, steps=steps, window_s=1e-3)


def test_new_metrics_by_hand():
    nccl = "ncclDevKernel_AllReduce_Sum_{}_RING_LL(ncclDevKernelArgsStorage" \
           "<4096ul>)"
    tr = _trace([("portbench.step", 0, 400),
                 ("parallel.sharded_fir_periodogram4096", 1, 300),
                 ("tsd.kernels.fir_periodogram4096_halo", 2, 200),
                 ("tsd.parallel.order", 5, 60),
                 ("tsd.kernels.fir_periodogram4096_halo", 302, 20),
                 ("tsd.demod_sb.pack_state", 330, 10),
                 ("tsd.demod_sb.carry", 350, 30),
                 ("tsd.demod_sb.outputs", 390, 6)],
                [("void chain_halo_kernel<short>()", 10, 50),
                 (nccl.format("u32"), 70, 40), (nccl.format("u32"), 170, 20),
                 (nccl.format("f32"), 230, 30)], 2)

    def read(name):
        return load_module("metrics", name).read(tr)
    # the float32 row sum alone, not the 32-bit words
    assert read("parallel.all_reduce_ms") == pytest.approx(0.015)
    assert load_module("metrics", "parallel.all_reduce_ms").combine(
        [0.1, 0.3, 0.2]) == 0.3
    # the wrappers' own host time: (200 - 60) + 20 us over 2 calls
    assert read("kernels.wrapper_host_us") == pytest.approx(80.0)
    assert read("models.demod_sb.state_ms") == pytest.approx(0.02)
    assert read("models.demod_sb.outputs_ms") == pytest.approx(0.003)
    assert most_spans_a_step(tr) == 8


def test_silent_without_the_ports_spans():
    """A port without the spans (the parent of them), or a row without
    NCCL: every metric read from spans, and the row sum's, returns None
    and does not raise."""
    tr = _trace([("portbench.step", 0, 400)],
                [("void chain_halo_kernel<short>()", 10, 50)], 1)
    names = [m["name"] for m in BENCH["per_layer"]
             if m["source"] == "program_span"]
    assert names
    for name in names + ["parallel.all_reduce_ms"]:
        assert load_module("metrics", name).read(tr) is None, name


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_is_silent_with_nothing_to_read(metric):
    """A step with no span of the port and no device activity: each
    per-layer metric's reader returns None (it never reads 0 for a share
    of a roofline or of the window)."""
    tr = _trace([("portbench.step", 0, 400)], [], 1)
    assert load_module("metrics", metric).read(tr) is None
