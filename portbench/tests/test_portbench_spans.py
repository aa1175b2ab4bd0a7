"""The per-layer metrics that read the port's own spans (``tsd.*``) and
the row's NCCL kernels, and the number of spans a step opens, on the CPU
at tiny sizes.  The row cell runs over gloo in its workers; its new
metrics wait, with the cell, beside ``row_cell.json`` in
``row_cell_spans.json``."""
from __future__ import annotations

import inspect
import json
import time

import pytest

from portbench import harness
from portbench.harness import PB, ROOT, Cell, load_module
from portbench.tests.test_portbench_contract import TESTED, _run, _tiny
from portbench.trace import Trace

ROW = "spectral_row4.t4"
NEW = ["models.demod_sb.state_ms", "models.demod_sb.outputs_ms",
       "kernels.wrapper_host_us", "parallel.order_ms",
       "parallel.all_reduce_ms"]
# the new metrics each one-card cell reports (host times: positive)
WANT = {
    "qam16.c4096": ["models.demod_sb.state_ms", "models.demod_sb.outputs_ms",
                    "kernels.wrapper_host_us"],
    "spectral.welch4": ["kernels.wrapper_host_us"],
    "spectral.c256": ["kernels.wrapper_host_us"],
}
# portbench/trace.py labels an idle gap with the innermost of the last 8
# spans started: a step may open 8, its own span included, so that the
# step's span stays among them at the step's end
LOOK_BACK = 8


def _with_row_spans(bench: dict) -> dict:
    """The tested entries plus the row cell's span metrics."""
    kept = json.loads((PB / "tests" / "row_cell_spans.json").read_text())
    out = dict(bench, per_layer=[dict(m) for m in bench["per_layer"]])
    for m in out["per_layer"]:
        m["workloads"] = m["workloads"] + kept["workloads_of"].get(
            m["name"], [])
    out["per_layer"] += kept["per_layer"]
    return out


@pytest.fixture
def kernel_route(monkeypatch):
    """The FFT on kernel #4's route, as on a card (its plain version
    here)."""
    from libtsd_tpu_torch.ops import fft
    monkeypatch.setattr(fft, "_kernel_eligible", lambda x, axis: True)


@pytest.mark.parametrize("cell", list(WANT))
def test_new_metrics_read_a_traced_tiny_run(kernel_route, cell):
    got = _run(cell, trace=True)["metrics"]
    for name in WANT[cell]:
        assert name in got and got[name]["value"] > 0, name


def test_row_cell_reads_its_wrapper_time_over_gloo():
    cell = Cell(ROW, _with_row_spans(TESTED), traffic=_tiny(ROW).traffic)
    assert {"parallel.order_ms", "parallel.all_reduce_ms",
            "kernels.wrapper_host_us"} <= {m["name"] for m in cell.per_layer}
    got = harness.run_cell(cell, 12345678901, 0.2, True, time.perf_counter(),
                           device="cpu", log=lambda s: None)["metrics"]
    assert got["kernels.wrapper_host_us"]["value"] > 0
    # gloo runs no NCCL kernel: both parallel metrics stay silent here
    assert "parallel.order_ms" not in got
    assert "parallel.all_reduce_ms" not in got


def most_spans_a_step(tr: Trace) -> int:
    """The most spans any step opens, the step's own span included."""
    starts = [s for _, s, _ in tr.spans]
    return max(sum(s <= t <= s + d for t in starts)
               for n, s, d in tr.spans if n == "portbench.step")


# a worker of the row cell whose traced breakdown also says how many spans
# its steps opened at most
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


@pytest.mark.parametrize("cell", list(WANT) + [ROW])
def test_a_step_opens_at_most_eight_spans(kernel_route, monkeypatch,
                                          tmp_path, cell):
    """Every span a traced step opens, the harness's and torch's included
    (on the row cell's workers, gloo's ranges stand in for NCCL's)."""
    if cell != ROW:
        plain = Trace.breakdown
        monkeypatch.setattr(Trace, "breakdown", lambda tr: dict(
            plain(tr), most_spans=most_spans_a_step(tr)))
        counts = [_run(cell, trace=True)["breakdown"]["most_spans"]]
    else:
        row = _tiny(ROW)
        (tmp_path / "run.py").write_text(_COUNTING_RUN)
        monkeypatch.setattr(harness, "PB", tmp_path)
        parts = harness.spawn_row(row, 12345678901, 0.2, True,
                                  time.perf_counter(), "cpu", 4)
        counts = [p["breakdown"]["most_spans"] for p in parts]
    assert all(2 <= n <= LOOK_BACK for n in counts), counts


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
    assert read("parallel.order_ms") == pytest.approx(0.03)
    assert read("parallel.all_reduce_ms") == pytest.approx(0.015)
    assert load_module("metrics", "parallel.order_ms").combine(
        [0.1, 0.3, 0.2]) == 0.3
    # the wrappers' own host time: (200 - 60) + 20 us over 2 calls
    assert read("kernels.wrapper_host_us") == pytest.approx(80.0)
    assert read("models.demod_sb.state_ms") == pytest.approx(0.02)
    assert read("models.demod_sb.outputs_ms") == pytest.approx(0.003)
    assert most_spans_a_step(tr) == 8


def test_silent_without_the_ports_spans():
    """A port without the spans (the parent of them), or a row without
    NCCL: every new metric returns None and does not raise."""
    tr = _trace([("portbench.step", 0, 400)],
                [("void chain_halo_kernel<short>()", 10, 50)], 1)
    for name in NEW:
        assert load_module("metrics", name).read(tr) is None, name
