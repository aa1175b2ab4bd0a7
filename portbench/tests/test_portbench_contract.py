"""The benchmark's own tests, on the CPU at tiny sizes (the card-only ones
are marked ``cuda`` and skip elsewhere).

    python -m pytest portbench/tests -q            # here, on the CPU
    python -m pytest portbench/tests -q -m cuda -s # on the card
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.harness import PB, ROOT, Cell, load_benchmark, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()


def _cells(bench: dict) -> list:
    return [w["name"] for w in bench["workloads"]]


def _paths(bench: dict) -> dict:
    """Every path the cells of ``bench`` drive (the ``path`` of their
    traffic files), with the first cell that drives it."""
    out = {}
    for c in _cells(bench):
        out.setdefault(Cell(c, bench).path, c)
    return out


def _fault_cases(bench: dict) -> list:
    """(cell, fault) for every fault the cell's path module declares; a
    path without ``FAULTS`` gives none here and fails
    ``test_every_path_declares_its_test_contract``."""
    return [(c, f) for c in _cells(bench) for f in getattr(
        load_module("paths", Cell(c, bench).path), "FAULTS", ())]


CELLS = _cells(BENCH)
FAULT_CASES = _fault_cases(BENCH)


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "msamples_per_s", "step_ms_p95", "setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    seen = set()
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        assert e["name"] not in seen
        seen.add(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k]), e[k]
        for k in e.get("reduced", []):
            assert NAME.match(k)
        for k in ("why", "layer", "source"):
            if k in e and k != "source" or kind == "configs" and k == "source":
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k]


def test_every_cell_reports_what_the_contract_asks():
    for w in BENCH["workloads"]:
        cell = Cell(w["name"], BENCH)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    c = Cell(cell, BENCH)
    load_module("paths", c.path)
    assert (PB / "reference" / f"{c.path}.py").is_file()
    for m in c.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
        if m["name"].endswith("_roofline"):
            mod = load_module("roofline", m["name"][:-len("_roofline")])
            assert callable(mod.least_seconds)


def test_config_files_state_their_cuts():
    for conf in BENCH["configs"]:
        f = json.loads((ROOT / conf["file"]).read_text())
        assert f["reduced"] == conf["reduced"]
        assert f["source"] and f["assumed"] and f["guarantees"]


def test_roofline_hand_counts():
    from portbench.roofline import chain, demod_sb_fused, fft, peaks
    ops, nb = chain.work(256, 1 << 22, 256, "int16")
    assert nb == 256 * ((1 << 22) + 255) * 2 + 256 * 4096 * 4
    assert ops == 256 * 1024 * 688138
    t, by = chain.least_seconds(256, 1 << 22, 256, "int16")
    assert by == "bytes" and abs(t - nb / 3.35e12) < 1e-12
    ops, nb = fft.work(3, 4096)
    assert (ops, nb) == (5 * 3 * 4096 * 12, 16 * 3 * 4096)
    ops, nb = demod_sb_fused.work(2, 8192, 256, 4, 21, 4)
    assert nb == 2 * (8192 + 256) * 8 + 2 * 2048 * 13 + 2 * 9 * 2 * 4
    assert ops == 2 * 2048 * (4 * (42 + 8) + 20)
    assert peaks.least_seconds(0, 3.35e12, 1.0) == (1.0, "bytes")


def _tiny(cell: str, bench: dict = BENCH) -> Cell:
    """The cell at the tiny size its path module's ``TINY`` gives."""
    c = Cell(cell, bench)
    t = dict(c.traffic, check_steps=2)
    t.update(load_module("paths", c.path).TINY)
    return Cell(cell, bench, traffic=t)


def _run(cell, seed=12345678901, bench: dict = BENCH, **kw):
    import time
    return harness.run_cell(_tiny(cell, bench), seed, 0.2,
                            kw.pop("trace", False), time.perf_counter(),
                            device="cpu", log=lambda s: None, **kw)


def _declares_its_test_contract(cell: str, bench: dict = BENCH) -> None:
    c = Cell(cell, bench)
    mod = load_module("paths", c.path)
    assert hasattr(mod, "Path"), c.path
    faults = getattr(mod, "FAULTS", None)
    assert isinstance(faults, tuple) and faults, f"{c.path}: no FAULTS"
    assert all(isinstance(f, str) for f in faults), faults
    tiny = getattr(mod, "TINY", None)
    assert isinstance(tiny, dict) and tiny, f"{c.path}: no TINY"


@pytest.mark.parametrize("path", sorted(_paths(BENCH)))
def test_every_path_declares_its_test_contract(path):
    """Each path module declares the faults its ``Path`` honours and the
    traffic of its tiny run: these tests read both, so a new path needs no
    edit here."""
    _declares_its_test_contract(_paths(BENCH)[path])


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_the_contract_keys(cell):
    r = _run(cell)
    r.pop("forbidden", None)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    # the CPU runs the kernels' plain versions, whose rounding differs from
    # the card's: here only the verdict's bookkeeping is checked
    assert r["attempted"] > 0 and r["checks"]
    assert r["correct"] == (r["failed"] == 0)
    assert set(r["metrics"]) == {m["name"] for m in _tiny(cell).end_to_end}
    for n, c in r["checks"].items():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", CELLS)
def test_traced_line_has_breakdown(cell):
    r = _run(cell, trace=True)
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    r.pop("forbidden", None)
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", FAULT_CASES)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = _run(cell, seed=7, fault=fault)
    assert not r["correct"], r["checks"]


def _subprocess(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_run_without_a_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_no_jax_after_set_up(cell):
    p = _subprocess(
        "import json, sys, time\n"
        "from portbench import harness\n"
        "from portbench.tests.test_portbench_contract import _tiny\n"
        f"c = _tiny({cell!r})\n"
        "r = harness.run_cell(c, 3, 0.1, False, time.perf_counter(), "
        "device='cpu', log=lambda s: None)\n"
        "top = {k.split('.')[0] for k in sys.modules}\n"
        "top.update(*r.get('forbidden', []))\n"
        "print(json.dumps([sorted(top), 'forbidden' in r]))")
    assert p.returncode == 0, p.stderr[-2000:]
    top, workers = json.loads(p.stdout.strip().splitlines()[-1])
    # a cell across cards sets up in its workers, which report their own
    assert workers or "libtsd_tpu_torch" in top
    assert not set(top) & {"jax", "jaxlib", "flax", "libtsd_tpu"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "libtsd_tpu_torch_x", sys)
    assert "libtsd_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in harness.forbidden_modules()


def test_trace_reduction_by_hand():
    from portbench.trace import Trace, kernel_ident
    assert kernel_ident("void (anonymous namespace)::fft_kernel<12>(float "
                        "const*, int)") == "fft_kernel"
    assert kernel_ident("void fm_chain_kernel<1>(float*)") != "chain_kernel"
    ev = [{"cat": "user_annotation", "name": "portbench.window", "ts": 0,
           "dur": 100},
          {"cat": "user_annotation", "name": "portbench.step", "ts": 0,
           "dur": 50},
          {"cat": "user_annotation", "name": "layer.call", "ts": 5,
           "dur": 10},
          {"cat": "kernel", "name": "void a::k<2>(int)", "ts": 20, "dur": 30},
          {"cat": "kernel", "name": "void other(int)", "ts": 40, "dur": 20},
          {"cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 20}]
    tr = Trace(ev, cell=None, steps=1, window_s=1e-4)
    assert abs(tr.busy_s - 50e-6) < 1e-12 and abs(tr.window_s - 1e-4) < 1e-12
    assert tr.kernel_seconds("k") == (30e-6, 1)
    assert abs(tr.kernels_other_than("k") - 20e-6) < 1e-12
    assert tr.span_seconds("portbench.step") == (50e-6, 1)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert abs(gaps["host in layer.call"] - 20e-6) < 1e-12
    assert abs(gaps["host outside any span"] - 30e-6) < 1e-12
