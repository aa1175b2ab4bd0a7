"""README.md's recipe for a new entry into the port, followed in a copy of
``portbench/``: a path module, its reference, a traffic file, a
configuration and a per-layer metric, all new files, and new entries in a
copy of BENCHMARK.json.  The tests' case lists, ``_tiny`` and the harness
take the new cell without an edit to any file they have."""
from __future__ import annotations

import copy
import json
import shutil

from portbench import harness
from portbench.harness import PB
from portbench.tests.test_portbench_contract import (
    BENCH, FAULT_CASES, _declares_its_test_contract, _fault_cases, _paths,
    _run, _tiny)
from portbench.tests.test_portbench_spans import (opens_at_most_eight_spans,
                                                  reads_its_span_metrics)

STUB_PATH = '''"""Path ``stub``: a step doubles a block drawn from the seed and adds
the step's index, inside a span as the port's kernel wrappers open."""
import torch

from portbench.harness import load_module
from portbench.spans import span

FAULTS = ("altered",)
TINY = {"n": 64}


class Path:
    def __init__(self, cell, seed, device, mark, control=False, fault=None,
                 row=None):
        self.n, self.fault = cell.traffic["n"], fault
        self.samples_per_step = self.n
        gen = torch.Generator(device=device).manual_seed(seed)
        self.x = torch.randn(self.n, generator=gen, device=device)
        self.kept = {}
        mark("data")

    def warm(self):
        self.step(0)

    def step(self, i):
        with span("tsd.kernels.stub"):
            self.out = 2 * self.x + i
        if self.fault == "altered":
            self.out[0] += 1

    def keep(self, i, slot):
        self.kept[slot] = (i, self.out.clone())

    def release(self):
        pass

    def check(self):
        ref = load_module("reference", "stub")
        gap = max(float((got - ref.step(self.x, i)).abs().max())
                  for i, got in self.kept.values())
        return [("gap", gap, 0.0)]
'''

STUB_REFERENCE = '''def step(x, i):
    return 2 * x + i
'''

STUB_METRIC = '''def read(tr):
    host, count = tr.span_seconds("tsd.kernels.stub")
    return 1e6 * host / count if count else None
'''


def _stub_bench(tmp_path, monkeypatch) -> dict:
    """A copy of ``portbench/`` with the stub's files added, the harness
    pointed at it, and BENCHMARK.json's entries with the stub's added."""
    pb = tmp_path / "portbench"
    shutil.copytree(PB, pb, ignore=shutil.ignore_patterns("__pycache__",
                                                          "tests"))
    (pb / "paths" / "stub.py").write_text(STUB_PATH)
    (pb / "reference" / "stub.py").write_text(STUB_REFERENCE)
    (pb / "metrics" / "stub.host_us.py").write_text(STUB_METRIC)
    (pb / "traffic" / "s1.json").write_text(json.dumps(
        {"path": "stub", "n": 1 << 20, "check_steps": 4}))
    (pb / "configs" / "stub_conf.json").write_text(json.dumps(
        {"name": "stub_conf", "source": "this test", "reduced": [],
         "assumed": ["a ramp"], "guarantees": ["exact"]}))
    monkeypatch.setattr(harness, "PB", pb)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "stub_conf", "source": "this test",
                             "file": "portbench/configs/stub_conf.json",
                             "reduced": [], "why": "the recipe's test"})
    bench["workloads"].append({"name": "stub.s1", "config": "stub_conf",
                               "traffic": "s1", "chips": 1,
                               "why": "the recipe's test"})
    bench["per_layer"].append({"name": "stub.host_us", "unit": "us",
                               "better": "lower", "source": "program_span",
                               "layer": "stub", "moves": "msamples_per_s",
                               "workloads": ["stub.s1"]})
    return bench


def test_a_new_path_needs_no_edit(tmp_path, monkeypatch):
    bench = _stub_bench(tmp_path, monkeypatch)
    assert _paths(bench)["stub"] == "stub.s1"
    _declares_its_test_contract("stub.s1", bench)
    # the cells already there keep their cases, and the stub's join them
    assert _fault_cases(bench) == FAULT_CASES + [("stub.s1", "altered")]
    t = _tiny("stub.s1", bench).traffic
    assert (t["n"], t["check_steps"]) == (64, 2)
    r = _run("stub.s1", bench=bench)
    assert r["correct"] and r["attempted"] > 0, r["checks"]
    assert not _run("stub.s1", bench=bench, fault="altered")["correct"]
    reads_its_span_metrics("stub.s1", bench)
    opens_at_most_eight_spans("stub.s1", monkeypatch, tmp_path, bench)
