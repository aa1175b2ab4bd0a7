"""The controls: each cell's reference (or the program's own next tier
down) computed in the nearest precision below the configuration's, in the
program's place, has to come out not correct.

On the CPU at a tiny size; on the card at the cells' own sizes, three
seeds each (``-m cuda -s`` prints the readings).
"""
from __future__ import annotations

import json
import time

import pytest

from portbench import harness
from portbench.harness import Cell
from portbench.tests.test_portbench_contract import BENCH, CELLS, _run

SEEDS = (2147483659, 3000000019, 4000000007)


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_cpu(cell):
    r = _run(cell, seed=11, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_the_card(cell):
    import torch
    c = Cell(cell, BENCH)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < c.chips:
        pytest.skip(f"needs {c.chips} NVIDIA card(s)")
    for seed in SEEDS:
        r = harness.run_cell(c, seed, 3.0, False, time.perf_counter(),
                             control=True, log=lambda s: None)
        print(f"CONTROL {cell} seed {seed} {json.dumps(r['checks'])} "
              f"steps {r['attempted']}")
        assert not r["correct"], r["checks"]
