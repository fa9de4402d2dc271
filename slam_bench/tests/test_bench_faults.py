"""The run's comparison with the reference, with the timed path broken
underneath (`slam_bench/faults.py`): each fault the cells can have turns
`correct` false, and the sound program passes. (A cell's batch is one
frame on one card: no half batch and no exchange between chips to leave
out.)"""

from __future__ import annotations

import pytest

from slam_bench import faults
from slam_bench.tests.conftest import run_cell

CELLS = ["tiny-sway", "tiny_mod-walker"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(tiny, capsys, cell):
    res = run_cell(tiny, cell, seed=2**33 + 1, capsys=capsys)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0


@pytest.mark.parametrize("cell,fault", [
    ("tiny-sway", f) for f in faults.FAULTS if f not in faults.MOD_FAULTS
] + [("tiny_mod-walker", f) for f in faults.MOD_FAULTS])
def test_fault_is_caught(tiny, capsys, cell, fault):
    with faults.planted(fault):
        res = run_cell(tiny, cell, seed=2**33 + 1, capsys=capsys)
    assert res["correct"] is False, (fault, res["checks"])
