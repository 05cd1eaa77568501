"""The check of a run's outputs against each cell's limits: a sound run
passes, the timed path broken underneath fails, for each fault the cell
can have (``lib/faults.py``), at a cut size on the CPU."""

import pytest

from conftest import CELLS, small_cell, small_run
from perfbench.lib import faults
from perfbench.run import judged

CASES = [(name, fault) for name in CELLS
         for fault in faults.FAULTS[small_cell(name).traffic["kind"]]
         if faults.applies(small_cell(name).traffic["kind"], fault,
                           small_cell(name).traffic["batch"])]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    cell, run, _ = small_run(name, seed=11)
    ok, checks = judged(run.judge()[0], cell.limits)
    assert ok, checks


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_run_is_not_correct(name, fault):
    cell, run, _ = small_run(name, seed=11, fault=fault)
    ok, checks = judged(run.judge()[0], cell.limits)
    assert not ok, checks
