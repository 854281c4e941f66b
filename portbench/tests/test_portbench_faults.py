"""The correctness check fails what it must: the control (the reference
computed in bfloat16 in the program's place) and a run of the cell with
the timed path broken underneath, once for each fault the cell can have.
The harness's look for a card is skipped (the drivers run on the CPU)."""

from __future__ import annotations

import pytest
import torch

import pbtiny
from portbench import check, faults, harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(cell):
    rec = pbtiny.run(cell, control=torch.bfloat16)
    assert rec["check"]["correct"]               # the program passes ...
    limits = pbtiny.spec(cell)["limits"]
    assert not check.verdict(rec["check"]["control"], limits)["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    rec = pbtiny.run(cell, program=faults.train_program(fault))
    assert not rec["check"]["correct"]
    # and the same run unbroken passes
    assert pbtiny.run(cell)["check"]["correct"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_fault_in_the_windows_steps_alone_is_not_correct(cell, fault):
    """The set-up steps sound, every step of the window broken: the check
    of the step that closes the window fails the run."""
    after = int(pbtiny.spec(cell)["params"]["checked_steps"])
    rec = pbtiny.run(cell, program=faults.train_program(fault, after))
    assert not rec["check"]["correct"]
