"""The check catches the bfloat16 control and each fault a cell can have.

Each case drives a whole run (everything but the look for a card) at a
small size on the CPU, with the port's update replaced or broken, and sees
``correct`` come out false; the sound program comes out true on the same
cells. The faults: the update returns its state unchanged; half of the
batch is left out (its stats copied from the other half); one chain's
answer is altered where it is produced. A one-card cell has no exchange
between chips to leave out. The control runs at the cells' own sizes on a
card (``test_control_at_cell_size``; ``benchmark/tools/readings.py`` gives
the readings the limits were set from).
"""

import pytest

from harness.control import Control, faulty
from harness.main import run_cell

CELLS = ["holstein_64.hmc", "ssh_64.hmc"]


def _tiny(cell, tiny):
    return tiny[cell.split("_")[0]]


@pytest.mark.parametrize("cell", CELLS)
def test_program_is_correct(cell, tiny):
    r = run_cell(cell, 2 ** 35 + 1, 0.0, False, "cpu", overrides=_tiny(cell, tiny))
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("broken", ["control", "unchanged", "half", "altered"])
def test_broken_update_is_not_correct(cell, broken, tiny):
    make = Control if broken == "control" else faulty(broken)
    r = run_cell(cell, 2 ** 35 + 2, 0.0, False, "cpu", overrides=_tiny(cell, tiny),
                 make_program=make)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_at_cell_size(cell, card):
    for seed in (7001, 7002, 7003):
        r = run_cell(cell, seed, 0.0, False, card, make_program=Control)
        assert not r["correct"], r["checks"]
