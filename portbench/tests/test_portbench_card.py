"""On the card (marked ``cuda``; skipped without one): a short run of a
cell is correct, and the control, the program in float32 without the
Kahan compensations, is not.  Both at the cell's own size."""
import pytest

from portbench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["plummer_iso.n65k", "mwlmc_sat.n1m"])
def test_program_correct_control_not(cell, card):
    line, numbers = harness.run(cell, 2**31 + 101, 1.0, False)
    assert line["correct"], numbers
    line, numbers = harness.run(cell, 2**31 + 101, 1.0, False,
                                precision="float32")
    assert not line["correct"], numbers
