"""The check against faults planted in the timed path: with the look for
a card skipped, a whole run on the CPU at a small size with the program's
KDK step broken underneath (``portbench/faults.py``) has to come out not
correct, and the same run unbroken correct.  Each fault is planted in
every step, and from the second step of each call on, where only the
window's own last step can show it."""
import pytest

from portbench import faults, harness

FAULTS = [None, *faults.FAULTS]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f or "none")
@pytest.mark.parametrize("cell", ["plummer_iso.n65k", "mwlmc_sat.n1m"])
def test_a_broken_step_is_not_correct(cell, fault):
    with faults.planted(fault):
        line, numbers = harness.run(cell, 2**31 + 11, 0.2, False,
                                    device="cpu", n_body=256)
    assert line["correct"] is (fault is None), numbers
    assert list(line)[-1] == "checks"
    if fault is not None and fault.endswith(".late"):
        # the warm-up call's one step is sound: only the window shows it
        assert all(numbers["start"][q] <= limit
                   for q, limit in harness.config(
                       harness.workload(harness.manifest(), cell)["config"]
                   )[0]["limits"].items()), numbers
