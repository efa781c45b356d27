"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault of perfbench/faults.py (a step
that returns its state unchanged, half of the batch left out, a
prediction altered where the step makes it, a selection by swapped
scores). Their readings at the cells' own sizes on the card are in
PERF.md (perfbench/calibrate.py)."""

import pytest

from perfbench import faults
from perfbench.tests import small


@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_sound_run_is_correct(entry):
    assert small.run(entry)["correct"]


@pytest.mark.parametrize("entry", ["v1", "v2"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(entry, fault):
    with faults.FAULTS[fault](entry, small.TINY):
        res = small.run(entry)
    assert not res["correct"], res["numbers"]
