"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven on the
CPU at a tiny size, once for each fault of perfbench/faults.py (a step
that returns its state unchanged, half of the batch left out, a
prediction altered where the step makes it, a selection by swapped
scores), on each route a cell's step can name: the fused v1 and v2
steps (v1_step, v2_step) and the v1 beam-only step (v1_beam_step, the
decode's fuse_model=False route). Their readings at the cells' own sizes
on the card are in PERF.md (perfbench/calibrate.py)."""

import pytest

from perfbench import faults, harness
from perfbench.tests import small


def _beam_only(model, batch, mix):
    from ssnt_tts_tpu_torch.parallel import decode
    return decode.beam_decode(model, batch["tokens"], batch["input_length"],
                              max_frames=mix["max_frames"],
                              beam_width=mix["beam"], fuse_model=False)


# route -> (entry, the step's span, the decode call in place of the
# entry's own)
ROUTES = {"v1": ("v1", None, None), "v2": ("v2", None, None),
          "v1_beam_only": ("v1", "v1_beam_step", _beam_only)}


@pytest.fixture(params=sorted(ROUTES))
def cell(request, monkeypatch):
    entry, step, call = ROUTES[request.param]
    if call is not None:
        monkeypatch.setitem(harness.ENTRIES, entry,
                            (call, harness.ENTRIES[entry][1]))
    return small.spec(entry, step=step)


def test_sound_run_is_correct(cell):
    assert small.run(cell)["correct"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(cell, fault):
    with faults.FAULTS[fault](cell):
        res = small.run(cell)
    assert not res["correct"], res["numbers"]
