"""An architecture is found by the name its configuration gives
(perfbench/arch.py), on the CPU at perfbench/tests/small.py's size:

  - a configuration that names no architecture and one that names "ssnt"
    give the same weights, judge numbers (the control's too) and counts;
  - an architecture defined here, in a test file, whose beams carry a
    state twice decoder_dim wide ([h | h], its step reading the first
    half), reaches the same weights, judge numbers and counts through
    harness.make_weights, check.Judge and the metric readers, with no
    other file of the harness edited: a new architecture is new files;
  - a cell whose architecture lacks what its entry or its readers need
    stops, naming what is missing.
"""

import sys
import types

import pytest
import torch

from perfbench import check, harness, traffic_gen
from perfbench.arch import architecture
from perfbench.counts import ssnt as ssnt_counts
from perfbench.reference import ssnt
from perfbench.tests import small

SEED = 2 ** 31 + 31
CPU = torch.device("cpu")
CARD = "NVIDIA H100 80GB HBM3"
COUNTED = ("decode.mfu", "v1_step_roofline", "v2_step_roofline")


def wide_modules():
    """The reference and the counts of "ssnt_wide": ssnt's model with a
    state of [h | h] a beam."""
    ref = types.ModuleType("perfbench.reference.ssnt_wide")
    for name in ("param_shapes", "encode", "v1_enc_side", "v2_enc_side",
                 "v1_output"):
        setattr(ref, name, getattr(ssnt, name))

    def state(cfg, R, W, device):
        return torch.zeros(R, W, 2 * cfg["decoder_dim"], device=device)

    def half(state):
        H = state.shape[-1] // 2
        assert torch.equal(state[..., :H], state[..., H:])
        return state[..., :H]

    def v1_step(P, side, t, state, prev_mel, num):
        h, mel, new = ssnt.v1_step(P, side, t, half(state), prev_mel, num)
        return h, mel, torch.cat([new, new], -1)

    def v2_step(P, side, pos, state, prev_class, num):
        h, new = ssnt.v2_step(P, side, pos, half(state), prev_class, num)
        return h, torch.cat([new, new], -1)

    ref.v1_state = ref.v2_state = state
    ref.v1_step, ref.v2_step = v1_step, v2_step
    counts = types.ModuleType("perfbench.counts.ssnt_wide")
    for name in ("decode_flops", "v1_step_flops", "v1_step_bytes",
                 "v2_step_flops", "v2_step_bytes"):
        setattr(counts, name, getattr(ssnt_counts, name))
    return ref, counts


@pytest.fixture
def wide(monkeypatch):
    for mod in wide_modules():
        monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return dict(small.TINY, architecture="ssnt_wide")


def weights(entry, cfg):
    spec = small.spec(entry, cfg=cfg)
    return harness.make_weights(spec["arch"], cfg, spec["mix"], SEED, CPU)


def judged(entry, cfg):
    """The judge's numbers and the control's over every row of one batch
    that the program decoded, with the weights of cfg's architecture."""
    spec = small.spec(entry, cfg=cfg)
    arch, mix = spec["arch"], spec["mix"]
    model = harness.build_model(arch, cfg, mix, SEED, CPU)
    batch = traffic_gen.Traffic(mix, cfg["vocab_size"], SEED, CPU).batch(0)
    host = harness.to_host(harness.ENTRIES[entry][0](model, batch, mix))
    rows = harness.keep_rows(host, batch, range(mix["batch"]))
    return check.judge(arch.ref, entry, weights(entry, cfg), cfg, rows,
                       spec["workload"], mix, CPU, control=True)


def counted(entry, cfg):
    """What the readers that take the architecture's counts read of one
    made-up run: a second's window of one batch, 100 us a step."""
    from perfbench import trace
    spec = small.spec(entry, cfg=cfg)
    step = harness.DEFAULT_STEP[entry]
    run = {"entry": entry, "cfg": cfg, "arch": spec["arch"],
           "mix": spec["mix"], "kind": CARD, "window_s": 1.0,
           "batches": [{}],
           "trace": {"spans": trace.Spans([{"name": step, "ts": 0,
                                             "dur": 1}]),
                     "ops": [{"dur": 100.0, "spans": frozenset([step])}]}}
    return {m: harness.reader(m)(run) for m in COUNTED}


@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_named_ssnt_is_the_default(entry):
    named = dict(small.TINY, architecture="ssnt")
    a, b = weights(entry, small.TINY), weights(entry, named)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert judged(entry, small.TINY) == judged(entry, named)
    assert counted(entry, small.TINY) == counted(entry, named)


@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_a_wider_state_in_new_files_reads_the_same(entry, wide):
    assert architecture(wide, entry).name == "ssnt_wide"
    a, b = weights(entry, small.TINY), weights(entry, wide)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    numbers = judged(entry, wide)
    assert numbers == judged(entry, small.TINY)
    assert check.verdict(numbers["program"], small.spec(entry)["workload"]
                         ["limits"])
    got = counted(entry, wide)
    assert got == counted(entry, small.TINY)
    assert got["decode.mfu"] > 0


def test_a_missing_piece_stops_the_cell(wide):
    del sys.modules["perfbench.reference.ssnt_wide"].v1_output
    with pytest.raises(SystemExit, match="v1_output"):
        architecture(wide, "v1")
    assert architecture(wide, "v2").name == "ssnt_wide"
    with pytest.raises(SystemExit, match="v3_step_flops"):
        architecture(wide, "v2", ["decode_flops", "v3_step_flops"])
    with pytest.raises(SystemExit, match="no_such_arch"):
        architecture(dict(wide, architecture="no_such_arch"))
    with pytest.raises(SystemExit, match="no module name"):
        architecture(dict(wide, architecture="../ssnt"))
