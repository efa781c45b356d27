"""The counts of operations and bytes against hand counts at a tiny
shape (B=1, W=2; H=4, M=2, R=1, He=4, D=3, bf16)."""

from perfbench.arch import architecture
from perfbench.counts import roofline, ssnt

CFG = dict(vocab_size=8, mel_dim=2, encoder_dim=4, encoder_layers=1,
           encoder_heads=2, decoder_dim=4, joint_rank=1,
           duration_class_size=3, tone_class_size=2, dtype="bfloat16")


def test_v1_step_flops():
    # prenet 2*4 + 4*4, GRU 2*(4*12), joint 4*1 + 1*2 + bias 4*2, mel 4*2
    macs = 8 + 16 + 96 + 4 + 2 + 8 + 8
    assert ssnt.v1_step_flops(CFG, 1, 2) == 2 * 2 * macs


def test_v2_step_flops():
    assert ssnt.v2_step_flops(CFG, 1, 2) == 2 * 2 * (96 + 4 * 3)


def test_v1_step_bytes():
    weights = (8 + 16 + 96 + 4 + 2 + 8) * 2 + (4 + 4 + 12 + 4 + 1 + 2 + 2) * 2
    weights += (8 + 2) * 4
    rows = 2 * (2 + 2 + 2) * 4
    inputs = rows + 2 * (4 + 4 + 4 + 1 + (2 + 4) * 4) + 4
    outputs = 2 * (6 * 4 + 1 + (2 + 4) * 4)
    assert ssnt.v1_step_bytes(CFG, 1, 2) == weights + inputs + outputs


def test_v2_step_bytes():
    weights = (3 * 4 + 96 + 16) * 2 + (4 * 3 + 3) * 4
    inputs = 4 * 2 + 3 * 4 + 2 * (5 * 4 + 1 + 4 * 4) + (2 * 4 + 1) + 3 * 4
    outputs = 2 * (6 * 4 + 1 + 4 * 4) + (4 + 1)
    assert ssnt.v2_step_bytes(CFG, 1, 2) == weights + inputs + outputs


def test_encoder_flops():
    T = 3
    conv = 3 * 2 * T * 5 * 4 * 4
    block = 4 * 2 * T * 16 + 2 * 2 * T * T * 4 + 2 * 2 * T * 4 * 16
    assert ssnt.encoder_flops(CFG, 2, T) == 2 * (conv + block)


def test_bound_takes_the_larger():
    kind = "NVIDIA H100 80GB HBM3"
    assert roofline.bound_s(989e12, 0, CFG, kind) == 1.0
    assert roofline.bound_s(0, 3.35e12, CFG, kind) == 1.0
    assert roofline.bound_s(1, 1, CFG, "another card") is None


def test_step_readers_from_a_trace():
    from perfbench import trace
    card = "NVIDIA H100 80GB HBM3"
    sp = trace.Spans([{"name": "v1_step", "ts": 0, "dur": 10},
                      {"name": "v1_step", "ts": 20, "dur": 10}])
    ops = [{"dur": d, "spans": frozenset(s)} for d, s in
           ((150, {"v1_step"}), (50, {"v1_step"}), (999, set()))]
    run = {"trace": {"ops": ops, "spans": sp}, "cfg": CFG, "kind": card,
           "arch": architecture(CFG), "mix": {"batch": 1, "beam": 2}}
    assert trace.step_device_us(run, "v1_step") == 100.0
    bound = roofline.bound_s(ssnt.v1_step_flops(CFG, 1, 2),
                             ssnt.v1_step_bytes(CFG, 1, 2), CFG, card)
    assert trace.roofline_share(run, "v1_step", "v1") == 100.0 * bound / (
        100.0 * 1e-6)
    assert trace.roofline_share(run, "v2_step", "v2") is None
    assert trace.step_device_us(dict(run, trace=None), "v1_step") is None
