"""The reference against the port's plain route, on the CPU at tiny
widths in bfloat16: the same weights, the same inputs."""

import torch

from perfbench import weights
from perfbench.arch import architecture
from perfbench.reference import beam, ssnt
from perfbench.reference.numerics import Num
from perfbench.tests import small

CFG = small.TINY
MIX = {"frames_per_token": 3}


def port_model():
    from perfbench import harness
    return harness.build_model(architecture(CFG), CFG, MIX, 99,
                               torch.device("cpu"))


def ref_params():
    return weights.make(ssnt.param_shapes(CFG, 3), 99, "cpu")


def inputs(B=3, T=9):
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, CFG["vocab_size"], (B, T), generator=g)
    il = torch.tensor([T, T - 2, 4])[:B]
    return toks, il


def close(a, b, tol=1e-5):
    scale = b.abs().max().clamp(min=1e-6)
    return float((a - b).abs().max() / scale) <= tol


def test_weights_are_the_ones_loaded():
    m = port_model()
    P = ref_params()
    for name, value in m.state_dict().items():
        assert torch.equal(value, P[name]), name


def test_encoder():
    toks, il = inputs()
    bf16 = Num(torch.bfloat16)
    ref = ssnt.encode(ref_params(), CFG, toks, il, bf16)
    with torch.no_grad():
        port = port_model().encode(toks, il)
    assert close(ref, port)


def test_v1_step():
    from ssnt_tts_tpu_torch.models import stepmath
    toks, il = inputs()
    m = port_model()
    P = ref_params()
    bf16 = Num(torch.bfloat16)
    enc = m.encode(toks, il)
    W = 2
    g = torch.Generator().manual_seed(5)
    t = torch.randint(0, 9, (3, W), generator=g)
    state = torch.randn(3, W, CFG["decoder_dim"], generator=g)
    prev = torch.randn(3, W, CFG["mel_dim"], generator=g)
    h, mel, new = ssnt.v1_step(P, ssnt.v1_enc_side(P, enc, bf16), t, state,
                               prev, bf16)
    w = m.v1_step_weights()
    pack = stepmath.v1_enc_pack(w, enc, torch.bfloat16)
    gath = torch.gather(pack, 1, t[..., None].expand(-1, -1, pack.shape[2]))
    ph, pmel, pnew = stepmath.v1_step_math(w, gath, state, prev,
                                           torch.bfloat16)
    assert close(h, ph) and close(mel, pmel) and close(new, pnew)


def test_v2_step():
    from ssnt_tts_tpu_torch.models import stepmath
    toks, il = inputs()
    m = port_model()
    P = ref_params()
    bf16 = Num(torch.bfloat16)
    enc = m.encode(toks, il)
    W = 2
    g = torch.Generator().manual_seed(6)
    pos = torch.randint(0, 9, (3, W), generator=g)
    state = torch.randn(3, W, CFG["decoder_dim"], generator=g)
    prev = torch.randint(0, CFG["duration_class_size"], (3, W), generator=g)
    h, new = ssnt.v2_step(P, ssnt.v2_enc_side(P, enc, bf16), pos, state,
                          prev, bf16)
    enc_t = torch.gather(enc, 1, pos[..., None].expand(-1, -1, enc.shape[2]))
    ph, pnew = stepmath.class_step_math(m.duration_step_weights(), enc_t,
                                        state, prev, torch.bfloat16)
    assert close(h, ph) and close(new, pnew)


def test_backtrace_and_upsample():
    from ssnt_tts_tpu_torch.ops import backtrace, upsample
    g = torch.Generator().manual_seed(7)
    B, U, W = 3, 11, 4
    br = torch.randint(0, W, (B, U, W), generator=g, dtype=torch.int32)
    th = torch.randint(0, 9, (B, U, W), generator=g, dtype=torch.int32)
    final = torch.zeros(B, dtype=torch.int32)
    slots, ts = beam.best_path(final.long(), br, th)
    pslots, pts = backtrace.extract_best_beam_branch(final, br, th)
    assert torch.equal(slots, pslots.long()) and torch.equal(ts, pts.long())
    order = beam.ancestry(br)
    porder = backtrace.order_beam_branch(
        torch.arange(W).expand(B, W), br)
    assert torch.equal(order, porder.long())
    dur = torch.randint(0, 4, (B, W, 9), generator=g, dtype=torch.int32)
    out_len = dur.sum(-1)
    assert torch.equal(beam.source_indexes(dur, out_len, 30),
                       upsample.upsample_source_indexes(
                           dur, out_len, -1, max_u=30).long())


def test_whole_decodes_read_zero_against_the_plain_route():
    # The CPU runs the fused steps' plain versions: the same arithmetic as
    # the reference, so every number reads (nearly) nothing.
    for entry in ("v1", "v2"):
        res = small.run(small.spec(entry))
        nums = res["numbers"]["program"]
        assert res["correct"], nums
        assert nums["mismatches"] == 0 and nums["invalid"] == 0
        sel, lp = ("sel_rel", "lp_rel") if entry == "v1" else ("sel_gap",
                                                                "lp_err")
        assert nums[sel] <= 1e-5 and nums[lp] <= 1e-4


def test_duration_bias_on_the_target_class():
    w = ref_params()
    bias = w["duration_ar.out.bias"]
    assert float(bias[3]) == ssnt.DURATION_BIAS
    assert float(bias.abs().sum()) == ssnt.DURATION_BIAS
    assert float(weights.make(ssnt.param_shapes(CFG), 99, "cpu")[
        "duration_ar.out.bias"].abs().sum()) == 0.0


def test_emptied_utterances_make_no_audio():
    from perfbench import harness
    frames = harness.ENTRIES["v2"][1]({
        "beam_emptied": torch.tensor([False, True, False]),
        "output_length": torch.tensor([[10, 9], [7, 7], [5, 4]])})
    assert frames.tolist() == [10, 0, 5]
