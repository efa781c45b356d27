"""PyTorch port, the program's spans (utils/profiling.annotate) in the
three decodes of parallel/decode, on the fused, beam-only and plain routes,
on the CPU at tiny widths: no call into the profiler while none records;
under one, one root span a call, one ssnt.step a step and every span inside
its parent; and the same outputs bit for bit either way.
"""

import json
import os

import pytest
import torch

from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
from ssnt_tts_tpu_torch.parallel import decode
from ssnt_tts_tpu_torch.utils import profiling
from ssnt_tts_tpu_torch.utils.config import ModelConfig, V2BeamConfig

TINY = ModelConfig(vocab_size=32, mel_dim=8, encoder_dim=32, encoder_layers=1,
                   encoder_heads=2, decoder_dim=32, joint_rank=8,
                   duration_class_size=5, tone_class_size=4,
                   dtype="bfloat16", duration_table=tuple(range(5)))
B, T, W, FRAMES = 3, 6, 3, 10
ROUTES = {"fused": {}, "beam_only": {"fuse_model": False},
          "plain": {"fuse_model": False, "use_pallas": False}}
KINDS = ("v1", "v2", "tone")
ROOT = {"v1": "ssnt.v1.decode", "v2": "ssnt.v2.decode",
        "tone": "ssnt.tone.decode"}
# Each span's parent, and its count in a decode.
PARENT = {"ssnt.encode": "root", "ssnt.weights": "root", "ssnt.paths": "root",
          "ssnt.steps": "root", "ssnt.step": "ssnt.steps",
          "ssnt.postprocess": "root", "ssnt.backtrace": "ssnt.postprocess",
          "ssnt.mel_gather": "ssnt.postprocess",
          "ssnt.upsample": "ssnt.postprocess"}


def expected_counts(kind, route):
    counts = {ROOT[kind]: 1, "ssnt.encode": 1, "ssnt.steps": 1,
              "ssnt.step": FRAMES if kind == "v1" else T,
              "ssnt.postprocess": 1, "ssnt.backtrace": 1}
    if route == "fused":
        counts.update({"ssnt.weights": 1, "ssnt.paths": 1})
    if kind == "v1":
        counts["ssnt.mel_gather"] = 1
    if kind == "v2":
        counts["ssnt.upsample"] = 1
    return counts


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(22)
    m = SSNTModel(TINY, device="cpu")
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    return m.eval()


def run(model, kind, route):
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(1, TINY.vocab_size, (B, T), generator=g)
    il = torch.tensor([T, T - 1, T - 2], dtype=torch.int32)
    kw = ROUTES[route]
    if kind == "v1":
        return decode.beam_decode(model, tokens, il, max_frames=FRAMES,
                                  beam_width=W, **kw)
    if kind == "v2":
        return decode.v2_duration_decode(
            model, tokens, il, il * 3, TINY.duration_table, beam_width=W,
            max_frames=3 * T, config=V2BeamConfig(), **kw)
    return decode.tone_decode(model, tokens, il, beam_width=W, **kw)


def traced(model, kind, route, logdir):
    with profiling.trace(str(logdir)) as prof:
        out = run(model, kind, route)
    events = json.loads(open(prof.trace_file).read())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("ssnt.")]
    return out, spans


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", KINDS)
def test_no_record_function_without_a_profiler(model, kind, route,
                                               monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.annotate("ssnt.step") is profiling.annotate("ssnt.x")
    run(model, kind, route)
    # The patch is the one annotate would call under a profiler.
    with torch.profiler.profile():
        with pytest.raises(AssertionError, match="entered"):
            profiling.annotate("ssnt.step")


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", KINDS)
def test_span_tree_under_the_profiler(model, kind, route, tmp_path):
    _, spans = traced(model, kind, route, tmp_path)
    counts = {}
    for e in spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert counts == expected_counts(kind, route)
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    for name, ivs in by.items():
        if name == ROOT[kind]:
            continue
        parent = PARENT[name]
        outer = by[ROOT[kind] if parent == "root" else parent]
        for s, e in ivs:
            assert any(ps <= s and e <= pe for ps, pe in outer), (name, s)
    # Siblings follow one another: the loop's steps do not overlap.
    steps = sorted(by["ssnt.step"])
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))
    assert len(os.listdir(tmp_path)) == 1


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("kind", KINDS)
def test_outputs_bit_for_bit_with_and_without_the_profiler(model, kind, route,
                                                           tmp_path):
    plain = run(model, kind, route)
    under, spans = traced(model, kind, route, tmp_path)
    assert spans
    assert plain.keys() == under.keys()
    for k in plain:
        assert plain[k].dtype == under[k].dtype, k
        assert torch.equal(plain[k], under[k]), k
