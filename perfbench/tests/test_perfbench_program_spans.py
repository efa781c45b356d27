"""The readers of the program's spans (perfbench/program_spans.py and the
six metrics on it) against a hand-made chrome trace whose split is worked
out by hand, and on a traced run of the small CPU cells."""

import json
import math

import pytest

from perfbench import harness, program_spans, trace
from perfbench.tests import small

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SIX = ("encoder.ms", "hoisted.ms", "steps.ms", "postprocess.ms",
       "decode_step.host_us", "decode.device_ops_per_batch")

# Two requests (µs). Request 1, a v1 decode: the encoder's kernel runs on
# into the weights' span and overlaps the weights' copy; a step's kernel
# outlasts its host span; the harness's copy after the decode. Request 2,
# a v2 decode: hoisted paths with no launch (idle alone), an operation
# whose launch is not in the trace. Harness spans ("encoder", "v1_step")
# sit inside program spans and are not program spans.
SPANS = [
    ("request", 0, 100), ("ssnt.v1.decode", 2, 90), ("ssnt.encode", 5, 20),
    ("encoder", 5.5, 19.5), ("ssnt.weights", 20, 25), ("ssnt.paths", 25, 30),
    ("ssnt.steps", 30, 60), ("ssnt.step", 31, 40), ("v1_step", 31.5, 39.5),
    ("ssnt.step", 41, 50), ("ssnt.postprocess", 60, 85),
    ("ssnt.backtrace", 61, 75), ("ssnt.mel_gather", 76, 84),
    ("request", 200, 260), ("ssnt.v2.decode", 201, 255),
    ("ssnt.encode", 202, 210), ("ssnt.paths", 210, 214),
    ("ssnt.weights", 214, 218), ("ssnt.steps", 218, 240),
    ("ssnt.step", 219, 229), ("ssnt.step", 229, 239),
    ("ssnt.postprocess", 240, 252), ("ssnt.backtrace", 241, 246),
    ("ssnt.upsample", 246, 250),
]
# (correlation, launch ts or None, category, start, end)
OPS = [
    (1, 6, "kernel", 8, 23), (2, 21, "gpu_memcpy", 22, 26),
    (3, 26, "kernel", 27, 29), (4, 32, "kernel", 33, 45),
    (5, 42, "kernel", 45, 52), (6, 62, "kernel", 63, 66),
    (7, 77, "gpu_memset", 78, 80), (8, 91, "gpu_memcpy", 92, 97),
    (9, 203, "kernel", 204, 209), (10, 220, "kernel", 221, 235),
    (11, 230, "kernel", 235, 238), (12, 247, "kernel", 248, 249),
    (13, None, "kernel", 256, 258),
]
# The split by hand, µs: [device busy, device idle].
SPLIT = {
    "request": [5 + 2, 2 + 2 + 3 + 1 + 1 + 2],
    "ssnt.v1.decode": [0, 3 + 5], "ssnt.v2.decode": [0, 1 + 3],
    "ssnt.encode": [15 + 5, 3 + 2 + 1],
    "ssnt.weights": [3, 4], "ssnt.paths": [2, 1 + 1 + 4],
    "ssnt.steps": [0, 1 + 8 + 1 + 1],
    "ssnt.step": [12 + 7 + 14 + 3, 2 + 2 + 1],
    "ssnt.postprocess": [0, 1 + 1 + 1 + 1 + 2],
    "ssnt.backtrace": [3, 2 + 9 + 5], "ssnt.mel_gather": [2, 2 + 4],
    "ssnt.upsample": [1, 3],
}
BY_HAND = {"encoder.ms": 26 / 2 / 1e3, "hoisted.ms": 15 / 2 / 1e3,
           "steps.ms": 52 / 2 / 1e3, "postprocess.ms": 37 / 2 / 1e3,
           "decode_step.host_us": (9 + 9 + 10 + 10) / 4,
           "decode.device_ops_per_batch": 11 / 2}


def write_trace(path, spans, ops):
    events = [{"cat": "user_annotation", "name": n, "ts": s, "dur": e - s}
              for n, s, e in spans]
    for c, at, cat, s, e in ops:
        if at is not None:
            events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": at, "dur": 0.5, "args": {"correlation": c}})
        events.append({"cat": cat, "name": f"op{c}", "ts": s, "dur": e - s,
                       "args": {"correlation": c}})
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.reduce(path)


def test_split_of_a_hand_made_trace(tmp_path):
    tr = write_trace(tmp_path / "t.json", SPANS, OPS)
    bd = program_spans.breakdown(tr)
    assert bd == SPLIT
    assert program_spans.roots(tr) == 2
    # The parts add up to the requests' length.
    assert sum(sum(v) for v in bd.values()) == 100 + 60


@pytest.mark.parametrize("metric", SIX)
def test_readers_of_a_hand_made_trace(tmp_path, metric):
    run = {"trace": write_trace(tmp_path / "t.json", SPANS, OPS)}
    assert math.isclose(harness.reader(metric)(run), BY_HAND[metric],
                        rel_tol=1e-12)


@pytest.mark.parametrize("metric", SIX)
def test_readers_of_a_program_without_spans(tmp_path, metric):
    """The parent of the spans: the harness's spans alone, no root span;
    no trace at all."""
    spans = [s for s in SPANS if not s[0].startswith("ssnt.")]
    run = {"trace": write_trace(tmp_path / "t.json", spans, OPS)}
    assert harness.reader(metric)(run) is None
    assert harness.reader(metric)({"trace": None}) is None


@pytest.mark.parametrize("metric", SIX)
def test_metrics_entries(metric):
    entry = {m["name"]: m for m in BENCH["per_layer"]}[metric]
    assert entry["source"] == "device_trace"
    assert entry["workloads"] == [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("entry", ["v1", "v2"])
def test_traced_small_cell_reports_the_six(entry, monkeypatch):
    kept = []

    def keep(path, *a, **k):
        kept.append(reduce(path, *a, **k))
        return kept[-1]

    reduce = trace.reduce
    monkeypatch.setattr(trace, "reduce", keep)
    spec = small.spec(entry)
    spec["per_layer"] = [m for m in BENCH["per_layer"] if m["name"] in SIX]
    res = harness.run_cell("small", 2 ** 31 + 22, 0.2, True, "cpu", t0=0.0,
                           spec=spec)
    got = res["metrics"]
    assert set(got) == set(SIX)
    for name in SIX[:5]:
        assert got[name]["value"] > 0, name
    # No device operation on the CPU.
    assert got["decode.device_ops_per_batch"]["value"] == 0
    tr, = kept
    requests = sum(e - s for s, e in tr["spans"].by["request"])
    bd = program_spans.breakdown(tr)
    assert math.isclose(sum(sum(v) for v in bd.values()), requests,
                        rel_tol=1e-9)
    assert bd["request"][1] > 0
