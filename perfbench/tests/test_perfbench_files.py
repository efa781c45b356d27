"""Every file the harness finds by name loads, and every name and unit
keeps to the benchmark's characters."""

import dataclasses
import json
import math
import re
from pathlib import Path

import pytest

from perfbench import harness, trace
from perfbench import traffic_gen as traffic
from perfbench.arch import architecture

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    for key in ("name", "config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key]), entry[key]
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"]), entry["unit"]
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    spec = harness.cell_spec(cell, BENCH)
    assert {"check_rows", "keep_per_batch", "traced_batches",
            "limits"} <= set(spec["workload"])
    assert {"entry", "batch", "beam"} <= set(spec["mix"])
    assert spec["mix"]["entry"] in harness.ENTRIES
    # Every cell reports setup_s, another end-to-end metric and a
    # per-layer one.
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers(metric):
    assert callable(harness.reader(metric["name"]))
    if metric in BENCH["per_layer"]:
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert set(metric.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(config):
    from ssnt_tts_tpu_torch.utils.config import ModelConfig
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    mc = harness.model_config(cfg)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    for key, value in cfg.items():
        if key in fields:
            got = getattr(mc, key)
            assert (list(got) if isinstance(got, tuple) else got) == value
    if "parameters" in cfg:
        total = sum(math.prod(s) for s, _ in
                    architecture(cfg).ref.param_shapes(cfg).values())
        assert total == cfg["parameters"]


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_architecture_resolves(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    arch = architecture(cfg)
    for kind, mod in (("reference", arch.ref), ("counts", arch.counts)):
        assert Path(mod.__file__) == ROOT / "perfbench" / kind / \
            f"{arch.name}.py"


def fault_fields_hold(span: str, cfg: dict):
    """The step's span carries what perfbench/faults.py needs, and it
    names the step's arguments and output fields."""
    import inspect
    import typing
    f = trace.span_specs()[span]["fault"]
    assert set(f) == {"args", "outputs", "classes"}
    assert set(f["args"]) == {"state", "log_prob"}
    assert set(f["outputs"]) == {"prediction", "state"}
    owner, attr = trace.owner_of(trace.span_specs()[span])
    step = getattr(owner, attr)
    assert set(f["args"].values()) <= set(inspect.signature(step).parameters)
    out = typing.get_type_hints(step)["return"]
    assert set(f["outputs"].values()) <= set(out._fields)
    classes = f["classes"]
    assert isinstance(classes, int) or isinstance(cfg[classes], int)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_step_carries_the_fault_fields(cell):
    spec = harness.cell_spec(cell, BENCH)
    fault_fields_hold(spec["step"], spec["cfg"])


def test_beam_only_step_carries_the_fault_fields():
    from perfbench.tests.small import TINY
    fault_fields_hold("v1_beam_step", TINY)


def test_spans_name_program_calls():
    import importlib
    for name, spec in trace.span_specs().items():
        owner = importlib.import_module(spec["module"])
        for part in spec["attr"].split("."):
            owner = getattr(owner, part)
        assert callable(owner), name


def test_each_pair_of_config_and_traffic_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_traffic_files():
    for path in sorted((ROOT / "perfbench" / "traffic").glob("*.json")):
        mix = traffic.load(path.stem)
        assert mix["entry"] in harness.ENTRIES
        assert mix["min_len"] <= mix["max_len"] <= mix["pad_to"]
