"""One run of one cell: set-up, the measured window, the traced segment,
the check against the reference, and the result line.

Everything that belongs to one cell, configuration, traffic mix, span or
metric is a file found by its name in BENCHMARK.json:
  perfbench/workloads/<cell>.json   the check's sample and the limits of
                                    its numbers
  perfbench/configs/<config>.json   the model's sizes (ModelConfig fields)
                                    and its architecture (perfbench/arch.py)
  perfbench/traffic/<traffic>.json  the mix: batch, beams, lengths
                                    (perfbench/traffic_gen.py)
  perfbench/spans/<span>.json       a program call traced as a span
  perfbench/metrics/<metric>.py     read(run) -> the metric, or None
The traffic's `entry` names the decode it drives (ENTRIES); the workload
file may name the span of the step that the decode takes ("step", by
default DEFAULT_STEP's), where perfbench/faults.py plants its faults.

A closed loop with one client: each batch is sent when the last one's
outputs are on the host. The window runs until the first batch that ends
after --seconds; its rate and tail are taken over every batch in it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import check, trace, weights
from perfbench import traffic_gen
from perfbench.arch import architecture
from perfbench.traffic_gen import subseed

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BUILD = ROOT / "build" / "perfbench"
INPUT_NAMES = {"output_length": "target_length"}
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ssnt_tts_tpu")


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_spec(name: str, bench: dict = None) -> dict:
    """The cell's entry in BENCHMARK.json with its files, its
    configuration's architecture, the span of its step, and the metrics
    that it reports."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[name]
    applies = lambda m: name in m.get("workloads", [name])
    workload = load_json(HERE / "workloads" / f"{name}.json")
    cfg = load_json(HERE / "configs" / f"{cell['config']}.json")
    mix = traffic_gen.load(cell["traffic"])
    metrics = {kind: [m for m in bench[kind] if applies(m)]
               for kind in ("end_to_end", "per_layer")}
    counts = {n for ms in metrics.values() for m in ms
              for n in getattr(reader_module(m["name"]), "COUNTS", ())}
    return {
        "cell": cell, "workload": workload, "cfg": cfg, "mix": mix,
        "arch": architecture(cfg, mix["entry"], sorted(counts)),
        "step": workload.get("step", DEFAULT_STEP[mix["entry"]]),
        **metrics,
    }


def reader_module(metric: str):
    """perfbench/metrics/<metric>.py: its read(run), and in COUNTS the
    names it takes from the architecture's counts."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    return reader_module(metric).read


# ------------------------------------------------------------------ entries

def _v1(model, batch, mix):
    from ssnt_tts_tpu_torch.parallel import decode
    return decode.beam_decode(model, batch["tokens"], batch["input_length"],
                              max_frames=mix["max_frames"],
                              beam_width=mix["beam"])


def _v2(model, batch, mix):
    from ssnt_tts_tpu_torch.parallel import decode
    from ssnt_tts_tpu_torch.utils.config import V2BeamConfig
    return decode.v2_duration_decode(
        model, batch["tokens"], batch["input_length"],
        batch["output_length"], model.config.duration_table,
        beam_width=mix["beam"], max_frames=mix["max_frames"],
        config=V2BeamConfig())


def _v1_frames(host):
    """Frames of each utterance's best beam."""
    return host["num_frames"]


def _v2_frames(host):
    """Frames of each utterance's best beam, none where the beam emptied:
    an utterance that no hypothesis could align produces no audio."""
    return torch.where(host["beam_emptied"], 0, host["output_length"][:, 0])


# entry -> (the decode call, the frames of a completed batch's utterances)
ENTRIES = {"v1": (_v1, _v1_frames), "v2": (_v2, _v2_frames)}
# entry -> the span (perfbench/spans) of the step its decode takes, where
# the workload file names none
DEFAULT_STEP = {"v1": "v1_step", "v2": "v2_step"}


def model_config(cfg: dict):
    from ssnt_tts_tpu_torch.utils.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in cfg.items() if k in names}
    if "duration_table" in kw:
        kw["duration_table"] = tuple(kw["duration_table"])
    return ModelConfig(**kw)


def make_weights(arch, cfg: dict, mix: dict, seed: int, device) -> dict:
    spec = arch.ref.param_shapes(cfg, mix.get("frames_per_token"))
    return weights.make(spec, seed, device)


def build_model(arch, cfg: dict, mix: dict, seed: int, device):
    from ssnt_tts_tpu_torch.models.ssnt import SSNTModel
    model = SSNTModel(model_config(cfg), device=device)
    w = make_weights(arch, cfg, mix, seed, device)
    model.load_state_dict(w, strict=True)
    return model.eval()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_host(out: dict) -> dict:
    return {k: v.cpu() for k, v in out.items()}


def keep_rows(host, batch, idx):
    """The outputs and inputs of rows idx; a v2 batch's output_length
    input is kept as target_length, beside the outputs' own."""
    rows = []
    inputs = {INPUT_NAMES.get(k, k): v.cpu() for k, v in batch.items()}
    for r in idx:
        row = {k: v[r].numpy() for k, v in host.items()}
        row.update({k: v[r].numpy() for k, v in inputs.items()})
        rows.append(row)
    return rows


def sample(rows, n, seed):
    """n rows drawn from the seed, one of the longest among them."""
    rng = np.random.default_rng(subseed(seed, "sample"))
    lens = np.array([int(r["input_length"]) for r in rows])
    longest = rng.choice(np.flatnonzero(lens == lens.max()))
    rest = rng.permutation([i for i in range(len(rows)) if i != longest])
    return [rows[i] for i in [longest, *rest[:max(n - 1, 0)]]]


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             *, t0: float, spec: dict = None, control: bool = False) -> dict:
    """Runs the cell and returns the result (the dict of the result line,
    and "numbers" / "limits" of the check). `spec` replaces cell_spec's
    (the tests' small cells); `control` also reads the control's numbers
    (the calibration of the limits, never a benchmark run)."""
    spec = spec or cell_spec(name)
    w, cfg, mix, arch = (spec[k] for k in ("workload", "cfg", "mix", "arch"))
    call, frames_of = ENTRIES[mix["entry"]]
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    model = build_model(arch, cfg, mix, seed, device)
    traffic = traffic_gen.Traffic(mix, cfg["vocab_size"], seed, device)

    def run_batch(batch):
        return to_host(call(model, batch, mix))

    run_batch(traffic.batch(-1))                 # warm-up: every shape
    sync(device)
    start = time.perf_counter()
    setup_s = start - t0
    batches, kept, attempted, failed, i = [], [], 0, 0, 0
    while time.perf_counter() - start < seconds:
        batch = traffic.batch(i)
        attempted += 1
        sent = time.perf_counter()
        try:
            host = run_batch(batch)
        except (RuntimeError, ValueError) as e:
            failed += 1
            print(f"batch {i} failed: {e}", file=sys.stderr)
        else:
            lat = time.perf_counter() - sent
            frames = frames_of(host)
            batches.append({"lat_s": lat,
                            "audio_s": float(frames.sum()) * mix["hop_s"],
                            "landed": float((frames > 0).float().mean())})
            g = np.random.default_rng(subseed(seed, "keep", i))
            il = batch["input_length"].cpu().numpy()
            idx = {int(np.argmax(il))}
            idx.update(g.choice(len(il), w["keep_per_batch"],
                                replace=False).tolist())
            kept += keep_rows(host, batch, sorted(idx))
        i += 1
    window_s = time.perf_counter() - start

    tr = None
    if traced:
        tr = trace_segment(run_batch, traffic, i, w["traced_batches"],
                           device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del model, traffic, run_batch
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rows = sample(kept, w["check_rows"], seed) if kept else []
    limits = w["limits"]
    check_start = time.perf_counter()
    if rows:
        ref_w = make_weights(arch, cfg, mix, seed, device)
        numbers = check.judge(arch.ref, mix["entry"], ref_w, cfg, rows, w,
                              mix, device, control)
    else:
        numbers = {"program": {k: float("inf") for k in limits},
                   "control": {}}
    correct = check.verdict(numbers["program"], limits) and not failed
    check_s = time.perf_counter() - check_start

    run = {"entry": mix["entry"], "cfg": cfg, "arch": arch, "mix": mix,
           "workload": w, "batches": batches, "window_s": window_s,
           "setup_s": setup_s, "trace": tr,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu")}
    metrics = {}
    for m in (spec["per_layer"] if traced else spec["end_to_end"]):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lat = [b["lat_s"] * 1e3 for b in batches]
    result = {
        "correct": bool(correct), "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": run["kind"], "count": spec["cell"]["chips"],
                   "memory_peak_bytes": int(peak)},
        "latency": {"batches": len(lat),
                    "median_ms": statistics.median(lat) if lat else None,
                    "landed": (statistics.mean(b["landed"] for b in batches)
                               if batches else None),
                    "check_s": check_s, "rows": len(rows)},
    }
    if tr is not None:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["numbers"], result["limits"] = numbers, limits
    return result


def trace_segment(run_batch, traffic, first: int, n: int, device) -> dict:
    """n batches under the profiler, with the program's spans."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / "trace.json"
    batches = [traffic.batch(first + j) for j in range(n)]
    with trace.spans(), profile(activities=acts) as prof:
        for b in batches:
            with record_function(trace.REQUEST):
                run_batch(b)
    prof.export_chrome_trace(str(path))
    try:
        return trace.reduce(path)
    finally:
        path.unlink(missing_ok=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=False).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi gave nothing"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv, t0: float) -> int:
    import argparse
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA card(s), this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    res = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda", t0=t0, spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"no result: the process holds {bad}", file=sys.stderr)
        return 3
    numbers, limits = res.pop("numbers"), res.pop("limits")
    lat = res.pop("latency")
    print(f"batches {lat['batches']}, median latency {lat['median_ms']} ms, "
          f"share of utterances landed {lat['landed']}; "
          f"check of {lat['rows']} rows {lat['check_s']:.1f} s; readings "
          f"{json.dumps(numbers['program'])}; card {card_line()}",
          file=sys.stderr)
    checks = {k: {"value": numbers["program"][k], "limit": v}
              for k, v in limits.items()}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    res["checks"] = checks
    print(json.dumps(res), flush=True)
    return 0
