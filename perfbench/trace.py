"""The traced segment: spans around the program's layer calls, a profiler
trace of the device, and its reduction to what the per-layer readers
read.

Each span is a file perfbench/spans/<name>.json naming a callable of the
program ({"module": ..., "attr": "func" or "Class.method"}; a step's span
also carries the fields perfbench/faults.py reads); while traced,
the harness wraps that callable in a `torch.profiler.record_function` of
the span's name, and the harness's own "request" span covers each batch
from its send until its outputs are on the host. A device operation is
attributed to every span that was open on the host when it was launched
(the launch found through the profiler's correlation id), so the layer a
kernel belongs to follows the call that launched it, not its name.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import json
from collections import Counter, defaultdict
from pathlib import Path

import torch

from perfbench.counts import roofline

HERE = Path(__file__).resolve().parent
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
REQUEST = "request"


def span_specs() -> dict:
    return {p.stem: json.loads(p.read_text())
            for p in sorted((HERE / "spans").glob("*.json"))}


def owner_of(spec: dict):
    """(the object that holds a span's callable, the callable's name)."""
    owner = importlib.import_module(spec["module"])
    *path, attr = spec["attr"].split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, attr


@contextlib.contextmanager
def spans():
    """Wrap every span's callable in a record_function while inside."""
    undo = []
    try:
        for name, spec in span_specs().items():
            owner, attr = owner_of(spec)
            fn = getattr(owner, attr)

            def wrapped(*a, _fn=fn, _name=name, **k):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **k)

            functools.update_wrapper(wrapped, fn)
            setattr(owner, attr, wrapped)
            undo.append((owner, attr, fn))
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            setattr(owner, attr, fn)


def union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Spans:
    """Host spans by name, for containment queries."""

    def __init__(self, events):
        by = defaultdict(list)
        for e in events:
            by[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
        self.by = {k: sorted(v) for k, v in by.items()}
        self.starts = {k: [s for s, _ in v] for k, v in self.by.items()}

    def open_at(self, ts):
        """{name: span length} of the spans open at host time ts."""
        found = {}
        for name, iv in self.by.items():
            i = bisect.bisect_right(self.starts[name], ts) - 1
            if i >= 0 and iv[i][1] >= ts:
                found[name] = iv[i][1] - iv[i][0]
        return found

    def count(self, name):
        return len(self.by.get(name, ()))


def reduce(path: Path, top: int = 10) -> dict:
    """The chrome trace at `path` -> the traced window's device operations
    with the spans open at their launch, busy and window seconds, and the
    breakdown (device operations by time, idle gaps by host span)."""
    events = json.loads(path.read_text())["traceEvents"]
    launch = {}
    ann, dev = [], []
    for e in events:
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
        elif cat == "user_annotation":
            ann.append(e)
        elif cat in DEVICE_CATS:
            dev.append(e)
    sp = Spans(ann)
    req = sp.by.get(REQUEST, [])
    if not req:
        raise RuntimeError("the trace holds no request span")
    w0, w1 = req[0][0], req[-1][1]
    ops = []
    for e in dev:
        s, d = e["ts"], e.get("dur", 0)
        if s + d < w0 or s > w1:
            continue
        at = launch.get(e.get("args", {}).get("correlation"))
        ops.append({"name": e["name"], "ts": s, "dur": d,
                    "spans": frozenset(sp.open_at(at)) if at is not None
                    else frozenset()})
    busy = union((max(o["ts"], w0), min(o["ts"] + o["dur"], w1))
                 for o in ops)
    by_name = Counter()
    for o in ops:
        by_name[o["name"]] += o["dur"] * 1e-6
    idle = Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            host = sp.open_at((a + b) / 2)
            name = min(host, key=host.get) if host else "outside any span"
            idle[name] += (b - a) * 1e-6
    return {
        "ops": ops, "spans": sp,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_ops": [[n, v] for n, v in by_name.most_common(top)],
        "idle_gaps": [[n, v] for n, v in idle.most_common(top)],
    }


def device_us_per_call(tr: dict, span: str):
    """Device microseconds that the calls of `span` launched, a call; None
    where the trace holds no such call."""
    calls = tr["spans"].count(span)
    total = sum(o["dur"] for o in tr["ops"] if span in o["spans"])
    return total / calls if calls and total else None


def step_device_us(run: dict, span: str):
    """A step reader's device microseconds a call of `span` in the run's
    traced segment; None without a trace or such a call."""
    return device_us_per_call(run["trace"], span) if run["trace"] else None


def roofline_share(run: dict, span: str, kind: str):
    """The share of its roofline, in percent, that a call of `span` (a
    step whose counts are the architecture's <kind>_step_flops and
    <kind>_step_bytes, perfbench/counts) reached: the least time the card
    could take for one step over the device time a call took; None where
    either is missing."""
    us = step_device_us(run, span)
    B, W = run["mix"]["batch"], run["mix"]["beam"]
    cfg, counts = run["cfg"], run["arch"].counts
    flops = getattr(counts, f"{kind}_step_flops")(cfg, B, W)
    nbytes = getattr(counts, f"{kind}_step_bytes")(cfg, B, W)
    bound = roofline.bound_s(flops, nbytes, cfg, run["kind"])
    if not us or bound is None:
        return None
    return 100.0 * bound / (us * 1e-6)
