"""The program's own spans in a traced segment (ssnt_tts_tpu_torch's
parallel/decode opens them: ssnt.*), and the split of the traced batches'
time among them that the per-layer readers take.

The split runs along the profiler's one clock, over the harness's request
spans, and gives each instant to one program span:
  - while an operation runs on the device, to the innermost program span
    that was open when the operation was launched (found through the
    launch's correlation id, as trace.reduce does); where operations
    overlap, the one that started first holds the instant;
  - while the device idles, to the innermost program span open on the
    host.
An instant inside a request and outside every program span goes to
"request": the harness's own work, its copies to the host among it. A
root span (one a decode call) keeps what lies inside the call and outside
its layers. So the parts add up to the requests' length, and a layer's
time never counts twice where its operations overlap another's.

A trace of a program without these spans holds no root span: every reader
then returns None.
"""

from __future__ import annotations

from collections import defaultdict

from perfbench.trace import REQUEST

ROOTS = ("ssnt.v1.decode", "ssnt.v2.decode", "ssnt.tone.decode")
ROOT_SET = frozenset(ROOTS)
# Inner spans first: a span comes before every span that can hold it.
INNER_FIRST = ("ssnt.step", "ssnt.backtrace", "ssnt.mel_gather",
               "ssnt.upsample", "ssnt.encode", "ssnt.weights", "ssnt.paths",
               "ssnt.steps", "ssnt.postprocess") + ROOTS
LAYERS = {
    "encoder": ("ssnt.encode",),
    "hoisted": ("ssnt.weights", "ssnt.paths"),
    "steps": ("ssnt.steps", "ssnt.step"),
    "postprocess": ("ssnt.postprocess", "ssnt.backtrace", "ssnt.mel_gather",
                    "ssnt.upsample"),
}


def innermost(names) -> str:
    """The innermost program span among `names`, else "request"."""
    return next((n for n in INNER_FIRST if n in names), REQUEST)


def roots(tr: dict) -> int:
    """The decode calls that started inside a request."""
    req = tr["spans"].by.get(REQUEST, [])
    return sum(1 for r in ROOTS for s, _ in tr["spans"].by.get(r, ())
               if any(a <= s <= b for a, b in req))


def breakdown(tr: dict) -> dict:
    """{program span or "request": [device-busy µs, device-idle µs]} over
    the traced segment's requests (module docstring)."""
    by = tr["spans"].by
    deltas = defaultdict(list)
    for s, e in by.get(REQUEST, ()):
        deltas[s].append((REQUEST, 1))
        deltas[e].append((REQUEST, -1))
    for name in INNER_FIRST:
        for s, e in by.get(name, ()):
            deltas[s].append((name, 1))
            deltas[e].append((name, -1))
    for i, o in enumerate(tr["ops"]):
        if o["dur"] > 0:
            deltas[o["ts"]].append((i, 1))
            deltas[o["ts"] + o["dur"]].append((i, -1))
    open_, running = defaultdict(int), {}
    out = defaultdict(lambda: [0.0, 0.0])
    times = sorted(deltas)
    for a, b in zip(times, times[1:]):
        for key, d in deltas[a]:
            if isinstance(key, str):
                open_[key] += d
            elif d > 0:
                o = tr["ops"][key]
                running[key] = (o["ts"], key, innermost(o["spans"]))
            else:
                running.pop(key, None)
        if open_[REQUEST] <= 0:
            continue
        if running:
            out[min(running.values())[2]][0] += b - a
        else:
            host = next((n for n in INNER_FIRST if open_[n] > 0), REQUEST)
            out[host][1] += b - a
    return dict(out)


def layer_ms(run: dict, layer: str):
    """Milliseconds a decode call of `layer` (LAYERS), device-busy and
    device-idle instants together; None without a trace or a root span."""
    tr = run["trace"]
    n = roots(tr) if tr else 0
    if not n:
        return None
    bd = breakdown(tr)
    return sum(sum(bd.get(name, (0.0, 0.0))) for name in LAYERS[layer]) \
        * 1e-3 / n


def step_host_us(run: dict):
    """Host microseconds a ssnt.step span, over their count."""
    tr = run["trace"]
    if not tr or not roots(tr):
        return None
    steps = tr["spans"].by.get("ssnt.step", [])
    return sum(e - s for s, e in steps) / len(steps) if steps else None


def device_ops_per_call(run: dict):
    """Device operations (kernels, copies, memsets) launched inside a root
    span, over the number of root spans."""
    tr = run["trace"]
    n = roots(tr) if tr else 0
    if not n:
        return None
    return sum(1 for o in tr["ops"] if o["spans"] & ROOT_SET) / n
