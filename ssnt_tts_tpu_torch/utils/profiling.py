"""Profiling hooks (the port of ssnt_tts_tpu/utils/profiling.py):
torch.profiler traces and the program's spans.

    with trace("traces/step") as prof:  # a Chrome trace (chrome://tracing,
        with annotate("step"):          # Perfetto) under traces/step/
            run_step()
    kernel_time(prof.trace_file)    # the device's busy time

A span (`annotate`) is recorded only while a torch profiler records: it is
then a `record_function`, kept by the profiler and written at export on
the device trace's clock. With no profiler active it is one shared no-op
context, so the decodes' spans cost a check each and nothing else.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU, and CUDA when a card is present) and write
    its Chrome trace to logdir/trace-<pid>-<ns>.json on exit. Yields the
    torch.profiler.profile, whose key_averages() summarize the block; its
    trace_file names the written trace after the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_file = os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_file)


def kernel_time(trace_file: str) -> dict:
    """The device of a Chrome trace (trace's): the number of its kernels,
    and its busy ms, the union of the intervals of its kernels, copies and
    memsets, so that operations that overlap count once (None where the
    trace holds no device operation, as on the CPU)."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    ops = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                 if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for s, e in ops:
        busy += max(e - max(s, end), 0.0)
        end = max(end, e)
    return {"kernels": sum(e.get("cat") == "kernel" for e in events),
            "busy_ms": busy / 1e3 if ops else None}


def annotate(name: str):
    """A named span of the program: a `record_function` while a torch
    profiler records, else a shared no-op context (no profiler call, no
    allocation). `name` is a constant, so an idle span builds nothing."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
