"""Profiling hooks (the port of ssnt_tts_tpu/utils/profiling.py):
torch.profiler traces and a wall-clock timer.

    with trace("traces/step") as prof:  # a Chrome trace (chrome://tracing,
        with annotate("step"):          # Perfetto) under traces/step/
            run_step()
    kernel_time(prof.trace_file)    # the device kernels' busy time
    with timer() as t:
        run_step()
    print(t.elapsed)
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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
    """The device kernels of a Chrome trace (trace's): their count and
    busy ms (the sum of their durations; None where the trace holds no
    kernel, as on the CPU)."""
    with open(trace_file) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"kernels": len(kernels),
            "busy_ms": (sum(e.get("dur", 0) for e in kernels) / 1e3
                        if kernels else None)}


class timer(contextlib.AbstractContextManager):
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
        return False


def annotate(name: str):
    """A named region that shows in profiler traces."""
    return record_function(name)
