"""Profiling hooks (the port of ssnt_tts_tpu/utils/profiling.py):
torch.profiler traces and a wall-clock timer.

    with trace("traces/step"):      # a Chrome trace (chrome://tracing,
        with annotate("step"):      # Perfetto) under traces/step/
            run_step()
    with timer() as t:
        run_step()
    print(t.elapsed)
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (CPU, and CUDA when a card is present) and write
    its Chrome trace to logdir/trace-<pid>-<ns>.json on exit. Yields the
    torch.profiler.profile, whose key_averages() summarize the block."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


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
