"""Seconds per step by the two-point slope (the port of
ssnt_tts_tpu/utils/timing.py).

A chain of n data-dependent iterations of a step runs eagerly; on the card
two CUDA events on the current stream bracket the chain, and the time
between them is read after the second has completed, so the chain's launch
overhead and any host work between launches count, as they do in a
training run. On the CPU the chain is timed with time.perf_counter. Two
chain lengths are timed and the slope (t_hi - t_lo) / (n_hi - n_lo)
cancels what a chain costs once (the first launch, the final wait).
"""

from __future__ import annotations

import dataclasses
import time

import torch


def _tensors(tree):
    """The tensors of a nest of tensors, modules, dataclasses (a
    TrainState), dicts (in sorted key order), lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from (p.detach() for p in tree.parameters())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _device(tree) -> torch.device:
    return next(_tensors(tree), torch.empty(0)).device


def _scalarize(tree) -> torch.Tensor:
    """A float32 scalar that depends on every tensor of `tree` (its first
    element, or the sum over an empty leading axis)."""
    acc = torch.zeros((), dtype=torch.float32, device=_device(tree))
    for leaf in _tensors(tree):
        sl = leaf
        while sl.ndim > 0:
            sl = sl[0] if sl.shape[0] else sl.sum(0)
        acc = acc + sl.float()
    return acc


def _chain_seconds(make_step, x0, n: int) -> float:
    dev = _device(x0)
    x = x0
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(n):
            x = make_step(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        x = make_step(x)
    return time.perf_counter() - t0


def bench_step(make_step, x0, *, n_lo: int = 10, n_hi: int = 60,
               repeats: int = 3, target_delta_s: float = 0.25,
               max_iters: int = 5000) -> float:
    """Median seconds per step of `make_step` (x -> x-like, each output the
    next input), by the slope between chains of n_lo and n_hi steps from
    x0, each the median of `repeats` runs. n_hi is raised (x4 at a time,
    up to max_iters) until its chain is target_delta_s slower than the n_lo
    chain, so the slope spans more time than the chains' jitter. A step
    that updates x in place (train_step on a TrainState) moves x0 on from
    run to run; time a copy."""
    run = lambda n: _chain_seconds(make_step, x0, n)
    run(n_lo)  # warm: first launches, allocator, library loads
    t_probe = run(n_lo)
    n = max(n_hi, 4 * n_lo)
    while n < max_iters and run(n) - t_probe < target_delta_s:
        n *= 4
    n_hi = min(n, max_iters)

    def timed(n):
        ts = sorted(run(n) for _ in range(repeats))
        return ts[len(ts) // 2]

    t_lo, t_hi = timed(n_lo), timed(n_hi)
    return max((t_hi - t_lo) / (n_hi - n_lo), 1e-9)


def bench_fn(fn, *args, n_lo: int = 10, n_hi: int = 60,
             repeats: int = 3) -> float:
    """bench_step for a function of constant arguments: the chain moves
    the first (floating) argument by 1e-12 times a scalar of the output,
    keeping its dtype."""
    first, rest = args[0], args[1:]

    def step(x):
        out = fn(x, *rest)
        return (x + _scalarize(out) * 1e-12).to(x.dtype)

    return bench_step(step, first, n_lo=n_lo, n_hi=n_hi, repeats=repeats)
