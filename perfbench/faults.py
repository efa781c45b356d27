"""Faults planted in the timed path underneath the harness, for the tests
(perfbench/tests, a tiny size on the CPU) and for their readings at a
cell's own size on the card (perfbench/calibrate.py). Each is a context
manager for an entry ("v1" or "v2") that breaks the program's decode
while inside and mends it on leaving:

  state_unchanged     every fused step returns the state it was given
  half_batch          half of the batch left out: the decode runs the
                      first half, the second half's outputs are copies
  prediction_altered  every seventh step alters the first slot's
                      prediction where the step makes it
  scores_swapped      every step selects by the first two slots'
                      log-probs swapped, so it keeps candidates that rank
                      below ones it drops, and they carry the swapped
                      log-probs

The cells run on one card: there is no exchange between cards to leave
out.
"""

from __future__ import annotations

import contextlib
import functools
import itertools

import torch

# entry -> (the fused step, the index of its state and of its log-prob
# arguments)
STEPS = {"v1": ("fused_v1_beam_step", 7, 3),
         "v2": ("fused_class_beam_step", 5, 6)}
CLASSES = {"v1": lambda cfg: 2, "v2": lambda cfg: cfg["duration_class_size"]}


@contextlib.contextmanager
def _replaced(owner, key, new, item=False):
    get = owner.__getitem__ if item else lambda k: getattr(owner, k)
    put = owner.__setitem__ if item else lambda k, v: setattr(owner, k, v)
    old = get(key)
    put(key, new(old))
    try:
        yield
    finally:
        put(key, old)


def _step(entry, change):
    """Replaces the entry's fused step by change(step, args, kwargs, n),
    n counting the calls from 1."""
    from ssnt_tts_tpu_torch.ops import beam_fused
    calls = itertools.count(1)

    def wrap(orig):
        def step(*a, **k):
            return change(orig, list(a), k, next(calls))
        # The step counts its launches on its own attribute, which the
        # module's name then finds on the replacement.
        return functools.update_wrapper(step, orig)

    return _replaced(beam_fused, STEPS[entry][0], wrap)


def state_unchanged(entry, cfg):
    idx = STEPS[entry][1]
    return _step(entry, lambda f, a, k, n: f(*a, **k)._replace(state=a[idx]))


def half_batch(entry, cfg):
    from perfbench import harness

    def wrap(pair):
        call, frames = pair

        def half(model, batch, mix):
            B = batch["tokens"].shape[0]
            part = {key: v[:B // 2] for key, v in batch.items()}
            out = call(model, part, mix)
            return {key: torch.cat([v, v])[:B] for key, v in out.items()}

        return half, frames

    return _replaced(harness.ENTRIES, entry, wrap, item=True)


def prediction_altered(entry, cfg):
    classes = CLASSES[entry](cfg)

    def change(f, a, k, n):
        o = f(*a, **k)
        if n % 7 != 3:
            return o
        pred = o.prediction.clone()
        pred[:, 0] = (pred[:, 0] + 1) % classes
        return o._replace(prediction=pred)

    return _step(entry, change)


def scores_swapped(entry, cfg):
    idx = STEPS[entry][2]

    def change(f, a, k, n):
        lp = a[idx].clone()
        lp[:, [0, 1]] = lp[:, [1, 0]]
        a[idx] = lp
        return f(*a, **k)

    return _step(entry, change)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  prediction_altered, scores_swapped)}
