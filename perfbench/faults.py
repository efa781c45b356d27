"""Faults planted in the timed path underneath the harness, for the tests
(perfbench/tests, a tiny size on the CPU) and for their readings at a
cell's own size on the card (perfbench/calibrate.py). Each is a context
manager for a cell's spec (harness.cell_spec) that breaks the program's
decode while inside and mends it on leaving:

  state_unchanged     every step returns the state it was given
  half_batch          half of the batch left out: the decode runs the
                      first half, the second half's outputs are copies
  prediction_altered  every seventh step alters the first slot's
                      prediction where the step makes it
  scores_swapped      every step selects by the first two slots'
                      log-probs swapped, so it keeps candidates that rank
                      below ones it drops, and they carry the swapped
                      log-probs

The step is the cell's (spec["step"]): its span file
perfbench/spans/<step>.json names the program's callable and, under
"fault", what the faults need of it:
  args      {"state": ..., "log_prob": ...} the names of the step's
            arguments that hold the beams' state and their log-probs
  outputs   {"prediction": ..., "state": ...} the names of the fields of
            the step's output (a named tuple) that hold them
  classes   the number of classes a prediction takes: a number, or the
            key of the configuration that holds it
half_batch wraps the entry's decode call (harness.ENTRIES), whatever step
it takes.

The cells run on one card: there is no exchange between cards to leave
out.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import itertools

import torch

from perfbench import trace


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


def _fields(spec) -> dict:
    """The "fault" fields of the cell's step's span file."""
    return trace.span_specs()[spec["step"]]["fault"]


def _step(spec, change):
    """Replaces the cell's step by change(step, bound arguments, n), n
    counting the calls from 1."""
    owner, attr = trace.owner_of(trace.span_specs()[spec["step"]])
    calls = itertools.count(1)

    def wrap(orig):
        sig = inspect.signature(orig)

        def step(*a, **k):
            return change(orig, sig.bind(*a, **k), next(calls))
        # The step counts its launches on its own attribute, which the
        # module's name then finds on the replacement.
        return functools.update_wrapper(step, orig)

    return _replaced(owner, attr, wrap)


def _call(f, bound):
    return f(*bound.args, **bound.kwargs)


def state_unchanged(spec):
    f = _fields(spec)

    def change(step, bound, n):
        out = {f["outputs"]["state"]: bound.arguments[f["args"]["state"]]}
        return _call(step, bound)._replace(**out)

    return _step(spec, change)


def half_batch(spec):
    from perfbench import harness

    def wrap(pair):
        call, frames = pair

        def half(model, batch, mix):
            B = batch["tokens"].shape[0]
            part = {key: v[:B // 2] for key, v in batch.items()}
            out = call(model, part, mix)
            return {key: torch.cat([v, v])[:B] for key, v in out.items()}

        return half, frames

    return _replaced(harness.ENTRIES, spec["mix"]["entry"], wrap, item=True)


def prediction_altered(spec):
    f = _fields(spec)
    classes = f["classes"]
    if isinstance(classes, str):
        classes = spec["cfg"][classes]
    name = f["outputs"]["prediction"]

    def change(step, bound, n):
        o = _call(step, bound)
        if n % 7 != 3:
            return o
        pred = getattr(o, name).clone()
        pred[:, 0] = (pred[:, 0] + 1) % classes
        return o._replace(**{name: pred})

    return _step(spec, change)


def scores_swapped(spec):
    name = _fields(spec)["args"]["log_prob"]

    def change(step, bound, n):
        lp = bound.arguments[name].clone()
        lp[:, [0, 1]] = lp[:, [1, 0]]
        bound.arguments[name] = lp
        return _call(step, bound)

    return _step(spec, change)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  prediction_altered, scores_swapped)}
