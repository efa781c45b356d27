"""Numerical-debug helpers (the port of ssnt_tts_tpu/utils/debug.py).

    guarded = guard_nans(step, "step")
    err, out = guarded(state, batch)   # no host sync yet
    err.throw()                        # raises if an output was not finite
    tree_nan_report(model)             # {state_dict name: non-finite count}

JAX returns a checkify error beside the outputs; here `Error` plays that
part. It holds its conditions as tensors on the outputs' device, so
nothing waits for the card until get() or throw() is called.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch


class CheckFailed(RuntimeError):
    """Raised by Error.throw()."""


class Error:
    """Failed-check conditions: (0-d bool tensor, message) pairs, in the
    order they were checked."""

    def __init__(self, checks: Optional[List[Tuple[torch.Tensor, str]]] =
                 None):
        self.checks = list(checks or [])

    def get(self) -> Optional[str]:
        """The first failed check's message, or None."""
        for failed, msg in self.checks:
            if bool(failed):
                return msg
        return None

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise CheckFailed(msg)


def _leaves(tree) -> list:
    """Leaves in JAX's order: dict values by sorted key."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def guard_nans(fn: Callable, name: str = "fn") -> Callable:
    """Wrap `fn` so that every floating output is checked finite. The
    wrapper returns (Error, outputs); call error.throw() to surface."""

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        checks = [(~torch.isfinite(leaf).all(),
                   f"{name}: non-finite value in output leaf {i}")
                  for i, leaf in enumerate(_leaves(out))
                  if isinstance(leaf, torch.Tensor)
                  and leaf.is_floating_point()]
        return Error(checks), out

    return wrapped


def _named(tree, prefix: str = ""):
    if isinstance(tree, torch.nn.Module):
        yield from _named(tree.state_dict(), prefix)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def tree_nan_report(tree: Any) -> dict:
    """{name: count of non-finite entries} over the floating tensors of a
    module (its state_dict names), a state dict or a nest of dicts and
    lists of tensors (names joined by "."); leaves with none are left
    out."""
    report = {}
    for name, leaf in _named(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            bad = int((~torch.isfinite(leaf)).sum())
            if bad:
                report[name] = bad
    return report
