"""Checkpoint and resume with torch.save (the port of
ssnt_tts_tpu/utils/checkpoint.py, which uses orbax).

One subdirectory per saved step, named by the step (as orbax names them),
holding `state.pt`. A save writes a temporary directory and renames it into
place, so a reader never sees a half-written step (orbax's atomic commit);
the oldest steps beyond max_to_keep are deleted.

`state` is a parallel/train.TrainState (its step, the model's state_dict and
the optimizer's count, mu and nu) or any nest of dicts, lists and tuples of
tensors (a decode carry, as the JAX package saves one).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Optional

import torch

from ssnt_tts_tpu_torch.parallel.train import OptState, TrainState

_FILE = "state.pt"


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit()
                  and os.path.isfile(os.path.join(directory, name, _FILE)))


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _payload(state) -> dict:
    if isinstance(state, TrainState):
        opt = state.opt_state
        return {"kind": "train_state", "step": int(state.step),
                "model": _to_cpu(state.model.state_dict()),
                "count": int(opt.count), "mu": _to_cpu(list(opt.mu)),
                "nu": _to_cpu(list(opt.nu))}
    return {"kind": "tree", "tree": _to_cpu(state)}


def save(directory: str, step: int, state: Any, max_to_keep: int = 3):
    """Save `state` (a TrainState or a nest of tensors) at `step`."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp-{int(step)}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_payload(state), os.path.join(tmp, _FILE))
    final = os.path.join(directory, str(int(step)))
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def _like(got: torch.Tensor, like: torch.Tensor, what: str) -> torch.Tensor:
    if got.shape != like.shape:
        raise ValueError(f"checkpoint {what}: shape {tuple(got.shape)}, "
                         f"expected {tuple(like.shape)}")
    return got.to(device=like.device, dtype=like.dtype)


def _restore_tree(got, like, what: str):
    if isinstance(like, torch.Tensor):
        return _like(got, like, what)
    if isinstance(like, dict):
        if set(got) != set(like):
            raise ValueError(f"checkpoint {what}: keys {sorted(got)}, "
                             f"expected {sorted(like)}")
        return {k: _restore_tree(got[k], v, f"{what}/{k}")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if len(got) != len(like):
            raise ValueError(f"checkpoint {what}: {len(got)} entries, "
                             f"expected {len(like)}")
        return type(like)(_restore_tree(g, v, f"{what}/{i}")
                          for i, (g, v) in enumerate(zip(got, like)))
    return got


def restore(directory: str, state_like: Any, step: Optional[int] = None):
    """The state saved at `step` (the latest when None), in the structure of
    `state_like`, its tensors on state_like's devices and dtypes. For a
    TrainState the parameters are loaded into state_like.model (in place)
    and the returned TrainState holds that model. Raises FileNotFoundError
    when the directory holds no checkpoint."""
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, str(int(step)), _FILE)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at step {step} under "
                                f"{directory}")
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state_like, TrainState):
        if data["kind"] != "train_state":
            raise ValueError(f"{path} holds a {data['kind']}, not a "
                             "TrainState")
        model = state_like.model
        model.load_state_dict(data["model"])
        opt = state_like.opt_state
        mu = _restore_tree(data["mu"], list(opt.mu), "mu")
        nu = _restore_tree(data["nu"], list(opt.nu), "nu")
        return TrainState(step=data["step"], model=model,
                          opt_state=OptState(count=data["count"], mu=mu,
                                             nu=nu))
    if data["kind"] != "tree":
        raise ValueError(f"{path} holds a TrainState; pass one as "
                         "state_like")
    return _restore_tree(data["tree"], state_like, "state")


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None
