"""An architecture, found by its name.

A configuration file may name its architecture ("architecture": "<arch>";
"ssnt" where it names none). Its plain reference is then
perfbench/reference/<arch>.py and its counts perfbench/counts/<arch>.py,
and nothing else in the harness names it. A new architecture is these two
files. The reference module gives (P the parameters by name as float32
tensors, `num` a perfbench.reference.numerics.Num, R rows and W beams):

  param_shapes(cfg, frames_per_token)  {name: (shape, init)}, each name as
                                       the program's state_dict has it
                                       (perfbench/weights.py draws them)
  encode(P, cfg, tokens, lengths, num) the encoder's output

and for each entry that it serves, v1 and v2:

  <entry>_enc_side(P, enc, num)        the encoder-side terms its step reads
  <entry>_state(cfg, R, W, device)     the beams' state at the first step:
                                       (R, W, ...) of any trailing shape
  v1_step(P, side, t, state, prev_frame, num)
                                       (h (R, W, 2) emit/shift log-probs,
                                       the frame (R, W, M), the new state)
  v2_step(P, side, pos, state, prev_class, num)
                                       (h (R, W, D) log-probs, new state)
  v1_output(P, cfg, frames, num_frames, num)
                                       the program's `mel` from the best
                                       path's frames (R, U, M): what a
                                       postnet makes of them

The counts module gives the names that the cell's metric readers list
in their COUNTS (perfbench/metrics/<metric>.py): decode_flops(entry, cfg,
mix, B, W) and each <kind>_step_flops / <kind>_step_bytes(cfg, B, W).
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Iterable, NamedTuple, Optional

DEFAULT = "ssnt"
SHARED = ("param_shapes", "encode")
ENTRY = {"v1": ("v1_enc_side", "v1_state", "v1_step", "v1_output"),
         "v2": ("v2_enc_side", "v2_state", "v2_step")}


class Arch(NamedTuple):
    name: str
    ref: ModuleType
    counts: ModuleType


def architecture(cfg: dict, entry: Optional[str] = None,
                 counts: Iterable[str] = ()) -> Arch:
    """The configuration's architecture. With `entry` it stops, naming
    what is missing, where the reference lacks what that entry needs or
    the counts lack one of `counts`."""
    name = cfg.get("architecture", DEFAULT)
    if not name.isidentifier():
        raise SystemExit(f"architecture {name!r} is no module name")
    try:
        arch = Arch(name,
                    importlib.import_module(f"perfbench.reference.{name}"),
                    importlib.import_module(f"perfbench.counts.{name}"))
    except ModuleNotFoundError as e:
        raise SystemExit(f"architecture {name!r}: {e}") from None
    if entry is not None:
        missing = [f"reference/{name}.py: {n}"
                   for n in SHARED + ENTRY[entry] if not hasattr(arch.ref, n)]
        missing += [f"counts/{name}.py: {n}"
                    for n in counts if not hasattr(arch.counts, n)]
        if missing:
            raise SystemExit(f"the {entry} entry needs what architecture "
                             f"{name!r} lacks: {', '.join(missing)}")
    return arch
