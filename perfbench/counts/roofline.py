"""What every architecture's counts share: the bytes of a type, the
card's peak rates (peaks.json) and the roofline bound over them."""

from __future__ import annotations

import json
from pathlib import Path

F32, I32, BOOL = 4, 4, 1
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def bound_s(flops: float, nbytes: float, cfg: dict, kind: str):
    """The least time the card could take: the larger of operations over
    the peak rate of the compute dtype and bytes over the memory rate;
    None for a card the table lacks."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None
    return max(flops / peak[cfg["dtype"] + "_flops"],
               nbytes / peak["bytes_per_s"])


def peak_flops(cfg: dict, kind: str):
    peak = PEAKS.get(kind)
    return None if peak is None else peak[cfg["dtype"] + "_flops"]
