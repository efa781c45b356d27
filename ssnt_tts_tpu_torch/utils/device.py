"""Where the port's entry points run: the card unless the caller says so."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the first CUDA device. There
    is no silent CPU fallback: with no card, None raises, and a caller that
    wants the CPU (the tests) names it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
