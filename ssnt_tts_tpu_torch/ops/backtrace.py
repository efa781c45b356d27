"""All-beam backtrace (PyTorch).

Mirrors ssnt_tts_tpu/ops/backtrace.order_beam_branch; reference
src/v2_util.rs:6-36. The parent-pointer walk is sequential in steps and
parallel over batch and beams: a reverse loop over T with one gather per
step.
"""

from __future__ import annotations

import torch


def order_beam_branch(final_branch: torch.Tensor,
                      beam_branch: torch.Tensor) -> torch.Tensor:
    """final_branch (B, W), beam_branch (B, T, W) parent pointers ->
    ordered ancestry (B, W, T) int32."""
    B, T, W = beam_branch.shape
    cur = final_branch.long()
    parents = beam_branch.long()
    out = torch.empty(B, W, T, dtype=torch.int32, device=beam_branch.device)
    for r in range(T - 1, -1, -1):
        out[:, :, r] = cur
        cur = torch.gather(parents[:, r, :], 1, cur)
    return out
