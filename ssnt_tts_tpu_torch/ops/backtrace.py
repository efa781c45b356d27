"""Beam backtraces (PyTorch).

Mirrors ssnt_tts_tpu/ops/backtrace.py:
  - extract_best_beam_branch (src/util.rs:6-33): from the best final
    branch, walk the parent pointers back, recovering the branch sequence
    and its t_history (the v1 decode's alignment);
  - order_beam_branch (src/v2_util.rs:6-36): the same walk for every beam.
Each walk is sequential in steps and parallel over batch and beams: a
reverse loop with one gather per step.
"""

from __future__ import annotations

import torch


def extract_best_beam_branch(best_final_branch, beam_branch, t_history):
    """beam_branch, t_history (B, U, W) parent pointers and source
    positions, best_final_branch (B,); or unbatched (U, W) and a scalar.
    Returns (best_beam_branch, best_t_history), each (B, U) (or (U,))
    int32: row r holds the branch the best path occupies at step r and
    its source position there."""
    if beam_branch.dim() == 2:
        best, ts = extract_best_beam_branch(
            torch.as_tensor(best_final_branch).reshape(1),
            beam_branch[None], t_history[None])
        return best[0], ts[0]
    B, U, W = beam_branch.shape
    rows = torch.stack([beam_branch.long(), t_history.long()], dim=-1)
    cur = torch.as_tensor(best_final_branch, device=rows.device).long()
    cur = cur.reshape(B, 1, 1).expand(B, 1, 2)
    best = torch.empty(B, U, dtype=torch.int32, device=rows.device)
    ts = torch.empty_like(best)
    for r in range(U - 1, -1, -1):
        best[:, r] = cur[:, 0, 0]
        pick = torch.gather(rows[:, r], 1, cur)[:, 0]  # (B, 2): parent, t
        ts[:, r] = pick[:, 1]
        cur = pick[:, :1, None].expand(B, 1, 2)
    return best, ts


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
