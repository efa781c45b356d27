"""Batched beam selection with the reference's semantics (PyTorch).

Mirrors ssnt_tts_tpu/ops/beam_common.select_beams for a batch of
utterances. The reference (Rust) joins a beam step as: stable sort by
cumulative log-prob, descending (src/lib.rs:161); drop a candidate equal
to its immediate predecessor on every field but the parent
(src/lib.rs:162); pad by repeating survivors from the front; truncate.

The sorted order is (valid first, lp descending, generation index
ascending), with IEEE `==` on lp, so -0.0 ties +0.0 and generation order
decides. It is computed from pairwise rank counts, not from a sort:
`torch.topk` does not keep that tie order, and a radix sort on the card
orders -0.0 and +0.0 by their bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch


def select_beams(
    fields: Dict[str, torch.Tensor],
    valid: torch.Tensor,
    log_prob: torch.Tensor,
    max_beam_width: int,
    eq_keys: Sequence[str],
    diag_mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Select the top `max_beam_width` hypotheses of each utterance.

    fields: name -> (B, C) candidate fields in generation order
      (beam-major, class-minor); invalid slots may hold anything.
    valid: (B, C) bool; log_prob: (B, C) f32, the sort key.
    eq_keys: fields compared (besides log_prob) by the adjacent dedup.
    diag_mask: optional (B, C) bool; the first surviving flagged candidate
      replaces the last slot (v2 diagonal re-injection, src/v2.rs:298-308).

    Returns name -> (B, max_beam_width) selected fields, plus
    "num_survivors" (B,) int32 (0 where the reference would panic on an
    empty beam; every slot then holds candidate 0).
    """
    B, C = valid.shape
    dev = valid.device
    gen = torch.arange(C, device=dev)
    lp_i, lp_j = log_prob[:, :, None], log_prob[:, None, :]
    # before[b, i, j]: candidate j precedes i in the stable sorted order.
    before = valid[:, None, :] & (
        (lp_j > lp_i) | ((lp_j == lp_i) & (gen[None, None, :] < gen[None, :, None]))
    )
    rank = before.sum(dim=2)  # (B, C), unique among valid candidates
    eq = valid[:, :, None] & valid[:, None, :] & (lp_i == lp_j)
    for k in eq_keys:
        if k != "log_prob":
            a = fields[k]
            eq &= a[:, :, None] == a[:, None, :]
    # Duplicate iff the immediate sorted predecessor is field-equal.
    dup = (eq & (rank[:, None, :] == rank[:, :, None] - 1)).any(dim=2)
    keep = valid & ~dup
    n = keep.sum(dim=1)  # (B,)
    krank = (before & keep[:, None, :]).sum(dim=2)  # rank among survivors

    j = torch.arange(max_beam_width, device=dev)[None, :]
    n_ = n[:, None]
    n_safe = n_.clamp(min=1)
    want = torch.where(j < n_, j % n_safe, (j - n_) % n_safe)
    hit = keep[:, None, :] & (krank[:, None, :] == want[:, :, None])
    hit |= (n_ == 0)[:, :, None] & (gen == 0)[None, None, :]
    src = (hit.long() * gen).sum(dim=2)  # (B, W_out)

    if diag_mask is not None:
        diag_keep = keep & diag_mask
        first = torch.where(diag_keep, rank, C).argmin(dim=1)
        src[:, -1] = torch.where(diag_keep.any(dim=1), first, src[:, -1])

    out = {k: torch.gather(v, 1, src) for k, v in fields.items()}
    out["num_survivors"] = n.to(torch.int32)
    return out
