"""Batched Levenshtein edit distance (PyTorch).

Mirrors ssnt_tts_tpu/ops/edit_distance.py; reference semantics
src/edit_distance.rs (Kaldi-style two-row DP over variable lengths). The
row recurrence
    e_tmp[n] = min(e[n-1] + delta, e[n] + 1, e_tmp[n-1] + 1)
is sequential through e_tmp[n-1], but with vals[n] = min(e[n-1] + delta,
e[n] + 1) it equals n + cummin(vals - n), a prefix minimum, so each row is
a few batched tensor ops and only the rows loop. In the JAX package this
is XLA, not a Pallas kernel; the port's version is plain PyTorch on every
device.
"""

from __future__ import annotations

import torch


def levenshtein_edit_distance(a, b, a_lengths, b_lengths) -> torch.Tensor:
    """Edit distance between a[i, :a_lengths[i]] and b[i, :b_lengths[i]].

    a (B, La), b (B, Lb) int; a_lengths, b_lengths (B,) int.
    Returns (B,) int32 distances."""
    B, La = a.shape
    Lb = b.shape[1]
    dev = a.device
    i32 = torch.int32
    a_len = a_lengths.to(device=dev, dtype=i32)[:, None]
    n = torch.arange(Lb + 1, device=dev, dtype=i32)
    e = n.expand(B, Lb + 1)                         # E(0, n) = n
    for m in range(1, La + 1):
        delta = (a[:, m - 1:m] != b).to(i32)       # (B, Lb) vs b[n-1]
        term12 = torch.minimum(e[:, :-1] + delta, e[:, 1:] + 1)
        vals = torch.cat([e[:, :1] + 1, term12], dim=1)
        e_new = n + torch.cummin(vals - n, dim=1).values
        e = torch.where(m <= a_len, e_new, e)
    idx = b_lengths.to(device=dev, dtype=torch.long)[:, None]
    return torch.gather(e, 1, idx)[:, 0]
