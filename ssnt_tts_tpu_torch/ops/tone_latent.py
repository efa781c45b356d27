"""Tone-latent beam step, plain PyTorch (batched).

Mirrors ssnt_tts_tpu/ops/tone_latent.py; reference semantics
src/tone_latent.rs. Structurally the v2 step without the duration
bookkeeping: every tone class is admissible for an active beam
(tone_latent.rs:87-93), candidates never finish themselves, so the
advance is always (t, u) -> (t+1, u+1) (:222-231), and a finished or
out-of-range beam emits one padding candidate that predicts
`empty_tone_id` (:211-219). Sort, dedup and pad as in every beam step
(ops/beam_common.select_beams), over candidates in beam-major,
class-minor generation order.
"""

from __future__ import annotations

from typing import Optional

import torch

from ssnt_tts_tpu_torch.ops.beam_common import select_beams

_EQ_KEYS = ("prediction", "log_prob", "next_t", "next_u", "is_finished")


def beam_search_step(h, log_prob_history, is_finished, t, u, input_length,
                     *, empty_tone_id: int = 0,
                     max_beam_width: Optional[int] = None):
    """One tone step for a batch (JAX tone_latent.beam_search_decode).

    h (B, W, K) f32 per-beam tone-class log-probs; log_prob_history (B, W)
    f32; is_finished (B, W) bool; t, u (B, W) int; input_length (B,) int.
    max_beam_width: output width, W by default (survivors pad by
    repetition).

    Returns (prediction, log_prob, next_t, next_u, is_finished,
    beam_branch), each (B, max_beam_width).
    """
    B, W, K = h.shape
    dev = h.device
    i32 = torch.int32
    t = t.to(i32)[:, :, None]                     # (B, W, 1)
    u = u.to(i32)[:, :, None]
    hist = log_prob_history.float()[:, :, None]
    T = input_length.to(device=dev, dtype=i32)[:, None, None]
    k = torch.arange(K, device=dev, dtype=i32)    # (K,)
    shape = (B, W, K)

    active = (t < T) & ~is_finished.bool()[:, :, None]
    # Padding candidate of an inactive beam in class slot 0.
    pad0 = ~active & (k == 0)
    pred = torch.where(pad0, empty_tone_id, k.expand(shape))
    lp = torch.where(pad0, hist, hist + h.float())
    nt = torch.where(pad0, t, t + 1)
    nu = torch.where(pad0, u, u + 1)
    valid = active.expand(shape) | pad0
    parent = torch.arange(W, device=dev, dtype=i32)[None, :, None]

    flat = lambda x: x.reshape(B, W * K)
    fields = {
        "prediction": flat(pred.to(i32)), "log_prob": flat(lp),
        "next_t": flat(nt), "next_u": flat(nu), "is_finished": flat(pad0),
        "parent_branch": flat(parent.expand(shape)),
    }
    out = select_beams(fields, flat(valid), fields["log_prob"],
                       max_beam_width or W, _EQ_KEYS)
    return (out["prediction"], out["log_prob"], out["next_t"], out["next_u"],
            out["is_finished"], out["parent_branch"])
