"""v1 emit/shift beam step, plain PyTorch (batched).

Mirrors ssnt_tts_tpu/ops/beam_v1.py; reference semantics src/lib.rs:149-230:
  - transition classes Emit=0 ((t, u) -> (t, u+1)) and Shift=1
    ((t, u) -> (t+1, u+1));
  - an emit at the last source frame finishes the hypothesis;
  - a shift at the last source frame is prohibited and becomes a finishing
    emit that keeps the log-prob unchanged;
  - an inactive beam (t < 0, t >= input_length, or finished) yields one
    padding emit candidate (log-prob unchanged, finished) and no shift.
Candidates are in generation order c = w*2 + k; sort, dedup and pad as in
every beam step (ops/beam_common.select_beams).
"""

from __future__ import annotations

from typing import Optional

import torch

from ssnt_tts_tpu_torch.ops.beam_common import select_beams

EMIT = 0
SHIFT = 1

_EQ_KEYS = ("prediction", "log_prob", "next_t", "next_u", "is_finished")


def beam_search_step(h, log_prob_history, is_finished, t, u, input_length,
                     *, max_beam_width: Optional[int] = None):
    """One v1 beam step for a batch (JAX beam_search_decode_batched).

    h (B, W, 2) f32 per-beam [emit, shift] log-probs; log_prob_history
    (B, W) f32; is_finished (B, W) bool; t, u (B, W) int; input_length
    (B,) int. max_beam_width: output width, W by default (the reference
    pads by repetition to any width, src/lib.rs:163-167).

    Returns (prediction, log_prob, next_t, next_u, is_finished,
    beam_branch), each (B, max_beam_width).
    """
    B, W, _ = h.shape
    dev = h.device
    i32 = torch.int32
    t = t.to(i32)
    u = u.to(i32)
    hist = log_prob_history.float()
    h = h.float()
    il = input_length.to(device=dev, dtype=i32)[:, None]

    active = (t >= 0) & (t < il) & ~is_finished.bool()
    last = t == il - 1
    grow = active & ~last

    # (B, W, 2) candidates: emit in slot 0, shift in slot 1.
    pred = torch.stack([torch.zeros_like(t), torch.where(last, EMIT, SHIFT)],
                       dim=2)
    lp = torch.stack([torch.where(active, hist + h[..., EMIT], hist),
                      torch.where(last, hist, hist + h[..., SHIFT])], dim=2)
    nt = torch.stack([t, torch.where(last, t, t + 1)], dim=2)
    nu = torch.stack([torch.where(grow, u + 1, u),
                      torch.where(last, u, u + 1)], dim=2)
    fin = torch.stack([~grow, last], dim=2)
    valid = torch.stack([torch.ones_like(active), active], dim=2)
    parent = torch.arange(W, device=dev, dtype=i32)[None, :, None]

    flat = lambda x: x.reshape(B, 2 * W)
    fields = {
        "prediction": flat(pred.to(i32)), "log_prob": flat(lp),
        "next_t": flat(nt), "next_u": flat(nu), "is_finished": flat(fin),
        "parent_branch": flat(parent.expand(B, W, 2)),
    }
    out = select_beams(fields, flat(valid), fields["log_prob"],
                       max_beam_width or W, _EQ_KEYS)
    return (out["prediction"], out["log_prob"], out["next_t"], out["next_u"],
            out["is_finished"], out["parent_branch"])


def beam_search_decode_batched(h, log_prob_history, is_finished, t, u,
                               input_length, *, max_beam_width=None):
    """JAX's batched v1 step (beam_v1.beam_search_decode_batched): h
    (B, W, 2), state (B, W), input_length (B,); beam_search_step's
    outputs."""
    return beam_search_step(h, log_prob_history, is_finished, t, u,
                            input_length, max_beam_width=max_beam_width)


def beam_search_decode(h, log_prob_history, is_finished, t, u, max_t,
                       beam_width: Optional[int] = None):
    """Reference-parity unbatched wrapper (ssnt_tts_tensorflow/__init__.py
    :8-21): h (W, 2), state (W,), max_t an int. `beam_width` is checked,
    not used (shapes carry the width). Returns six (W,) outputs."""
    if beam_width is not None and h.shape[0] != beam_width:
        raise ValueError(f"beam_width {beam_width} != h.shape[0] "
                         f"{h.shape[0]}")
    il = torch.as_tensor(max_t, dtype=torch.int32, device=h.device)
    out = beam_search_step(h[None], log_prob_history[None],
                           torch.as_tensor(is_finished)[None],
                           torch.as_tensor(t)[None], torch.as_tensor(u)[None],
                           il.reshape(1))
    return tuple(x[0] for x in out)
