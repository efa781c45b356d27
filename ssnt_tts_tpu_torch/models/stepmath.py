"""Extracted-weight AR class-step math: the fused class kernel's contract.

Mirrors the class-step half of ssnt_tts_tpu/models/stepmath.py. The v2 and
tone decodes condition each beam on its own class history through
ARClassCell + ClassHead. The fused step kernel (csrc/fused_class_step.cu)
cannot call modules, so the step is written here as plain functions over a
flat tuple of weights, with the rounding points of flax's bfloat16
modules:

  - `gru_step` fixes where bfloat16 rounding happens; the kernel
    reproduces it operation for operation;
  - `class_step_from_paths` is the part of the step the kernel runs;
  - `class_decode_paths` is the enc-side precompute: at step s every
    active beam sits at source position min(s, T_b - 1) in the v2 scan and
    min(s, T_b) in the tone scan, so the enc projections hoist out of the
    step loop into (T, B, .) paths.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssnt_tts_tpu_torch.models.layers import mm


class ClassStepWeights(NamedTuple):
    """Flat float32 weights of one AR class head, kernels in (in, out)
    layout. He = encoder dim, H = decoder dim, D = class count."""

    embed: torch.Tensor      # (D, H)
    enc_in_k: torch.Tensor   # (He, H)
    enc_in_b: torch.Tensor   # (H,)
    wi: torch.Tensor         # (H, 3H) input kernel [ir|iz|in]
    bi: torch.Tensor         # (3H,)
    wh: torch.Tensor         # (H, 3H) recurrent kernel [hr|hz|hn]
    bhn: torch.Tensor        # (H,) recurrent bias of the n gate
    out_k: torch.Tensor      # (H, D) correction head (float32)
    out_b: torch.Tensor      # (D,)
    head_h1_k: torch.Tensor  # (He, Hh) ClassHead hidden
    head_h1_b: torch.Tensor  # (Hh,)
    head_out_k: torch.Tensor  # (Hh, D) (float32)
    head_out_b: torch.Tensor  # (D,)


def extract_class_step_weights(head, ar) -> ClassStepWeights:
    """From a ClassHead and its ARClassCell (models/encoder.py)."""
    return ClassStepWeights(
        embed=ar.embed, enc_in_k=ar.enc_in.weight.T, enc_in_b=ar.enc_in.bias,
        wi=ar.cell.wi, bi=ar.cell.bi, wh=ar.cell.wh, bhn=ar.cell.bhn,
        out_k=ar.out.weight.T, out_b=ar.out.bias,
        head_h1_k=head.h1.weight.T, head_h1_b=head.h1.bias,
        head_out_k=head.out.weight.T, head_out_b=head.out.bias,
    )


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_softmax's association: shifted - log(sum(exp(shifted)))."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def head_base(w: ClassStepWeights, enc, dtype) -> torch.Tensor:
    """ClassHead.logits: (..., He) f32 -> (..., D) f32."""
    h1 = torch.relu(mm(enc, w.head_h1_k, dtype) + w.head_h1_b.to(dtype))
    return torch.matmul(h1.float(), w.head_out_k.float()) + w.head_out_b


def enc_in_proj(w: ClassStepWeights, enc, dtype) -> torch.Tensor:
    """ARClassCell.enc_in: (..., He) f32 -> (..., H) in dtype."""
    return mm(enc, w.enc_in_k, dtype) + w.enc_in_b.to(dtype)


def gru_step(wi, bi, wh, bhn, state, x):
    """flax nn.GRUCell replica with packed [r|z|n] kernels; the compute
    dtype is x's. state (..., H) f32. Returns new_h (..., H) f32:
    (1-z)*n in the compute dtype plus z*state in float32, as flax's
    mixed-precision promotion gives it. Nonlinearities evaluate in float32
    and round back to the compute dtype."""
    return gru_update(gru_input(wi, bi, x), wh, bhn, state)


def gru_input(wi, bi, x):
    """The state-free half of gru_step: x (..., In) -> gi (..., 3H) in x's
    dtype. A teacher-forced loop computes it for every step at once."""
    return mm(x, wi, x.dtype) + bi.to(x.dtype)


def gru_update(gi, wh, bhn, state):
    """The recurrent half of gru_step, given gi = gru_input(wi, bi, x)."""
    dt = gi.dtype
    H = state.shape[-1]
    gh = mm(state, wh, dt)
    sig = lambda p: torch.sigmoid(p.float()).to(dt)
    r = sig(gi[..., :H] + gh[..., :H])
    z = sig(gi[..., H:2 * H] + gh[..., H:2 * H])
    n = torch.tanh(
        (gi[..., 2 * H:] + r * (gh[..., 2 * H:] + bhn.to(dt))).float()
    ).to(dt)
    return ((1 - z) * n).float() + z.float() * state


def class_step_from_paths(embed, wi, bi, wh, bhn, out_k, out_b,
                          xin, base, state, prev_class):
    """The per-step model math; the fused kernel runs it for one path row.

    embed/wi/bi/wh/bhn in the compute dtype (the kernel's), out_k/out_b
    float32; xin (..., H) in the compute dtype and base (..., D) f32,
    broadcast against the beams; state (B, W, H) f32; prev_class (B, W).
    Returns (h (B, W, D) log-probs f32, new_h (B, W, H) f32)."""
    x = embed[prev_class.long()] + xin
    new_h = gru_step(wi, bi, wh, bhn, state, x)
    logits = base + (torch.matmul(new_h, out_k) + out_b)
    return log_softmax(logits), new_h


def class_step_math(w: ClassStepWeights, enc_t, state, prev_class, dtype):
    """Decode step of SSNTModel.duration_decode_step from flat weights.
    enc_t (B, W, He) f32, state (B, W, H) f32, prev_class (B, W) int.
    Returns (log_probs (B, W, D), new_state (B, W, H))."""
    return class_step_from_paths(
        w.embed.to(dtype), w.wi, w.bi, w.wh, w.bhn, w.out_k, w.out_b,
        enc_in_proj(w, enc_t, dtype), head_base(w, enc_t, dtype),
        state, prev_class)


def class_decode_paths(w: ClassStepWeights, enc, input_length, dtype, *,
                       kind: str):
    """Hoisted enc-side inputs of the fused class decode step.

    enc (B, T, He) f32; input_length (B,) int; kind "v2" or "tone".
    Returns (xin_path (T, B, H) compute dtype, base_path (T, B, D) f32):
    row s holds enc_in / head logits at source position min(s, T_b - 1)
    (v2) or min(s, T_b) (tone), clipped to [0, T - 1]. An inactive tone
    beam runs the cell on the padding position; that touches no output."""
    if kind not in ("v2", "tone"):
        raise ValueError(f"unknown class decode kind {kind!r}")
    B, T, _ = enc.shape
    xin_all = enc_in_proj(w, enc, dtype)  # (B, T, H)
    base_all = head_base(w, enc, dtype)   # (B, T, D)
    s = torch.arange(T, device=enc.device)[:, None]
    last = input_length.long()[None, :] - (1 if kind == "v2" else 0)
    idx = torch.minimum(s, last).clamp(0, T - 1)
    b_idx = torch.arange(B, device=enc.device)[None, :]
    return (xin_all[b_idx, idx].contiguous(),
            base_all[b_idx, idx].contiguous())
