"""Extracted-weight decode-step math: the fused kernels' contract.

Mirrors ssnt_tts_tpu/models/stepmath.py. The v2 and tone decodes
condition each beam on its own class history through ARClassCell +
ClassHead; the v1 decode steps the mel GRU and the transition and frame
joints. The fused step kernels (csrc/fused_class_step.cu,
csrc/fused_v1_step.cu) cannot call modules, so the steps are written here
as plain functions over flat weights, with the rounding points of flax's
bfloat16 modules:

  - `gru_step` fixes where bfloat16 rounding happens; the kernel
    reproduces it operation for operation;
  - `class_step_from_paths` is the part of the step the kernel runs;
  - `class_decode_paths` is the enc-side precompute: at step s every
    active beam sits at source position min(s, T_b - 1) in the v2 scan and
    min(s, T_b) in the tone scan, so the enc projections hoist out of the
    step loop into (T, B, .) paths;
  - `v1_enc_pack` / `v1_step_math` are the v1 counterparts: a v1 beam's
    source position is its own (emit keeps it, shift moves it on), so
    the enc projections hoist into one (B, T, .) pack that each step
    gathers by the beams' t.
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


# ---------------------------------------------------------------- v1 path

class V1StepWeights(NamedTuple):
    """Flat float32 weights of the v1 mel-decode step (ARDecoderCell +
    the decode sides of TransitionJoint and FrameJoint), kernels in
    (in, out) layout. The enc-side projections (enc_*) hoist out of the
    frame loop into v1_enc_pack. M = mel dim, H = decoder dim, R = joint
    rank, He = encoder dim."""

    prenet_w1: torch.Tensor  # (M, H)
    prenet_b1: torch.Tensor  # (H,)
    prenet_w2: torch.Tensor  # (H, H)
    prenet_b2: torch.Tensor  # (H,)
    wi: torch.Tensor         # (H, 3H) GRU input kernel [r|z|n]
    bi: torch.Tensor         # (3H,)
    wh: torch.Tensor         # (H, 3H) GRU recurrent kernel
    bhn: torch.Tensor        # (H,)
    dec_pre_k: torch.Tensor  # (H, R)
    dec_pre_b: torch.Tensor  # (R,)
    dec_proj_k: torch.Tensor  # (R, 2R)
    dec_proj_b: torch.Tensor  # (2R,)
    dec_bias_k: torch.Tensor  # (H, 2) float32
    dec_bias_b: torch.Tensor  # (2,)
    dec_mel_k: torch.Tensor   # (H, M)
    dec_mel_b: torch.Tensor   # (M,)
    enc_proj_k: torch.Tensor  # (He, 2R)
    enc_proj_b: torch.Tensor  # (2R,)
    enc_bias_k: torch.Tensor  # (He, 2) float32
    enc_bias_b: torch.Tensor  # (2,)
    enc_mel_k: torch.Tensor   # (He, M)
    enc_mel_b: torch.Tensor   # (M,)


def extract_v1_step_weights(ar_cell, transition, frame) -> V1StepWeights:
    """From an ARDecoderCell, a TransitionJoint and a FrameJoint
    (models/decoder.py)."""
    pre, cell = ar_cell.prenet, ar_cell.cell
    kb = lambda d: (d.weight.T, d.bias)
    return V1StepWeights(
        *kb(pre.fc1), *kb(pre.fc2), cell.wi, cell.bi, cell.wh, cell.bhn,
        *kb(transition.dec_pre), *kb(transition.dec_proj),
        *kb(transition.dec_bias), *kb(frame.dec_mel),
        *kb(transition.enc_proj), *kb(transition.enc_bias),
        *kb(frame.enc_mel))


def v1_enc_pack(w: V1StepWeights, enc, dtype) -> torch.Tensor:
    """The enc-side projections of the v1 step, packed into one
    (B, T, 2R + 2 + M) float32 array, [enc_proj | enc_bias | enc_mel], so
    that a frame gathers each beam's row once. enc_proj and enc_mel are
    compute-dtype values stored as float32 (exact)."""
    p = mm(enc, w.enc_proj_k, dtype) + w.enc_proj_b.to(dtype)
    eb = torch.matmul(enc.float(), w.enc_bias_k.float()) + w.enc_bias_b
    em = mm(enc, w.enc_mel_k, dtype) + w.enc_mel_b.to(dtype)
    return torch.cat([p.float(), eb, em.float()], dim=-1)


def v1_step_math(w, gath, state, prev_mel, dtype):
    """The v1 decode step over packed rows: the fused v1 kernel's contract.

    w: the decode-side fields of V1StepWeights (a V1StepWeights, or
    beam_fused.V1FusedWeights with the same names); gath (..., 2R+2+M)
    f32 = v1_enc_pack rows at each beam's t; state (..., H) f32 GRU carry;
    prev_mel (..., M) f32. Returns (h (..., 2) emit/shift log-probs f32,
    mel (..., M) f32, new_state (..., H) f32), rounded where flax's
    modules round (rnd = round to `dtype`):
      x = relu(rnd(rnd(prev_mel . w1) + b1)), twice (the prenet);
      new_h = gru_step(x, state);
      pre = rnd(tanh(rnd(rnd(new_h . dec_pre_k) + dec_pre_b)))  (f32 tanh);
      q = rnd(rnd(pre . dec_proj_k) + dec_proj_b);
      logit_k = sum_r f32(rnd(p_kr * q_kr)) + enc_bias_k + dec_bias_k,
        the rank sum in float32 and the dec_bias dot in float32;
      h = log_softmax over the two classes, as shifted - log(sum(exp));
      mel = f32(rnd(enc_mel + rnd(rnd(new_h . dec_mel_k) + dec_mel_b))).
    SSNTModel.decode_step rounds the rank sum to `dtype` as flax does, so
    in bfloat16 the two differ by about one ulp of the logits."""
    R2 = w.dec_proj_k.shape[1]
    R = R2 // 2
    p = gath[..., :R2].to(dtype)
    eb = gath[..., R2:R2 + 2]
    em = gath[..., R2 + 2:].to(dtype)
    dense = lambda x, k, b: mm(x, k, dtype) + b.to(dtype)
    x = torch.relu(dense(prev_mel, w.prenet_w1, w.prenet_b1))
    x = torch.relu(dense(x, w.prenet_w2, w.prenet_b2))
    new_h = gru_step(w.wi, w.bi, w.wh, w.bhn, state, x)
    pre = torch.tanh(dense(new_h, w.dec_pre_k, w.dec_pre_b).float()).to(dtype)
    q = dense(pre, w.dec_proj_k, w.dec_proj_b)
    prod = (p * q).float()
    db = torch.matmul(new_h, w.dec_bias_k.float()) + w.dec_bias_b.float()
    logits = torch.stack([prod[..., :R].sum(-1), prod[..., R:].sum(-1)], -1)
    h = log_softmax(logits + eb + db)
    mel = (em + dense(new_h, w.dec_mel_k, w.dec_mel_b)).float()
    return h, mel, new_h
