"""v2 duration decode, the serving path (PyTorch).

Port of ssnt_tts_tpu/parallel/decode.v2_duration_decode (the reference's
production path, SURVEY §3.1 + §3.3), its fused step loop and its
post-processing:

  encode -> enc-side paths (stepmath.class_decode_paths) -> T fused v2
  steps (ops/beam_fused) -> all-beam backtrace (ops/backtrace) -> per-beam
  durations -> duration-to-frame upsampling (ops/upsample)

Outputs keep the JAX layouts: prediction/beam_branch (B, T, W),
ordered_beam_branch/durations (B, W, T), output_length (B, W),
source_indexes (B, W, max_frames), log_prob/total_duration/is_finished
(B, W), beam_emptied (B,).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.ops import backtrace, beam_fused, upsample
from ssnt_tts_tpu_torch.utils.config import V2BeamConfig


def v2_postprocess(preds, branches, duration_table, input_length,
                   max_frames: int, lp, tot, fin, emptied
                   ) -> Dict[str, torch.Tensor]:
    """preds/branches (B, T, W) -> alignment outputs (decode.py:233)."""
    B, T, W = preds.shape
    dev = preds.device
    # All-beam backtrace (src/v2_util.rs:6-36): final branch of beam w is w.
    final_branch = torch.arange(W, device=dev).expand(B, W)
    ordered = backtrace.order_beam_branch(final_branch, branches)  # (B, W, T)
    # Each beam's class along its ancestry, mapped to frames.
    pred_classes = torch.gather(preds.transpose(1, 2), 1, ordered.long())
    durations = duration_table.to(dev)[pred_classes.long()]
    tmask = torch.arange(T, device=dev)[None, None, :] < input_length[:, None, None]
    durations = torch.where(tmask, durations, 0).to(torch.int32)
    out_len = durations.sum(dim=-1, dtype=torch.int32)  # (B, W)
    src = upsample.upsample_source_indexes(durations, out_len, -1,
                                           max_u=max_frames)
    return {
        "prediction": preds, "beam_branch": branches,
        "ordered_beam_branch": ordered, "durations": durations,
        "output_length": out_len, "source_indexes": src, "log_prob": lp,
        "total_duration": tot, "is_finished": fin, "beam_emptied": emptied,
    }


@torch.no_grad()
def v2_duration_decode(
    model,
    tokens: torch.Tensor,
    input_length: torch.Tensor,
    output_length: torch.Tensor,
    duration_table,
    *,
    beam_width: int,
    max_frames: int,
    zero_duration_id: int = 0,
    allow_skip: bool = False,
    test_mode: bool = False,
    fuse_model: Optional[bool] = None,
    config: Optional[V2BeamConfig] = None,
) -> Dict[str, torch.Tensor]:
    """T steps of the v2 duration-class beam over per-beam h, then the
    alignment extraction. `model` is a models.ssnt.SSNTModel.

    fuse_model: None (or True) runs ops/beam_fused.fused_class_beam_step,
    which launches the CUDA kernel for CUDA tensors and the plain step for
    CPU tensors; False runs the plain step on any device, to compare the
    two. beam_emptied (B,) marks utterances where some step kept no
    candidate, where the reference panics (src/v2.rs:292).
    """
    B, T = tokens.shape
    W = beam_width
    dev = tokens.device
    i32 = torch.int32
    dtab = torch.as_tensor(duration_table, dtype=i32, device=dev)
    il = input_length.to(device=dev, dtype=i32).contiguous()
    ol = output_length.to(device=dev, dtype=i32)
    if test_mode:
        ol = torch.zeros_like(ol)
    ol = ol.contiguous()

    enc = model.encode(tokens, il)
    w = model.duration_step_weights()
    xin_path, base_path = stepmath.class_decode_paths(w, enc, il, model.dtype)
    fw = beam_fused.prepare_fused_weights(w, model.dtype)
    step = (beam_fused.fused_class_beam_step_reference if fuse_model is False
            else beam_fused.fused_class_beam_step)

    zeros = lambda dt: torch.zeros(B, W, dtype=dt, device=dev)
    lp, fin = zeros(torch.float32), zeros(torch.bool)
    tot, t, u, pc = zeros(i32), zeros(i32), zeros(i32), zeros(i32)
    state = torch.zeros(B, W, model.config.decoder_dim, device=dev)
    emptied = torch.zeros(B, dtype=torch.bool, device=dev)
    preds, branches = [], []
    for s in range(T):
        o = step(s, xin_path, base_path, fw, pc, state, lp, fin, tot, t, u,
                 il, ol, dtab, emptied, zero_duration_id=zero_duration_id,
                 allow_skip=allow_skip, test_mode=test_mode, config=config)
        lp, fin, tot = o.log_prob, o.is_finished, o.total_duration
        t, u, pc, state, emptied = (o.next_t, o.next_u, o.prediction,
                                    o.state, o.emptied)
        preds.append(o.prediction)
        branches.append(o.branch)
    return v2_postprocess(torch.stack(preds, 1), torch.stack(branches, 1),
                          dtab, il, max_frames, lp, tot, fin, emptied)
