"""Beam decodes (v2 duration, tone, v1 emit/shift), PyTorch.

Port of ssnt_tts_tpu/parallel/decode: v2_duration_decode (the reference's
production path, SURVEY §3.1 + §3.3), tone_decode and beam_decode /
greedy_decode (the v1 decode), with their step loops and post-processing:

  v2: encode -> T steps -> all-beam backtrace (ops/backtrace) -> per-beam
  durations -> duration-to-frame upsampling (ops/upsample)
  tone: encode -> T steps -> all-beam backtrace -> per-beam tones
  v1: encode -> max_frames steps (each beam's source position t is its
  own, moved by its emit/shift choices) -> best-path backtrace
  (backtrace.extract_best_beam_branch) -> its mel frames

A step is, as in the JAX package, one of three routes:
  - fused (fuse_model None or True): enc-side projections hoisted
    (stepmath.class_decode_paths, stepmath.v1_enc_pack), then one
    ops/beam_fused step per step (the CUDA kernel for CUDA tensors, its
    plain version for CPU tensors);
  - beam-only (fuse_model=False, use_pallas None or True): the model's
    per-beam decode step gives h, then ops/beam_kernels (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors);
  - plain (fuse_model=False, use_pallas=False): the per-beam decode step,
    then the plain beam step and state gather on any device.

Spans (utils/profiling.annotate: recorded only while a torch profiler
records) mark each layer of a decode, whichever the route:
ssnt.v1.decode / ssnt.v2.decode / ssnt.tone.decode around the call, and
inside it ssnt.encode, ssnt.weights and ssnt.paths (the fused route's
hoisted work), ssnt.steps (the step loop) around one ssnt.step a step, and
ssnt.postprocess (the stacks and the post-processing) around
ssnt.backtrace and ssnt.mel_gather (v1) or ssnt.upsample (v2). The
benchmark's per-layer readers (perfbench/program_spans.py) match these
names letter for letter.

Outputs keep the JAX layouts. v2: prediction/beam_branch (B, T, W),
ordered_beam_branch/durations (B, W, T), output_length (B, W),
source_indexes (B, W, max_frames), log_prob/total_duration/is_finished
(B, W), beam_emptied (B,). Tone: tones (B, W, T), prediction/beam_branch
(B, T, W), log_prob (B, W). v1: see beam_decode.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.ops import backtrace, beam_fused, beam_kernels
from ssnt_tts_tpu_torch.ops import beam_v2, upsample
from ssnt_tts_tpu_torch.utils.config import V2BeamConfig
from ssnt_tts_tpu_torch.utils.profiling import annotate


def _ordered(preds, branches):
    """preds/branches (B, T, W) -> (ordered_beam_branch (B, W, T), each
    beam's class along its ancestry (B, W, T)); all-beam backtrace
    (src/v2_util.rs:6-36): the final branch of beam w is w."""
    B, T, W = preds.shape
    final_branch = torch.arange(W, device=preds.device).expand(B, W)
    ordered = backtrace.order_beam_branch(final_branch, branches)
    return ordered, torch.gather(preds.transpose(1, 2), 1, ordered.long())


def _within(input_length, T: int):
    """(B, 1, T) mask of the positions inside each utterance."""
    t = torch.arange(T, device=input_length.device)
    return t[None, None, :] < input_length[:, None, None]


def v2_postprocess(preds, branches, duration_table, input_length,
                   max_frames: int, lp, tot, fin, emptied
                   ) -> Dict[str, torch.Tensor]:
    """preds/branches (B, T, W) -> alignment outputs (decode.py:233)."""
    T = preds.shape[1]
    with annotate("ssnt.backtrace"):
        ordered, pred_classes = _ordered(preds, branches)
    durations = duration_table.to(preds.device)[pred_classes.long()]
    durations = torch.where(_within(input_length, T), durations,
                            0).to(torch.int32)
    out_len = durations.sum(dim=-1, dtype=torch.int32)  # (B, W)
    with annotate("ssnt.upsample"):
        src = upsample.upsample_source_indexes(durations, out_len, -1,
                                               max_u=max_frames)
    return {
        "prediction": preds, "beam_branch": branches,
        "ordered_beam_branch": ordered, "durations": durations,
        "output_length": out_len, "source_indexes": src, "log_prob": lp,
        "total_duration": tot, "is_finished": fin, "beam_emptied": emptied,
    }


def tone_postprocess(preds, branches, input_length, empty_tone_id: int,
                     lp) -> Dict[str, torch.Tensor]:
    """preds/branches (B, T, W) -> tones (B, W, T) (decode.py:627):
    each beam's tone along its ancestry, empty_tone_id past the
    utterance's length."""
    T = preds.shape[1]
    with annotate("ssnt.backtrace"):
        _, tones = _ordered(preds, branches)
    tones = torch.where(_within(input_length, T), tones, empty_tone_id)
    return {"tones": tones, "prediction": preds, "beam_branch": branches,
            "log_prob": lp}


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
    use_pallas: Optional[bool] = None,
    fuse_model: Optional[bool] = None,
    collect_diagnostics: bool = False,
    config: Optional[V2BeamConfig] = None,
) -> Dict[str, torch.Tensor]:
    """T steps of the v2 duration-class beam over per-beam h, then the
    alignment extraction. `model` is a models.ssnt.SSNTModel; the route
    follows fuse_model and use_pallas (module docstring). beam_emptied
    (B,) marks utterances where some step kept no candidate, where the
    reference panics (src/v2.rs:292).

    collect_diagnostics: take the plain step (no kernel; the attribution
    lives there only, as in JAX) and add first_empty_prune_counts (B, 4)
    int32, beam_v2's [band, overrun, exact_final, zero_skip] counts at
    each utterance's first emptying step (0 if none), and first_empty_t
    (B,) int32, its source position (-1 if none).
    """
    with annotate("ssnt.v2.decode"):
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
        kw = dict(zero_duration_id=zero_duration_id, allow_skip=allow_skip,
                  test_mode=test_mode, config=config)

        with annotate("ssnt.encode"):
            enc = model.encode(tokens, il)
        zeros = lambda dt: torch.zeros(B, W, dtype=dt, device=dev)
        lp, fin = zeros(torch.float32), zeros(torch.bool)
        tot, t, u, pc = zeros(i32), zeros(i32), zeros(i32), zeros(i32)
        state = torch.zeros(B, W, model.config.decoder_dim, device=dev)
        emptied = torch.zeros(B, dtype=torch.bool, device=dev)
        first_counts = torch.zeros(B, 4, dtype=i32, device=dev)
        first_t = torch.full((B,), -1, dtype=i32, device=dev)
        if collect_diagnostics:
            def step(s):
                nonlocal first_counts, first_t
                h, new_h = model.duration_decode_step(enc, t, state, pc)
                *o, counts, n = beam_v2.beam_search_decode(
                    h, lp, fin, tot, dtab, t, u, il, ol,
                    return_diagnostics=True, **kw)
                new = (n == 0) & ~emptied
                first_counts = torch.where(new[:, None], counts,
                                           first_counts)
                first_t = torch.where(new, t[:, 0], first_t)
                return beam_fused.V2Step(
                    *o, n, emptied | (n == 0),
                    beam_fused.reorder_state(new_h, o[6]))
        elif fuse_model is not False:
            w = model.duration_step_weights()
            with annotate("ssnt.paths"):
                xin_path, base_path = stepmath.class_decode_paths(
                    w, enc, il, model.dtype, kind="v2")
            with annotate("ssnt.weights"):
                fw = beam_fused.prepare_fused_weights(w, model.dtype)

            def step(s):
                return beam_fused.fused_class_beam_step(
                    s, xin_path, base_path, fw, pc, state, lp, fin, tot, t,
                    u, il, ol, dtab, emptied, **kw)
        else:
            beam_step = (beam_kernels.v2_beam_search_decode_reference
                         if use_pallas is False
                         else beam_kernels.v2_beam_search_decode)

            def step(s):
                h, new_h = model.duration_decode_step(enc, t, state, pc)
                o = beam_step(h, lp, fin, tot, dtab, t, u, il, ol,
                              state=new_h, **kw)
                return beam_fused.V2Step(
                    *o[:8], emptied | (o.num_survivors == 0), o.state)

        preds, branches = [], []
        with annotate("ssnt.steps"):
            for s in range(T):
                with annotate("ssnt.step"):
                    o = step(s)
                lp, fin, tot = o.log_prob, o.is_finished, o.total_duration
                t, u, pc, state, emptied = (o.next_t, o.next_u, o.prediction,
                                            o.state, o.emptied)
                preds.append(o.prediction)
                branches.append(o.branch)
        with annotate("ssnt.postprocess"):
            out = v2_postprocess(torch.stack(preds, 1),
                                 torch.stack(branches, 1), dtab, il,
                                 max_frames, lp, tot, fin, emptied)
        if collect_diagnostics:
            out["first_empty_prune_counts"] = first_counts
            out["first_empty_t"] = first_t
        return out


@torch.no_grad()
def tone_decode(
    model,
    tokens: torch.Tensor,
    input_length: torch.Tensor,
    *,
    beam_width: int,
    empty_tone_id: int = 0,
    use_pallas: Optional[bool] = None,
    fuse_model: Optional[bool] = None,
) -> Dict[str, torch.Tensor]:
    """Tone-latent beam decode over T source positions with per-beam AR
    conditioning (each beam's h follows its own tone history); the eval
    pairs it with ops/edit_distance. The route follows fuse_model and
    use_pallas (module docstring)."""
    with annotate("ssnt.tone.decode"):
        B, T = tokens.shape
        W = beam_width
        dev = tokens.device
        i32 = torch.int32
        il = input_length.to(device=dev, dtype=i32).contiguous()

        with annotate("ssnt.encode"):
            enc = model.encode(tokens, il)
        zeros = lambda dt: torch.zeros(B, W, dtype=dt, device=dev)
        lp, fin = zeros(torch.float32), zeros(torch.bool)
        t, u, pc = zeros(i32), zeros(i32), zeros(i32)
        state = torch.zeros(B, W, model.config.decoder_dim, device=dev)
        if fuse_model is not False:
            w = model.tone_step_weights()
            with annotate("ssnt.paths"):
                xin_path, base_path = stepmath.class_decode_paths(
                    w, enc, il, model.dtype, kind="tone")
            with annotate("ssnt.weights"):
                fw = beam_fused.prepare_fused_weights(w, model.dtype)

            def step(s):
                return beam_fused.fused_tone_step(
                    s, xin_path, base_path, fw, pc, state, lp, fin, t, u, il,
                    empty_tone_id=empty_tone_id)
        else:
            beam_step = (beam_kernels.tone_beam_search_decode_reference
                         if use_pallas is False
                         else beam_kernels.tone_beam_search_decode)

            def step(s):
                h, new_h = model.tone_decode_step(enc, t, state, pc)
                return beam_step(h, lp, fin, t, u, il, state=new_h,
                                 empty_tone_id=empty_tone_id)

        preds, branches = [], []
        with annotate("ssnt.steps"):
            for s in range(T):
                with annotate("ssnt.step"):
                    o = step(s)
                lp, fin, t, u = o.log_prob, o.is_finished, o.next_t, o.next_u
                pc, state = o.prediction, o.state
                preds.append(o.prediction)
                branches.append(o.branch)
        with annotate("ssnt.postprocess"):
            return tone_postprocess(torch.stack(preds, 1),
                                    torch.stack(branches, 1), il,
                                    empty_tone_id, lp)


def v1_postprocess(branches, t_hists, mels, preds, lp, u
                   ) -> Dict[str, torch.Tensor]:
    """branches/t_hists/preds (B, U, W), mels (B, U, W, M) -> the v1
    outputs (decode.py:196): the backtrace from beam 0 (beams stay sorted,
    slot 0 the best) and its mel frames."""
    B, U, W, M = mels.shape
    best_final = torch.zeros(B, dtype=torch.int32, device=mels.device)
    with annotate("ssnt.backtrace"):
        best_branch, best_t = backtrace.extract_best_beam_branch(
            best_final, branches, t_hists)
    with annotate("ssnt.mel_gather"):
        idx = best_branch.long()[:, :, None, None].expand(B, U, 1, M)
        mel = torch.gather(mels, 2, idx)[:, :, 0]
    return {
        "mel": mel, "alignment": best_t,
        "beam_branch": branches, "t_history": t_hists, "prediction": preds,
        "log_prob": lp, "num_frames": u[:, 0],
    }


def v1_beam_only_step(model, enc, input_length, t, u, log_prob,
                      is_finished, state, prev_mel, beam_step
                      ) -> beam_fused.V1FusedStep:
    """One frame of beam_decode on its beam-only and plain routes (the
    scan body of JAX's beam_decode without the fused kernel):
    SSNTModel.decode_step at each beam's t, then `beam_step`
    (beam_kernels.beam_search_step_reorder, or its plain version) over h
    with [state | mel | prev_mel | fin | t] as one float32 row a beam, then
    the finished-beam mel keep. Returns the step as the fused v1 step
    does."""
    H = model.config.decoder_dim
    M = model.config.mel_dim
    h, new_state, mel = model.decode_step(enc, t, state, prev_mel)
    rows = torch.cat([new_state, mel, prev_mel,
                      is_finished.float()[..., None], t.float()[..., None]],
                     dim=-1)
    o = beam_step(h, log_prob, is_finished, t, u, input_length, rows)
    r = o.state
    return beam_fused.V1FusedStep(
        *o[:6], r[..., -1].to(torch.int32),
        beam_fused.keep_finished_mel(r[..., H:H + M], r[..., H + M:-2],
                                     o.is_finished, r[..., -2] != 0),
        r[..., :H].contiguous())


@torch.no_grad()
def beam_decode(
    model,
    tokens: torch.Tensor,
    input_length: torch.Tensor,
    *,
    max_frames: int,
    beam_width: int,
    use_pallas: Optional[bool] = None,
    fuse_model: Optional[bool] = None,
) -> Dict[str, torch.Tensor]:
    """The v1 emit/shift beam decode: max_frames frames, each moving every
    beam by emit (t, u+1) or shift (t+1, u+1) and predicting a mel frame,
    then the best-path backtrace. The route follows fuse_model and
    use_pallas (module docstring); the non-fused routes carry
    [state | mel | prev_mel | fin | t] as one (B, W, H + 2M + 2) float32
    row per beam through the reorder (t is exact in float32 below 2^24).

    Returns mel (B, max_frames, M) best-path frames, alignment
    (B, max_frames) best-path source positions, beam_branch / t_history /
    prediction (B, max_frames, W), log_prob (B, W) final cumulative
    log-probs (slot 0 the best), num_frames (B,) frames of the best beam.
    """
    with annotate("ssnt.v1.decode"):
        B, T = tokens.shape
        W = beam_width
        dev = tokens.device
        cfg = model.config
        H, M = cfg.decoder_dim, cfg.mel_dim
        i32 = torch.int32
        il = input_length.to(device=dev, dtype=i32).contiguous()

        with annotate("ssnt.encode"):
            enc = model.encode(tokens, il)
        zeros = lambda dt: torch.zeros(B, W, dtype=dt, device=dev)
        t, u, lp, fin = zeros(i32), zeros(i32), zeros(torch.float32), zeros(
            torch.bool)
        state = torch.zeros(B, W, H, device=dev)
        prev_mel = torch.zeros(B, W, M, device=dev)
        if fuse_model is not False:
            w = model.v1_step_weights()
            with annotate("ssnt.weights"):
                fw = beam_fused.prepare_v1_fused_weights(w, model.dtype)
            with annotate("ssnt.paths"):
                enc_pack = stepmath.v1_enc_pack(w, enc,
                                                model.dtype).contiguous()

            def step():
                return beam_fused.fused_v1_beam_step(
                    enc_pack, t, u, lp, fin, il, prev_mel, state, fw)
        else:
            beam_step = (beam_kernels.beam_search_step_reorder_reference
                         if use_pallas is False
                         else beam_kernels.beam_search_step_reorder)

            def step():
                return v1_beam_only_step(model, enc, il, t, u, lp, fin,
                                         state, prev_mel, beam_step)

        branches, t_hists, mels, preds = [], [], [], []
        with annotate("ssnt.steps"):
            for _ in range(max_frames):
                with annotate("ssnt.step"):
                    o = step()
                t, u, lp, fin = o.next_t, o.next_u, o.log_prob, o.is_finished
                state, prev_mel = o.state, o.mel
                branches.append(o.branch)
                t_hists.append(o.t_history)
                mels.append(o.mel)
                preds.append(o.prediction)
        with annotate("ssnt.postprocess"):
            return v1_postprocess(torch.stack(branches, 1),
                                  torch.stack(t_hists, 1),
                                  torch.stack(mels, 1), torch.stack(preds, 1),
                                  lp, u)


def greedy_decode(model, tokens, input_length, *, max_frames: int,
                  use_pallas: Optional[bool] = None,
                  fuse_model: Optional[bool] = None):
    """Greedy decode: beam_decode at beam width 1, on the same routes."""
    return beam_decode(model, tokens, input_length, max_frames=max_frames,
                       beam_width=1, use_pallas=use_pallas,
                       fuse_model=fuse_model)
