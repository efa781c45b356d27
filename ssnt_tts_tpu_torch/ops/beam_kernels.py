"""Beam-only decode steps: h is given, one launch per step.

Port of the beam-only kernels of ssnt_tts_tpu/ops/beam_pallas.py, with the
state reorder folded in (the form the decode loops use):
  - `v2_beam_search_decode` (beam_pallas.v2_beam_search_decode, state=):
    the v2 candidate grid, selection and survivor count, and
    state[branch];
  - `tone_beam_search_decode` (beam_pallas.tone_beam_search_decode,
    state=): the tone step and state[branch];
  - `beam_search_step_reorder` (beam_pallas.beam_search_step_reorder): the
    v1 emit/shift step and the reorder of (B, W, F) rows, and
    `beam_search_step_batched` (beam_pallas.beam_search_step_batched), the
    same kernel without rows.
For CUDA tensors each launches its hand-written kernel in
csrc/beam_step.cu (built by ops/_build.py) or raises, and adds one to its
own `.launches` per launch. For CPU tensors it runs the plain version
(`*_reference`): the plain beam_v2 / tone_latent / beam_v1 step, then the
gather of the rows by parent pointer.

Each writes W_out = max_beam_width (W by default) output slots, as JAX's
kernels do: the survivors pad by repetition when W_out exceeds them, and
v2's diagonal candidate goes to slot W_out - 1. The kernels take W and
W_out up to MAX_BEAMS and up to MAX_CANDIDATES candidates (check_beam_shape
raises before a launch above them); the plain versions take every width,
as JAX's XLA steps do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ssnt_tts_tpu_torch.ops import _build, beam_v1, beam_v2, tone_latent
from ssnt_tts_tpu_torch.ops.beam_fused import (  # noqa: F401 (re-exported)
    MAX_BEAMS,
    MAX_CANDIDATES,
    ToneStep,
    check_beam_shape,
    reorder_state,
)
from ssnt_tts_tpu_torch.utils.config import V2BeamConfig


class V2BeamStep(NamedTuple):
    """(B, W): prediction, log_prob, next_t, next_u, is_finished,
    total_duration, branch; (B,): num_survivors; state (B, W, H)
    reordered."""

    prediction: torch.Tensor
    log_prob: torch.Tensor
    next_t: torch.Tensor
    next_u: torch.Tensor
    is_finished: torch.Tensor
    total_duration: torch.Tensor
    branch: torch.Tensor
    num_survivors: torch.Tensor
    state: torch.Tensor


def _out_width(W: int, max_beam_width: Optional[int]) -> int:
    """W_out = max_beam_width, W when it is None."""
    return W if max_beam_width is None else int(max_beam_width)


def v2_beam_search_decode_reference(
    h, log_prob_history, is_finished, total_duration, duration_table, t, u,
    input_length, output_length, *, state, zero_duration_id: int = 0,
    allow_skip: bool = False, test_mode: bool = False,
    config: Optional[V2BeamConfig] = None,
    max_beam_width: Optional[int] = None,
) -> V2BeamStep:
    """Plain PyTorch version of v2_beam_search_decode (any device)."""
    out = beam_v2.beam_search_decode(
        h, log_prob_history, is_finished, total_duration, duration_table, t,
        u, input_length, output_length, zero_duration_id=zero_duration_id,
        allow_skip=allow_skip, test_mode=test_mode, config=config,
        max_beam_width=_out_width(h.shape[1], max_beam_width))
    return V2BeamStep(*out, reorder_state(state, out[6]))


def v2_beam_search_decode(
    h, log_prob_history, is_finished, total_duration, duration_table, t, u,
    input_length, output_length, *, state, zero_duration_id: int = 0,
    allow_skip: bool = False, test_mode: bool = False,
    config: Optional[V2BeamConfig] = None,
    max_beam_width: Optional[int] = None,
) -> V2BeamStep:
    """One v2 beam step given h, with the state reorder.

    h (B, W, D) f32 per-beam class log-probs; log_prob_history (B, W) f32;
    is_finished (B, W) bool; total_duration, t, u (B, W) int32;
    duration_table (D,) int32; input_length, output_length (B,) int32
    (zeroed here in test_mode, as the reference wrapper does); state
    (B, W, H) f32 per-beam rows. Outputs (B, W_out), state (B, W_out, H).
    """
    kw = dict(state=state, zero_duration_id=zero_duration_id,
              allow_skip=allow_skip, test_mode=test_mode, config=config,
              max_beam_width=max_beam_width)
    args = (h, log_prob_history, is_finished, total_duration,
            duration_table, t, u, input_length, output_length)
    dev = h.device
    if dev.type == "cpu":
        return v2_beam_search_decode_reference(*args, **kw)
    B, W, D = h.shape
    H = state.shape[-1]
    if D > 64:  # JAX's limit (beam_pallas.v2_beam_search_decode)
        raise ValueError(f"duration_class_size {D} > 64 breaks eq-key "
                         f"packing injectivity")
    lib, W_out = _check_common(h, log_prob_history, is_finished, t, u,
                               input_length, state, max_beam_width)
    if not 0 <= zero_duration_id < D:
        raise ValueError(f"zero_duration_id {zero_duration_id} out of range")
    i32 = torch.int32
    for name, x, dt, shape in (
        ("total_duration", total_duration, i32, (B, W)),
        ("output_length", output_length, i32, (B,)),
        ("duration_table", duration_table, i32, (D,)),
    ):
        _build.check_arg(name, x, dt, shape, dev)
    if test_mode:
        output_length = torch.zeros_like(output_length)
    cfg = config if config is not None else V2BeamConfig()
    new = lambda dt: torch.empty(B, W_out, dtype=dt, device=dev)
    out = V2BeamStep(
        prediction=new(i32), log_prob=new(torch.float32), next_t=new(i32),
        next_u=new(i32), is_finished=new(torch.bool),
        total_duration=new(i32), branch=new(i32),
        num_survivors=torch.empty(B, dtype=i32, device=dev),
        state=torch.empty(B, W_out, H, dtype=torch.float32, device=dev),
    )
    ptr = lambda x: x.data_ptr()
    rc = lib.ssnt_beam_v2_step(
        B, W, W_out, D, H,
        *map(ptr, (h, log_prob_history, is_finished, total_duration, t, u,
                   input_length, output_length, duration_table, state)),
        *map(ptr, out),
        int(zero_duration_id), int(bool(allow_skip)), int(bool(test_mode)),
        int(cfg.overrun_multiplier), int(bool(cfg.final_feasible_guard)),
        float(cfg.band_lower_frac), float(cfg.band_upper_frac),
        float(cfg.diagonal_window[0]), float(cfg.diagonal_window[1]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"beam-only v2 step kernel launch failed: "
                           f"cudaError {rc}")
    v2_beam_search_decode.launches += 1
    return out


v2_beam_search_decode.launches = 0


def tone_beam_search_decode_reference(
    h, log_prob_history, is_finished, t, u, input_length, *, state,
    empty_tone_id: int = 0, max_beam_width: Optional[int] = None,
) -> ToneStep:
    """Plain PyTorch version of tone_beam_search_decode (any device)."""
    out = tone_latent.beam_search_step(
        h, log_prob_history, is_finished, t, u, input_length,
        empty_tone_id=empty_tone_id,
        max_beam_width=_out_width(h.shape[1], max_beam_width))
    return ToneStep(*out, reorder_state(state, out[5]))


def tone_beam_search_decode(
    h, log_prob_history, is_finished, t, u, input_length, *, state,
    empty_tone_id: int = 0, max_beam_width: Optional[int] = None,
) -> ToneStep:
    """One tone beam step given h (B, W, K) f32, with the state reorder.
    Other arguments as v2_beam_search_decode's."""
    args = (h, log_prob_history, is_finished, t, u, input_length)
    kw = dict(state=state, empty_tone_id=empty_tone_id,
              max_beam_width=max_beam_width)
    dev = h.device
    if dev.type == "cpu":
        return tone_beam_search_decode_reference(*args, **kw)
    B, W, K = h.shape
    H = state.shape[-1]
    lib, W_out = _check_common(*args, state, max_beam_width)
    i32 = torch.int32
    new = lambda dt: torch.empty(B, W_out, dtype=dt, device=dev)
    out = ToneStep(
        prediction=new(i32), log_prob=new(torch.float32), next_t=new(i32),
        next_u=new(i32), is_finished=new(torch.bool), branch=new(i32),
        state=torch.empty(B, W_out, H, dtype=torch.float32, device=dev),
    )
    ptr = lambda x: x.data_ptr()
    rc = lib.ssnt_beam_tone_step(
        B, W, W_out, K, H, *map(ptr, (*args, state)), *map(ptr, out),
        int(empty_tone_id), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"beam-only tone step kernel launch failed: "
                           f"cudaError {rc}")
    tone_beam_search_decode.launches += 1
    return out


tone_beam_search_decode.launches = 0


class V1BeamStep(NamedTuple):
    """(B, W_out): prediction, log_prob, next_t, next_u, is_finished,
    branch; state (B, W_out, F) reordered rows, None for the step without
    state."""

    prediction: torch.Tensor
    log_prob: torch.Tensor
    next_t: torch.Tensor
    next_u: torch.Tensor
    is_finished: torch.Tensor
    branch: torch.Tensor
    state: Optional[torch.Tensor]


def beam_search_step_reorder_reference(
    h, log_prob_history, is_finished, t, u, input_length, state,
    *, max_beam_width: Optional[int] = None,
) -> V1BeamStep:
    """Plain PyTorch version of beam_search_step_reorder (any device)."""
    out = beam_v1.beam_search_step(
        h, log_prob_history, is_finished, t, u, input_length,
        max_beam_width=_out_width(h.shape[1], max_beam_width))
    return V1BeamStep(*out, reorder_state(state, out[5]))


def beam_search_step_batched_reference(
    h, log_prob_history, is_finished, t, u, input_length,
    *, max_beam_width: Optional[int] = None,
) -> V1BeamStep:
    """Plain PyTorch version of beam_search_step_batched (any device)."""
    return V1BeamStep(*beam_v1.beam_search_step(
        h, log_prob_history, is_finished, t, u, input_length,
        max_beam_width=_out_width(h.shape[1], max_beam_width)), None)


def _v1_step(args, state, max_beam_width) -> V1BeamStep:
    """Launch the v1 kernel on CUDA tensors (state None: no reorder)."""
    h = args[0]
    dev = h.device
    B, W, _ = h.shape
    lib, W_out = _check_common(*args, state, max_beam_width)
    i32 = torch.int32
    new = lambda dt: torch.empty(B, W_out, dtype=dt, device=dev)
    F = 0 if state is None else state.shape[-1]
    out = V1BeamStep(
        prediction=new(i32), log_prob=new(torch.float32), next_t=new(i32),
        next_u=new(i32), is_finished=new(torch.bool), branch=new(i32),
        state=None if state is None else torch.empty(
            B, W_out, F, dtype=torch.float32, device=dev),
    )
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = lib.ssnt_beam_v1_step(
        B, W, W_out, F,
        *map(ptr, (*args, state)), *map(ptr, out),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"beam-only v1 step kernel launch failed: "
                           f"cudaError {rc}")
    return out


def beam_search_step_reorder(
    h, log_prob_history, is_finished, t, u, input_length, state,
    *, max_beam_width: Optional[int] = None,
) -> V1BeamStep:
    """One v1 beam step given h, with the reorder of per-beam rows.

    h (B, W, 2) f32 emit/shift log-probs; log_prob_history (B, W) f32;
    is_finished (B, W) bool; t, u (B, W) int32; input_length (B,) int32;
    state (B, W, F) f32: any per-beam rows (the v1 decode packs its GRU
    state, mel, previous mel, fin and t there). Outputs (B, W_out), state
    (B, W_out, F)."""
    args = (h, log_prob_history, is_finished, t, u, input_length)
    if h.device.type == "cpu":
        return beam_search_step_reorder_reference(
            *args, state, max_beam_width=max_beam_width)
    out = _v1_step(args, state, max_beam_width)
    beam_search_step_reorder.launches += 1
    return out


beam_search_step_reorder.launches = 0


def beam_search_step_batched(
    h, log_prob_history, is_finished, t, u, input_length,
    *, max_beam_width: Optional[int] = None,
) -> V1BeamStep:
    """beam_search_step_reorder without state rows (its `state` is None);
    the same kernel."""
    args = (h, log_prob_history, is_finished, t, u, input_length)
    if h.device.type == "cpu":
        return beam_search_step_batched_reference(
            *args, max_beam_width=max_beam_width)
    out = _v1_step(args, None, max_beam_width)
    beam_search_step_batched.launches += 1
    return out


beam_search_step_batched.launches = 0


def _check_common(h, log_prob, is_finished, t, u, input_length, state,
                  max_beam_width):
    """Raise unless a beam-only kernel can take these (CUDA) tensors
    (state may be None); returns the kernel library and W_out."""
    B, W, D = h.shape
    W_out = _out_width(W, max_beam_width)
    check_beam_shape(W, W_out, W * D)
    dev = h.device
    if dev.type != "cuda":
        raise ValueError(f"beam-only step runs on cuda or cpu, not {dev}")
    lib = _build.beam_step_library()
    i32, f32 = torch.int32, torch.float32
    for name, x, dt, shape in (
        ("h", h, f32, (B, W, D)), ("log_prob", log_prob, f32, (B, W)),
        ("is_finished", is_finished, torch.bool, (B, W)),
        ("t", t, i32, (B, W)), ("u", u, i32, (B, W)),
        ("input_length", input_length, i32, (B,)),
    ):
        _build.check_arg(name, x, dt, shape, dev)
    if state is not None:
        _build.check_arg("state", state, f32, (B, W, state.shape[-1]), dev)
    return lib, W_out
