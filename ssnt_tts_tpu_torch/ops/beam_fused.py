"""Model-fused v2 decode step: one kernel launch per source step.

Port of ssnt_tts_tpu/ops/beam_fused.py, kind="v2". One step runs the AR
class cell (embedding + GRU + correction head + log_softmax) for every
beam, the v2 candidate grid with every prune, the stable top-W selection
and the parent-pointer reorder of the GRU state.

  - `fused_class_beam_step` is the wrapper. For CUDA tensors it launches
    the hand-written kernel csrc/fused_v2_step.cu (built by ops/_build.py)
    or raises; it adds one to `fused_class_beam_step.launches` per launch.
    For CPU tensors it runs the plain version.
  - `fused_class_beam_step_reference` is the plain version:
    stepmath.class_step_from_paths, then the plain beam_v2 step, then a
    gather of the new state by parent pointer.

The TPU kernel's carry layouts ((B, 1, W) lane rows, (B, W, 1) prev_class,
a kernel-emitted step counter) are dropped: beam state is (B, W), and the
step index s is an argument.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.ops import _build, beam_v2
from ssnt_tts_tpu_torch.utils.config import V2BeamConfig


class FusedWeights(NamedTuple):
    """Kernel-ready weights, cast once per decode: the compute dtype for
    embed/wi/bi/wh/bhn (it is the kernel's compute dtype), float32 for the
    correction head. All contiguous, on the decode's device."""

    embed: torch.Tensor  # (D, H)
    wi: torch.Tensor     # (H, 3H)
    bi: torch.Tensor     # (3H,)
    wh: torch.Tensor     # (H, 3H)
    bhn: torch.Tensor    # (H,)
    out_k: torch.Tensor  # (H, D) float32
    out_b: torch.Tensor  # (D,) float32


def prepare_fused_weights(w: stepmath.ClassStepWeights,
                          dtype) -> FusedWeights:
    cast = lambda x, dt: x.detach().to(dt).contiguous()
    return FusedWeights(
        embed=cast(w.embed, dtype), wi=cast(w.wi, dtype),
        bi=cast(w.bi, dtype), wh=cast(w.wh, dtype), bhn=cast(w.bhn, dtype),
        out_k=cast(w.out_k, torch.float32), out_b=cast(w.out_b, torch.float32),
    )


class V2Step(NamedTuple):
    """One step's outputs. (B, W): prediction (also the next prev_class),
    log_prob, next_t, next_u, is_finished, total_duration, branch;
    (B,): num_survivors, emptied; state (B, W, H) reordered."""

    prediction: torch.Tensor
    log_prob: torch.Tensor
    next_t: torch.Tensor
    next_u: torch.Tensor
    is_finished: torch.Tensor
    total_duration: torch.Tensor
    branch: torch.Tensor
    num_survivors: torch.Tensor
    emptied: torch.Tensor
    state: torch.Tensor


def fused_class_beam_step_reference(
    s: int, xin_path, base_path, fw: FusedWeights, prev_class, state,
    log_prob, is_finished, total_duration, t, u, input_length,
    output_length, duration_table, emptied,
    *, zero_duration_id: int = 0, allow_skip: bool = False,
    test_mode: bool = False, config: Optional[V2BeamConfig] = None,
    debug_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> V2Step:
    """Plain PyTorch version of the fused step (any device)."""
    h, new_h = stepmath.class_step_from_paths(
        *fw, xin_path[s][:, None], base_path[s][:, None], state, prev_class)
    if debug_out is not None:
        debug_out[0].copy_(h)
        debug_out[1].copy_(new_h)
    (pred, lp, nt, nu, fin, tot, branch, nsurv) = beam_v2.beam_search_step(
        h, log_prob, is_finished, total_duration, duration_table, t, u,
        input_length, output_length, zero_duration_id=zero_duration_id,
        allow_skip=allow_skip, test_mode=test_mode, config=config)
    H = new_h.shape[-1]
    new_state = torch.gather(
        new_h, 1, branch.long()[..., None].expand(-1, -1, H))
    return V2Step(pred, lp, nt, nu, fin, tot, branch, nsurv,
                  emptied | (nsurv == 0), new_state)


def fused_class_beam_step(
    s: int, xin_path, base_path, fw: FusedWeights, prev_class, state,
    log_prob, is_finished, total_duration, t, u, input_length,
    output_length, duration_table, emptied,
    *, zero_duration_id: int = 0, allow_skip: bool = False,
    test_mode: bool = False, config: Optional[V2BeamConfig] = None,
    debug_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> V2Step:
    """One fused v2 decode step.

    s: step index; xin_path (T, B, H) compute dtype and base_path (T, B, D)
    f32 from stepmath.class_decode_paths; prev_class (B, W) int32;
    state (B, W, H) f32; log_prob (B, W) f32; is_finished (B, W) bool;
    total_duration/t/u (B, W) int32; input_length/output_length (B,)
    int32 (output_length already zeroed in test_mode); duration_table (D,)
    int32; emptied (B,) bool. debug_out: optional (h (B, W, D),
    new_h (B, W, H)) float32 tensors that receive the step's class
    log-probs and pre-reorder state.
    """
    kw = dict(zero_duration_id=zero_duration_id, allow_skip=allow_skip,
              test_mode=test_mode, config=config, debug_out=debug_out)
    args = (s, xin_path, base_path, fw, prev_class, state, log_prob,
            is_finished, total_duration, t, u, input_length, output_length,
            duration_table, emptied)
    dev = state.device
    if dev.type == "cpu":
        return fused_class_beam_step_reference(*args, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused v2 step runs on cuda or cpu, not {dev}")

    cfg = config if config is not None else V2BeamConfig()
    B, W, H = state.shape
    T, D = base_path.shape[0], base_path.shape[2]
    ct = fw.wi.dtype
    if ct not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {ct} is not float32 or bfloat16")
    lib = _build.fused_v2_library()
    if W > lib.ssnt_fused_v2_step_max_beams() or (
            W * D > lib.ssnt_fused_v2_step_max_candidates()):
        raise ValueError(f"beam width {W} x classes {D} exceeds the kernel")
    if not 0 <= s < T or not 0 <= zero_duration_id < D:
        raise ValueError(f"step {s} / zero_duration_id {zero_duration_id} "
                         f"out of range")
    i32, f32, bl = torch.int32, torch.float32, torch.bool
    for name, x, dt, shape in (
        ("xin_path", xin_path, ct, (T, B, H)),
        ("base_path", base_path, f32, (T, B, D)),
        ("embed", fw.embed, ct, (D, H)), ("wi", fw.wi, ct, (H, 3 * H)),
        ("bi", fw.bi, ct, (3 * H,)), ("wh", fw.wh, ct, (H, 3 * H)),
        ("bhn", fw.bhn, ct, (H,)), ("out_k", fw.out_k, f32, (H, D)),
        ("out_b", fw.out_b, f32, (D,)),
        ("prev_class", prev_class, i32, (B, W)),
        ("state", state, f32, (B, W, H)), ("log_prob", log_prob, f32, (B, W)),
        ("is_finished", is_finished, bl, (B, W)),
        ("total_duration", total_duration, i32, (B, W)),
        ("t", t, i32, (B, W)), ("u", u, i32, (B, W)),
        ("input_length", input_length, i32, (B,)),
        ("output_length", output_length, i32, (B,)),
        ("duration_table", duration_table, i32, (D,)),
        ("emptied", emptied, bl, (B,)),
    ):
        _build.check_arg(name, x, dt, shape, dev)
    dbg = (None, None)
    if debug_out is not None:
        _build.check_arg("debug h", debug_out[0], f32, (B, W, D), dev)
        _build.check_arg("debug new_h", debug_out[1], f32, (B, W, H), dev)
        dbg = tuple(x.data_ptr() for x in debug_out)

    new = lambda dt: torch.empty(B, W, dtype=dt, device=dev)
    out = V2Step(
        prediction=new(i32), log_prob=new(f32), next_t=new(i32),
        next_u=new(i32), is_finished=new(bl), total_duration=new(i32),
        branch=new(i32),
        num_survivors=torch.empty(B, dtype=i32, device=dev),
        emptied=torch.empty(B, dtype=bl, device=dev),
        state=torch.empty(B, W, H, dtype=f32, device=dev),
    )
    ptr = lambda x: x.data_ptr()
    rc = lib.ssnt_fused_v2_step(
        int(ct == torch.bfloat16), B, W, D, H, int(s),
        *map(ptr, (xin_path, base_path, *fw, prev_class, state, log_prob,
                   is_finished, total_duration, t, u, input_length,
                   output_length, duration_table, emptied)),
        *map(ptr, out), *dbg,
        int(zero_duration_id), int(bool(allow_skip)), int(bool(test_mode)),
        int(cfg.overrun_multiplier), int(bool(cfg.final_feasible_guard)),
        float(cfg.band_lower_frac), float(cfg.band_upper_frac),
        float(cfg.diagonal_window[0]), float(cfg.diagonal_window[1]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused v2 step kernel launch failed: "
                           f"cudaError {rc}")
    fused_class_beam_step.launches += 1
    return out


fused_class_beam_step.launches = 0
