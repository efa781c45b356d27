"""v2 duration-class beam step, plain PyTorch (batched).

Mirrors ssnt_tts_tpu/ops/beam_v2.py; reference semantics src/v2.rs.
Each class d predicts duration_table[d] frames for source position t. Hard
constraints, all skipped in test_mode:
  - diagonal band: the new total duration stays within
    [trunc(max(diag - 0.05U, 0)), trunc(min(diag + 0.1U, U))], with
    diag = U/T * (t+1) in float32 (src/v2.rs:94-104, 131);
  - overrun: every class is pruned when (T-(t+1))*3 > U (src/v2.rs:106-111);
  - at t == T-1 the total must equal U and the hypothesis finishes;
  - zero_duration_id is pruned unless allow_skip;
  - optionally (V2BeamConfig.final_feasible_guard), candidates that can no
    longer land on U exactly.
A finished or out-of-range beam emits one padding candidate. The first
surviving candidate within [-20, 0] frames of the diagonal is re-injected
into the last slot (src/v2.rs:282-308).

The band and diagonal arithmetic follows the reference's float32
operations one rounding at a time, as the numpy oracle does: each torch
op below rounds, none is fused. (Compiled XLA on the CPU contracts
`diag - U*0.05` into a fused multiply-add, which moves an exact-integer
lower edge down by one frame; the fused kernel is built with -fmad=false
for the same reason.)
"""

from __future__ import annotations

import torch

from ssnt_tts_tpu_torch.ops.beam_common import select_beams
from ssnt_tts_tpu_torch.utils.config import V2BeamConfig

_EQ_KEYS = ("prediction", "log_prob", "next_t", "next_u", "is_finished",
            "total_duration")


def beam_search_step(
    h, log_prob_history, is_finished, total_duration, duration_table,
    t, u, input_length, output_length,
    *,
    zero_duration_id: int,
    allow_skip: bool,
    test_mode: bool,
    config: V2BeamConfig | None = None,
    max_beam_width: int | None = None,
    return_diagnostics: bool = False,
):
    """One v2 beam step for a batch.

    h (B, W, D) f32 per-beam class log-probs; log_prob_history (B, W) f32;
    is_finished (B, W) bool; total_duration, t, u (B, W) int;
    duration_table (D,) int; input_length, output_length (B,) int.
    max_beam_width: output width, W by default (survivors pad by
    repetition; the diagonal candidate goes to the last slot).

    Returns (prediction, log_prob, next_t, next_u, is_finished,
    total_duration, beam_branch), each (B, max_beam_width), then with
    return_diagnostics the (B, 4) int32 prune attribution [band, overrun,
    exact_final, zero_skip] (per constraint, the candidates of active
    beams that dropping that constraint alone would admit; computed in
    test_mode too, as in JAX), and num_survivors (B,).
    """
    B, W, D = h.shape
    if D > 64:  # JAX's limit, kept though no key is packed here
        raise ValueError(f"duration_class_size {D} > 64 breaks eq-key "
                         f"packing injectivity")
    cfg = config if config is not None else V2BeamConfig()
    dev = h.device
    i32, f32 = torch.int32, torch.float32
    f = lambda x: torch.full((), x, dtype=f32, device=dev)  # float32(x)

    t = t.to(i32)[:, :, None]                    # (B, W, 1)
    u = u.to(i32)[:, :, None]
    tot0 = total_duration.to(i32)[:, :, None]
    hist = log_prob_history.to(f32)[:, :, None]
    fin_in = is_finished.bool()[:, :, None]
    dtab = duration_table.to(device=dev, dtype=i32)
    T = input_length.to(device=dev, dtype=i32)[:, None, None]
    U = output_length.to(device=dev, dtype=i32)[:, None, None]
    d = torch.arange(D, device=dev, dtype=i32)   # (D,)

    active = (t < T) & ~fin_in                   # src/v2.rs:119-125
    last = t == T - 1
    tot = tot0 + dtab                            # (B, W, D)

    Uf, Tf = U.to(f32), T.to(f32)
    ratio = Uf / Tf
    diag = ratio * (t + 1).to(f32)
    lower = torch.clamp(diag - Uf * f(cfg.band_lower_frac), min=0.0).to(i32)
    upper = torch.minimum(diag + Uf * f(cfg.band_upper_frac), Uf).to(i32)
    band_ok = (tot >= lower) & (tot <= upper)
    overrun = (T - (t + 1)) * cfg.overrun_multiplier > U
    final_len_ok = ~last | (tot == U)
    skip_ok = (d != zero_duration_id) | allow_skip   # (D,)

    valid = active & skip_ok
    if not test_mode:
        valid = valid & band_ok & ~overrun & final_len_ok
        if cfg.final_feasible_guard:
            big = torch.iinfo(i32).max
            dmin = torch.where(skip_ok, dtab, big).min()
            dmax = dtab.max()
            fut = torch.clamp(T - 1 - t, min=0)
            rem = U - tot
            valid = valid & (rem >= fut * dmin) & (rem <= fut * dmax)

    shape = (B, W, D)
    pred = d.expand(shape)
    lp = hist + h.to(f32)
    nt = torch.where(last, t, t + 1).expand(shape)
    nu = torch.where(last, u, u + 1).expand(shape)
    fin = last.expand(shape)
    # Padding candidate of a finished/out-of-range beam sits in class slot
    # 0 (src/v2.rs:313-323).
    pad0 = ~active & (d == 0)
    pred = torch.where(pad0, zero_duration_id, pred)
    lp = torch.where(pad0, hist, lp)
    nt = torch.where(pad0, t, nt)
    nu = torch.where(pad0, u, nu)
    fin = fin | pad0
    tot = torch.where(pad0, tot0, tot)
    valid = valid | pad0
    parent = torch.arange(W, device=dev, dtype=i32)[None, :, None].expand(shape)

    flat = lambda x: x.reshape(B, W * D)
    fields = {
        "prediction": flat(pred.to(i32)), "log_prob": flat(lp),
        "next_t": flat(nt), "next_u": flat(nu), "is_finished": flat(fin),
        "total_duration": flat(tot), "parent_branch": flat(parent),
    }
    diag_mask = None
    if not test_mode:
        # on_diagonal uses the candidate's next_t (src/v2.rs:113-117).
        diff = tot.to(f32) - ratio * nt.to(f32)
        lo, hi = cfg.diagonal_window
        diag_mask = flat((diff >= f(lo)) & (diff <= f(hi)))
    out = select_beams(fields, flat(valid), fields["log_prob"],
                       max_beam_width or W, _EQ_KEYS, diag_mask=diag_mask)
    result = (out["prediction"], out["log_prob"], out["next_t"],
              out["next_u"], out["is_finished"], out["total_duration"],
              out["parent_branch"])
    if return_diagnostics:
        act_ok = active & skip_ok
        no_ov = ~overrun
        count = lambda m: m.sum(dim=(1, 2), dtype=i32)
        result += (torch.stack([
            count(act_ok & no_ov & final_len_ok & ~band_ok),
            count(act_ok & band_ok & final_len_ok & overrun),
            count(act_ok & band_ok & no_ov & ~final_len_ok),
            count(active & ~skip_ok & band_ok & no_ov & final_len_ok),
        ], dim=1),)
    return result + (out["num_survivors"],)


def beam_search_decode(
    h, log_prob_history, is_finished, total_duration, duration_table,
    t, u, input_length, output_length,
    *,
    zero_duration_id: int = 0,
    allow_skip: bool = False,
    test_mode: bool = False,
    config: V2BeamConfig | None = None,
    max_beam_width: int | None = None,
    return_diagnostics: bool = False,
):
    """Reference Python API (ssnt_tts_tensorflow/__init__.py:33-73): in
    test_mode output_length is zeroed, like the reference wrapper.
    Returns beam_search_step's outputs (eight, nine with
    return_diagnostics)."""
    if test_mode:
        output_length = torch.zeros_like(output_length)
    return beam_search_step(
        h, log_prob_history, is_finished, total_duration, duration_table,
        t, u, input_length, output_length,
        zero_duration_id=zero_duration_id, allow_skip=allow_skip,
        test_mode=test_mode, config=config, max_beam_width=max_beam_width,
        return_diagnostics=return_diagnostics,
    )
