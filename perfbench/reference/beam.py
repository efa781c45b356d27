"""The reference's beam rules and post-processing, plain PyTorch.

The candidates of one step, with the fields a selection carries and
whether the rules admit them (the v1 emit/shift transducer and the v2
duration classes), the backtrace of parent pointers, and the expansion
of durations into frame indexes.
"""

from __future__ import annotations

import torch

EMIT, SHIFT = 0, 1


def v1_candidates(hist, h, t, u, fin, il):
    """hist (B, W) cumulative log-probs, h (B, W, 2) [emit, shift]
    log-probs, t, u (B, W), fin (B, W) bool, il (B,). Returns the fields
    of the 2W candidates of each beam as (B, W, 2) tensors: pred, lp,
    nt, nu, fin, valid. An emit keeps t; a shift moves it on; an emit at
    the last source position finishes, a shift there becomes a finishing
    emit that keeps the log-prob; a beam that is finished or out of range
    has one padding emit."""
    il = il[:, None]
    active = (t >= 0) & (t < il) & ~fin
    last = t == il - 1
    grow = active & ~last
    pred = torch.stack([torch.zeros_like(t),
                        torch.where(last, EMIT, SHIFT)], 2)
    lp = torch.stack([torch.where(active, hist + h[..., EMIT], hist),
                      torch.where(last, hist, hist + h[..., SHIFT])], 2)
    nt = torch.stack([t, torch.where(last, t, t + 1)], 2)
    nu = torch.stack([torch.where(grow, u + 1, u),
                      torch.where(last, u, u + 1)], 2)
    nfin = torch.stack([~grow, last], 2)
    valid = torch.stack([torch.ones_like(active), active], 2)
    return {"pred": pred, "lp": lp, "nt": nt, "nu": nu, "fin": nfin,
            "valid": valid, "active": active, "last": last}


def v2_candidates(hist, h, t, u, tot0, fin, dtab, il, ol, *,
                  zero_duration_id=0, allow_skip=False, band_lower=0.05,
                  band_upper=0.1, overrun=3, window=(-20.0, 0.0)):
    """hist (B, W), h (B, W, D) class log-probs, t, u, tot0 (B, W), fin
    (B, W) bool, dtab (D,), il, ol (B,). Returns (B, W, D) fields pred,
    lp, nt, nu, fin, tot, valid and diag (inside the diagonal window).
    The band [trunc(max(diag - 0.05 U, 0)), trunc(min(diag + 0.1 U, U))]
    with diag = U / T * (t + 1) in float32, one rounding an operation;
    every class pruned while (T - (t + 1)) * 3 > U; the total equal to U
    at the last position; the zero class pruned; a finished beam one
    padding candidate in class slot 0."""
    f32 = torch.float32
    D = h.shape[-1]
    dev = h.device
    f = lambda x: torch.full((), x, dtype=f32, device=dev)
    t, u, tot0 = t[..., None], u[..., None], tot0[..., None]
    hist, fin = hist[..., None], fin[..., None]
    T, U = il[:, None, None], ol[:, None, None]
    d = torch.arange(D, device=dev, dtype=t.dtype)
    active = (t < T) & ~fin
    last = t == T - 1
    tot = tot0 + dtab
    Uf, Tf = U.to(f32), T.to(f32)
    ratio = Uf / Tf
    diag = ratio * (t + 1).to(f32)
    lower = torch.clamp(diag - Uf * f(band_lower), min=0.0).to(t.dtype)
    upper = torch.minimum(diag + Uf * f(band_upper), Uf).to(t.dtype)
    valid = (active & ((d != zero_duration_id) | allow_skip)
             & (tot >= lower) & (tot <= upper)
             & ~((T - (t + 1)) * overrun > U) & (~last | (tot == U)))
    shape = h.shape
    pad0 = ~active & (d == 0)
    pred = torch.where(pad0, zero_duration_id, d.expand(shape))
    lp = torch.where(pad0, hist, hist + h)
    nt = torch.where(pad0, t, torch.where(last, t, t + 1).expand(shape))
    nu = torch.where(pad0, u, torch.where(last, u, u + 1).expand(shape))
    tot = torch.where(pad0, tot0, tot)
    diff = tot.to(f32) - ratio * nt.to(f32)
    return {"pred": pred, "lp": lp, "nt": nt, "nu": nu,
            "fin": last.expand(shape) | pad0, "tot": tot,
            "valid": valid | pad0,
            "diag": (diff >= f(window[0])) & (diff <= f(window[1])),
            "active": active[..., 0]}


def best_path(final, branches, t_hist):
    """final (B,) the last step's slot, branches / t_hist (B, U, W) ->
    the slot the path holds at each step and its source position, each
    (B, U)."""
    B, U, W = branches.shape
    cur = final.long()
    slots = torch.empty(B, U, dtype=torch.long, device=branches.device)
    ts = torch.empty_like(slots)
    for r in range(U - 1, -1, -1):
        slots[:, r] = cur
        ts[:, r] = t_hist[:, r].long().gather(1, cur[:, None])[:, 0]
        cur = branches[:, r].long().gather(1, cur[:, None])[:, 0]
    return slots, ts


def ancestry(branches):
    """branches (B, T, W) parent pointers -> each final slot's slot at
    every step (B, W, T), the final slot of beam w being w."""
    B, T, W = branches.shape
    cur = torch.arange(W, device=branches.device).expand(B, W)
    out = torch.empty(B, W, T, dtype=torch.long, device=branches.device)
    for r in range(T - 1, -1, -1):
        out[:, :, r] = cur
        cur = branches[:, r].long().gather(1, cur)
    return out


def source_indexes(durations, out_len, max_u, fill=-1):
    """durations (B, W, T), out_len (B, W) -> (B, W, max_u): frame j maps
    to the first position whose cumulative duration exceeds j, fill at
    and past the output length."""
    T = durations.shape[-1]
    ends = torch.cumsum(durations.long(), dim=-1)
    j = torch.arange(max_u, device=durations.device)
    idx = (ends[..., None, :] <= j[:, None]).sum(-1).clamp(max=T - 1)
    return torch.where(j < out_len[..., None], idx, fill)
