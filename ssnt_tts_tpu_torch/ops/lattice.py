"""SSNT forward-backward alignment-lattice losses, plain PyTorch.

Mirrors ssnt_tts_tpu/ops/lattice.py. The lattice (per example, T source
positions, U output frames):

  Emit  : (t, u) -> (t, u+1)     Shift : (t, u) -> (t+1, u+1)
  alpha[t, 0] = lf[t, 0] if t == 0 else NEG
  alpha[t, u] = lf[t, u] + logaddexp(alpha[t, u-1] + le[t, u-1],
                                     alpha[t-1, u-1] + ls[t-1, u-1])
  logZ        = alpha[T-1, U-1] + le[T-1, U-1],   loss = -logZ

Both transitions advance u by one, so the DP walks output-frame columns:
each step is (B, T) vector math. `ssnt_loss` is a torch.autograd.Function
whose backward is the analytic beta/posterior pass (`_backward_betas` and
`posterior_grads`), not autograd through the column loop; this module is
the plain route of the training loss and the plain version the lattice
kernels (ops/lattice_kernels.py) are held against.
`ssnt_loss_reference` differentiates through the loop (tests only);
`ssnt_duration_loss` is the v2 duration-class lattice, differentiated
through its loop.

Masked cells use NEG = -1e30 instead of -inf, so no arithmetic forms
inf - inf; values outside t < input_length, u < output_length are sums of
NEG whose exact value depends on the order of operations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG = -1e30


def logaddexp(a, b):
    """max + log1p(exp(-|a - b|)), the JAX package's association."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(-torch.abs(a - b)))


def shift_down_t(x, fill=NEG, k=1):
    """x[..., t] -> x[..., t-k] along the last (T) axis; t < k filled (all
    of it for k >= T)."""
    if k == 0:
        return x
    if k >= x.shape[-1]:
        return torch.full_like(x, fill)
    return torch.cat([torch.full_like(x[..., :k], fill), x[..., :-k]], dim=-1)


def shift_up_t(x, fill=NEG, k=1):
    """x[..., t] -> x[..., t+k] along the last (T) axis; t >= T-k filled
    (all of it for k >= T)."""
    if k == 0:
        return x
    if k >= x.shape[-1]:
        return torch.full_like(x, fill)
    return torch.cat([x[..., k:], torch.full_like(x[..., :k], fill)], dim=-1)


def shift_up_from(x, right=None):
    """shift_up_t(x) with `right` (x without its T axis) at the last t in
    place of the fill: the first column of the next slice of T, when x is
    one slice (ops/lattice_sharded). right=None: shift_up_t(x)."""
    if right is None:
        return shift_up_t(x)
    return torch.cat([x[..., 1:], right[..., None]], dim=-1)


def _forward_alphas(le, ls, lf):
    """All alpha columns. (U, B, T) inputs -> alphas (U, B, T)."""
    U, B, T = le.shape
    t_is_0 = torch.arange(T, device=le.device) == 0
    alpha = torch.where(t_is_0, lf[0], torch.full_like(lf[0], NEG))
    cols = [alpha]
    for le_prev, ls_prev, lf_u in zip(le.unbind(0)[:-1], ls.unbind(0)[:-1],
                                      lf.unbind(0)[1:]):
        stay = alpha + le_prev
        moved = shift_down_t(alpha + ls_prev)
        alpha = lf_u + logaddexp(stay, moved)
        cols.append(alpha)
    return torch.stack(cols, dim=0)


def beta_column(le_u, ls_u, lf_next, beta, init_col, at_last_u, right=None):
    """One column of the beta recursion: beta_u from beta_{u+1} and
    lf_{u+1} (B, T), re-initialized to init_col where at_last_u. right:
    lf_{u+1} + beta_{u+1} at the position after the last (NEG when
    None)."""
    emit_cont = le_u + lf_next + beta
    shift_cont = ls_u + shift_up_from(lf_next + beta, right)
    return torch.where(at_last_u, init_col,
                       logaddexp(emit_cont, shift_cont))


def _backward_betas(le, ls, lf, input_length, output_length):
    """All beta columns, re-initialized per example at u == output_length-1.
    (U, B, T) inputs -> betas (U, B, T)."""
    U, B, T = le.shape
    t_idx = torch.arange(T, device=le.device)[None, :]
    is_last_t = t_idx == (input_length.long()[:, None] - 1)  # (B, T)
    last_u = output_length.long()[:, None] - 1
    neg = torch.full((B, T), NEG, dtype=le.dtype, device=le.device)
    beta_col, lf_next = neg, neg
    cols = []
    for u in range(U - 1, -1, -1):
        beta_col = beta_column(le[u], ls[u], lf_next, beta_col,
                               torch.where(is_last_t, le[u], neg),
                               last_u == u)
        lf_next = lf[u]
        cols.append(beta_col)
    return torch.stack(cols[::-1], dim=0)


def gather_logz(alphas, le, input_length, output_length, t0=0,
                t_total=None):
    """logZ (B,) = alpha + le at (t = input_length-1, u = output_length-1).

    With t_total, alphas and le hold positions t0 .. t0 + T - 1 of a
    lattice of t_total positions (one slice, ops/lattice_sharded): an
    example whose t lies outside the slice gets 0."""
    U, B, T = alphas.shape
    b_idx = torch.arange(B, device=alphas.device)
    u_last = (output_length.long() - 1).clamp(0, U - 1)
    t_last = (input_length.long() - 1).clamp(
        0, (T if t_total is None else t_total) - 1) - t0
    tl = t_last.clamp(0, T - 1)
    val = alphas[u_last, b_idx, tl] + le[u_last, b_idx, tl].float()
    if t_total is None:
        return val
    return torch.where((t_last >= 0) & (t_last < T), val, 0.0)


def posterior_grads(le, ls, lf, alphas, betas, logz, input_length,
                    output_length, g, t0=0, right=None):
    """d loss / d (le, ls, lf) from alphas and betas: the transition and
    occupancy posteriors times the upstream cotangent g (B,), zero outside
    the valid region and for an example with no valid path (logZ <= NEG/2).
    Mirrors ssnt_tts_tpu/ops/lattice.py:_ssnt_loss_bwd and the posterior
    pass of lattice_pallas._core_bwd (identical math). All (U, B, T)
    float32.

    For one slice of T (ops/lattice_sharded): t0 is its first position,
    right (U, B) the next slice's lf[u+1] + beta[u+1] at its first position
    (shift_up_from)."""
    U, B, T = le.shape
    dev = le.device
    u_idx = torch.arange(U, device=dev)[:, None, None]
    t_idx = t0 + torch.arange(T, device=dev)[None, None, :]
    in_len = input_length.long()[None, :, None]
    out_len = output_length.long()[None, :, None]
    valid = (t_idx < in_len) & (u_idx < out_len)
    is_last_u = u_idx == out_len - 1
    is_last_t = t_idx == in_len - 1

    lf_beta = lf + betas
    lf_beta_next_u = torch.cat(
        [lf_beta[1:], torch.full_like(lf_beta[:1], NEG)], dim=0)
    zero = torch.zeros((), device=dev)
    neg = torch.full((), NEG, device=dev)
    cont_emit = torch.where(is_last_u, torch.where(is_last_t, zero, neg),
                            lf_beta_next_u)
    cont_shift = torch.where(is_last_u, neg,
                             shift_up_from(lf_beta_next_u, right))

    logz_b = logz[None, :, None]
    keep = valid & ~(logz_b <= NEG / 2)

    def post(score):
        s = torch.clamp(score - logz_b, max=30.0)
        return torch.where(keep, torch.exp(s), zero)

    gB = g[None, :, None]
    return (-post(alphas + le + cont_emit) * gB,
            -post(alphas + ls + cont_shift) * gB,
            -post(alphas + betas) * gB)


def canonicalize(log_emit, log_shift, log_frame, input_length,
                 output_length, layout: str = "btu",
                 dtype=torch.float32):
    """Shared argument canonicalization. layout "btu": (B, T, U) inputs;
    "ubt": time-major (U, B, T). Casts the lattice to `dtype` (the storage
    dtype the caller's kernels consume) and fills defaults: log_frame
    zeros, full lengths. Lengths become int32 on the lattice's device."""
    if layout == "btu":
        B, T, U = log_emit.shape
    elif layout == "ubt":
        U, B, T = log_emit.shape
    else:
        raise ValueError(f"unknown layout {layout!r}")
    dev = log_emit.device
    if log_frame is None:
        log_frame = torch.zeros_like(log_emit)
    if input_length is None:
        input_length = torch.full((B,), T, dtype=torch.int32)
    if output_length is None:
        output_length = torch.full((B,), U, dtype=torch.int32)
    lens = lambda x: torch.as_tensor(x).to(device=dev, dtype=torch.int32)
    return (log_emit.to(dtype), log_shift.to(dtype), log_frame.to(dtype),
            lens(input_length), lens(output_length))


def to_ubt(args, layout: str):
    """(le, ls, lf, ...) in `layout` -> the time-major (U, B, T) lattice."""
    if layout == "btu":
        return tuple(x.permute(2, 0, 1) for x in args[:3]) + tuple(args[3:])
    return tuple(args)


class _SSNTLoss(torch.autograd.Function):
    """Time-major core: (U, B, T) float32 -> (B,) loss; analytic backward."""

    @staticmethod
    def forward(ctx, le, ls, lf, input_length, output_length):
        alphas = _forward_alphas(le, ls, lf)
        logz = gather_logz(alphas, le, input_length, output_length)
        ctx.save_for_backward(le, ls, lf, alphas, logz, input_length,
                              output_length)
        return -logz

    @staticmethod
    def backward(ctx, g):
        le, ls, lf, alphas, logz, il, ol = ctx.saved_tensors
        betas = _backward_betas(le, ls, lf, il, ol)
        d = posterior_grads(le, ls, lf, alphas, betas, logz, il, ol, g)
        return d + (None, None)


def ssnt_loss(log_emit, log_shift, log_frame=None, input_length=None,
              output_length=None, *, layout: str = "btu"):
    """SSNT emit/shift lattice negative log-likelihood, (B,) float32.

    log_emit, log_shift, log_frame: (B, T, U) (layout="btu") or time-major
    (U, B, T) (layout="ubt", what the model's joints emit); log_frame
    defaults to zeros. input_length, output_length: optional (B,) int.
    Gradients are the analytic forward-backward posteriors."""
    args = canonicalize(log_emit, log_shift, log_frame, input_length,
                        output_length, layout)
    le, ls, lf, il, ol = to_ubt(args, layout)
    return _SSNTLoss.apply(le.contiguous(), ls.contiguous(), lf.contiguous(),
                           il, ol)


def ssnt_loss_reference(log_emit, log_shift, log_frame=None,
                        input_length=None, output_length=None):
    """ssnt_loss on (B, T, U) inputs with autograd through the column loop
    (no analytic backward); kept for verification."""
    args = canonicalize(log_emit, log_shift, log_frame, input_length,
                        output_length)
    le, ls, lf, il, ol = to_ubt(args, "btu")
    alphas = _forward_alphas(le, ls, lf)
    return -gather_logz(alphas, le, il, ol)


# --------------------------------------------------------------------------
# v2: duration-class lattice (semi-Markov duration model)
# --------------------------------------------------------------------------

def ssnt_duration_loss(log_h, duration_table: Sequence[int],
                       input_length=None, output_length=None,
                       exclude_class: Optional[int] = None):
    """Duration-class lattice NLL over the v2 decoder's alignment space.

      alpha[t, u] = logsumexp_d alpha[t-1, u - dur[d]] + log_h[t-1, d]
      alpha[0, u] = 0 if u == 0 else NEG,   loss = -alpha[T_b, U_b]

    log_h (B, T, D) float per-position class log-probs; duration_table a
    static sequence of D ints; output_length (B,) required; exclude_class
    optionally bars one class. Gradients by autograd through the loop over
    t. Returns (B,) float32."""
    log_h = log_h.float()
    B, T, D = log_h.shape
    dev = log_h.device
    durations = tuple(int(d) for d in duration_table)
    if len(durations) != D:
        raise ValueError("duration_table length must match log_h class dim")
    if input_length is None:
        input_length = torch.full((B,), T, dtype=torch.int32)
    if output_length is None:
        raise ValueError("output_length is required for the duration lattice")
    il = torch.as_tensor(input_length).to(dev).long()
    ol = torch.as_tensor(output_length).to(dev).long()
    u_max = max(durations) * T
    neg = torch.tensor(NEG, device=dev)

    alpha = torch.where(torch.arange(u_max + 1, device=dev) == 0, 0.0,
                        NEG)[None, :].expand(B, u_max + 1)
    cols = [alpha]
    for lh in log_h.unbind(1):  # (B, D) per source position
        terms = []
        for d, dur in enumerate(durations):
            if exclude_class is not None and d == exclude_class:
                continue
            shifted = alpha if dur == 0 else torch.cat(
                [torch.full((B, dur), NEG, device=dev), alpha[:, :-dur]],
                dim=1)
            terms.append(shifted + lh[:, d:d + 1])
        stacked = torch.stack(terms, dim=0)
        m = stacked.amax(dim=0)
        alpha = m + torch.log(torch.exp(stacked - m[None]).sum(dim=0))
        # Keep masked cells bounded; maximum (not clamp) splits the
        # gradient of a tie in half, as jnp.maximum does.
        alpha = torch.maximum(alpha, neg)
        cols.append(alpha)
    alphas = torch.stack(cols, dim=0)  # (T+1, B, U+1)
    b_idx = torch.arange(B, device=dev)
    return -alphas[il.clamp(0, T), b_idx, ol.clamp(0, u_max)]
