"""Blocked parallel-scan SSNT lattice (variant="scan"), plain PyTorch.

Port of ssnt_tts_tpu/ops/lattice_scan.py, which is pure XLA (no Pallas
kernel), so this module has no kernel either. The column recursion

    alpha_u[t] = lse(M_u[t,0] + alpha_{u-1}[t], M_u[t,1] + alpha_{u-1}[t-1])
    M_u[t,0] = lf[t,u] + le[t,u-1]      (stay)
    M_u[t,1] = lf[t,u] + ls[t-1,u-1]    (shift, from t-1)

is linear over the (logaddexp, +) semiring, so U sequential columns become:
  1. a tree composition of each block of K consecutive operators into one
     (K+1)-banded block-transfer operator, all blocks at once;
  2. a boundary walk of U/K band-applies;
  3. the interior replay: every block replays its K columns from its
     boundary state, all blocks at once (K sequential steps in all).
Sequential depth drops from U to U/K + K.

Ragged batches are uniformized: for u >= U_b the inputs become the
absorbing column (le = 0, ls = NEG, lf = 0; ls one column earlier), so the
backward recursion's per-example re-initialization emerges from one global
init at the last column. The backward flips T and walks the columns from
the end, reusing the forward machinery. The gradients are the analytic
posteriors (ops/lattice.posterior_grads) over these alphas and betas.

ops/lattice_kernels.ssnt_loss_kernels(variant="scan") dispatches here with
K = 16, as lattice_pallas.ssnt_loss_pallas does. U < 2, or a K that is not
a power of two >= 2, raises ValueError, where JAX asserts.
"""

from __future__ import annotations

import torch

from ssnt_tts_tpu_torch.ops.lattice import (
    NEG,
    canonicalize,
    gather_logz,
    logaddexp,
    posterior_grads,
    shift_down_t,
    shift_up_t,
    to_ubt,
)


def _check(U: int, K: int) -> None:
    if U < 2:
        raise ValueError(f"blocked scan needs U >= 2, got U={U}")
    if K < 2 or K & (K - 1):
        raise ValueError(f"blocked scan K must be a power of two >= 2, "
                         f"got K={K}")


def _uniformize(le, ls, lf, output_length):
    """(U, B, T) inputs -> absorbing-column padding for u >= U_b (ls killed
    from u >= U_b - 1: only the stop emit follows the last live frame)."""
    U = le.shape[0]
    u_idx = torch.arange(U, device=le.device)[:, None, None]
    out_len = output_length.long()[None, :, None]
    live = u_idx < out_len
    return (torch.where(live, le, 0.0),
            torch.where(u_idx < out_len - 1, ls, NEG),
            torch.where(live, lf, 0.0))


def _compose_v(Bop, A):
    """Bop o A (A applied first) with the band axis last and T second to
    last: (..., T, b2) and (..., T, b1) -> (..., T, b1 + b2 - 1)."""
    b2, b1 = Bop.shape[-1], A.shape[-1]
    C = torch.full(A.shape[:-1] + (b1 + b2 - 1,), NEG, dtype=A.dtype,
                   device=A.device)
    for k in range(b2):
        # A's entries are read at source row t-k: shift along T.
        A_shift = shift_down_t(A.transpose(-1, -2), k=k).transpose(-1, -2)
        contrib = Bop[..., k:k + 1] + A_shift
        C[..., k:k + b1] = logaddexp(C[..., k:k + b1], contrib)
    return C


def _stack_blocks(diag, sub, K: int):
    """(U-1, B, T) column operators -> (nb, K, B, T, 2), padded with
    identity operators (diag 0, sub NEG)."""
    ncols, B, T = diag.shape
    nb = -(-ncols // K)
    pad = nb * K - ncols
    if pad:
        diag = torch.cat([diag, diag.new_zeros((pad, B, T))])
        sub = torch.cat([sub, sub.new_full((pad, B, T), NEG)])
    return torch.stack([diag, sub], dim=-1).reshape(nb, K, B, T, 2)


def _tree(per_col, K: int):
    """Tree-combine each block's K operators: band 2 -> 3 -> 5 -> K+1."""
    P = per_col
    while P.shape[1] > 1:
        P = _compose_v(P[:, 1::2], P[:, 0::2])
    return P[:, 0]


def _build_block_operators(le, ls, lf, K: int):
    """(U, B, T) uniform inputs -> (nb, B, T, K+1) block-transfer operators
    and the per-column (nb, K, B, T, 2) operators (for interior replay)."""
    U = le.shape[0]
    _check(U, K)
    diag = lf[1:] + le[:-1]
    sub = lf[1:] + shift_down_t(ls[:-1])  # from t-1
    per_col = _stack_blocks(diag, sub, K)
    return _tree(per_col, K), per_col


def _apply_band(P, s):
    """s'[t] = lse_j P[..., t, j] + s[t-j]. P (..., T, band); s (..., T)."""
    terms = torch.stack([P[..., j] + shift_down_t(s, k=j)
                         for j in range(P.shape[-1])])
    return torch.logsumexp(terms, dim=0)


def _blocked_walk(P, per_col, init):
    """The boundary walk from init over the blocks' operators P, then the
    interior replay of every block: (1 + nb*K, B, T) states, init first."""
    nb, K, B, T, _ = per_col.shape
    starts, s = [], init
    for i in range(nb):
        starts.append(s)
        s = _apply_band(P[i], s)
    s = torch.stack(starts)  # (nb, B, T) block starts
    interiors = []
    for k in range(K):  # all blocks advance together
        col = per_col[:, k]
        s = logaddexp(col[..., 0] + s, col[..., 1] + shift_down_t(s))
        interiors.append(s)
    interiors = torch.stack(interiors, dim=1).reshape(nb * K, B, T)
    return torch.cat([init[None], interiors])


def forward_alphas_scan(le, ls, lf, *, K: int = 16):
    """(U, B, T) uniform inputs -> (U, B, T) alphas via blocked scan."""
    U, B, T = le.shape
    P, per_col = _build_block_operators(le, ls, lf, K)
    t0 = (torch.arange(T, device=le.device) == 0)[None, :]
    alpha0 = torch.where(t0, lf[0], NEG)
    return _blocked_walk(P, per_col, alpha0)[:U]


def backward_betas_scan(le, ls, lf, input_length, *, K: int = 16):
    """(U, B, T) *uniformized* inputs -> (U, B, T) betas via blocked scan.

    Operator (superdiagonal): beta_u[t] = lse(N_u[t,0] + beta_{u+1}[t],
    N_u[t,1] + beta_{u+1}[t+1]) with N_u[t,0] = le[t,u] + lf[t,u+1],
    N_u[t,1] = ls[t,u] + lf[t+1,u+1]: T flipped (the superdiagonal becomes
    a subdiagonal) and u reversed, then the forward machinery."""
    U, B, T = le.shape
    _check(U, K)
    t_idx = torch.arange(T, device=le.device)[None, :]
    is_last_t = t_idx == input_length.long()[:, None] - 1

    lf_next = lf[1:]  # lf at u+1
    diag = le[:-1] + lf_next
    sup = ls[:-1] + shift_up_t(lf_next)  # from t+1
    diag_f = torch.flip(diag, dims=(-1, 0))
    sup_f = torch.flip(sup, dims=(-1, 0))

    init = torch.where(is_last_t, le[-1], NEG)  # beta at the last column
    init_f = torch.flip(init, dims=(-1,))
    per_col = _stack_blocks(diag_f, sup_f, K)
    betas_f = _blocked_walk(_tree(per_col, K), per_col, init_f)[:U]
    # Undo: u-order back (the walk ran from the end), T-flip back.
    return torch.flip(betas_f, dims=(0, -1))


class _Core(torch.autograd.Function):
    """Time-major core, as lattice_scan._core: (U, B, T) -> (B,) loss."""

    @staticmethod
    def forward(ctx, le, ls, lf, input_length, output_length, K):
        leu, lsu, lfu = _uniformize(le, ls, lf, output_length)
        alphas = forward_alphas_scan(leu, lsu, lfu, K=K)
        logz = gather_logz(alphas, le, input_length, output_length)
        ctx.save_for_backward(le, ls, lf, alphas, logz, input_length,
                              output_length)
        ctx.K = K
        return -logz

    @staticmethod
    def backward(ctx, g):
        le, ls, lf, alphas, logz, il, ol = ctx.saved_tensors
        leu, lsu, lfu = _uniformize(le, ls, lf, ol)
        betas = backward_betas_scan(leu, lsu, lfu, il, K=ctx.K)
        return posterior_grads(le, ls, lf, alphas, betas, logz, il, ol,
                               g.float()) + (None,) * 3


def ssnt_loss_scan(log_emit, log_shift, log_frame=None, input_length=None,
                   output_length=None, *, K: int = 16, layout: str = "btu"):
    """Blocked-parallel-scan SSNT loss, (B,) float32 (same semantics and
    gradients as ops.lattice.ssnt_loss; values agree to float32
    reassociation). layout "btu" (B, T, U) or "ubt" (time-major)."""
    args = canonicalize(log_emit, log_shift, log_frame, input_length,
                        output_length, layout)
    le, ls, lf, il, ol = to_ubt(args, layout)
    return _Core.apply(le.contiguous(), ls.contiguous(), lf.contiguous(),
                       il, ol, K)
