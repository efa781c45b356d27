"""PyTorch port, the K-banded forward (#2) and backward gradients (#6) as
their CUDA kernels split them: three passes each through workspaces
(csrc/lattice.cu banded_compose_kernel, banded_chain_kernel and
banded_replay_kernel / banded_grads_replay_kernel), emulated here block
by block over the flat indices the kernels use, must equal
lattice_forward_alphas_banded_reference and
lattice_backward_grads_banded_reference bit for bit. The forward:

  - compose, a block per (group g, example b), one lane per t: the K
    column operators (forward_column_ops), the pairwise tree, and the
    (K+1)-band result at P[((g*(K+1) + k)*B + b)*T + t];
  - chain, a block per example: alpha at g*K + K - 1 from alpha at
    g*K - 1 through P_g, written to alphas[((g*K + K - 1)*B + b)*T + t]
    when that column is below U;
  - replay, a block per (g, b): the K - 1 interior columns from the
    group's start, read back from alphas at column g*K - 1 (the virtual
    carry [t == 0] for g = 0).

The backward:

  - compose, a block per (g, b): the K uniformized column operators
    (backward_column_ops, by the example's output length), listed from
    the top down, the tree with reads at t + i, P as the forward's;
  - chain, a block per example: beta at g*K from beta at g*K + K through
    P_g, groups descending from the virtual init [t == T_b - 1] at the
    padded top, each group's bottom written to bottoms[(g*B + b)*T + t];
  - replay, a block per (g, b): from the group's top (bottoms of g + 1,
    the virtual init for the top group) the K - 1 interior columns down,
    and the three posteriors of every column below U (column g*K with
    the chain's bottom), at d[(u*B + b)*T + t].

Each lane's arithmetic is the kernel's: lse_terms (the max, the sum of
exp(x - max) left to right, then max + log), the shifted read that gives
NEG outside [0, T)."""

import numpy as np
import pytest
import torch

from ssnt_tts_tpu_torch.ops import lattice_kernels as lk
from ssnt_tts_tpu_torch.ops.lattice import gather_logz

NEG = -1e30


def _lse_terms(xs):
    if len(xs) == 1:
        return xs[0]
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    acc = torch.exp(xs[0] - m)
    for x in xs[1:]:
        acc = acc + torch.exp(x - m)
    return m + torch.log(acc)


def _shifted(row, i, up=False):
    """Every lane t's read of row[t - i] (row[t + i] if up); NEG where
    that leaves [0, T)."""
    out = torch.full_like(row, NEG)
    n = row.shape[-1]
    if i < n:
        if up:
            out[..., :n - i] = row[..., i:]
        else:
            out[..., i:] = row[..., :n - i]
    return out


def _column_ops(flat, g, b, K, B, T, U):
    """forward_column_ops: [lf_u + le_{u-1}, lf_u + ls_{u-1}(t-1)] for
    u = g*K + j, from the flat (U*B*T,) lattice."""
    le, ls, lf = flat
    t = torch.arange(T)
    at = lambda x, u, tt: x[(u * B + b) * T + tt]
    ops = []
    for j in range(K):
        u = g * K + j
        lf_u = at(lf, u, t) if u < U else torch.full((T,), NEG)
        if 1 <= u <= U:
            le_p = at(le, u - 1, t)
            ls_p = torch.where(t >= 1, at(ls, u - 1, (t - 1).clamp(min=0)),
                               torch.tensor(NEG))
        else:
            le_p = torch.full((T,), 0.0 if u == 0 else NEG)
            ls_p = torch.full((T,), NEG)
        ops.append([lf_u + le_p, lf_u + ls_p])
    return ops


def _compose_tree(ops, up=False):
    """compose_level level by level: out[p][k] = lse over i in [lo, hi] of
    ops[2p+1][i] + ops[2p][k-i] read at t - i (t + i if up)."""
    while len(ops) > 1:
        nxt = []
        for p in range(len(ops) // 2):
            a, first = ops[2 * p + 1], ops[2 * p]
            W = len(a)
            out = []
            for k in range(2 * W - 1):
                lo, hi = max(k - (W - 1), 0), min(k, W - 1)
                out.append(_lse_terms([a[i] + _shifted(first[k - i], i, up)
                                       for i in range(lo, hi + 1)]))
            nxt.append(out)
        ops = nxt
    return ops[0]


def emulate_banded_forward(le, ls, lf, K):
    """alphas (U, B, T) from the three passes over flat buffers."""
    U, B, T = le.shape
    G = -(-U // K)
    flat = [x.reshape(-1) for x in (le, ls, lf)]
    P = torch.full((G * (K + 1) * B * T,), float("nan"))
    alphas = torch.full((U * B * T,), float("nan"))
    t = torch.arange(T)
    carry = torch.where(t == 0, 0.0, NEG)
    for b in range(B):  # compose
        for g in range(G):
            Pg = _compose_tree(_column_ops(flat, g, b, K, B, T, U))
            for k in range(K + 1):
                P[((g * (K + 1) + k) * B + b) * T + t] = Pg[k]
    for b in range(B):  # chain
        alpha = carry
        for g in range(G):
            alpha = _lse_terms([P[((g * (K + 1) + k) * B + b) * T + t]
                                + _shifted(alpha, k) for k in range(K + 1)])
            u = g * K + K - 1
            if u < U:
                alphas[(u * B + b) * T + t] = alpha
    for b in range(B):  # replay
        for g in range(G):
            M = _column_ops(flat, g, b, K, B, T, U)
            a = carry if g == 0 else alphas[((g * K - 1) * B + b) * T + t]
            for j in range(K - 1):
                a = _lse_terms([M[j][0] + a, M[j][1] + _shifted(a, 1)])
                if g * K + j < U:
                    alphas[((g * K + j) * B + b) * T + t] = a
    return alphas.view(U, B, T)


def _lattice(seed, U, B, T):
    rng = np.random.default_rng(seed)
    logp = lambda: np.log(rng.uniform(0.05, 1.0, (U, B, T)))
    le, ls, lf = (torch.tensor(logp(), dtype=torch.float32)
                  for _ in range(3))
    return le, ls, lf


@pytest.mark.parametrize("U", [37, 400])
@pytest.mark.parametrize("K", [2, 4, 8, 16])
def test_three_pass_workspace_equals_plain_version(K, U):
    torch.set_num_threads(1)
    le, ls, lf = _lattice(K * 1000 + U, U, B=3, T=12)
    got = emulate_banded_forward(le, ls, lf, K)
    want = lk.lattice_forward_alphas_banded_reference(le, ls, lf, K)
    assert not torch.isnan(got).any()  # every cell written once
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _bwd_column_ops(flat, g, b, K, B, T, U, out_len):
    """backward_column_ops for u = g*K + j: (leu, ls, lfa, lfa_up, N0, N1)
    of each column, uniformized by the example's output length."""
    le, ls, lf = flat
    t = torch.arange(T)
    at = lambda x, u, tt: x[(u * B + b) * T + tt]
    full = lambda v: torch.full((T,), v)
    below_t = t + 1 < T
    Up = -(-U // K) * K
    cols = []
    for j in range(K):
        u = g * K + j
        le_u = at(le, u, t) if u < U else full(NEG)
        ls_u = at(ls, u, t) if u < U else full(NEG)
        if u + 1 < Up and u + 1 < out_len:
            if u + 1 < U:
                f = at(lf, u + 1, t)
                f_up = torch.where(
                    below_t, at(lf, u + 1, (t + 1).clamp(max=T - 1)),
                    torch.tensor(NEG))
            else:
                f, f_up = full(NEG), full(NEG)
        else:
            f = full(0.0)
            f_up = torch.where(below_t, 0.0, NEG)
        leu = le_u if u < out_len else full(0.0)
        lsu = ls_u if u < out_len - 1 else full(NEG)
        cols.append((leu, ls_u, f, f_up, leu + f, lsu + f_up))
    return cols


def _banded_grads(u, U, T, out_len, is_last_t, t_valid, neg_g, lz, al, col,
                  bnext, bnext_up, bu):
    """banded_grads: the three posteriors of column u (None past U)."""
    if u >= U:
        return None
    leu, ls_u, lfa, lfa_up, _, _ = col
    t = torch.arange(T)
    is_last_u = u == out_len - 1
    a = al - lz if u < out_len else torch.full((T,), NEG)
    cont = lfa + bnext
    cont_emit = torch.where(is_last_t, 0.0, NEG) if is_last_u else cont
    cont_up = torch.where(t + 1 < T, lfa_up + bnext_up, NEG)
    cont_shift = torch.full((T,), NEG) if is_last_u else cont_up

    def post(score):
        return torch.where(t_valid, torch.exp(torch.clamp(score, max=30.0)),
                           0.0)

    return (neg_g * post(a + leu + cont_emit), neg_g * post(a + ls_u +
                                                            cont_shift),
            neg_g * post(a + bu))


def emulate_banded_backward(le, ls, lf, alphas, il, ol, g, logz, K):
    """(d_le, d_ls, d_lf) (U, B, T) from the three passes over flat
    buffers."""
    U, B, T = le.shape
    G = -(-U // K)
    flat = [x.reshape(-1) for x in (le, ls, lf)]
    al_flat = alphas.reshape(-1)
    P = torch.full((G * (K + 1) * B * T,), float("nan"))
    bottoms = torch.full((G * B * T,), float("nan"))
    d = [torch.full((U * B * T,), float("nan")) for _ in range(3)]
    t = torch.arange(T)
    for b in range(B):  # compose: the columns from the top down
        for gi in range(G):
            cols = _bwd_column_ops(flat, gi, b, K, B, T, U, int(ol[b]))
            Pg = _compose_tree([[c[4], c[5]] for c in reversed(cols)],
                               up=True)
            for k in range(K + 1):
                P[((gi * (K + 1) + k) * B + b) * T + t] = Pg[k]
    for b in range(B):  # chain: groups descending
        beta = torch.where(t == int(il[b]) - 1, 0.0, NEG)
        for i in range(G):
            gi = G - 1 - i
            beta = _lse_terms([P[((gi * (K + 1) + k) * B + b) * T + t]
                               + _shifted(beta, k, up=True)
                               for k in range(K + 1)])
            bottoms[(gi * B + b) * T + t] = beta
    for b in range(B):  # replay
        in_len, out_len = int(il[b]), int(ol[b])
        lz = logz[b]
        neg_g = torch.zeros(()) if lz <= NEG / 2 else -g[b]
        is_last_t, t_valid = t == in_len - 1, t < in_len
        for gi in range(G):
            cols = _bwd_column_ops(flat, gi, b, K, B, T, U, out_len)
            top = (torch.where(is_last_t, 0.0, NEG) if gi == G - 1
                   else bottoms[((gi + 1) * B + b) * T + t])
            bnext = top
            for j in range(K - 1, -1, -1):
                u = gi * K + j
                up = _shifted(bnext, 1, up=True)
                if j > 0:
                    _, _, _, _, n0, n1 = cols[j]
                    bu = _lse_terms([n0 + bnext, n1 + up])
                else:
                    bu = bottoms[(gi * B + b) * T + t]
                al = (al_flat[(u * B + b) * T + t] if u < U
                      else torch.full((T,), NEG))
                out = _banded_grads(u, U, T, out_len, is_last_t, t_valid,
                                    neg_g, lz, al, cols[j], bnext, up, bu)
                if out is not None:
                    for x, v in zip(d, out):
                        x[(u * B + b) * T + t] = v
                bnext = bu
    return tuple(x.view(U, B, T) for x in d)


@pytest.mark.parametrize("U", [37, 64])
@pytest.mark.parametrize("K", [2, 4, 8, 16])
def test_backward_three_passes_equal_plain_version(K, U):
    """Ragged lengths: a full example, il = ol = 1, a degenerate one (ol <
    il: no path reaches t = il - 1, zero gradients) and a short one."""
    torch.set_num_threads(1)
    T = 12
    le, ls, lf = _lattice(K * 7000 + U, U, B=4, T=T)
    il = torch.tensor([T, 1, T, 7], dtype=torch.int32)
    ol = torch.tensor([U, 1, T - 1, 25], dtype=torch.int32)
    rng = np.random.default_rng(U)
    g = torch.tensor(rng.uniform(0.5, 2.0, 4), dtype=torch.float32)
    alphas = lk.lattice_forward_alphas_banded_reference(le, ls, lf, K)
    logz = gather_logz(alphas, le, il, ol)
    assert float(logz[2]) <= NEG / 2 < float(logz[0])
    got = emulate_banded_backward(le, ls, lf, alphas, il, ol, g, logz, K)
    want = lk.lattice_backward_grads_banded_reference(
        le, ls, lf, alphas, il, ol, g, logz, K)
    for a, w in zip(got, want):
        assert not torch.isnan(a).any()  # every cell written once
        assert torch.equal(a.view(torch.int32), w.view(torch.int32))
        assert not a[:, 2].any()
        assert a[:, 0].abs().sum() > 0
