"""PyTorch port, the K-banded forward (#2) as its CUDA kernels split it:
three passes through a workspace (csrc/lattice.cu banded_compose_kernel,
banded_chain_kernel, banded_replay_kernel), emulated here block by block
over the flat indices the kernels use, must equal
lattice_forward_alphas_banded_reference bit for bit:

  - compose, a block per (group g, example b), one lane per t: the K
    column operators (forward_column_ops), the pairwise tree, and the
    (K+1)-band result at P[((g*(K+1) + k)*B + b)*T + t];
  - chain, a block per example: alpha at g*K + K - 1 from alpha at
    g*K - 1 through P_g, written to alphas[((g*K + K - 1)*B + b)*T + t]
    when that column is below U;
  - replay, a block per (g, b): the K - 1 interior columns from the
    group's start, read back from alphas at column g*K - 1 (the virtual
    carry [t == 0] for g = 0).

Each lane's arithmetic is the kernel's: lse_terms (the max, the sum of
exp(x - max) left to right, then max + log), the shifted read that gives
NEG outside [0, T)."""

import numpy as np
import pytest
import torch

from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

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


def _shifted(row, i):
    """Every lane t's read of row[t - i]; NEG where t - i < 0."""
    out = torch.full_like(row, NEG)
    if i < row.shape[-1]:
        out[..., i:] = row[..., :row.shape[-1] - i]
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


def _compose_tree(ops):
    """compose_level level by level: out[p][k] = lse over i in [lo, hi] of
    ops[2p+1][i] + ops[2p][k-i] read at t - i."""
    while len(ops) > 1:
        nxt = []
        for p in range(len(ops) // 2):
            a, first = ops[2 * p + 1], ops[2 * p]
            W = len(a)
            out = []
            for k in range(2 * W - 1):
                lo, hi = max(k - (W - 1), 0), min(k, W - 1)
                out.append(_lse_terms([a[i] + _shifted(first[k - i], i)
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
