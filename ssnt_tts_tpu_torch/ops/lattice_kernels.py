"""SSNT lattice loss on hand-written CUDA kernels.

Port of ssnt_tts_tpu/ops/lattice_pallas.py. Eight kernels in csrc/lattice.cu
(built by ops/_build.py) replace its nine TPU kernels:

  lattice_bidir           fused_alphas_betas_pallas (:817) and its
                          lane-packed twin fused_alphas_betas_pallas_packed
                          (:993): alphas and betas in one launch
  lattice_forward_alphas  forward_alphas_pallas (:165)
  lattice_backward_grads  backward_grads_pallas (:596): the reverse beta
                          walk writing d_le/d_ls/d_lf, betas never stored
  lattice_backward_betas  backward_betas_pallas (:348): lattice_bidir's
                          beta walk alone (JAX calls it from tests only)
  lattice_bidir_exp       fused_alphas_betas_pallas_exp (:480): the
                          variant="exp" pass, probability-domain walks
                          renormalized every column, log-domain outputs
                          (-inf for a cell of probability 0)
  lattice_expin           fused_expin_pallas (:1459): the exp-native pass
                          of ssnt_loss_expin (lattice_domain="exp"), on
                          probabilities, renormalized every 4th column
  lattice_forward_alphas_banded
                          forward_alphas_pallas_banded (:289): alphas by
                          K-banded chains (variant="bandedN")
  lattice_backward_grads_banded
                          backward_grads_pallas_banded (:726): the
                          backward-gradients walk on the same banding

Each wrapper launches its kernel for CUDA tensors (or raises) and adds one
to its `launches` count per launch; for CPU tensors it runs its plain
version, `<name>_reference`, which repeats the kernel's arithmetic in
PyTorch column by column. The plain versions are used by the tests and by
chip_smoke.py, and by nothing on the main path when a card is present.

On the card every kernel takes 1 <= T <= MAX_T (8192) and B * T <=
MAX_COLUMN (2^31 - 1; check_shape raises ValueError naming the limits
before any launch): warp walks for T <= 128,
block walks of up to 8 positions a thread above. The banded kernels keep
one thread a position, so their limit is banded_max_t(K, backward), the
threads their registers allow a block (under 1024), named by their
ValueError; JAX's banded walks have no such limit.

`ssnt_loss_kernels` keeps lattice_pallas._grad_mode's routing: columns
with B * pad128(T) <= 8192 (the B=32, T=80 training shape) take the
bidirectional kernel plus the plain-PyTorch posterior pass (XLA
elementwise work in the JAX package); larger columns (B=256) and the
bfloat16-storage variant take forward alphas plus the backward-gradients
kernel. Without gradients only forward alphas run. The 8192 threshold was
measured on a TPU; it is kept so that the same shapes take the same
kernels as in JAX, not because it is right for an H100. variant="exp"
runs lattice_bidir_exp with and without gradients (as
lattice_pallas._loss_fwd_impl does), then the same posterior pass.
variant="banded" (K = 2) and "banded2|4|8|16" run the banded forward with
and without gradients and the banded backward (float32 only; no route
picks them unasked, as in JAX); variant="scan" is ops/lattice_scan.py, in
plain PyTorch.

The banded walks group columns by global index: U is padded with NEG to a
multiple of K, where JAX pads to its U-chunk (a multiple of K), so the
K-groups are the same. The forward's alphas on [0, U) do not depend on the
padding. In the backward a taller padded top changes only cells that are
sums of NEG, which are masked or exp to 0: the port matches JAX to
rounding, and its kernels match their plain versions bit for bit.

`ssnt_loss_expin_kernels` is lattice_pallas.ssnt_loss_expin: the loss of
the probability-domain quadruple (E, S, F, mcol) on lattice_expin, its
backward the plain-PyTorch form of _expin_bwd.

One deliberate difference from the JAX kernel: fused_expin_pallas
renormalizes at column index j of its U-chunk ((j + 1) % 4 == 0), so at
a chunk below 4 (_auto_chunk gives 2 once B * pad128(T) > 39321) it never
renormalizes, the fields underflow and every loss is the 1e30 sentinel.
The port renormalizes by global column: forward after column u when
(u + 1) % 4 == 0, backward at column u when u % 4 == 0, which is JAX's
schedule at every chunk that is a multiple of 4.
"""

from __future__ import annotations

import functools

import torch

from ssnt_tts_tpu_torch.ops import _build, lattice_scan
from ssnt_tts_tpu_torch.ops.lattice import (
    NEG,
    _forward_alphas,
    canonicalize,
    gather_logz,
    logaddexp,
    posterior_grads,
    shift_down_t,
    shift_up_t,
    to_ubt,
)

_FUSED_MAX_COLUMN_ELEMS = 8192
# The kernels' source-length limit (csrc/lattice.cu kMaxT, returned by
# ssnt_lattice_max_t): the block walks hold up to 8 positions a thread in
# blocks of up to 1024. JAX's Pallas walks have none; 8192 covers every T
# whose (1, B, pad128(T)) blocks fit _auto_chunk's VMEM budget at B >= 24.
MAX_T = 8192
MAX_COLUMN = 2**31 - 1  # B * T: csrc/lattice.cu bad_shape
_BANDS = (2, 4, 8, 16)  # the banded kernels' K (lattice_pallas's probes)
_AUTO_BANDED_K = 2      # bare variant="banded"
_TINY = 1e-30  # floor of an exp-domain normalizer (lattice_pallas._TINY)
_RENORM = 4    # lattice_expin renormalizes every 4th column


def _t_pad(T: int) -> int:
    return ((T + 127) // 128) * 128


def grad_mode(variant: str, B: int, T: int) -> tuple:
    """(mode, K) as lattice_pallas._grad_mode routes it: mode "fused"
    (bidirectional kernel + posterior pass), "plain" (forward alphas +
    backward gradients), "exp" (exp-domain bidirectional kernel +
    posterior pass) or "banded" (the K-banded forward and backward); K is
    0 but for "banded".
    variant: "log" (auto), "fused"/"fusedpack" (both the bidirectional
    kernel here), "plain", "bf16" (plain, bfloat16 storage), "exp",
    "banded" (K = 2) or "banded2", "banded4", "banded8", "banded16". Any
    other K raises ValueError, where JAX asserts a power of two: "banded32"
    passes JAX's assert, but JAX documents and tests only these four."""
    if variant in ("plain", "bf16"):
        return "plain", 0
    if variant in ("fused", "fusedpack"):
        return "fused", 0
    if variant == "exp":
        return "exp", 0
    if variant.startswith("banded"):
        suffix = variant[len("banded"):] or str(_AUTO_BANDED_K)
        if not suffix.isdigit() or int(suffix) not in _BANDS:
            raise ValueError(f"lattice variant {variant!r}: K must be one "
                             f"of {_BANDS}")
        return "banded", int(suffix)
    if variant != "log":
        raise ValueError(f"unknown lattice variant {variant!r}")
    fused = B * _t_pad(T) <= _FUSED_MAX_COLUMN_ELEMS
    return ("fused" if fused else "plain"), 0


# ------------------------------------------------------- plain versions

def lattice_backward_betas_reference(le, ls, lf, input_length,
                                     output_length):
    """Betas (U, B, T) f32 in the bidirectional kernel's operation order
    (the continuation is le + (lf_next + beta))."""
    U, B, T = le.shape
    t_idx = torch.arange(T, device=le.device)[None, :]
    is_last_t = t_idx == input_length.long()[:, None] - 1
    last_u = output_length.long()[:, None] - 1
    neg = torch.full((B, T), NEG, device=le.device)
    betas = torch.empty((U, B, T), device=le.device)
    beta, lf_next = neg, neg
    for u in range(U - 1, -1, -1):
        cont = lf_next + beta
        rec = logaddexp(le[u] + cont, ls[u] + shift_up_t(cont))
        beta = torch.where(last_u == u, torch.where(is_last_t, le[u], neg),
                           rec)
        betas[u] = beta
        lf_next = lf[u]
    return betas


def lattice_bidir_reference(le, ls, lf, input_length, output_length):
    """Alphas and betas (U, B, T) f32, in the bidirectional kernel's
    operation order."""
    return (_forward_alphas(le, ls, lf),
            lattice_backward_betas_reference(le, ls, lf, input_length,
                                             output_length))


def _row_max(x):
    """An exp-domain normalizer: the (B, T) field's max over T, at least
    _TINY, as (B, 1)."""
    return torch.clamp(x.amax(dim=1, keepdim=True), min=_TINY)


def _exp_setup(x, input_length, output_length):
    """(t == 0 as 0/1 f32, t == T_b - 1, u_last (B, 1), zeros (B, T),
    zeros (B, 1)) for the exp-domain walks of a (U, B, T) lattice."""
    _, B, T = x.shape
    dev = x.device
    t_idx = torch.arange(T, device=dev)[None, :]
    first_t = (t_idx == 0).float().expand(B, T)
    is_last_t = t_idx == input_length.long()[:, None] - 1
    last_u = output_length.long()[:, None] - 1
    return (first_t, is_last_t, last_u, torch.zeros((B, T), device=dev),
            torch.zeros((B, 1), device=dev))


def lattice_bidir_exp_reference(le, ls, lf, input_length, output_length):
    """#4 in its kernel's operation order: alphas and betas (U, B, T) f32,
    the logs of probability-domain walks divided by their row max in every
    column (plus the running log normalizer); -inf where a cell's
    probability is 0.

      forward:  q = p * exp(le_{u-1}) + shift0_down(p * exp(ls_{u-1}))
                p_raw = (u == 0 ? onehot(t == 0) : q) * exp(lf_u)
                alpha_u = log(p_raw) + m;  s = rowmax;  p = p_raw / s
                m += log(s)
      backward: c = b * exp(lf_{u+1})
                b_raw = exp(le_u) * c + exp(ls_u) * shift0_up(c),
                reset to (t == T_b-1 ? exp(le_u) : 0) and n = 0 at
                u == U_b-1;  beta_u = log(b_raw) + n;  b = b_raw / s
                n += log(s)"""
    U, B, T = le.shape
    first_t, is_last_t, last_u, zeros, zcol = _exp_setup(
        le, input_length, output_length)
    alphas = torch.empty((U, B, T), device=le.device)
    betas = torch.empty_like(alphas)
    p, m, e_le_prev, e_ls_prev = zeros, zcol, zeros, zeros
    for u in range(U):
        q = p * e_le_prev + shift_down_t(p * e_ls_prev, 0.0)
        p_raw = (first_t if u == 0 else q) * torch.exp(lf[u])
        s = _row_max(p_raw)
        alphas[u] = torch.log(p_raw) + m
        p = p_raw / s
        m = m + torch.log(s)
        e_le_prev, e_ls_prev = torch.exp(le[u]), torch.exp(ls[u])
    b, n, e_lf_next = zeros, zcol, zeros
    for u in range(U - 1, -1, -1):
        e_le = torch.exp(le[u])
        c = b * e_lf_next
        b_raw = e_le * c + torch.exp(ls[u]) * shift_up_t(c, 0.0)
        init = last_u == u
        b_raw = torch.where(init, torch.where(is_last_t, e_le, 0.0), b_raw)
        n = torch.where(init, 0.0, n)
        s = _row_max(b_raw)
        betas[u] = torch.log(b_raw) + n
        b = b_raw / s
        n = n + torch.log(s)
        e_lf_next = torch.exp(lf[u])
    return alphas, betas


def lattice_expin_reference(E, S, F, mcol, input_length, output_length):
    """#9 in its kernel's operation order: (qn, bn) (U, B, T) and (M, N)
    (U, B), f32, from probabilities E, S, F (U, B, T) and the column
    scalars mcol (U, B); alpha_u = log(qn_u * F_u) + M_u, beta_u =
    log(bn_u) + N_u. A normalizer s scales by its correctly rounded
    reciprocal (q * (1/s)), forward after column u when (u + 1) % 4 == 0,
    backward at column u when u % 4 == 0.

      forward:  q = p * E_{u-1} + shift0_down(p * S_{u-1}) (p = onehot(t
                == 0), E_{-1} = 1, S_{-1} = 0 before column 0);
                [q *= 1/s, m += log(s)];  qn_u = q;  m += mcol_u;
                M_u = m;  p = qn_u * F_u
      backward: b_raw = E_u * c + S_u * shift0_up(c), reset to (t ==
                T_b-1 ? E_u : 0) and n = 0 at u == U_b-1;  [b_raw *= 1/s,
                n += log(s)];  bn_u = b_raw;  N_u = n;  c = F_u * bn_u;
                n += mcol_u"""
    U, B, T = E.shape
    first_t, is_last_t, last_u, zeros, zcol = _exp_setup(
        E, input_length, output_length)
    qn = torch.empty((U, B, T), device=E.device)
    bn = torch.empty_like(qn)
    M = torch.empty((U, B), device=E.device)
    N = torch.empty_like(M)
    p, m, e_prev, s_prev = first_t, zcol, torch.ones_like(zeros), zeros
    for u in range(U):
        q = p * e_prev + shift_down_t(p * s_prev, 0.0)
        if (u + 1) % _RENORM == 0:
            s = _row_max(q)
            q = q * torch.reciprocal(s)
            m = m + torch.log(s)
        qn[u] = q
        m = m + mcol[u][:, None]
        M[u] = m[:, 0]
        p = q * F[u]
        e_prev, s_prev = E[u], S[u]
    c, n = zeros, zcol
    for u in range(U - 1, -1, -1):
        init = last_u == u
        b_raw = E[u] * c + S[u] * shift_up_t(c, 0.0)
        b_raw = torch.where(init, torch.where(is_last_t, E[u], 0.0), b_raw)
        n = torch.where(init, 0.0, n)
        if u % _RENORM == 0:
            s = _row_max(b_raw)
            b_raw = b_raw * torch.reciprocal(s)
            n = n + torch.log(s)
        bn[u] = b_raw
        N[u] = n[:, 0]
        c = F[u] * b_raw
        n = n + mcol[u][:, None]
    return qn, bn, M, N


def lattice_forward_alphas_reference(le, ls, lf):
    """Alphas (U, B, T) f32 from f32 or bf16 inputs (upcast on load)."""
    return _forward_alphas(le.float(), ls.float(), lf.float())


def lattice_backward_grads_reference(le, ls, lf, alphas, input_length,
                                     output_length, g, logz):
    """(d_le, d_ls, d_lf) in le's dtype: the backward-gradients kernel's
    reverse walk (beta and the three posteriors per column, the
    posterior exponent clamped at 30, zero for an example whose
    logz <= NEG/2), in its operation order."""
    U, B, T = le.shape
    dev = le.device
    le32, ls32, lf32 = le.float(), ls.float(), lf.float()
    t_idx = torch.arange(T, device=dev)[None, :]
    in_len = input_length.long()[:, None]
    out_len = output_length.long()[:, None]
    is_last_t = t_idx == in_len - 1
    t_valid = t_idx < in_len
    logz_c = logz[:, None]
    neg_g = torch.where(logz_c <= NEG / 2, 0.0, -g[:, None])
    neg = torch.full((B, T), NEG, device=dev)
    zero = torch.zeros((), device=dev)
    d = torch.empty((3, U, B, T), device=dev)
    beta, lf_next = neg, neg
    for u in range(U - 1, -1, -1):
        is_last_u = out_len - 1 == u
        valid = t_valid & (u < out_len)

        def post(score):
            return neg_g * torch.where(
                valid, torch.exp(torch.clamp(score, max=30.0)), zero)

        cont = lf_next + beta
        cont_shift_raw = shift_up_t(cont)
        cont_emit = torch.where(is_last_u,
                                torch.where(is_last_t, zero, neg), cont)
        cont_shift = torch.where(is_last_u, neg, cont_shift_raw)
        anorm = alphas[u] - logz_c
        d[0, u] = post(anorm + le32[u] + cont_emit)
        d[1, u] = post(anorm + ls32[u] + cont_shift)
        rec = logaddexp(le32[u] + cont, ls32[u] + cont_shift_raw)
        beta = torch.where(is_last_u, torch.where(is_last_t, le32[u], neg),
                           rec)
        d[2, u] = post(anorm + beta)
        lf_next = lf32[u]
    return tuple(x.to(le.dtype) for x in d)


# The banded walks' algebra (lattice_pallas.py:76-105, :202-233): a band
# operator is a list of (..., T) coefficients, entry k acting on t -+ k;
# a shift by k >= T is all NEG.

def _lse(*terms):
    """logsumexp of the terms in the TPU kernels' order: the max, the sum of
    exp(term - max) left to right, then max + log(sum)."""
    m = terms[0]
    for x in terms[1:]:
        m = torch.maximum(m, x)
    acc = torch.exp(terms[0] - m)
    for x in terms[1:]:
        acc = acc + torch.exp(x - m)
    return m + torch.log(acc)


def _compose(A, Bop, shift):
    """A o Bop (Bop applied first): entry k is the _lse over ascending i of
    A[i] + shift(Bop[k-i], k=i); an entry of one term is that term."""
    out = [[] for _ in range(len(A) + len(Bop) - 1)]
    for i, a in enumerate(A):
        for j, b in enumerate(Bop):
            out[i + j].append(a + shift(b, k=i))
    return [x[0] if len(x) == 1 else _lse(*x) for x in out]


def _tree_compose(ops, shift):
    """ops[-1] o ... o ops[0] for K (a power of two) operators, pairwise:
    [M0, M1, M2, M3] -> [M1 o M0, M3 o M2] -> [(M3 o M2) o (M1 o M0)]."""
    while len(ops) > 1:
        ops = [_compose(ops[i + 1], ops[i], shift)
               for i in range(0, len(ops), 2)]
    return ops[0]


def _pad_u(x, K: int):
    """(U, B, T) -> (U', B, T), U' the next multiple of K, padded with NEG."""
    pad = -x.shape[0] % K
    if not pad:
        return x
    return torch.cat([x, torch.full_like(x[:1], NEG).expand(pad, -1, -1)])


def lattice_forward_alphas_banded_reference(le, ls, lf, K: int):
    """#2 in its kernel's operation order: alphas (U, B, T) f32 from a f32
    lattice. Column u's operator [lf_u + le_{u-1}, lf_u + ls_{u-1}(t-1)]
    (le_{-1} = 0, ls_{-1} = NEG, alpha_{-1} = [t == 0] as 0/NEG); the K
    columns of each group compose by _tree_compose, the chain applies the
    composed band (the group's last column), and the other columns are
    replayed from the group's start value."""
    U, B, T = le.shape
    le, ls, lf = (_pad_u(x, K) for x in (le, ls, lf))
    G = le.shape[0] // K
    le_prev = torch.cat([torch.zeros_like(le[:1]), le[:-1]])
    ls_prev = torch.cat([torch.full_like(ls[:1], NEG), ls[:-1]])
    diag = (lf + le_prev).view(G, K, B, T)
    sub = (lf + shift_down_t(ls_prev)).view(G, K, B, T)
    P = _tree_compose([[diag[:, j], sub[:, j]] for j in range(K)],
                      shift_down_t)
    alphas = torch.empty((G, K, B, T), device=le.device)
    starts = torch.empty((G, B, T), device=le.device)
    t_idx = torch.arange(T, device=le.device)
    alpha = torch.where(t_idx == 0, 0.0, NEG).expand(B, T)
    for g in range(G):
        starts[g] = alpha
        alpha = _lse(*[P[k][g] + shift_down_t(alpha, k=k)
                       for k in range(K + 1)])
        alphas[g, K - 1] = alpha
    a = starts  # the interiors of all groups at once
    for j in range(K - 1):
        a = _lse(diag[:, j] + a, sub[:, j] + shift_down_t(a))
        alphas[:, j] = a
    return alphas.view(G * K, B, T)[:U]


def lattice_backward_grads_banded_reference(le, ls, lf, alphas,
                                            input_length, output_length,
                                            g, logz, K: int):
    """#6 in its kernel's operation order: (d_le, d_ls, d_lf) f32. The
    columns are uniformized (le, lf -> 0 for u >= U_b, ls -> NEG for
    u >= U_b - 1; lf above the padded top 0), column u's operator is
    [leu_u + lf_{u+1}, lsu_u + lf_{u+1}(t+1)], the beta chain starts from
    [t == T_b - 1] as 0/NEG at the padded top and applies each group's
    composed band (columns from the top down); the posteriors are
    lattice_backward_grads_reference's."""
    U, B, T = le.shape
    dev = le.device
    le, ls, lf, alphas = (_pad_u(x, K) for x in (le, ls, lf, alphas))
    Up = le.shape[0]
    G = Up // K
    u_idx = torch.arange(Up, device=dev)[:, None, None]
    out_len = output_length.long()[None, :, None]
    t_idx = torch.arange(T, device=dev)[None, :]
    in_len = input_length.long()[:, None]
    is_last_t = t_idx == in_len - 1
    leu = torch.where(u_idx < out_len, le, 0.0)
    lsu = torch.where(u_idx < out_len - 1, ls, NEG)
    lfc = torch.where(u_idx < out_len, lf, 0.0)
    lf_above = torch.cat([lfc[1:], torch.zeros_like(lfc[:1])])
    diag = (leu + lf_above).view(G, K, B, T)
    sup = (lsu + shift_up_t(lf_above)).view(G, K, B, T)
    P = _tree_compose([[diag[:, j], sup[:, j]] for j in range(K - 1, -1, -1)],
                      shift_up_t)
    top = torch.empty((G, B, T), device=dev)
    bottom = torch.empty((G, B, T), device=dev)
    beta = torch.where(is_last_t, 0.0, NEG)
    for gi in range(G - 1, -1, -1):
        top[gi] = beta
        beta = _lse(*[P[k][gi] + shift_up_t(beta, k=k) for k in range(K + 1)])
        bottom[gi] = beta
    bs = [bottom] + [None] * (K - 1) + [top]  # beta at base + j, all groups
    for j in range(K - 1, 0, -1):
        bs[j] = _lse(diag[:, j] + bs[j + 1],
                     sup[:, j] + shift_up_t(bs[j + 1]))
    betas = torch.stack(bs[:K], dim=1).view(Up, B, T)
    beta_next = torch.stack(bs[1:], dim=1).view(Up, B, T)

    is_last_u = u_idx == out_len - 1
    alpha = torch.where(u_idx < out_len, alphas - logz[None, :, None], NEG)
    cont = lf_above + beta_next
    cont_emit = torch.where(is_last_u, torch.where(is_last_t, 0.0, NEG),
                            cont)
    cont_shift = torch.where(is_last_u, NEG, shift_up_t(cont))
    neg_g = torch.where(logz <= NEG / 2, 0.0, -g)[None, :, None]
    t_valid = t_idx < in_len

    def post(score):
        return neg_g * torch.where(
            t_valid, torch.exp(torch.clamp(score, max=30.0)), 0.0)

    return (post(alpha + leu + cont_emit)[:U],
            post(alpha + ls + cont_shift)[:U], post(alpha + betas)[:U])


# ------------------------------------------------------------- wrappers

_STORE = (torch.float32, torch.bfloat16)


def check_shape(U: int, B: int, T: int) -> None:
    """Raise ValueError, naming the limit, unless the kernels take a (U, B,
    T) lattice: 1 <= T <= MAX_T, U >= 1 and B * T < 2^31 (a column's
    offsets are 32-bit; no library needed)."""
    if not 1 <= T <= MAX_T or U < 1 or B * T > MAX_COLUMN:
        raise ValueError(f"lattice (U={U}, B={B}, T={T}): the lattice "
                         f"kernels take 1 <= T <= {MAX_T}, U >= 1 and "
                         f"B * T <= {MAX_COLUMN}")


def _cuda_args(le, ls, lf, dtypes):
    """Common checks of a (U, B, T) lattice on the card; returns U, B, T
    and the device."""
    dev = le.device
    if dev.type != "cuda":
        raise ValueError(f"lattice kernels run on cuda or cpu, not {dev}")
    U, B, T = le.shape
    check_shape(U, B, T)
    lib = _build.lattice_library()
    for name, x in (("le", le), ("ls", ls), ("lf", lf)):
        _build.check_arg(name, x, dtypes, (U, B, T), dev)
    if not le.dtype == ls.dtype == lf.dtype:
        raise ValueError("le, ls, lf must share one dtype")
    return lib, U, B, T, dev


def _check_lengths(B, dev, input_length, output_length) -> None:
    for name, x in (("input_length", input_length),
                    ("output_length", output_length)):
        _build.check_arg(name, x, torch.int32, (B,), dev)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def lattice_bidir(le, ls, lf, input_length, output_length):
    """(U, B, T) f32 lattice + (B,) int32 lengths -> (alphas, betas)
    (U, B, T) f32. On the card: for T <= 128 (and U * B * T < 2^31) each
    walk (example, direction) runs on ceil(T / 32) warps of one position a
    lane (a shuffle between lanes of one warp; between several, a shared
    row and a named barrier each column), beside a warp that stages its
    inputs and one that stores its outputs; otherwise one block per walk
    (csrc/lattice.cu)."""
    if le.device.type == "cpu":
        return lattice_bidir_reference(le, ls, lf, input_length,
                                       output_length)
    lib, U, B, T, dev = _cuda_args(le, ls, lf, torch.float32)
    _check_lengths(B, dev, input_length, output_length)
    alphas = torch.empty((U, B, T), device=dev)
    betas = torch.empty((U, B, T), device=dev)
    _raise_on(lib.ssnt_lattice_bidir(
        B, T, U, le.data_ptr(), ls.data_ptr(), lf.data_ptr(),
        input_length.data_ptr(), output_length.data_ptr(),
        alphas.data_ptr(), betas.data_ptr(), _stream(dev)), "lattice_bidir")
    lattice_bidir.launches += 1
    return alphas, betas


def lattice_forward_alphas(le, ls, lf):
    """(U, B, T) f32 or bf16 lattice -> alphas (U, B, T) f32. On the card:
    for T <= 128 (and U * B * T < 2^31) lattice_bidir's forward walk alone
    (its alphas bit for bit), rows staged in the lattice's dtype; otherwise
    one block per example (csrc/lattice.cu)."""
    if le.device.type == "cpu":
        return lattice_forward_alphas_reference(le, ls, lf)
    lib, U, B, T, dev = _cuda_args(le, ls, lf, _STORE)
    alphas = torch.empty((U, B, T), device=dev)
    _raise_on(lib.ssnt_lattice_forward_alphas(
        int(le.dtype == torch.bfloat16), B, T, U, le.data_ptr(),
        ls.data_ptr(), lf.data_ptr(), alphas.data_ptr(), _stream(dev)),
        "lattice_forward_alphas")
    lattice_forward_alphas.launches += 1
    return alphas


def lattice_backward_grads(le, ls, lf, alphas, input_length, output_length,
                           g, logz):
    """(U, B, T) lattice (f32 or bf16) + f32 alphas, (B,) int32 lengths,
    (B,) f32 upstream cotangent g and logz -> (d_le, d_ls, d_lf) in the
    lattice's dtype. On the card: for T <= 128 (and U * B * T < 2^31) a
    block per example of a loader warp, ceil(T / 32) warps walking the
    betas (lattice_bidir's beta walk) and ceil(T / 32) warps that form and
    store the posteriors beside them; otherwise one block per example
    (csrc/lattice.cu)."""
    if le.device.type == "cpu":
        return lattice_backward_grads_reference(
            le, ls, lf, alphas, input_length, output_length, g, logz)
    lib, U, B, T, dev = _cuda_args(le, ls, lf, _STORE)
    _build.check_arg("alphas", alphas, torch.float32, (U, B, T), dev)
    for name, x, dt in (("input_length", input_length, torch.int32),
                        ("output_length", output_length, torch.int32),
                        ("g", g, torch.float32),
                        ("logz", logz, torch.float32)):
        _build.check_arg(name, x, dt, (B,), dev)
    d = [torch.empty((U, B, T), dtype=le.dtype, device=dev)
         for _ in range(3)]
    _raise_on(lib.ssnt_lattice_backward_grads(
        int(le.dtype == torch.bfloat16), B, T, U,
        *(x.data_ptr() for x in (le, ls, lf, alphas, input_length,
                                 output_length, g, logz, *d)),
        _stream(dev)), "lattice_backward_grads")
    lattice_backward_grads.launches += 1
    return tuple(d)


def lattice_backward_betas(le, ls, lf, input_length, output_length):
    """(U, B, T) f32 lattice + (B,) int32 lengths -> betas (U, B, T) f32,
    bit for bit lattice_bidir's betas. On the card: for T <= 128 (and
    U * B * T < 2^31) lattice_bidir's backward walk alone; otherwise one
    block per example (csrc/lattice.cu)."""
    if le.device.type == "cpu":
        return lattice_backward_betas_reference(le, ls, lf, input_length,
                                                output_length)
    lib, U, B, T, dev = _cuda_args(le, ls, lf, torch.float32)
    _check_lengths(B, dev, input_length, output_length)
    betas = torch.empty((U, B, T), device=dev)
    _raise_on(lib.ssnt_lattice_backward_betas(
        B, T, U, le.data_ptr(), ls.data_ptr(), lf.data_ptr(),
        input_length.data_ptr(), output_length.data_ptr(), betas.data_ptr(),
        _stream(dev)), "lattice_backward_betas")
    lattice_backward_betas.launches += 1
    return betas


def lattice_bidir_exp(le, ls, lf, input_length, output_length):
    """(U, B, T) f32 lattice + (B,) int32 lengths -> (alphas, betas)
    (U, B, T) f32 by the exp-domain walks; -inf for a cell of
    probability 0. On the card: for T <= 128 (and U * B * T < 2^31) one
    warp per walk (shuffles for the neighbour and the row max), beside
    warps that stage and exponentiate its inputs and one that takes the
    logs and stores; otherwise one block per walk (csrc/lattice.cu)."""
    if le.device.type == "cpu":
        return lattice_bidir_exp_reference(le, ls, lf, input_length,
                                           output_length)
    lib, U, B, T, dev = _cuda_args(le, ls, lf, torch.float32)
    _check_lengths(B, dev, input_length, output_length)
    alphas = torch.empty((U, B, T), device=dev)
    betas = torch.empty((U, B, T), device=dev)
    _raise_on(lib.ssnt_lattice_bidir_exp(
        B, T, U, le.data_ptr(), ls.data_ptr(), lf.data_ptr(),
        input_length.data_ptr(), output_length.data_ptr(),
        alphas.data_ptr(), betas.data_ptr(), _stream(dev)),
        "lattice_bidir_exp")
    lattice_bidir_exp.launches += 1
    return alphas, betas


def lattice_expin(E, S, F, mcol, input_length, output_length):
    """(U, B, T) f32 probabilities E, S, F, (U, B) f32 mcol and (B,) int32
    lengths -> (qn, bn (U, B, T), M, N (U, B)) f32. On the card: for T <=
    128 (and U * B * T < 2^31) one warp per example and direction walks
    the columns (shuffles for the neighbour and the row max), beside a
    warp that stages its inputs and one that stores its outputs; otherwise
    one block per walk (csrc/lattice.cu)."""
    if E.device.type == "cpu":
        return lattice_expin_reference(E, S, F, mcol, input_length,
                                       output_length)
    lib, U, B, T, dev = _cuda_args(E, S, F, torch.float32)
    _build.check_arg("mcol", mcol, torch.float32, (U, B), dev)
    _check_lengths(B, dev, input_length, output_length)
    qn = torch.empty((U, B, T), device=dev)
    bn = torch.empty((U, B, T), device=dev)
    M = torch.empty((U, B), device=dev)
    N = torch.empty((U, B), device=dev)
    _raise_on(lib.ssnt_lattice_expin(
        B, T, U, *(x.data_ptr() for x in (E, S, F, mcol, input_length,
                                          output_length, qn, bn, M, N)),
        _stream(dev)), "lattice_expin")
    lattice_expin.launches += 1
    return qn, bn, M, N


@functools.lru_cache(maxsize=None)
def banded_max_t(K: int, backward: int) -> int:
    """The largest T the K-banded forward (backward 0) or backward (1)
    kernels take on the card: the threads their registers allow a block,
    one thread a position (below MAX_T)."""
    return _build.lattice_library().ssnt_lattice_banded_max_t(K, backward)


def _banded_args(le, ls, lf, K: int, backward: int):
    """_cuda_args for a K-banded kernel, whose registers may cap T below
    the other kernels' limit (asked once per K and direction)."""
    lib, U, B, T, dev = _cuda_args(le, ls, lf, torch.float32)
    limit = banded_max_t(K, backward)
    if T > limit:
        raise ValueError(f"lattice T={T}: the K={K} banded kernel takes "
                         f"T <= {limit}")
    return lib, U, B, T, dev


def _check_band(K: int) -> None:
    if K not in _BANDS:
        raise ValueError(f"banded lattice K={K}: want one of {_BANDS}")


def lattice_forward_alphas_banded(le, ls, lf, K: int):
    """(U, B, T) f32 lattice -> alphas (U, B, T) f32 by K-banded chains,
    K in (2, 4, 8, 16). On the card: three kernels (compose, chain,
    replay; csrc/lattice.cu) through a (ceil(U/K), K+1, B, T) f32
    workspace of the groups' composed operators; one launch counted."""
    _check_band(K)
    if le.device.type == "cpu":
        return lattice_forward_alphas_banded_reference(le, ls, lf, K)
    lib, U, B, T, dev = _banded_args(le, ls, lf, K, 0)
    alphas = torch.empty((U, B, T), device=dev)
    work = torch.empty((-(-U // K), K + 1, B, T), device=dev)
    _raise_on(lib.ssnt_lattice_forward_alphas_banded(
        K, B, T, U, le.data_ptr(), ls.data_ptr(), lf.data_ptr(),
        alphas.data_ptr(), work.data_ptr(), _stream(dev)),
        "lattice_forward_alphas_banded")
    lattice_forward_alphas_banded.launches += 1
    return alphas


def lattice_backward_grads_banded(le, ls, lf, alphas, input_length,
                                  output_length, g, logz, K: int):
    """(U, B, T) f32 lattice and alphas, (B,) int32 lengths, (B,) f32
    upstream cotangent g and logz -> (d_le, d_ls, d_lf) f32 by K-banded
    beta chains. On the card: three kernels (compose, chain, replay;
    csrc/lattice.cu) through a (ceil(U/K), K+1, B, T) f32 workspace of the
    groups' composed operators and a (ceil(U/K), B, T) one of the chain's
    betas at the groups' bottoms; one launch counted."""
    _check_band(K)
    if le.device.type == "cpu":
        return lattice_backward_grads_banded_reference(
            le, ls, lf, alphas, input_length, output_length, g, logz, K)
    lib, U, B, T, dev = _banded_args(le, ls, lf, K, 1)
    _build.check_arg("alphas", alphas, torch.float32, (U, B, T), dev)
    for name, x, dt in (("input_length", input_length, torch.int32),
                        ("output_length", output_length, torch.int32),
                        ("g", g, torch.float32),
                        ("logz", logz, torch.float32)):
        _build.check_arg(name, x, dt, (B,), dev)
    d = [torch.empty((U, B, T), device=dev) for _ in range(3)]
    G = -(-U // K)
    work = torch.empty((G, K + 1, B, T), device=dev)
    bottoms = torch.empty((G, B, T), device=dev)
    _raise_on(lib.ssnt_lattice_backward_grads_banded(
        K, B, T, U,
        *(x.data_ptr() for x in (le, ls, lf, alphas, input_length,
                                 output_length, g, logz, *d, work, bottoms)),
        _stream(dev)), "lattice_backward_grads_banded")
    lattice_backward_grads_banded.launches += 1
    return tuple(d)


KERNELS = (lattice_bidir, lattice_forward_alphas, lattice_backward_grads,
           lattice_backward_betas, lattice_bidir_exp, lattice_expin,
           lattice_forward_alphas_banded, lattice_backward_grads_banded)
for _k in KERNELS:
    _k.launches = 0


# ---------------------------------------------------------- the loss

class _KernelLoss(torch.autograd.Function):
    """Time-major core, as lattice_pallas._core: (U, B, T) -> (B,) loss.
    The forward runs the exp-domain bidirectional kernel on the exp route
    and the banded forward on the banded route (with gradients and
    without), the bidirectional kernel when gradients are needed on the
    fused route, and forward alphas alone otherwise."""

    @staticmethod
    def forward(ctx, le, ls, lf, input_length, output_length, mode, K,
                need_grad):
        betas = None
        if mode == "exp":
            alphas, betas = lattice_bidir_exp(le, ls, lf, input_length,
                                              output_length)
        elif mode == "banded":
            alphas = lattice_forward_alphas_banded(le, ls, lf, K)
        elif need_grad and mode == "fused":
            alphas, betas = lattice_bidir(le, ls, lf, input_length,
                                          output_length)
        else:
            alphas = lattice_forward_alphas(le, ls, lf)
        logz = gather_logz(alphas, le, input_length, output_length)
        ctx.save_for_backward(le, ls, lf, alphas, betas, logz, input_length,
                              output_length)
        ctx.K = K
        return -logz

    @staticmethod
    def backward(ctx, g):
        le, ls, lf, alphas, betas, logz, il, ol = ctx.saved_tensors
        g = g.float().contiguous()
        if ctx.K:
            d = lattice_backward_grads_banded(le, ls, lf, alphas, il, ol, g,
                                              logz, ctx.K)
        elif betas is None:
            d = lattice_backward_grads(le, ls, lf, alphas, il, ol, g, logz)
        else:
            d = posterior_grads(le, ls, lf, alphas, betas, logz, il, ol, g)
        return tuple(d) + (None,) * 5


def ssnt_loss_kernels(log_emit, log_shift, log_frame=None,
                      input_length=None, output_length=None, *,
                      variant: str = "log", layout: str = "btu"):
    """ops.lattice.ssnt_loss on the lattice kernels (same semantics and
    gradients). variant "bf16" stores the lattice in bfloat16 (f32 compute
    in the kernels, f32 alphas, bf16 gradients); variant "exp" gives +inf,
    not 1e30, for an example with no valid path (its gradients are 0), as
    the JAX kernel does; variant "scan" is lattice_scan.ssnt_loss_scan
    (plain PyTorch, no kernel); see grad_mode for the others. layout "btu"
    (B, T, U) or "ubt" (time-major, what the model's joints emit).
    Returns the (B,) float32 per-example NLL."""
    store = torch.bfloat16 if variant == "bf16" else torch.float32
    args = canonicalize(log_emit, log_shift, log_frame, input_length,
                        output_length, layout, dtype=store)
    le, ls, lf, il, ol = to_ubt(args, layout)
    if variant == "scan":
        return lattice_scan.ssnt_loss_scan(le, ls, lf, il, ol, layout="ubt")
    U, B, T = le.shape
    mode, K = grad_mode(variant, B, T)
    need_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (le, ls, lf))
    return _KernelLoss.apply(le.contiguous(), ls.contiguous(),
                             lf.contiguous(), il.contiguous(),
                             ol.contiguous(), mode, K, need_grad)


# The exp-native loss forms its final cell and its posteriors from the logs
# of the fields, not from their products as JAX does: between
# renormalizations (up to 3 columns) qn and bn fall far below 1, so JAX's
# scalar exponents (M + N - logz etc., clamped at 30, the log path's clamp
# on a whole posterior exponent) pass 30 and cut the posteriors, and its
# final cell qn * F * E can fall under its 1e-30 floor. Here the clamp
# applies to the whole exponent, as in the log path; where JAX's clamp
# does not bind, the two agree to rounding.

def expin_logz(E, F, qn, M, input_length, output_length):
    """logZ (B,) = alpha + le at the final cell = log(qn F E) + M there;
    NEG for an example whose final cell has probability 0."""
    U, B, T = E.shape
    b_idx = torch.arange(B, device=E.device)
    u_last = (output_length.long() - 1).clamp(0, U - 1)
    t_last = (input_length.long() - 1).clamp(0, T - 1)
    cell = [x[u_last, b_idx, t_last] for x in (qn, F, E)]
    live = (cell[0] > 0) & (cell[1] > 0) & (cell[2] > 0)
    return torch.where(live, sum(torch.log(x) for x in cell)
                       + M[u_last, b_idx], NEG)


def expin_grads(E, S, F, mcol, qn, bn, M, N, logz, input_length,
                output_length, g):
    """lattice_pallas._expin_bwd: d loss / d (E, S, F, mcol) from the
    exp-native pass's fields, times the upstream cotangent g (B,), zero
    outside the valid region and for an example with no valid path:
      d_E = -g exp(alpha + cont_emit - logz)   (u < U_b-1)
          = -g exp(alpha - logz) at t = T_b-1  (u = U_b-1)
      d_S = -g exp(alpha + shift_up(cont) - logz)
      d_F = -g exp(alpha + beta - logz) / F,  d_mcol = sum_t F d_F
    with alpha = log(qn F) + M, beta = log(bn) + N and cont = log(F bn)
    + mcol + N at u+1, each exponent clamped at 30."""
    U, B, T = E.shape
    dev = E.device
    u_idx = torch.arange(U, device=dev)[:, None, None]
    t_idx = torch.arange(T, device=dev)[None, None, :]
    in_len = input_length.long()[None, :, None]
    out_len = output_length.long()[None, :, None]
    valid = (t_idx < in_len) & (u_idx < out_len)
    is_last_u = u_idx == out_len - 1
    is_last_t = t_idx == in_len - 1
    degenerate = logz[None, :, None] <= NEG / 2
    gB = torch.where(degenerate | ~valid, 0.0, -g.float()[None, :, None])

    def post(x):  # exp of an exponent clamped at 30
        return torch.exp(torch.clamp(x, max=30.0))

    log_qn, log_F, log_bn = torch.log(qn), torch.log(F), torch.log(bn)
    sa = log_qn + log_F + (M - logz[None, :])[:, :, None]  # alpha - logz
    # The continuation at u+1: field log(F bn), scalar mcol + N (NEG past
    # the last column).
    log_c = log_F + log_bn
    c_next = torch.cat([log_c[1:], torch.full_like(log_c[:1], -torch.inf)],
                       dim=0)
    cs_next = torch.cat([(mcol + N)[1:], torch.full_like(mcol[:1], NEG)],
                        dim=0)[:, :, None]
    d_E = gB * torch.where(is_last_u, torch.where(is_last_t, post(sa), 0.0),
                           post(sa + c_next + cs_next))
    d_S = gB * torch.where(
        is_last_u, 0.0, post(sa + shift_up_t(c_next, -torch.inf) + cs_next))
    d_F = gB * post(log_qn + log_bn + (M + N - logz[None, :])[:, :, None])
    return d_E, d_S, d_F, (d_F * F).sum(dim=2)


class _ExpinLoss(torch.autograd.Function):
    """lattice_pallas._expin_core: (E, S, F, mcol) -> (B,) loss; gradients
    with respect to the probabilities themselves."""

    @staticmethod
    def forward(ctx, E, S, F, mcol, input_length, output_length):
        qn, bn, M, N = lattice_expin(E, S, F, mcol, input_length,
                                     output_length)
        logz = expin_logz(E, F, qn, M, input_length, output_length)
        ctx.save_for_backward(E, S, F, mcol, qn, bn, M, N, logz,
                              input_length, output_length)
        return -logz

    @staticmethod
    def backward(ctx, g):
        return expin_grads(*ctx.saved_tensors, g) + (None, None)


def ssnt_loss_expin_kernels(E, S, F, mcol, input_length=None,
                            output_length=None):
    """lattice_pallas.ssnt_loss_expin on the exp-native kernel: the (B,)
    NLL of ssnt_loss(log E, log S, log F + mcol) from time-major
    probabilities E, S (U, B, T) (E + S = 1 per cell), column-max
    normalized frame likelihoods F (U, B, T) in [0, 1] and mcol (U, B).
    Inputs are upcast to float32 (a bf16 lattice gets bf16 gradients);
    gradients are with respect to (E, S, F, mcol). An example with no
    valid path gives the 1e30 sentinel and zero gradients."""
    U, B, T = E.shape
    dev = E.device
    if input_length is None:
        input_length = torch.full((B,), T, dtype=torch.int32)
    if output_length is None:
        output_length = torch.full((B,), U, dtype=torch.int32)
    lens = lambda x: torch.as_tensor(x).to(device=dev,
                                           dtype=torch.int32).contiguous()
    return _ExpinLoss.apply(
        *(x.float().contiguous() for x in (E, S, F, mcol)),
        lens(input_length), lens(output_length))
