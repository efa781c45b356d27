"""PyTorch port, the exp-native pass (#9) as its warp walk runs it for
T <= 128 (csrc/lattice.cu expin_warp_kernel): a block of three warps per
(example, direction), the walk on one warp whose lane l holds the V
consecutive source positions t = l*V + j (V = 1, 2 or 4 by T), emulated
here lane by lane over the flat (U*B*T,) fields, must equal
lattice_expin_reference bit for bit:

  - rounds of 4 columns aligned on u (forward r*4 + k, backward top - r*4
    + 3 - k with top = (U-1)//4*4), the renormalizing column each round's
    last;
  - the loader stages round r into input slot r % 6 (a round is staged at
    most 6 ahead of the chain, and only into a slot the chain has read),
    each lane its own live positions, zeros for a column past U;
  - the chain: the neighbour exchange (forward, the value at t - 1 from
    the lane below, __shfl_up_sync, 0 into t = 0; backward, t + 1 from the
    lane above, __shfl_down_sync, 0 from t >= T) and at the renormalizing
    column the row max (the lane's max over its live values, 0 for a lane
    past T, then the warp's max) floored at 1e-30, the field times its
    correctly rounded reciprocal; each round's field and normalizer into
    result slot r % 4 (only one the storer has read);
  - the storer: the field of the round's columns below U, and the log
    normalizers M, N from the normalizer and mcol (lane l loads column
    slot 32q + l of each 32-column block q, read by shuffle, and stores
    that column's M / N at the block's end); it trails the chain by up to
    3 rounds.

Per cell the operations and their order are the block walk's (q = p * E +
shift(p * S); b = E * c + S * shift(c)), so the emulation and the plain
version agree exactly. Inputs are numpy-seeded; lengths are ragged, with
il = ol = 1 and an example whose emit probability is 0 everywhere."""

import numpy as np
import pytest
import torch

from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

LANES, RENORM, TINY = 32, 4, 1e-30
IN_ROUNDS, RES_ROUNDS = 6, 4  # the input and result rings, in rounds


def lanes_v(T: int) -> int:
    """V, the positions a lane holds: ceil(T / 32) rounded up to 1, 2, 4."""
    assert 1 <= T <= 128
    return 1 if T <= 32 else 2 if T <= 64 else 4


class Walk:
    """One walk's columns, its two rings and its mcol blocks. column(r, k)
    is round r's k-th column in walk order; a ring slot holds a round or
    None once read."""

    def __init__(self, fields, mcol, b, B, T, U, V, backward):
        self.fields, self.mcol = fields, mcol
        self.b, self.B, self.T, self.U = b, B, T, U
        self.backward = backward
        self.top = (U - 1) // RENORM * RENORM
        self.rounds = -(-U // RENORM)
        self.t = torch.arange(LANES * V).view(LANES, V)
        self.live = self.t < T
        self.inputs = [None] * IN_ROUNDS
        self.results = [None] * RES_ROUNDS

    def column(self, r, k):
        if self.backward:
            return self.top - RENORM * r + RENORM - 1 - k
        return RENORM * r + k

    def load(self, r):
        """The loader: round r's E, S, F at the live positions (NaN where
        nothing is staged), zeros for a column past U."""
        assert self.inputs[r % IN_ROUNDS] is None  # the chain has read it
        tt = self.t.clamp(max=self.T - 1)
        nan = torch.full(self.t.shape, float("nan"))
        cols = []
        for k in range(RENORM):
            u = self.column(r, k)
            o = (min(u, self.U - 1) * self.B + self.b) * self.T
            cols.append([torch.where(self.live, x[o + tt] if u < self.U
                                     else 0.0, nan) for x in self.fields])
        self.inputs[r % IN_ROUNDS] = cols

    def take(self, r):
        cols = self.inputs[r % IN_ROUNDS]
        self.inputs[r % IN_ROUNDS] = None
        return cols

    def give(self, r, field, norm):
        assert self.results[r % RES_ROUNDS] is None  # the storer has read it
        self.results[r % RES_ROUNDS] = (field, norm)

    def mcol_block(self, q):
        """block_mcol: lane l's mcol of column slot 32q + l (0 past U)."""
        vals = []
        for lane in range(LANES):
            i = q * LANES + lane
            u = self.column(i // RENORM, i % RENORM)
            vals.append(self.mcol[u * self.B + self.b] if 0 <= u < self.U
                        else torch.tensor(0.0))
        return torch.stack(vals)


def warp_max(x, live):
    """warp_renorm's max: each lane's max over its live values (0 for a
    lane past T), then the warp's max."""
    m = torch.where(live[:, 0], x[:, 0], 0.0)
    for j in range(1, x.shape[1]):
        m = torch.where(live[:, j], torch.maximum(m, x[:, j]), m)
    return m.max()


def renorm(x, live):
    norm = torch.clamp(warp_max(x, live), min=TINY)
    return x * torch.reciprocal(norm), norm


def alpha_round(w, state, cols, V):
    """expin_alpha_chain for one round: (field per column, normalizer)."""
    p, e_prev, s_prev = state
    q, norm = [], None
    for k, (e, s, f) in enumerate(cols):
        sp = p * s_prev
        edge = torch.cat([torch.zeros(1), sp[:-1, V - 1]])  # lane 0: 0
        qk = torch.empty(LANES, V)
        qk[:, 0] = p[:, 0] * e_prev[:, 0] + edge
        for j in range(1, V):
            qk[:, j] = p[:, j] * e_prev[:, j] + sp[:, j - 1]
        if k == RENORM - 1:
            qk, norm = renorm(qk, w.live)
        q.append(qk)
        p, e_prev, s_prev = qk * f, e, s
    state[:] = [p, e_prev, s_prev]
    return q, norm


def beta_round(w, state, cols, r, in_len, out_len, V):
    """expin_beta_chain for one round."""
    c, t, T = state[0], w.t, w.T
    bs, norm = [], None
    for k, (e, s, f) in enumerate(cols):
        above = torch.cat([c[1:, 0], c[-1:, 0]])  # lane 31 reads itself
        nb = torch.cat([c[:, 1:], above[:, None]], dim=1)
        nb = torch.where(t + 1 >= T, 0.0, nb)
        bk = e * c + s * nb
        if w.column(r, k) == out_len - 1:
            bk = torch.where(t == in_len - 1, e, 0.0)
        if k == RENORM - 1:
            bk, norm = renorm(bk, w.live)
        bs.append(bk)
        c = f * bk
    state[0] = c
    return bs, norm


def store_round(w, r, blocks, acc, keep, field_out, logs_out, out_len):
    """expin_storer for one round; returns the running log normalizer.
    keep[l] is lane l's M / N of column slot 32q + l of the current
    32-column block, stored at the block's end (or the walk's)."""
    field, norm = w.results[r % RES_ROUNDS]
    w.results[r % RES_ROUNDS] = None
    B, T, b, t, live = w.B, w.T, w.b, w.t, w.live
    for k in range(RENORM):
        u = w.column(r, k)
        slot = (RENORM * r + k) % LANES
        mc = blocks[r // (LANES // RENORM)][slot]
        if u >= w.U:
            continue
        field_out[((u * B + b) * T + t)[live]] = field[k][live]
        if w.backward and u == out_len - 1:
            acc = torch.zeros(())
        if k == RENORM - 1:
            acc = acc + torch.log(norm)
        if w.backward:
            keep[slot] = acc
            acc = acc + mc
        else:
            acc = acc + mc
            keep[slot] = acc
    per_block = LANES // RENORM
    if r % per_block == per_block - 1 or r == w.rounds - 1:
        for lane in range(LANES):
            i = r // per_block * LANES + lane
            ul = w.column(i // RENORM, i % RENORM)
            if i // RENORM <= r and 0 <= ul < w.U:
                logs_out[ul * B + b] = keep[lane]
    return acc


def run_walk(w, field_out, logs_out, in_len, out_len, V):
    """The three warps in an order their rings allow: the loader 6 rounds
    ahead of the chain, the storer 3 behind it."""
    t = w.t
    if w.backward:
        state = [torch.zeros(LANES, V)]
    else:
        state = [(t == 0).float(), torch.ones(LANES, V),
                 torch.zeros(LANES, V)]
    blocks = [w.mcol_block(q) for q in range(-(-w.rounds * RENORM
                                               // LANES))]
    acc, keep = torch.zeros(()), [None] * LANES
    for r in range(min(IN_ROUNDS, w.rounds)):
        w.load(r)
    for r in range(w.rounds):
        cols = w.take(r)
        if r + IN_ROUNDS < w.rounds:
            w.load(r + IN_ROUNDS)
        if w.backward:
            out = beta_round(w, state, cols, r, in_len, out_len, V)
        else:
            out = alpha_round(w, state, cols, V)
        if r >= RES_ROUNDS - 1:
            acc = store_round(w, r - RES_ROUNDS + 1, blocks, acc, keep,
                              field_out, logs_out, out_len)
        w.give(r, *out)
    for r in range(max(w.rounds - RES_ROUNDS + 1, 0), w.rounds):
        acc = store_round(w, r, blocks, acc, keep, field_out, logs_out,
                          out_len)


def emulate_expin_warp(E, S, F, mcol, il, ol):
    """(qn, bn, M, N) from the warp walks over flat buffers."""
    U, B, T = E.shape
    V = lanes_v(T)
    fields = [x.reshape(-1) for x in (E, S, F)]
    mflat = mcol.reshape(-1)
    qn, bn = (torch.full((U * B * T,), float("nan")) for _ in range(2))
    M, N = (torch.full((U * B,), float("nan")) for _ in range(2))
    for b in range(B):
        run_walk(Walk(fields, mflat, b, B, T, U, V, False), qn, M, 0, 0, V)
        run_walk(Walk(fields, mflat, b, B, T, U, V, True), bn, N,
                 int(il[b]), int(ol[b]), V)
    return qn.view(U, B, T), bn.view(U, B, T), M.view(U, B), N.view(U, B)


def expin_inputs(seed, U, T):
    """(E, S, F, mcol) and ragged lengths for 5 examples: full, il = ol =
    1, short, half, and example 4 with emit probability 0 everywhere."""
    rng = np.random.default_rng(seed)
    B = 5
    E = rng.uniform(0.1, 0.9, (U, B, T)).astype(np.float32)
    S = (1.0 - E).astype(np.float32)
    E[:, 4], S[:, 4] = 0.0, 1.0
    lf = rng.normal(-2.0, 1.0, (U, B, T)).astype(np.float32)
    mcol = lf.max(axis=2)
    F = np.exp(lf - mcol[:, :, None]).astype(np.float32)
    il = np.array([T, 1, max(1, T - 3), (T + 1) // 2, T], np.int32)
    ol = np.array([U, 1, U - 5, U // 2, U - 2], np.int32)
    return [torch.tensor(x) for x in (E, S, F, mcol, il, ol)]


@pytest.mark.parametrize("U", [37, 42])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 80, 128])
def test_warp_walk_equals_plain_version(T, U):
    torch.set_num_threads(1)
    E, S, F, mcol, il, ol = expin_inputs(T * 100 + U, U, T)
    got = emulate_expin_warp(E, S, F, mcol, il, ol)
    want = lk.lattice_expin_reference(E, S, F, mcol, il, ol)
    for name, a, w in zip(("qn", "bn", "M", "N"), got, want):
        assert not torch.isnan(a).any(), name  # every cell written once
        assert torch.equal(a.view(torch.int32), w.view(torch.int32)), name
    assert bool((got[0] > 0).any()) and bool((got[1] > 0).any())


def test_lane_layout_covers_each_position_once():
    """t = l*V + j over 32 lanes covers [0, T) once at every T <= 128,
    with V the least of 1, 2, 4 that reaches T."""
    for T in range(1, 129):
        V = lanes_v(T)
        t = [lane * V + j for lane in range(LANES) for j in range(V)]
        assert sorted(x for x in t if x < T) == list(range(T))
        assert V == 1 or LANES * (V // 2) < T
