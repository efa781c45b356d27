"""PyTorch port, the bidirectional passes as their warp walks run them for
T <= 128 (csrc/lattice.cu bidir_warp_kernel, #8/#7 lattice_bidir, and
bidir_exp_warp_kernel, #4 lattice_bidir_exp), and #3 lattice_backward_betas
(bidir_warp_kernel launched for the backward walks alone): a block per
(example, direction) of loader, chain and storer warps, emulated here
lane by lane over the flat (U*B*T,) lattice, must equal
lattice_bidir_reference / lattice_bidir_exp_reference /
lattice_backward_betas_reference bit for bit:

  - the launch: a grid of (B, dirs) blocks, block (b, y) walking example
    b backward where y + dir0 == 1 (#8: dirs 2, dir0 0; #3: dirs 1, dir0
    1, so its betas are #8's walk's);

  - the chain: #4 on one warp whose lane l holds the V consecutive
    positions t = l*V + j (V = 1, 2, 4 by T); #8 on ceil(T / (32 V))
    warps, warp c's lane l holding t = 32 V c + l V + j (V = 1, 2 or 4);
  - rounds of R columns (#8 16, #4 4): forward r*R + k, backward top - r*R
    + R - 1 - k with top = U - R (the backward starts at u = U - 1); a
    column outside [0, U) is staged as zeros, walked, and never stored;
  - the loader stages round r into input slot r % n_in (#8 3, #4 6; at
    most n_in ahead of the chain, and only into a slot the chain has
    read), each lane its positions below T (a position not staged reads
    NaN); #4's loader replaces each staged value by its exp in place
    before the chain may read the round;
  - the chain: the neighbour exchange (forward, the value at t - 1, NEG
    (#8) or 0 (#4) into t = 0; backward, t + 1, NEG or 0 from t >= T):
    with one chain warp within the lane or from the next lane
    (__shfl_up_sync / __shfl_down_sync); with several (#8), the barrier
    exchange: every position writes its value into row s & 1 of two
    shared rows of 32 * 4 + 1 cells (forward at t + 1, backward at t),
    named barrier 1 over the chain warps, then each reads its neighbour's
    cell (forward t, backward t + 1), written in the same column step s;
    the reset at u == out_len - 1 and,
    for #4, every column's row max (the lane's max over its positions
    below T, 0 for a lane past T, then the warp's) floored at 1e-30 and
    the division by it (the double product with the normalizer's double
    reciprocal, rounded to float: the bits of the float division); each
    round's rows (and #4's normalizers) into result slot r % n_res (#8 2,
    #4 4; only one the storer has read);
  - the storer: the rows of the round's columns in [0, U), below T; #4's
    log(raw) plus the running log normalizer (the backward's reset to 0
    at u == out_len - 1), then log(norm) added. It trails the chain by up
    to n_res - 1 rounds.

Per cell the operations and their order are the block walks', so the
emulation and the plain versions agree exactly. Inputs are numpy-seeded;
lengths are ragged, with il = ol = 1, and (#4) an example whose emit
probability is 0 everywhere (le = -inf)."""

import numpy as np
import pytest
import torch

from ssnt_tts_tpu_torch.ops import lattice_kernels as lk
from ssnt_tts_tpu_torch.ops.lattice import NEG, logaddexp

LANES, TINY = 32, 1e-30
# Columns a round, and the input and result rings in rounds: #8's (log)
# and #4's (exp).
RINGS = {False: (16, 3, 2), True: (4, 6, 4)}
ROW = LANES * 4 + 1  # cells of a barrier-exchange row (kMaxChains = 4)


def lanes_v(T: int) -> int:
    """V, the positions a lane of the rows (and of #4's chain) holds:
    ceil(T / 32) rounded up to 1, 2, 4."""
    assert 1 <= T <= 128
    return 1 if T <= 32 else 2 if T <= 64 else 4


def log_layouts(T: int) -> list:
    """The chain lanes' positions VC #8's launcher may take at T (kLogVC,
    at most the rows' V): on ceil(T / (32 VC)) chain warps."""
    return [v for v in (1, 2, 4) if v <= lanes_v(T)]


class Walk:
    """One walk's columns, its two rings and (#8) its chain warps' exchange
    rows.
    column(r, k) is round r's k-th column in walk order; a ring slot holds
    a round or None once read. Chain warp c's lane l holds t = 32 V c + l V
    + j, lane rows 32 c .. 32 c + 31 of t."""

    def __init__(self, fields, b, B, T, U, V, backward, exp_domain, nc=1):
        self.fields, self.b, self.B, self.T, self.U = fields, b, B, T, U
        self.backward, self.exp_domain, self.nc = backward, exp_domain, nc
        self.round, self.n_in, self.n_res = RINGS[exp_domain]
        self.top = U - self.round
        self.rounds = -(-U // self.round)
        self.t = torch.arange(nc * LANES * V).view(nc * LANES, V)
        self.live = self.t < T
        assert nc * LANES * V < ROW
        # the barrier exchange's two rows: each cell's value and the column
        # step that wrote it (never written: NaN, -1)
        self.row = torch.full((2, ROW), float("nan"))
        self.row_step = torch.full((2, ROW), -1, dtype=torch.long)
        self.inputs = [None] * self.n_in
        self.results = [None] * self.n_res

    def column(self, r, k):
        if self.backward:
            return self.top - self.round * r + self.round - 1 - k
        return self.round * r + k

    def in_walk(self, u):
        return 0 <= u < self.U

    def load(self, r):
        """The loader: round r's le, ls, lf at the positions below T (NaN
        where nothing is staged), zeros for a column outside [0, U); #4's
        exp'd in place."""
        assert self.inputs[r % self.n_in] is None  # the chain has read it
        tt = self.t.clamp(max=self.T - 1)
        nan = torch.full(self.t.shape, float("nan"))
        cols = []
        for k in range(self.round):
            u = self.column(r, k)
            o = ((u if self.in_walk(u) else self.U - 1) * self.B
                 + self.b) * self.T
            rows = [torch.where(self.live, x[o + tt] if self.in_walk(u)
                                else 0.0, nan) for x in self.fields]
            if self.exp_domain:
                rows = [torch.where(self.live, torch.exp(x), nan)
                        for x in rows]
            cols.append(rows)
        self.inputs[r % self.n_in] = cols

    def take(self, r):
        cols = self.inputs[r % self.n_in]
        assert cols is not None  # the loader has staged it
        self.inputs[r % self.n_in] = None
        return cols

    def give(self, r, rows, norms):
        assert self.results[r % self.n_res] is None  # the storer has read it
        self.results[r % self.n_res] = (rows, norms)


def shift_in_down(x, V, edge):
    """Each position's value at t - 1 within one warp's (32, V) x: within
    the lane, or the lane below's last (__shfl_up_sync), `edge` into lane
    0."""
    edge = torch.as_tensor(edge, dtype=torch.float32).reshape(1)
    below = torch.cat([edge, x[:-1, V - 1]])
    return torch.cat([below[:, None], x[:, :-1]], dim=1)


def shift_in_up(t, T, x, V, edge, past_t):
    """Each position's value at t + 1 within one warp's (32, V) x: within
    the lane, or the lane above's first (__shfl_down_sync), `edge` into
    lane 31; `past_t` from t + 1 >= T."""
    edge = torch.as_tensor(edge, dtype=torch.float32).reshape(1)
    above = torch.cat([x[1:, 0], edge])
    nb = torch.cat([x[:, 1:], above[:, None]], dim=1)
    return torch.where(t + 1 >= T, past_t, nb)


def warp_max(x, live):
    """warp_max: each lane's max over its live values (0 for a lane past
    T), then the warp's max, floored at TINY."""
    m = torch.where(live[:, 0], x[:, 0], 0.0)
    for j in range(1, x.shape[1]):
        m = torch.where(live[:, j], torch.maximum(m, x[:, j]), m)
    return torch.clamp(m.max(), min=TINY)


def div_rn(x, norm):
    """div_rn: x / norm through the double reciprocal, rounded to float."""
    return (x.double() * (1.0 / norm.double())).float()


def neighbours(w, x, step, backward, V):
    """The log walks' neighbour of each chain position in column step
    `step`: the value at t - 1 (forward; NEG into t = 0) or at t + 1
    (backward; NEG from t + 1 >= T). One chain warp: a shuffle. Several:
    the barrier exchange, each position's value written into row step & 1
    (forward at t + 1, backward at t), then every neighbour's cell read,
    which this column step must have written."""
    if w.nc == 1:
        if backward:
            return shift_in_up(w.t, w.T, x, V, NEG, NEG)
        return shift_in_down(x, V, NEG)
    flat, t = x.reshape(-1), w.t.reshape(-1)
    n, off = flat.numel(), 0 if backward else 1
    row, tag = w.row[step & 1], w.row_step[step & 1]
    row[off:off + n] = flat
    tag[off:off + n] = step
    idx = t + 1 if backward else t  # the neighbour's cell
    used = t + 1 < w.T if backward else t > 0
    assert bool((tag[idx][used] == step).all())  # written this column
    got = torch.where(used, row[idx], NEG)
    return got.view_as(x)


def log_alpha_round(w, st, cols, r, V):
    """log_alpha_chain for one round on every chain warp: the alphas of
    its columns."""
    out = []
    for k, (e, s, f) in enumerate(cols):
        mv = st["alpha"] + st["ls"]
        moved = neighbours(w, mv, r * w.round + k, False, V)
        x = f + logaddexp(st["alpha"] + st["le"], moved)
        if r == 0 and k == 0:
            x = torch.where(w.t == 0, f, NEG)
        st["alpha"], st["le"], st["ls"] = x, e, s
        out.append(x)
    return out, None


def log_beta_round(w, st, cols, r, in_len, out_len, V):
    """log_beta_chain for one round on every chain warp: the betas of its
    columns."""
    out = []
    for k, (e, s, f) in enumerate(cols):
        cont = st["lf"] + st["beta"]
        up = neighbours(w, cont, r * w.round + k, True, V)
        x = logaddexp(e + cont, s + up)
        if w.column(r, k) == out_len - 1:
            x = torch.where(w.t == in_len - 1, e, NEG)
        st["beta"], st["lf"] = x, f
        out.append(x)
    return out, None


def exp_alpha_round(w, st, cols, r, V):
    """exp_alpha_chain for one round: p_raw and the normalizer of each
    column."""
    out, norms = [], []
    for k, (e, s, f) in enumerate(cols):
        sp = st["p"] * st["ls"]
        q = st["p"] * st["le"] + shift_in_down(sp, V, 0.0)
        if r == 0 and k == 0:
            q = (w.t == 0).float()
        x = q * f
        norm = warp_max(x, w.live)
        st["p"], st["le"], st["ls"] = div_rn(x, norm), e, s
        out.append(x)
        norms.append(norm)
    return out, norms


def exp_beta_round(w, st, cols, r, in_len, out_len, V):
    """exp_beta_chain for one round: b_raw and the normalizer of each
    column."""
    out, norms = [], []
    for k, (e, s, f) in enumerate(cols):
        c = st["field"] * st["lf"]
        x = e * c + s * shift_in_up(w.t, w.T, c, V, 0.0, 0.0)
        if w.column(r, k) == out_len - 1:
            x = torch.where(w.t == in_len - 1, e, 0.0)
        norm = warp_max(x, w.live)
        st["field"], st["lf"] = div_rn(x, norm), f
        out.append(x)
        norms.append(norm)
    return out, norms


def store_round(w, r, out, acc, out_len):
    """The storer for one round; returns #4's running log normalizer."""
    rows, norms = w.results[r % w.n_res]
    w.results[r % w.n_res] = None
    for k in range(w.round):
        u = w.column(r, k)
        if not w.in_walk(u):
            continue
        y = rows[k]
        if w.exp_domain:
            if w.backward and u == out_len - 1:
                acc = torch.zeros(())
            y = torch.log(y) + acc
            acc = acc + torch.log(norms[k])
        out[((u * w.B + w.b) * w.T + w.t)[w.live]] = y[w.live]
    return acc


def run_walk(w, out, in_len, out_len, V):
    """The three warps in an order their rings allow: the loader 6 rounds
    ahead of the chain, the storer 3 behind it."""
    if w.exp_domain:
        z = torch.zeros(LANES, V)
        st = ({"field": z, "lf": z} if w.backward
              else {"p": z, "le": z, "ls": z})
    else:
        neg = torch.full((w.nc * LANES, V), NEG)
        st = ({"beta": neg, "lf": neg} if w.backward
              else {"alpha": neg, "le": neg, "ls": neg})
    chain = {(False, False): log_alpha_round, (False, True): log_beta_round,
             (True, False): exp_alpha_round, (True, True): exp_beta_round}[
        (w.exp_domain, w.backward)]
    acc = torch.zeros(())
    for r in range(min(w.n_in, w.rounds)):
        w.load(r)
    for r in range(w.rounds):
        cols = w.take(r)
        if r + w.n_in < w.rounds:
            w.load(r + w.n_in)
        if w.backward:
            res = chain(w, st, cols, r, in_len, out_len, V)
        else:
            res = chain(w, st, cols, r, V)
        if r >= w.n_res - 1:
            acc = store_round(w, r - w.n_res + 1, out, acc, out_len)
        w.give(r, *res)
    for r in range(max(w.rounds - w.n_res + 1, 0), w.rounds):
        acc = store_round(w, r, out, acc, out_len)


def emulate_bidir_warp(le, ls, lf, il, ol, V, exp_domain, dir0=0,
                       dirs=2):
    """(alphas, betas) from the warp walks over flat buffers (NaN where a
    launch writes nothing): #4 on one chain warp, the log walks on ceil(T
    / (32 V)) chain warps in a grid of (B, dirs) blocks, block (b, y)
    backward where y + dir0 == 1 (#8: dir0 0, dirs 2; #3: dir0 1, dirs
    1)."""
    U, B, T = le.shape
    nc = 1 if exp_domain else -(-T // (LANES * V))
    fields = [x.reshape(-1) for x in (le, ls, lf)]
    alphas, betas = (torch.full((U * B * T,), float("nan"))
                     for _ in range(2))
    for b in range(B):
        for y in range(dirs):
            back = y + dir0 == 1
            w = Walk(fields, b, B, T, U, V, back, exp_domain, nc)
            if back:
                run_walk(w, betas, int(il[b]), int(ol[b]), V)
            else:
                run_walk(w, alphas, 0, 0, V)
    return alphas.view(U, B, T), betas.view(U, B, T)


def lattice_inputs(seed, U, T, exp_domain):
    """A (U, 5, T) log-domain lattice and ragged lengths: full, il = ol =
    1, short, half, and example 4 degenerate (ol < il: no path; for #4 its
    emit probability is 0 everywhere, le = -inf, ls = 0)."""
    rng = np.random.default_rng(seed)
    B = 5
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(-2.0, 1.0, (U, B, T)).astype(np.float32)
    il = np.array([T, 1, max(1, T - 3), (T + 1) // 2, T], np.int32)
    ol = np.array([U, 1, max(1, U - 5), max(1, U // 2), max(1, U - 2)],
                  np.int32)
    if exp_domain:
        le[:, 4], ls[:, 4] = -np.inf, 0.0
    else:
        ol[4] = max(1, min(U, T - 1))
    return [torch.tensor(x) for x in (le, ls, lf, il, ol)]


TS, US = (1, 31, 33, 64, 80, 97, 128), (3, 37, 42)
EXP_CASES = [(T, U, lanes_v(T)) for T in TS for U in US]
LOG_CASES = [(T, U, V) for T in TS for U in US for V in log_layouts(T)]


def check_walk(T, U, V, exp_domain, reference):
    torch.set_num_threads(1)
    le, ls, lf, il, ol = lattice_inputs(T * 100 + U + 7 * V, U, T,
                                        exp_domain)
    got = emulate_bidir_warp(le, ls, lf, il, ol, V, exp_domain)
    want = reference(le, ls, lf, il, ol)
    for name, a, w in zip(("alphas", "betas"), got, want):
        assert not torch.isnan(a).any(), name  # every cell written once
        assert torch.equal(a.view(torch.int32), w.view(torch.int32)), name
    return got


@pytest.mark.parametrize("T,U,V", LOG_CASES)
def test_log_warp_walk_equals_plain_version(T, U, V):
    """#8: the log-domain walk on ceil(T / (32 V)) chain warps, NEG at the
    edges, the chain warps' neighbours through the barrier exchange."""
    alphas, betas = check_walk(T, U, V, False, lk.lattice_bidir_reference)
    assert bool((alphas > NEG / 2).any()) and bool((betas > NEG / 2).any())


@pytest.mark.parametrize("T,U,V", EXP_CASES)
def test_exp_warp_walk_equals_plain_version(T, U, V):
    """#4: the exp-domain walk, 0 at the shuffles' edges, a row max and a
    division every column, -inf for a cell of probability 0."""
    alphas, betas = check_walk(T, U, V, True, lk.lattice_bidir_exp_reference)
    assert bool(torch.isfinite(alphas).any())
    assert bool(torch.isneginf(alphas[:, 4]).any())


BETAS_TS = (1, 31, 32, 33, 64, 80, 100, 128)
BETAS_CASES = [(T, U) for T in BETAS_TS for U in (3, 37, 42)]


@pytest.mark.parametrize("T,U", BETAS_CASES)
def test_betas_warp_walk_equals_plain_version(T, U):
    """#3: bidir_warp_kernel launched for the backward walks alone (one
    direction a block, dir0 = 1) on ceil(T / 32) chain warps of one
    position a lane (kLogVC), with ragged lengths and a degenerate
    example: every beta written once, no alpha written, bit for bit the
    plain version and #8's betas."""
    torch.set_num_threads(1)
    le, ls, lf, il, ol = lattice_inputs(T * 100 + U + 3, U, T, False)
    alphas, betas = emulate_bidir_warp(le, ls, lf, il, ol, 1, False,
                                       dir0=1, dirs=1)
    assert bool(torch.isnan(alphas).all())
    assert not torch.isnan(betas).any()
    want = lk.lattice_backward_betas_reference(le, ls, lf, il, ol)
    assert torch.equal(betas.view(torch.int32), want.view(torch.int32))
    _, bidir = emulate_bidir_warp(le, ls, lf, il, ol, 1, False)
    assert torch.equal(betas.view(torch.int32), bidir.view(torch.int32))
    assert bool((betas > NEG / 2).any())
    if T > 1:  # example 4 has no path (ol < il): beta_0 at t = 0 is NEG
        assert int(ol[4]) < int(il[4]) and float(betas[0, 4, 0]) <= NEG / 2


def test_double_reciprocal_division_is_correctly_rounded():
    """div_rn equals the float division bit for bit on the exp walks'
    domain: dividends +0 or positive down to the smallest subnormal,
    normalizers from 1e-30 up, quotients normal and subnormal."""
    rng = np.random.default_rng(0)
    n = 1 << 20
    bits = rng.integers(0, 0x7F800000, n, dtype=np.int64).astype(np.int32)
    x = torch.tensor(bits).view(torch.float32)  # every finite float >= 0
    s = torch.tensor(np.exp(rng.uniform(np.log(1e-30), np.log(1e3), n))
                     .astype(np.float32))
    s[: n // 4] = torch.maximum(x[: n // 4], torch.tensor(TINY))  # x <= s
    want = x / s
    assert bool((want < 2.0 ** -126).any()) and bool((x < 2.0 ** -126).any())
    got = div_rn(x, s)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_lane_layouts_cover_each_position_once():
    """t = 32 V c + l V + j over ceil(T / (32 V)) warps of 32 lanes covers
    [0, T) once for every layout a launcher may pick at T <= 128, and the
    rows' V is the least of 1, 2, 4 that reaches T."""
    for T in range(1, 129):
        for V in log_layouts(T):
            nc = -(-T // (LANES * V))
            assert nc <= 4
            t = [LANES * V * c + lane * V + j for c in range(nc)
                 for lane in range(LANES) for j in range(V)]
            assert sorted(x for x in t if x < T) == list(range(T))
        V = lanes_v(T)
        assert V == 1 or LANES * (V // 2) < T
