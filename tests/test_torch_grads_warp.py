"""PyTorch port, the two-pass lattice route's warp walks as they run for T
<= 128 (csrc/lattice.cu): #1 lattice_forward_alphas (bidir_warp_kernel's
forward walk alone) and #5 lattice_backward_grads (grads_warp_kernel),
emulated here lane by lane over the flat (U*B*T,) lattice in float32 and
bfloat16 storage, must equal lattice_forward_alphas_reference /
lattice_backward_grads_reference bit for bit:

  - the loader stages rounds of 16 columns (#1 ascending from u = 0; #5
    descending, round r's k-th column U - 1 - 16 r - k) into a ring of 3
    input slots, each row 32 V values of the storage dtype (V = 1, 2, 4
    by T), the positions below T (a position not staged reads NaN), zeros
    for a column outside [0, U); a slot is refilled only once every
    reader has freed it;
  - ceil(T / 32) chain warps of one position a lane, t = 32 c + lane,
    walk the recursion (the row's values converted to float32 where read):
    #1 alpha_walk's cells, #5 log_beta_chain (lattice_bidir's beta walk,
    the reset at u == out_len - 1); the value at t - 1 / t + 1 comes from
    a shared row the chain warps write before a named barrier (the
    barrier exchange: every position reads a cell written in the same
    column), or with one chain warp from the next lane (a shuffle); NEG
    at the edges; each round's rows go into a ring of 2 result slots;
  - #1's storer writes each round's alphas of columns in [0, U), below T;
  - #5's ceil(T / 32) posterior warps (one position a lane, t = 32 q +
    lane; lane 31 also reads the next warp's first position th = 32 (q +
    1))
    read each column's betas from the result slot and le, ls, lf from the
    input slot, carry beta_{u+1} and lf_{u+1}, load alpha_u one round
    ahead, and store neg_g * exp(min(score, 30)) for the emit, shift and
    frame posteriors in the storage dtype; they lag the chain by a round
    and free both slots after a round.

Per cell the operations and their order are the block walks', so the
emulation and the plain versions agree exactly. Inputs are numpy-seeded;
lengths ragged, with il = ol = 1 and a degenerate example (ol < il)."""

import numpy as np
import pytest
import torch

from ssnt_tts_tpu_torch.ops import lattice_kernels as lk
from ssnt_tts_tpu_torch.ops.lattice import NEG, gather_logz, logaddexp

LANES, ROUND, N_IN, N_RES = 32, 16, 3, 2


def rows_v(T: int) -> int:
    """V: the positions a loader lane holds, ceil(T / 32) rounded up to 1,
    2, 4."""
    assert 1 <= T <= 128
    return 1 if T <= 32 else 2 if T <= 64 else 4


def chains(T: int) -> int:
    return -(-T // LANES)


class Ring:
    """Slots of a ring: each holds (round, value) until freed."""

    def __init__(self, n):
        self.slots = [None] * n

    def put(self, r, x):
        assert self.slots[r % len(self.slots)] is None  # freed by readers
        self.slots[r % len(self.slots)] = (r, x)

    def get(self, r):
        step, x = self.slots[r % len(self.slots)]
        assert step == r  # the round staged there, not an older one
        return x

    def free(self, r):
        assert self.slots[r % len(self.slots)][0] == r
        self.slots[r % len(self.slots)] = None


class Walk:
    """One example's walk: its columns, rings and exchange rows."""

    def __init__(self, fields, b, B, T, U, backward):
        self.fields, self.b, self.B, self.T, self.U = fields, b, B, T, U
        self.backward = backward
        self.V, self.nc = rows_v(T), chains(T)
        self.rounds = -(-U // ROUND)
        self.top = U - ROUND
        self.inputs, self.results = Ring(N_IN), Ring(N_RES)
        # the barrier exchange's two rows of 32 nc + 1 cells: (step, value)
        self.rows = [[None] * (self.nc * LANES + 1) for _ in range(2)]

    def column(self, r, k):
        if self.backward:
            return self.top - ROUND * r + ROUND - 1 - k
        return ROUND * r + k

    def in_walk(self, u):
        return 0 <= u < self.U

    def load(self, r):
        """Round r's (R, 3, 32 V) rows in the storage dtype: the positions
        below T, NaN elsewhere, zeros for a column outside [0, U)."""
        n = LANES * self.V
        dt = self.fields[0].dtype
        rows = torch.full((ROUND, 3, n), float("nan"), dtype=dt)
        for k in range(ROUND):
            u = self.column(r, k)
            o = (u * self.B + self.b) * self.T
            for i, x in enumerate(self.fields):
                rows[k, i, :self.T] = (x[o:o + self.T] if self.in_walk(u)
                                       else 0.0)
        self.inputs.put(r, rows)

    def chain_t(self):
        return torch.arange(self.nc * LANES)


def shift_edges(w, x, s, backward):
    """The neighbour of each chain position, as the chain warps get it:
    NEG at t = 0 (forward) and from t + 1 >= T (backward; the caller
    masks it too). With several chain warps, the barrier exchange: row s &
    1 gets each position's value at t + 1 (forward) or t (backward), then
    each reads t (forward) or t + 1, a cell written at step s. With one,
    the next lane's value by a shuffle."""
    n = w.nc * LANES
    if w.nc > 1:
        row = w.rows[s & 1]
        for t in range(n):
            row[t + (0 if backward else 1)] = (s, float(x[t]))

        def read(i):
            step, v = row[i]
            assert step == s  # written in this column, before the barrier
            return v

        if backward:
            return torch.tensor([read(t + 1) if t + 1 < w.T else NEG
                                 for t in range(n)])
        return torch.tensor([NEG] + [read(t) for t in range(1, n)])
    edge = torch.tensor([NEG])
    return torch.cat([x[1:], edge]) if backward else torch.cat([edge, x[:-1]])


def alpha_round(w, st, rows, r):
    """log_alpha_chain on every chain warp for round r: its alphas."""
    t = w.chain_t()
    x = rows[:, :, :w.nc * LANES].float()
    out = []
    for k in range(ROUND):
        e, s, f = x[k]
        mv = st["alpha"] + st["ls"]
        moved = shift_edges(w, mv, r * ROUND + k, False)
        a = f + logaddexp(st["alpha"] + st["le"], moved)
        if r == 0 and k == 0:
            a = torch.where(t == 0, f, NEG)
        st["alpha"], st["le"], st["ls"] = a, e, s
        out.append(a)
    return out


def beta_round(w, st, rows, r, in_len, out_len):
    """log_beta_chain on every chain warp for round r: its betas."""
    t = w.chain_t()
    x = rows[:, :, :w.nc * LANES].float()
    out = []
    for k in range(ROUND):
        e, s, f = x[k]
        cont = st["lf"] + st["beta"]
        up = shift_edges(w, cont, r * ROUND + k, True)
        up = torch.where(t + 1 >= w.T, NEG, up)
        beta = logaddexp(e + cont, s + up)
        if w.column(r, k) == out_len - 1:
            beta = torch.where(t == in_len - 1, e, NEG)
        st["beta"], st["lf"] = beta, f
        out.append(beta)
    return out


def result_rows(w, betas):
    """A result slot: the round's rows of 32 V floats (NaN past the chain
    warps' positions)."""
    res = torch.full((ROUND, LANES * w.V), float("nan"))
    res[:, :w.nc * LANES] = torch.stack(betas)
    return res


def posterior_round(w, st, r, al, lz, neg_g, in_len, out_len, d):
    """Every posterior warp for round r (slots read, then freed)."""
    rows, res = w.inputs.get(r), w.results.get(r)
    T, dt = w.T, w.fields[0].dtype
    for q in range(w.nc):
        t = q * LANES + torch.arange(LANES)
        th = (q + 1) * LANES
        halo = th < T
        ps = st[q]
        for k in range(ROUND):
            u = w.column(r, k)
            be = res[k][t]
            e, s, f = (rows[k, i][t].float() for i in range(3))
            hbu = float(res[k][th]) if halo else NEG
            hfu = float(rows[k, 2][th].float()) if halo else NEG
            cont = ps["lf"] + ps["beta"]
            shift = torch.cat([cont[1:], (ps["hf"] + ps["hb"]).reshape(1)])
            shift = torch.where(t + 1 >= T, NEG, shift)
            is_last_u = u == out_len - 1
            is_last_t = t == in_len - 1
            valid = (t < in_len) & (u < out_len)
            emit = (torch.where(is_last_t, 0.0, NEG) if is_last_u else cont)
            shift_c = torch.full_like(shift, NEG) if is_last_u else shift
            au = torch.zeros(t.shape)
            if w.in_walk(u):
                au = torch.where(t < T, al[u, w.b][t.clamp(max=T - 1)], 0.0)
            anorm = au - lz

            def post(score):
                return neg_g * torch.where(
                    valid, torch.exp(torch.clamp(score, max=30.0)), 0.0)

            vals = (post(anorm + e + emit), post(anorm + s + shift_c),
                    post(anorm + be))
            if w.in_walk(u):
                live = t < T
                idx = (u * w.B + w.b) * T + t[live]
                for i, v in enumerate(vals):
                    assert torch.isnan(d[i, idx].float()).all()  # once
                    d[i, idx] = v[live].to(dt)
            ps["beta"], ps["lf"] = be, f
            ps["hb"], ps["hf"] = torch.tensor(hbu), torch.tensor(hfu)
    w.inputs.free(r)
    w.results.free(r)


def emulate_grads_warp(le, ls, lf, alphas, il, ol, g, logz):
    """(d_le, d_ls, d_lf) in le's dtype from #5's warp walk; also the
    chain's betas (U, B, T) f32."""
    U, B, T = le.shape
    fields = [x.reshape(-1) for x in (le, ls, lf)]
    d = torch.full((3, U * B * T), float("nan"), dtype=le.dtype)
    betas = torch.full((U, B, T), float("nan"))
    for b in range(B):
        w = Walk(fields, b, B, T, U, True)
        in_len, out_len = int(il[b]), int(ol[b])
        lz = float(logz[b])
        neg_g = 0.0 if lz <= NEG / 2 else -float(g[b])
        neg = torch.full((w.nc * LANES,), NEG)
        chain = {"beta": neg, "lf": neg}
        post = [{"beta": torch.full((LANES,), NEG),
                 "lf": torch.full((LANES,), NEG),
                 "hb": torch.tensor(NEG), "hf": torch.tensor(NEG)}
                for _ in range(w.nc)]
        loaded = 0
        for r in range(w.rounds):
            # The loader: as far as the freed slots allow.
            while loaded < w.rounds and loaded < r + N_IN and (
                    w.inputs.slots[loaded % N_IN] is None):
                w.load(loaded)
                loaded += 1
            rows = w.inputs.get(r)  # the chain reads no round ahead
            out = beta_round(w, chain, rows, r, in_len, out_len)
            for k, x in enumerate(out):
                u = w.column(r, k)
                if w.in_walk(u):
                    betas[u, b] = x[:T]
            w.results.put(r, result_rows(w, out))
            if r >= N_RES - 1:  # the posterior warps a round behind
                posterior_round(w, post, r - N_RES + 1, alphas, lz, neg_g,
                                in_len, out_len, d)
        for r in range(max(w.rounds - N_RES + 1, 0), w.rounds):
            posterior_round(w, post, r, alphas, lz, neg_g, in_len, out_len,
                            d)
    return tuple(x.view(U, B, T) for x in d), betas


def emulate_alpha_warp(le, ls, lf):
    """Alphas (U, B, T) f32 from #1's warp walk."""
    U, B, T = le.shape
    fields = [x.reshape(-1) for x in (le, ls, lf)]
    alphas = torch.full((U * B * T,), float("nan"))
    for b in range(B):
        w = Walk(fields, b, B, T, U, False)
        neg = torch.full((w.nc * LANES,), NEG)
        st = {"alpha": neg, "le": neg, "ls": neg}
        for r in range(min(N_IN, w.rounds)):
            w.load(r)
        for r in range(w.rounds):
            rows = w.inputs.get(r)
            w.inputs.free(r)
            if r + N_IN < w.rounds:
                w.load(r + N_IN)
            out = alpha_round(w, st, rows, r)
            w.results.put(r, out)
            for k, x in enumerate(w.results.get(r)):  # the storer
                u = w.column(r, k)
                if w.in_walk(u):
                    o = (u * B + b) * T
                    alphas[o:o + T] = x[:T]
            w.results.free(r)
    return alphas.view(U, B, T)


def lattice_inputs(seed, U, T, dtype):
    """A (U, 5, T) lattice in dtype, ragged lengths (full, il = ol = 1,
    short, half, and example 4 degenerate: ol < il), upstream g."""
    rng = np.random.default_rng(seed)
    B = 5
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    ls = np.log1p(-np.exp(le)).astype(np.float32)
    lf = rng.normal(-2.0, 1.0, (U, B, T)).astype(np.float32)
    il = np.array([T, 1, max(1, T - 3), (T + 1) // 2, T], np.int32)
    ol = np.array([U, 1, max(1, U - 5), max(1, U // 2), max(1, min(U, T - 1))],
                  np.int32)
    if T == 1:  # no example can then be degenerate by ol < il
        ol[4] = U
    g = rng.uniform(0.5, 2.0, B).astype(np.float32)
    lat = [torch.tensor(x).to(dtype) for x in (le, ls, lf)]
    return lat, torch.tensor(il), torch.tensor(ol), torch.tensor(g)


def same_bits(a, b):
    view = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(view), b.view(view))


TS, US = (1, 31, 32, 33, 80, 128), (1, 15, 16, 17, 40)
DTYPES = (torch.float32, torch.bfloat16)
CASES = [(T, U, dt) for T in TS for U in US for dt in DTYPES]


def grads_case(T, U, dtype):
    torch.set_num_threads(1)
    (le, ls, lf), il, ol, g = lattice_inputs(T * 100 + U, U, T, dtype)
    alphas = lk.lattice_forward_alphas_reference(le, ls, lf)
    logz = gather_logz(alphas, le, il, ol)
    got, betas = emulate_grads_warp(le, ls, lf, alphas, il, ol, g, logz)
    want = lk.lattice_backward_grads_reference(le, ls, lf, alphas, il, ol,
                                               g, logz)
    return got, want, betas, (le, ls, lf, il, ol, logz)


@pytest.mark.parametrize("T,U,dtype", CASES)
def test_grads_warp_walk_equals_plain_version(T, U, dtype):
    """#5: chain and posterior warps of one position a lane, in f32 and
    bf16 storage; every cell written once; the degenerate
    example's gradients exactly 0."""
    got, want, _, (_, _, _, _, _, logz) = grads_case(T, U, dtype)
    for name, a, w in zip(("d_le", "d_ls", "d_lf"), got, want):
        assert a.dtype == dtype
        assert not torch.isnan(a.float()).any(), name
        assert same_bits(a, w), name
    if T > 1:
        assert float(logz[4]) <= NEG / 2
        assert not any(bool(x[:, 4].float().any()) for x in got)
    assert bool(got[2].float().abs().max() > 0)


def block_walk_betas(le, ls, lf, il, ol):
    """The beta recursion of backward_grads_kernel (and of its plain
    version): rec = lae(le_u + cont, ls_u + cont_shift_raw), reset at
    u == out_len - 1, on the upcast lattice."""
    U, B, T = le.shape
    le32, ls32, lf32 = le.float(), ls.float(), lf.float()
    t_idx = torch.arange(T)[None, :]
    is_last_t = t_idx == il.long()[:, None] - 1
    out_len = ol.long()[:, None]
    neg = torch.full((B, T), NEG)
    beta, lf_next = neg, neg
    betas = torch.empty((U, B, T))
    for u in range(U - 1, -1, -1):
        cont = lf_next + beta
        cont_shift_raw = torch.cat([cont[:, 1:], neg[:, :1]], dim=1)
        rec = logaddexp(le32[u] + cont, ls32[u] + cont_shift_raw)
        beta = torch.where(out_len - 1 == u,
                           torch.where(is_last_t, le32[u], neg), rec)
        betas[u] = beta
        lf_next = lf32[u]
    return betas


@pytest.mark.parametrize("T,U,dtype", [(80, 40, torch.float32),
                                       (80, 40, torch.bfloat16),
                                       (33, 17, torch.float32),
                                       (128, 16, torch.bfloat16),
                                       (1, 15, torch.float32),
                                       (31, 17, torch.bfloat16),
                                       (32, 40, torch.float32),
                                       (64, 16, torch.bfloat16),
                                       (65, 1, torch.float32),
                                       (96, 17, torch.bfloat16),
                                       (97, 33, torch.float32),
                                       (128, 40, torch.float32)])
def test_grads_beta_recursion_is_log_beta_chain(T, U, dtype):
    """#5's beta recursion (rec and the reset of backward_grads_kernel)
    and log_beta_chain's (x and its reset) give the same bits: the chain
    warps' betas equal the block walk's recursion and lattice_bidir's plain
    betas on the upcast lattice."""
    _, _, betas, (le, ls, lf, il, ol, _) = grads_case(T, U, dtype)
    want = block_walk_betas(le, ls, lf, il, ol)
    assert torch.equal(betas.view(torch.int32), want.view(torch.int32))
    bidir = lk.lattice_backward_betas_reference(le.float(), ls.float(),
                                                lf.float(), il, ol)
    assert torch.equal(betas.view(torch.int32), bidir.view(torch.int32))


@pytest.mark.parametrize("T,U,dtype", CASES)
def test_alpha_warp_walk_equals_plain_version(T, U, dtype):
    """#1: lattice_bidir's forward walk alone, rows in the storage dtype,
    alphas float32, every cell written once."""
    torch.set_num_threads(1)
    (le, ls, lf), _, _, _ = lattice_inputs(T * 100 + U + 1, U, T, dtype)
    got = emulate_alpha_warp(le, ls, lf)
    want = lk.lattice_forward_alphas_reference(le, ls, lf)
    assert not torch.isnan(got).any()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_lane_layouts_cover_each_position_once():
    """For every T <= 128: the chain and posterior warps' t = 32 c + lane
    cover [0, T) once, inside the rows' 32 V positions; each posterior
    warp's lane 31 reads the next warp's first position (or none past T);
    at most 4 chain warps, so at most 9 warps a block."""
    for T in range(1, 129):
        V, nc = rows_v(T), chains(T)
        assert nc <= 4 and nc * LANES <= LANES * V
        assert sorted(t for t in range(nc * LANES) if t < T) == list(
            range(T))
        for q in range(nc):
            th = (q + 1) * LANES
            assert th == q * LANES + LANES - 1 + 1
            assert (th < T) == (q + 1 < nc)
        assert 1 + 2 * nc <= 9
