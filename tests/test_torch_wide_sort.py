"""PyTorch port, the wide beam selection (csrc/beam_select.cuh wide_select)
emulated in numpy as the kernel stages it, held against the plain
selection (ops/beam_common.select_beams) and JAX's
(ssnt_tts_tpu/ops/beam_common.select_beams), bit for bit.

The kernel builds one 64-bit key a candidate (wide_key: lp mapped to a u32
that falls as lp rises, -0.0 first made +0.0, over the generation index;
invalid candidates and pads the largest key), sorts the keys of the
power of two at or above C with a bitonic network held P = 1, 2, 4 or 8
keys a thread over 256 threads (strides below P in registers, below 32 P
by warp shuffles, the rest through shared memory), then dedups, ranks the
survivors by ballots and per-warp counts, pads and re-injects the
diagonal candidate. Each of those steps is written out below in the
kernel's own terms (thread, lane, warp, key k of a thread), on
tie-heavy candidates: dyadic log-probs, +-0.0, -inf, scores at the port's
sentinel (kept valid, unlike JAX's bitonic pads), subnormals, invalid
slots, every candidate invalid, one survivor, fewer survivors than slots
and a diagonal candidate that sorts past the slots.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssnt_tts_tpu.ops import beam_common as jbeam_common
from ssnt_tts_tpu_torch.ops import beam_common, beam_v2, tone_latent
from test_torch_wide_beam import _tone_inputs, _v2_inputs

THREADS, WARP = 256, 32
PAD = np.uint64(0xFFFFFFFFFFFFFFFF)  # beam_select.cuh kNoKey
LOW = np.uint64(0xFFFFFFFF)
SENT = np.float32(-3.0e38 * 0.9)  # scores the port keeps valid
# Candidate counts (with the steps that give them) and output widths.
# 257 is prime: no step of two or more beams gives it, so only the drawn
# candidates take it.
C_CASES = {34: ("v2", 17, 2), 257: None, 320: ("v2", 32, 10),
           1024: ("tone", 128, 8), 1280: ("v2", 128, 10),
           2047: ("v2", 89, 23), 2048: ("v2", 128, 16)}
W_OUTS = (1, 17, 128)
V2_EQ = ("prediction", "log_prob", "next_t", "next_u", "is_finished",
         "total_duration")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def sort_len(C: int) -> int:
    """beam_select.cuh wide_sort_len: C rounded up to a power of two."""
    L = 1
    while L < C:
        L *= 2
    return L


def wide_keys(lp, valid):
    """beam_select.cuh wide_key over (..., C) candidates; PAD where
    invalid."""
    lp = np.asarray(lp, np.float32)
    lp = np.where(lp == 0.0, np.float32(0.0), lp).astype(np.float32)
    u = lp.view(np.uint32).astype(np.uint64)
    hi = np.where((u & np.uint64(0x80000000)) != 0, u,
                  ~u & np.uint64(0x7FFFFFFF))
    gen = np.arange(lp.shape[-1], dtype=np.uint64)
    return np.where(valid, (hi << np.uint64(32)) | gen, PAD)


def network(keys, stages=None):
    """beam_select.cuh wide_sort on L = len(keys) keys (a power of two):
    thread t holds indices t P + k in key[t, k]; every stage compares
    index i with i ^ j, ascending where i & K is 0 (from stride P up a
    thread's keys share their side: it keeps the smaller of each where
    `lo`). `stages` collects each stage's route."""
    L = len(keys)
    P = max(1, L // THREADS)
    key = np.full(THREADS * P, PAD)
    key[:L] = keys
    key = key.reshape(THREADS, P)
    t = np.arange(THREADS)[:, None]
    k = np.arange(P)[None, :]
    i0 = t * P
    live = np.broadcast_to(i0 < L, key.shape)  # threads of the exchange
    K = 2
    while K <= L:
        up = (i0 & K) == 0
        j = K // 2
        while j >= 1:
            if j < P:  # sort_in_thread: keys k and k | j of one thread
                route = "register"
                new = key.copy()
                for kk in range(P):
                    if kk & j:
                        continue
                    a, b = key[:, kk], key[:, kk | j]
                    swap = (b < a) == (((kk & K) == 0) if K < P else up[:, 0])
                    new[:, kk] = np.where(swap, b, a)
                    new[:, kk | j] = np.where(swap, a, b)
                key = new
            else:
                m = j // P
                pt = t[:, 0] ^ m
                if j < WARP * P:  # __shfl_xor_sync(key[k], m)
                    route = "shuffle"
                    assert ((pt // WARP) == (t[:, 0] // WARP)).all()
                    other = key[pt]
                else:  # buf[k kThreads + t], then the partner thread's
                    route = "shared"
                    buf = np.full(P * THREADS, PAD)
                    at = (k * THREADS + t)[live]
                    buf[at] = key[live]
                    other = buf[k * THREADS + pt[:, None]]
                lo = ((i0 & j) == 0) == up
                new = np.where((other < key) == lo, other, key)
                key = np.where(live, new, key) if route == "shared" else new
            if stages is not None:
                stages.append(route)
            j //= 2
        K *= 2
    return key.reshape(-1)[:L]


def emulate_select(lp, valid, eq, diag, W_out):
    """beam_select.cuh wide_select for one utterance: (src (W_out,),
    survivor count). eq: the dedup's fields besides lp, (C,) each; diag
    (C,) bool or None (no re-injection)."""
    C = len(lp)
    L = sort_len(C)
    keys = np.full(L, PAD)
    keys[:C] = wide_keys(lp, valid)
    s = network(keys)
    nvalid = int(np.asarray(valid).sum())
    assert (s[:nvalid] != PAD).all() and (s[nvalid:] == PAD).all()
    order = (s[:nvalid] & LOW).astype(np.int64)
    # Sorted position p = k kThreads + tid: row p // 32 = k warps + warp.
    P = -(-C // THREADS)
    keep = np.zeros(P * THREADS, bool)
    cand = np.zeros(P * THREADS, np.int64)
    cand[:nvalid] = order
    keep[:nvalid] = True
    if nvalid > 1:
        c, q = order[1:], order[:-1]
        same = lp[q] == lp[c]
        for f in eq:
            same &= f[q] == f[c]
        keep[1:nvalid] = ~same
    first_diag = None
    if diag is not None:
        hits = np.nonzero(keep & diag[cand])[0]
        first_diag = int(hits[0]) if len(hits) else None
    # Ballots of the rows (k, warp), their counts' inclusive scan `upto`;
    # a kept lane's rank is upto less the kept lanes at or above it.
    m = keep.reshape(P * THREADS // WARP, WARP)
    upto = np.cumsum(m.sum(1))
    n = int(upto[-1])
    surv = np.zeros(max(n, 1), np.int64)
    at_or_above = np.cumsum(m[:, ::-1], 1)[:, ::-1]
    rank = (upto[:, None] - at_or_above).reshape(-1)
    surv[rank[keep]] = cand[keep]
    src = np.zeros(W_out, np.int64)
    for j in range(W_out):
        if n > 0:
            src[j] = surv[j if j < n else (j - n) % n]
        if j == W_out - 1 and first_diag is not None:
            src[j] = order[first_diag]
    return src, n


def plain_select(fields, valid, W_out, eq_keys, diag):
    """The plain selection's slots (candidate indices) and survivors."""
    B, C = valid.shape
    f = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in fields.items()}
    f["gen"] = torch.arange(C).expand(B, C)
    out = beam_common.select_beams(
        f, torch.from_numpy(valid), f["log_prob"], W_out, eq_keys,
        diag_mask=None if diag is None else torch.from_numpy(diag))
    return out["gen"].numpy(), out["num_survivors"].numpy()


@functools.lru_cache(maxsize=None)
def _jax_select(W_out, eq_keys, with_diag):
    def one(fields, valid, diag):
        return jbeam_common.select_beams(
            fields, valid, fields["log_prob"], W_out, eq_keys,
            diag_mask=diag if with_diag else None)
    return jax.jit(jax.vmap(one))


def jax_select(fields, valid, W_out, eq_keys, diag):
    """JAX's selection's slots and survivors."""
    B, C = valid.shape
    f = {k: jnp.asarray(v) for k, v in fields.items()}
    f["gen"] = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32), (B, C))
    d = jnp.asarray(valid if diag is None else diag)
    out = _jax_select(W_out, tuple(eq_keys), diag is not None)(
        f, jnp.asarray(valid), d)
    return np.asarray(out["gen"]), np.asarray(out["num_survivors"])


def flushed(lp):
    """lp with subnormal scores made zeros of their sign: XLA on the CPU
    (as the TPU) compares subnormals as zeros, where the port, the CUDA
    kernel (built without -ftz) and the Rust reference compare them as
    IEEE numbers."""
    lp = np.asarray(lp, np.float32)
    sub = np.abs(lp) < np.finfo(np.float32).tiny
    return np.where(sub, np.copysign(np.float32(0.0), lp), lp)


def check_all(fields, valid, W_out, eq_keys, diag, what):
    """The emulated selection of every utterance against the plain and
    JAX selections: slots and survivor counts equal. JAX is held to the
    emulation of the scores it compares, subnormals flushed (`flushed`)."""
    plain_src, plain_n = plain_select(fields, valid, W_out, eq_keys, diag)
    jax_src, jax_n = jax_select(fields, valid, W_out, eq_keys, diag)
    eq = [fields[k] for k in eq_keys if k != "log_prob"]
    lp = fields["log_prob"]
    for b in range(valid.shape[0]):
        emu = lambda x: emulate_select(
            x, valid[b], [e[b] for e in eq],
            None if diag is None else diag[b], W_out)
        src, n = emu(lp[b])
        np.testing.assert_array_equal(src, plain_src[b],
                                      err_msg=f"{what} utt {b}: vs plain")
        assert n == plain_n[b], (what, b, n, plain_n[b])
        src, n = emu(flushed(lp[b]))
        np.testing.assert_array_equal(src, jax_src[b],
                                      err_msg=f"{what} utt {b}: vs JAX")
        assert n == jax_n[b], (what, b, n, jax_n[b])


def tie_heavy(x, rng):
    """Step inputs with ties made harder: some zero log-probs -0.0, some
    histories -inf, at the sentinel or subnormal."""
    h, lph = x["h"], x["lph"]
    h[(h == 0) & (rng.random(h.shape) < 0.5)] = -0.0
    r = rng.random(lph.shape)
    lph[r < 0.15] = -0.0
    lph[(r >= 0.15) & (r < 0.2)] = -np.inf
    lph[(r >= 0.2) & (r < 0.25)] = SENT
    lph[(r >= 0.25) & (r < 0.3)] = -1e-40
    return x


def step_candidates(C, W_out, seed, monkeypatch):
    """The candidates (fields, valid, eq_keys, diag) of one port step whose
    grid has C candidates (C_CASES), from test_torch_beam_steps' inputs
    made tie-heavy, captured at the port's select_beams."""
    kind, W, D = C_CASES[C]
    rng = np.random.default_rng(seed)
    seen = {}

    def capture(fields, valid, log_prob, max_beam_width, eq_keys,
                diag_mask=None):
        seen.update(fields={k: v.numpy().copy() for k, v in fields.items()},
                    valid=valid.numpy().copy(), eq_keys=tuple(eq_keys),
                    diag=None if diag_mask is None
                    else diag_mask.numpy().copy())
        return select(fields, valid, log_prob, max_beam_width, eq_keys,
                      diag_mask)

    select = beam_common.select_beams
    if kind == "v2":
        x = tie_heavy(_v2_inputs(seed, B=6, W=W, D=D), rng)
        dtab = rng.permutation(D).astype(np.int32)
        monkeypatch.setattr(beam_v2, "select_beams", capture)
        beam_v2.beam_search_step(
            *(torch.from_numpy(np.asarray(a)) for a in (
                x["h"], x["lph"], x["fin"], x["tot"], dtab, x["t"], x["u"],
                x["il"], x["ol"])),
            zero_duration_id=0, allow_skip=False, test_mode=False,
            max_beam_width=W_out)
    else:
        x = tie_heavy(_tone_inputs(seed, B=6, W=W, K=D), rng)
        monkeypatch.setattr(tone_latent, "select_beams", capture)
        tone_latent.beam_search_step(
            *(torch.from_numpy(np.asarray(a)) for a in (
                x["h"], x["lph"], x["fin"], x["t"], x["u"], x["il"])),
            empty_tone_id=1, max_beam_width=W_out)
    assert seen["valid"].shape[1] == C
    return seen


def synthetic_candidates(C, seed):
    """Six utterances of C candidates drawn from small sets (so that many
    are field-equal): every candidate invalid; one survivor; fewer
    survivors than any W_out above 1; the one diagonal candidate the
    lowest-scoring survivor; then two at random."""
    rng = np.random.default_rng(seed)
    B = 6
    vals = np.array([0.0, -0.0, -0.25, -0.5, -1.0, -np.inf, SENT, -1e-40,
                     -1e-45, -2.0], np.float32)
    lp = vals[rng.integers(0, len(vals), (B, C))]
    small = lambda n: rng.integers(0, n, (B, C)).astype(np.int32)
    fields = {"prediction": small(3), "log_prob": lp, "next_t": small(2),
              "next_u": small(2), "is_finished": small(2).astype(bool),
              "total_duration": small(2)}
    valid = rng.random((B, C)) < 0.75
    diag = rng.random((B, C)) < 1 / 7
    valid[0] = False
    valid[1] = False
    valid[1, C // 2] = True
    valid[2] = False
    valid[2, rng.choice(C, min(C, 3), replace=False)] = True
    on = np.nonzero(valid[3])[0]
    lp[3, on] = np.maximum(lp[3, on], np.float32(-2.0))
    last = on[len(on) // 2]
    lp[3, last] = -np.inf
    diag[3] = False
    diag[3, last] = True
    return {"fields": fields, "valid": valid, "eq_keys": V2_EQ,
            "diag": diag}


# ---------------------------------------------------------------- keys


@pytest.mark.parametrize("C", sorted(C_CASES))
def test_key_order_is_the_pairwise_rank_order(C):
    """Sorting wide_key's keys gives the plain selection's order (lp
    descending under IEEE compares, then generation), invalid last, on
    tie-heavy scores: the plain selection with a unique field in its
    dedup and W_out = C returns its sorted order in the first slots."""
    cand = synthetic_candidates(C, seed=C)
    lp, valid = cand["fields"]["log_prob"], cand["valid"]
    assert (lp == 0).any() and np.signbit(lp[lp == 0]).any()
    keys = wide_keys(lp, valid)
    for b in range(valid.shape[0]):
        f = {"log_prob": torch.from_numpy(lp[b:b + 1]),
             "gen": torch.arange(C, dtype=torch.int32)[None]}
        out = beam_common.select_beams(f, torch.from_numpy(valid[b:b + 1]),
                                       f["log_prob"], C, ("log_prob", "gen"))
        nv = int(valid[b].sum())
        order = np.argsort(keys[b], kind="stable")
        assert len(np.unique(keys[b][valid[b]])) == nv
        np.testing.assert_array_equal(order[:nv], out["gen"][0, :nv].numpy())
        assert (keys[b][order[nv:]] == PAD).all()


def test_key_mapping_orders_floats():
    """The key's high word falls strictly as the score rises, over every
    class of float32 the selection meets; -0.0 and +0.0 share a key."""
    xs = np.array([np.inf, 3.0e38, 1.0, 0.25, 1e-40, 1e-45, 0.0, -1e-45,
                   -1e-40, -0.25, -1.0, SENT, -3.4e38, -np.inf], np.float32)
    hi = wide_keys(xs, np.ones(len(xs), bool)) >> np.uint64(32)
    assert (np.diff(hi.astype(np.int64)) > 0).all()
    pair = wide_keys(np.array([0.0, -0.0], np.float32), np.ones(2, bool))
    assert pair[0] >> np.uint64(32) == pair[1] >> np.uint64(32)


# ------------------------------------------------------------- network


@pytest.mark.parametrize("L", [32, 64, 256, 512, 1024, 2048])
def test_network_equals_sort(L):
    """wide_sort as staged (register, shuffle and shared-memory strides)
    equals np.sort on distinct keys with pads; the routes' stage counts
    are the kernel's (at L = 2048, 66 stages: 6 through shared memory)."""
    rng = np.random.default_rng(L)
    for trial in range(3):
        keys = rng.choice(np.uint64(1) << np.uint64(40), L,
                          replace=False).astype(np.uint64)
        keys[rng.random(L) < 0.2 * trial] = PAD
        stages = []
        np.testing.assert_array_equal(network(keys, stages), np.sort(keys))
    lg = L.bit_length() - 1
    assert len(stages) == lg * (lg + 1) // 2
    P = max(1, L // THREADS)
    shared = sum(1 for K in range(1, lg + 1) for s in range(K)
                 if (1 << s) >= WARP * P)
    assert stages.count("shared") == shared
    assert stages.count("register") == sum(
        1 for K in range(1, lg + 1) for s in range(K) if (1 << s) < P)
    if L == 2048:
        assert (len(stages), shared) == (66, 6)


# ----------------------------------------------------- whole selection


@pytest.mark.parametrize("W_out", W_OUTS)
@pytest.mark.parametrize("C", sorted(c for c, s in C_CASES.items() if s))
def test_selection_of_steps_matches_plain_and_jax(C, W_out, monkeypatch):
    """The emulated selection on a port step's own candidates (v2 or tone
    inputs of test_torch_beam_steps, scores made tie-heavy; v2 with its
    diagonal flags) equals the plain and JAX selections: slots and
    survivor counts."""
    cand = step_candidates(C, W_out, seed=C + W_out, monkeypatch=monkeypatch)
    check_all(cand["fields"], cand["valid"], W_out, cand["eq_keys"],
              cand["diag"], f"step C={C} W_out={W_out}")


@pytest.mark.parametrize("W_out", W_OUTS)
@pytest.mark.parametrize("C", sorted(C_CASES))
def test_selection_of_tie_heavy_grids_matches_plain_and_jax(C, W_out):
    """The emulated selection on drawn candidates (many field-equal, every
    score class, all invalid, one survivor, n < W_out, a diagonal
    candidate past the slots) equals the plain and JAX selections."""
    cand = synthetic_candidates(C, seed=7 * C + W_out)
    check_all(cand["fields"], cand["valid"], W_out, cand["eq_keys"],
              cand["diag"], f"drawn C={C} W_out={W_out}")
    src, n = emulate_select(
        cand["fields"]["log_prob"][3], cand["valid"][3],
        [cand["fields"][k][3] for k in V2_EQ if k != "log_prob"],
        cand["diag"][3], W_out)
    # Utterance 3's diagonal candidate is its last survivor: it takes the
    # last slot wherever the survivors outnumber the slots.
    last = np.nonzero(cand["diag"][3])[0][0]
    assert src[-1] == last
    if n > W_out:
        assert last not in src[:-1]
