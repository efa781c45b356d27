"""The bfloat16 wide instances of the fused decode steps, on the CPU.

Above 16 beams (or 256 class candidates) csrc/fused_class_step.cu and
csrc/fused_v1_step.cu run their bfloat16 steps as rounds of wgmma
m64nNk16 products, every beam of an utterance on the N side, over a
second weight stream packed once per decode by ops/beam_fused
(pack_wide_dense, pack_wide_gru, pack_wide_v1; `.packed_wide` beside
`.packed`). The kernels run only on the card; these tests pin what they
assume, from the layout note in csrc/wide_step.cuh:
  - the wide streams unpack to the original weights bit for bit, padding
    zero (smoke and tiny widths, float32 and bfloat16 storage), with as
    many tiles as the kernels' rounds take;
  - a plain emulation of the kernels' walk (each rank's rounds in stream
    order, the ring's pieces at 16 and 32 KB slots, each warpgroup's
    64-column A tiles and its B operand read through the descriptors'
    core-matrix strides from the activations' blocked layout, the
    products in input-tile order, N = the beams rounded up to 8) equals
    x @ W within 1e-6 in float32 at 17, 24, 32 and 128 beams;
  - the GRU cell folded round by round in the wide kernels' gate order
    equals stepmath.gru_step bit for bit in bfloat16.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.ops import beam_fused
from test_torch_fused_pack import WIDTHS, class_weights, rand, v1_weights

CL = beam_fused.CLUSTER
# The GRU's gate rounds (wide_step.cuh gru_gate): r, then n, then z, by
# index into [wi_r, wi_z, wi_n, wh_r, wh_z, wh_n].
GATES = (0, 3, 5, 2, 1, 4)
BEAMS = (17, 24, 32, 128)


def cdiv(a, b):
    return -(-a // b)


def share(N):
    """A rank's share of N outputs: its 16-column tiles."""
    return cdiv(cdiv(N, 16), CL) * 16


def mtiles(N):
    return cdiv(share(N), 64)


def core_at(rows, k, stride):
    """Offsets of (row, k) in a K-major no-swizzle operand: core matrices
    of 8 rows x 8 values, the k halves LBO = 64 values apart, the 8-row
    groups `stride` values apart (SBO)."""
    return (rows // 8) * stride + (k // 8) * 64 + (rows % 8) * 8 + k % 8


_AM, _AK = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
A_AT = core_at(_AM, _AK, 128)  # (64, 16): an A tile's SBO is 256 bytes


def act_buffer(x, N):
    """Activations x (beams, K) in the blocked layout wgmma reads as B
    (wide_step.cuh act_at), N beams and Kp = 16 ceil(K/16) inputs, zero
    past the beams and K: a flat (N * Kp) tensor."""
    nb, K = x.shape
    Kp = cdiv(K, 16) * 16
    n, k = np.meshgrid(np.arange(N), np.arange(Kp), indexing="ij")
    at = ((n // 8) * (Kp // 8) + k // 8) * 64 + (n % 8) * 8 + k % 8
    buf = torch.zeros(N * Kp, dtype=x.dtype)
    full = torch.zeros(N, Kp, dtype=x.dtype)
    full[:nb, :K] = x
    buf[torch.from_numpy(at.reshape(-1))] = full.reshape(-1)
    return buf


def b_operand(buf, kt, N, Kp):
    """Input tile kt of the activations as the B descriptor reads it:
    start 128 kt values in, LBO 64 values, SBO Kp * 8 values. (16, N)."""
    n, k = np.meshgrid(np.arange(N), np.arange(16), indexing="ij")
    return buf[torch.from_numpy(128 * kt + core_at(n, k, Kp * 8))].T


def rounds_of(kind, H, M, R):
    """The kernels' rounds (csrc/wide_step.cuh wide_dense / wide_gru,
    fused_v1_step.cu v1_wide_stream): (K, [(matrix, m-tile), ...]) with
    one m-tile a warpgroup; matrix "gru<g>" is gate g of [wi_r, wi_z,
    wi_n, wh_r, wh_z, wh_n]."""
    def pairs(K, tiles):
        return [(K, tiles[i:i + 2]) for i in range(0, len(tiles), 2)]

    def dense(name, K, N):
        return pairs(K, [(name, i) for i in range(mtiles(N))])

    ug = mtiles(H)
    gru = [(H, [(f"gru{g}", u) for u in range(p, min(p + 2, ug))])
           for p in range(0, ug, 2) for g in GATES]
    if kind == "class":
        return gru
    heads = ([("dec_pre_k", i) for i in range(mtiles(R))]
             + [("dec_mel_k", i) for i in range(mtiles(M))])
    return (dense("prenet_w1", M, H) + dense("prenet_w2", H, H) + gru
            + pairs(H, heads) + dense("dec_proj_k", R, 2 * R))


def matrices(fw, kind):
    """Each streamed matrix (K, N) by its name in rounds_of."""
    H = fw.wh.shape[0]
    out = {f"gru{g}": (fw.wi if g < 3 else fw.wh)[:, (g % 3) * H:
                                                   (g % 3 + 1) * H]
           for g in range(6)}
    if kind == "v1":
        out.update({k: getattr(fw, k) for k in beam_fused.V1_PACKED
                    if k != "gru"})
    return out


def prepared(kind, widths, dtype, seed):
    H, M, R, D, _ = WIDTHS[widths]
    rng = np.random.default_rng(seed)
    if kind == "class":
        return beam_fused.prepare_fused_weights(class_weights(rng, H, D),
                                                dtype), (H, M, R)
    return beam_fused.prepare_v1_fused_weights(v1_weights(rng, H, M, R),
                                               dtype), (H, M, R)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", list(WIDTHS))
@pytest.mark.parametrize("kind", ["class", "v1"])
def test_wide_pack_unpacks_bit_for_bit(kind, widths, dtype):
    fw, (H, M, R) = prepared(kind, widths, dtype, 1)
    packed = fw.packed_wide
    assert packed.dtype == dtype and packed.is_contiguous()
    mats = matrices(fw, kind)
    got = {k: torch.zeros(cdiv(w.shape[0], 16) * 16, CL * share(w.shape[1]),
                          dtype=dtype) for k, w in mats.items()}
    seen = {k: torch.zeros_like(g, dtype=torch.bool) for k, g in got.items()}
    idx = torch.from_numpy(A_AT)
    for r in range(CL):
        t = 0
        for K, tiles in rounds_of(kind, H, M, R):
            for kt in range(cdiv(K, 16)):
                for name, mt in tiles:
                    a = packed[r, t * 1024:(t + 1) * 1024][idx]  # (64 m, 16 k)
                    t += 1
                    UN = share(mats[name].shape[1])
                    c = 64 * mt + torch.arange(64)
                    mine = c < UN  # past the rank's share: zero
                    assert not a[~mine].any(), (name, mt)
                    cols = r * UN + c[mine]
                    rows = slice(16 * kt, 16 * kt + 16)
                    got[name][rows, cols] = a[mine].T
                    assert not seen[name][rows, cols].any()
                    seen[name][rows, cols] = True
        assert t * 1024 == packed.shape[1], "stream longer than its rounds"
    for name, w in mats.items():
        K, N = w.shape
        assert seen[name][:K, :N].all(), name
        assert not got[name][K:].any() and not got[name][:, N:].any(), name
        assert torch.equal(got[name][:K, :N], w), name


def emulate_walk(packed, kind, dims, xs, cap):
    """The kernels' rounds over one rank stream each, in float32: the
    ring's pieces (cap A tiles a slot: 8 at 16 KB, 16 at 32 KB), each
    warpgroup's tile of an input tile at (i nwg + wg) 1024 in its piece,
    B read through the descriptor from xs[name] (act_buffer), the
    products accumulated in input-tile order. Returns {matrix: (beams,
    columns)}, the columns n = r UN + c of every rank."""
    H, M, R = dims
    idx = torch.from_numpy(A_AT)
    out = {}
    for r in range(CL):
        t = 0
        for K, tiles in rounds_of(kind, H, M, R):
            KT, nw = cdiv(K, 16), len(tiles)
            kc = cap // nw
            accs = [None] * nw
            for k0 in range(0, KT, kc):
                n = min(kc, KT - k0)
                slot = packed[r, t * 1024:(t + n * nw) * 1024].float()
                t += n * nw
                for wg, (name, mt) in enumerate(tiles):
                    buf, N, Kp = xs[name]
                    for i in range(n):
                        a = slot[(i * nw + wg) * 1024:][:1024][idx]
                        p = a @ b_operand(buf, k0 + i, N, Kp).float()
                        accs[wg] = p if accs[wg] is None else accs[wg] + p
            for wg, (name, mt) in enumerate(tiles):
                out.setdefault(name, {})[(r, mt)] = accs[wg]
    cols = {}
    for name, blocks in out.items():
        cols[name] = torch.cat([blocks[(r, mt)].T for r in range(CL)
                                for mt in range(len(blocks) // CL)], 1)
    return cols


@pytest.mark.parametrize("cap", [8, 16])
@pytest.mark.parametrize("beams", BEAMS)
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_wide_walk_equals_matmul(widths, beams, cap):
    """Every matrix of the v1 wide stream (the class stream is its GRU
    rounds): the emulated walk equals x @ W within 1e-6 (absolute, plus
    1e-6 relative: float32 sums of up to 256 terms in other orders, sums
    of order 1), for the real beams and columns. Weights at std
    1/sqrt(fan-in) and activations in (-1, 1), as in the decode; a layout
    fault moves a value by O(1)."""
    rng = np.random.default_rng(3)
    fw, dims = prepared("v1", widths, torch.float32, 3)
    H, M, R = dims
    N = cdiv(beams, 8) * 8
    inputs = {"prenet_w1": M, "prenet_w2": H, "dec_pre_k": H,
              "dec_mel_k": H, "dec_proj_k": R}
    inputs.update({f"gru{g}": H for g in range(6)})
    x = {k: torch.tanh(rand(rng, beams, K, std=1.0))
         for k, K in inputs.items()}
    xs = {k: (act_buffer(v, N), N, cdiv(v.shape[1], 16) * 16)
          for k, v in x.items()}
    got = emulate_walk(fw.packed_wide, "v1", dims, xs, cap)
    mats = matrices(fw, "v1")
    for name, w in mats.items():
        UN = share(w.shape[1])
        c = torch.arange(got[name].shape[1])
        n = (c // (got[name].shape[1] // CL)) * UN + c % (got[name].shape[1]
                                                          // CL)
        real = (c % (got[name].shape[1] // CL) < UN) & (n < w.shape[1])
        want = x[name] @ w
        torch.testing.assert_close(got[name][:beams, real], want[:, n[real]],
                                   rtol=1e-6, atol=1e-6)


def gru_folded(wi, bi, wh, bhn, state, x):
    """The wide kernels' GRU (wide_step.cuh gru_fold) on float32 dots
    rounded to the compute dtype, gate round by gate round in GATES'
    order, each value held in the compute dtype between rounds (torch's
    sigmoid and tanh in float32, as stepmath's)."""
    dt = x.dtype
    H = state.shape[-1]
    rb = lambda v: v.to(dt).float()
    dot = lambda a, w, g: rb(torch.matmul(a.float(), w[:, g * H:(g + 1) * H]
                                          .float()))
    b = bi.float()
    hb = state.to(dt)
    held = {}
    for g in GATES:
        if g == 0:
            held["a"] = rb(dot(x, wi, 0) + b[:H])
        elif g == 3:
            held["a"] = rb(torch.sigmoid(rb(held["a"] + dot(hb, wh, 0))))
        elif g == 5:
            held["a"] = rb(held["a"] * rb(dot(hb, wh, 2) + bhn.float()))
        elif g == 2:
            held["a"] = rb(torch.tanh(rb(rb(dot(x, wi, 2) + b[2 * H:])
                                         + held["a"])))
        elif g == 1:
            held["b"] = rb(dot(x, wi, 1) + b[H:2 * H])
        else:
            z = rb(torch.sigmoid(rb(held["b"] + dot(hb, wh, 1))))
            return rb(rb(1 - z) * held["a"]) + z * state
    raise AssertionError("GATES ends with wh_z")


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_gru_fold_order_is_stepmath_bit_for_bit(widths):
    """The rounds change the order in which the gates are formed, not one
    rounding: the folded cell equals stepmath.gru_step bit for bit in
    bfloat16 at 17 beams (state in float32, as the decode carries it)."""
    H, _, _, D, _ = WIDTHS[widths]
    rng = np.random.default_rng(7)
    fw = beam_fused.prepare_fused_weights(class_weights(rng, H, D),
                                          torch.bfloat16)
    x = torch.tanh(rand(rng, 3, 17, H, std=1.0)).to(torch.bfloat16)
    state = torch.tanh(rand(rng, 3, 17, H, std=1.0))
    want = stepmath.gru_step(fw.wi, fw.bi, fw.wh, fw.bhn, state, x)
    got = gru_folded(fw.wi, fw.bi, fw.wh, fw.bhn, state, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("widths", list(WIDTHS))
def test_wide_stream_tile_counts(widths):
    """The streams' A tiles a rank, from the rounds (the kernels' pieces
    walk them; at smoke widths 192 for the class step and 270 for v1,
    384 KB and 540 KB of bfloat16)."""
    H, M, R, D, _ = WIDTHS[widths]
    for kind in ("class", "v1"):
        fw, dims = prepared(kind, widths, torch.bfloat16, 5)
        tiles = sum(cdiv(K, 16) * len(t) for K, t in rounds_of(kind, *dims))
        assert fw.packed_wide.shape == (CL, tiles * 1024)
        if widths == "smoke":
            assert tiles == {"class": 192, "v1": 270}[kind]
