"""The packed weight streams of the fused decode kernels, on the CPU.

csrc/fused_class_step.cu and csrc/fused_v1_step.cu read their matrices
from one stream per block of an utterance's cluster, packed once per
decode by ops/beam_fused (pack_dense, pack_gru, prepare_*_fused_weights)
into 16x16 tiles in mma.sync m16n8k16 fragment order. The kernels run only
on the card; these tests pin the layout they assume:
  - the packed streams unpack, by the layout written in csrc/gru_step.cuh,
    to the original weights bit for bit (smoke and tiny widths);
  - a plain emulation of the kernels' tile walk (per cluster rank, per
    16-column tile, input tiles in stream order, each lane's fragment
    product, the split-k partials added in order) equals x @ W within
    1e-6 in float32 at 1, 8 and 16 beams;
  - prepare_*_fused_weights raise on a wrong shape or dtype.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.ops import beam_fused

CL = beam_fused.CLUSTER  # blocks per utterance (csrc/gru_step.cuh kCL)
WARPS, SLOTS = 8, 6      # warps per block, m-tiles a warp holds (kMaxSlots)
# (H, M, R, D, K): the smoke widths (chip_smoke.py's model) and the tiny
# test widths (utils/config tiny config: decoder 32, mel 8, rank 8).
WIDTHS = {"smoke": (256, 80, 64, 10, 8), "tiny": (32, 8, 8, 5, 4)}


def cdiv(a, b):
    return -(-a // b)


def fragment_mk():
    """(m, k) of tile value p, from the layout note in gru_step.cuh: lane
    L = 4g + t holds values 8L .. 8L+7 at (g, 2t), (g, 2t+1), (g+8, 2t),
    (g+8, 2t+1), (g, 2t+8), (g, 2t+9), (g+8, 2t+8), (g+8, 2t+9)."""
    m, k = np.empty(256, int), np.empty(256, int)
    for lane in range(32):
        g, t = divmod(lane, 4)
        at = [(g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1),
              (g, 2 * t + 8), (g, 2 * t + 9), (g + 8, 2 * t + 8),
              (g + 8, 2 * t + 9)]
        for j, (mm, kk) in enumerate(at):
            m[8 * lane + j], k[8 * lane + j] = mm, kk
    return m, k


FM, FK = fragment_mk()


def layers_of(kind, H, M, R):
    """The kernels' streams: (name, K, N, gru) in stream order."""
    if kind == "class":
        return [("gru", H, H, True)]
    return [("prenet_w1", M, H, False), ("prenet_w2", H, H, False),
            ("gru", H, H, True), ("dec_pre_k", H, R, False),
            ("dec_mel_k", H, M, False), ("dec_proj_k", R, 2 * R, False)]


def tile_counts(K, N, gru):
    KT = cdiv(K, 16)
    MT = 6 * cdiv(cdiv(N, 16), CL) if gru else cdiv(cdiv(N, 16), CL)
    return KT, MT


def segments(packed, layers):
    """Split a (CL, S) stream into each layer's (CL, KT, MT, 256) tiles."""
    out, off = {}, 0
    for name, K, N, gru in layers:
        KT, MT = tile_counts(K, N, gru)
        n = KT * MT * 256
        out[name] = packed[:, off:off + n].reshape(CL, KT, MT, 256)
        off += n
    assert off == packed.shape[1], "stream longer than its layers"
    return out


def unpack_dense(seg, K, N):
    """(CL, KT, MT, 256) -> W (K, N): A[m][k] = W[16kt+k][16(r MT+mt)+m]."""
    _, KT, MT, _ = seg.shape
    w = torch.zeros(KT * 16, CL * MT * 16, dtype=seg.dtype)
    for r in range(CL):
        for kt in range(KT):
            for mt in range(MT):
                w[16 * kt + FK, 16 * (r * MT + mt) + FM] = seg[r, kt, mt]
    # Padding past K and N is zero.
    assert not w[K:].any() and not w[:, N:].any()
    return w[:K, :N]


def unpack_gru(seg, H):
    """(CL, KT, 6 HR, 256) -> (wi, wh), m-tiles [wi_r, wi_z, wi_n, wh_r,
    wh_z, wh_n] per hidden-unit tile of the rank."""
    _, KT, MT, _ = seg.shape
    HR = MT // 6
    g = torch.zeros(6, KT * 16, CL * HR * 16, dtype=seg.dtype)
    for r in range(CL):
        for kt in range(KT):
            for mt in range(MT):
                lh, gate = divmod(mt, 6)
                g[gate, 16 * kt + FK, 16 * (r * HR + lh) + FM] = seg[r, kt, mt]
    assert not g[:, H:].any() and not g[:, :, H:].any()
    g = g[:, :H, :H]
    return torch.cat(list(g[:3]), 1), torch.cat(list(g[3:]), 1)


def ksplit(MT):
    return 1 if MT >= WARPS else WARPS // MT


def emulate_layer(seg, xa, xb=None):
    """The kernels' dot_layer over a rank stream, in float32: for each
    rank, tiles in stream order (kt-major), each tile's m16n8k16 product
    of the lane fragments (A from the tile's fragment order, B the beams'
    activations), accumulated per (split, m-tile), the splits added in
    order. xa (beams, K) feeds every tile (the GRU's recurrent tiles read
    xb). Returns (CL, MT, 16, beams) column sums."""
    _, KT, MT, _ = seg.shape
    nb = xa.shape[0]
    pad = lambda x: torch.nn.functional.pad(x, (0, KT * 16 - x.shape[1]))
    xa = pad(xa)
    xb = xa if xb is None else pad(xb)
    S = ksplit(MT)
    out = torch.zeros(CL, MT, 16, nb)
    for r in range(CL):
        part = torch.zeros(S, MT, 16, nb)
        for kt in range(KT):
            for mt in range(MT):
                a = torch.zeros(16, 16)
                a[FM, FK] = seg[r, kt, mt].float()
                x = xb if (xb is not xa and mt % 6 >= 3) else xa
                b = x[:, 16 * kt:16 * kt + 16].float().T  # (16 k, beams)
                part[kt % S, mt] += a @ b
        acc = part[0]
        for ks in range(1, S):
            acc = acc + part[ks]
        out[r] = acc
    return out


def columns(out, N):
    """(CL, MT, 16, beams) -> (beams, N): column 16 (r MT + mt) + m."""
    CLn, MT, _, nb = out.shape
    return out.permute(3, 0, 1, 2).reshape(nb, CLn * MT * 16)[:, :N]


def rand(rng, *shape, std=0.3):
    return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))


def class_weights(rng, H, D, He=12, Hh=6):
    return stepmath.ClassStepWeights(
        rand(rng, D, H), rand(rng, He, H), rand(rng, H), rand(rng, H, 3 * H),
        rand(rng, 3 * H), rand(rng, H, 3 * H), rand(rng, H), rand(rng, H, D),
        rand(rng, D), rand(rng, He, Hh), rand(rng, Hh), rand(rng, Hh, D),
        rand(rng, D))


def v1_weights(rng, H, M, R, He=12):
    """Random v1 step weights, each kernel at a trained model's scale
    (std 1/sqrt(fan-in))."""
    shapes = beam_fused.v1_weight_shapes(H, M, R)
    shapes.update(enc_proj_k=(He, 2 * R), enc_proj_b=(2 * R,),
                  enc_bias_k=(He, 2), enc_bias_b=(2,), enc_mel_k=(He, M),
                  enc_mel_b=(M,))
    return stepmath.V1StepWeights(**{
        k: rand(rng, *shapes[k], std=shapes[k][0] ** -0.5)
        for k in stepmath.V1StepWeights._fields})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_class_pack_unpacks_bit_for_bit(widths, dtype):
    H, _, _, D, _ = WIDTHS[widths]
    fw = beam_fused.prepare_fused_weights(
        class_weights(np.random.default_rng(1), H, D), dtype)
    assert fw.packed.dtype == dtype and fw.packed.is_contiguous()
    seg = segments(fw.packed, layers_of("class", H, 0, 0))
    wi, wh = unpack_gru(seg["gru"], H)
    assert torch.equal(wi, fw.wi) and torch.equal(wh, fw.wh)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_v1_pack_unpacks_bit_for_bit(widths, dtype):
    H, M, R, _, _ = WIDTHS[widths]
    fw = beam_fused.prepare_v1_fused_weights(
        v1_weights(np.random.default_rng(2), H, M, R), dtype)
    assert fw.packed.dtype == dtype and fw.packed.is_contiguous()
    layers = layers_of("v1", H, M, R)
    seg = segments(fw.packed, layers)
    for name, K, N, gru in layers:
        if gru:
            wi, wh = unpack_gru(seg[name], H)
            assert torch.equal(wi, fw.wi) and torch.equal(wh, fw.wh)
        else:
            assert torch.equal(unpack_dense(seg[name], K, N),
                               getattr(fw, name)), name


@pytest.mark.parametrize("beams", [1, 8, 16])
@pytest.mark.parametrize("widths", list(WIDTHS))
def test_tile_walk_equals_matmul(widths, beams):
    """Every layer of the v1 stream (the class stream is its GRU layer):
    the emulated tile walk over the packed tiles equals x @ W within 1e-6
    (absolute, plus 1e-6 relative: two float32 sums of up to 256 terms in
    different orders, sums of order 1). Weights at std 1/sqrt(fan-in) and
    activations in (-1, 1), as in the decode. A layout fault moves a
    column by O(1)."""
    H, M, R, _, _ = WIDTHS[widths]
    rng = np.random.default_rng(3)
    fw = beam_fused.prepare_v1_fused_weights(v1_weights(rng, H, M, R),
                                             torch.float32)
    layers = layers_of("v1", H, M, R)
    seg = segments(fw.packed, layers)
    for name, K, N, gru in layers:
        x = torch.tanh(rand(rng, beams, K, std=1.0))
        if gru:
            h = torch.tanh(rand(rng, beams, H, std=1.0))
            got = emulate_layer(seg[name], x, h)  # (CL, 6 HR, 16, beams)
            HR = got.shape[1] // 6
            per_gate = got.reshape(CL, HR, 6, 16, beams)
            for gate in range(6):
                cols = columns(per_gate[:, :, gate], H)
                w = (fw.wi if gate < 3 else fw.wh)[:, (gate % 3) * H:
                                                   (gate % 3 + 1) * H]
                want = (x if gate < 3 else h) @ w
                torch.testing.assert_close(cols, want, rtol=1e-6, atol=1e-6)
        else:
            want = x @ getattr(fw, name)
            torch.testing.assert_close(columns(emulate_layer(seg[name], x), N),
                                       want, rtol=1e-6, atol=1e-6)


def test_split_k_covers_every_input_tile_once():
    """Each (m-tile, input tile) pair of a layer goes to exactly one warp
    (the kernels' ownership rule), at every m-tile count a layer of the
    smoke or tiny widths has."""
    for MT in (1, 2, 3, 4, 5, 6, 8, 12, 24, 48):
        S = ksplit(MT)
        for KT in (1, 4, 5, 16):
            owners = np.zeros((MT, KT), int)
            for warp in range(WARPS):
                for mt in range(MT):
                    for kt in range(KT):
                        if S > 1:
                            mine = (warp < MT * S and mt == warp % MT
                                    and kt % S == warp // MT)
                        else:
                            mine = mt % WARPS == warp and mt // WARPS < SLOTS
                        owners[mt, kt] += mine
            assert (owners == 1).all(), (MT, KT)


def test_prepare_fused_weights_raises_on_wrong_shape_or_dtype():
    H, D = 32, 5
    w = class_weights(np.random.default_rng(4), H, D)
    with pytest.raises(ValueError, match="compute dtype"):
        beam_fused.prepare_fused_weights(w, torch.float16)
    with pytest.raises(ValueError, match="wi"):
        beam_fused.prepare_fused_weights(w._replace(wi=w.wi[:, :2 * H]),
                                         torch.float32)
    with pytest.raises(ValueError, match="out_k"):
        beam_fused.prepare_fused_weights(w._replace(out_k=w.out_k[:, :3]),
                                         torch.bfloat16)


def test_prepare_v1_fused_weights_raises_on_wrong_shape_or_dtype():
    H, M, R = 32, 8, 8
    w = v1_weights(np.random.default_rng(5), H, M, R)
    with pytest.raises(ValueError, match="compute dtype"):
        beam_fused.prepare_v1_fused_weights(w, torch.int32)
    with pytest.raises(ValueError, match="dec_proj_k"):
        beam_fused.prepare_v1_fused_weights(
            w._replace(dec_proj_k=w.dec_proj_k[:, :R]), torch.float32)
    with pytest.raises(ValueError, match="dec_mel_b"):
        beam_fused.prepare_v1_fused_weights(
            w._replace(dec_mel_b=w.dec_mel_b[:3]), torch.bfloat16)


def test_prepared_weights_keep_the_plain_fields():
    """The stream rides beside the fields: iterating the prepared weights
    gives exactly the FusedWeights / V1FusedWeights fields (what the plain
    step reads), each equal to a plain cast."""
    H, M, R, D = 32, 8, 8, 5
    rng = np.random.default_rng(6)
    w = class_weights(rng, H, D)
    fw = beam_fused.prepare_fused_weights(w, torch.bfloat16)
    assert isinstance(fw, beam_fused.FusedWeights)
    assert len(tuple(fw)) == len(beam_fused.FusedWeights._fields)
    assert torch.equal(fw.wi, w.wi.to(torch.bfloat16))
    assert fw.out_k.dtype == torch.float32
    w1 = v1_weights(rng, H, M, R)
    f1 = beam_fused.prepare_v1_fused_weights(w1, torch.bfloat16)
    assert isinstance(f1, beam_fused.V1FusedWeights)
    assert len(tuple(f1)) == len(beam_fused.V1FusedWeights._fields)
    assert torch.equal(f1.prenet_w2, w1.prenet_w2.to(torch.bfloat16))
    assert f1.dec_bias_k.dtype == torch.float32
