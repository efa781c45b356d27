"""The plain reference of the SSNT-TTS architecture ("ssnt", the default
of a configuration that names none), in PyTorch: its parameters, its
encoder and its v1 and v2 decode steps, as perfbench/arch.py asks of an
architecture.

It imports nothing of the program. Its parameters are a dict of float32
tensors by name (`param_shapes`), the weights the benchmark makes from
the seed and hands to both sides; everything the program derives from
them (fused and packed weights, the hoisted encoder-side paths of the
class step, the v1 step's encoder pack) is worked out here again. The
rounding to the compute dtype is perfbench/reference/numerics.py's.

Parameters. Kernels and embeddings are normal with standard deviation
fan_in ** -0.5 (LeCun normal), biases and log_sigma zero, LayerNorm
scales one. Dense kernels are (out, in), convolutions (out, in, width),
the GRU's packed [r|z|n] kernels (in, 3H).

One bias is set: the transition joint's encoder bias, EMIT_BIAS for emit
and -EMIT_BIAS for shift. Random weights put the emit/shift preference
where chance puts it: under some seeds the best v1 beam shifts at every
frame and finishes after about one frame a token, under others it runs
to the frame limit, so the audio of a batch would swing with the seed.
With the bias every seed emits first (the v1 decode's frames per batch
stay B x max_frames); the v2 decode does not read the transition joint.

For the v2 traffic, the duration AR head's output bias is DURATION_BIAS
on the class that lasts the traffic's frames a token, zero elsewhere.
Random weights put the duration preference where chance puts it, the
same at every source position: a beam that keeps a class shorter or
longer than the target's rate drifts to the edge of the band and cannot
land on the target at the last position, so each seed emptied its own
share of utterances (0-100 % at B=16, eight seeds on the CPU). With the
bias every utterance of sixteen seeds lands at B=64, W=8 (a bias of 5
emptied 2 % of one seed's), and the class log-probs keep some entropy:
-0.01 to -0.33 nats a step on the best path.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.numerics import (Num, dense32, layer_norm,
                                          log_softmax)

# name -> (shape, init): init is a fan-in for a normal draw, "zeros",
# "ones", or a list of the values.
Spec = Dict[str, Tuple[Tuple[int, ...], object]]
EMIT_BIAS = 4.0
DURATION_BIAS = 6.0


def param_shapes(cfg: dict, frames_per_token: Optional[int] = None) -> Spec:
    He, H, M, R = (cfg["encoder_dim"], cfg["decoder_dim"], cfg["mel_dim"],
                   cfg["joint_rank"])
    spec: Spec = {}

    def dense(name, i, o):
        spec[name + ".weight"] = ((o, i), i)
        spec[name + ".bias"] = ((o,), "zeros")

    def norm(name, d):
        spec[name + ".weight"] = ((d,), "ones")
        spec[name + ".bias"] = ((d,), "zeros")

    def gru(name, i, h):
        spec[name + ".wi"] = ((i, 3 * h), i)
        spec[name + ".bi"] = ((3 * h,), "zeros")
        spec[name + ".wh"] = ((h, 3 * h), h)
        spec[name + ".bhn"] = ((h,), "zeros")

    spec["encoder.embed"] = ((cfg["vocab_size"], He), He)
    for i in range(3):
        spec[f"encoder.prenet.convs.{i}.weight"] = ((He, He, 5), 5 * He)
        spec[f"encoder.prenet.convs.{i}.bias"] = ((He,), "zeros")
    for i in range(3):
        norm(f"encoder.prenet.norms.{i}", He)
    for i in range(cfg["encoder_layers"]):
        pre = f"encoder.blocks.{i}."
        norm(pre + "norm1", He)
        for n in ("query", "key", "value", "out"):
            dense(pre + "attn." + n, He, He)
        norm(pre + "norm2", He)
        dense(pre + "ff.fc1", He, 4 * He)
        dense(pre + "ff.fc2", 4 * He, He)
    norm("encoder.norm", He)
    dense("ar_cell.prenet.fc1", M, H)
    dense("ar_cell.prenet.fc2", H, H)
    gru("ar_cell.cell", H, H)
    dense("transition.enc_proj", He, 2 * R)
    dense("transition.dec_pre", H, R)
    dense("transition.dec_proj", R, 2 * R)
    dense("transition.enc_bias", He, 2)
    spec["transition.enc_bias.bias"] = ((2,), [EMIT_BIAS, -EMIT_BIAS])
    dense("transition.dec_bias", H, 2)
    spec["frame.log_sigma"] = ((), "zeros")
    dense("frame.enc_mel", He, M)
    dense("frame.dec_mel", H, M)
    for kind, D in (("duration", cfg["duration_class_size"]),
                    ("tone", cfg["tone_class_size"])):
        dense(f"{kind}_head.h1", He, He)
        dense(f"{kind}_head.out", He, D)
        spec[f"{kind}_ar.embed"] = ((D, H), H)
        dense(f"{kind}_ar.enc_in", He, H)
        gru(f"{kind}_ar.cell", H, H)
        dense(f"{kind}_ar.out", H, D)
    if frames_per_token is not None:
        bias = [0.0] * cfg["duration_class_size"]
        bias[cfg["duration_table"].index(frames_per_token)] = DURATION_BIAS
        spec["duration_ar.out.bias"] = ((len(bias),), bias)
    return spec


def positions(length: int, dim: int, device) -> torch.Tensor:
    """The sinusoidal table, sin in even and cos in odd columns."""
    pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
    scale = -torch.log(torch.tensor(10000.0)) / dim
    div = torch.exp(torch.arange(0, dim, 2, device=device,
                                 dtype=torch.float32) * scale.to(device))
    pe = torch.zeros(length, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def encode(P, cfg: dict, tokens, lengths, num: Num):
    """Embedding, three SAME convolutions with LayerNorm and ReLU, the
    sinusoidal positions, pre-norm transformer blocks, a final LayerNorm.
    tokens (B, T) int, lengths (B,) -> (B, T, He) float32."""
    B, T = tokens.shape
    He, nh = cfg["encoder_dim"], cfg["encoder_heads"]
    hd = He // nh
    dense = lambda x, name: num.dense(x, P[name + ".weight"].T,
                                      P[name + ".bias"])
    x = num.rnd(P["encoder.embed"])[tokens.long()]
    for i in range(3):
        w = P[f"encoder.prenet.convs.{i}.weight"]          # (out, in, k)
        out_ch, in_ch, k = w.shape
        left = (k - 1) // 2
        xp = F.pad(x, (0, 0, left, k - 1 - left))
        windows = xp.unfold(1, k, 1).reshape(B, T, in_ch * k)
        y = num.dense(windows, w.reshape(out_ch, in_ch * k).T,
                      P[f"encoder.prenet.convs.{i}.bias"])
        x = torch.relu(layer_norm(y, P[f"encoder.prenet.norms.{i}.weight"],
                                  P[f"encoder.prenet.norms.{i}.bias"]))
    x = x + num.rnd(positions(T, He, tokens.device))[None]
    valid = torch.arange(T, device=tokens.device)[None, :] < lengths[:, None]
    mask = valid[:, None, None, :] & valid[:, None, :, None]
    split = lambda y: y.reshape(B, T, nh, hd).transpose(1, 2)
    sqrt_hd = num.rnd(torch.tensor(math.sqrt(hd)))
    for i in range(cfg["encoder_layers"]):
        pre = f"encoder.blocks.{i}."
        h = layer_norm(x, P[pre + "norm1.weight"], P[pre + "norm1.bias"])
        q = num.rnd(split(dense(h, pre + "attn.query")) / sqrt_hd)
        kk = split(dense(h, pre + "attn.key"))
        v = split(dense(h, pre + "attn.value"))
        s = num.mm(q, kk.transpose(-1, -2)).masked_fill(~mask, num.min)
        a = num.rnd(torch.softmax(s, dim=-1))
        o = num.mm(a, v).transpose(1, 2).reshape(B, T, He)
        x = x + dense(o, pre + "attn.out")
        h = layer_norm(x, P[pre + "norm2.weight"], P[pre + "norm2.bias"])
        f = num.rnd(F.gelu(dense(h, pre + "ff.fc1"), approximate="tanh"))
        x = x + dense(f, pre + "ff.fc2")
    return layer_norm(x, P["encoder.norm.weight"], P["encoder.norm.bias"])


def gru(num: Num, wi, bi, wh, bhn, state, x):
    """A GRU cell with packed [r|z|n] kernels (in, 3H), only the n gate's
    recurrent bias, gates rounded to the compute dtype, and the carry
    (1 - z) * n in the compute dtype plus z * state in float32."""
    H = state.shape[-1]
    gi = num.dense(x, wi, bi)
    gh = num.mm(state, wh)
    sig = lambda p: num.rnd(torch.sigmoid(num.rnd(p)))
    r = sig(gi[..., :H] + gh[..., :H])
    z = sig(gi[..., H:2 * H] + gh[..., H:2 * H])
    inner = num.rnd(r * num.rnd(gh[..., 2 * H:] + num.rnd(bhn)))
    n = num.rnd(torch.tanh(num.rnd(gi[..., 2 * H:] + inner)))
    return num.rnd(num.rnd(1.0 - z) * n) + z * state


def _zero_carry(cfg: dict, R: int, W: int, device):
    """The GRU carry of every beam at the first step: (R, W, H) zeros."""
    return torch.zeros(R, W, cfg["decoder_dim"], device=device)


# ------------------------------------------------------------------- v1

def v1_enc_side(P, enc, num: Num):
    """The encoder-side terms of the v1 step at every source position:
    (p (B, T, 2R) the transition factors, eb (B, T, 2) the transition's
    encoder bias in float32, em (B, T, M) the frame's encoder term)."""
    p = num.dense(enc, P["transition.enc_proj.weight"].T,
                  P["transition.enc_proj.bias"])
    eb = dense32(enc, P["transition.enc_bias.weight"].T,
                 P["transition.enc_bias.bias"])
    em = num.dense(enc, P["frame.enc_mel.weight"].T,
                   P["frame.enc_mel.bias"])
    return p, eb, em


v1_state = _zero_carry


def v1_step(P, side, t, state, prev_mel, num: Num):
    """One v1 frame for every beam. side: v1_enc_side's terms (B, T, .);
    t (B, W) each beam's source position (clipped); state (B, W, H);
    prev_mel (B, W, M). Returns (h (B, W, 2) emit/shift log-probs, mel
    (B, W, M), new_state (B, W, H)): the mel prenet, the GRU, the
    factorized transition joint of rank R and the frame's point
    prediction."""
    T = side[0].shape[1]
    idx = t.long().clamp(0, T - 1)
    gather = lambda a: torch.gather(
        a, 1, idx[..., None].expand(-1, -1, a.shape[-1]))
    p, eb, em = (gather(a) for a in side)
    d = lambda x, name: num.dense(x, P[name + ".weight"].T,
                                  P[name + ".bias"])
    x = torch.relu(d(prev_mel, "ar_cell.prenet.fc1"))
    x = torch.relu(d(x, "ar_cell.prenet.fc2"))
    new_h = gru(num, P["ar_cell.cell.wi"], P["ar_cell.cell.bi"],
                P["ar_cell.cell.wh"], P["ar_cell.cell.bhn"], state, x)
    pre = num.rnd(torch.tanh(d(new_h, "transition.dec_pre")))
    q = d(pre, "transition.dec_proj")
    R = q.shape[-1] // 2
    prod = num.rnd(p * q)
    db = dense32(new_h, P["transition.dec_bias.weight"].T,
                 P["transition.dec_bias.bias"])
    logits = torch.stack([prod[..., :R].sum(-1), prod[..., R:].sum(-1)], -1)
    h = log_softmax(logits + eb + db)
    mel = num.rnd(em + d(new_h, "frame.dec_mel"))
    return h, mel, new_h


def v1_output(P, cfg: dict, frames, num_frames, num: Num):
    """The program's `mel` from the best path's frames (B, U, M): the
    frames themselves (this architecture has no postnet)."""
    return frames


# ------------------------------------------------------------------- v2

def v2_enc_side(P, enc, num: Num):
    """The duration head's encoder-side terms at every source position:
    (xin (B, T, H) the AR cell's encoder input, base (B, T, D) the
    per-position head logits in float32)."""
    xin = num.dense(enc, P["duration_ar.enc_in.weight"].T,
                    P["duration_ar.enc_in.bias"])
    h1 = torch.relu(num.dense(enc, P["duration_head.h1.weight"].T,
                              P["duration_head.h1.bias"]))
    base = dense32(h1, P["duration_head.out.weight"].T,
                   P["duration_head.out.bias"])
    return xin, base


v2_state = _zero_carry


def v2_step(P, side, pos, state, prev_class, num: Num):
    """One duration-class step for every beam at source positions pos
    (B, W) (clipped): the class embedding plus the encoder input through
    the AR GRU, the correction head added to the per-position logits.
    Returns (h (B, W, D) log-probs, new_state (B, W, H))."""
    T = side[0].shape[1]
    idx = pos.long().clamp(0, T - 1)
    xin, base = (torch.gather(a, 1, idx[..., None].expand(-1, -1,
                                                           a.shape[-1]))
                 for a in side)
    x = num.rnd(num.rnd(P["duration_ar.embed"])[prev_class.long()] + xin)
    new_h = gru(num, P["duration_ar.cell.wi"], P["duration_ar.cell.bi"],
                P["duration_ar.cell.wh"], P["duration_ar.cell.bhn"], state, x)
    logits = base + dense32(new_h, P["duration_ar.out.weight"].T,
                            P["duration_ar.out.bias"])
    return log_softmax(logits), new_h
