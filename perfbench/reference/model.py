"""The plain reference of the SSNT-TTS decode math, in PyTorch.

It imports nothing of the program. Its parameters are a dict of float32
tensors by name (`params.param_shapes`), the weights the benchmark makes
from the seed and hands to both sides; everything the program derives from
them (fused and packed weights, the hoisted encoder-side paths of the class
step, the v1 step's encoder pack) is worked out here again.

Every operation runs in float32, and the points where the model rounds to
its compute dtype are explicit: `Num(dtype).rnd`. With `bfloat16` this is
the configuration's own arithmetic (operands rounded, products accumulated
in float32, results rounded, as a low-precision dense layer does); with
`float8_e4m3fn` the same code is the control, one precision below.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Num:
    """Rounding to one compute dtype, with float32 arithmetic between."""

    def __init__(self, dtype: torch.dtype):
        self.dtype = dtype
        self.min = torch.finfo(dtype).min

    def rnd(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype).float()

    def mm(self, a, b):
        """a (..., K) @ b (K, N): operands and result rounded."""
        return self.rnd(torch.matmul(self.rnd(a), self.rnd(b)))

    def dense(self, x, k, b):
        """A dense layer in the compute dtype: k (in, out)."""
        return self.rnd(self.mm(x, k) + self.rnd(b))


def dense32(x, k, b):
    """A dense layer kept in float32."""
    return torch.matmul(x.float(), k.float()) + b.float()


def log_softmax(x):
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def layer_norm(x, w, b, eps=1e-6):
    """eps 1e-6, float32 statistics, variance E[x^2] - E[x]^2 clipped."""
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * w) + b


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
