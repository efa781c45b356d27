"""Shared building blocks with flax.linen's numerics (PyTorch).

Mirrors ssnt_tts_tpu/models/layers.py. Parameters are float32; every
matmul-bearing layer computes in `dtype` (the model's compute dtype) the
way flax does with `dtype=bfloat16`: operands are rounded to `dtype`, the
product accumulates in float32 and the result is rounded back to `dtype`
before the bias (also in `dtype`) is added.

Flax facts this module reproduces:
  - `nn.gelu` is the tanh approximation;
  - `nn.LayerNorm` uses epsilon 1e-6, float32 statistics, and the fast
    variance E[x^2] - E[x]^2 clipped at 0;
  - `nn.Conv` pads SAME;
  - `MultiHeadDotProductAttention` scales q by 1/sqrt(head_dim) and fills
    masked scores with finfo(dtype).min, so a fully masked query row (a
    padded token) comes out uniform rather than NaN;
  - the sinusoidal table interleaves sin/cos in even/odd columns.

Parameters are created uninitialized: weights come from
ssnt_tts_tpu_torch.convert (a flax tree or a seeded numpy tree).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def mm(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a (..., K) @ b (K, N): operands rounded to `dtype`, float32
    accumulation, result rounded to `dtype` (flax's low-precision dot)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float()).to(dtype)


class Dense(nn.Module):
    """flax nn.Dense. weight is (out, in), the transpose of flax's kernel."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 *, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mm(x, self.weight.T, self.dtype) + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(dtype=float32): eps 1e-6, fast variance."""

    eps = 1e-6

    def __init__(self, dim: int, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        mu2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mu2 - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mu) * mul + self.bias


class Conv1d(nn.Module):
    """flax nn.Conv over the token axis with SAME padding, on (B, T, C).
    weight is (out, in, k), flax's (k, in, out) kernel transposed. Computed
    as one `mm` over the k-wide windows: the rounding of Dense, and no
    cuDNN (whose float32 convolutions default to TF32 on the card)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, dtype,
                 *, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch, kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(out_ch, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_ch, in_ch, k = self.weight.shape
        left = (k - 1) // 2  # SAME: the extra pad (even k) goes right
        xp = F.pad(x, (0, 0, left, k - 1 - left))          # (B, T+k-1, C)
        windows = xp.unfold(1, k, 1).reshape(*x.shape[:2], in_ch * k)
        y = mm(windows, self.weight.reshape(out_ch, in_ch * k).T, self.dtype)
        return y + self.bias.to(self.dtype)


class MultiHeadAttention(nn.Module):
    """flax MultiHeadDotProductAttention (self-attention, qkv_features =
    out_features = dim). q/k/v/out weights are (dim, dim) Linear layouts of
    flax's (dim, heads, head_dim) / (heads, head_dim, dim) kernels."""

    def __init__(self, dim: int, num_heads: int, dtype, *, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.query = Dense(dim, dim, dtype, device=device)
        self.key = Dense(dim, dim, dtype, device=device)
        self.value = Dense(dim, dim, dtype, device=device)
        self.out = Dense(dim, dim, dtype, device=device)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        B, T, E = x.shape
        nh = self.num_heads
        hd = E // nh
        dt = self.dtype
        split = lambda y: y.reshape(B, T, nh, hd).transpose(1, 2)  # (B,h,T,d)
        q = split(self.query(x)) / torch.tensor(math.sqrt(hd), dtype=dt)
        k = split(self.key(x))
        v = split(self.value(x))
        w = mm(q, k.transpose(-1, -2), dt)  # (B, h, Tq, Tk)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(dt).min)
        w = torch.softmax(w.float(), dim=-1).to(dt)
        o = mm(w, v, dt).transpose(1, 2).reshape(B, T, E)
        return self.out(o)


class FeedForward(nn.Module):
    def __init__(self, dim: int, dtype, hidden_mult: int = 4, *, device=None):
        super().__init__()
        self.fc1 = Dense(dim, dim * hidden_mult, dtype, device=device)
        self.fc2 = Dense(dim * hidden_mult, dim, dtype, device=device)

    def forward(self, x):
        h = self.fc1(x)
        h = F.gelu(h.float(), approximate="tanh").to(h.dtype)
        return self.fc2(h)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype, *, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = MultiHeadAttention(dim, num_heads, dtype, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.ff = FeedForward(dim, dtype, device=device)

    def forward(self, x, mask=None):
        x = x + self.attn(self.norm1(x), mask)
        return x + self.ff(self.norm2(x))


class ConvPrenet(nn.Module):
    """1D conv stack over the token axis (Tacotron-style text prenet)."""

    def __init__(self, dim: int, dtype, kernel_size: int = 5,
                 layers: int = 3, *, device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(dim, dim, kernel_size, dtype, device=device)
            for _ in range(layers))
        self.norms = nn.ModuleList(
            LayerNorm(dim, device=device) for _ in range(layers))

    def forward(self, x):
        for conv, norm in zip(self.convs, self.norms):
            x = torch.relu(norm(conv(x)))
        return x


def sinusoidal_positions(length: int, dim: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    pos = torch.arange(length, device=device, dtype=torch.float32)[:, None]
    scale = -torch.log(torch.tensor(10000.0)) / dim
    div = torch.exp(
        torch.arange(0, dim, 2, device=device, dtype=torch.float32)
        * scale.to(device))
    pe = torch.zeros(length, dim, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool mask."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])
