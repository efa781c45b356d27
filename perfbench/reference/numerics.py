"""Arithmetic that every architecture's reference shares, in PyTorch.

Every operation runs in float32, and the points where a model rounds to
its compute dtype are explicit: `Num(dtype).rnd`. With `bfloat16` this is
the configuration's own arithmetic (operands rounded, products accumulated
in float32, results rounded, as a low-precision dense layer does); with
`float8_e4m3fn` the same code is the control, one precision below.
"""

from __future__ import annotations

import torch


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
