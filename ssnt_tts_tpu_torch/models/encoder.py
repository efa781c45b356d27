"""Text encoder, per-position class head and AR class cell (PyTorch).

Mirrors ssnt_tts_tpu/models/encoder.py:
  - TextEncoder: embedding + conv prenet + transformer stack -> (B, T, He)
    float32;
  - ClassHead: per-position duration (or tone) logits;
  - ARClassCell: per-beam GRU over each beam's own class history, which
    supplies the h (B, W, D) input of the v2 beam step.
ClassHead and ARClassCell hold parameters; their math is one set of plain
functions in models/stepmath.py, shared with the fused step's plain
version.
"""

from __future__ import annotations

import torch
from torch import nn

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.models.layers import (
    ConvPrenet,
    Dense,
    LayerNorm,
    TransformerBlock,
    length_mask,
    sinusoidal_positions,
)


class TextEncoder(nn.Module):
    def __init__(self, vocab_size: int, dim: int, num_layers: int,
                 num_heads: int, dtype, *, device=None):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.embed = nn.Parameter(torch.empty(vocab_size, dim, device=device))
        self.prenet = ConvPrenet(dim, dtype, device=device)
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, dtype, device=device)
            for _ in range(num_layers))
        self.norm = LayerNorm(dim, device=device)

    def forward(self, tokens: torch.Tensor, lengths=None) -> torch.Tensor:
        B, T = tokens.shape
        x = self.embed.to(self.dtype)[tokens.long()]
        x = self.prenet(x)
        x = x + sinusoidal_positions(T, self.dim, self.dtype,
                                     device=tokens.device)[None]
        mask = None
        if lengths is not None:
            m = length_mask(lengths, T)
            mask = m[:, None, None, :] & m[:, None, :, None]
        for block in self.blocks:
            x = block(x, mask)
        return self.norm(x)  # (B, T, dim) float32


class ClassHead(nn.Module):
    """Per-position class head: h1 in the compute dtype, out in float32.
    Its logits are stepmath.head_base over these weights."""

    def __init__(self, in_dim: int, num_classes: int, hidden_dim: int,
                 dtype, *, device=None):
        super().__init__()
        self.h1 = Dense(in_dim, hidden_dim, dtype, device=device)
        self.out = Dense(hidden_dim, num_classes, torch.float32,
                         device=device)


class GRUCell(nn.Module):
    """flax nn.GRUCell in stepmath's packed [r|z|n] form: wi (in, 3H) with
    bias bi, wh (H, 3H) with only the n gate's bias bhn (flax's hr/hz have
    none). Not torch's GRUCell, which has separate r/z recurrent biases
    and other rounding points in bfloat16."""

    def __init__(self, in_dim: int, dim: int, dtype, *, device=None):
        super().__init__()
        self.dtype = dtype
        self.wi = nn.Parameter(torch.empty(in_dim, 3 * dim, device=device))
        self.bi = nn.Parameter(torch.empty(3 * dim, device=device))
        self.wh = nn.Parameter(torch.empty(dim, 3 * dim, device=device))
        self.bhn = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, state: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return stepmath.gru_step(self.wi, self.bi, self.wh, self.bhn,
                                 state, x.to(self.dtype))


class ARClassCell(nn.Module):
    """Per-beam autoregressive class state (GRU over embedded history).
    Its step is stepmath.class_step_math over these weights (and, in the
    decode loop, the fused v2 step)."""

    def __init__(self, enc_dim: int, num_classes: int, dim: int, dtype,
                 *, device=None):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(num_classes, dim, device=device))
        self.enc_in = Dense(enc_dim, dim, dtype, device=device)
        self.cell = GRUCell(dim, dim, dtype, device=device)
        self.out = Dense(dim, num_classes, torch.float32, device=device)
