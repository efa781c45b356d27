"""Mel prenet, AR decoder cell and the frame joint's decode side (PyTorch).

Mirrors the serving half of ssnt_tts_tpu/models/decoder.py: the GRU over
generated mel frames and FrameJoint.predict, the point prediction
a(enc_t) + b(dec_u) that synthesize_from_alignment emits. The lattice
side (TransitionJoint, FrameJoint.__call__) belongs to training and is not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ssnt_tts_tpu_torch.models.encoder import GRUCell
from ssnt_tts_tpu_torch.models.layers import Dense


class MelPrenet(nn.Module):
    def __init__(self, mel_dim: int, dim: int, dtype, *, device=None):
        super().__init__()
        self.fc1 = Dense(mel_dim, dim, dtype, device=device)
        self.fc2 = Dense(dim, dim, dtype, device=device)

    def forward(self, mel):
        return torch.relu(self.fc2(torch.relu(self.fc1(mel))))


class ARDecoderCell(nn.Module):
    """GRU cell over generated mel frames."""

    def __init__(self, mel_dim: int, dim: int, dtype, *, device=None):
        super().__init__()
        self.prenet = MelPrenet(mel_dim, dim, dtype, device=device)
        self.cell = GRUCell(dim, dim, dtype, device=device)

    def forward(self, carry, mel_frame):
        new_carry = self.cell(carry, self.prenet(mel_frame))
        return new_carry, new_carry.float()


class FrameJoint(nn.Module):
    """Decode side of the isotropic-Gaussian frame joint."""

    def __init__(self, enc_dim: int, dec_dim: int, mel_dim: int, dtype,
                 *, device=None):
        super().__init__()
        self.enc_mel = Dense(enc_dim, mel_dim, dtype, device=device)
        self.dec_mel = Dense(dec_dim, mel_dim, dtype, device=device)

    def predict(self, enc_t, dec_state):
        """Decode-time mel frame: (..., He) and (..., H) -> (..., M) f32."""
        return (self.enc_mel(enc_t) + self.dec_mel(dec_state)).float()
