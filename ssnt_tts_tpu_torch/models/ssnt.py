"""SSNTModel, serving half (PyTorch).

Mirrors the decode-time methods of ssnt_tts_tpu/models/ssnt.py:
  encode -> enc (B, T, He) float32
  duration_decode_step -> per-beam h (B, W, D) + new AR class state
  synthesize_from_alignment -> mel (B, U, M) through a decoded alignment

The parameter names follow the flax tree's module names (encoder, ar_cell,
frame, duration_head, duration_ar, tone_head, tone_ar), so
ssnt_tts_tpu_torch.convert maps leaves one to one. The training-only
TransitionJoint and FrameJoint.log_sigma are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.models.decoder import ARDecoderCell, FrameJoint
from ssnt_tts_tpu_torch.models.encoder import (
    ARClassCell,
    ClassHead,
    TextEncoder,
)
from ssnt_tts_tpu_torch.utils.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {cfg.dtype!r}")
    return _DTYPES[cfg.dtype]


class SSNTModel(nn.Module):
    """Parameters are uninitialized until a state dict is loaded
    (ssnt_tts_tpu_torch.convert.flax_to_torch)."""

    def __init__(self, config: ModelConfig, *, device=None):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        He, H = cfg.encoder_dim, cfg.decoder_dim
        kw = dict(device=device)
        self.encoder = TextEncoder(cfg.vocab_size, He, cfg.encoder_layers,
                                   cfg.encoder_heads, dt, **kw)
        self.ar_cell = ARDecoderCell(cfg.mel_dim, H, dt, **kw)
        self.frame = FrameJoint(He, H, cfg.mel_dim, dt, **kw)
        self.duration_head = ClassHead(He, cfg.duration_class_size, He, dt,
                                       **kw)
        self.duration_ar = ARClassCell(He, cfg.duration_class_size, H, dt,
                                       **kw)
        self.tone_head = ClassHead(He, cfg.tone_class_size, He, dt, **kw)
        self.tone_ar = ARClassCell(He, cfg.tone_class_size, H, dt, **kw)

    def encode(self, tokens, input_length=None):
        return self.encoder(tokens, input_length)

    def duration_step_weights(self) -> stepmath.ClassStepWeights:
        return stepmath.extract_class_step_weights(self.duration_head,
                                                   self.duration_ar)

    def duration_decode_step(self, enc, beam_t, state, prev_class):
        """Per-beam v2 conditioning. enc (B, T, He); beam_t (B, W) source
        positions; state (B, W, H); prev_class (B, W).
        Returns (h (B, W, D) log-probs, new_state (B, W, H))."""
        T = enc.shape[1]
        idx = beam_t.long().clamp(0, T - 1)
        enc_t = torch.gather(
            enc, 1, idx[..., None].expand(-1, -1, enc.shape[2]))
        return stepmath.class_step_math(self.duration_step_weights(), enc_t,
                                        state, prev_class, self.dtype)

    def synthesize_from_alignment(self, enc, source_indexes):
        """Mel frames through a decoded alignment map.

        enc (B, T, He); source_indexes (B, U) int (out-of-range entries are
        clipped; callers mask with the true output length).
        Returns mel (B, U, M) float32."""
        B, T, He = enc.shape
        U = source_indexes.shape[1]
        src = source_indexes.long().clamp(0, T - 1)
        enc_path = torch.gather(enc, 1, src[..., None].expand(-1, -1, He))
        state = torch.zeros(B, self.config.decoder_dim, device=enc.device)
        prev_mel = torch.zeros(B, self.config.mel_dim, device=enc.device)
        mels = []
        for j in range(U):
            state, dec_out = self.ar_cell(state, prev_mel)
            prev_mel = self.frame.predict(enc_path[:, j], dec_out)
            mels.append(prev_mel)
        return torch.stack(mels, dim=1)
