"""Operations and bytes of the SSNT-TTS architecture's decode ("ssnt",
perfbench/reference/ssnt.py), from a configuration's shapes, as
perfbench/arch.py asks of an architecture's counts.

Operations are 2 x the multiply-adds of the matrix products. Bytes count
each input byte read once and each output byte written once: a step's
weights (compute dtype, float32 where the model keeps a layer in
float32), its activations and beam state, and for v1 the encoder-pack
rows its beams gather. Nothing that a kernel reads again is counted twice.
"""

from __future__ import annotations

from perfbench.counts.roofline import BOOL, DTYPE_BYTES, F32, I32


def encoder_flops(cfg: dict, B: int, T: int) -> float:
    """Embedding, three width-5 convolutions, and per block the four
    attention projections, scores and values, and the feed-forward."""
    He = cfg["encoder_dim"]
    conv = 3 * 2 * T * 5 * He * He
    block = (4 * 2 * T * He * He + 2 * 2 * T * T * He
             + 2 * 2 * T * He * 4 * He)
    return B * (conv + cfg["encoder_layers"] * block)


def v1_step_flops(cfg: dict, B: int, W: int) -> float:
    H, M, R = cfg["decoder_dim"], cfg["mel_dim"], cfg["joint_rank"]
    macs = M * H + H * H + 2 * H * 3 * H + H * R + R * 2 * R + H * 2 + H * M
    return 2.0 * B * W * macs


def v1_step_bytes(cfg: dict, B: int, W: int) -> float:
    H, M, R = cfg["decoder_dim"], cfg["mel_dim"], cfg["joint_rank"]
    c = DTYPE_BYTES[cfg["dtype"]]
    weights = ((M * H + H * H + 2 * H * 3 * H + H * R + R * 2 * R + H * M)
               * c + (2 * H + 3 * H + H + 3 * R + M) * c + (2 * H + 2) * F32)
    n = B * W
    rows = n * (2 * R + 2 + M) * F32
    inputs = rows + n * (3 * I32 + BOOL + (M + H) * F32) + B * I32
    outputs = n * (6 * I32 + BOOL + (M + H) * F32)
    return float(weights + inputs + outputs)


def v2_step_flops(cfg: dict, B: int, W: int) -> float:
    H, D = cfg["decoder_dim"], cfg["duration_class_size"]
    return 2.0 * B * W * (2 * H * 3 * H + H * D)


def v2_step_bytes(cfg: dict, B: int, W: int) -> float:
    H, D = cfg["decoder_dim"], cfg["duration_class_size"]
    c = DTYPE_BYTES[cfg["dtype"]]
    weights = (D * H + 2 * H * 3 * H + 4 * H) * c + (H * D + D) * F32
    n = B * W
    inputs = (B * H * c + B * D * F32 + n * (5 * I32 + BOOL + H * F32)
              + B * (2 * I32 + BOOL) + D * I32)
    outputs = n * (6 * I32 + BOOL + H * F32) + B * (I32 + BOOL)
    return float(weights + inputs + outputs)


def decode_flops(entry: str, cfg: dict, mix: dict, B: int, W: int) -> float:
    """Model operations of one batch: the encoder, the encoder-side
    projections hoisted out of the loop, and every step's products."""
    T, He = mix["pad_to"], cfg["encoder_dim"]
    total = encoder_flops(cfg, B, T)
    if entry == "v1":
        M, R = cfg["mel_dim"], cfg["joint_rank"]
        total += 2.0 * B * T * He * (2 * R + 2 + M)
        return total + mix["max_frames"] * v1_step_flops(cfg, B, W)
    H, D = cfg["decoder_dim"], cfg["duration_class_size"]
    total += 2.0 * B * T * (He * H + He * He + He * D)
    return total + T * v2_step_flops(cfg, B, W)

