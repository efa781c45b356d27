"""Typed configuration for the PyTorch port.

A field-for-field mirror of ssnt_tts_tpu/utils/config.py (same names, same
defaults), kept separate so the port never imports the JAX package.
tests/test_torch_model.py asserts the two stay equal.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    """v1 emit/shift beam search (src/lib.rs)."""

    beam_width: int = 8
    max_beam_width: Optional[int] = None  # defaults to beam_width

    def resolved_max_width(self) -> int:
        return self.max_beam_width or self.beam_width


@dataclasses.dataclass(frozen=True)
class V2BeamConfig:
    """v2 duration-class beam search: the reference's hard-coded constants
    (src/v2.rs:96-116) promoted to fields. Every field here is read by the
    kernel (ops/beam_v2.py); the op-attr-style knobs (beam_width,
    zero_duration_id, allow_skip, test_mode) are explicit kernel arguments
    instead, so a config object can never silently diverge from behavior."""

    # src/v2.rs:98 (+10% of total frames)
    band_upper_frac: float = 0.1
    # src/v2.rs:100 (-5% of total frames)
    band_lower_frac: float = 0.05
    # src/v2.rs:109 (min duration per remaining source position)
    overrun_multiplier: int = 3
    # src/v2.rs:116 (diagonal re-injection window, frames)
    diagonal_window: Tuple[float, float] = (-20.0, 0.0)
    # Round-5 empty-beam remedy (VERDICT r4 #2): prune candidates that
    # provably CANNOT reach total_duration == output_length — after this
    # candidate, the remaining f = T-1-t positions can only add
    # [f*dmin, f*dmax] frames (dmin over admissible classes), so any
    # candidate with U - tot outside that range is doomed; pruning it
    # early keeps beam slots for hypotheses that can still land exactly
    # (a strict generalization of the reference's t==T-1 exact-final
    # rule, src/v2.rs:135-137 — at f=0 it IS that rule). Default False:
    # the reference has no such guard, and parity-at-defaults is the
    # conformance contract. Ignored in test_mode like every other prune.
    final_feasible_guard: bool = False


@dataclasses.dataclass(frozen=True)
class ToneBeamConfig:
    """Tone-latent beam search (src/tone_latent.rs)."""

    beam_width: int = 8
    tone_class_size: int = 8
    empty_tone_id: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Flagship SSNT-TTS model."""

    vocab_size: int = 256
    mel_dim: int = 80
    encoder_dim: int = 256
    encoder_layers: int = 4
    encoder_heads: int = 4
    decoder_dim: int = 256
    joint_rank: int = 64
    duration_class_size: int = 10
    tone_class_size: int = 8
    dtype: str = "bfloat16"
    # Lattice loss backend: "auto" uses the Pallas kernels on TPU and the
    # XLA scan elsewhere; "xla"/"pallas" force one.
    lattice_impl: str = "auto"
    # Domain of the lattice quantities the joints emit. "log" (default):
    # log-prob arrays (le, ls, lf) — the reference-conformant API the
    # fp64 oracle checks. "exp": the joints emit probabilities directly
    # (E, S from the transition softmax; column-max-normalized F + mcol
    # from the frame joint) and the loss runs the transcendental-free
    # exp-native Pallas path (ops/lattice_pallas.ssnt_loss_expin) — the
    # fast path for the issue-bound small-batch regime
    # (docs/LATTICE_FLOOR.md). Loss/grads match the log path to f32
    # accuracy (tests/test_lattice_pallas.py, tests/test_model.py).
    lattice_domain: str = "log"
    # Storage dtype of the (U, B, T) lattice quantities the joints emit.
    # "float32" (default): exact-contract lattice loss. "bfloat16": the
    # joints emit bf16 lattices and the Pallas loss runs its 26 B/cell
    # bf16-storage variant (f32 compute in VMEM) — the mixed-precision
    # training path past the f32 HBM roofline; loss/grads track f32 to
    # ~1% relative (tests/test_model.py::test_bf16_lattice_training).
    # The XLA backend upcasts bf16 inputs to f32 (correct, no speedup).
    lattice_dtype: str = "float32"
    # Frames contributed by each duration class (v2 alignment space,
    # src/v2.rs DecodingTable). Must have duration_class_size entries.
    duration_table: Tuple[int, ...] = tuple(range(10))
    # Train the per-position duration head by the duration-lattice marginal
    # NLL (ops.lattice.ssnt_duration_loss) instead of only teacher-forced CE.
    use_duration_lattice: bool = False
    duration_lattice_weight: float = 1.0
    # Long-context lattices: when set (and training through
    # parallel.train.make_sharded_train_step), lattices with
    # U*B*T >= this many cells shard their T axis over the mesh "model"
    # axis with ring frontier exchange (ops/lattice_sharded) instead of
    # running the single-chip kernels. None = never T-shard.
    lattice_tshard_min_cells: Optional[int] = None


def tiny_model_config(**overrides) -> ModelConfig:
    """Small config for tests/dryruns."""
    base = dict(
        vocab_size=32,
        mel_dim=8,
        encoder_dim=32,
        encoder_layers=1,
        encoder_heads=2,
        decoder_dim=32,
        joint_rank=8,
        duration_class_size=5,
        tone_class_size=4,
        duration_table=tuple(range(5)),
        dtype="float32",
    )
    base.update(overrides)
    return ModelConfig(**base)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    warmup_steps: int = 1000
    weight_decay: float = 1e-2
    grad_clip_norm: float = 1.0
    batch_size: int = 256
    max_input_length: int = 80
    max_output_length: int = 400


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout. data * model must equal the device count."""

    data: int = 1
    model: int = 1
