"""ssnt_tts_tpu_torch: the PyTorch + CUDA port of ssnt_tts_tpu.

The JAX package (ssnt_tts_tpu/) is the reference; this package mirrors its
layout (models/, ops/, parallel/, utils/) and keeps its public array
layouts so the two can be compared like with like. Hand-written Hopper
kernels live in csrc/ and are built at first use by ops/_build.py.

This package imports torch and numpy only, never jax, flax or ssnt_tts_tpu.

Public API (ssnt_tts_tpu/__init__.py's, the reference Python wrapper's
names), bound to the port's functions:

  beam_search_decode              v1 emit/shift step, unbatched
  beam_search_decode_batched      the same over a batch
  ssnt_tts_v2_beam_search_decode  v2 duration-class step
  tone_latent_beam_search_decode  tone step
  extract_best_beam_branch        v1 best-path backtrace
  order_beam_branch               all-beam backtrace
  upsample_source_indexes         durations -> source index per frame
  levenshtein_edit_distance       batched edit distance
  ssnt_loss                       forward-backward emit/shift lattice NLL
  ssnt_duration_loss              duration-class (v2) lattice NLL
"""

from ssnt_tts_tpu_torch.ops.backtrace import (
    extract_best_beam_branch,
    order_beam_branch,
)
from ssnt_tts_tpu_torch.ops.beam_v1 import (
    beam_search_decode,
    beam_search_decode_batched,
)
from ssnt_tts_tpu_torch.ops.beam_v2 import (
    beam_search_decode as ssnt_tts_v2_beam_search_decode,
)
from ssnt_tts_tpu_torch.ops.edit_distance import levenshtein_edit_distance
from ssnt_tts_tpu_torch.ops.lattice import ssnt_duration_loss, ssnt_loss
from ssnt_tts_tpu_torch.ops.tone_latent import (
    beam_search_decode as tone_latent_beam_search_decode,
)
from ssnt_tts_tpu_torch.ops.upsample import upsample_source_indexes

__version__ = "0.1.0"

__all__ = [
    "beam_search_decode",
    "beam_search_decode_batched",
    "ssnt_tts_v2_beam_search_decode",
    "tone_latent_beam_search_decode",
    "extract_best_beam_branch",
    "order_beam_branch",
    "upsample_source_indexes",
    "levenshtein_edit_distance",
    "ssnt_loss",
    "ssnt_duration_loss",
]
