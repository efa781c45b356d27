"""Checked versions of the steps whose invariants the reference enforces by
aborting (the port of ssnt_tts_tpu/ops/checks.py):

  - the v2 beam empties: the reference panics (src/v2.rs:292);
  - sum(duration) != output_length in upsampling: an assert
    (src/v2_util.rs:58).

Each returns (utils.debug.Error, outputs) so that the caller decides: mask
the utterance, drop it, or raise with error.throw().
"""

from __future__ import annotations

from ssnt_tts_tpu_torch.ops import beam_v2, upsample
from ssnt_tts_tpu_torch.utils.debug import Error


def v2_beam_search_step_checked(*args, **kwargs):
    """beam_v2.beam_search_step (batched: h (B, W, D), state (B, W)) that
    flags, as JAX's checkify does, a step leaving an utterance without a
    surviving candidate. Returns (error, the step's seven outputs)."""
    *outs, n = beam_v2.beam_search_step(*args, **kwargs)
    err = Error([(~(n > 0).all(),
                  "Beam search could not find a duration sequence with "
                  "compatible output length (reference panics here, "
                  "src/v2.rs:292).")])
    return err, tuple(outs)


def upsample_source_indexes_checked(duration, output_length,
                                    out_of_range_source_index, max_u=None):
    """Upsampling that checks sum(duration) == output_length per (b, w)
    (the reference's assert, src/v2_util.rs:58). max_u defaults to the
    largest output_length (a host sync, as in JAX). Returns (error,
    indices)."""
    total = duration.sum(dim=-1)
    err = Error([(~(total == output_length).all(),
                  "sum(duration) != output_length (reference assert, "
                  "src/v2_util.rs:58)")])
    if max_u is None:
        max_u = int(output_length.max())
    return err, upsample.upsample_source_indexes(
        duration, output_length, out_of_range_source_index, max_u=max_u)
