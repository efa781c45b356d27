"""Duration -> frame-index upsampling (PyTorch).

Mirrors ssnt_tts_tpu/ops/upsample.py; reference src/v2_util.rs:39-66.
Output frame j maps to the first source position whose cumulative
duration exceeds j (cumsum + searchsorted(right=True)), which skips
zero-duration positions exactly like the reference's empty expansion.
Frames at or past output_length hold the fill value.
"""

from __future__ import annotations

import torch


def upsample_source_indexes(duration: torch.Tensor,
                            output_length: torch.Tensor,
                            out_of_range_source_index: int,
                            *, max_u: int) -> torch.Tensor:
    """duration (B, W, T) int, output_length (B, W) int ->
    (B, W, max_u) int32 source indices. max_u is the static output width
    (the reference's reduce_max(output_length) would need a host sync)."""
    B, W, T = duration.shape
    ends = torch.cumsum(duration.to(torch.int32), dim=-1, dtype=torch.int32)
    j = torch.arange(max_u, device=duration.device, dtype=torch.int32)
    idx = torch.searchsorted(ends.contiguous(),
                             j.expand(B, W, max_u).contiguous(),
                             right=True, out_int32=True)
    idx = torch.clamp(idx, max=T - 1)
    fill = torch.full_like(idx, out_of_range_source_index)
    return torch.where(j < output_length[..., None], idx, fill)
