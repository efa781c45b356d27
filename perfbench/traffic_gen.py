"""The one generator of the benchmark's traffic, driven by a mix's file.

A mix (perfbench/traffic/<name>.json) holds parameters only:
  entry             the decode a batch drives ("v1" or "v2", harness.ENTRIES)
  batch             B, the utterances a batch
  beam              W, the decode's beam width
  pad_to            T, the padded source length
  min_len, max_len  source lengths, evenly spread over this range in every
                    batch (the same set of lengths for every seed and
                    batch, in another order)
  max_frames        U, the decode's frame limit
  frames_per_token  v2: an utterance's target is this many frames a token
  hop_s             seconds of audio a frame
Tokens are uniform over the configuration's vocabulary, 0 past an
utterance's length. Batch i of seed n is the same in every run: it is
drawn on the device from a generator seeded with (n, i).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def subseed(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of draws of a run's seed."""
    text = ":".join(str(x) for x in (seed, *tags)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "big") >> 1


def load(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


class Traffic:
    def __init__(self, mix: dict, vocab_size: int, seed: int, device):
        self.mix, self.vocab, self.B = mix, vocab_size, mix["batch"]
        self.seed, self.device = seed, device
        lo, hi = mix["min_len"], mix["max_len"]
        if not 1 <= lo <= hi <= mix["pad_to"]:
            raise ValueError(f"lengths {lo}-{hi} do not fit T={mix['pad_to']}")
        self.lengths = lo + (torch.arange(self.B) * (hi - lo + 1)) // self.B

    def batch(self, i: int) -> dict:
        """Batch i: tokens (B, T) int32, input_length (B,) int32 and, for
        v2, output_length (B,) int32, on the device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(subseed(self.seed, "batch", i))
        T = self.mix["pad_to"]
        perm = torch.randperm(self.B, generator=g, device=self.device)
        il = self.lengths.to(self.device)[perm].to(torch.int32)
        toks = torch.randint(0, self.vocab, (self.B, T), generator=g,
                             device=self.device, dtype=torch.int32)
        pos = torch.arange(T, device=self.device)[None, :]
        out = {"tokens": torch.where(pos < il[:, None], toks, 0),
               "input_length": il}
        if "frames_per_token" in self.mix:
            out["output_length"] = il * self.mix["frames_per_token"]
        return out
