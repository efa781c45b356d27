"""File-backed dataset: .npz shards and length-bucketed static-shape
batches (numpy only).

A copy of ssnt_tts_tpu/data_files.py, kept in the port so that it never
imports the JAX package: shards written by either package read
identically in the other, and for the same shards and seed the batches
and PaddingStats are the same bit for bit.

  - Shard format: each ``shard-NNNNN.npz`` stores ragged examples as flat
    arrays and offsets (``tokens_flat/tokens_off``, ``mel_flat/mel_off``,
    optional ``duration_flat``/``tone_flat`` sharing ``tokens_off``).
  - Length bucketing: each batch is padded to one of a fixed set of
    ``(T_pad, U_pad)`` buckets; an example goes to the smallest bucket that
    fits, and a batch is emitted whenever a bucket fills.
  - Padding efficiency: ``PaddingStats`` counts token and frame occupancy
    of every emitted batch.

Batches have the keys and dtypes of data.SyntheticTTSDataset.batch, less
"alignment", so train_loop consumes either source through
prefetch_to_device.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


# ------------------------------------------------------------------ writing

def write_npz_shards(
    examples: Iterable[Dict[str, np.ndarray]],
    out_dir: str,
    shard_size: int = 512,
) -> List[str]:
    """Write ragged examples to flat+offset .npz shards.

    Each example dict: tokens (Tb,) i32, mel (Ub, M) f32, and optionally
    duration_target (Tb,) i32, tone_target (Tb,) i32. Returns shard paths.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    buf: List[Dict[str, np.ndarray]] = []

    def flush():
        if not buf:
            return
        tokens = [e["tokens"] for e in buf]
        mels = [e["mel"] for e in buf]
        out = {
            "tokens_flat": np.concatenate(tokens).astype(np.int32),
            "tokens_off": np.cumsum([0] + [len(t) for t in tokens]).astype(
                np.int64
            ),
            "mel_flat": np.concatenate(mels, axis=0).astype(np.float32),
            "mel_off": np.cumsum([0] + [len(m) for m in mels]).astype(
                np.int64
            ),
        }
        for key, name in (
            ("duration_target", "duration_flat"),
            ("tone_target", "tone_flat"),
        ):
            if key in buf[0]:
                out[name] = np.concatenate(
                    [e[key] for e in buf]
                ).astype(np.int32)
        path = os.path.join(out_dir, f"shard-{len(paths):05d}.npz")
        np.savez_compressed(path, **out)
        paths.append(path)
        buf.clear()

    for ex in examples:
        if len(ex["tokens"]) == 0 or len(ex["mel"]) == 0:
            raise ValueError("empty example")
        buf.append(ex)
        if len(buf) >= shard_size:
            flush()
    flush()
    meta = {"num_shards": len(paths), "shard_size": shard_size}
    with open(os.path.join(out_dir, "dataset.json"), "w") as f:
        json.dump(meta, f)
    return paths


def materialize_synthetic(
    ds, num_examples: int, out_dir: str, shard_size: int = 512,
    batch_size: int = 64,
) -> List[str]:
    """Dump `num_examples` ragged examples from data.SyntheticTTSDataset
    into shards (test/bootstrap convenience)."""

    def gen():
        produced = 0
        while produced < num_examples:
            b = ds.batch(batch_size)
            for i in range(len(b["tokens"])):
                if produced >= num_examples:
                    return
                Tb = int(b["input_length"][i])
                Ub = int(b["output_length"][i])
                yield {
                    "tokens": b["tokens"][i, :Tb],
                    "mel": b["mel"][i, :Ub],
                    "duration_target": b["duration_target"][i, :Tb],
                    "tone_target": b["tone_target"][i, :Tb],
                }
                produced += 1

    return write_npz_shards(gen(), out_dir, shard_size)


# ------------------------------------------------------------------ buckets

@dataclass(frozen=True)
class Bucket:
    t_pad: int
    u_pad: int


def default_buckets(max_t: int, max_u: int, n: int = 4) -> List[Bucket]:
    """Geometric bucket ladder ending at (max_t, max_u)."""
    buckets = []
    for i in range(n, 0, -1):
        frac = 0.5 ** (i - 1)
        buckets.append(
            Bucket(max(8, int(np.ceil(max_t * frac))),
                   max(16, int(np.ceil(max_u * frac))))
        )
    return buckets


@dataclass
class PaddingStats:
    """Running occupancy of emitted batches (1.0 = no padding waste)."""
    token_slots: int = 0
    tokens: int = 0
    frame_slots: int = 0
    frames: int = 0
    batches: int = 0
    per_bucket: Dict[Tuple[int, int], int] = field(default_factory=dict)

    def update(self, batch: Dict[str, np.ndarray]):
        B, T = batch["tokens"].shape
        U = batch["mel"].shape[1]
        self.token_slots += B * T
        self.tokens += int(batch["input_length"].sum())
        self.frame_slots += B * U
        self.frames += int(batch["output_length"].sum())
        self.batches += 1
        self.per_bucket[(T, U)] = self.per_bucket.get((T, U), 0) + 1

    @property
    def token_efficiency(self) -> float:
        return self.tokens / max(1, self.token_slots)

    @property
    def frame_efficiency(self) -> float:
        return self.frames / max(1, self.frame_slots)

    def summary(self) -> Dict[str, float]:
        return {
            "token_efficiency": round(self.token_efficiency, 4),
            "frame_efficiency": round(self.frame_efficiency, 4),
            "batches": self.batches,
        }


# ------------------------------------------------------------------ reading

class NpzShardDataset:
    """Reads flat+offset shards and emits length-bucketed padded batches."""

    def __init__(self, data_dir: str, buckets: Optional[Sequence[Bucket]] = None,
                 cache_shards: int = 16):
        self.data_dir = data_dir
        # Shard cache bound (the oldest loaded shard goes first).
        # batches() shuffles example order globally, so a small cache
        # thrashes: each example can hit a different shard, ~45 MB
        # decompressed per miss at T=80, U=400. 16 shards = 8K examples
        # resident; larger corpora should raise the bound.
        self.cache_shards = int(cache_shards)
        self.paths = sorted(
            os.path.join(data_dir, p)
            for p in os.listdir(data_dir)
            if p.startswith("shard-") and p.endswith(".npz")
        )
        if not self.paths:
            raise FileNotFoundError(f"no shard-*.npz under {data_dir}")
        # Example index: (shard_i, example_i, T_b, U_b) — lengths come from
        # the offset vectors, so the index never loads mel payloads.
        index: List[Tuple[int, int, int, int]] = []
        for si, p in enumerate(self.paths):
            with np.load(p) as z:
                t_off, m_off = z["tokens_off"], z["mel_off"]
            for ei in range(len(t_off) - 1):
                index.append(
                    (si, ei, int(t_off[ei + 1] - t_off[ei]),
                     int(m_off[ei + 1] - m_off[ei]))
                )
        self.index = index
        max_t = max(e[2] for e in index)
        max_u = max(e[3] for e in index)
        self.buckets = sorted(
            buckets or default_buckets(max_t, max_u),
            key=lambda b: (b.t_pad, b.u_pad),
        )
        if max_t > self.buckets[-1].t_pad or max_u > self.buckets[-1].u_pad:
            raise ValueError(
                f"corpus max lengths ({max_t}, {max_u}) exceed the largest "
                f"bucket {self.buckets[-1]}"
            )
        self.stats = PaddingStats()
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self):
        return len(self.index)

    def _shard(self, si: int) -> Dict[str, np.ndarray]:
        if si not in self._cache:
            if len(self._cache) >= self.cache_shards:
                self._cache.pop(next(iter(self._cache)))
            with np.load(self.paths[si]) as z:
                self._cache[si] = {k: z[k] for k in z.files}
        return self._cache[si]

    def _example(self, si: int, ei: int) -> Dict[str, np.ndarray]:
        z = self._shard(si)
        t0, t1 = z["tokens_off"][ei], z["tokens_off"][ei + 1]
        m0, m1 = z["mel_off"][ei], z["mel_off"][ei + 1]
        ex = {
            "tokens": z["tokens_flat"][t0:t1],
            "mel": z["mel_flat"][m0:m1],
        }
        if "duration_flat" in z:
            ex["duration_target"] = z["duration_flat"][t0:t1]
        if "tone_flat" in z:
            ex["tone_target"] = z["tone_flat"][t0:t1]
        return ex

    def _bucket_for(self, T_b: int, U_b: int) -> Bucket:
        for b in self.buckets:
            if T_b <= b.t_pad and U_b <= b.u_pad:
                return b
        raise AssertionError  # guarded in __init__

    def _pad_batch(self, exs: List[Dict[str, np.ndarray]], b: Bucket):
        B = len(exs)
        M = exs[0]["mel"].shape[1]
        out = {
            "tokens": np.zeros((B, b.t_pad), np.int32),
            "mel": np.zeros((B, b.u_pad, M), np.float32),
            "input_length": np.zeros((B,), np.int32),
            "output_length": np.zeros((B,), np.int32),
        }
        has_dur = "duration_target" in exs[0]
        has_tone = "tone_target" in exs[0]
        if has_dur:
            out["duration_target"] = np.zeros((B, b.t_pad), np.int32)
        if has_tone:
            out["tone_target"] = np.zeros((B, b.t_pad), np.int32)
        for i, ex in enumerate(exs):
            Tb, Ub = len(ex["tokens"]), len(ex["mel"])
            out["tokens"][i, :Tb] = ex["tokens"]
            out["mel"][i, :Ub] = ex["mel"]
            out["input_length"][i] = Tb
            out["output_length"][i] = Ub
            if has_dur:
                out["duration_target"][i, :Tb] = ex["duration_target"]
            if has_tone:
                out["tone_target"][i, :Tb] = ex["tone_target"]
        self.stats.update(out)
        return out

    def batches(
        self,
        batch_size: int,
        *,
        shuffle_seed: Optional[int] = 0,
        epochs: Optional[int] = None,
        drop_remainder: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield bucketed, padded batches. With drop_remainder=False, final
        partial buckets are filled by repeating their first example (keeps
        static shapes; repeats slightly re-weight those utterances)."""
        rng = np.random.default_rng(shuffle_seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self.index))
            if shuffle_seed is not None:
                rng.shuffle(order)
            pending: Dict[Bucket, List[Tuple[int, int]]] = {
                b: [] for b in self.buckets
            }
            for oi in order:
                si, ei, T_b, U_b = self.index[oi]
                b = self._bucket_for(T_b, U_b)
                pending[b].append((si, ei))
                if len(pending[b]) == batch_size:
                    yield self._pad_batch(
                        [self._example(*k) for k in pending[b]], b
                    )
                    pending[b] = []
            if not drop_remainder:
                for b, keys in pending.items():
                    if not keys:
                        continue
                    keys = keys + [keys[0]] * (batch_size - len(keys))
                    yield self._pad_batch(
                        [self._example(*k) for k in keys], b
                    )
            epoch += 1
