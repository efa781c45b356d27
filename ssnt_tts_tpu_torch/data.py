"""Input pipeline: the synthetic SSNT-TTS dataset and a background
host-to-device prefetch (PyTorch).

`SyntheticTTSDataset` is a copy of ssnt_tts_tpu/data.py's (numpy only):
for the same seed its batches are byte-identical to the JAX package's.
Batches are padded to (max_input_length, max_output_length) with the true
lengths alongside: monotone alignments (random positive durations), mel
frames that are a function of the aligned token plus noise, and duration
and tone targets consistent with the alignment.

`prefetch_to_device` stages the next batches on a background thread:
pinned host memory and non_blocking copies to an explicit device (the
card unless the caller names another), so the copy of batch i+1 overlaps
step i.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ssnt_tts_tpu_torch.utils.device import resolve_device


class SyntheticTTSDataset:
    def __init__(
        self,
        vocab_size: int = 128,
        mel_dim: int = 80,
        max_input_length: int = 80,
        max_output_length: int = 400,
        duration_class_size: int = 10,
        tone_class_size: int = 8,
        seed: int = 0,
    ):
        self.vocab_size = vocab_size
        self.mel_dim = mel_dim
        self.max_T = max_input_length
        self.max_U = max_output_length
        self.D = duration_class_size
        self.K = tone_class_size
        self._rng = np.random.default_rng(seed)
        # Fixed random embedding of tokens -> mel space so mel frames are a
        # learnable function of the aligned token.
        self._tok_mel = self._rng.normal(
            0, 1, (vocab_size, mel_dim)
        ).astype(np.float32)

    def batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        rng = self._rng
        B = batch_size
        T, U = self.max_T, self.max_U
        tokens = rng.integers(1, self.vocab_size, (B, T)).astype(np.int32)
        input_length = rng.integers(
            max(2, T // 2), T + 1, B
        ).astype(np.int32)
        output_length = np.zeros(B, np.int32)
        mel = np.zeros((B, U, self.mel_dim), np.float32)
        duration = np.zeros((B, T), np.int32)
        align = np.zeros((B, U), np.int32)
        for b in range(B):
            Tb = input_length[b]
            # Random positive durations summing to <= U: expected U/T frames
            # per token, at least 1 (every token emits), at most D-1 so the
            # duration-CLASS targets are exactly the durations. (Round-5
            # fix: the generator previously drew durations up to
            # (U//Tb)*2-1 > D-1 and clipped only the class targets, so
            # sum(duration_target) != output_length and — when
            # (D-1)*Tb < output_length — the utterance was INFEASIBLE in
            # the v2 alignment space: no class sequence can land
            # output_length exactly, the state where the reference
            # panics (src/v2.rs:292). A large part of the eval
            # empty-beam rate was this data inconsistency, not decode
            # behavior.)
            max_per = max(1, min((U // Tb) * 2 - 1, self.D - 1))
            d = rng.integers(1, max_per + 1, Tb)
            scale = min(1.0, (U - Tb) / max(1, d.sum() - Tb))
            d = np.maximum(1, np.round(d * scale)).astype(np.int64)
            while d.sum() > U:
                i = int(np.argmax(d))
                d[i] -= 1
            duration[b, :Tb] = d
            Ub = int(d.sum())
            output_length[b] = Ub
            pos = np.repeat(np.arange(Tb), d)
            align[b, :Ub] = pos
            mel[b, :Ub] = self._tok_mel[tokens[b, pos]]
        mel += rng.normal(0, 0.05, mel.shape).astype(np.float32)
        tone = (tokens % self.K).astype(np.int32)
        dur_class = np.clip(duration, 0, self.D - 1).astype(np.int32)
        return {
            "tokens": tokens,
            "mel": mel,
            "input_length": input_length,
            "output_length": output_length,
            "duration_target": dur_class,
            "tone_target": tone,
            "alignment": align,
        }

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch(batch_size)


def prefetch_to_device(it: Iterator[Dict[str, np.ndarray]], size: int = 2,
                       device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields the batches of `it` as tensors on `device`, staged up to
    `size` ahead by a daemon thread. An exception in `it` is raised to the
    consumer; closing the generator stops the thread."""
    dev = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()

    def to_device(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for batch in it:
                if not put({k: to_device(v) for k, v in batch.items()}):
                    return
            put(done)
        except BaseException as e:  # propagate to the consumer
            put(e)

    worker = threading.Thread(target=producer, daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        worker.join(timeout=10)
