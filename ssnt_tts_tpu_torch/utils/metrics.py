"""The lattice throughput counter, the weak-scaling ratios and a JSON-lines
metrics sink (copies of ssnt_tts_tpu/utils/metrics.py's LatticeThroughput,
weak_scaling_efficiency and MetricsLogger, and scripts/weak_scaling.py's
partition efficiency)."""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, Optional


@dataclasses.dataclass
class LatticeThroughput:
    """Mcells/s for a (B, T, U) forward[-backward] lattice pass."""

    batch: int
    input_length: int
    output_length: int

    @property
    def cells(self) -> int:
        return self.batch * self.input_length * self.output_length

    def mcells_per_s(self, seconds: float) -> float:
        return self.cells / seconds / 1e6


def weak_scaling_efficiency(throughput_1: float, throughput_n: float,
                            n: int) -> float:
    """Throughput on n ranks over n times that on one, the per-rank batch
    held constant; >= 0.9 is the north-star bar (BASELINE.md)."""
    return throughput_n / (throughput_1 * n)


def partition_efficiency(seconds_unsharded: float,
                         seconds_sharded: float) -> float:
    """t(one rank, the total batch) / t(n ranks, the same total batch):
    what the partitioning and its collectives cost at fixed total work.
    Where the ranks share one device it is this cost alone; it claims no
    scaling."""
    return seconds_unsharded / seconds_sharded


class MetricsLogger:
    """Minimal JSONL metrics sink (stdout or file)."""

    def __init__(self, path: Optional[str] = None):
        self._fh = open(path, "a") if path else None
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]):
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update(
            {
                k: (float(v) if hasattr(v, "item") or isinstance(
                    v, (int, float)) else v)
                for k, v in metrics.items()
            }
        )
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line)

    def close(self):
        if self._fh:
            self._fh.close()
