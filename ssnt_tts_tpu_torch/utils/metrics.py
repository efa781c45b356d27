"""JSON-lines metrics sink (a copy of ssnt_tts_tpu/utils/metrics.py's
MetricsLogger)."""

from __future__ import annotations

import json
import time
from typing import Dict, Optional


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
