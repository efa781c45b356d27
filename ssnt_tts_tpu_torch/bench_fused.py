"""Time the fused decode kernels of one or more checkouts, in turns.

    python3 ssnt_tts_tpu_torch/bench_fused.py [--roots DIR ...] [--json OUT]

For each root (a checkout of this repository; default the one this file
is in), in the order given, the fused steps at chip_smoke.py's model
(decoder 256, mel 80, joint rank 64, bf16, random weights from seed 0)
and batch (B=32, T=80):
  - #15 fused_v1_beam_step at W=1, 8 and 16 on a request's own carry at
    frame 100;
  - #14 fused_class_beam_step (v2) and fused_tone_step at W=8, step 30;
each as device time per call under a CUDA graph (chip_smoke.graph_ms),
eager time per call with a synchronize at the end (chip_smoke.eager_ms)
and host time per call (the wrapper's own cost: the median of 5 runs of
200 calls issued without a synchronize, host clock). Give the roots as
parent, change, change, parent to compare two commits on one card. Each root's package and
chip_smoke.py are imported afresh, so each times its own wrappers and
kernels (built into the root's own build/ directory).

Prints one JSON object per root and call, then the card's name and power
limit; --json writes them all. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def host_us(fn, n: int = 200, reps: int = 5) -> float:
    """Host microseconds per call of fn, issued without a synchronize: the
    median of reps runs of n calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[reps // 2]


def load(root: Path):
    """Import root's chip_smoke and package afresh."""
    for name in list(sys.modules):
        if name == "chip_smoke" or name.startswith("ssnt_tts_tpu_torch"):
            del sys.modules[name]
    sys.path[0] = str(root)
    importlib.invalidate_caches()
    cs = importlib.import_module("chip_smoke")
    beam_fused = importlib.import_module("ssnt_tts_tpu_torch.ops.beam_fused")
    return cs, beam_fused


def bench_root(root: Path, dev) -> dict:
    import numpy as np
    import torch

    cs, beam_fused = load(root)
    from ssnt_tts_tpu_torch import convert
    from ssnt_tts_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(**cs.SERVE_CFG)
    model = cs.make_model(cfg, convert.random_flax_tree(cfg, 0), "bfloat16",
                          dev)
    rng = np.random.default_rng(0)
    req = cs.make_request(rng, cfg.vocab_size, dev)
    toks, il, _ = req
    fns = {}
    for Wn in (1, 8, 16):
        pack, fw, kept = cs.v1_carries(model, toks, il, (100,), Wn, dev)
        c = kept[100]
        args = (pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"],
                c["state"], fw)
        fns[f"fused_v1_step W={Wn}"] = (
            lambda a=args: beam_fused.fused_v1_beam_step(*a))
    sa = cs.step_inputs(model, req, 30, rng, dev)
    fns["fused_v2_step W=8"] = lambda: beam_fused.fused_class_beam_step(*sa)
    ta = cs.tone_step_inputs(model, toks, il, 30, rng, dev)
    fns["fused_tone_step W=8"] = lambda: beam_fused.fused_tone_step(*ta)
    out = {}
    with torch.no_grad():
        for name, fn in fns.items():
            out[name] = {"graph_ms": cs.graph_ms(fn),
                         "eager_ms": cs.eager_ms(fn),
                         "host_us": host_us(fn)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE)])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_fused: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = []
    for i, root in enumerate(args.roots):
        t0 = time.time()
        r = {"call": i, "root": root,
             "kernels": bench_root(Path(root).resolve(), dev),
             "seconds": time.time() - t0}
        print(json.dumps(r), flush=True)
        results.append(r)
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
