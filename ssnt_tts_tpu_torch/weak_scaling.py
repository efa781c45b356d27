"""Weak-scaling harness of the port (scripts/weak_scaling.py's
counterpart): the per-rank batch held constant while the data-parallel
mesh grows; throughput and efficiency against one rank.

    python -m ssnt_tts_tpu_torch.weak_scaling [--ranks 1 2 4]
        [--per-rank-batch 8] [--steps 5] [--seq T U] [--full]
        [--device cpu] [--json out.json]

For each n the ranks (dryrun.launch, task "time_steps") take sharded train
steps on an n x 1 mesh at a global batch of n times the per-rank batch;
then one rank takes the same total batch. It reports ms a step, examples
a second, utils/metrics.weak_scaling_efficiency against n = 1, and
partition_efficiency, t(one rank, the total batch) / t(n ranks, the same
batch): what the partitioning and its collectives cost at fixed work.

Ranks run on the card (cuda:rank modulo the cards; NCCL when every rank
has a card of its own, else gloo) unless --device names another; the
record names the card and its power limit (nvidia-smi). Where
ranks share a device (several on one card, or the CPU) the classic
efficiency measures their contention, so it is reported as
"weak_scaling_efficiency_contended", and partition_efficiency is the
partition cost alone: neither claims any scaling.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
from typing import Optional

import torch

from ssnt_tts_tpu_torch import dryrun
from ssnt_tts_tpu_torch.utils.config import TrainConfig, tiny_model_config
from ssnt_tts_tpu_torch.utils.metrics import (
    partition_efficiency,
    weak_scaling_efficiency,
)

WORK = pathlib.Path(__file__).resolve().parent.parent / "build" / \
    "weak_scaling"


def timed(n: int, B: int, args, cfg) -> float:
    """ms a sharded step on n ranks at global batch B."""
    T, U = args.seq
    job = {"mesh": (n, 1), "cfg": cfg, "seed": 0, "steps": args.steps,
           "tcfg": TrainConfig(warmup_steps=2, batch_size=B),
           "batch": dryrun.example_batch(cfg, B, T, U)}
    ranks = dryrun.launch("time_steps", job, n, WORK / f"n{n}_b{B}",
                          device=args.device, timeout=600)
    return max(r["ms"] for r in ranks)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--per-rank-batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seq", type=int, nargs=2, default=[80, 400],
                    metavar=("T", "U"))
    ap.add_argument("--full", action="store_true",
                    help="the smoke model's width (dryrun.FULL_CONFIG); "
                    "default tiny_model_config")
    ap.add_argument("--device", help="every rank's device type: 'cpu', "
                    "or the card (default)")
    ap.add_argument("--json", help="write the record to this file")
    args = ap.parse_args(argv)
    cfg = dryrun.FULL_CONFIG if args.full else tiny_model_config()
    cards = 0 if args.device == "cpu" else torch.cuda.device_count()
    device = args.device or subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    record = {"per_rank_batch": args.per_rank_batch, "seq": args.seq,
              "steps": args.steps, "full": args.full, "device": device,
              "cards": cards, "runs": []}
    print(json.dumps({k: v for k, v in record.items() if k != "runs"}),
          flush=True)
    base = None
    for n in args.ranks:
        B = args.per_rank_batch * n
        ms = timed(n, B, args, cfg)
        ms_one = timed(1, B, args, cfg) if n > 1 else ms
        thr = B / ms * 1e3
        base = base or (thr if n == 1 else None)
        shared = n > 1 and n > cards
        eff = weak_scaling_efficiency(base, thr, n) if base else None
        run = {"ranks": n, "ms_per_step": ms, "examples_per_s": thr,
               "ranks_share_a_device": shared,
               "partition_efficiency": partition_efficiency(ms_one, ms)}
        run["weak_scaling_efficiency" + ("_contended" if shared else "")] = (
            eff)
        record["runs"].append(run)
        print(json.dumps(run), flush=True)
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
