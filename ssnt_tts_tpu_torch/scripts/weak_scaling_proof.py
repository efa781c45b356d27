"""The total work of the sharded train step against the unsharded one
(the port of scripts/weak_scaling_proof.py; WEAKSCALE_PROOF_r05.json's
keys).

The total batch stays fixed (--per-device-batch times the largest of
--devices) while the data mesh grows over n = --devices. If the partition
added work, the ranks' FLOPs summed would grow with n; if it is clean,
they equal the one-rank step's, and the added work is the collectives.
For each n, n ranks (dryrun task "proof") each run one sharded step
(parallel/train.make_sharded_train_step) under
torch.utils.flop_counter.FlopCounterMode, which counts this rank's
matrix products (forward, backward and the GRU loop's recomputation), in
place of XLA's cost_analysis(); the step's own counters give its
all_reduces (JAX read 168 from its HLO; the port makes 2 a step); then
--steps steps are timed by host clock after a warm one.

What the counter does not see: the CUDA lattice kernels (called through
ctypes) and every elementwise operation (the lattice's plain walk on the
CPU, activations, the optimizer). XLA's cost model counts elementwise
operations too, so the absolute FLOPs do not compare with JAX's; the
ratio to the unsharded step does.

The model is JAX's tiny_model_config, or with --full the flagship
ModelConfig(); weights convert.random_flax_tree(cfg, 0); the batch JAX's
(every utterance at full length, no targets). Ranks run on the card (NCCL
with a card a rank where there are enough, else gloo with every rank on
the one card, contended) or, with --cpu, on the CPU.

  python -m ssnt_tts_tpu_torch.scripts.weak_scaling_proof --devices 1 2 4 \\
      --per-device-batch 8 --full --json proof.json
  python -m ssnt_tts_tpu_torch.scripts.weak_scaling_proof --cpu \\
      --devices 1 2 --per-device-batch 2 --seq 6 12 --steps 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from ssnt_tts_tpu_torch import dryrun
from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
from ssnt_tts_tpu_torch.parallel import multihost
from ssnt_tts_tpu_torch.parallel import train as train_lib
from ssnt_tts_tpu_torch.scripts.decode_scale import card_platform
from ssnt_tts_tpu_torch.scripts.weak_scaling_triage import example_batch
from ssnt_tts_tpu_torch.utils.config import (
    MeshConfig, ModelConfig, TrainConfig, tiny_model_config,
)
from ssnt_tts_tpu_torch.utils.device import resolve_device

DEFAULT_JOB_DIR = str(Path(__file__).resolve().parents[2] / "build"
                      / "weak_scaling_proof")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rank_task(job, device) -> dict:
    """dryrun task "proof". job: cfg, batch (global, numpy), steps. One
    sharded step over a data mesh of every rank under FlopCounterMode,
    then `steps` timed steps; returns this rank's FLOPs, all_reduces and
    all_gathers a step, host-clock ms a step, kernel launches of the
    counted step, and the counted step's loss."""
    world = dist.get_world_size()
    mesh = mesh_lib.make_mesh(MeshConfig(data=world, model=1), device=device)
    dev = mesh.device
    B = len(job["batch"]["tokens"])
    tcfg = TrainConfig(warmup_steps=2, batch_size=B)
    state = train_lib.init_train_state(job["cfg"], tcfg, seed=0, device=dev)
    step_fn, state = train_lib.make_sharded_train_step(
        train_lib.make_optimizer(tcfg), mesh, state)
    batch = {k: mesh_lib.data_sharding(mesh, v)
             for k, v in job["batch"].items()}
    before = dryrun.launch_counts()
    with FlopCounterMode(display=False) as counter:
        state, metrics = step_fn(state, batch)
        _sync(dev)
    launches = {k: v - before[k] for k, v in dryrun.launch_counts().items()
                if v != before[k]}
    ar, ag = step_fn.all_reduces, step_fn.all_gathers
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(job["steps"]):
        state, _ = step_fn(state, batch)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(job["steps"], 1)
    dist.barrier()
    return {"flops": int(counter.get_total_flops()), "ms": ms,
            "all_reduces": ar, "all_gathers": ag, "launches": launches,
            "loss": float(metrics["loss"])}


def main(argv=None, outputs=None) -> dict:
    """Runs each mesh size and returns the record. A dict `outputs`
    receives each n's per-rank results (by n)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--per-device-batch", type=int, default=32)
    p.add_argument("--seq", type=int, nargs=2, default=[32, 80])
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--full", action="store_true",
                   help="the flagship ModelConfig() (default: JAX's "
                   "tiny_model_config)")
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--job-dir", type=str, default=DEFAULT_JOB_DIR)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    resolve_device("cpu" if args.cpu else None)
    cfg = ModelConfig() if args.full else tiny_model_config()
    T, U = args.seq
    B = args.per_device_batch * max(args.devices)
    batch = example_batch(cfg, B, T, U)
    shared = (not args.cpu
              and max(args.devices) > torch.cuda.device_count())
    platform = "cpu" if args.cpu else card_platform()
    record = {
        "total_batch": B, "seq": args.seq,
        "platform": platform + ("; ranks share one card over gloo "
                                "(contended)" if shared else ""),
        "method": (
            "torch.utils.flop_counter.FlopCounterMode per rank over one "
            "sharded step (matrix products of the forward, the backward "
            "and the GRU loop's recomputation) x n vs the one-rank step; "
            "all_reduces from the step's own counter (parallel/train "
            "step_fn.all_reduces; JAX's HLO held 168). Not counted: the "
            "CUDA lattice kernels (ctypes) and every elementwise "
            "operation, which XLA's cost model counts, so only the ratio "
            "compares with JAX's"),
        "runs": [],
    }
    base = None
    got = {}
    for n in args.devices:
        backend = "gloo" if args.cpu else multihost.default_backend(n)
        ranks = dryrun.launch(
            "proof", {"cfg": cfg, "batch": batch, "steps": args.steps}, n,
            Path(args.job_dir) / f"n{n}", device="cpu" if args.cpu else None,
            backend=backend, timeout=900)
        got[n] = ranks
        per_dev = ranks[0]["flops"]
        total = sum(r["flops"] for r in ranks)
        ms = max(r["ms"] for r in ranks)
        base = base or {"flops": total, "ms": ms}
        run = {
            "devices": n,
            "per_device_flops": per_dev,
            "total_flops": total,
            "total_flops_vs_unsharded": round(total / base["flops"], 6),
            "allreduce_ops": ranks[0]["all_reduces"],
            "ms_per_step": round(ms, 2),
            "wall_vs_unsharded": round(base["ms"] / ms, 3),
        }
        record["runs"].append(run)
        print(f"[proof] n={n}: per-rank flops {per_dev:.4e}, total x "
              f"{run['total_flops_vs_unsharded']:.6f}, all_reduces "
              f"{run['allreduce_ops']} a step, {ms:.1f} ms a step "
              f"({backend})", flush=True)
    if outputs is not None:
        outputs.update(got)
    r = record["runs"]
    if len(r) > 1:
        growth = max(abs(x["total_flops_vs_unsharded"] - 1) for x in r[1:])
        record["conclusion"] = (
            f"total counted FLOPs constant to within {100 * growth:.4f}% "
            f"across mesh sizes while wall-clock moves "
            f"{r[-1]['ms_per_step'] / r[0]['ms_per_step']:.2f}x -> the "
            "data partition adds no matrix work; the only added work is "
            f"the step's {r[-1]['allreduce_ops']} all_reduces"
            + (" (ranks sharing one card contend for it: the wall clock "
               "measures that, not scaling)" if shared else ""))
    print(json.dumps(record, indent=1), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
    sys.exit(0)
