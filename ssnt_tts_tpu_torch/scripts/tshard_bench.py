"""The T-sharded lattice ring against the unsharded loss (the port of
scripts/tshard_bench.py; TSHARD_r05.json's keys).

ops/lattice_sharded.ssnt_loss_tsharded forward + backward on n ranks over
the mesh's model axis (dryrun task "tshard_bench": one launch of n ranks
sweeps every block for that n), at each pipeline block K that divides U:
the ring's hops a walk (its own count, asserted to equal
lattice_sharded.hops_per_walk and JAX's U/K + (n - 1 if K > 1)), one group
sum a forward, K * B * 4 bytes a hop, and ms a gradient. The baseline is
the unsharded loss of the same lattice on one rank, this process, on the
lattice kernels (ops/lattice_kernels.ssnt_loss_kernels; #8 lattice_bidir
at the default shape on the card, its plain version on the CPU).

One arm beyond JAX's: the time of one bare hop of K * B * 4 bytes through
the ring's own transport (lattice_sharded.ring_hop; with gloo and CUDA
tensors through host memory, as the ring hops), so that the hops of a
gradient (2 walks) times that time can be set beside ms_per_grad.

Ranks run on the card (NCCL with a card a rank where there are enough
cards, else gloo with every rank on the one card) or, with --cpu, on the
CPU under gloo. Times are host-clock means over --steps calls after a
warm one, each span ending in a synchronize; a sharded run's time is its
slowest rank's. Inputs are JAX's: numpy default_rng(0), le = log U(0.1,
0.9), ls = log(1 - e^le), lf ~ N(0, 0.5), every example at full length.

  python -m ssnt_tts_tpu_torch.scripts.tshard_bench --json tshard.json
  python -m ssnt_tts_tpu_torch.scripts.tshard_bench --cpu --devices 2 \\
      --shape 24 2 8 --blocks 1 4 --steps 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ssnt_tts_tpu_torch import dryrun
from ssnt_tts_tpu_torch.ops import lattice_kernels, lattice_sharded
from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
from ssnt_tts_tpu_torch.parallel import multihost
from ssnt_tts_tpu_torch.scripts.decode_scale import card_platform
from ssnt_tts_tpu_torch.utils.config import MeshConfig
from ssnt_tts_tpu_torch.utils.device import resolve_device

DEFAULT_JOB_DIR = str(Path(__file__).resolve().parents[2] / "build"
                      / "tshard_bench")
BARE_HOPS = 50  # hops a bare-hop timing averages


def lattice_inputs(U: int, B: int, T: int) -> dict:
    """JAX's script's lattice and lengths, as numpy."""
    rng = np.random.default_rng(0)
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    return {"le": le, "ls": np.log1p(-np.exp(le)).astype(np.float32),
            "lf": rng.normal(0, 0.5, (U, B, T)).astype(np.float32),
            "il": np.full((B,), T, np.int32),
            "ol": np.full((B,), U, np.int32)}


def jax_hops(U: int, n: int, block: int) -> int:
    """JAX's script's ppermutes a forward walk."""
    return U // block + (n - 1 if block > 1 else 0)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_grad(loss_fn, xs, steps: int, dev):
    """(mean ms of a forward + backward of loss_fn(*leaves).sum() over
    `steps` calls after a warm one, the last call's (loss, grads))."""
    def call():
        leaves = [x.clone().requires_grad_() for x in xs]
        loss = loss_fn(*leaves)
        loss.sum().backward()
        return loss.detach(), [x.grad for x in leaves]

    out = call()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        out = call()
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / max(steps, 1), out


def rank_task(job, device) -> dict:
    """dryrun task "tshard_bench". job: mesh (1, n), the lattice (numpy,
    lattice_inputs' keys), blocks, steps. Per block: this rank's ms a ring
    gradient, the counts of one call, rank 0's loss and gradients, and the
    mean ms of a bare hop of block * B float32."""
    d, m = job["mesh"]
    mesh = mesh_lib.make_mesh(MeshConfig(data=d, model=m), device=device)
    dev = mesh.device
    xs = [torch.as_tensor(job[k], device=dev) for k in ("le", "ls", "lf")]
    il, ol = (torch.as_tensor(job[k], device=dev) for k in ("il", "ol"))
    B = xs[0].shape[1]
    out = []
    for block in job["blocks"]:
        loss_fn = lambda *a: lattice_sharded.ssnt_loss_tsharded(
            *a, il, ol, mesh, block=block)
        dist.barrier()
        ms, (loss, grads) = timed_grad(loss_fn, xs, job["steps"], dev)
        lattice_sharded.reset_counts()
        loss_fn(*[x.clone().requires_grad_() for x in xs]).sum().backward()
        counts = dict(lattice_sharded.COUNTS)
        hop = torch.zeros(block, B, device=dev)
        lattice_sharded.ring_hop(hop, mesh)  # warm
        _sync(dev)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(BARE_HOPS):
            lattice_sharded.ring_hop(hop, mesh)
        _sync(dev)
        hop_ms = (time.perf_counter() - t0) * 1e3 / BARE_HOPS
        lattice_sharded.reset_counts()
        row = {"block": block, "ms": ms, "counts": counts,
               "bare_hop_ms": hop_ms}
        if mesh.rank == 0:
            row["loss"] = loss.cpu().numpy()
            row["grads"] = [g.cpu().numpy() for g in grads]
        out.append(row)
    return {"rank": mesh.rank, "runs": out}


def main(argv=None, outputs=None) -> dict:
    """Runs the sweep and returns the record. A dict `outputs` receives the
    inputs (numpy), the unsharded loss and gradients ("unsharded", on this
    process's device) and each run's rank-0 loss and gradients ("runs",
    numpy, in the record's order)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, nargs="+", default=[2, 4, 8],
                   help="shard counts (ranks)")
    p.add_argument("--shape", type=int, nargs=3, default=[400, 8, 64],
                   metavar=("U", "B", "T"))
    p.add_argument("--steps", type=int, default=6)
    p.add_argument("--blocks", type=int, nargs="+",
                   default=[1, 8, 16, 40, 80, 100])
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--job-dir", type=str, default=DEFAULT_JOB_DIR)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    U, B, T = args.shape
    blocks = [k for k in args.blocks if U % k == 0]
    x = lattice_inputs(U, B, T)
    xs = [torch.as_tensor(x[k], device=dev) for k in ("le", "ls", "lf")]
    il, ol = (torch.as_tensor(x[k], device=dev) for k in ("il", "ol"))
    ms_un, unsharded = timed_grad(
        lambda *a: lattice_kernels.ssnt_loss_kernels(*a, il, ol,
                                                     layout="ubt"),
        xs, args.steps, dev)
    mode = lattice_kernels.grad_mode("log", B, T)[0]
    print(f"[tshard_bench] unsharded kernel loss ({mode}) U={U} B={B} "
          f"T={T}: {ms_un:.3f} ms a gradient", flush=True)
    platform = "cpu" if args.cpu else card_platform()
    record = {
        "shape": {"U": U, "B": B, "T": T},
        "platform": platform,
        "unsharded_xla_ms": round(ms_un, 3),
        "comm_structure_note": (
            "per run: block=K => U/K + n - 1 ring hops (send / recv) of "
            "K*B*4 bytes plus ONE group sum per forward (block 1: U hops); "
            "the backward mirrors the ring and ends in one all_gather of "
            "the gradients; unsharded_xla_ms is the unsharded loss on the "
            f"lattice kernels ({mode} route; the plain version on the CPU)"),
        "note": (
            "ranks on " + ("the CPU (gloo)" if args.cpu else
                           "one card when there are fewer cards than ranks "
                           "(gloo: hops through host memory, contended)")
            + "; bare_hop_ms is one hop of bytes_per_hop alone through the "
            "same transport, hops_ms = 2 walks x ppermutes_per_fwd x "
            "bare_hop_ms"),
        "runs": [],
    }
    got_runs = []
    for n in args.devices:
        backend = "gloo" if args.cpu else multihost.default_backend(n)
        job = {"mesh": (1, n), **x, "blocks": blocks, "steps": args.steps}
        ranks = dryrun.launch("tshard_bench", job, n,
                              Path(args.job_dir) / f"n{n}",
                              device="cpu" if args.cpu else None,
                              backend=backend, timeout=600)
        for i, blk in enumerate(blocks):
            rows = [r["runs"][i] for r in ranks]
            hops = rows[0]["counts"]["hops_forward"]
            want = lattice_sharded.hops_per_walk(U, n, blk)
            if hops != want or want != jax_hops(U, n, blk) or any(
                    r["counts"] != rows[0]["counts"] for r in rows) or (
                    rows[0]["counts"]["hops_backward"] != hops
                    or rows[0]["counts"]["all_reduce"] != 1):
                raise AssertionError(
                    f"n={n} block={blk}: counts {rows[0]['counts']}, want "
                    f"{want} hops a walk (JAX {jax_hops(U, n, blk)})")
            ms = max(r["ms"] for r in rows)
            hop_ms = max(r["bare_hop_ms"] for r in rows)
            run = {"shards": n, "block": blk, "ppermutes_per_fwd": hops,
                   "psums_per_fwd": rows[0]["counts"]["all_reduce"],
                   "bytes_per_hop": blk * B * 4,
                   "ms_per_grad": round(ms, 3),
                   "vs_unsharded": round(ms_un / ms, 4),
                   "bare_hop_ms": round(hop_ms, 4),
                   "hops_ms": round(2 * hops * hop_ms, 3),
                   "hops_share": round(2 * hops * hop_ms / ms, 3)}
            record["runs"].append(run)
            got_runs.append({"loss": rows[0]["loss"],
                             "grads": rows[0]["grads"]})
            print(f"[tshard_bench] shards={n} block={blk}: {ms:.2f} ms "
                  f"(unsharded {ms_un:.3f}), {hops} hops a walk of "
                  f"{blk * B * 4} B, bare hop {hop_ms:.4f} ms, hops x bare "
                  f"hop {run['hops_ms']:.2f} ms ({run['hops_share']:.3f} "
                  f"of the gradient)", flush=True)
    if outputs is not None:
        outputs.update(inputs=x, unsharded=unsharded, runs=got_runs)
    print(json.dumps(record, indent=1), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
    sys.exit(0)
