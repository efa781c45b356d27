"""Partition efficiency split into nine experiments (the port of
scripts/weak_scaling_triage.py; WEAKSCALE_TRIAGE_r04.json's keys).

partition_efficiency = t(one rank, the total batch B) / t(n data ranks,
the same B). The experiments, under JAX's names:

  A_train        the sharded train step (parallel/train.
                 make_sharded_train_step) against one rank;
  B_fwd_only     the loss alone (no gradient, so no gradient all_reduce;
                 one all_reduce of the scalar loss);
  C_allreduce    a bare all_reduce of a parameter-sized flat float32
                 buffer over the n ranks;
  D_train_4x_batch  A at 4x the batch;
  E_data_x_model A on an (n/2) x 2 mesh, the parameters split over the
                 model axis (ParamShard) as the step stores them;
  F_grad_only    the loss's gradient and its all_reduce, no optimizer;
  G_optimizer_only  ClipAdamW's update on every rank (parameters
                 replicated) against one rank alone;
  H_lattice_grad_only  the lattice loss's gradient alone (models/ssnt.
                 lattice_loss, the model's route: the lattice kernels on
                 the card) on (U, B/n, T) random columns;
  I_model_grad_no_lattice  the gradient of sum(le + ls + lf) from
                 SSNTModel.lattice_quantities (encoder, GRU loop, joints;
                 no lattice walk) and its all_reduce.

Every sharded arm of one n runs in one launch of n ranks (dryrun task
"triage"), the unsharded arms in one launch of one rank. Each arm is
timed by host clock, the mean of --steps calls after a warm one (the
ranks synchronized before and after); a sharded arm's time is its slowest
rank's. The model is JAX's tiny_model_config, or with --full the flagship
ModelConfig(); weights convert.random_flax_tree(cfg, 0); the batch JAX's
(__graft_entry__._example_batch: every utterance at full length, no
targets). Ranks run on the card (NCCL with a card a rank where there are
enough, else gloo with every rank on the one card: then they contend for
it, and the efficiencies measure that contention with the partition) or,
with --cpu, on the CPU. The log names each arm's lattice route (the
kernels it launched a call).

  python -m ssnt_tts_tpu_torch.scripts.weak_scaling_triage --devices 4 \\
      --per-device-batch 8 --full --json triage.json
  python -m ssnt_tts_tpu_torch.scripts.weak_scaling_triage --cpu \\
      --devices 2 --per-device-batch 2 --seq 6 12 --steps 1
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
from ssnt_tts_tpu_torch.models.ssnt import lattice_loss, loss_normalizers
from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
from ssnt_tts_tpu_torch.parallel import multihost
from ssnt_tts_tpu_torch.parallel import train as train_lib
from ssnt_tts_tpu_torch.scripts.decode_scale import card_platform
from ssnt_tts_tpu_torch.utils.config import (
    MeshConfig, ModelConfig, TrainConfig, tiny_model_config,
)
from ssnt_tts_tpu_torch.utils.device import resolve_device
from ssnt_tts_tpu_torch.utils.metrics import partition_efficiency

DEFAULT_JOB_DIR = str(Path(__file__).resolve().parents[2] / "build"
                      / "weak_scaling_triage")
ARMS = ("A_train", "B_fwd_only", "C_allreduce", "D_train_4x_batch",
        "E_data_x_model", "F_grad_only", "G_optimizer_only",
        "H_lattice_grad_only", "I_model_grad_no_lattice")
# The arms that run on one rank as well (E and C only sharded, as JAX's).
UNSHARDED_ARMS = ("A_train", "B_fwd_only", "D_train_4x_batch",
                  "F_grad_only", "G_optimizer_only", "H_lattice_grad_only",
                  "I_model_grad_no_lattice")
LOSS_KEYS = ("tokens", "mel", "input_length", "output_length")


def example_batch(cfg: ModelConfig, B: int, T: int, U: int,
                  seed: int = 0) -> dict:
    """__graft_entry__._example_batch as numpy: random tokens and mel,
    every utterance at full length, no targets."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(1, cfg.vocab_size, (B, T)).astype(
                np.int32),
            "mel": rng.normal(0, 1, (B, U, cfg.mel_dim)).astype(np.float32),
            "input_length": np.full((B,), T, np.int32),
            "output_length": np.full((B,), U, np.int32)}


def lattice_columns(U: int, B: int, T: int, seed: int = 0) -> tuple:
    """Arm H's (U, B, T) lattice, as JAX's script draws it (numpy)."""
    rng = np.random.default_rng(seed)
    le = np.log(rng.uniform(0.1, 0.9, (U, B, T))).astype(np.float32)
    return (le, np.log1p(-np.exp(le)).astype(np.float32),
            rng.normal(0, 0.5, (U, B, T)).astype(np.float32))


# ------------------------------------------------------------- the arms


def forward_loss(model, batch: dict, normalizers=None) -> torch.Tensor:
    """Arm B's work: the training loss of `batch` (model.loss without
    targets, JAX's call), divided by `normalizers` ([batch size, valid
    tokens] of the global batch; by default the batch's own)."""
    kw = {} if normalizers is None else dict(
        batch_size=int(normalizers[0]), token_count=normalizers[1])
    return model.loss(*(batch[k] for k in LOSS_KEYS), **kw)[0]


def loss_grads(model, batch: dict, normalizers=None) -> list:
    """Arm F's work: the gradient of forward_loss, one tensor a
    parameter (zeros where the loss does not reach)."""
    params = list(model.parameters())
    grads = torch.autograd.grad(forward_loss(model, batch, normalizers),
                                params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def lattice_grads(cfg: ModelConfig, le, ls, lf) -> tuple:
    """Arm H's work: the gradient of the summed lattice loss (the model's
    lattice route, models/ssnt.lattice_loss, every example at full
    length) in its three (U, B, T) inputs."""
    U, B, T = le.shape
    xs = [x.detach().requires_grad_() for x in (le, ls, lf)]
    full = lambda n: torch.full((B,), n, dtype=torch.int32, device=le.device)
    loss = lattice_loss(cfg.lattice_impl, cfg.lattice_dtype, xs, full(T),
                        full(U), cfg.lattice_domain)
    return torch.autograd.grad(loss.sum(), xs)


def quantity_grads(model, batch: dict) -> list:
    """Arm I's work: the gradient of sum(le) + sum(ls) + sum(lf) of
    SSNTModel.lattice_quantities (encoder, teacher-forced GRU loop, joints;
    no lattice walk), one tensor a parameter."""
    enc = model.encode(batch["tokens"], batch["input_length"])
    dec = model.decoder_states(batch["mel"])
    q = model.lattice_quantities(enc, dec, batch["mel"])
    params = list(model.parameters())
    grads = torch.autograd.grad(sum(x.float().sum() for x in q[:3]), params,
                                allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def optimizer_update(tx, grads: list, opt_state, params: list) -> None:
    """Arm G's work: one ClipAdamW update of `params` in place."""
    tx.update(grads, opt_state, params)


# ------------------------------------------------------- the ranks' task


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(fn, steps: int, dev) -> dict:
    """fn's mean host-clock ms over `steps` calls after a warm one, the
    ranks synchronized around the timed calls, and the kernel launches of
    one call."""
    before = dryrun.launch_counts()
    fn()
    _sync(dev)
    launches = {k: v - before[k] for k, v in dryrun.launch_counts().items()
                if v != before[k]}
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / max(steps, 1)
    dist.barrier()
    return {"ms": ms, "launches": launches}


def _flat_all_reduce(tensors: list, group) -> None:
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)


def rank_task(job, device) -> dict:
    """dryrun task "triage". job: cfg, seq (T, U), batch and batch4 (the
    global batches of A and D, numpy), lattice (arm H's global columns),
    arms, steps. Runs each arm in `arms` on this rank's rows of a data
    mesh over every rank (E: an (n/2) x 2 mesh); returns {arm: {"ms",
    "launches"}} (C also "param_count")."""
    world = dist.get_world_size()
    mesh = mesh_lib.make_mesh(MeshConfig(data=world, model=1), device=device)
    dev = mesh.device
    cfg, steps = job["cfg"], job["steps"]
    group = mesh.groups["data"]
    sharded = world > 1
    rows = lambda b: {k: torch.as_tensor(v[mesh.rows(len(v))], device=dev)
                      for k, v in b.items()}
    out = {}

    def train_arm(gbatch, run_mesh):
        B = len(gbatch["tokens"])
        tcfg = TrainConfig(warmup_steps=2, batch_size=B)
        state = train_lib.init_train_state(cfg, tcfg, seed=0, device=dev)
        step_fn, state = train_lib.make_sharded_train_step(
            train_lib.make_optimizer(tcfg), run_mesh, state)
        batch = {k: mesh_lib.data_sharding(run_mesh, v)
                 for k, v in gbatch.items()}
        box = [state]

        def step():
            box[0], _ = step_fn(box[0], batch)
        return _timed(step, steps, dev)

    model = dryrun.make_model(cfg, None, 0, dev)
    batch = rows(job["batch"])
    counts = loss_normalizers(
        torch.as_tensor(job["batch"]["tokens"], device=dev),
        torch.as_tensor(job["batch"]["input_length"], device=dev))
    for arm in job["arms"]:
        if arm == "A_train":
            out[arm] = train_arm(job["batch"], mesh)
        elif arm == "D_train_4x_batch":
            out[arm] = train_arm(job["batch4"], mesh)
        elif arm == "E_data_x_model":
            out[arm] = train_arm(job["batch"], mesh_lib.make_mesh(
                MeshConfig(data=world // 2, model=2), device=device))
        elif arm == "B_fwd_only":
            def fwd():
                with torch.no_grad():
                    loss = forward_loss(model, batch, counts)
                    if sharded:
                        dist.all_reduce(loss, group=group)
            out[arm] = _timed(fwd, steps, dev)
        elif arm == "F_grad_only":
            def grad():
                g = loss_grads(model, batch, counts)
                if sharded:
                    _flat_all_reduce(g, group)
            out[arm] = _timed(grad, steps, dev)
        elif arm == "I_model_grad_no_lattice":
            def qgrad():
                g = quantity_grads(model, batch)
                if sharded:
                    _flat_all_reduce(g, group)
            out[arm] = _timed(qgrad, steps, dev)
        elif arm == "H_lattice_grad_only":
            cols = [torch.as_tensor(x, device=dev)[
                :, mesh.rows(x.shape[1])].contiguous()
                for x in job["lattice"]]
            out[arm] = _timed(lambda: lattice_grads(cfg, *cols), steps, dev)
        elif arm == "G_optimizer_only":
            tx = train_lib.make_optimizer(TrainConfig(warmup_steps=2))
            params = [p.detach() for p in model.parameters()]
            opt_state = tx.init(params)
            grads = [torch.full_like(p, 1e-3) for p in params]
            out[arm] = _timed(
                lambda: optimizer_update(tx, [g.clone() for g in grads],
                                         opt_state, params), steps, dev)
        elif arm == "C_allreduce":
            n = sum(p.numel() for p in model.parameters())
            buf = torch.ones(n, device=dev)
            out[arm] = _timed(lambda: dist.all_reduce(buf, group=group),
                              steps, dev)
            out[arm]["param_count"] = n
        else:
            raise ValueError(f"unknown arm {arm!r}")
    return out


# --------------------------------------------------------------- the tool


def lattice_route(launches: dict) -> str:
    """The lattice kernels a call launched, by name ("plain" when none)."""
    names = [k.replace("lattice_", "") for k in sorted(launches)
             if k.startswith("lattice_")]
    return " + ".join(f"{k} x{launches['lattice_' + k]}" for k in names) \
        or "plain"


def main(argv=None, outputs=None) -> dict:
    """Runs the experiments and returns the record. A dict `outputs`
    receives each launch's per-rank results ("sharded", "unsharded")."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=8)
    p.add_argument("--per-device-batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seq", type=int, nargs=2, default=[32, 80],
                   metavar=("T", "U"))
    p.add_argument("--full", action="store_true",
                   help="the flagship ModelConfig() (default: JAX's "
                   "tiny_model_config)")
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--job-dir", type=str, default=DEFAULT_JOB_DIR)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    resolve_device("cpu" if args.cpu else None)
    n = args.devices
    if n < 2 or n % 2:
        raise ValueError(f"--devices {n}: E needs an even count >= 2")
    cfg = ModelConfig() if args.full else tiny_model_config()
    T, U = args.seq
    B = args.per_device_batch * n
    job = {"cfg": cfg, "steps": args.steps,
           "batch": example_batch(cfg, B, T, U),
           "batch4": example_batch(cfg, 4 * B, T, U),
           "lattice": lattice_columns(U, B, T)}
    device = "cpu" if args.cpu else None
    t_start = time.time()
    res = {}
    for name, world, arms in (("sharded", n, ARMS),
                              ("unsharded", 1, UNSHARDED_ARMS)):
        backend = "gloo" if args.cpu else multihost.default_backend(world)
        res[name] = dryrun.launch(
            "triage", {**job, "arms": arms}, world,
            Path(args.job_dir) / name, device=device, backend=backend,
            timeout=900)
        for arm in arms:
            r0 = res[name][0][arm]
            print(f"[triage] {name} {arm}: "
                  f"{max(r[arm]['ms'] for r in res[name]):.2f} ms "
                  f"(lattice route a call: {lattice_route(r0['launches'])})",
                  flush=True)
    if outputs is not None:
        outputs.update(res)
    ms = lambda name, arm: max(r[arm]["ms"] for r in res[name])
    eff = lambda arm: {
        "sharded_ms": round(ms("sharded", arm), 2),
        "unsharded_ms": round(ms("unsharded", arm), 2),
        "partition_efficiency": round(partition_efficiency(
            ms("unsharded", arm), ms("sharded", arm)), 3)}
    shared = not args.cpu and n > torch.cuda.device_count()
    platform = "cpu" if args.cpu else card_platform()
    record = {
        "devices": n, "seq": args.seq,
        "per_device_batch": args.per_device_batch,
        "platform": platform + (f"; {n} gloo ranks share one card "
                                "(contended)" if shared else ""),
        "experiments": {
            "A_train": eff("A_train"),
            "B_fwd_only": eff("B_fwd_only"),
            "C_allreduce": {
                "ms": round(ms("sharded", "C_allreduce"), 3),
                "param_count": res["sharded"][0]["C_allreduce"][
                    "param_count"]},
            "D_train_4x_batch": eff("D_train_4x_batch"),
            "E_data_x_model": {
                "sharded_ms": round(ms("sharded", "E_data_x_model"), 2),
                "partition_efficiency_vs_unsharded": round(
                    partition_efficiency(ms("unsharded", "A_train"),
                                         ms("sharded", "E_data_x_model")),
                    3)},
            "F_grad_only": eff("F_grad_only"),
            "G_optimizer_only": {
                "replicated_on_n_ms": round(
                    ms("sharded", "G_optimizer_only"), 2),
                "single_device_ms": round(
                    ms("unsharded", "G_optimizer_only"), 2),
                "slowdown": round(ms("sharded", "G_optimizer_only")
                                  / ms("unsharded", "G_optimizer_only"), 2)},
            "H_lattice_grad_only": eff("H_lattice_grad_only"),
            "I_model_grad_no_lattice": eff("I_model_grad_no_lattice"),
        },
    }
    print(f"[triage] {n} ranks, {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps(record, indent=1), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
    sys.exit(0)
