"""Multi-rank dry run of the port, and the one entry that runs its ranks.

The counterpart of __graft_entry__.dryrun_multichip. On an n-rank (data,
model) mesh (model 2 when n is even, as JAX's) it runs one sharded train
step, then the v2 decode on its plain and fused routes, the tone decode
and the v1 beam_decode, each on the data rank's rows with beams
rank-local, then the T-sharded lattice against ops/lattice.ssnt_loss.

    torchrun --nproc-per-node 4 -m ssnt_tts_tpu_torch.dryrun [--device cpu]
    python -m ssnt_tts_tpu_torch.dryrun --init file:///tmp/rdv --world 4 \\
        --rank R [--device cpu]          # one rank; start all of them

Each rank runs on the card (cuda:LOCAL_RANK modulo the cards) unless
--device names another; without a card it raises.

`launch` starts the ranks of a task with torch.multiprocessing (start
method "spawn", so a parent that has initialized CUDA may call it), each
running `run_rank` as __main__ does, under a deadline; a rank that fails
or overruns fails the launch. The tasks (TASKS) take a job (a dict,
pickled into the job directory) and return a picklable result per rank:
  dryrun      the dry run above;
  lattice     ring losses and gradients of given lattices (and the exp
              domain's hook through models/ssnt.lattice_loss);
  steps       sharded train steps of given configurations and batches;
  decode      the four decodes on this rank's rows;
  run_training  train_loop.run_training over a mesh;
  time_steps  timed sharded steps (weak_scaling.py);
  probe       the collectives on this device, and send / recv as the
              ring does them.
A module-level function of (job, device) may stand in for a task's name.
The one-process references the ranks are held to: `halves_step` (the
sharded step's arithmetic over two data ranks, with the lattice on the
ring or not) and `decode_routes` (the four decodes by name).
"""

from __future__ import annotations

import argparse
import contextlib
import pathlib
import pickle
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import (
    SSNTModel,
    lattice_loss,
    loss_normalizers,
)
from ssnt_tts_tpu_torch.ops import beam_fused, lattice, lattice_kernels
from ssnt_tts_tpu_torch.ops import lattice_sharded
from ssnt_tts_tpu_torch.parallel import decode as decode_lib
from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
from ssnt_tts_tpu_torch.parallel import multihost
from ssnt_tts_tpu_torch.parallel import train as train_lib
from ssnt_tts_tpu_torch.utils.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
    tiny_model_config,
)

# The smoke model (chip_smoke.py's SERVE_CFG at ModelConfig's defaults
# otherwise: 10 duration classes, bf16 compute).
FULL_CONFIG = ModelConfig(vocab_size=128, mel_dim=80, encoder_dim=256,
                          encoder_layers=2, encoder_heads=4, decoder_dim=256,
                          joint_rank=64)

# -------------------------------------------------------------- helpers


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def make_model(cfg: ModelConfig, params: Optional[dict], seed: int,
               device) -> SSNTModel:
    """SSNTModel with a flax tree's weights (or convert.random_flax_tree's
    for `seed`), in eval mode."""
    model = SSNTModel(cfg, device=device)
    tree = params if params is not None else convert.random_flax_tree(
        cfg, seed)
    model.load_state_dict(convert.flax_to_torch(tree, cfg))
    return model.eval()


def launch_counts() -> Dict[str, int]:
    """Launch counts of the kernels the sharded paths run."""
    counts = {k.__name__: k.launches for k in lattice_kernels.KERNELS}
    for k in (beam_fused.fused_class_beam_step, beam_fused.fused_tone_step,
              beam_fused.fused_v1_beam_step):
        counts[k.__name__] = k.launches
    return counts


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def example_batch(cfg: ModelConfig, B: int, T: int, U: int,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """__graft_entry__._example_batch's tokens and mel, with ragged
    lengths spread unevenly over the rows (the first half's utterances
    longer than the second's; row 0 at full length) and duration and tone
    targets."""
    rng = np.random.default_rng(seed)
    half = np.arange(B) < B // 2
    il = np.where(half, rng.integers(T - T // 4, T + 1, B),
                  rng.integers(max(2, T // 4), T // 2 + 1, B))
    ol = np.minimum(U, np.maximum(il, np.round(
        il * rng.uniform(0.8, 1.0, B) * U / T))).astype(np.int32)
    il[0], ol[0] = T, U
    return {
        "tokens": rng.integers(1, cfg.vocab_size, (B, T)).astype(np.int32),
        "mel": rng.normal(0, 1, (B, U, cfg.mel_dim)).astype(np.float32),
        "input_length": il.astype(np.int32),
        "output_length": ol,
        "duration_target": rng.integers(
            0, cfg.duration_class_size, (B, T)).astype(np.int32),
        "tone_target": rng.integers(
            0, cfg.tone_class_size, (B, T)).astype(np.int32),
    }


def _mesh(job, device) -> mesh_lib.Mesh:
    d, m = job["mesh"]
    return mesh_lib.make_mesh(MeshConfig(data=d, model=m), device=device)


def decode_routes(model: SSNTModel, toks, il, ol, beam_width: int,
                  max_frames: int) -> dict:
    """The four decodes the sharded paths run, as thunks by name: the v2
    decode on its fused ("v2") and plain ("v2_plain") routes, the tone
    decode and the v1 beam_decode, on the route each takes by default."""
    cfg, W = model.config, beam_width
    return {
        "v2": lambda: decode_lib.v2_duration_decode(
            model, toks, il, ol, cfg.duration_table, beam_width=W,
            max_frames=max_frames),
        "v2_plain": lambda: decode_lib.v2_duration_decode(
            model, toks, il, ol, cfg.duration_table, beam_width=W,
            max_frames=max_frames, fuse_model=False, use_pallas=False),
        "tone": lambda: decode_lib.tone_decode(model, toks, il,
                                               beam_width=W),
        "v1": lambda: decode_lib.beam_decode(model, toks, il,
                                             max_frames=max_frames,
                                             beam_width=W),
    }


def halves_step(tx, state: train_lib.TrainState,
                batch: Dict[str, torch.Tensor], ring: bool = False):
    """The one-process reference of a sharded step over two data ranks:
    the loss of each of the batch's two row halves with the whole batch's
    normalizers, the gradients summed in autograd's buffers (the
    arithmetic of a two-rank data group's all_reduce), the metrics summed,
    one update. ring: every lattice goes through ops/lattice_sharded's ring
    on a one-rank mesh of this process (the sharded step's dispatch and
    float32 upcast, nothing to exchange), as under
    lattice_tshard_min_cells=0. Returns (state, metrics), as train_step."""
    model = state.model
    model.train()
    params = list(model.parameters())
    for p in params:
        p.grad = None
    B = len(batch["tokens"])
    counts = loss_normalizers(batch["tokens"], batch.get("input_length"))
    one = mesh_lib.Mesh(shape={"data": 1, "model": 1}, rank=0,
                        device=counts.device, backend="none",
                        groups={"data": None, "model": None},
                        ranks={"data": (0,), "model": (0,)})
    metrics = {}
    for rows in (slice(0, B // 2), slice(B // 2, B)):
        with (lattice_sharded.tshard_lattice(one, "model", 0) if ring
              else contextlib.nullcontext()):
            loss, m = model.loss(
                *(batch[k][rows] if k in batch else None
                  for k in train_lib.BATCH_KEYS),
                batch_size=int(counts[0]), token_count=counts[1])
            loss.backward()
        for k, v in m.items():
            metrics[k] = metrics[k] + v.detach() if k in metrics else (
                v.detach())
    metrics["grad_norm"] = tx.update([p.grad for p in params],
                                     state.opt_state,
                                     [p.detach() for p in params])
    for p in params:
        p.grad = None
    state.step += 1
    return state, metrics


# ---------------------------------------------------------------- tasks


def lattice_task(job, device) -> dict:
    """job: mesh (d, m); cases: [{le, ls, lf, il, ol (numpy), blocks}];
    exp_cases: [{E, S, F, mcol, il, ol}]. Per case and block: the ring's
    loss, its gradients and the hops of each walk."""
    mesh = _mesh(job, device)
    dev = mesh.device
    out = {"cases": [], "exp_cases": []}
    for case in job["cases"]:
        il, ol = (torch.as_tensor(case[k], device=dev) for k in ("il", "ol"))
        rows = []
        for block in case["blocks"]:
            xs = [torch.tensor(case[k], device=dev, requires_grad=True)
                  for k in ("le", "ls", "lf")]
            lattice_sharded.reset_counts()
            loss = lattice_sharded.ssnt_loss_tsharded(*xs, il, ol, mesh,
                                                      block=block)
            loss.sum().backward()
            rows.append({"block": block, "loss": _host(loss),
                         "grads": [_host(x.grad) for x in xs],
                         "counts": dict(lattice_sharded.COUNTS)})
        out["cases"].append(rows)
    for case in job.get("exp_cases", ()):
        il, ol = (torch.as_tensor(case[k], device=dev) for k in ("il", "ol"))
        xs = [torch.tensor(case[k], device=dev, requires_grad=True)
              for k in ("E", "S", "F", "mcol")]
        lattice_sharded.reset_counts()
        with lattice_sharded.tshard_lattice(mesh, "model", 0):
            loss = lattice_loss("xla", "float32", xs, il, ol, "exp")
        loss.sum().backward()
        out["exp_cases"].append({"loss": _host(loss),
                                 "grads": [_host(x.grad) for x in xs],
                                 "counts": dict(lattice_sharded.COUNTS)})
    return out


def steps_task(job, device) -> dict:
    """job: mesh (d, m) or multihost (the model axis); runs: [{cfg, tcfg,
    params or seed, batches (global numpy batches)}]. multihost runs go
    through multihost.global_data_mesh and host_local_batch_to_global with
    this process's rows. Per run and step: the metrics, the ring's counts,
    kernel launches and host-clock ms; the final parameters. With
    ring=(U, B, T): the ring alone on ring_inputs (_ring_run)."""
    if "multihost" in job:
        mesh = multihost.global_data_mesh(job["multihost"], device=device)
    else:
        mesh = _mesh(job, device)
    dev = mesh.device
    out = []
    for run in job["runs"]:
        cfg, tcfg = run["cfg"], run["tcfg"]
        state = train_lib.init_train_state(cfg, tcfg,
                                           params=run.get("params"),
                                           seed=run.get("seed", 0),
                                           device=dev)
        tx = train_lib.make_optimizer(tcfg)
        step_fn, state = train_lib.make_sharded_train_step(tx, mesh, state)
        steps = []
        for gbatch in run["batches"]:
            rows = mesh.rows(len(gbatch["tokens"]))
            if "multihost" in job:
                batch = multihost.host_local_batch_to_global(
                    {k: v[rows] for k, v in gbatch.items()}, mesh)
            else:
                batch = {k: mesh_lib.data_sharding(mesh, v)
                         for k, v in gbatch.items()}
            before, ar = launch_counts(), step_fn.all_reduces
            lattice_sharded.reset_counts()
            _sync(dev)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            _sync(dev)
            steps.append({
                "ms": (time.perf_counter() - t0) * 1e3,
                "metrics": {k: float(v) for k, v in metrics.items()},
                "ring": dict(lattice_sharded.COUNTS),
                "all_reduces": step_fn.all_reduces - ar,
                "launches": _delta(before)})
        out.append({"steps": steps, "params": {
            k: _host(v) for k, v in state.model.state_dict().items()}})
    res = {"runs": out, "rank": mesh.rank, "data": mesh.index("data"),
           "model": mesh.index("model"), "stage_p2p": mesh.stage_p2p}
    if "ring" in job:
        res["ring"] = _ring_run(mesh, *job["ring"])
    return res


def ring_inputs(U: int, B: int, T: int, device, seed: int = 0):
    """A random time-major (U, B, T) log lattice with ragged lengths (the
    first example at full length): ([le, ls, lf], il, ol) on `device`."""
    g = torch.Generator().manual_seed(seed)
    le = torch.rand(U, B, T, generator=g).clamp(0.1, 0.9).log()
    lf = torch.randn(U, B, T, generator=g) * 0.5
    il = torch.randint(T // 2, T + 1, (B,), generator=g)
    ol = (il * U // T * (0.8 + 0.2 * torch.rand(B, generator=g))).long()
    il[0], ol[0] = T, U
    ol = torch.maximum(ol.clamp(max=U), il)
    return ([x.to(device) for x in (le, (-le.exp()).log1p(), lf)],
            il.int().to(device), ol.int().to(device))


def _ring_run(mesh, U: int, B: int, T: int, reps: int = 3) -> dict:
    """ssnt_loss_tsharded forward + backward over the model axis on
    ring_inputs(U, B, T): host-clock ms (the median of `reps` after a warm
    call), and the last call's loss and whole-T gradients."""
    dev = mesh.device
    xs, il, ol = ring_inputs(U, B, T, dev)
    times = []
    for _ in range(reps + 1):
        leaves = [x.clone().requires_grad_() for x in xs]
        _sync(dev)
        t0 = time.perf_counter()
        loss = lattice_sharded.ssnt_loss_tsharded(*leaves, il, ol, mesh)
        loss.sum().backward()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"ms": float(np.median(times[1:])), "loss": _host(loss),
            "grads": [_host(x.grad) for x in leaves]}


def decode_task(job, device) -> dict:
    """job: mesh, cfg, params or seed, batch (global tokens,
    input_length, output_length), beam_width, max_frames. This rank's rows
    through the v2 decode (fused and plain routes), the tone decode and
    the v1 beam_decode; their outputs and kernel launches."""
    mesh = _mesh(job, device)
    dev = mesh.device
    model = make_model(job["cfg"], job.get("params"), job.get("seed", 0),
                       dev)
    toks, il, ol = (mesh_lib.data_sharding(mesh, job["batch"][k]) for k in
                    ("tokens", "input_length", "output_length"))
    runs = decode_routes(model, toks, il, ol, job["beam_width"],
                         job["max_frames"])
    out = {"rows": mesh.rows(len(job["batch"]["tokens"]))}
    with torch.no_grad():
        for name, fn in runs.items():
            before = launch_counts()
            res = fn()
            _sync(dev)
            out[name] = {k: _host(v) for k, v in res.items()}
            out[name + "_launches"] = _delta(before)
    return out


def time_steps_task(job, device) -> dict:
    """job: mesh, cfg, tcfg, seed, batch (global), steps. Host-clock ms
    per sharded step after one warm step (every rank synchronized)."""
    mesh = _mesh(job, device)
    dev = mesh.device
    state = train_lib.init_train_state(job["cfg"], job["tcfg"],
                                       seed=job["seed"], device=dev)
    tx = train_lib.make_optimizer(job["tcfg"])
    step_fn, state = train_lib.make_sharded_train_step(tx, mesh, state)
    batch = {k: mesh_lib.data_sharding(mesh, v)
             for k, v in job["batch"].items()}
    state, _ = step_fn(state, batch)
    _sync(dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(job["steps"]):
        state, metrics = step_fn(state, batch)
    _sync(dev)
    dist.barrier()
    return {"ms": (time.perf_counter() - t0) * 1e3 / job["steps"],
            "loss": float(metrics["loss"])}


def probe_task(job, device) -> dict:
    """all_reduce, all_gather and broadcast once each on tensors on
    `device`, then send / recv between ranks 0 and 1 as the ring does
    them (through host memory where mesh.stage_p2p: gloo's send of a CUDA
    tensor aborts the process). Raises unless each gives the right
    values; returns "ok" for each, and the send / recv tensors' device."""
    mesh = _mesh(job, device)
    dev, rank, n = mesh.device, mesh.rank, mesh.size
    x = torch.full((4,), float(rank + 1), device=dev)
    out = {}
    y = x.clone()
    dist.all_reduce(y)
    out["all_reduce"] = bool((y == n * (n + 1) / 2).all())
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x)
    out["all_gather"] = all(bool((p == r + 1).all())
                            for r, p in enumerate(parts))
    y = x.clone()
    dist.broadcast(y, src=0)
    out["broadcast"] = bool((y == 1).all())
    send = x.cpu() if mesh.stage_p2p else x
    recv = torch.empty_like(send)
    if rank < 2:
        peer = 1 - rank
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, peer),
                dist.P2POp(dist.irecv, recv, peer)]):
            w.wait()
        out["send_recv"] = bool((recv == peer + 1).all())
    if not all(out.values()):
        raise AssertionError(f"rank {rank}: wrong values: {out}")
    return {**{k: "ok" for k in out}, "send_recv_tensors": str(send.device)}


def dryrun_task(job, device) -> dict:
    """The dry run (module docstring) at tiny_model_config, B = 2 rows a
    rank, T=8, U=16; with job["full"] at FULL_CONFIG, T=80, U=400."""
    world = dist.get_world_size()
    model_axis = 2 if world % 2 == 0 else 1
    mesh = mesh_lib.make_mesh(MeshConfig(data=world // model_axis,
                                         model=model_axis), device=device)
    dev = mesh.device
    primary = multihost.is_primary()
    say = print if primary else (lambda *a, **k: None)
    if job.get("full"):
        cfg, (B, T, U) = FULL_CONFIG, (2 * world, 80, 400)
    else:
        cfg, (B, T, U) = tiny_model_config(), (2 * world, 8, 16)
    tcfg = TrainConfig(warmup_steps=2, batch_size=B)
    gbatch = example_batch(cfg, B, T, U)
    state = train_lib.init_train_state(cfg, tcfg, seed=0, device=dev)
    step_fn, state = train_lib.make_sharded_train_step(
        train_lib.make_optimizer(tcfg), mesh, state)
    batch = {k: mesh_lib.data_sharding(mesh, v) for k, v in gbatch.items()}
    state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    out = {"loss": loss, "mesh": dict(mesh.shape)}
    say(f"dryrun: mesh {mesh.shape} step ok, loss={loss:.4f}, "
        f"{step_fn.all_reduces} all_reduces", flush=True)

    model = state.model.eval()
    toks, il, ol = (batch[k] for k in ("tokens", "input_length",
                                       "output_length"))
    W = 2
    with torch.no_grad():
        for name, route in (("v2", None), ("v2 plain", False)):
            res = decode_lib.v2_duration_decode(
                model, toks, il, ol, cfg.duration_table, beam_width=W,
                max_frames=U, test_mode=True, fuse_model=route,
                use_pallas=route)
            if res["durations"].shape != (len(toks), W, T) or not bool(
                    torch.isfinite(res["log_prob"]).all()):
                raise AssertionError(f"{name} decode: shape or log_prob")
            out[name] = _host(res["log_prob"][:, 0])
            say(f"dryrun: {name} decode ok on {len(toks)} rows per rank, "
                f"log_prob[0,0]={float(res['log_prob'][0, 0]):.4f}",
                flush=True)
        res = decode_lib.tone_decode(model, toks, il, beam_width=W)
        if res["tones"].shape != (len(toks), W, T) or not bool(
                torch.isfinite(res["log_prob"]).all()):
            raise AssertionError("tone decode: shape or log_prob")
        out["tone"] = _host(res["log_prob"][:, 0])
        say(f"dryrun: tone decode ok, log_prob[0,0]="
            f"{float(res['log_prob'][0, 0]):.4f}", flush=True)
        res = decode_lib.beam_decode(model, toks, il, max_frames=U,
                                     beam_width=W)
        steps = res["alignment"][:, 1:] - res["alignment"][:, :-1]
        if res["mel"].shape != (len(toks), U, cfg.mel_dim) or not bool(
                torch.isfinite(res["mel"]).all()) or not bool(
                ((steps == 0) | (steps == 1)).all()):
            raise AssertionError("v1 decode: mel shape, finite or steps")
        out["v1"] = _host(res["log_prob"][:, 0])
        say(f"dryrun: v1 beam_decode ok, log_prob[0,0]="
            f"{float(res['log_prob'][0, 0]):.4f}", flush=True)

    if model_axis >= 2:
        rng = np.random.default_rng(0)
        Us, Bs, Ts = 12, 2, 2 * model_axis
        le = np.log(rng.uniform(0.1, 0.9, (Us, Bs, Ts))).astype(np.float32)
        ls = np.log1p(-np.exp(le)).astype(np.float32)
        lf = rng.normal(0, 0.5, (Us, Bs, Ts)).astype(np.float32)
        xs = [torch.as_tensor(a, device=dev) for a in (le, ls, lf)]
        ils = torch.full((Bs,), Ts, dtype=torch.int32, device=dev)
        ols = torch.full((Bs,), Us, dtype=torch.int32, device=dev)
        got = lattice_sharded.ssnt_loss_tsharded(*xs, ils, ols, mesh)
        want = lattice.ssnt_loss(*xs, ils, ols, layout="ubt")
        np.testing.assert_allclose(_host(got), _host(want), rtol=1e-5,
                                   atol=1e-5)
        out["tshard"] = _host(got)
        say(f"dryrun: T-sharded lattice ok over {model_axis} shards (ring "
            f"send/recv), loss[0]={float(got[0]):.4f}", flush=True)
    return out


def run_training_task(job, device) -> dict:
    """job: mesh, cfg, tcfg, steps, seed. train_loop.run_training over the
    mesh; its last metrics."""
    from ssnt_tts_tpu_torch.train_loop import run_training

    return run_training(job["steps"], job["cfg"], job["tcfg"],
                        seed=job["seed"], device=device, log_every=1,
                        mesh_config=MeshConfig(*job["mesh"]))


TASKS = {"dryrun": dryrun_task, "lattice": lattice_task,
         "steps": steps_task, "decode": decode_task,
         "run_training": run_training_task,
         "time_steps": time_steps_task, "probe": probe_task}


# ------------------------------------------------------------- launching


def run_rank(task, job_dir: Optional[str] = None, *,
             job: Optional[dict] = None,
             init_method: Optional[str] = None,
             world: Optional[int] = None, rank: Optional[int] = None,
             device=None, backend: Optional[str] = None,
             timeout_s: float = 300.0):
    """One rank: initialize the process group (explicit arguments, else
    the launcher's environment; gloo for a CPU device, else
    multihost.default_backend unless `backend` names one), run the task
    (a name in TASKS, or a module-level function of (job, device)) on
    `job` (else job_dir's job.pkl, else an empty job), write its result to
    job_dir's rank<R>.pkl when there is a job_dir, and leave the group.
    Returns the result."""
    if device is not None and torch.device(device).type == "cpu":
        torch.set_num_threads(1)
        backend = backend or "gloo"
    multihost.initialize(init_method, world, rank, backend=backend,
                         timeout_s=timeout_s)
    if not dist.is_initialized():
        raise RuntimeError("no process group: give --init/--world/--rank "
                           "or launch with torchrun")
    try:
        if job is None and job_dir is not None:
            job = pickle.loads((pathlib.Path(job_dir) / "job.pkl")
                               .read_bytes())
        fn = TASKS[task] if isinstance(task, str) else task
        result = fn(job or {}, device)
        if job_dir is not None:
            (pathlib.Path(job_dir) / f"rank{dist.get_rank()}.pkl"
             ).write_bytes(pickle.dumps(result))
        return result
    finally:
        dist.destroy_process_group()


def _spawned(index, task, job_dir, init_method, world, device, backend,
             timeout_s):
    run_rank(task, job_dir, init_method=init_method, world=world,
             rank=index, device=device, backend=backend,
             timeout_s=timeout_s)


def launch(task, job: dict, world: int, job_dir, *, device=None,
           backend: Optional[str] = None, timeout: float = 300.0
           ) -> List[object]:
    """Run `task` (as run_rank takes it; a function is pickled by
    reference) on `world` new ranks (torch.multiprocessing, "spawn"),
    rendezvous through a file in job_dir; returns each rank's result, in
    rank order. Raises if a rank raises or exits non-zero (the others are
    stopped), and TimeoutError (every rank killed) after `timeout`
    seconds; the process group's collectives time out after the same."""
    import torch.multiprocessing as mp

    job_dir = pathlib.Path(job_dir).resolve()
    job_dir.mkdir(parents=True, exist_ok=True)
    for old in job_dir.glob("rank*.pkl"):
        old.unlink()
    (job_dir / "job.pkl").write_bytes(pickle.dumps(job))
    store = job_dir / "rendezvous"
    store.unlink(missing_ok=True)
    dev = None if device is None else str(device)
    ctx = mp.start_processes(
        _spawned, args=(task, str(job_dir), f"file://{store}", world, dev,
                        backend, timeout),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{getattr(task, '__name__', task)}: "
                                   f"{world} ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [pickle.loads((job_dir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--init", help="init_method (tcp://host:port or "
                    "file:///path); default: the launcher's environment")
    ap.add_argument("--world", type=int)
    ap.add_argument("--rank", type=int)
    ap.add_argument("--device", help="this rank's device (default: its "
                    "card)")
    ap.add_argument("--full", action="store_true",
                    help="the smoke model's width (vocab 128, mel 80, "
                    "encoder 256 x 2 x 4, decoder 256, rank 64, bf16) at "
                    "T=80, U=400, 2 rows a rank")
    args = ap.parse_args(argv)
    run_rank("dryrun", job={"full": args.full}, init_method=args.init,
             world=args.world, rank=args.rank, device=args.device)

if __name__ == "__main__":
    main()
