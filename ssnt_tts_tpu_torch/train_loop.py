"""Training loop: data -> step -> metrics -> checkpoints (PyTorch).

    from ssnt_tts_tpu_torch.train_loop import run_training
    run_training(num_steps=100, checkpoint_dir="ckpt")   # on the card
    run_training(num_steps=3, device="cpu", ...)         # on the CPU
    run_training(num_steps=100, data_dir="shards")       # .npz shards
    # on every rank of an initialized process group (parallel/multihost):
    run_training(num_steps=100, mesh_config=MeshConfig(data=2, model=2))

Mirrors ssnt_tts_tpu/train_loop.py. Batches come from the seeded
synthetic generator or, with data_dir, from .npz shards through
data_files.NpzShardDataset (length-bucketed; the padding efficiencies are
logged beside the training metrics). With checkpoint_dir the run resumes
from the latest checkpoint there (utils/checkpoint) and saves every
checkpoint_every steps and at the last one. With a mesh_config, every
rank draws the same global batches and trains on its data rows through the
sharded step (with its parameters split over the model axis when it has
more than one rank); every rank joins the gather of a checkpoint's whole
parameters, only the primary logs and saves, every rank restores, and
every rank returns after the primary's last save.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch.distributed as dist

from ssnt_tts_tpu_torch import data as data_lib
from ssnt_tts_tpu_torch import data_files as data_files_lib
from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
from ssnt_tts_tpu_torch.parallel import multihost
from ssnt_tts_tpu_torch.parallel import train as train_lib
from ssnt_tts_tpu_torch.utils import checkpoint as ckpt_lib
from ssnt_tts_tpu_torch.utils.device import resolve_device
from ssnt_tts_tpu_torch.utils.config import (
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from ssnt_tts_tpu_torch.utils.metrics import MetricsLogger


def run_training(num_steps: int,
                 model_config: Optional[ModelConfig] = None,
                 train_config: Optional[TrainConfig] = None,
                 seed: int = 0, device=None,
                 metrics_path: Optional[str] = None,
                 log_every: int = 50,
                 params: Optional[dict] = None,
                 mesh_config: Optional[MeshConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1000,
                 data_dir: Optional[str] = None,
                 ) -> Dict[str, float]:
    """Train up to step num_steps from `params` (a flax tree of numpy
    arrays) or, by default, seeded random weights (convert.random_flax_tree)
    on seeded synthetic batches, or with data_dir on the shards there
    (shuffled with `seed`). Logs metrics every log_every steps and at the
    last one (JSON lines to metrics_path, or stdout; with a mesh, the
    primary only); returns the last logged metrics (of the global batch),
    with token_/frame_padding_efficiency when training from files.

    checkpoint_dir: restore the latest checkpoint there, if any, and train
    steps [its step, num_steps) on a fresh data stream (the first batches
    are seen again, as in JAX); save every checkpoint_every steps and at
    the last step (the primary rank only; with a mesh, every rank returns
    after that save).
    mesh_config: train over mesh_lib.make_mesh(mesh_config, device=device)
    with parallel/train.make_sharded_train_step; None trains on one
    device with train_step."""
    cfg = model_config or ModelConfig()
    tcfg = train_config or TrainConfig()
    B = tcfg.batch_size
    if mesh_config is None:
        mesh = None
        device = resolve_device(device)
    else:
        mesh = mesh_lib.make_mesh(mesh_config, device=device)
        device = mesh.device
    file_ds = None
    if data_dir is not None:
        file_ds = data_files_lib.NpzShardDataset(data_dir)
        source = file_ds.batches(B, shuffle_seed=seed)
        # JAX pads one batch of a second stream to initialize its
        # parameters (train_loop.py:58-62); file_ds.stats counts it, and
        # so do the logged padding efficiencies. Drawn here for the same
        # numbers.
        next(file_ds.batches(B, shuffle_seed=seed))
    else:
        ds = data_lib.SyntheticTTSDataset(
            vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
            max_input_length=tcfg.max_input_length,
            max_output_length=tcfg.max_output_length,
            duration_class_size=cfg.duration_class_size,
            tone_class_size=cfg.tone_class_size, seed=seed)
        source = ds.batches(B)
        # JAX initializes its parameters on the generator's first batch
        # (train_loop.py:77-81) and trains from the second on. The port
        # initializes from a seed; this draw only keeps step i on the
        # batch JAX's step i trains on.
        ds.batch(B)
    state = train_lib.init_train_state(cfg, tcfg, params=params, seed=seed,
                                       device=device)
    start_step = 0
    if checkpoint_dir and ckpt_lib.latest_step(checkpoint_dir) is not None:
        state = ckpt_lib.restore(checkpoint_dir, state)
        start_step = state.step
    tx = train_lib.make_optimizer(tcfg)
    if mesh is None:
        step_fn = lambda st, b: train_lib.train_step(tx, st, b)
        rows = slice(None)
    else:
        step_fn, state = train_lib.make_sharded_train_step(tx, mesh, state)
        rows = mesh.rows(B)
    raw = ({k: v[rows] for k, v in b.items() if k != "alignment"}
           for b in source)
    batches = data_lib.prefetch_to_device(
        raw, device=next(state.model.parameters()).device)
    primary = multihost.is_primary()
    logger = MetricsLogger(metrics_path) if primary else None
    last: Dict[str, float] = {}
    try:
        for i in range(start_step, num_steps):
            state, metrics = step_fn(state, next(batches))
            if (i + 1) % log_every == 0 or i + 1 == num_steps:
                last = {k: float(v) for k, v in metrics.items()}
                if file_ds is not None:
                    last["token_padding_efficiency"] = (
                        file_ds.stats.token_efficiency)
                    last["frame_padding_efficiency"] = (
                        file_ds.stats.frame_efficiency)
                if logger is not None:
                    logger.log(i + 1, last)
            if checkpoint_dir and (
                    (i + 1) % checkpoint_every == 0 or i + 1 == num_steps):
                # Every rank joins the gather of split parameters; the
                # primary writes.
                params = train_lib.gather_params(state)
                if primary:
                    ckpt_lib.save(checkpoint_dir, i + 1, state,
                                  params=params)
        if checkpoint_dir and mesh is not None:
            # Every rank returns once the primary's checkpoints are in
            # place, so a run that follows restores the same step on every
            # rank (NCCL's collectives do not order the ranks' reads after
            # the primary's writes).
            dist.barrier(**({"device_ids": [mesh.device.index]}
                            if mesh.backend == "nccl" else {}))
    finally:
        batches.close()
        if logger is not None:
            logger.close()
    return last
