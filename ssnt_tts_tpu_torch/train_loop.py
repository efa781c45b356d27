"""Training loop on synthetic data: data -> step -> metrics (PyTorch).

    from ssnt_tts_tpu_torch.train_loop import run_training
    run_training(num_steps=100)                     # on the card
    run_training(num_steps=3, device="cpu", ...)    # on the CPU
    # on every rank of an initialized process group (parallel/multihost):
    run_training(num_steps=100, mesh_config=MeshConfig(data=2, model=2))

Mirrors ssnt_tts_tpu/train_loop.py with the synthetic generator. With a
mesh_config, every rank draws the same global batches and trains on its
data rows through the sharded step; only the primary logs. File-backed
data (data_dir) and checkpoints are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

from ssnt_tts_tpu_torch import data as data_lib
from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
from ssnt_tts_tpu_torch.parallel import multihost
from ssnt_tts_tpu_torch.parallel import train as train_lib
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
                 mesh_config: Optional[MeshConfig] = None
                 ) -> Dict[str, float]:
    """Train for num_steps from `params` (a flax tree of numpy arrays) or,
    by default, seeded random weights (convert.random_flax_tree) on seeded
    synthetic batches. Logs metrics every log_every steps and at the last
    one (JSON lines to metrics_path, or stdout; with a mesh, the primary
    only); returns the last logged metrics (of the global batch).

    mesh_config: train over mesh_lib.make_mesh(mesh_config, device=device)
    with parallel/train.make_sharded_train_step; None trains on one
    device with train_step."""
    cfg = model_config or ModelConfig()
    tcfg = train_config or TrainConfig()
    mesh = None
    if mesh_config is not None:
        mesh = mesh_lib.make_mesh(mesh_config, device=device)
        device = mesh.device
    state = train_lib.init_train_state(cfg, tcfg, params=params, seed=seed,
                                       device=device)
    tx = train_lib.make_optimizer(tcfg)
    if mesh is None:
        step_fn = lambda st, b: train_lib.train_step(tx, st, b)
        rows = slice(None)
    else:
        step_fn, state = train_lib.make_sharded_train_step(tx, mesh, state)
        rows = mesh.rows(tcfg.batch_size)
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=tcfg.max_input_length,
        max_output_length=tcfg.max_output_length,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed)
    raw = ({k: v[rows] for k, v in b.items() if k != "alignment"}
           for b in ds.batches(tcfg.batch_size))
    batches = data_lib.prefetch_to_device(
        raw, device=next(state.model.parameters()).device)
    logger = MetricsLogger(metrics_path) if multihost.is_primary() else None
    last: Dict[str, float] = {}
    try:
        for i in range(num_steps):
            state, metrics = step_fn(state, next(batches))
            if (i + 1) % log_every == 0 or i + 1 == num_steps:
                last = {k: float(v) for k, v in metrics.items()}
                if logger is not None:
                    logger.log(i + 1, last)
    finally:
        batches.close()
        if logger is not None:
            logger.close()
    return last
