"""Training loop on synthetic data: data -> step -> metrics (PyTorch).

    from ssnt_tts_tpu_torch.train_loop import run_training
    run_training(num_steps=100)                     # on the card
    run_training(num_steps=3, device="cpu", ...)    # on the CPU

Mirrors ssnt_tts_tpu/train_loop.py on one device with the synthetic
generator. File-backed data (data_dir), checkpoints, the mesh and
multi-host training are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict, Optional

from ssnt_tts_tpu_torch import data as data_lib
from ssnt_tts_tpu_torch.parallel import train as train_lib
from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig
from ssnt_tts_tpu_torch.utils.metrics import MetricsLogger


def run_training(num_steps: int,
                 model_config: Optional[ModelConfig] = None,
                 train_config: Optional[TrainConfig] = None,
                 seed: int = 0, device=None,
                 metrics_path: Optional[str] = None,
                 log_every: int = 50,
                 params: Optional[dict] = None) -> Dict[str, float]:
    """Train for num_steps from `params` (a flax tree of numpy arrays) or,
    by default, seeded random weights (convert.random_flax_tree) on seeded
    synthetic batches. Logs metrics every log_every steps and at the last
    one (JSON lines to metrics_path, or stdout); returns the last logged
    metrics."""
    cfg = model_config or ModelConfig()
    tcfg = train_config or TrainConfig()
    state = train_lib.init_train_state(cfg, tcfg, params=params, seed=seed,
                                       device=device)
    tx = train_lib.make_optimizer(tcfg)
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=tcfg.max_input_length,
        max_output_length=tcfg.max_output_length,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed)
    raw = ({k: v for k, v in b.items() if k != "alignment"}
           for b in ds.batches(tcfg.batch_size))
    batches = data_lib.prefetch_to_device(
        raw, device=next(state.model.parameters()).device)
    logger = MetricsLogger(metrics_path)
    last: Dict[str, float] = {}
    try:
        for i in range(num_steps):
            state, metrics = train_lib.train_step(tx, state, next(batches))
            if (i + 1) % log_every == 0 or i + 1 == num_steps:
                last = {k: float(v) for k, v in metrics.items()}
                logger.log(i + 1, last)
    finally:
        batches.close()
        logger.close()
    return last
