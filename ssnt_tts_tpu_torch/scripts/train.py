"""Training command line (the port of scripts/train.py): synthetic data,
checkpoints and resume.

    python -m ssnt_tts_tpu_torch.scripts.train --steps 200 --batch-size 32 \
        --ckpt ckpt_dir            # on the card, ModelConfig()
    python -m ssnt_tts_tpu_torch.scripts.train --cpu --tiny --steps 3

Run again with the same --ckpt and more --steps to resume. Training from
.npz shards goes through train_loop.run_training(data_dir=), as in JAX.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--input-length", type=int, default=80)
    p.add_argument("--output-length", type=int, default=400)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--metrics", type=str, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model config (CI/smoke)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    from ssnt_tts_tpu_torch.train_loop import run_training
    from ssnt_tts_tpu_torch.utils.config import (
        ModelConfig,
        TrainConfig,
        tiny_model_config,
    )

    mcfg = tiny_model_config() if args.tiny else ModelConfig()
    tcfg = TrainConfig(
        learning_rate=args.lr,
        batch_size=args.batch_size,
        max_input_length=args.input_length,
        max_output_length=args.output_length,
        warmup_steps=min(1000, max(2, args.steps // 10)),
    )
    metrics = run_training(
        num_steps=args.steps,
        model_config=mcfg,
        train_config=tcfg,
        device="cpu" if args.cpu else None,
        checkpoint_dir=args.ckpt,
        metrics_path=args.metrics,
    )
    print("final:", metrics)
    return 0


if __name__ == "__main__":
    sys.exit(main())
