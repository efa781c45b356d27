"""Triage of the v2 empty-beam rate (the port of
scripts/triage_empty_beam.py; docs/EMPTYBEAM.md): why a v2 beam empties,
the state where the reference panics (src/v2.rs:292).

  1. which prune empties the beam: v2_duration_decode's
     collect_diagnostics (per utterance, the [band, overrun, exact_final,
     zero_skip] rescue counts at the first emptying step and its source
     position; the plain step, as in JAX);
  2. whether longer training drives it down: checkpoints of one run at
     increasing step counts (TrainConfig(warmup_steps=max(2, steps // 10),
     learning_rate=3e-4) on SyntheticTTSDataset, as JAX's script);
  3. whether allow_skip, a wider band or a wider beam (2x and 4x --beam)
     removes it: five sweeps at the final checkpoint.

The record has the keys of JAX's (TRIAGE_EMPTYBEAM_r04.json). The
weights start from the port's seeded init (convert.random_flax_tree), not
JAX's, so the record compares with JAX's statistically; the data stream
and the eval batch are JAX's.

  python -m ssnt_tts_tpu_torch.scripts.triage_empty_beam --out triage.json
  python -m ssnt_tts_tpu_torch.scripts.triage_empty_beam --cpu --tiny \\
      --steps 2 4
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ssnt_tts_tpu_torch import data as data_lib
from ssnt_tts_tpu_torch.parallel import decode as decode_lib
from ssnt_tts_tpu_torch.parallel import train as train_lib
from ssnt_tts_tpu_torch.utils.config import (
    ModelConfig, TrainConfig, V2BeamConfig, tiny_model_config,
)
from ssnt_tts_tpu_torch.utils.device import resolve_device

PRUNES = ("band", "overrun", "exact_final", "zero_skip")


def summarize(emptied, counts, first_t, out_len0, input_length,
              output_length) -> dict:
    """One decode's entry from numpy arrays: emptied (B,) bool, counts
    (B, 4) first_empty_prune_counts, first_t (B,) first_empty_t, out_len0
    (B,) the best beam's output length; among the emptied utterances, how
    many one relaxation alone would have rescued at the first emptying
    step, and where that step fell (relative to the last position)."""
    e = np.asarray(emptied).astype(bool)
    counts, first_t = np.asarray(counts), np.asarray(first_t)
    il = np.asarray(input_length)
    rel = (first_t[e] / np.maximum(il[e] - 1, 1)).tolist() if e.any() else []
    mae = float(np.abs(np.asarray(out_len0) - np.asarray(output_length))
                .mean())
    return {
        "emptied_rate": round(float(e.mean()), 4),
        "n_emptied": int(e.sum()),
        "rescued_by": {n: int((counts[e, i] > 0).sum())
                       for i, n in enumerate(PRUNES)},
        "first_empty_t_relative": [round(x, 3) for x in rel],
        "output_length_mae_frames": round(mae, 2),
    }


def decode_entry(model, tokens, il, ol, *, beam: int, max_frames: int,
                 allow_skip: bool = False, config=None) -> dict:
    """v2_duration_decode(collect_diagnostics=True) of the eval batch
    (tensors on the model's device), summarized."""
    out = decode_lib.v2_duration_decode(
        model, tokens, il, ol, model.config.duration_table,
        beam_width=beam, max_frames=max_frames, allow_skip=allow_skip,
        collect_diagnostics=True, config=config)
    host = lambda k: out[k].cpu().numpy()
    return summarize(host("beam_emptied"), host("first_empty_prune_counts"),
                     host("first_empty_t"), host("output_length")[:, 0],
                     il.cpu().numpy(), ol.cpu().numpy())


def sweeps(beam: int) -> dict:
    """The sweeps at the final checkpoint: name -> decode_entry kwargs."""
    return {
        "allow_skip": dict(allow_skip=True),
        "band_x2": dict(config=V2BeamConfig(band_upper_frac=0.2,
                                            band_lower_frac=0.1)),
        "band_x4": dict(config=V2BeamConfig(band_upper_frac=0.4,
                                            band_lower_frac=0.2)),
        # Beam capacity: the beam must carry a hypothesis whose total
        # duration can land on output_length at t = T-1.
        "beam_x2": dict(beam=2 * beam),
        "beam_x4": dict(beam=4 * beam),
    }


def main(argv=None, outputs=None) -> dict:
    """Runs the triage and returns the record. A dict `outputs` receives
    the trained model and the eval batch (tokens, il, ol on its device)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, nargs="+", default=[150, 400, 800])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--eval-batch", type=int, default=64)
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    t0 = time.time()
    if args.tiny:
        cfg = tiny_model_config()
        T, U = 16, 40
    else:
        cfg = ModelConfig(
            vocab_size=128, mel_dim=80, encoder_dim=256, encoder_layers=2,
            encoder_heads=4, decoder_dim=256, joint_rank=64,
        )
        T, U = 80, 400
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=T, max_output_length=U,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=0,
    )
    B = args.batch
    tcfg = TrainConfig(warmup_steps=max(2, max(args.steps) // 10),
                       batch_size=B, learning_rate=3e-4)
    # JAX initializes its parameters on this batch; the port initializes
    # from a seed and draws it only to keep the stream JAX's.
    ds.batch(B)
    state = train_lib.init_train_state(cfg, tcfg, seed=0, device=dev)
    tx = train_lib.make_optimizer(tcfg)

    def to_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
                if k != "alignment"}

    Be = args.eval_batch
    ev = to_dev(ds.batch(Be))
    tokens, il, ol = ev["tokens"], ev["input_length"], ev["output_length"]

    def run_decode(**kw):
        beam = kw.pop("beam", args.beam)
        state.model.eval()  # train_step sets train mode again
        with torch.no_grad():
            return decode_entry(state.model, tokens, il, ol, beam=beam,
                                max_frames=U, **kw)

    record = {"eval_batch": Be, "beam": args.beam, "train_batch": B,
              "checkpoints": {}, "sweeps_at_final": {}}
    done = 0
    for target in sorted(args.steps):
        for _ in range(target - done):
            state, metrics = train_lib.train_step(tx, state,
                                                  to_dev(ds.batch(B)))
        done = target
        loss = float(metrics["loss"])
        r = {**run_decode(), "loss": round(loss, 3)}
        record["checkpoints"][str(target)] = r
        print(f"[triage] steps={target} loss={loss:.3f} -> {r}", flush=True)

    for name, kw in sweeps(args.beam).items():
        r = run_decode(**kw)
        record["sweeps_at_final"][name] = r
        print(f"[triage] sweep {name} -> {r}", flush=True)

    record["wall_s"] = round(time.time() - t0, 1)
    out = json.dumps(record, indent=1)
    print(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(out)
    if outputs is not None:
        state.model.eval()
        outputs.update(model=state.model, tokens=tokens, il=il, ol=ol,
                       max_frames=U)
    return record


if __name__ == "__main__":
    main()
    sys.exit(0)
