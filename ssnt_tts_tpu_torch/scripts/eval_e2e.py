"""End-to-end evaluation (the port of scripts/eval_e2e.py, the repo's
BASELINE config 3): synthetic corpus -> .npz shards -> training at B=256
from the shards -> v2 duration decode in two arms -> synthesis -> tone
decode -> edit distance, written as one JSON record with JAX's keys.

  - The corpus is materialize_synthetic's into --data-dir, read back by
    data_files.NpzShardDataset (length buckets; the padding efficiency of
    the batches trained on is recorded). The eval batch comes from the
    generator, because the teacher-forced metric needs its alignment.
  - The duration head trains with the duration-lattice marginal NLL
    (ModelConfig.use_duration_lattice).
  - train_step_ms: utils/timing.bench_step on the card (CUDA events around
    chains of train steps on a copy of the trained state), absent with
    --cpu as in JAX.
  - Teacher-forced mel error (the frame joint along the true alignment),
    then v2_duration_decode -> synthesize_from_alignment at reference
    defaults and with V2BeamConfig.final_feasible_guard: decoded mel error,
    the emptied rate with its binomial stderr, the output-length error.
  - tone_decode -> levenshtein_edit_distance against the tone targets.

The weights are the port's seeded init (convert.random_flax_tree), not
JAX's, so the record is a statistical comparison with JAX's, not an equal
one; the corpus, the bucketing and the padding statistics are the same.

  python -m ssnt_tts_tpu_torch.scripts.eval_e2e --out eval.json   # card
  python -m ssnt_tts_tpu_torch.scripts.eval_e2e --cpu --tiny --steps 4
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import time
from pathlib import Path

# Shards land inside the checkout's build/ (listed in .gitignore).
DEFAULT_DATA_DIR = str(Path(__file__).resolve().parents[2] / "build"
                       / "eval_shards")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--eval-batch", type=int, default=256)
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--corpus", type=int, default=4096,
                   help="examples materialized into .npz shards")
    p.add_argument("--data-dir", type=str, default=DEFAULT_DATA_DIR,
                   help="shard directory (emptied first)")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from ssnt_tts_tpu_torch import data as data_lib
    from ssnt_tts_tpu_torch import data_files as data_files_lib
    from ssnt_tts_tpu_torch.ops import edit_distance
    from ssnt_tts_tpu_torch.parallel import decode as decode_lib
    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.utils.config import (
        ModelConfig, TrainConfig, V2BeamConfig, tiny_model_config,
    )
    from ssnt_tts_tpu_torch.utils.device import resolve_device
    from ssnt_tts_tpu_torch.utils.timing import bench_step

    dev = resolve_device("cpu" if args.cpu else None)
    t_start = time.time()
    if args.tiny:
        cfg = tiny_model_config(use_duration_lattice=True)
        T, U = 16, 40
    else:
        cfg = ModelConfig(
            vocab_size=128, mel_dim=80, encoder_dim=256, encoder_layers=2,
            encoder_heads=4, decoder_dim=256, joint_rank=64,
            use_duration_lattice=True,
        )
        T, U = 80, 400
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=T, max_output_length=U,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=0,
    )
    B = args.batch
    tcfg = TrainConfig(warmup_steps=max(2, args.steps // 10), batch_size=B,
                       learning_rate=3e-4)
    # JAX initializes its parameters on this batch; the port initializes
    # from a seed and draws it only to keep the corpus and the eval batch
    # the same as JAX's.
    ds.batch(B)
    state = train_lib.init_train_state(cfg, tcfg, seed=0, device=dev)
    tx = train_lib.make_optimizer(tcfg)
    model = state.model

    def to_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()
                if k != "alignment"}

    # ---- materialize the corpus into .npz shards; train from them ----
    shutil.rmtree(args.data_dir, ignore_errors=True)
    n_corpus = 256 if args.tiny else args.corpus
    print(f"[eval] materializing {n_corpus} examples into "
          f"{args.data_dir}...", flush=True)
    data_files_lib.materialize_synthetic(ds, n_corpus, args.data_dir)
    file_ds = data_files_lib.NpzShardDataset(args.data_dir)
    stats = data_files_lib.PaddingStats()
    batch_iter = file_ds.batches(B, shuffle_seed=0, drop_remainder=False)

    print(f"[eval] training {args.steps} steps at B={B} from npz "
          f"shards ({len(file_ds)} examples, bucketed)...", flush=True)
    losses = []
    for i in range(args.steps):
        batch = next(batch_iter)
        stats.update(batch)
        state, metrics = train_lib.train_step(tx, state, to_dev(batch))
        if (i + 1) % max(1, args.steps // 10) == 0:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"[eval] step {i+1}: loss {loss:.4f} "
                  f"(+{time.time()-t_start:.0f}s)", flush=True)

    record = {
        "config": "BASELINE-3 (B=256 train, 1 host)" if not args.tiny
        else "tiny-smoke",
        "batch": B,
        "steps": args.steps,
        "data_source": "npz_shards",
        "corpus_examples": len(file_ds),
        "padding_stats": stats.summary(),
        "decode_backend": (
            "fused model+beam CUDA kernels (ops/beam_fused.py)"
            if dev.type == "cuda" else "plain PyTorch steps (CPU)"
        ),
        "loss_first_logged": losses[0] if losses else None,
        "loss_final": losses[-1] if losses else None,
    }

    # ---- train-step timing at B ----
    if dev.type == "cuda":
        print("[eval] timing train step...", flush=True)
        bench_batch = to_dev(ds.batch(B))

        def chain(s):
            return train_lib.train_step(tx, s, bench_batch)[0]

        dt = bench_step(chain, copy.deepcopy(state), n_lo=2, n_hi=8)
        record["train_step_ms"] = round(dt * 1e3, 2)
        record["train_examples_per_s"] = round(B / dt, 1)

    # ---- eval batch ----
    Be = args.eval_batch
    ev = ds.batch(Be)
    tokens = torch.from_numpy(ev["tokens"]).to(dev)
    il = torch.from_numpy(ev["input_length"]).to(dev)
    ol = torch.from_numpy(ev["output_length"]).to(dev)
    mel_true = ev["mel"]
    model.eval()
    umask = (np.arange(U)[None, :] < ev["output_length"][:, None])[..., None]

    def mel_l2(mel):
        return round(float(np.sqrt(
            (((mel - mel_true) ** 2) * umask).sum()
            / (umask.sum() * cfg.mel_dim))), 4)

    with torch.no_grad():
        enc = model.encode(tokens, il)
        # Teacher-forced mel reconstruction along the true alignment.
        mel_tf = model.synthesize_from_alignment(
            enc, torch.from_numpy(ev["alignment"]).to(dev))
    record["mel_l2_teacher_forced_alignment"] = mel_l2(mel_tf.cpu().numpy())

    # v2 production decode -> alignment -> synthesis, at reference
    # defaults and with the final-feasibility guard.
    dur_table = torch.arange(cfg.duration_class_size, dtype=torch.int32)
    for arm, v2cfg in [
        ("", V2BeamConfig()),
        ("_guard", V2BeamConfig(final_feasible_guard=True)),
    ]:
        print(f"[eval] v2 duration decode (arm: default{arm})...",
              flush=True)
        v2 = decode_lib.v2_duration_decode(
            model, tokens, il, ol, dur_table, beam_width=args.beam,
            max_frames=U, config=v2cfg)
        with torch.no_grad():
            mel_dec = model.synthesize_from_alignment(
                enc, v2["source_indexes"][:, 0, :])  # best beam (B, U)
        record[f"mel_l2_v2_decoded_alignment{arm}"] = mel_l2(
            mel_dec.cpu().numpy())
        emptied = v2["beam_emptied"].cpu().numpy().astype(np.float64)
        rate = float(emptied.mean())
        record[f"v2_beam_emptied_rate{arm}"] = round(rate, 4)
        record[f"v2_beam_emptied_stderr{arm}"] = round(
            float(np.sqrt(max(rate * (1 - rate), 1e-12) / len(emptied))),
            4,
        )
        # Duration fidelity of the decoded best beam.
        record[f"v2_output_length_mae_frames{arm}"] = round(
            float(np.abs(v2["output_length"][:, 0].cpu().numpy()
                         - ev["output_length"]).mean()), 2
        )
    record["eval_n"] = int(Be)

    # Tone decode -> edit distance against the targets.
    print("[eval] tone decode + edit distance...", flush=True)
    td = decode_lib.tone_decode(model, tokens, il, beam_width=args.beam)
    dist = edit_distance.levenshtein_edit_distance(
        td["tones"][:, 0, :], torch.from_numpy(ev["tone_target"]).to(dev),
        il, il).cpu().numpy()
    record["tone_edit_distance_mean"] = round(float(dist.mean()), 3)
    record["tone_edit_distance_per_token"] = round(
        float((dist / ev["input_length"]).mean()), 4
    )
    record["wall_s"] = round(time.time() - t_start, 1)

    print(json.dumps(record))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return record


if __name__ == "__main__":
    main()
    sys.exit(0)
