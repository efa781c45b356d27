"""The v2 decode at the batch of BASELINE configs[4] (the port of
scripts/decode_scale.py): v2_duration_decode at B=2048 in one process and
split over data ranks (beams rank-local, no collectives in the decode),
and an unsharded B=256 point for the scaling structure, at the smoke
width (vocab 128, mel 80, encoder 256 x 2 x 4, decoder 256, joint rank
64, bf16), written as one JSON record with JAX's keys.

  - The decode is v2_duration_decode's default route, the fused step
    (csrc/fused_class_step.cu) on the card; --plain takes JAX's script's
    route (fuse_model=False, use_pallas=False); --cpu runs on the CPU.
  - Every utterance is at full length (T tokens, U frames), as in JAX's
    script; tokens come from numpy's default_rng(0), B=256's first.
  - Weights: convert.random_flax_tree(cfg, 0) through
    convert.flax_to_torch (JAX's script takes init_train_state's).
  - The sharded case splits the batch over --ranks data ranks with
    dryrun's "decode" task: NCCL with a card a rank where there are
    enough cards, else gloo with every rank on the one card (or on the
    CPU with --cpu). Parameters are replicated; each rank decodes its
    rows. Its ms is the slowest rank's.
  - ms per decode: host clock over --reps decodes after a warm one, each
    ending in a synchronize; audio-seconds per second B * U * 0.0125 s /
    that latency.

  python -m ssnt_tts_tpu_torch.scripts.decode_scale --json scale.json
  python -m ssnt_tts_tpu_torch.scripts.decode_scale --cpu --batch 8 \\
      --small-batch 4 --seq 8 16 --ranks 2
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ssnt_tts_tpu_torch import dryrun
from ssnt_tts_tpu_torch.parallel import decode as decode_lib
from ssnt_tts_tpu_torch.parallel import multihost
from ssnt_tts_tpu_torch.utils.device import resolve_device

FRAME_HOP_S = 0.0125
# The sharded case's job directory, inside the checkout's build/ (listed
# in .gitignore).
DEFAULT_JOB_DIR = str(Path(__file__).resolve().parents[2] / "build"
                      / "decode_scale")


def make_batch(rng, cfg, B: int, T: int, U: int) -> dict:
    """JAX's batch: random tokens, every utterance at full length."""
    return {"tokens": rng.integers(1, cfg.vocab_size, (B, T)).astype(
                np.int32),
            "input_length": np.full((B,), T, np.int32),
            "output_length": np.full((B,), U, np.int32)}


def decoder(model, batch: dict, beam: int, max_frames: int, plain: bool):
    """A thunk running v2_duration_decode on the batch (on the model's
    device); returns its outputs."""
    dev = next(model.parameters()).device
    toks, il, ol = (torch.as_tensor(batch[k], device=dev) for k in
                    ("tokens", "input_length", "output_length"))
    route = False if plain else None
    return lambda: decode_lib.v2_duration_decode(
        model, toks, il, ol, model.config.duration_table, beam_width=beam,
        max_frames=max_frames, fuse_model=route, use_pallas=route)


def timed(fn, reps: int, dev):
    """(ms a call over reps calls after a warm one, the warm call's
    outputs); each timed span ends in a synchronize."""

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.no_grad():
        out = fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
    return (time.perf_counter() - t0) * 1e3 / max(reps, 1), out


def sharded(cfg, batch: dict, ranks: int, beam: int, max_frames: int,
            plain: bool, reps: int, cpu: bool, job_dir) -> dict:
    """The batch over `ranks` data ranks (dryrun's "decode" task), beams
    rank-local. Returns {"ms": the slowest rank's ms a decode, "out": the
    ranks' outputs concatenated in rank order (numpy), "launches": each
    rank's kernel launches, "backend", "device"}."""
    route = "v2_plain" if plain else "v2"
    if cpu:
        device, backend = "cpu", "gloo"
    else:
        device, backend = None, multihost.default_backend(ranks)
    job = {"mesh": (ranks, 1), "cfg": cfg, "seed": 0, "batch": batch,
           "beam_width": beam, "max_frames": max_frames, "routes": [route],
           "reps": reps}
    res = dryrun.launch("decode", job, ranks, job_dir, device=device,
                        backend=backend, timeout=600)
    out = {k: np.concatenate([r[route][k] for r in res])
           for k in res[0][route]}
    where = "cpu" if cpu else (
        f"{ranks} cards" if backend == "nccl" else
        f"one card ({torch.cuda.get_device_name(0)})")
    return {"ms": max(r[route + "_ms"] for r in res), "out": out,
            "launches": [r[route + "_launches"] for r in res],
            "backend": backend, "device": where}


def card_platform() -> str:
    """The card, as nvidia-smi names it with its power limit."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return f"gpu: {smi}; torch {torch.__version__}"


def main(argv=None, outputs=None) -> dict:
    """Runs the cases and returns the record. A dict `outputs` receives
    the model, the B=--batch batch, the one-process decode's outputs
    ("one", tensors) and the sharded one's ("sharded", numpy, rows in
    order) with each rank's launches ("sharded_launches")."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--small-batch", type=int, default=256)
    p.add_argument("--seq", type=int, nargs=2, default=[80, 400],
                   metavar=("T", "U"))
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--ranks", type=int, default=4,
                   help="data ranks of the sharded case")
    p.add_argument("--plain", action="store_true",
                   help="JAX's script's route: fuse_model=False, "
                   "use_pallas=False (default: the fused kernel)")
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--job-dir", type=str, default=DEFAULT_JOB_DIR,
                   help="the sharded ranks' job directory")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    T, U = args.seq
    W = args.beam
    cfg = dryrun.FULL_CONFIG  # the smoke width
    model = dryrun.make_model(cfg, None, 0, dev)
    rng = np.random.default_rng(0)
    t_start = time.time()

    def run_case(batch):
        return timed(decoder(model, batch, W, U, args.plain), args.reps,
                     dev)

    small = make_batch(rng, cfg, args.small_batch, T, U)
    big = make_batch(rng, cfg, args.batch, T, U)
    print(f"[scale] B={args.small_batch} in one process...", flush=True)
    ms_small, _ = run_case(small)
    print(f"[scale]   {ms_small:.1f} ms", flush=True)
    print(f"[scale] B={args.batch} in one process...", flush=True)
    ms_big, out_big = run_case(big)
    print(f"[scale]   {ms_big:.1f} ms", flush=True)
    print(f"[scale] B={args.batch} over {args.ranks} data ranks...",
          flush=True)
    sh = sharded(cfg, big, args.ranks, W, U, args.plain, args.reps,
                 args.cpu, args.job_dir)
    if outputs is not None:
        outputs.update(model=model, batch=big, one=out_big,
                       sharded=sh["out"], sharded_launches=sh["launches"])
    print(f"[scale]   {sh['ms']:.1f} ms ({sh['backend']}, {sh['device']})",
          flush=True)

    per_example = (ms_big / args.batch) / (ms_small / args.small_batch)
    emptied = lambda e: round(float(np.mean(e)), 4)
    audio = lambda B, ms: round(B * U * FRAME_HOP_S / (ms / 1e3), 1)
    route = ("plain steps (fuse_model=False, use_pallas=False)" if args.plain
             else "fused v2 step (csrc/fused_class_step.cu)")
    record = {
        "config": "BASELINE configs[4] shape (v2 decode at B="
                  f"{args.batch}), {route}",
        "platform": "cpu" if args.cpu else card_platform(),
        "T": T, "U": U, "beam": W,
        "sharding": {
            "mesh": f"{args.ranks} data ranks ({sh['backend']}, "
                    f"{sh['device']})",
            "batch_axis": "data (beams rank-local; the decode needs no "
                          "collectives)",
            "params": "replicated",
        },
        "runs": [
            {"B": args.small_batch, "sharded": False,
             "ms_per_decode": round(ms_small, 1),
             "audio_s_per_s": audio(args.small_batch, ms_small)},
            {"B": args.batch, "sharded": False,
             "ms_per_decode": round(ms_big, 1),
             "audio_s_per_s": audio(args.batch, ms_big),
             "beam_emptied_rate": emptied(
                 out_big["beam_emptied"].cpu().numpy())},
            {"B": args.batch, "sharded": True,
             "ms_per_decode": round(sh["ms"], 1),
             "audio_s_per_s": audio(args.batch, sh["ms"]),
             "beam_emptied_rate": emptied(sh["out"]["beam_emptied"])},
        ],
        "scaling_note": (
            f"per-example time ratio B={args.batch} vs B={args.small_batch}"
            f", one process = {per_example:.2f}; {args.ranks} ranks vs one "
            f"process at B={args.batch} = {sh['ms'] / ms_big:.2f} (host "
            "clock; ranks on one card share it)"),
        "wall_s": round(time.time() - t_start, 1),
    }
    print(json.dumps(record, indent=1))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
    sys.exit(0)
