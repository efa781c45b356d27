"""Where a training step's time goes on the card.

    python3 -m ssnt_tts_tpu_torch.profile_train [--batch 32 256] [--seed 0]

At the benchmarked model width (vocab 128, mel 80, encoder 256 x 2 x 4
heads, decoder 256, joint rank 64, bf16 compute) and T=80, U=400 with
seeded random weights and synthetic batches, for each batch size:

  1. the train step split by layer (host clock, each part ending in a
     synchronize): the forward and the backward of the encoder, the
     teacher-forced decoder GRU loop, the lattice joints, the lattice
     loss (kernel route), the teacher-forced duration and tone AR class
     heads, and the optimizer. Each backward is taken alone, from a
     random cotangent on that layer's output, so the parts add up to a
     little more than one step;
  2. one whole train_step under torch.profiler: device busy time (the sum
     of the kernels' device time), the step's wall time, their ratio, the
     number of device kernels, and the kernels that take the most time.
     If the profiler records no device time it says so ("not measured").

Every line carries the card's name and power limit (nvidia-smi). Needs a
CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ssnt_tts_tpu_torch import data as data_lib
from ssnt_tts_tpu_torch.models.ssnt import lattice_loss
from ssnt_tts_tpu_torch.parallel import train as train_lib
from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

MODEL = dict(vocab_size=128, mel_dim=80, encoder_dim=256, encoder_layers=2,
             encoder_heads=4, decoder_dim=256, joint_rank=64)


def _timed(fn, reps: int = 3) -> float:
    """Median host-clock ms of fn() between synchronizes."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(out))


def _fwd_bwd_ms(fwd) -> tuple:
    """(forward ms, backward ms) of fwd() -> tensor or tuple of tensors,
    the backward from random cotangents; medians of 3."""
    def backward_s():
        out = fwd()
        ys = out if isinstance(out, tuple) else (out,)
        cots = [torch.randn_like(y) for y in ys]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.autograd.backward(ys, cots)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return _timed(fwd), 1e3 * float(np.median([backward_s()
                                               for _ in range(3)]))


def layer_split(state, batch) -> dict:
    model = state.model
    cfg = model.config
    toks, mel, il, ol = (batch[k] for k in train_lib.BATCH_KEYS[:4])
    with torch.no_grad():
        enc0 = model.encode(toks, il)
        dec0 = model.decoder_states(mel)
        q0 = model.lattice_quantities(enc0, dec0, mel, il)
    leaf = lambda x: x.detach().clone().requires_grad_()
    parts = {
        "encoder": lambda: model.encode(toks, il),
        "decoder_gru_loop": lambda: model.decoder_states(mel),
        "joints": lambda: model.lattice_quantities(leaf(enc0), leaf(dec0),
                                                   mel, il),
        "lattice_loss": lambda: lattice_loss(
            cfg.lattice_impl, cfg.lattice_dtype, tuple(map(leaf, q0)), il,
            ol, cfg.lattice_domain),
        "duration_and_tone_heads": lambda: (
            model.duration_ar_log_probs(leaf(enc0),
                                        batch["duration_target"]),
            model.tone_ar_log_probs(leaf(enc0), batch["tone_target"])),
    }
    split = {name: _fwd_bwd_ms(fn) for name, fn in parts.items()}
    tx = train_lib.make_optimizer(TrainConfig(warmup_steps=2))
    params = [p.detach().clone() for p in model.parameters()]  # copies
    grads = [torch.randn_like(p) for p in params]
    opt = tx.init(params)
    split["optimizer"] = (_timed(lambda: tx.update(grads, opt, params)),
                          0.0)
    return split


def profile_step(tx, state, batch) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_lib.train_step(tx, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for avg in prof.key_averages():
        dev = getattr(avg, "self_device_time_total", None)
        if dev is None:
            dev = getattr(avg, "self_cuda_time_total", 0.0)
        if dev > 0 and avg.self_cpu_time_total == 0:
            rows.append((dev, avg.count, avg.key))
    busy_us = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    return {
        "wall_ms": 1e3 * wall,
        "device_busy_ms": busy_us / 1e3 if busy_us else None,
        "busy_share": busy_us / 1e6 / wall if busy_us else None,
        "device_kernels": sum(r[1] for r in rows) if rows else None,
        "top": [{"kernel": k[:80], "ms": d / 1e3, "count": c}
                for d, c, k in rows[:8]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[32, 256])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    cfg = ModelConfig(**MODEL)
    for bsz in args.batch:
        tcfg = TrainConfig(warmup_steps=2, batch_size=bsz)
        state = train_lib.init_train_state(cfg, tcfg, seed=args.seed,
                                           device=dev)
        tx = train_lib.make_optimizer(tcfg)
        ds = data_lib.SyntheticTTSDataset(vocab_size=cfg.vocab_size,
                                          mel_dim=cfg.mel_dim,
                                          seed=args.seed)
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in ds.batch(bsz).items() if k != "alignment"}
        train_lib.train_step(tx, state, batch)  # warm
        split = layer_split(state, batch)
        total = sum(f + b for f, b in split.values())
        print(f"[split] {smi}: B={bsz} T=80 U=400 bf16, forward/backward "
              f"ms by layer (host clock): " + ", ".join(
                  f"{k} {f:.1f}/{b:.1f}" for k, (f, b) in split.items())
              + f"; sum {total:.1f}", flush=True)
        prof = profile_step(tx, state, batch)
        busy = ("not measured" if prof["busy_share"] is None
                else f"{prof['device_busy_ms']:.1f} ms device busy, "
                     f"share {prof['busy_share']:.3f}, "
                     f"{prof['device_kernels']} kernels")
        print(f"[profile] {smi}: B={bsz} one train step "
              f"{prof['wall_ms']:.1f} ms wall (profiled); {busy}",
              flush=True)
        print(json.dumps({"batch": bsz, "card": smi, "split_ms": split,
                          "profile": prof}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
