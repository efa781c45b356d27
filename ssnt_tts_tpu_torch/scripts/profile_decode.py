"""The v1 decode step's cost split by component ablation (the port of
scripts/profile_decode.py; docs/DECODE_PROFILE.md).

Each component of one frame of beam_decode is chained alone with
utils/timing.bench_step (the slope timer; CUDA events on the card) and
timed in us a step, so the parts add up to about the whole frame:

  full    one frame of beam_decode off the fused route, its own code
          (parallel/decode.v1_beam_only_step): SSNTModel.decode_step, the
          beam step over h with [state | mel | prev_mel | fin | t] rows
          (route "beam-only": #11 beam_search_step_reorder; "plain":
          beam_v1's step and the gather of the rows, JAX's
          USE_PALLAS=False branch), the finished-beam mel keep;
  model   SSNTModel.decode_step alone (GRU cell, transition and frame
          joints);
  beam    the beam step alone on a fixed h that depends on the carry
          ("beam-only": #10 beam_search_step_batched; "plain":
          beam_v1.beam_search_decode_batched);
  gather  the parent-pointer reorder of the state rows alone;
  unattributed  full less the sum of the other three.

Width and batch are JAX's script's: vocab 128, mel 80, encoder 256 x 2 x
4 heads, decoder 256, joint rank 64 (bf16), B=32, W=8, T=80, U=400,
tokens from numpy's default_rng(0), every utterance at full length;
weights convert.random_flax_tree(cfg, 0). The record holds each
component's us a step and the steps bench_step ran it (each beam-only
step launches its kernel once). With --rounds R the components are timed
in turn R times, each the median of its rounds (rounds_us shows the
host clock's drift between them). With --trace DIR, torch.profiler also
records TRACE_FRAMES full steps and the record gives the device's busy
share of them (kernel time over their host-clock span).

  python -m ssnt_tts_tpu_torch.scripts.profile_decode [--route plain] \\
      [--trace build/profile_decode] [--json profile.json]
  python -m ssnt_tts_tpu_torch.scripts.profile_decode --cpu --tiny \\
      --batch 2 --beam 2 --seq 6 12 --max-iters 40
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ssnt_tts_tpu_torch import dryrun
from ssnt_tts_tpu_torch.ops import beam_fused, beam_kernels, beam_v1
from ssnt_tts_tpu_torch.parallel import decode as decode_lib
from ssnt_tts_tpu_torch.scripts.decode_scale import card_platform
from ssnt_tts_tpu_torch.utils import profiling
from ssnt_tts_tpu_torch.utils.config import tiny_model_config
from ssnt_tts_tpu_torch.utils.device import resolve_device
from ssnt_tts_tpu_torch.utils.timing import bench_step

COMPONENTS = ("full", "model", "beam", "gather")
ROUTES = ("beam-only", "plain")
TRACE_FRAMES = 20  # full steps under the profiler, after a warm one


def reorder_step(route: str):
    """The beam step with the reorder of the rows, as beam_decode takes
    it on `route`."""
    return {"beam-only": beam_kernels.beam_search_step_reorder,
            "plain": beam_kernels.beam_search_step_reorder_reference}[route]


def beam_only_step(route: str):
    """The beam step without rows on `route`."""
    return {"beam-only": beam_kernels.beam_search_step_batched,
            "plain": beam_v1.beam_search_decode_batched}[route]


def initial_carry(B: int, W: int, H: int, M: int, dev) -> tuple:
    """beam_decode's carry before its first frame: (t, u, log_prob,
    is_finished, state, prev_mel)."""
    z = lambda dt: torch.zeros(B, W, dtype=dt, device=dev)
    return (z(torch.int32), z(torch.int32), z(torch.float32), z(torch.bool),
            torch.zeros(B, W, H, device=dev), torch.zeros(B, W, M, device=dev))


def full_frame(model, enc, input_length, route: str, carry):
    """One frame of beam_decode's `route` from `carry`: the
    beam_fused.V1FusedStep decode.v1_beam_only_step returns."""
    t, u, lp, fin, state, prev_mel = carry
    return decode_lib.v1_beam_only_step(model, enc, input_length, t, u, lp,
                                        fin, state, prev_mel,
                                        reorder_step(route))


def make_full_step(model, enc, input_length, route: str):
    """carry -> carry: one frame (full_frame), as JAX's full_step."""

    def step(carry):
        o = full_frame(model, enc, input_length, route, carry)
        return (o.next_t, o.next_u, o.log_prob, o.is_finished, o.state,
                o.mel)
    return step


def make_model_step(model, enc):
    """(state, prev_mel) -> (state, mel): decode_step at t = 0, the new
    state tied to h by a 1e-20 term so nothing goes unused."""

    def step(carry):
        state, prev_mel = carry
        t = torch.zeros(state.shape[:2], dtype=torch.int32,
                        device=state.device)
        h, new_state, mel = model.decode_step(enc, t, state, prev_mel)
        return new_state + h.sum(-1, keepdim=True) * 1e-20, mel
    return step


def make_beam_step(h0, input_length, route: str):
    """(t, u, log_prob, is_finished) -> the same: the beam step alone on
    h0 + log_prob * 1e-20 (h depends on the carry, so each step waits on
    the last), its log-probs scaled by 1e-6 to stay finite."""
    fn = beam_only_step(route)

    def step(carry):
        t, u, lp, fin = carry
        h = h0 + lp[..., None] * 1e-20
        _, lp2, nt, nu, nfin, _ = fn(h, lp, fin, t, u, input_length)[:6]
        return nt, nu, lp2 * 1e-6, nfin
    return step


def make_gather_step(H: int, M: int):
    """(state, prev_mel) -> the same through the reorder of [state |
    prev_mel | prev_mel] by a parent pointer of 0 that depends on the
    state."""

    def step(carry):
        state, prev_mel = carry
        branch = (torch.zeros(state.shape[:2], dtype=torch.int32,
                              device=state.device)
                  + (state[:, :1, 0] * 0).to(torch.int32))
        rows = beam_fused.reorder_state(
            torch.cat([state, prev_mel, prev_mel], dim=-1), branch)
        return rows[..., :H], rows[..., H:H + M]
    return step


def counted(step):
    """step, counting its calls in .calls."""

    def wrapped(carry):
        wrapped.calls += 1
        return step(carry)

    wrapped.calls = 0
    return wrapped


@torch.no_grad()
def decode_by_frames(model, tokens, input_length, frames: int, W: int,
                     route: str) -> dict:
    """beam_decode's outputs from `frames` full_frame calls (the profiled
    step run as the decode), and "kept": how many beam-frames took the
    finished-beam mel keep (a beam finished before the frame and after
    it)."""
    cfg = model.config
    il = input_length.to(torch.int32).contiguous()
    enc = model.encode(tokens, il)
    carry = initial_carry(tokens.shape[0], W, cfg.decoder_dim, cfg.mel_dim,
                          tokens.device)
    outs, kept = [], 0
    for _ in range(frames):
        o = full_frame(model, enc, il, route, carry)
        fin_prev = torch.gather(carry[3], 1, o.branch.long())
        kept += int((o.is_finished & fin_prev).sum())
        carry = (o.next_t, o.next_u, o.log_prob, o.is_finished, o.state,
                 o.mel)
        outs.append(o)
    stack = lambda k: torch.stack([getattr(o, k) for o in outs], 1)
    out = decode_lib.v1_postprocess(stack("branch"), stack("t_history"),
                                    stack("mel"), stack("prediction"),
                                    carry[2], carry[1])
    out["kept"] = kept
    return out


def main(argv=None, outputs=None) -> dict:
    """Times the components and returns the record. A dict `outputs`
    receives the model, the tokens and input lengths, and the step
    functions by component."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--route", choices=ROUTES, default="beam-only",
                   help="the beam step: the beam-only kernels (#11 / #10; "
                   "their plain versions on the CPU) or JAX's plain branch")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--beam", type=int, default=8)
    p.add_argument("--seq", type=int, nargs=2, default=[80, 400],
                   metavar=("T", "U"))
    p.add_argument("--trace", default=None,
                   help="also record full steps with torch.profiler here")
    p.add_argument("--max-iters", type=int, default=5000,
                   help="bench_step's longest chain")
    p.add_argument("--rounds", type=int, default=1,
                   help="time the components in turn this many times; "
                   "each is the median of its rounds")
    p.add_argument("--tiny", action="store_true",
                   help="tiny_model_config (default: JAX's script's width)")
    p.add_argument("--json", type=str, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    args = p.parse_args(argv)

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = tiny_model_config() if args.tiny else dryrun.FULL_CONFIG
    B, W = args.batch, args.beam
    T, U = args.seq
    H, M = cfg.decoder_dim, cfg.mel_dim
    model = dryrun.make_model(cfg, None, 0, dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(1, cfg.vocab_size, (B, T)),
                             dtype=torch.int32, device=dev)
    rng.normal(0, 1, (B, U, M))  # JAX's script draws the init batch's mel
    il = torch.full((B,), T, dtype=torch.int32, device=dev)
    h0 = torch.as_tensor(rng.normal(0, 1, (B, W, 2)), dtype=torch.float32,
                         device=dev)
    t_start = time.time()
    with torch.no_grad():
        enc = model.encode(tokens, il)
    carry0 = initial_carry(B, W, H, M, dev)
    steps = {
        "full": (make_full_step(model, enc, il, args.route), carry0),
        "model": (make_model_step(model, enc), carry0[4:6]),
        "beam": (make_beam_step(h0, il, args.route), carry0[:4]),
        "gather": (make_gather_step(H, M), carry0[4:6]),
    }
    if outputs is not None:
        outputs.update(model=model, tokens=tokens, input_length=il,
                       steps={k: v[0] for k, v in steps.items()})
    counters = {k: counted(fn) for k, (fn, _) in steps.items()}
    rounds = {k: [] for k in COMPONENTS}
    for r in range(args.rounds):
        for name in COMPONENTS:
            with torch.no_grad():
                rounds[name].append(bench_step(
                    counters[name], steps[name][1], n_lo=20, n_hi=100,
                    max_iters=args.max_iters) * 1e6)
            print(f"[profile_decode] round {r} {name:>12}: "
                  f"{rounds[name][-1]:8.2f} us/step", flush=True)
    us = {k: float(np.median(v)) for k, v in rounds.items()}
    calls = {k: c.calls for k, c in counters.items()}
    parts = sum(us[k] for k in COMPONENTS[1:])
    record = {
        **{k: round(us[k], 3) for k in COMPONENTS},
        "components_sum": round(parts, 3),
        "unattributed": round(us["full"] - parts, 3),
        "route": args.route,
        "config": {"vocab": cfg.vocab_size, "mel": M,
                   "encoder": [cfg.encoder_dim, cfg.encoder_layers,
                               cfg.encoder_heads],
                   "decoder": H, "joint_rank": cfg.joint_rank,
                   "dtype": cfg.dtype},
        "B": B, "W": W, "T": T, "U": U,
        "platform": "cpu" if args.cpu else card_platform(),
        "steps": calls,
        "rounds_us": {k: [round(x, 3) for x in v] for k, v in
                      rounds.items()},
    }
    if args.trace:
        full, c = steps["full"][0], carry0
        with torch.no_grad():
            c = full(c)  # warm
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            with profiling.trace(args.trace) as prof:
                t0 = time.perf_counter()
                for _ in range(TRACE_FRAMES):
                    c = full(c)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wall = (time.perf_counter() - t0) * 1e3
        k = profiling.kernel_time(prof.trace_file)
        record["steps"]["traced"] = TRACE_FRAMES + 1
        record["trace"] = {
            "file": prof.trace_file, "frames": TRACE_FRAMES,
            "wall_ms": round(wall, 3), "kernels": k["kernels"],
            "busy_ms": k["busy_ms"],
            "busy_share": (None if k["busy_ms"] is None
                           else round(k["busy_ms"] / wall, 4))}
        print(f"[profile_decode] trace of {TRACE_FRAMES} full steps: "
              f"{record['trace']}", flush=True)
    record["wall_s"] = round(time.time() - t_start, 1)
    print(json.dumps(record, indent=1), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(record, indent=1))
    return record


if __name__ == "__main__":
    main()
    sys.exit(0)
