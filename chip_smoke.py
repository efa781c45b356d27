#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives ssnt_tts_tpu_torch at the repo's benchmarked model width
(vocab 128, mel 80, encoder 256 x 2 layers x 4 heads, decoder 256,
10 duration classes, bfloat16 compute) with seeded random weights, in
phases, each reported on its own line:

  1. device: torch's name for the card and nvidia-smi's name/power limit;
  2. build: compile csrc/fused_v2_step.cu with nvcc (ptxas report);
  3. step check at B=32, W=8, H=256, D=10, float32 and bfloat16: the
     kernel's class log-probs h and new GRU state against the plain
     PyTorch step (tolerance 1e-4 f32, 3e-2 bf16), and the plain selection
     run on the kernel's own h against the kernel's selected beams and
     reordered state, bit for bit;
  4. serve: 3 requests of B=32 (T=80, U=400, ragged lengths, bf16)
     through encode -> v2_duration_decode -> synthesize_from_alignment,
     counting the fused kernel's launches (T per request);
  5. the same requests with the plain step (fuse_model=False), float32
     and bfloat16: share of utterances whose durations agree;
  6. timings: the fused step against the plain step (CUDA events; device
     time under a CUDA graph, and per eager call), and one request end to
     end (host clock, split into decode, encode and synthesis).

Then one JSON line describing the kernel, and as the last line
{"ok": true, "device": {...}}. Any failed check raises (non-zero exit,
no result line). Without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

B, T, U, W = 32, 80, 400, 8
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SERVE_CFG = dict(vocab_size=128, mel_dim=80, encoder_dim=256,
                 encoder_layers=2, encoder_heads=4, decoder_dim=256,
                 joint_rank=64)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_model(cfg, tree, dtype: str, dev):
    from ssnt_tts_tpu_torch import convert
    from ssnt_tts_tpu_torch.models.ssnt import SSNTModel

    cfg = dataclasses.replace(cfg, dtype=dtype)
    model = SSNTModel(cfg, device=dev)
    model.load_state_dict(convert.flax_to_torch(tree, cfg))
    return model.eval()


def make_request(rng, vocab: int, dev):
    il = rng.integers(40, T + 1, B)
    il[0] = T
    ol = np.minimum(U, np.round(il * rng.uniform(4.2, 5.0, B))).astype(int)
    ol[0] = U
    toks = rng.integers(1, vocab, (B, T))
    as_t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return as_t(toks), as_t(il), as_t(ol)


def step_inputs(model, req, s: int, rng, dev):
    """Beam state for one step at step s: most beams at t = s with totals
    near the diagonal, some finished or at their last position, and
    duplicated beams (dedup)."""
    from ssnt_tts_tpu_torch.models import stepmath
    from ssnt_tts_tpu_torch.ops import beam_fused

    toks, il, ol = req
    with torch.no_grad():
        w = model.duration_step_weights()
        enc = model.encode(toks, il)
        xin, base = stepmath.class_decode_paths(w, enc, il, model.dtype)
        fw = beam_fused.prepare_fused_weights(w, model.dtype)
    H = model.config.decoder_dim
    D = model.config.duration_class_size
    il_n, ol_n = il.cpu().numpy(), ol.cpu().numpy()
    t = np.minimum(s, il_n)[:, None].repeat(W, 1)
    last = rng.random((B, W)) < 0.1
    t[last] = il_n[np.nonzero(last)[0]] - 1
    tot = np.round(ol_n[:, None] / il_n[:, None] * t) + rng.integers(
        -10, 10, (B, W))
    fin = rng.random((B, W)) < 0.15
    lp = -rng.gamma(2.0, 2.0 + s / 4, (B, W))
    state = rng.normal(0, 0.5, (B, W, H))
    pc = rng.integers(0, D, (B, W))
    for a in (t, tot, fin, lp, state, pc):  # beams 0 and 1 identical
        a[::3, 1] = a[::3, 0]
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return (s, xin, base, fw, i32(pc),
            torch.tensor(state, dtype=torch.float32, device=dev),
            torch.tensor(lp, dtype=torch.float32, device=dev),
            torch.tensor(fin, device=dev), i32(np.maximum(tot, 0)), i32(t),
            i32(t), il, ol,
            torch.tensor(model.config.duration_table, dtype=torch.int32,
                         device=dev),
            torch.tensor(rng.random(B) < 0.1, device=dev))


def same_bits(a, b) -> bool:
    return bool(torch.equal(a, b)) and (
        not a.is_floating_point()
        or bool(torch.equal(torch.signbit(a), torch.signbit(b))))


def check_step(args, opts, dtype) -> tuple:
    """Phase 3 for one input set: returns (max |dh|, max |dnew_h|)."""
    from ssnt_tts_tpu_torch.ops import beam_fused, beam_v2

    s, xin, base, fw, pc, state, lp, fin, tot, t, u, il, ol, dtab, emp = args
    if opts.get("test_mode"):
        ol = torch.zeros_like(ol)
        args = args[:12] + (ol,) + args[13:]
    dev = state.device
    dbg_k = (torch.empty(B, W, base.shape[2], device=dev),
             torch.empty_like(state))
    dbg_r = tuple(torch.empty_like(x) for x in dbg_k)
    with torch.no_grad():
        k = beam_fused.fused_class_beam_step(*args, debug_out=dbg_k, **opts)
        beam_fused.fused_class_beam_step_reference(*args, debug_out=dbg_r,
                                                   **opts)
        torch.cuda.synchronize()
        err_h = (dbg_k[0] - dbg_r[0]).abs().max().item()
        err_n = (dbg_k[1] - dbg_r[1]).abs().max().item()
        if not (err_h <= TOL[dtype] and err_n <= TOL[dtype]):
            raise AssertionError(f"kernel vs plain model step: |dh| {err_h} "
                                 f"|dnew_h| {err_n} > {TOL[dtype]}")
        # The plain selection on the kernel's own h must reproduce the
        # kernel's selection exactly.
        sel = beam_v2.beam_search_step(
            dbg_k[0], lp, fin, tot, dtab, t, u, il, ol,
            zero_duration_id=opts.get("zero_duration_id", 0),
            allow_skip=opts.get("allow_skip", False),
            test_mode=opts.get("test_mode", False),
            config=opts.get("config"))
        want = list(sel) + [
            emp | (sel[7] == 0),
            torch.gather(dbg_k[1], 1,
                         sel[6].long()[..., None].expand_as(dbg_k[1]))]
        for name, a, b in zip(beam_fused.V2Step._fields, k, want):
            if not same_bits(a, b):
                raise AssertionError(f"selection differs on {name} "
                                     f"({opts}, step {s})")
    return err_h, err_n


def serve(model, req, *, config=None, fuse_model=None, times=None):
    """encode -> v2_duration_decode -> synthesize_from_alignment (best
    beam). With a `times` dict, records each stage's host-clock ms (every
    stage ends in a synchronize): decode (with its own encode), encode,
    synthesis, total."""
    from ssnt_tts_tpu_torch.parallel import decode

    toks, il, ol = req
    stamps = []

    def stamp():
        if times is not None:
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

    with torch.no_grad():
        stamp()
        out = decode.v2_duration_decode(
            model, toks, il, ol, model.config.duration_table, beam_width=W,
            max_frames=U, config=config, fuse_model=fuse_model)
        stamp()
        enc = model.encode(toks, il)
        stamp()
        mel = model.synthesize_from_alignment(enc,
                                              out["source_indexes"][:, 0])
        stamp()
    if times is not None:
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        times.update(decode=ms[0], encode=ms[1], synthesis=ms[2],
                     total=sum(ms))
    return out, mel


def check_request(i, out, mel, req) -> int:
    _, il, ol = req
    emptied = out["beam_emptied"]
    ok = ~emptied
    n_ok = int(ok.sum())
    if not torch.isfinite(mel).all():
        raise AssertionError(f"request {i}: mel is not finite")
    if mel.shape != (B, U, SERVE_CFG["mel_dim"]):
        raise AssertionError(f"request {i}: mel shape {tuple(mel.shape)}")
    if n_ok == 0:
        raise AssertionError(f"request {i}: every utterance emptied")
    if not (out["output_length"][ok] == ol[ok, None]).all():
        raise AssertionError(f"request {i}: a non-emptied utterance's "
                             f"beams miss their output length")
    lp = out["log_prob"][ok]
    # Slot 0 is the best beam. (Later slots are not sorted in general:
    # pad-by-repetition and the diagonal re-injection break the order.)
    if not (lp[:, 0] == lp.max(dim=1).values).all():
        raise AssertionError(f"request {i}: slot 0 is not the best beam")
    br = out["beam_branch"]
    if not ((br >= 0) & (br < W)).all():
        raise AssertionError(f"request {i}: beam_branch out of [0, {W})")
    return B - n_ok


def graph_ms(fn, k: int = 20, reps: int = 20) -> float:
    """Device time per call of fn: CUDA events around replays of a CUDA
    graph holding k calls (no host launch cost in the measurement)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(k):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (k * reps)


def eager_ms(fn, n: int = 50) -> float:
    """Per-call time of fn issued eagerly (host launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    from ssnt_tts_tpu_torch import convert
    from ssnt_tts_tpu_torch.ops import _build, beam_fused
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, V2BeamConfig

    # True float32 on the plain path: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.time()

    # ---- 1. device ----
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] torch: {kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # ---- 2. build ----
    t0 = time.time()
    build_log = _build.build_log("fused_v2_step")
    _build.fused_v2_library()
    ptxas = [ln.strip() for ln in build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[2 build] fused_v2_step.cu built/loaded in {time.time() - t0:.1f}s")
    for ln in ptxas:
        log(f"[2 build] ptxas: {ln}")

    cfg = ModelConfig(**SERVE_CFG)
    tree = convert.random_flax_tree(cfg, args.seed)
    models = {dt: make_model(cfg, tree, name, dev) for dt, name in
              ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"))}
    rng = np.random.default_rng(args.seed)
    reqs = [make_request(rng, cfg.vocab_size, dev) for _ in range(3)]

    # ---- 3. step check ----
    option_sets = [
        {}, {"config": V2BeamConfig(final_feasible_guard=True)},
        {"allow_skip": True}, {"test_mode": True},
    ]
    worst = {}
    for dt, model in models.items():
        errs = []
        for s in (0, 30, T - 1):
            inputs = step_inputs(model, reqs[0], s, rng, dev)
            for opts in option_sets:
                errs.append(check_step(inputs, opts, dt))
        worst[dt] = (max(e[0] for e in errs), max(e[1] for e in errs))
        log(f"[3 step] {str(dt)[6:]}: {len(errs)} steps, selection "
            f"bit-exact; max |dh| {worst[dt][0]:.3e} max |dnew_h| "
            f"{worst[dt][1]:.3e} (tol {TOL[dt]})")

    # ---- 4. serve (the main path) ----
    bf = models[torch.bfloat16]
    req_cfgs = [None, None, V2BeamConfig(final_feasible_guard=True)]
    beam_fused.fused_class_beam_step.launches = 0
    served = []
    for i, (req, c) in enumerate(zip(reqs, req_cfgs), 1):
        before = beam_fused.fused_class_beam_step.launches
        out, mel = serve(bf, req, config=c)
        torch.cuda.synchronize()
        n = beam_fused.fused_class_beam_step.launches - before
        if n != T:
            raise AssertionError(f"request {i}: {n} kernel launches, not {T}")
        n_empty = check_request(i, out, mel, req)
        served.append(out)
        log(f"[4 serve] request {i} ({'guard' if c else 'defaults'}): "
            f"{n} launches, emptied {n_empty}/{B}, mel {tuple(mel.shape)}")
    launches = beam_fused.fused_class_beam_step.launches
    if launches != 3 * T:
        raise AssertionError(f"main path: {launches} launches, not {3 * T}")

    # ---- 5. kernel vs plain over the whole path ----
    for dt, model in models.items():
        agree = []
        for i, (req, c) in enumerate(zip(reqs, req_cfgs)):
            fused = served[i] if dt == torch.bfloat16 else serve(
                model, req, config=c)[0]
            plain = serve(model, req, config=c, fuse_model=False)[0]
            agree.append((fused["durations"] == plain["durations"])
                         .all(dim=2).all(dim=1).float().mean().item())
        log(f"[5 path] {str(dt)[6:]}: utterances whose durations agree, "
            f"kernel vs plain, per request: "
            + ", ".join(f"{a:.3f}" for a in agree))

    # ---- 6. timings ----
    step_args = step_inputs(bf, reqs[0], 30, rng, dev)
    with torch.no_grad():
        k_ms = graph_ms(lambda: beam_fused.fused_class_beam_step(*step_args))
        p_ms = graph_ms(
            lambda: beam_fused.fused_class_beam_step_reference(*step_args))
        k_eager = eager_ms(
            lambda: beam_fused.fused_class_beam_step(*step_args))
        p_eager = eager_ms(
            lambda: beam_fused.fused_class_beam_step_reference(*step_args))
    log(f"[6 time] {smi}: v2 step B={B} W={W} bf16, device time per step "
        f"(CUDA graph): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; eager "
        f"per call: kernel {k_eager:.4f} ms, plain {p_eager:.4f} ms")
    for fm, label in ((None, "kernel"), (False, "plain")):
        serve(bf, reqs[0], fuse_model=fm)  # warm
        ms = {}
        serve(bf, reqs[0], fuse_model=fm, times=ms)
        log(f"[6 time] {smi}: one request B={B} T={T} U={U} bf16 end to end "
            f"({label} step): {ms['total']:.1f} ms = decode (with its "
            f"encode) {ms['decode']:.1f} + encode {ms['encode']:.1f} + "
            f"synthesis {ms['synthesis']:.1f}")

    log(json.dumps({"kernels": [{
        "name": "fused_v2_step", "route": "cuda",
        "source": "ssnt_tts_tpu_torch/csrc/fused_v2_step.cu",
        "replaces": "ssnt_tts_tpu/ops/beam_fused.py:486",
        "launches": launches,
        "max_abs_err": max(worst[torch.float32]),
        "ms": k_ms, "plain_ms": p_ms,
    }]}))
    log(f"[done] {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
