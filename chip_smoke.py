#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives ssnt_tts_tpu_torch at the repo's benchmarked model width
(vocab 128, mel 80, encoder 256 x 2 layers x 4 heads, decoder 256,
joint rank 64, 10 duration classes, bfloat16 compute) with seeded random
weights, in phases, each reported on its own line:

  1. device: torch's name for the card and nvidia-smi's name/power limit;
  2. build: compile csrc/fused_v2_step.cu and csrc/lattice.cu with nvcc,
     one process each, at once (ptxas report);
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
     end (host clock, split into decode, encode and synthesis);
  7. lattice check: each lattice kernel against its plain version on
     ragged lengths with an il = ol = 1 and a degenerate example: the
     bidirectional kernel at B=32 T=80 U=400 (alphas, betas, loss, and the
     gradients after the posterior pass), forward alphas and backward
     gradients at B=256 in float32 and bfloat16 storage;
  8. train (the training path): run_training at B=32 for 10 steps (one
     bidirectional launch each), one no-grad loss (one forward-alphas
     launch), run_training at B=256 for 2 steps in float32 and 2 in
     bfloat16 lattice storage (one forward and one backward launch each),
     and one B=32 step through the plain lattice route from the same
     weights and batch as a kernel-route step (no launches; loss and
     grad_norm agree);
  9. timings: each lattice kernel and its plain version (device time,
     CUDA graph), both lattice routes at both batch sizes, and the train
     step at B=32 and B=256 on both routes, split into forward, backward
     and optimizer (host clock, each part ending in a synchronize).

Then one JSON line describing the kernels, and as the last line
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
B_LARGE = 256
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# Lattice kernel vs plain version (same operations in the same order; only
# the exp/log1p implementations may differ by an ulp): alphas, betas and
# losses within 1e-5 relative (of max(1, |value|)), float32 gradients
# (posteriors times g = 1, in [0, 1]) within 1e-5, bfloat16 gradients
# within one bf16 ulp below 1 (2^-8).
LAT_REL, GRAD_F32, GRAD_BF16 = 1e-5, 1e-5, 2.0 ** -8
# Kernel route vs plain route, one bf16 train step from the same weights:
# the lattice gradients agree to ~1e-6, then the bf16 backward rounds them
# (a flipped rounding moves a bf16 value by 2^-8 relative).
ROUTE_LOSS_RTOL, ROUTE_NORM_RTOL = 1e-5, 1e-2
# Card peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, float32 (non
# tensor core) and bf16 tensor-core operations/s.
HBM_BPS, F32_OPS, BF16_OPS = 3.35e12, 67e12, 989e12
SERVE_CFG = dict(vocab_size=128, mel_dim=80, encoder_dim=256,
                 encoder_layers=2, encoder_heads=4, decoder_dim=256,
                 joint_rank=64)


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, ops_rate: float):
    """(least ms for the work, "bytes" or "operations")."""
    tb, to = nbytes / HBM_BPS, ops / ops_rate
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


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


def lattice_inputs(rng, Bn: int, dtype, dev):
    """A (U, B, T) lattice (transition log-probs, Gaussian-like frame
    log-likelihoods) and ragged lengths: example 0 full, 1 with
    il = ol = 1, 2 degenerate (ol < il: no path reaches t = il-1)."""
    le = np.log(rng.uniform(0.1, 0.9, (U, Bn, T)))
    ls = np.log1p(-np.exp(le))
    lf = rng.normal(-2.0, 1.0, (U, Bn, T))
    il = rng.integers(T // 2, T + 1, Bn)
    ol = np.minimum(U, np.round(il * rng.uniform(4.2, 5.0, Bn)))
    il[0], ol[0] = T, U
    il[1], ol[1] = 1, 1
    il[2], ol[2] = T, T - 1
    lat = [torch.tensor(x, dtype=torch.float32, device=dev).to(dtype)
           for x in (le, ls, lf)]
    lens = [torch.tensor(x, dtype=torch.int32, device=dev) for x in (il, ol)]
    return lat, lens


def lattice_err(got, want, what: str) -> tuple:
    """(max |got - want|, max |got - want| / max(1, |want|)) over finite
    cells, the second held to LAT_REL; where want is a masked cell
    (<= NEG/2), got must be one too."""
    from ssnt_tts_tpu_torch.ops.lattice import NEG

    masked = want <= NEG / 2
    if not bool((got[masked] <= NEG / 2).all()):
        raise AssertionError(f"{what}: a masked cell came out finite")
    d = (got - want).abs()[~masked]
    rel = float((d / want.abs()[~masked].clamp(min=1.0)).max())
    if not rel <= LAT_REL:
        raise AssertionError(f"{what}: relative error {rel} > {LAT_REL}")
    return float(d.max()), rel


def grad_err(got, want, tol: float, what: str) -> float:
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    if not err <= tol:
        raise AssertionError(f"{what}: gradient error {err} > {tol}")
    if any(bool(d[:, 2].float().any()) for d in got):
        raise AssertionError(f"{what}: degenerate example's gradients "
                             f"are not exactly 0")
    return err


def check_lattice(rng, dev):
    """Phase 7. Returns the float32 max errors (bidir, fwd, bwd)."""
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    (le, ls, lf), (il, ol) = lattice_inputs(rng, B, torch.float32, dev)
    g = torch.ones(B, device=dev)
    with torch.no_grad():
        ka, kb = lk.lattice_bidir(le, ls, lf, il, ol)
        ra, rb = lk.lattice_bidir_reference(le, ls, lf, il, ol)
        torch.cuda.synchronize()
        e_bidir = max(lattice_err(ka, ra, "bidir alphas"),
                      lattice_err(kb, rb, "bidir betas"))  # (abs, rel)
        kz = lat.gather_logz(ka, le, il, ol)
        rz = lat.gather_logz(ra, le, il, ol)
        lattice_err(kz, rz, "bidir logz")
        kg = lat.posterior_grads(le, ls, lf, ka, kb, kz, il, ol, g)
        rg = lat.posterior_grads(le, ls, lf, ra, rb, rz, il, ol, g)
        e_post = grad_err(kg, rg, GRAD_F32, "bidir + posterior pass")
    log(f"[7 lattice] bidir B={B} T={T} U={U} f32: alphas/betas max abs "
        f"err {e_bidir[0]:.3e}, rel err {e_bidir[1]:.3e}, grads after the "
        f"posterior pass {e_post:.3e} "
        f"(tol {LAT_REL}, {GRAD_F32}); degenerate grads exactly 0")
    errs = {}
    for dtype, gtol in ((torch.float32, GRAD_F32),
                        (torch.bfloat16, GRAD_BF16)):
        (le, ls, lf), (il, ol) = lattice_inputs(rng, B_LARGE, dtype, dev)
        g = torch.ones(B_LARGE, device=dev)
        with torch.no_grad():
            ka = lk.lattice_forward_alphas(le, ls, lf)
            ra = lk.lattice_forward_alphas_reference(le, ls, lf)
            torch.cuda.synchronize()
            e_fwd = lattice_err(ka, ra, f"forward alphas {dtype}")
            z = lat.gather_logz(ra, le, il, ol)
            kd = lk.lattice_backward_grads(le, ls, lf, ra, il, ol, g, z)
            rd = lk.lattice_backward_grads_reference(le, ls, lf, ra, il, ol,
                                                     g, z)
            torch.cuda.synchronize()
            if any(d.dtype != dtype for d in kd):
                raise AssertionError("backward grads not in the input dtype")
            e_bwd = grad_err(kd, rd, gtol, f"backward grads {dtype}")
        errs[dtype] = (e_fwd, e_bwd)
        log(f"[7 lattice] B={B_LARGE} {str(dtype)[6:]} storage: forward "
            f"alphas max abs err {e_fwd[0]:.3e}, rel err {e_fwd[1]:.3e} "
            f"(tol {LAT_REL}), backward grads "
            f"{e_bwd:.3e} (tol {gtol}); degenerate grads exactly 0")
    (e_fwd, _), e_bwd = errs[torch.float32]
    return e_bidir[0], e_fwd, e_bwd


def to_device(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
            if k != "alignment"}


def split_step_ms(tx, state, batch, reps: int = 3) -> dict:
    """Host-clock ms of train_step's parts (model.loss, backward, the
    optimizer), each ending in a synchronize; median of `reps` steps."""
    from ssnt_tts_tpu_torch.parallel import train as train_lib

    parts = []
    for _ in range(reps):
        model = state.model
        params = list(model.parameters())
        for p in params:
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(*(batch.get(k) for k in train_lib.BATCH_KEYS))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        tx.update([p.grad if p.grad is not None else torch.zeros_like(p)
                   for p in params], state.opt_state,
                  [p.detach() for p in params])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts.append((t1 - t0, t2 - t1, t3 - t2))
    fwd, bwd, opt = (1e3 * float(np.median(x)) for x in zip(*parts))
    return {"forward": fwd, "backward": bwd, "optimizer": opt,
            "total": fwd + bwd + opt}


def train_phases(seed: int, dev, smi: str) -> list:
    """Phases 7-9; returns the lattice kernels' entries of the JSON line."""
    import dataclasses as dc
    from pathlib import Path

    from ssnt_tts_tpu_torch import data as data_lib
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk
    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.train_loop import run_training
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

    rng = np.random.default_rng(seed + 1)
    # ---- 7. lattice kernels against their plain versions ----
    e_bidir, e_fwd, e_bwd = check_lattice(rng, dev)

    # ---- 8. train (the main path) ----
    cfg = ModelConfig(**SERVE_CFG)
    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    counts = lambda: tuple(k.launches for k in lk.KERNELS)

    def train_run(name, steps, bsz, mcfg, want):
        path = out_dir / f"{name}.jsonl"
        path.unlink(missing_ok=True)
        before = counts()
        t0 = time.perf_counter()
        last = run_training(steps, mcfg, TrainConfig(
            warmup_steps=2, batch_size=bsz), seed=seed, device=dev,
            metrics_path=str(path), log_every=1)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = tuple(a - b for a, b in zip(counts(), before))
        if got != want:
            raise AssertionError(f"{name}: launches (bidir, fwd, bwd) "
                                 f"{got}, not {want}")
        rows = [json.loads(x) for x in path.read_text().splitlines()]
        if len(rows) != steps or not all(
                np.isfinite(v) for r in rows for v in r.values()):
            raise AssertionError(f"{name}: metrics missing or not finite")
        log(f"[8 train] {name}: {steps} steps B={bsz} T={T} U={U} in "
            f"{secs:.1f}s, launches (bidir, fwd, bwd) {got}; loss "
            + " ".join(f"{r['loss']:.4f}" for r in rows)
            + f"; last grad_norm {last['grad_norm']:.4f}")

    for k in lk.KERNELS:
        k.launches = 0
    train_run("b32", 10, B, cfg, (10, 0, 0))
    train_tcfg = TrainConfig(warmup_steps=2, batch_size=B)
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim, seed=seed + 2)
    batch32 = to_device(ds.batch(B), dev)
    state_k = train_lib.init_train_state(cfg, train_tcfg, seed=seed,
                                         device=dev)
    before = counts()
    with torch.no_grad():
        nll = state_k.model(*(batch32[k] for k in train_lib.BATCH_KEYS[:4]))
    torch.cuda.synchronize()
    if tuple(a - b for a, b in zip(counts(), before)) != (0, 1, 0):
        raise AssertionError("no-grad loss: not one forward-alphas launch")
    if nll.shape != (B,) or not bool(torch.isfinite(nll).all()):
        raise AssertionError("no-grad loss: not B finite values")
    log(f"[8 train] no-grad loss B={B}: 1 forward-alphas launch, mean NLL "
        f"per utterance {float(nll.mean()):.3f}")
    train_run("b256", 2, B_LARGE, cfg, (0, 2, 2))
    train_run("b256_bf16_lattice", 2, B_LARGE,
              dc.replace(cfg, lattice_dtype="bfloat16"), (0, 2, 2))
    cfg_plain = dc.replace(cfg, lattice_impl="xla")
    state_p = train_lib.init_train_state(cfg_plain, train_tcfg, seed=seed,
                                         device=dev)
    tx = train_lib.make_optimizer(train_tcfg)
    before = counts()
    _, mk = train_lib.train_step(tx, state_k, batch32)
    mid = counts()
    _, mp = train_lib.train_step(tx, state_p, batch32)
    torch.cuda.synchronize()
    if (tuple(a - b for a, b in zip(mid, before)) != (1, 0, 0)
            or counts() != mid):
        raise AssertionError("route comparison: unexpected launches")
    for key, rtol in (("loss", ROUTE_LOSS_RTOL),
                      ("grad_norm", ROUTE_NORM_RTOL)):
        a, b = float(mk[key]), float(mp[key])
        if not abs(a - b) <= rtol * abs(b):
            raise AssertionError(f"route comparison: {key} kernel {a} vs "
                                 f"plain {b} (rtol {rtol})")
    log(f"[8 train] one B={B} step, kernel route vs plain route (same "
        f"weights and batch): loss {float(mk['loss']):.6f} vs "
        f"{float(mp['loss']):.6f}, grad_norm {float(mk['grad_norm']):.5f} "
        f"vs {float(mp['grad_norm']):.5f} (rtol {ROUTE_LOSS_RTOL}, "
        f"{ROUTE_NORM_RTOL}); the plain step launched no kernel")
    main_launches = counts()
    if main_launches != (11, 5, 4):
        raise AssertionError(f"train phase launches {main_launches}")

    # ---- 9. timings ----
    lat_rows = []
    for name, Bn, dtype in (("bidir", B, torch.float32),
                            ("fwd_bwd", B_LARGE, torch.float32),
                            ("fwd_bwd", B_LARGE, torch.bfloat16)):
        (le, ls, lf), (il, ol) = lattice_inputs(rng, Bn, dtype, dev)
        g = torch.ones(Bn, device=dev)
        with torch.no_grad():
            if name == "bidir":
                fns = [("lattice_bidir",
                        lambda: lk.lattice_bidir(le, ls, lf, il, ol),
                        lambda: lk.lattice_bidir_reference(le, ls, lf, il,
                                                           ol),
                        nbytes(le, ls, lf, il, ol) + 2 * nbytes(le))]
            else:
                a = lk.lattice_forward_alphas(le, ls, lf)
                from ssnt_tts_tpu_torch.ops.lattice import gather_logz
                z = gather_logz(a, le, il, ol)
                fns = [
                    ("lattice_forward_alphas",
                     lambda: lk.lattice_forward_alphas(le, ls, lf),
                     lambda: lk.lattice_forward_alphas_reference(le, ls, lf),
                     nbytes(le, ls, lf, a)),
                    ("lattice_backward_grads",
                     lambda: lk.lattice_backward_grads(le, ls, lf, a, il, ol,
                                                       g, z),
                     lambda: lk.lattice_backward_grads_reference(
                         le, ls, lf, a, il, ol, g, z),
                     nbytes(le, ls, lf, a, il, ol, g, z) + 3 * nbytes(le))]
            for kname, kfn, pfn, nb in fns:
                k_ms = graph_ms(kfn, k=20, reps=10)
                p_ms = graph_ms(pfn, k=1, reps=3)
                # ~10 float32 operations per cell (adds, max, |.|, exp,
                # log1p) per walk; twice for the bidirectional pass.
                ops = 10 * le.numel() * (2 if kname == "lattice_bidir"
                                         else 1)
                bd = bound(nb, ops, F32_OPS)
                lat_rows.append((kname, dtype, k_ms, p_ms, bd))
                log(f"[9 time] {smi}: {kname} B={Bn} T={T} U={U} "
                    f"{str(dtype)[6:]}: kernel {k_ms:.4f} ms, plain "
                    f"{p_ms:.4f} ms (device time, CUDA graph); bound "
                    f"{bd[0] * 1e3:.2f} us ({bd[1]}, {nb / 1e6:.1f} MB)")
    for Bn in (B, B_LARGE):
        (le, ls, lf), (il, ol) = lattice_inputs(rng, Bn, torch.float32, dev)
        for variant in ("fused", "plain"):
            leaves = [x.clone().requires_grad_() for x in (le, ls, lf)]

            def fwd_bwd():
                lk.ssnt_loss_kernels(*leaves, il, ol, variant=variant,
                                     layout="ubt").sum().backward()

            ms = eager_ms(fwd_bwd, n=10)
            route = ("bidir + posterior pass" if variant == "fused"
                     else "forward alphas + backward grads")
            log(f"[9 time] {smi}: lattice loss fwd+bwd B={Bn} T={T} U={U} "
                f"f32, route {variant} ({route}): {ms:.4f} ms per call "
                f"(CUDA events, eager)")
    torch.cuda.reset_peak_memory_stats()
    for Bn in (B, B_LARGE):
        tcfg = TrainConfig(warmup_steps=2, batch_size=Bn)
        batch = to_device(data_lib.SyntheticTTSDataset(
            vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
            seed=seed + 3).batch(Bn), dev)
        for mcfg, label in ((cfg, "kernel"), (cfg_plain, "plain")):
            st = train_lib.init_train_state(mcfg, tcfg, seed=seed,
                                            device=dev)
            txn = train_lib.make_optimizer(tcfg)
            train_lib.train_step(txn, st, batch)  # warm
            ms = split_step_ms(txn, st, batch)
            log(f"[9 time] {smi}: train step B={Bn} T={T} U={U} bf16, "
                f"{label} lattice route: {ms['total']:.1f} ms = forward "
                f"{ms['forward']:.1f} + backward {ms['backward']:.1f} + "
                f"optimizer {ms['optimizer']:.1f} (host clock)")
    log(f"[9 time] peak device memory over the train-step timings: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    err = {"lattice_bidir": e_bidir, "lattice_forward_alphas": e_fwd,
           "lattice_backward_grads": e_bwd}
    replaces = {"lattice_bidir": "ssnt_tts_tpu/ops/lattice_pallas.py:993",
                "lattice_forward_alphas":
                    "ssnt_tts_tpu/ops/lattice_pallas.py:165",
                "lattice_backward_grads":
                    "ssnt_tts_tpu/ops/lattice_pallas.py:596"}
    launched = dict(zip(("lattice_bidir", "lattice_forward_alphas",
                         "lattice_backward_grads"), main_launches))
    return [{
        "name": kname, "route": "cuda",
        "source": "ssnt_tts_tpu_torch/csrc/lattice.cu",
        "replaces": replaces[kname], "launches": launched[kname],
        "max_abs_err": err[kname], "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": bd[0], "bound_by": bd[1], "library_ms": None,
    } for kname, dtype, k_ms, p_ms, bd in lat_rows
        if dtype == torch.float32]


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
    _build.build_all(["fused_v2_step", "lattice"])
    _build.fused_v2_library()
    _build.lattice_library()
    log(f"[2 build] fused_v2_step.cu and lattice.cu built/loaded in "
        f"{time.time() - t0:.1f}s")
    for name in ("fused_v2_step", "lattice"):
        for ln in _build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                log(f"[2 build] {name} ptxas: {ln.strip()}")

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

    v2_bytes = nbytes(step_args[1][30], step_args[2][30], *step_args[3],
                      *step_args[4:]) + nbytes(
        *beam_fused.fused_class_beam_step(*step_args))
    H = bf.config.decoder_dim
    D = bf.config.duration_class_size
    v2_ops = 2 * B * W * H * 3 * H * 2 + 2 * B * W * H * D
    v2_bound = bound(v2_bytes, v2_ops, BF16_OPS)
    log(f"[6 time] {smi}: v2 step bound {v2_bound[0] * 1e3:.3f} us "
        f"({v2_bound[1]}: {v2_bytes / 1e6:.3f} MB, {v2_ops / 1e9:.3f} "
        f"GFLOP bf16)")
    kernels = [{
        "name": "fused_v2_step", "route": "cuda",
        "source": "ssnt_tts_tpu_torch/csrc/fused_v2_step.cu",
        "replaces": "ssnt_tts_tpu/ops/beam_fused.py:486",
        "launches": launches,
        "max_abs_err": max(worst[torch.float32]),
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": v2_bound[0], "bound_by": v2_bound[1],
        "library_ms": None,
    }]
    kernels += train_phases(args.seed, dev, smi)
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
