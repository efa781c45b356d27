#!/usr/bin/env python3
"""Smoke run of the PyTorch port's serving, training (log and exp
domains), tone and v1 paths, the banded lattice loss, the distributed
training step, the training and eval entry points, and the decodes at
wide beams and at B=2048 on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives ssnt_tts_tpu_torch at the repo's benchmarked model width
(vocab 128, mel 80, encoder 256 x 2 layers x 4 heads, decoder 256,
joint rank 64, 10 duration classes, bfloat16 compute; phase 26 at the
flagship ModelConfig()) with seeded random weights, in phases, each
reported on its own line:

  1. device: torch's name for the card and nvidia-smi's name/power limit;
  2. build: compile csrc/fused_class_step.cu, csrc/fused_v1_step.cu,
     csrc/beam_step.cu and csrc/lattice.cu with nvcc, one process each, at
     once (ptxas report: registers, spills, static shared memory per
     instance), and the fused steps' cluster shape and dynamic shared
     memory per block at W=1, 8, 16 in both dtypes;
  3. step check at B=32, W=8, H=256, D=10, float32 and bfloat16: the
     kernel's class log-probs h and new GRU state against the plain
     PyTorch step (tolerance 1e-4 f32, 3e-2 bf16), and the plain selection
     run on the kernel's own h against the kernel's selected beams and
     reordered state, bit for bit;
  4. serve: 3 requests of B=32 (T=80, U=400, ragged lengths, bf16)
     through encode -> v2_duration_decode -> synthesize_from_alignment,
     counting the fused kernel's launches (T per request);
  5. the same requests on the plain route (fuse_model=False,
     use_pallas=False), float32 and bfloat16: share of utterances whose
     durations agree;
  6. timings: the fused step against the plain step (CUDA events; device
     time under a CUDA graph, and per eager call), the wrapper's host time
     per call (no synchronize), and one request end to end (host clock,
     split into decode, encode and synthesis);
  7. lattice check: each lattice kernel against its plain version on
     ragged lengths with an il = ol = 1 and a degenerate example: the
     bidirectional kernel at B=32 T=80 U=400 (its warp walk: alphas,
     betas, loss, and the gradients after the posterior pass; alphas bit
     for bit the forward alphas kernel's) and at T=T_BLOCK_WALK, B=8 (its
     block walk; alphas and betas bit for bit the forward alphas and
     betas-only kernels'), forward alphas and backward gradients at B=256
     in float32 and bfloat16 storage (their warp walks: bit for bit their
     block walks', through the C entries only this script and
     bench_fused.py call; the forward's float32 alphas bit for bit the
     bidirectional kernel's; whether the gradients equal the plain
     version's bit for bit is printed);
  8. train (the training path): run_training at B=32 for 3 steps (one
     bidirectional launch each), one no-grad loss (one forward-alphas
     launch), run_training at B=256 for 1 step in float32 and 1 in
     bfloat16 lattice storage (one forward and one backward launch each),
     and one B=32 step through the plain lattice route from the same
     weights and batch as a kernel-route step (no launches; loss and
     grad_norm agree);
  9. timings: each lattice kernel and its plain version (device time,
     CUDA graph; forward alphas and backward gradients also by their block
     walks), both lattice routes at both batch sizes, and the train
     step at B=32 and B=256 on both routes, split into forward, backward
     and optimizer (host clock, each part ending in a synchronize); at
     B=256 a step through decoder_states' chunked remat bit for bit one
     through the loop written out without it (unchunked_decoder_states),
     with each step's peak device memory;
 10. tone step check at B=32, W=8, K=8, H=256, float32 and bfloat16 (and
     the first step at W=16): the fused tone kernel's h and new GRU state
     against the plain step (TOL), and the plain tone selection on the
     kernel's own h against the kernel's beams and reordered state, bit
     for bit;
 11. beam-only kernel check: the v2 (#12) and tone (#13) beam-only
     kernels against their plain versions on the same h and state, every
     output bit for bit, at W=8 and W=16 on ragged lengths, at
     max_beam_width W-1 and W+5, and at W=3 with F = H-1 state rows (spans
     not a multiple of 16 bytes; the one-warp selection) for W_out 3 and
     8; v2 with defaults, the final-feasibility guard, allow_skip and
     test_mode, and an utterance that empties;
 12. tone serve (the tone path): 3 requests of B=32 (T=80, synthetic
     batches with tone targets, bf16) through encode -> tone_decode on
     the fused route (T launches of the fused tone kernel each), the
     beam-only route (T launches of #13 each, none of the fused kernel)
     and the plain route (no launches; tones equal the beam-only route's
     bit for bit); the fused route's agreement as a share; the best
     beam's edit distance to the tone targets (printed, not gated: the
     weights are random); then one v2 request through
     v2_duration_decode(fuse_model=False): T launches of #12, durations
     equal to the plain route's;
 13. timings: the launch floor (a one-element in-place add under the
     same graph timing), each new kernel against its plain version
     (device time under a CUDA graph, and eager; host time per kernel
     call), and one
     tone request end to end
     (host clock: tone_decode, and apart its encode, its
     post-processing and the edit distance);
 14. fused v1 step check at B=32, W=8, H=256, M=80, R=64, float32 and
     bfloat16, on a request's own carry at frames 0/100/399 (and W=1,
     W=16 at 0/100), each later frame also with beams moved onto and past
     their last frame and more finished: the kernel's h, new GRU state and
     mel against the plain step (TOL), and the plain selection, reorder
     and finished-beam mel keep on the kernel's own h, state and mel
     against the kernel's outputs, bit for bit;
 15. beam-only v1 check: #11 with the decode's F = H + 2M + 2 = 418-wide
     rows and #10 without rows against their plain versions, every output
     bit for bit, at W=1, 8 and 16 on ragged lengths, at max_beam_width
     W-1 and W+5, and at W=3 with F = 417 for W_out 3 and 8;
 16. v1 serve (the v1 path): 3 requests of B=32 (T=80, max_frames=400,
     bf16) through encode -> beam_decode on the fused route (400 #15
     launches each), the beam-only route (400 #11 each; outputs equal the
     plain route's bit for bit) and the plain route (none), and
     greedy_decode on each route (400 #15; 400 #11 on the beam-only
     route: #10 has no decode caller, as in JAX); gates: alignment steps 0 or 1 inside each utterance,
     num_frames <= 400, mel finite, slot 0 the best beam;
 17. timings: the launch floor, #15, #11 and #10 against their plain
     versions (device time under a CUDA graph, and eager; host time per
     kernel call), #15 also at
     W=1 and W=16, and one v1 request per route end to
     end (host clock: beam_decode, and apart its encode and its backtrace
     + mel gather; audio-seconds per second, B*400*0.0125 s / latency);
 18. exp-domain lattice check on the same ragged lengths (and an example
     whose emit probability is 0 everywhere): the exp-native pass (#9)
     and the exp-domain bidirectional pass (#4) at B=32 and B=256 (their
     warp walks), the betas-only pass (#3, its warp walk) at B=32 and
     B=256 (bit for bit its block walk and lattice_bidir's warp-walk
     betas), each against its plain version (LAT_REL; -inf cells equal;
     #9, #4 and #3 also bit for bit), #9's and
     #4's block walks at T=T_BLOCK_WALK, B=8, the same way, and the
     gradients after the plain backward (GRAD_F32; degenerate examples'
     exactly 0);
 19. exp-domain training (the exp path, lattice_domain="exp", frame
     log_sigma EXP_LOG_SIGMA): run_training at B=32 for 3 steps (one #9
     launch each), one no-grad loss (one), run_training at B=256 for 1
     step (one); one B=32 step in the exp domain against one in the log
     domain from the same weights and batch (loss rtol 1e-4, gradient
     cosine > 0.999); ssnt_loss_kernels(variant="exp") forward and
     backward at B=32 and B=256 (one #4 launch each; loss within 5e-4 of
     variant="log", the degenerate example +inf);
 20. timings: #9, #4 and #3 against their plain versions (device time
     under a CUDA graph; #3's block walk beside it), the lattice loss
     fwd+bwd for variant "exp",
     "fused" and "plain", and the exp-domain train step at B=32 and B=256
     split into forward, backward and optimizer (host clock);
 21. banded check on the same ragged lengths, at B=32 and B=256 and each
     K in BANDS: the banded forward (#2) and backward-gradients (#6)
     kernels against their plain versions, every output bit for bit, the
     degenerate example's gradients exactly 0;
 22. the banded path: ssnt_loss_kernels(variant=f"banded{K}") forward and
     backward and one no-grad forward at each K, B=32 and B=256 (exactly
     one #2 and one #6 launch per fwd+bwd, one #2 per no-grad call, equal
     to the grad forward bit for bit), and variant="scan" fwd+bwd at B=32
     (no launch); each loss within BANDED_LOSS_RTOL and its gradients
     within BANDED_GRAD_RTOL / BANDED_GRAD_ATOL of variant="log";
 23. timings: the plain forward alphas (#1) at each batch, #2 and #6 at
     each K and batch against their plain versions (device time under a
     CUDA graph) with their byte and operation bounds (also with their
     workspaces written and read once) and the composition tree's exp +
     log count, and the lattice
     loss fwd+bwd for variant "banded2".."banded16", "fused", "exp", "plain"
     and "scan" at B=32 and B=256 (eager, and device time under a CUDA
     graph);
 24. long lattices (the block walks at several positions a thread): at
     T=T_LONG (1500), U=400, B=2 and B=8, with paths that reach far (il <=
     U) and an example with il = T: #1, #3, #5 (float32 and bfloat16),
     #7/#8, #4 and #9 against their plain versions (#8's alphas and betas
     bit for bit #1's and #3's), the same at T=1100, U=1100 (paths over
     all of T), at T=3000, U=1600 (4 positions a thread) and at T=MAX_T
     (8192), U=16 and U=1100, with lengths whose alphas, betas and
     gradients carry live values across the position bounds of the
     threads (block_bounds; checked); #1, #5, #3 and #8 through their C
     entries with every tensor inside guard bands (guard_check); one
     lattice_loss step through
     the kernel route against the plain route at T_LONG, B=2 ("fused") and
     B=8 ("plain"); ValueError at MAX_T + 1, the C side's limit equal to
     the wrapper's; each banded K's limit (banded_max_t) run at the limit
     against the plain versions bit for bit and refused (ValueError) at
     the limit + 32;
 25. distribution (the sharded train step, the T-sharded lattice ring
     and the decodes over data shards), at B=32 global on ragged lengths
     sorted longest first (data rank 0 holds more tokens): (a) NCCL, one
     rank, in this process: two sharded steps on a 1x1 mesh against
     two train_steps from the same state, losses and parameters bit
     for bit, the all_reduces a step, then run_training over that mesh
     with a checkpoint directory for 1 step and resumed to 2 (the
     primary's saves and the end-of-run barrier on NCCL), each timed; and
     run_training resumed on that mesh from the step-1 checkpoint that
     four spawned ranks saved from a 2x2 mesh (parameters split over
     "model", whole tensors gathered for the save), the checkpoint bit for
     bit the one-process step over the two row halves and step 2 bit for
     bit train_step from it; (b) four ranks of
     ssnt_tts_tpu_torch.dryrun started with torch.multiprocessing
     ("spawn"; they load the libraries built above), on gloo with every
     rank on cuda:0 (NCCL one rank a card when there are four cards), at
     the flagship ModelConfig():
     the gloo operations the port calls, on the tensors it hands them
     (a 2-rank probe: the collectives on CUDA tensors, send / recv
     through host memory), DIST_STEPS sharded steps on a 2x2 and on a 1x4
     mesh, the parameters split over the model axis
     (mesh.param_sharding), each with lattice_tshard_min_cells=0 (the
     ring: T=80 over 2 or 4 shards, K=16) and with it off, against the
     one-process step with whole parameters (losses rtol 2e-4; parameters
     and grad_norm bit for bit the one-process step over the same data
     rows, dryrun.split_step, with its lattices on a one-rank ring when
     the ring is on; the count of parameters outside rtol 2e-3 / atol 2e-5
     of the whole-batch step reported), the bytes each rank stores, one
     all_gather and two all_reduces a step, the ring's hops, the kernel
     launches of every rank, the ring alone bit for bit
     ops/lattice.ssnt_loss at U=400, B=16 and its fwd+bwd time, and after
     three 2x2 sharded steps the v2 (fused and plain routes), tone and v1
     decodes over data shards gathered and gated as phases 4 and 16 gate
     theirs, each rank's outputs bit for bit a one-process decode of the
     same rows by the one-process model, and their agreement with a
     one-process decode of the whole batch (not gated; beside it the plain
     routes' agreement in the bf16 model and in a float32 one).
     Every spawned group has a 300 s deadline;
 26. the utilities at the flagship width (ModelConfig(): vocab 256,
     encoder 256 x 4 layers x 4 heads, bf16): (a) the train CLI
     (scripts.train.main) for 2 steps at B=32 with a checkpoint
     directory, then resumed to 3: exactly one #8 launch a step taken and
     no #1/#5, latest_step 2 then 3, restore of step 2 bit for bit the
     state the first run saved (every parameter, mu, nu, count, step),
     and the first step after the resume bit for bit the same step taken
     here from the restored state on the same batch; (b)
     materialize_synthetic of CORPUS examples into .npz shards, then
     run_training(data_dir=) for 3 steps at B=256: one #1 and one #5
     launch a step and no #8, padding efficiencies in (0, 1]; shard
     sizes and times, buckets, step ms, peak memory logged; (c)
     scripts.eval_e2e --steps EVAL_STEPS --corpus CORPUS --eval-batch 256
     --beam 8 (bench_step's chains run BENCH_REPEATS times): every key of
     JAX's record present and finite, exactly 2 x T
     launches of the fused v2 step and T of the fused tone step; then #14
     at that decode batch, B=256 W=8, on the eval model's width: the v2
     step in both of eval_e2e's arms and the tone step, float32 and
     bfloat16, at s=0/30/T-1, h and new_h within TOL of the plain step's
     and the selection bit for bit the plain selection on the kernel's h
     (as phases 3 and 10 at B=32; the largest |dh| and |dnew_h| logged
     apart); its bench_step train_step_ms beside
     split_step_ms at the same config;
     (d) utils/profiling.trace around one B=32 train step: the Chrome
     trace names the lattice_bidir kernel (bidir_warp_kernel) and the
     annotation; guard_nans passes a clean step and flags a NaN mel
     frame; ops/checks flag an emptied v2 step and a bad upsampling length
     on CUDA tensors and pass good ones; (e) at B=32 and B=256, a step
     through decoder_states' chunked remat bit for bit one through the
     loop without it, with each step's peak device memory, then at B=256
     both in turns (split_step_ms, host clock) with each run's peak;
 27. beam widths and the decode at scale: (a) the libraries' MAX_BEAMS /
     MAX_CANDIDATES equal ops/beam_fused's, and every beam kernel wrapper
     refuses W = MAX_BEAMS + 1 (v2 / tone / v1 max_beam_width too) and
     MAX_CANDIDATES + 1 candidates with a ValueError before any launch; #12
     / #13 and #11 / #10 against their plain versions bit for bit at W in
     WIDTHS (D=10, K=8), at W=128 with D=K=16 (2048 candidates), with
     max_beam_width widening 8 -> 128, 17 -> 40 with odd F and narrowing 64
     -> 10; #14 (v2 and tone, float32 and bfloat16) at each W and at W=128
     with 16 classes, and #15 at each W on a request's carry, against the
     plain steps as phases 3, 10 and 14 hold them; one v2, tone and v1
     request at W=W_WIDE on each route (exact launch counts, beam-only
     equal to plain bit for bit, the gates of phases 4 and 16, the fused
     route's agreement); each beam kernel's device time a step under a CUDA
     graph at each W against its bound and its share of it (the JSON
     line's entries gain max_beams, max_candidates, the times and bounds
     at W=32 and W=128, and the fused entries the launches of their W=32
     request); (b)
     scripts.decode_scale at B=2048 and B=256 (smoke width, T=80, U=400,
     W=8, bf16, fused route), the B=2048 decode bit for bit its rows
     decoded in 8 slices of 256 and over 4 data ranks (gloo on the card),
     ms, audio-seconds per second, emptied rate, peak device memory; (c) a
     reduced scripts.triage_empty_beam (steps 2 and 4 at B=64, smoke
     width): JAX's record keys, every sweep (beam_x4 at W=32), and its
     final checkpoint decoded at W=32 on the fused and beam-only routes;
     27a also decodes a float32 model's W=32 request on the fused and
     plain routes and prints, for both models, the best-beam and the
     all-beams agreement shares (where a float32 best beam parts, the
     first utterance and step and the scores there);
 28. the tools that split the decode step, the ring and the gloo step
     (tools_slice_phase), every count zeroed before and read after, every
     record on its own line with the card: (a) scripts.profile_decode at
     JAX's width (B=32, W=8, T=80, U=400, bf16) on the beam-only and
     plain routes, PROFILE_ROUNDS rounds of at most PROFILE_MAX_ITERS
     steps a chain (each chain run BENCH_REPEATS times), with a trace,
     then its full
     step run over 400 frames bit
     for bit beam_decode on the same route (short utterances finish, so
     the mel keep is taken), #10 and #11 launched exactly the steps the
     tool ran; (b) scripts.tshard_bench at U=400, B=8, T=64 over
     TSHARD_DEVICES ranks and TSHARD_BLOCKS (gloo on the card; shard
     counts, blocks and timed calls cut for time, TOOL_STEPS): every
     run's loss and gradients bit for bit the plain unsharded loss (as
     25b's ring check), which the unsharded kernel loss (#8, launched
     exactly once a timed call) meets by phase 24's rule; (c)
     scripts.weak_scaling_triage at ModelConfig(), 4 ranks, per-rank batch
     8, seq 32 80, TRIAGE_STEPS steps: each arm's lattice launches a call
     exactly its route's (grad_mode); (d) scripts.weak_scaling_proof at ModelConfig(),
     n in PROOF_DEVICES, total batch 32, TOOL_STEPS timed steps:
     total_flops_vs_unsharded within 1e-3 of 1, 2 all_reduces a step.

Then one JSON line describing the kernels, and as the last line
{"ok": true, "device": {...}}. Any failed check raises (non-zero exit,
no result line). Without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import functools
import importlib
import json
import os
import pathlib
import subprocess
import sys
import time

if __name__ in ("__main__", "__mp_main__"):
    # The bytecode of every module this run compiles goes to build/pycache,
    # for this process and the ranks it spawns (which start from this
    # environment and import this file again). An interpreter told not to
    # write bytecode (PYTHONDONTWRITEBYTECODE) beside sources that have
    # none would compile PyTorch's Python modules anew in every process:
    # seconds for `import torch`, and more for the torch._dynamo import
    # that the first step through torch.utils.checkpoint makes.
    _PYC = str(pathlib.Path(__file__).resolve().parent / "build" / "pycache")
    sys.pycache_prefix = _PYC
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = _PYC
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)

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
# Exp domain against log domain, one train step from the same weights
# (JAX's own tolerance, tests/test_model.py::test_exp_domain_lattice_
# training), and variant="exp" against variant="log" on one lattice
# (tests/test_lattice_pallas.py::test_exp_variant_loss_and_grads_match).
EXP_LOSS_RTOL, EXP_GRAD_COS, EXP_VARIANT_RTOL = 1e-4, 0.999, 5e-4
# The exp-domain training runs (phase 19): the frame joint's log_sigma and
# the warmup. The exp domain flushes a cell more than ~87 nats below its
# column's best to 0 (in JAX as here): at the random tree's log_sigma 0
# most utterances, and at 1 some, lose every path and give the 1e30
# sentinel; and one Adam step at full learning rate saturates the random
# transition joint, after which every utterance does. At log_sigma 2 with TrainConfig's default warmup (1000
# steps) none does.
EXP_LOG_SIGMA, EXP_WARMUP = 2.0, 1000
# A train loss at or above this holds an utterance at the 1e30 sentinel.
SENTINEL_LOSS = 1e20
# A source length above the warp walks' T <= 128: phases 7 and 18 hold the
# block walks of #8, #9 and #4 too.
T_BLOCK_WALK = 200
# Phase 24's source length: above the 1024 threads of a block, so the
# block walks hold two positions a thread.
T_LONG = 1500
# The banded kernels' K, and variant="bandedN" / "scan" against
# variant="log" on one lattice: JAX's own tolerances
# (tests/test_lattice_pallas.py::test_banded_k_variants_match_xla: loss
# rtol 1e-5, gradients rtol 1e-4 / atol 1e-5), with the gradients' rtol
# widened per example to GRAD_ULPS float32 epsilons of |logZ|: a gradient
# is exp(alpha + beta - logZ), whose terms are sums of |logZ|'s size (~1e3
# at U=400, where JAX's test has ~50) accumulated in another order by each
# route, so k ulps there are a relative error of k eps |logZ| in the
# gradient (one ulp of 1100 is 1.2e-4, past JAX's rtol).
BANDS = (2, 4, 8, 16)
BANDED_LOSS_RTOL, BANDED_GRAD_RTOL, BANDED_GRAD_ATOL = 1e-5, 1e-4, 1e-5
GRAD_ULPS = 32
# Card peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, float32 (non
# tensor core) and bf16 tensor-core operations/s.
HBM_BPS, F32_OPS, BF16_OPS = 3.35e12, 67e12, 989e12
SOURCES = ("fused_class_step", "fused_v1_step", "beam_step", "lattice")
# The lattice kernels' launch counts, in lattice_kernels.KERNELS' order.
LAUNCH_NAMES = ("(bidir, fwd, bwd, betas, bidir_exp, expin, "
                "fwd_banded, bwd_banded)")
SERVE_CFG = dict(vocab_size=128, mel_dim=80, encoder_dim=256,
                 encoder_layers=2, encoder_heads=4, decoder_dim=256,
                 joint_rank=64)


def log(msg: str) -> None:
    print(msg, flush=True)


_LAP = [time.time(), time.time()]  # (start of the run, end of the last lap)


def lap(phase: str) -> None:
    """Logs the seconds since the last lap as `phase`'s, and since the
    start of the run (main resets the clock)."""
    now = time.time()
    log(f"[seconds] phase {phase}: {now - _LAP[1]:.1f} s ({now - _LAP[0]:.1f} "
        f"s into the run)")
    _LAP[1] = now


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


def make_request(rng, vocab: int, dev, Bn: int = B):
    il = rng.integers(40, T + 1, Bn)
    il[0] = T
    ol = np.minimum(U, np.round(il * rng.uniform(4.2, 5.0, Bn))).astype(int)
    ol[0] = U
    toks = rng.integers(1, vocab, (Bn, T))
    as_t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return as_t(toks), as_t(il), as_t(ol)


def step_inputs(model, req, s: int, rng, dev, Wn: int = W):
    """Beam state for one step at step s: most beams at t = s with totals
    near the diagonal, some finished or at their last position, and
    duplicated beams (dedup). The batch is the request's; Wn beams."""
    from ssnt_tts_tpu_torch.models import stepmath
    from ssnt_tts_tpu_torch.ops import beam_fused

    toks, il, ol = req
    Bn = il.shape[0]
    with torch.no_grad():
        w = model.duration_step_weights()
        enc = model.encode(toks, il)
        xin, base = stepmath.class_decode_paths(w, enc, il, model.dtype,
                                                kind="v2")
        fw = beam_fused.prepare_fused_weights(w, model.dtype)
    H = model.config.decoder_dim
    D = model.config.duration_class_size
    il_n, ol_n = il.cpu().numpy(), ol.cpu().numpy()
    t = np.minimum(s, il_n)[:, None].repeat(Wn, 1)
    last = rng.random((Bn, Wn)) < 0.1
    t[last] = il_n[np.nonzero(last)[0]] - 1
    tot = np.round(ol_n[:, None] / il_n[:, None] * t) + rng.integers(
        -10, 10, (Bn, Wn))
    fin = rng.random((Bn, Wn)) < 0.15
    lp = -rng.gamma(2.0, 2.0 + s / 4, (Bn, Wn))
    state = rng.normal(0, 0.5, (Bn, Wn, H))
    pc = rng.integers(0, D, (Bn, Wn))
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
            torch.tensor(rng.random(Bn) < 0.1, device=dev))


def same_bits(a, b) -> bool:
    return bool(torch.equal(a, b)) and (
        not a.is_floating_point()
        or bool(torch.equal(torch.signbit(a), torch.signbit(b))))


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port, by name."""
    from ssnt_tts_tpu_torch.ops import beam_fused, beam_kernels
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    fns = list(lk.KERNELS) + [
        beam_fused.fused_class_beam_step, beam_fused.fused_tone_step,
        beam_fused.fused_v1_beam_step, beam_kernels.v2_beam_search_decode,
        beam_kernels.tone_beam_search_decode,
        beam_kernels.beam_search_step_reorder,
        beam_kernels.beam_search_step_batched]
    return {f.__name__: f for f in fns}


def zero_counts() -> None:
    for f in kernel_wrappers().values():
        f.launches = 0


def read_counts() -> dict:
    """The non-zero launch counts by wrapper name."""
    return {n: f.launches for n, f in kernel_wrappers().items()
            if f.launches}


def expect_counts(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got}, not {want}")


def check_step(args, opts, dtype) -> tuple:
    """Phase 3 for one input set: returns (max |dh|, max |dnew_h|)."""
    from ssnt_tts_tpu_torch.ops import beam_fused, beam_v2

    s, xin, base, fw, pc, state, lp, fin, tot, t, u, il, ol, dtab, emp = args
    if opts.get("test_mode"):
        ol = torch.zeros_like(ol)
        args = args[:12] + (ol,) + args[13:]
    dbg_k = (torch.empty(*state.shape[:2], base.shape[2],
                         device=state.device),
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


def serve(model, req, *, config=None, fuse_model=None, use_pallas=None,
          times=None):
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
            max_frames=U, config=config, fuse_model=fuse_model,
            use_pallas=use_pallas)
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


def launch_floor_ms() -> float:
    """Device time per call of the least kernel: an in-place add on a
    one-element tensor, timed as graph_ms times any kernel (what one graph
    node costs on this card)."""
    one = torch.zeros(1, device="cuda")
    return graph_ms(lambda: one.add_(1.0))


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


def lattice_inputs(rng, Bn: int, dtype, dev, Tn: int = T):
    """A (U, B, Tn) lattice (transition log-probs, Gaussian-like frame
    log-likelihoods) and ragged lengths: example 0 full, 1 with
    il = ol = 1, 2 degenerate (ol < il: no path reaches t = il-1)."""
    le = np.log(rng.uniform(0.1, 0.9, (U, Bn, Tn)))
    ls = np.log1p(-np.exp(le))
    lf = rng.normal(-2.0, 1.0, (U, Bn, Tn))
    il = rng.integers(Tn // 2, Tn + 1, Bn)
    ol = np.minimum(U, np.round(il * rng.uniform(4.2, 5.0, Bn)))
    il[0], ol[0] = Tn, U
    il[1], ol[1] = 1, 1
    il[2], ol[2] = Tn, Tn - 1
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


def block_forward_alphas(le, ls, lf):
    """#1 by its block walk at any T (ssnt_lattice_forward_alphas_block:
    only this script and bench_fused.py call it)."""
    from ssnt_tts_tpu_torch.ops import _build

    U, Bn, Tn = le.shape
    a = torch.empty((U, Bn, Tn), device=le.device)
    rc = _build.lattice_library().ssnt_lattice_forward_alphas_block(
        int(le.dtype == torch.bfloat16), Bn, Tn, U, le.data_ptr(),
        ls.data_ptr(), lf.data_ptr(), a.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"forward alphas block walk: cudaError {rc}")
    return a


def block_backward_betas(le, ls, lf, il, ol):
    """#3 by its block walk at any T (ssnt_lattice_backward_betas_block)."""
    from ssnt_tts_tpu_torch.ops import _build

    U, Bn, Tn = le.shape
    b = torch.empty((U, Bn, Tn), device=le.device)
    rc = _build.lattice_library().ssnt_lattice_backward_betas_block(
        Bn, Tn, U, le.data_ptr(), ls.data_ptr(), lf.data_ptr(),
        il.data_ptr(), ol.data_ptr(), b.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"backward betas block walk: cudaError {rc}")
    return b


def block_backward_grads(le, ls, lf, a, il, ol, g, z):
    """#5 by its block walk at any T (ssnt_lattice_backward_grads_block)."""
    from ssnt_tts_tpu_torch.ops import _build

    U, Bn, Tn = le.shape
    d = [torch.empty((U, Bn, Tn), dtype=le.dtype, device=le.device)
         for _ in range(3)]
    rc = _build.lattice_library().ssnt_lattice_backward_grads_block(
        int(le.dtype == torch.bfloat16), Bn, Tn, U,
        *(x.data_ptr() for x in (le, ls, lf, a, il, ol, g, z, *d)),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"backward grads block walk: cudaError {rc}")
    return tuple(d)


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
        # The warp walk's alphas against #1's block walk (the same cells in
        # the same order).
        fa = lk.lattice_forward_alphas(le, ls, lf)
        torch.cuda.synchronize()
        if not same_bits(ka, fa):
            raise AssertionError("bidir alphas: not forward alphas' bit for "
                                 "bit")
        kz = lat.gather_logz(ka, le, il, ol)
        rz = lat.gather_logz(ra, le, il, ol)
        lattice_err(kz, rz, "bidir logz")
        kg = lat.posterior_grads(le, ls, lf, ka, kb, kz, il, ol, g)
        rg = lat.posterior_grads(le, ls, lf, ra, rb, rz, il, ol, g)
        e_post = grad_err(kg, rg, GRAD_F32, "bidir + posterior pass")
    log(f"[7 lattice] bidir (warp walk) B={B} T={T} U={U} f32: alphas bit "
        f"for bit forward alphas'; alphas/betas max abs "
        f"err {e_bidir[0]:.3e}, rel err {e_bidir[1]:.3e}, grads after the "
        f"posterior pass {e_post:.3e} "
        f"(tol {LAT_REL}, {GRAD_F32}); degenerate grads exactly 0")
    # The block walk, kept above the warp walk's T <= 128.
    (le, ls, lf), (il, ol) = lattice_inputs(rng, 8, torch.float32, dev,
                                            T_BLOCK_WALK)
    with torch.no_grad():
        ka, kb = lk.lattice_bidir(le, ls, lf, il, ol)
        ra, rb = lk.lattice_bidir_reference(le, ls, lf, il, ol)
        fa = lk.lattice_forward_alphas(le, ls, lf)
        fb = lk.lattice_backward_betas(le, ls, lf, il, ol)
        torch.cuda.synchronize()
        e_blk = max(lattice_err(ka, ra, f"bidir alphas T={T_BLOCK_WALK}"),
                    lattice_err(kb, rb, f"bidir betas T={T_BLOCK_WALK}"))
        if not (same_bits(ka, fa) and same_bits(kb, fb)):
            raise AssertionError(f"bidir T={T_BLOCK_WALK}: not forward "
                                 f"alphas' and backward betas' bit for bit")
    e_bidir = max(e_bidir, e_blk)
    log(f"[7 lattice] bidir (block walk) B=8 T={T_BLOCK_WALK} U={U} f32: "
        f"alphas/betas bit for bit forward alphas' / backward betas'; max "
        f"abs err {e_blk[0]:.3e}, rel err {e_blk[1]:.3e} (tol {LAT_REL})")
    errs = {}
    for dtype, gtol in ((torch.float32, GRAD_F32),
                        (torch.bfloat16, GRAD_BF16)):
        (le, ls, lf), (il, ol) = lattice_inputs(rng, B_LARGE, dtype, dev)
        g = torch.ones(B_LARGE, device=dev)
        with torch.no_grad():
            ka = lk.lattice_forward_alphas(le, ls, lf)
            ra = lk.lattice_forward_alphas_reference(le, ls, lf)
            ba = block_forward_alphas(le, ls, lf)
            torch.cuda.synchronize()
            e_fwd = lattice_err(ka, ra, f"forward alphas {dtype}")
            if not same_bits(ka, ba):
                raise AssertionError(f"forward alphas {dtype}: the warp "
                                     f"walk is not the block walk's bit for "
                                     f"bit")
            if dtype == torch.float32:
                xa, _ = lk.lattice_bidir(le, ls, lf, il, ol)
                torch.cuda.synchronize()
                if not same_bits(ka, xa):
                    raise AssertionError("forward alphas: not the "
                                         "bidirectional kernel's bit for bit")
            z = lat.gather_logz(ra, le, il, ol)
            kd = lk.lattice_backward_grads(le, ls, lf, ra, il, ol, g, z)
            rd = lk.lattice_backward_grads_reference(le, ls, lf, ra, il, ol,
                                                     g, z)
            bd = block_backward_grads(le, ls, lf, ra, il, ol, g, z)
            torch.cuda.synchronize()
            if any(d.dtype != dtype for d in kd):
                raise AssertionError("backward grads not in the input dtype")
            e_bwd = grad_err(kd, rd, gtol, f"backward grads {dtype}")
            if not all(same_bits(a, b) for a, b in zip(kd, bd)):
                raise AssertionError(f"backward grads {dtype}: the warp "
                                     f"walk is not the block walk's bit for "
                                     f"bit")
            plain_bits = all(same_bits(a, b) for a, b in zip(kd, rd))
        errs[dtype] = (e_fwd, e_bwd)
        log(f"[7 lattice] B={B_LARGE} {str(dtype)[6:]} storage: forward "
            f"alphas (warp walk) max abs err {e_fwd[0]:.3e}, rel err "
            f"{e_fwd[1]:.3e} (tol {LAT_REL}), bit for bit the block walk's"
            + (" and the bidirectional kernel's" if dtype == torch.float32
               else "") + f"; backward grads (warp walk) {e_bwd:.3e} (tol "
            f"{gtol}), bit for bit the block walk's; bit for bit the plain "
            f"version's: {plain_bits}; degenerate grads exactly 0")
    (e_fwd, _), e_bwd = errs[torch.float32]
    return e_bidir[0], e_fwd, e_bwd


def to_device(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
            if k != "alignment"}


def split_step_ms(tx, state, batch, reps: int = 1) -> dict:
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


def unchunked_decoder_states(model, mel_target):
    """SSNTModel.decoder_states with its recurrence as one loop, without
    the chunked remat (the port's loop before it, written out): autograd
    keeps every frame's activations."""
    from ssnt_tts_tpu_torch.models import stepmath

    shifted = torch.cat([torch.zeros_like(mel_target[:, :1]),
                         mel_target[:, :-1]], dim=1)
    cell = model.ar_cell.cell
    gi = stepmath.gru_input(cell.wi, cell.bi,
                            model.ar_cell.prenet(shifted).to(model.dtype))
    state = torch.zeros(mel_target.shape[0], model.config.decoder_dim,
                        device=mel_target.device)
    outs = []
    for gi_u in gi.unbind(1):
        state = stepmath.gru_update(gi_u, cell.wh, cell.bhn, state)
        outs.append(state)
    return torch.stack(outs, dim=1)


def remat_compare(tag: str, cfg, sizes, seed: int, dev, smi: str,
                  reps: int = 2) -> None:
    """At each batch size, two states from the same weights: one trains
    through decoder_states' chunked remat, the other through
    unchunked_decoder_states (set on its model instance). One train step
    each on the same batch: loss, grad_norm and every parameter, mu and nu
    after it bit for bit, and each step's peak device memory
    (max_memory_allocated after reset_peak_memory_stats; both states
    resident); then, unless reps is 0, split_step_ms (median of `reps`
    steps) in turns loop, remat, remat, loop, with each run's peak. Logs
    one line per size."""
    import types

    from ssnt_tts_tpu_torch import data as data_lib
    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.utils.config import TrainConfig

    for Bn in sizes:
        tcfg = TrainConfig(warmup_steps=2, batch_size=Bn)
        batch = to_device(data_lib.SyntheticTTSDataset(
            vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
            duration_class_size=cfg.duration_class_size,
            tone_class_size=cfg.tone_class_size,
            seed=seed + 10).batch(Bn), dev)
        tx = train_lib.make_optimizer(tcfg)
        states, first = {}, {}
        for name in ("loop", "remat"):
            st = train_lib.init_train_state(cfg, tcfg, seed=seed, device=dev)
            if name == "loop":
                st.model.decoder_states = types.MethodType(
                    unchunked_decoder_states, st.model)
            states[name] = st
        for name, st in states.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, m = train_lib.train_step(tx, st, batch)
            torch.cuda.synchronize()
            first[name] = ({k: float(v) for k, v in m.items()},
                           torch.cuda.max_memory_allocated())
        if first["loop"][0] != first["remat"][0]:
            raise AssertionError(f"{tag} remat B={Bn}: metrics {first}")
        n = same_record(state_record(states["remat"]),
                        state_record(states["loop"]),
                        f"{tag} remat B={Bn}: the step through the remat "
                        f"against the loop")
        runs = {"loop": [], "remat": []}
        for name in ("loop", "remat", "remat", "loop")[:4 if reps else 0]:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = split_step_ms(tx, states[name], batch, reps=reps)
            runs[name].append((ms["total"], ms["backward"],
                               torch.cuda.max_memory_allocated()))
        gib = lambda x: f"{x / 2**30:.3f}"
        fmt = lambda name: (
            "step ms " + " / ".join(f"{r[0]:.1f}" for r in runs[name])
            + " (backward " + " / ".join(f"{r[1]:.1f}" for r in runs[name])
            + "), peak GiB " + " / ".join(gib(r[2]) for r in runs[name]))
        log(f"[{tag} remat] {smi}: train step B={Bn} T={T} U={U} "
            f"{cfg.dtype}, encoder {cfg.encoder_dim} x "
            f"{cfg.encoder_layers}: one step through decoder_states' chunked "
            f"remat (chunk 8) bit for bit the loop without it (loss "
            f"{first['remat'][0]['loss']:.6f}, {n} tensors); peak of that "
            f"step remat {gib(first['remat'][1])} GiB, loop "
            f"{gib(first['loop'][1])} GiB (saved "
            f"{(first['loop'][1] - first['remat'][1]) / 1e9:.3f} GB)"
            + (f"; in turns loop, remat, remat, loop (host clock, median of "
               f"{reps}): remat {fmt('remat')}; loop {fmt('loop')}"
               if reps else ""))


def train_run(tag, name, steps, bsz, mcfg, want, seed, dev, params=None,
              warmup_steps=2, gate_sentinel=True):
    """run_training for `steps` steps at batch `bsz` (from `params` when
    given); the lattice kernels' launches over the run must equal `want`,
    the metrics finite and (with gate_sentinel) no utterance at the 1e30
    sentinel."""
    from pathlib import Path

    from ssnt_tts_tpu_torch.train_loop import run_training
    from ssnt_tts_tpu_torch.utils.config import TrainConfig

    out_dir = Path(__file__).resolve().parent / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.jsonl"
    path.unlink(missing_ok=True)
    before = lattice_counts()
    t0 = time.perf_counter()
    last = run_training(steps, mcfg, TrainConfig(
        warmup_steps=warmup_steps, batch_size=bsz), seed=seed, device=dev,
        metrics_path=str(path), log_every=1, params=params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = tuple(a - b for a, b in zip(lattice_counts(), before))
    if got != want:
        raise AssertionError(f"{name}: launches {LAUNCH_NAMES} "
                             f"{got}, not {want}")
    rows = [json.loads(x) for x in path.read_text().splitlines()]
    if len(rows) != steps or not all(
            np.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"{name}: metrics missing or not finite")
    # One utterance at the NLL sentinel lifts the mean loss above 1e24.
    if gate_sentinel and not all(r["loss"] < SENTINEL_LOSS for r in rows):
        raise AssertionError(f"{name}: an utterance's NLL is the sentinel")
    log(f"[{tag}] {name}: {steps} steps B={bsz} T={T} U={U} in "
        f"{secs:.1f}s, launches {LAUNCH_NAMES} {got}; loss "
        + " ".join(f"{r['loss']:.4f}" for r in rows)
        + f"; last grad_norm {last['grad_norm']:.4f}")


def lattice_counts() -> tuple:
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    return tuple(k.launches for k in lk.KERNELS)


def train_phases(seed: int, dev, smi: str) -> list:
    """Phases 7-9; returns the lattice kernels' entries of the JSON line."""
    import dataclasses as dc

    from ssnt_tts_tpu_torch import data as data_lib
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk
    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

    rng = np.random.default_rng(seed + 1)
    # ---- 7. lattice kernels against their plain versions ----
    e_bidir, e_fwd, e_bwd = check_lattice(rng, dev)

    lap("7")
    # ---- 8. train (the main path) ----
    cfg = ModelConfig(**SERVE_CFG)
    counts = lattice_counts
    train = lambda *a: train_run("8 train", *a, seed, dev)

    zero_counts()
    train("b32", 3, B, cfg, (3, 0, 0, 0, 0, 0, 0, 0))
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
    if tuple(a - b for a, b in zip(counts(), before)) != (
            0, 1, 0, 0, 0, 0, 0, 0):
        raise AssertionError("no-grad loss: not one forward-alphas launch")
    if nll.shape != (B,) or not bool(torch.isfinite(nll).all()):
        raise AssertionError("no-grad loss: not B finite values")
    log(f"[8 train] no-grad loss B={B}: 1 forward-alphas launch, mean NLL "
        f"per utterance {float(nll.mean()):.3f}")
    train("b256", 1, B_LARGE, cfg, (0, 1, 1, 0, 0, 0, 0, 0))
    train("b256_bf16_lattice", 1, B_LARGE,
          dc.replace(cfg, lattice_dtype="bfloat16"),
          (0, 1, 1, 0, 0, 0, 0, 0))
    cfg_plain = dc.replace(cfg, lattice_impl="xla")
    state_p = train_lib.init_train_state(cfg_plain, train_tcfg, seed=seed,
                                         device=dev)
    tx = train_lib.make_optimizer(train_tcfg)
    before = counts()
    _, mk = train_lib.train_step(tx, state_k, batch32)
    mid = counts()
    _, mp = train_lib.train_step(tx, state_p, batch32)
    torch.cuda.synchronize()
    if (tuple(a - b for a, b in zip(mid, before)) != (1, 0, 0, 0, 0, 0, 0, 0)
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
    if main_launches != (4, 3, 2, 0, 0, 0, 0, 0):
        raise AssertionError(f"train phase launches {main_launches}")

    lap("8")
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
                blocks = {
                    "lattice_forward_alphas":
                        lambda: block_forward_alphas(le, ls, lf),
                    "lattice_backward_grads":
                        lambda: block_backward_grads(le, ls, lf, a, il, ol,
                                                     g, z)}
            for kname, kfn, pfn, nb in fns:
                k_ms = graph_ms(kfn, k=20, reps=10)
                p_ms = graph_ms(pfn, k=1, reps=3)
                # ~10 float32 operations per cell (adds, max, |.|, exp,
                # log1p) per walk; twice for the bidirectional pass.
                ops = 10 * le.numel() * (2 if kname == "lattice_bidir"
                                         else 1)
                bd = bound(nb, ops, F32_OPS)
                lat_rows.append((kname, dtype, k_ms, p_ms, bd))
                blk = ""
                if name != "bidir":
                    b_ms = graph_ms(blocks[kname], k=20, reps=10)
                    blk = f", block walk {b_ms:.4f} ms"
                log(f"[9 time] {smi}: {kname} B={Bn} T={T} U={U} "
                    f"{str(dtype)[6:]}: kernel {k_ms:.4f} ms{blk}, plain "
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
    remat_compare("9 time", cfg, (B_LARGE,), seed, dev, smi, reps=0)

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


def exp_lattice_inputs(rng, Bn: int, dev, Tn: int = T):
    """lattice_inputs' lattice and lengths, and its exp-domain quadruple
    (E, S, F, mcol) as the joints emit it: mcol the max of lf over valid
    t, F = exp(lf - mcol) and 0 past the input length; example 3's emit
    probability is 0 everywhere (no valid path, as JAX's
    test_expin_degenerate_path_zero_grads)."""
    (le, ls, lf), (il, ol) = lattice_inputs(rng, Bn, torch.float32, dev,
                                            Tn)
    E, S = le.exp(), ls.exp()
    E[:, 3], S[:, 3] = 0.0, 1.0
    tmask = torch.arange(Tn, device=dev)[None, None, :] < il[None, :, None]
    mcol = torch.where(tmask, lf, -1e30).amax(dim=2)
    F = torch.exp(torch.where(tmask, lf - mcol[:, :, None], -torch.inf))
    return (E, S, F, mcol), (le, ls, lf), (il, ol)


def check_expin_bits(x, il, ol, what: str):
    """#9 on (E, S, F, mcol) and lengths: every output bit for bit its
    plain version's. Returns (kernel outputs, plain outputs)."""
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    k = lk.lattice_expin(*x, il, ol)
    r = lk.lattice_expin_reference(*x, il, ol)
    torch.cuda.synchronize()
    for a, b, n in zip(k, r, ("qn", "bn", "M", "N")):
        if not same_bits(a, b):
            raise AssertionError(f"expin {n} {what}: not the plain "
                                 f"version's bit for bit")
    return k, r


def check_exp_lattice(rng, dev) -> dict:
    """Phase 18: #9, #4 and #3 at B=32 and B=256, each against its plain
    version (#3 also against its block walk and #8's betas), and #9's and
    #4's block walks (T above the warp walks').
    Returns each kernel's max abs error."""
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    err = dict.fromkeys(("lattice_expin", "lattice_bidir_exp",
                         "lattice_backward_betas"), 0.0)
    for Bn in (B, B_LARGE):
        x, logs, (il, ol) = exp_lattice_inputs(rng, Bn, dev)
        g = torch.ones(Bn, device=dev)
        with torch.no_grad():
            k, r = check_expin_bits(x, il, ol, f"B={Bn}")
            e_in = max(lattice_err(a, b, f"expin {n} B={Bn}") for a, b, n in
                       zip(k, r, ("qn", "bn", "M", "N")))
            kz = lk.expin_logz(x[0], x[2], k[0], k[2], il, ol)
            rz = lk.expin_logz(x[0], x[2], r[0], r[2], il, ol)
            lattice_err(kz, rz, f"expin logz B={Bn}")
            if not bool((kz[2:4] == lat.NEG).all()):
                raise AssertionError("expin: a degenerate example's logz "
                                     "is not the NEG sentinel")
            kg = lk.expin_grads(*x, *k, kz, il, ol, g)
            rg = lk.expin_grads(*x, *r, rz, il, ol, g)
            e_gin = grad_err(kg, rg, GRAD_F32, f"expin grads B={Bn}")
            if any(bool(d[:, 3].any()) for d in kg):
                raise AssertionError("expin: the E = 0 example's gradients "
                                     "are not exactly 0")

            ka, kb = lk.lattice_bidir_exp(*logs, il, ol)
            ra, rb = lk.lattice_bidir_exp_reference(*logs, il, ol)
            torch.cuda.synchronize()
            for a, b, n in ((ka, ra, "alphas"), (kb, rb, "betas")):
                if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
                    raise AssertionError(f"bidir_exp {n} B={Bn}: -inf "
                                         f"cells differ")
            e_ex = max(lattice_err(ka, ra, f"bidir_exp alphas B={Bn}"),
                       lattice_err(kb, rb, f"bidir_exp betas B={Bn}"))
            if not (same_bits(ka, ra) and same_bits(kb, rb)):
                raise AssertionError(f"bidir_exp B={Bn}: not the plain "
                                     f"version's bit for bit")
            kz = lat.gather_logz(ka, logs[0], il, ol)
            rz = lat.gather_logz(ra, logs[0], il, ol)
            lattice_err(kz, rz, f"bidir_exp logz B={Bn}")
            if not (bool(torch.isneginf(kz[2])) and bool(
                    torch.isneginf(rz[2]))):
                raise AssertionError("bidir_exp: the degenerate example's "
                                     "logz is not -inf")
            kg = lat.posterior_grads(*logs, ka, kb, kz, il, ol, g)
            rg = lat.posterior_grads(*logs, ra, rb, rz, il, ol, g)
            e_gex = grad_err(kg, rg, GRAD_F32, f"bidir_exp grads B={Bn}")
            n_inf = (int(torch.isneginf(ka).sum()),
                     int(torch.isneginf(kb).sum()))
        err["lattice_expin"] = max(err["lattice_expin"], e_in[0])
        err["lattice_bidir_exp"] = max(err["lattice_bidir_exp"], e_ex[0])
        log(f"[18 exp lattice] B={Bn} T={T} U={U} f32: expin (warp walk) "
            f"qn/bn/M/N bit for bit the plain version's, max abs err "
            f"{e_in[0]:.3e}, rel err {e_in[1]:.3e}, grads after the "
            f"plain backward {e_gin:.3e}; bidir_exp (warp walk) alphas/betas "
            f"bit for bit the plain version's, max abs "
            f"err {e_ex[0]:.3e}, rel err {e_ex[1]:.3e}, -inf cells equal "
            f"({n_inf[0]} alphas, {n_inf[1]} betas), grads after the "
            f"posterior pass {e_gex:.3e} (tol {LAT_REL}, {GRAD_F32}); "
            f"degenerate examples' grads exactly 0")
        # #3: its warp walk bit for bit its block walk and #8's betas.
        le, ls, lf = logs
        with torch.no_grad():
            kb = lk.lattice_backward_betas(le, ls, lf, il, ol)
            bb = block_backward_betas(le, ls, lf, il, ol)
            ra, rb = lk.lattice_bidir_reference(le, ls, lf, il, ol)
            _, bidir_b = lk.lattice_bidir(le, ls, lf, il, ol)
            torch.cuda.synchronize()
            if not (same_bits(kb, bb) and same_bits(kb, bidir_b)
                    and same_bits(kb, rb)):
                raise AssertionError(f"backward_betas B={Bn}: the warp walk "
                                     f"is not the block walk's, "
                                     f"lattice_bidir's and the plain "
                                     f"version's betas bit for bit")
            e_b = lattice_err(kb, rb, f"backward_betas B={Bn}")
            rz = lat.gather_logz(ra, le, il, ol)
            e_gb = grad_err(
                lat.posterior_grads(le, ls, lf, ra, kb, rz, il, ol, g),
                lat.posterior_grads(le, ls, lf, ra, rb, rz, il, ol, g),
                GRAD_F32, f"backward_betas grads B={Bn}")
        err["lattice_backward_betas"] = max(err["lattice_backward_betas"],
                                            e_b[0])
        log(f"[18 exp lattice] backward_betas (warp walk) B={Bn} f32: bit "
            f"for bit its block walk's, lattice_bidir's and the plain "
            f"version's betas; grads after the posterior pass {e_gb:.3e}; "
            f"degenerate grads exactly 0")
    # #9's block walk: T above the warp walk's 128.
    x, _, (il, ol) = exp_lattice_inputs(rng, 8, dev, T_BLOCK_WALK)
    with torch.no_grad():
        k, r = check_expin_bits(x, il, ol, f"T={T_BLOCK_WALK}")
    e_blk = max(float((a - b).abs().max()) for a, b in zip(k, r))
    err["lattice_expin"] = max(err["lattice_expin"], e_blk)
    log(f"[18 exp lattice] expin (block walk) B=8 T={T_BLOCK_WALK} U={U} "
        f"f32: qn/bn/M/N bit for bit the plain version's")
    # #4's block walk.
    _, logs, (il, ol) = exp_lattice_inputs(rng, 8, dev, T_BLOCK_WALK)
    with torch.no_grad():
        ka, kb = lk.lattice_bidir_exp(*logs, il, ol)
        ra, rb = lk.lattice_bidir_exp_reference(*logs, il, ol)
        torch.cuda.synchronize()
        for a, b, n in ((ka, ra, "alphas"), (kb, rb, "betas")):
            if not torch.equal(torch.isneginf(a), torch.isneginf(b)):
                raise AssertionError(f"bidir_exp {n} T={T_BLOCK_WALK}: -inf "
                                     f"cells differ")
        e_blk = max(lattice_err(ka, ra, f"bidir_exp alphas T={T_BLOCK_WALK}"),
                    lattice_err(kb, rb, f"bidir_exp betas T={T_BLOCK_WALK}"))
        if not (same_bits(ka, ra) and same_bits(kb, rb)):
            raise AssertionError(f"bidir_exp T={T_BLOCK_WALK}: not the plain "
                                 f"version's bit for bit")
    err["lattice_bidir_exp"] = max(err["lattice_bidir_exp"], e_blk[0])
    log(f"[18 exp lattice] bidir_exp (block walk) B=8 T={T_BLOCK_WALK} U={U} "
        f"f32: alphas/betas bit for bit the plain version's, max "
        f"abs err {e_blk[0]:.3e}, rel err {e_blk[1]:.3e} (tol {LAT_REL}), "
        f"-inf cells equal")
    return err


def exp_phases(seed: int, dev, smi: str) -> list:
    """Phases 18-20; returns the exp-domain kernels' entries of the JSON
    line."""
    import dataclasses as dc

    from ssnt_tts_tpu_torch import data as data_lib
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk
    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

    rng = np.random.default_rng(seed + 5)
    # ---- 18. exp-domain kernels against their plain versions ----
    err = check_exp_lattice(rng, dev)

    lap("18")
    # ---- 19. exp-domain training (the main path) ----
    # From the random tree with a wider frame sigma, at TrainConfig's
    # default warmup (EXP_LOG_SIGMA).
    from ssnt_tts_tpu_torch import convert

    cfg_log = ModelConfig(**SERVE_CFG)
    cfg = dc.replace(cfg_log, lattice_domain="exp")
    tree = convert.random_flax_tree(cfg, seed)
    wide = copy.deepcopy(tree)
    wide["params"]["frame"]["log_sigma"] = np.float32(EXP_LOG_SIGMA)
    train = lambda *a: train_run("19 exp train", *a, seed, dev, wide,
                                 EXP_WARMUP)

    def delta(fn, want, what):
        before = lattice_counts()
        out = fn()
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(lattice_counts(), before))
        if got != want:
            raise AssertionError(f"{what}: launches {LAUNCH_NAMES} {got}, "
                                 f"not {want}")
        return out

    zero_counts()
    train("exp_b32", 3, B, cfg, (0, 0, 0, 0, 0, 3, 0, 0))
    tcfg = TrainConfig(warmup_steps=EXP_WARMUP, batch_size=B)
    batch32 = to_device(data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        seed=seed + 2).batch(B), dev)
    args = [batch32[k] for k in train_lib.BATCH_KEYS]
    state = lambda c, t: train_lib.init_train_state(c, tcfg, params=t,
                                                    device=dev)
    state_e = state(cfg, wide)
    with torch.no_grad():
        nll = delta(lambda: state_e.model(*args[:4]),
                    (0, 0, 0, 0, 0, 1, 0, 0), "exp no-grad loss")
    if nll.shape != (B,) or not bool((nll < -lat.NEG / 2).all()):
        raise AssertionError("exp no-grad loss: not B finite values below "
                             "the sentinel")
    log(f"[19 exp train] no-grad loss B={B}: 1 expin launch, mean NLL per "
        f"utterance {float(nll.mean()):.3f}")
    train("exp_b256", 1, B_LARGE, cfg, (0, 0, 0, 0, 0, 1, 0, 0))

    # One step's loss and gradients, exp domain against log domain, from
    # the same weights and batch.
    steps = {}
    for name, st, want in (("exp", state_e, (0, 0, 0, 0, 0, 1, 0, 0)),
                           ("log", state(cfg_log, wide),
                            (1, 0, 0, 0, 0, 0, 0, 0))):
        model = st.model
        model.zero_grad(set_to_none=True)

        def step():
            loss, _ = model.loss(*args)
            loss.backward()
            return loss.detach()

        loss = float(delta(step, want, f"{name}-domain step"))
        grads = torch.cat([p.grad.double().ravel() if p.grad is not None
                           else torch.zeros(p.numel(), device=dev,
                                            dtype=torch.float64)
                           for p in model.parameters()])
        model.zero_grad(set_to_none=True)
        steps[name] = (loss, grads)
    (le_, ge), (ll_, gl) = steps["exp"], steps["log"]
    cos = float(ge @ gl / (ge.norm() * gl.norm()))
    if not (abs(le_ - ll_) <= EXP_LOSS_RTOL * abs(ll_)
            and cos > EXP_GRAD_COS):
        raise AssertionError(f"exp vs log step: loss {le_} vs {ll_} (rtol "
                             f"{EXP_LOSS_RTOL}), gradient cosine {cos}")
    log(f"[19 exp train] one B={B} step, exp domain vs log domain (same "
        f"weights, log_sigma {EXP_LOG_SIGMA}, and batch): loss {le_:.6f} vs "
        f"{ll_:.6f} (rtol {EXP_LOSS_RTOL}), gradient cosine {cos:.7f} (> "
        f"{EXP_GRAD_COS}); 1 expin launch, 1 bidir launch")
    # Not gated: the same comparison at the random tree's log_sigma 0.
    with torch.no_grad():
        at0 = [delta(lambda: state(c, tree).model(*args[:4]), want, what)
               for c, want, what in (
                   (cfg, (0, 0, 0, 0, 0, 1, 0, 0), "exp at log_sigma 0"),
                   (cfg_log, (0, 1, 0, 0, 0, 0, 0, 0), "log at log_sigma 0"))]
    off = ((at0[0] - at0[1]).abs() / at0[1].abs()) > EXP_LOSS_RTOL
    log(f"[19 exp train] not gated: at the random tree's log_sigma 0, "
        f"{int(off.sum())}/{B} utterances' exp-domain NLL is off the log "
        f"domain's by more than {EXP_LOSS_RTOL} relative, "
        f"{int((at0[0] >= 1e29).sum())} collapsed to the 1e30 sentinel; "
        f"mean NLL {float(at0[1].mean()):.1f} (log), largest relative "
        f"gap {float(((at0[0] - at0[1]).abs() / at0[1].abs()).max()):.3e}")
    # Not gated: phase 8's warmup of 2 steps; the first step at full
    # learning rate saturates the transition joint.
    train_run("19 exp train", "exp_b32_warmup2", 3, B, cfg,
              (0, 0, 0, 0, 0, 3, 0, 0), seed, dev, wide, 2,
              gate_sentinel=False)

    # variant="exp": one forward and backward, one #4 launch each.
    for Bn in (B, B_LARGE):
        (le, ls, lf), (il, ol) = lattice_inputs(rng, Bn, torch.float32, dev)
        leaves = [x.clone().requires_grad_() for x in (le, ls, lf)]

        def fwd_bwd():
            loss = lk.ssnt_loss_kernels(*leaves, il, ol, variant="exp",
                                        layout="ubt")
            loss.sum().backward()
            return loss.detach()

        loss = delta(fwd_bwd, (0, 0, 0, 0, 1, 0, 0, 0),
                     f"variant=exp B={Bn}")
        with torch.no_grad():
            ref = delta(lambda: lk.ssnt_loss_kernels(
                le, ls, lf, il, ol, variant="log", layout="ubt"),
                (0, 1, 0, 0, 0, 0, 0, 0), f"variant=log B={Bn}")
            ra, _ = lk.lattice_bidir_exp_reference(le, ls, lf, il, ol)
            plain = -lat.gather_logz(ra, le, il, ol)
        live = torch.arange(Bn, device=dev) != 2
        rel = float(((loss - ref).abs() / ref.abs())[live].max())
        if not rel <= EXP_VARIANT_RTOL:
            raise AssertionError(f"variant=exp B={Bn}: loss off the log "
                                 f"route by {rel} relative")
        if not (loss[2] == np.inf and plain[2] == np.inf):
            raise AssertionError(f"variant=exp B={Bn}: the degenerate "
                                 f"example's loss is not +inf")
        if not all(bool(torch.isfinite(x.grad).all())
                   and not bool(x.grad[:, 2].any()) for x in leaves):
            raise AssertionError(f"variant=exp B={Bn}: gradients not "
                                 f"finite, or the degenerate example's "
                                 f"not 0")
        log(f"[19 exp train] variant=exp fwd+bwd B={Bn}: 1 bidir_exp "
            f"launch; loss within {rel:.2e} relative of variant=log (tol "
            f"{EXP_VARIANT_RTOL}); degenerate example +inf in the kernel "
            f"and plain routes, gradients finite, its own exactly 0")
    main = lattice_counts()
    if main != (1, 3, 0, 0, 2, 10, 0, 0):
        raise AssertionError(f"exp phase launches {main}")

    lap("19")
    # ---- 20. timings ----
    rows = {}
    for Bn in (B, B_LARGE):
        x, logs, (il, ol) = exp_lattice_inputs(rng, Bn, dev)
        cells = logs[0].numel()
        with torch.no_grad():
            outs = lk.lattice_expin(*x, il, ol)
            fns = [
                ("lattice_expin", lambda: lk.lattice_expin(*x, il, ol),
                 lambda: lk.lattice_expin_reference(*x, il, ol),
                 nbytes(*x, il, ol, *outs), 10 * cells),
                ("lattice_bidir_exp",
                 lambda: lk.lattice_bidir_exp(*logs, il, ol),
                 lambda: lk.lattice_bidir_exp_reference(*logs, il, ol),
                 nbytes(*logs, il, ol) + 2 * nbytes(logs[0]), 20 * cells),
                ("lattice_backward_betas",
                 lambda: lk.lattice_backward_betas(*logs, il, ol),
                 lambda: lk.lattice_backward_betas_reference(*logs, il, ol),
                 nbytes(*logs, il, ol) + nbytes(logs[0]), 10 * cells),
            ]
            for name, kfn, pfn, nb, ops in fns:
                k_ms = graph_ms(kfn, k=20, reps=10)
                p_ms = graph_ms(pfn, k=1, reps=3)
                bd = bound(nb, ops, F32_OPS)
                if Bn == B:
                    rows[name] = (k_ms, p_ms, bd)
                log(f"[20 time] {smi}: {name} B={Bn} T={T} U={U} f32: "
                    f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (device "
                    f"time, CUDA graph); bound {bd[0] * 1e3:.2f} us "
                    f"({bd[1]}, {nb / 1e6:.1f} MB)")
            b_ms = graph_ms(lambda: block_backward_betas(*logs, il, ol),
                            k=20, reps=10)
            log(f"[20 time] {smi}: lattice_backward_betas block walk "
                f"B={Bn} T={T} U={U} f32: {b_ms:.4f} ms (device time, CUDA "
                f"graph); chain floor U x 120 ns = {U * 120e-6:.4f} ms")
    for Bn in (B, B_LARGE):
        (le, ls, lf), (il, ol) = lattice_inputs(rng, Bn, torch.float32, dev)
        for variant in ("exp", "fused", "plain"):
            leaves = [x.clone().requires_grad_() for x in (le, ls, lf)]

            def fwd_bwd():
                lk.ssnt_loss_kernels(*leaves, il, ol, variant=variant,
                                     layout="ubt").sum().backward()

            ms = eager_ms(fwd_bwd, n=10)
            log(f"[20 time] {smi}: lattice loss fwd+bwd B={Bn} T={T} U={U} "
                f"f32, variant {variant}: {ms:.4f} ms per call (CUDA "
                f"events, eager)")
    for Bn in (B, B_LARGE):
        tc = TrainConfig(warmup_steps=EXP_WARMUP, batch_size=Bn)
        batch = to_device(data_lib.SyntheticTTSDataset(
            vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
            seed=seed + 3).batch(Bn), dev)
        st = train_lib.init_train_state(cfg, tc, params=wide, device=dev)
        txn = train_lib.make_optimizer(tc)
        train_lib.train_step(txn, st, batch)  # warm
        ms = split_step_ms(txn, st, batch)
        log(f"[20 time] {smi}: train step B={Bn} T={T} U={U} bf16, "
            f"lattice_domain=exp (kernel route): {ms['total']:.1f} ms = "
            f"forward {ms['forward']:.1f} + backward {ms['backward']:.1f} "
            f"+ optimizer {ms['optimizer']:.1f} (host clock)")

    replaces = {"lattice_expin": 1459, "lattice_bidir_exp": 480,
                "lattice_backward_betas": 348}
    launched = dict(zip(("lattice_backward_betas", "lattice_bidir_exp",
                         "lattice_expin"), main[3:6]))
    return [{
        "name": name, "route": "cuda",
        "source": "ssnt_tts_tpu_torch/csrc/lattice.cu",
        "replaces": f"ssnt_tts_tpu/ops/lattice_pallas.py:{replaces[name]}",
        "launches": launched[name], "max_abs_err": err[name], "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": bd[0], "bound_by": bd[1],
        "library_ms": None,
    } for name, (k_ms, p_ms, bd) in rows.items()]


def lse_cost(m: int) -> tuple:
    """(exp + log, float operations) of an _lse of m terms: m - 1 max, m
    subtractions and exps, m - 1 adds, a log and an add; 0 for one."""
    return (0, 0) if m == 1 else (m + 1, 4 * m)


def banded_costs(K: int, backward: bool) -> tuple:
    """Per (b, t) cell and K-group of a banded walk: (the composition
    tree's exp + log, the whole group's exp + log, its float operations):
    2 adds per column operator, the tree (a term is one add), the chain's
    K+1 terms, K-1 interior columns of 2 terms; the backward adds its
    three posteriors per column (3 exps, 14 other operations)."""
    tree_t = tree_o = 0
    w, n = 2, K
    while n > 1:
        for k in range(2 * w - 1):
            m = min(k, 2 * w - 2 - k, w - 1) + 1
            tt, to = lse_cost(m)
            tree_t += n // 2 * tt
            tree_o += n // 2 * (m + to)
        w, n = 2 * w - 1, n // 2
    chain_t, chain_o = lse_cost(K + 1)
    step_t, step_o = lse_cost(2)
    trans = tree_t + chain_t + (K - 1) * step_t
    ops = 2 * K + tree_o + K + 1 + chain_o + (K - 1) * (2 + step_o)
    if backward:
        trans, ops = trans + 3 * K, ops + 17 * K
    return tree_t, trans, ops


def check_banded(rng, dev) -> dict:
    """Phase 21: #2 and #6 at each K against their plain versions at B=32
    and B=256, every output bit for bit; returns each kernel's max abs
    error."""
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    err = dict.fromkeys(("lattice_forward_alphas_banded",
                         "lattice_backward_grads_banded"), 0.0)
    for Bn in (B, B_LARGE):
        (le, ls, lf), (il, ol) = lattice_inputs(rng, Bn, torch.float32, dev)
        g = torch.tensor(rng.uniform(0.5, 2.0, Bn), dtype=torch.float32,
                         device=dev)
        for K in BANDS:
            with torch.no_grad():
                ka = lk.lattice_forward_alphas_banded(le, ls, lf, K)
                ra = lk.lattice_forward_alphas_banded_reference(le, ls, lf,
                                                                K)
                z = lat.gather_logz(ra, le, il, ol)
                kd = lk.lattice_backward_grads_banded(le, ls, lf, ra, il, ol,
                                                      g, z, K)
                rd = lk.lattice_backward_grads_banded_reference(
                    le, ls, lf, ra, il, ol, g, z, K)
                torch.cuda.synchronize()
            what = f"banded K={K} B={Bn}"
            if not (same_bits(ka, ra) and bool(torch.isfinite(ka).all())):
                raise AssertionError(f"{what}: alphas not the plain "
                                     f"version's bit for bit, or not finite")
            if not all(same_bits(a, b) for a, b in zip(kd, rd)):
                raise AssertionError(f"{what}: gradients not the plain "
                                     f"version's bit for bit")
            if any(bool(d[:, 2].any()) for d in kd):
                raise AssertionError(f"{what}: degenerate example's "
                                     f"gradients are not exactly 0")
            e_a = float((ka - ra).abs().max())
            e_d = max(float((a - b).abs().max()) for a, b in zip(kd, rd))
            err["lattice_forward_alphas_banded"] = max(
                err["lattice_forward_alphas_banded"], e_a)
            err["lattice_backward_grads_banded"] = max(
                err["lattice_backward_grads_banded"], e_d)
        log(f"[21 banded] B={Bn} T={T} U={U} f32, K in {BANDS}: forward "
            f"alphas (#2) and backward gradients (#6) equal their plain "
            f"versions bit for bit; degenerate grads exactly 0")
    return err


def route_grads_err(grads, ref_grads, ref_loss) -> tuple:
    """Two routes' lattice gradients (U, B, T) against each other:
    max(|d| - rtol |ref|) over the cells, held to BANDED_GRAD_ATOL by the
    caller, with rtol = max(BANDED_GRAD_RTOL, GRAD_ULPS eps |logZ|) per
    example; and the largest relative difference (where |ref| > 1e-3) in
    units of eps |logZ|."""
    eps_z = (torch.finfo(torch.float32).eps
             * ref_loss.abs())[None, :, None]  # eps |logZ| per example
    rtol = (GRAD_ULPS * eps_z).clamp(min=BANDED_GRAD_RTOL)
    gerr = max(float(((a - b).abs() - rtol * b.abs()).max())
               for a, b in zip(grads, ref_grads))
    ulps = max(float(((a - b).abs() / (b.abs() * eps_z))[
        b.abs() > 1e-3].max()) for a, b in zip(grads, ref_grads))
    return gerr, ulps


def banded_phases(seed: int, dev, smi: str) -> list:
    """Phases 21-23; returns #2's and #6's entries of the JSON line (the
    K=2 instance, bare "banded"'s, at B=32)."""
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    rng = np.random.default_rng(seed + 6)
    # ---- 21. banded kernels against their plain versions ----
    err = check_banded(rng, dev)

    lap("21")
    # ---- 22. the banded path ----
    def fwd_bwd(x, variant):
        (le, ls, lf), (il, ol) = x
        leaves = [a.clone().requires_grad_() for a in (le, ls, lf)]
        loss = lk.ssnt_loss_kernels(*leaves, il, ol, variant=variant,
                                    layout="ubt")
        loss.sum().backward()
        return loss.detach(), [a.grad for a in leaves]

    inputs = {Bn: lattice_inputs(rng, Bn, torch.float32, dev)
              for Bn in (B, B_LARGE)}
    refs = {Bn: fwd_bwd(x, "log") for Bn, x in inputs.items()}
    torch.cuda.synchronize()
    zero_counts()
    runs = {}
    for Bn, x in inputs.items():
        for K in BANDS:
            before = lattice_counts()
            loss, grads = fwd_bwd(x, f"banded{K}")
            with torch.no_grad():
                nograd = lk.ssnt_loss_kernels(*x[0], *x[1],
                                              variant=f"banded{K}",
                                              layout="ubt")
            torch.cuda.synchronize()
            got = tuple(a - b for a, b in zip(lattice_counts(), before))
            if got != (0, 0, 0, 0, 0, 0, 2, 1):
                raise AssertionError(f"banded{K} B={Bn}: launches "
                                     f"{LAUNCH_NAMES} {got}, not one #2 + "
                                     f"one #6 and one #2 without grad")
            if not same_bits(nograd, loss):
                raise AssertionError(f"banded{K} B={Bn}: the no-grad "
                                     f"forward differs from the grad one")
            runs[f"banded{K}", Bn] = (loss, grads)
    before = lattice_counts()
    runs["scan", B] = fwd_bwd(inputs[B], "scan")
    torch.cuda.synchronize()
    if lattice_counts() != before:
        raise AssertionError("variant=scan launched a lattice kernel")
    main = lattice_counts()
    n_runs = 2 * len(BANDS)
    if main != (0, 0, 0, 0, 0, 0, 2 * n_runs, n_runs):
        raise AssertionError(f"banded phase launches {main}")
    for (variant, Bn), (loss, grads) in runs.items():
        ref_loss, ref_grads = refs[Bn]
        live = torch.arange(Bn, device=dev) != 2
        rel = float(((loss - ref_loss).abs() / ref_loss.abs())[live].max())
        gerr, ulps = route_grads_err(grads, ref_grads, ref_loss)
        if not (rel <= BANDED_LOSS_RTOL and gerr <= BANDED_GRAD_ATOL):
            raise AssertionError(f"{variant} B={Bn}: loss {rel} relative, "
                                 f"gradients {gerr} past the tolerance of "
                                 f"variant=log ({ulps:.1f} eps |logZ|)")
        if not (bool(loss[2] >= -lat.NEG / 2) and all(
                bool(torch.isfinite(x).all()) and not bool(x[:, 2].any())
                for x in grads)):
            raise AssertionError(f"{variant} B={Bn}: the degenerate "
                                 f"example's loss is not the sentinel, or "
                                 f"gradients not finite or its own not 0")
        log(f"[22 banded path] variant={variant} fwd+bwd B={Bn} T={T} "
            f"U={U}: loss within {rel:.2e} relative of variant=log (tol "
            f"{BANDED_LOSS_RTOL}), gradients within {ulps:.2f} eps |logZ| "
            f"relative (tol max({BANDED_GRAD_RTOL}, {GRAD_ULPS} eps |logZ|) "
            f"+ {BANDED_GRAD_ATOL}; |logZ| up to "
            f"{float(ref_loss[live].abs().max()):.1f}); degenerate example "
            f"at the sentinel, its gradients exactly 0")
    log(f"[22 banded path] launches {LAUNCH_NAMES} {main}: one #2 + one #6 "
        f"per banded fwd+bwd and one #2 per no-grad forward, at each K and "
        f"B; variant=scan none")

    lap("22")
    # ---- 23. timings ----
    rows = {}
    for Bn in (B, B_LARGE):
        (le, ls, lf), (il, ol) = lattice_inputs(rng, Bn, torch.float32, dev)
        g = torch.ones(Bn, device=dev)
        with torch.no_grad():
            a1 = lk.lattice_forward_alphas(le, ls, lf)
            f_ms = graph_ms(lambda: lk.lattice_forward_alphas(le, ls, lf),
                            k=20, reps=10)
            f_bd = bound(nbytes(le, ls, lf, a1), 0, F32_OPS)
            log(f"[23 time] {smi}: lattice_forward_alphas (#1, beside #2) "
                f"B={Bn} T={T} U={U} f32: kernel {f_ms:.4f} ms (device "
                f"time, CUDA graph); bound {f_bd[0] * 1e3:.2f} us (bytes)")
            for K in BANDS:
                a = lk.lattice_forward_alphas_banded(le, ls, lf, K)
                z = lat.gather_logz(a, le, il, ol)
                groups = -(-U // K)
                fns = [
                    ("lattice_forward_alphas_banded", False,
                     lambda: lk.lattice_forward_alphas_banded(le, ls, lf, K),
                     lambda: lk.lattice_forward_alphas_banded_reference(
                         le, ls, lf, K),
                     nbytes(le, ls, lf, a)),
                    ("lattice_backward_grads_banded", True,
                     lambda: lk.lattice_backward_grads_banded(
                         le, ls, lf, a, il, ol, g, z, K),
                     lambda: lk.lattice_backward_grads_banded_reference(
                         le, ls, lf, a, il, ol, g, z, K),
                     nbytes(le, ls, lf, a, il, ol, g, z) + 3 * nbytes(le)),
                ]
                # The workspaces, each written and read once: the groups'
                # composed operators (#2 and #6) and #6's group bottoms.
                work = {False: 2 * groups * (K + 1) * Bn * T * 4,
                        True: 2 * groups * (K + 2) * Bn * T * 4}
                for name, bwd, kfn, pfn, nb in fns:
                    k_ms = graph_ms(kfn, k=20, reps=10)
                    p_ms = graph_ms(pfn, k=1, reps=2)
                    tree_t, trans, ops = banded_costs(K, bwd)
                    cells = groups * Bn * T
                    bd = bound(nb, ops * cells, F32_OPS)
                    rows[name, Bn, K] = (k_ms, p_ms, bd)
                    ws = (f"; with the workspaces written and read once "
                          f"({work[bwd] / 1e6:.1f} MB) "
                          f"{bound(nb + work[bwd], 0, F32_OPS)[0] * 1e3:.2f}"
                          f" us")
                    log(f"[23 time] {smi}: {name} K={K} B={Bn} T={T} U={U} "
                        f"f32: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
                        f"(device time, CUDA graph); bound "
                        f"{bd[0] * 1e3:.2f} us ({bd[1]}, {nb / 1e6:.1f} MB, "
                        f"{ops * cells / 1e6:.1f} M operations){ws}; per "
                        f"cell and group: tree {tree_t} exp+log, walk "
                        f"{trans} exp+log, {ops} operations")
    for Bn in (B, B_LARGE):
        x = lattice_inputs(rng, Bn, torch.float32, dev)
        for variant in [f"banded{K}" for K in BANDS] + ["fused", "exp",
                                                         "plain", "scan"]:
            ms = eager_ms(lambda: fwd_bwd(x, variant), n=10)
            # The route's device time: forward and backward under a graph.
            scan = variant == "scan"
            dev_ms = graph_ms(lambda: fwd_bwd(x, variant), k=1 if scan else 5,
                              reps=2 if scan else 5)
            log(f"[23 time] {smi}: lattice loss fwd+bwd B={Bn} T={T} U={U} "
                f"f32, variant {variant}: {ms:.4f} ms per call (CUDA "
                f"events, eager); device time {dev_ms:.4f} ms (CUDA graph)")

    replaces = {"lattice_forward_alphas_banded": 289,
                "lattice_backward_grads_banded": 726}
    launched = dict(zip(replaces, main[6:]))
    return [{
        "name": name, "route": "cuda",
        "source": "ssnt_tts_tpu_torch/csrc/lattice.cu",
        "replaces": f"ssnt_tts_tpu/ops/lattice_pallas.py:{replaces[name]}",
        "launches": launched[name], "max_abs_err": err[name],
        "ms": rows[name, B, 2][0], "plain_ms": rows[name, B, 2][1],
        "bound_ms": rows[name, B, 2][2][0],
        "bound_by": rows[name, B, 2][2][1], "library_ms": None,
    } for name in replaces]


def long_inputs(rng, Bn: int, Tn: int, Un: int, dev, lens=None):
    """A (Un, Bn, Tn) float32 lattice (lattice_inputs' distributions) whose
    paths reach far: example 0 with il = Tn and ol = Un (no path when Un <
    Tn: its alphas then exercise the low positions and its betas the high
    ones), the others il <= min(Tn, Un), ol in [il, Un]; with B > 2,
    example 1 il = ol = 1 and example 2 degenerate (ol = il - 1). lens:
    (il, ol) given instead."""
    le = np.log(rng.uniform(0.1, 0.9, (Un, Bn, Tn)))
    ls = np.log1p(-np.exp(le))
    lf = rng.normal(-2.0, 1.0, (Un, Bn, Tn))
    il = rng.integers(2, min(Tn, Un) + 1, Bn)
    ol = np.minimum(Un, il + rng.integers(0, Un, Bn))
    il[0], ol[0] = Tn, Un
    if Bn > 2:
        il[1], ol[1] = 1, 1
        ol[2] = il[2] - 1
    if lens is not None:
        il, ol = (np.asarray(x) for x in lens)
    lat = [torch.tensor(x, dtype=torch.float32, device=dev)
           for x in (le, ls, lf)]
    lens = [torch.tensor(x, dtype=torch.int32, device=dev) for x in (il, ol)]
    return lat, lens


def block_bounds(Tn: int) -> list:
    """Where a block walk's thread takes its next position past 1024
    threads: t = p n for p in 1..P-1, t = threadIdx.x + p n, as
    launch_block_walk picks P (the least of 2, 4, 8 with ceil(Tn / P) <=
    1024) and n = ceil(Tn / P) rounded up to a warp."""
    P = next(p for p in (2, 4, 8) if -(-Tn // p) <= 1024)
    n = -(-(-(-Tn // P)) // 32) * 32
    return [p * n for p in range(1, P) if p * n < Tn]


def crossed(live, bounds) -> list:
    """The bounds b at which some column and example of live (U, B, T)
    holds a live cell at both t = b - 1 and t = b: a walk that reads its
    neighbour across b reads a live value there."""
    return [b for b in bounds if bool((live[:, :, b - 1] & live[:, :, b])
                                      .any())]


def check_long(rng, Bn: int, Tn: int, Un: int, dev, lens=None) -> tuple:
    """Phase 24 at one shape: #8, #1, #3, #5 (float32 and bfloat16
    storage), #4 and #9 against their plain versions (LAT_REL, GRAD_F32 /
    GRAD_BF16 with g = 1, -inf cells equal; #8's alphas and betas bit for
    bit #1's and #3's; #9 bit for bit). Returns a summary and, for the
    plain alphas, betas, f32 gradients, exp-domain betas and #9's bn, the
    block_bounds each carries live values across (crossed)."""
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    (le, ls, lf), (il, ol) = long_inputs(rng, Bn, Tn, Un, dev, lens)
    bounds = block_bounds(Tn)
    cover = {}
    what = f"B={Bn} T={Tn} U={Un}"
    g = torch.ones(Bn, device=dev)
    with torch.no_grad():
        ka, kb = lk.lattice_bidir(le, ls, lf, il, ol)
        ra, rb = lk.lattice_bidir_reference(le, ls, lf, il, ol)
        fa = lk.lattice_forward_alphas(le, ls, lf)
        fb = lk.lattice_backward_betas(le, ls, lf, il, ol)
        torch.cuda.synchronize()
        cover["alphas"] = crossed(ra > lat.NEG / 2, bounds)
        cover["betas"] = crossed(rb > lat.NEG / 2, bounds)
        e_lat = max(lattice_err(ka, ra, f"bidir alphas {what}"),
                    lattice_err(kb, rb, f"bidir betas {what}"))
        if not (same_bits(ka, fa) and same_bits(kb, fb)):
            raise AssertionError(f"{what}: bidir alphas/betas not forward "
                                 f"alphas' / backward betas' bit for bit")
        e_grad = {}
        for dtype, tol in ((torch.float32, GRAD_F32),
                           (torch.bfloat16, GRAD_BF16)):
            x = [t.to(dtype) for t in (le, ls, lf)]
            a = lk.lattice_forward_alphas(*x)
            r = lk.lattice_forward_alphas_reference(*x)
            z = lat.gather_logz(r, x[0], il, ol)
            kd = lk.lattice_backward_grads(*x, r, il, ol, g, z)
            rd = lk.lattice_backward_grads_reference(*x, r, il, ol, g, z)
            torch.cuda.synchronize()
            e_lat = max(e_lat, lattice_err(a, r, f"forward alphas {what} "
                                                 f"{dtype}"))
            err = max(float((p.float() - q.float()).abs().max())
                      for p, q in zip(kd, rd))
            if not (err <= tol and all(d.dtype == dtype for d in kd)):
                raise AssertionError(f"backward grads {what} {dtype}: "
                                     f"error {err} > {tol}")
            if Bn > 2 and any(bool(d[:, 2].float().any()) for d in kd):
                raise AssertionError(f"backward grads {what}: degenerate "
                                     f"example's gradients not exactly 0")
            e_grad[dtype] = err
            if dtype == torch.float32:
                cover["grads"] = crossed(rd[0] != 0, bounds)
        ea, eb = lk.lattice_bidir_exp(le, ls, lf, il, ol)
        rea, reb = lk.lattice_bidir_exp_reference(le, ls, lf, il, ol)
        torch.cuda.synchronize()
        for p, q, n in ((ea, rea, "alphas"), (eb, reb, "betas")):
            if not torch.equal(torch.isneginf(p), torch.isneginf(q)):
                raise AssertionError(f"bidir_exp {n} {what}: -inf cells "
                                     f"differ")
            lattice_err(p, q, f"bidir_exp {n} {what}")
        exp_bits = same_bits(ea, rea) and same_bits(eb, reb)
        cover["exp betas"] = crossed(torch.isfinite(reb), bounds)
        tmask = (torch.arange(Tn, device=dev)[None, None, :]
                 < il[None, :, None])
        mcol = torch.where(tmask, lf, -1e30).amax(dim=2)
        F = torch.exp(torch.where(tmask, lf - mcol[:, :, None], -torch.inf))
        _, (_, bn, _, _) = check_expin_bits((le.exp(), ls.exp(), F, mcol),
                                            il, ol, what)
        cover["expin bn"] = crossed(bn != 0, bounds)
    return (f"{what}: bidir/forward/betas max rel err {e_lat[1]:.2e} (tol "
            f"{LAT_REL}), bidir bit for bit forward alphas' and backward "
            f"betas'; backward grads err f32 {e_grad[torch.float32]:.2e} "
            f"(tol {GRAD_F32}) bf16 {e_grad[torch.bfloat16]:.2e} (tol "
            f"{GRAD_BF16}); bidir_exp within {LAT_REL}, -inf cells equal, "
            f"bit for bit the plain version's: {exp_bits}; expin bit for "
            f"bit; live values across the block walks' position bounds "
            f"{bounds}: {cover}"), cover


# Elements of each guard band around guard_check's tensors.
GUARD = 4096


def guard_check(rng, dev) -> str:
    """#1 and #5 (float32 and bfloat16 storage), #3 (the entries' walks and
    the block walks' _block entries) and #8, called through their C
    entries at T = 80 (warp walks; block walks at one thread a position),
    1100, 3000 and MAX_T (2, 4 and 8 positions a thread), twice: on plain
    tensors and with every tensor in the middle of a buffer whose GUARD
    elements on each side hold NaN (inputs; -2^30 for lengths) or a
    sentinel bit pattern (outputs). The second run must leave the guard
    bands as they were, write every output cell and give the first run's
    bits: no write outside an output, no read of a guard band that reaches
    a result. Returns a summary."""
    from ssnt_tts_tpu_torch.ops import _build
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    lib = _build.lattice_library()
    sentinel = {torch.float32: (torch.int32, 0x7FBADBAD),
                torch.bfloat16: (torch.int16, 0x7FAD)}

    def banded(x, fill=None):
        """(buffer, the view of x's shape in its middle)."""
        buf = torch.empty(x.numel() + 2 * GUARD, dtype=x.dtype, device=dev)
        if fill is None:
            view, bits = sentinel[x.dtype]
            buf.view(view).fill_(bits)
        else:
            buf.fill_(fill)
        mid = buf[GUARD:GUARD + x.numel()].view(x.shape)
        if fill is not None:
            mid.copy_(x)
        return buf, mid

    def call(entry, lead, ins, outs) -> int:
        """Checks entry on ins (tensors) with outputs shaped as outs;
        returns the cells written."""
        fn = getattr(lib, entry)
        stream = torch.cuda.current_stream().cuda_stream
        plain = [torch.empty_like(o) for o in outs]
        rc = fn(*lead, *(x.data_ptr() for x in (*ins, *plain)), stream)
        gin = [banded(x, -(1 << 30) if x.dtype == torch.int32
                      else float("nan")) for x in ins]
        gout = [banded(o) for o in outs]
        rc = rc or fn(*lead, *(m.data_ptr() for _, m in (*gin, *gout)),
                      stream)
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"{entry}: cudaError {rc}")
        for (buf, mid), want in zip(gout, plain):
            view, bits = sentinel[buf.dtype]
            band = torch.cat([buf[:GUARD], buf[-GUARD:]]).view(view)
            if not bool((band == bits).all()):
                raise AssertionError(f"{entry} {lead}: a guard band was "
                                     f"written")
            if bool((mid.view(view) == bits).any()):
                raise AssertionError(f"{entry} {lead}: an output cell was "
                                     f"not written")
            if not same_bits(mid, want):
                raise AssertionError(f"{entry} {lead}: not the unguarded "
                                     f"run's bits")
        for (buf, mid), x in zip(gin, ins):
            if not same_bits(mid, x):
                raise AssertionError(f"{entry} {lead}: an input changed")
        return sum(o.numel() for o in outs)

    cells, runs = 0, 0
    for Bn, Tn, Un in ((4, T, 40), (2, 1100, 24), (2, 3000, 24),
                       (2, lk.MAX_T, 24)):
        (le, ls, lf), (il, ol) = long_inputs(rng, Bn, Tn, Un, dev)
        shape = (Un, Bn, Tn)
        f32 = torch.empty(shape, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = [t.to(dtype) for t in (le, ls, lf)]
            bf16 = int(dtype == torch.bfloat16)
            a = block_forward_alphas(*x)
            z = lat.gather_logz(a, x[0], il, ol)
            g = torch.ones(Bn, device=dev)
            d = torch.empty(shape, dtype=dtype, device=dev)
            for block in ("", "_block"):
                cells += call(f"ssnt_lattice_forward_alphas{block}",
                              (bf16, Bn, Tn, Un), x, [f32])
                cells += call(f"ssnt_lattice_backward_grads{block}",
                              (bf16, Bn, Tn, Un), [*x, a, il, ol, g, z],
                              [d, d, d])
                runs += 2
        for block in ("", "_block"):
            cells += call(f"ssnt_lattice_backward_betas{block}",
                          (Bn, Tn, Un), [le, ls, lf, il, ol], [f32])
        cells += call("ssnt_lattice_bidir", (Bn, Tn, Un),
                      [le, ls, lf, il, ol], [f32, f32])
        runs += 3
    return (f"{runs} guarded calls of #1, #5 (f32, bf16), #3 (walk and "
            f"block walk), #8 at T = {T}, 1100, 3000, {lk.MAX_T}: guard "
            f"bands of {GUARD} elements intact, all {cells} output cells "
            f"written, bit for bit the unguarded runs")


def long_phase(seed: int, dev) -> None:
    """Phase 24: lattices past one thread a position, the T limit and the
    banded kernels' named limits."""
    from ssnt_tts_tpu_torch.ops import _build
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    rng = np.random.default_rng(seed + 7)
    limit = _build.lattice_library().ssnt_lattice_max_t()
    if limit != lk.MAX_T or limit < 8192:
        raise AssertionError(f"T limit: the kernels' {limit}, the "
                             f"wrapper's {lk.MAX_T}")
    # (B, T, U, lengths, the bounds each field must carry live values
    # across): T = 3000 holds 4 positions a thread (example 1: il 1560 < ol,
    # a band of paths past two bounds), MAX_T 8; at MAX_T the examples of U
    # = 16 end 8 past each bound (betas live there, in both domains), and
    # at U = 1100 example 1 (il 1060 < ol) takes alphas and gradients past
    # the first bound. "all": every bound. The exp-domain fields flush
    # cells far below their column's best, so at U >= 1100 they are only
    # reported.
    t3k = block_bounds(3000)
    shapes = (
        (2, T_LONG, U, None, {}), (8, T_LONG, U, None, {}),
        (2, 1100, 1100, None, {}),
        (3, 3000, 1600, ([3000, 1560, 2320], [1600] * 3),
         {"alphas": t3k[:2], "betas": "all", "grads": t3k[:2]}),
        (8, lk.MAX_T, 16, ([lk.MAX_T] + [1024 * k + 8 for k in range(1, 8)],
                           [16] * 8),
         {"betas": "all", "exp betas": "all", "expin bn": "all"}),
        (2, lk.MAX_T, 1100, ([lk.MAX_T, 1060], [1100, 1100]),
         {"alphas": [1024], "grads": [1024]}))
    for Bn, Tn, Un, lens, need in shapes:
        summary, cover = check_long(rng, Bn, Tn, Un, dev, lens)
        log(f"[24 long] {summary}")
        for field, want in need.items():
            want = block_bounds(Tn) if want == "all" else want
            if not set(want) <= set(cover[field]):
                raise AssertionError(f"B={Bn} T={Tn} U={Un}: {field} carry "
                                     f"live values across {cover[field]}, "
                                     f"not every one of {want}")
    log(f"[24 guard] {guard_check(rng, dev)}")

    # One loss step through the kernel route against the plain route.
    from ssnt_tts_tpu_torch.models.ssnt import lattice_loss

    for Bn, route, want in ((2, "fused", 1), (8, "plain", 2)):
        (le, ls, lf), (il, ol) = long_inputs(rng, Bn, T_LONG, U, dev)
        if lk.grad_mode("log", Bn, T_LONG)[0] != route:
            raise AssertionError(f"B={Bn} T={T_LONG}: not route {route}")
        runs = []
        for impl in ("pallas", "xla"):
            leaves = [x.clone().requires_grad_() for x in (le, ls, lf)]
            before = lattice_counts()
            loss = lattice_loss(impl, "float32", leaves, il, ol)
            loss.sum().backward()
            torch.cuda.synchronize()
            n = sum(lattice_counts()) - sum(before)
            if n != (want if impl == "pallas" else 0):
                raise AssertionError(f"lattice_loss {impl} B={Bn}: {n} "
                                     f"kernel launches")
            runs.append((loss.detach(), [x.grad for x in leaves]))
        (kl, kg), (pl, pg) = runs
        rel = float(((kl - pl).abs() / pl.abs()).max())
        gerr, ulps = route_grads_err(kg, pg, pl)
        if not (rel <= ROUTE_LOSS_RTOL and gerr <= BANDED_GRAD_ATOL
                and bool(torch.isfinite(kl).all())):
            raise AssertionError(f"lattice_loss B={Bn} T={T_LONG}: loss "
                                 f"{rel} relative, gradients {gerr} past the "
                                 f"tolerance ({ulps:.1f} eps |logZ|)")
        n_none = int((pl >= -lat.NEG / 2).sum())
        log(f"[24 long] lattice_loss fwd+bwd B={Bn} T={T_LONG} U={U}, "
            f"kernel route ({route}: {want} launch(es)) vs plain route: loss "
            f"within {rel:.2e} relative (tol {ROUTE_LOSS_RTOL}), gradients "
            f"within {ulps:.2f} eps |logZ| relative (tol max("
            f"{BANDED_GRAD_RTOL}, {GRAD_ULPS} eps |logZ|) + "
            f"{BANDED_GRAD_ATOL}); {n_none} example(s) without a path, at "
            f"the sentinel")

    x = [torch.zeros((1, 1, lk.MAX_T + 1), device=dev) for _ in range(3)]
    try:
        lk.lattice_forward_alphas(*x)
    except ValueError as e:
        if str(lk.MAX_T) not in str(e):
            raise AssertionError(f"T limit + 1: {e}") from e
        log(f"[24 long] T={lk.MAX_T + 1}: ValueError ({e})")
    else:
        raise AssertionError(f"T={lk.MAX_T + 1} did not raise")

    # The banded kernels' limits, one thread a position: run at the limit,
    # refused at the limit + 32.
    for K in BANDS:
        limits = [lk.banded_max_t(K, d) for d in (0, 1)]
        Tn = min(limits)
        (le, ls, lf), (il, ol) = long_inputs(rng, 2, Tn, 16, dev)
        g = torch.ones(2, device=dev)
        with torch.no_grad():
            ka = lk.lattice_forward_alphas_banded(le, ls, lf, K)
            ra = lk.lattice_forward_alphas_banded_reference(le, ls, lf, K)
            z = lat.gather_logz(ra, le, il, ol)
            kd = lk.lattice_backward_grads_banded(le, ls, lf, ra, il, ol, g,
                                                  z, K)
            rd = lk.lattice_backward_grads_banded_reference(
                le, ls, lf, ra, il, ol, g, z, K)
            torch.cuda.synchronize()
        if not (same_bits(ka, ra)
                and all(same_bits(a, b) for a, b in zip(kd, rd))):
            raise AssertionError(f"banded K={K} T={Tn}: not the plain "
                                 f"versions' bit for bit")
        refused = []
        for d, lim in enumerate(limits):
            x = [torch.zeros((16, 1, lim + 32), device=dev)
                 for _ in range(3)]
            lens = [torch.ones(1, dtype=torch.int32, device=dev)] * 2
            one = torch.ones(1, device=dev)
            try:
                if d == 0:
                    lk.lattice_forward_alphas_banded(*x, K)
                else:
                    lk.lattice_backward_grads_banded(*x, x[0], *lens, one,
                                                     one, K)
            except ValueError as e:
                if str(lim) not in str(e):
                    raise AssertionError(f"banded K={K}: {e}") from e
                refused.append(lim + 32)
            else:
                raise AssertionError(f"banded K={K} T={lim + 32} ran")
        log(f"[24 long] banded K={K}: limits T <= {limits[0]} (forward), "
            f"{limits[1]} (backward); run at T={Tn} bit for bit the plain "
            f"versions', refused at T={refused} (ValueError naming the "
            f"limit)")


def tone_step_inputs(model, tokens, il, s: int, rng, dev, Wn: int = W):
    """Fused tone step inputs at step s: beams at t = min(s, T_b) (past
    their length for short utterances), some finished, duplicated beams;
    at s = 0 the decode's own first step (every beam identical). The
    batch is the request's."""
    from ssnt_tts_tpu_torch.models import stepmath
    from ssnt_tts_tpu_torch.ops import beam_fused

    with torch.no_grad():
        w = model.tone_step_weights()
        enc = model.encode(tokens, il)
        xin, base = stepmath.class_decode_paths(w, enc, il, model.dtype,
                                                kind="tone")
        fw = beam_fused.prepare_fused_weights(w, model.dtype)
    H, K = model.config.decoder_dim, model.config.tone_class_size
    il_n = il.cpu().numpy()
    Bn = il_n.shape[0]
    t = np.minimum(s, il_n)[:, None].repeat(Wn, 1)
    fin = rng.random((Bn, Wn)) < 0.15
    lp = -rng.gamma(2.0, 2.0 + s / 4, (Bn, Wn))
    state = rng.normal(0, 0.5, (Bn, Wn, H))
    pc = rng.integers(0, K, (Bn, Wn))
    for a in (fin, lp, state, pc):  # beams 0 and 1 identical
        a[::3, 1] = a[::3, 0]
    if s == 0:
        fin[:], lp[:], state[:], pc[:] = False, 0.0, 0.0, 0
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return (s, xin, base, fw, i32(pc),
            torch.tensor(state, dtype=torch.float32, device=dev),
            torch.tensor(lp, dtype=torch.float32, device=dev),
            torch.tensor(fin, device=dev), i32(t), i32(t), il)


def check_tone_step(args, empty_tone_id: int, tol: float) -> tuple:
    """Phase 10 for one input set: returns (max |dh|, max |dnew_h|)."""
    from ssnt_tts_tpu_torch.ops import beam_fused, tone_latent

    state = args[5]
    Bn, Wn, _ = state.shape
    dbg_k = (torch.empty(Bn, Wn, args[2].shape[2], device=state.device),
             torch.empty_like(state))
    dbg_r = tuple(torch.empty_like(x) for x in dbg_k)
    with torch.no_grad():
        k = beam_fused.fused_tone_step(*args, empty_tone_id=empty_tone_id,
                                       debug_out=dbg_k)
        beam_fused.fused_tone_step_reference(
            *args, empty_tone_id=empty_tone_id, debug_out=dbg_r)
        torch.cuda.synchronize()
        err_h = (dbg_k[0] - dbg_r[0]).abs().max().item()
        err_n = (dbg_k[1] - dbg_r[1]).abs().max().item()
        if not (err_h <= tol and err_n <= tol):
            raise AssertionError(f"tone kernel vs plain model step: |dh| "
                                 f"{err_h} |dnew_h| {err_n} > {tol}")
        _, _, _, _, _, lp, fin, t, u, il = args[1:]
        sel = tone_latent.beam_search_step(dbg_k[0], lp, fin, t, u, il,
                                           empty_tone_id=empty_tone_id)
        want = list(sel) + [beam_fused.reorder_state(dbg_k[1], sel[5])]
        for name, a, b in zip(beam_fused.ToneStep._fields, k, want):
            if not same_bits(a, b):
                raise AssertionError(f"tone selection differs on {name} "
                                     f"(step {args[0]}, empty "
                                     f"{empty_tone_id})")
    return err_h, err_n


def beam_only_inputs(rng, s: int, Wn: int, D: int, K: int, H: int, il, ol,
                     dev):
    """h for D duration classes and h_tone for K tone classes (log-softmax
    of random logits), beam rows around the diagonal at step s (some
    finished, at their last position or past it, duplicated) and random
    state rows; utterance 0 overruns at t = 0, so its v2 beam empties
    outside test_mode."""
    il_n, ol_n = il.cpu().numpy().copy(), ol.cpu().numpy().copy()
    ol_n[0] = il_n[0]
    logp = lambda n: torch.log_softmax(torch.tensor(
        rng.normal(0, 1.5, (B, Wn, n)), dtype=torch.float32), -1).numpy()
    h, h_tone = logp(D), logp(K)
    t = np.minimum(s, il_n)[:, None].repeat(Wn, 1)
    last = rng.random((B, Wn)) < 0.1
    t[last] = il_n[np.nonzero(last)[0]] - 1
    t[0] = 0
    tot = np.maximum(np.round(ol_n[:, None] / il_n[:, None] * t)
                     + rng.integers(-6, 6, (B, Wn)), 0)
    fin = rng.random((B, Wn)) < 0.15
    fin[0] = False
    lp = -rng.gamma(2.0, 2.0 + s / 4, (B, Wn))
    state = rng.normal(0, 0.5, (B, Wn, H))
    for a in (t, tot, fin, lp, h, h_tone, state):
        a[::3, 1] = a[::3, 0]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return dict(h=f32(h), h_tone=f32(h_tone), lp=f32(lp),
                fin=torch.tensor(fin, device=dev),
                tot=i32(tot), t=i32(t), u=i32(t), il=il, ol=i32(ol_n),
                state=f32(state))


def check_beam_only(x, dtab, opts: dict, empty_tone_id: int,
                    w_out=None) -> float:
    """Phase 11 for one input set: both beam-only kernels against their
    plain versions at max_beam_width w_out (None: W), every output bit
    for bit; returns the v2 survivor count of utterance 0."""
    from ssnt_tts_tpu_torch.ops import beam_kernels as bk

    v2_args = (x["h"], x["lp"], x["fin"], x["tot"], dtab, x["t"], x["u"],
               x["il"], x["ol"])
    tone_args = (x["h_tone"], x["lp"], x["fin"], x["t"], x["u"], x["il"])
    with torch.no_grad():
        pairs = [
            ("v2 #12", bk.v2_beam_search_decode(
                *v2_args, state=x["state"], max_beam_width=w_out, **opts),
             bk.v2_beam_search_decode_reference(
                 *v2_args, state=x["state"], max_beam_width=w_out, **opts)),
            ("tone #13", bk.tone_beam_search_decode(
                *tone_args, state=x["state"], empty_tone_id=empty_tone_id,
                max_beam_width=w_out),
             bk.tone_beam_search_decode_reference(
                 *tone_args, state=x["state"],
                 empty_tone_id=empty_tone_id, max_beam_width=w_out)),
        ]
        torch.cuda.synchronize()
    for what, k, r in pairs:
        for name, a, b in zip(k._fields, k, r):
            if not same_bits(a, b):
                raise AssertionError(
                    f"{what} kernel differs on {name} ({opts}, empty "
                    f"{empty_tone_id}, W={x['h'].shape[1]}, W_out={w_out}, "
                    f"F={x['state'].shape[-1]})")
    return int(pairs[0][1].num_survivors[0])


def tone_requests(cfg, seed: int, dev, n: int = 3) -> list:
    """n synthetic batches (data.SyntheticTTSDataset) of B utterances:
    (tokens, input_length, tone_target) on the card."""
    from ssnt_tts_tpu_torch import data as data_lib

    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=T, max_output_length=U,
        tone_class_size=cfg.tone_class_size, seed=seed + 4)
    as_t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return [tuple(as_t(b[k]) for k in ("tokens", "input_length",
                                       "tone_target"))
            for b in (ds.batch(B) for _ in range(n))]


def check_tones(i, out, il, K: int, Wn: int) -> None:
    tones, lp = out["tones"], out["log_prob"]
    if tones.shape != (B, Wn, T) or not bool(torch.isfinite(lp).all()):
        raise AssertionError(f"tone request {i}: shape {tuple(tones.shape)}"
                             f" or log-probs not finite")
    inside = torch.arange(T, device=il.device)[None, None, :] < il[:, None,
                                                                  None]
    if not bool(((tones >= 0) & (tones < K))[inside.expand_as(tones)]
                .all()) or bool((tones[~inside.expand_as(tones)] != 0)
                                .any()):
        raise AssertionError(f"tone request {i}: tones out of range")
    if not bool((lp[:, 0] == lp.max(dim=1).values).all()):
        raise AssertionError(f"tone request {i}: slot 0 is not the best")


def tone_phases(seed: int, dev, smi: str, models, v2_req) -> list:
    """Phases 10-13; returns the new kernels' entries of the JSON line."""
    from ssnt_tts_tpu_torch.bench_fused import host_us
    from ssnt_tts_tpu_torch.ops import beam_fused
    from ssnt_tts_tpu_torch.ops import beam_kernels as bk
    from ssnt_tts_tpu_torch.ops import edit_distance
    from ssnt_tts_tpu_torch.parallel import decode

    rng = np.random.default_rng(seed + 5)
    bf = models[torch.bfloat16]
    cfg = bf.config
    H, K, D = cfg.decoder_dim, cfg.tone_class_size, cfg.duration_class_size
    reqs = tone_requests(cfg, seed, dev)
    mid = min(30, T - 1)

    # ---- 10. fused tone step against the plain step ----
    worst = {}
    for dt, model in models.items():
        errs = []
        toks, il, _ = reqs[0]
        for s in (0, mid, T - 1):
            for empty in (0, 3):
                inputs = tone_step_inputs(model, toks, il, s, rng, dev)
                errs.append(check_tone_step(inputs, empty, TOL[dt]))
        errs.append(check_tone_step(
            tone_step_inputs(model, toks, il, 0, rng, dev, Wn=16), 3,
            TOL[dt]))
        worst[dt] = max(max(e) for e in errs)
        log(f"[10 tone step] {str(dt)[6:]}: {len(errs)} steps (W={W} at "
            f"s=0/{mid}/{T - 1} with empty_tone_id 0 and 3, W=16 first step), "
            f"selection and reorder bit-exact; max |dh|, |dnew_h| "
            f"{worst[dt]:.3e} (tol {TOL[dt]})")

    lap("10")
    # ---- 11. beam-only kernels against their plain versions ----
    from ssnt_tts_tpu_torch.utils.config import V2BeamConfig

    dtab = torch.tensor(cfg.duration_table, dtype=torch.int32, device=dev)
    _, il, ol = v2_req
    n_checks, emptied = 0, 0
    for Wn in (W, 16):
        for s in (0, mid, T - 1):
            x = beam_only_inputs(rng, s, Wn, D, K, H, il, ol, dev)
            for opts, empty in (
                    ({}, 0),
                    ({"config": V2BeamConfig(final_feasible_guard=True)}, 3),
                    ({"allow_skip": True}, 0), ({"test_mode": True}, 3)):
                n0 = check_beam_only(x, dtab, opts, empty)
                emptied += int(n0 == 0 and not opts.get("test_mode"))
                n_checks += 1
    # Other output widths, and F odd at W=3: a (W, F) span and a
    # (W_out, F) output span whose bytes are not a multiple of 16, and at
    # W=3 candidate grids of 30 and 24 (the one-warp selection; v2 with its
    # diagonal re-injection).
    widths = ((W, W - 1, H), (W, W + 5, H), (3, 3, H - 1), (3, W, H - 1))
    for Wn, w_out, F in widths:
        for s in (0, mid):
            x = beam_only_inputs(rng, s, Wn, D, K, F, il, ol, dev)
            for opts, empty in (
                    ({}, 0),
                    ({"config": V2BeamConfig(final_feasible_guard=True)}, 3),
                    ({"allow_skip": True}, 0), ({"test_mode": True}, 3)):
                n0 = check_beam_only(x, dtab, opts, empty, w_out)
                emptied += int(n0 == 0 and not opts.get("test_mode"))
                n_checks += 1
    if emptied != n_checks * 3 // 4:
        raise AssertionError(f"the overrun utterance emptied in {emptied} "
                             f"of {n_checks * 3 // 4} checks")
    log(f"[11 beam-only] v2 #12 and tone #13 at W={W} and W=16 "
        f"(s=0/{mid}/{T - 1}), and (W, W_out, F) in {widths} (s=0/{mid}), "
        f"4 option sets each ({n_checks} checks): every output bit-exact "
        f"against the plain versions; the overrun utterance emptied in "
        f"all {emptied} non-test_mode v2 checks")

    lap("11")
    # ---- 12. tone serve (the tone path) ----
    counters = (beam_fused.fused_class_beam_step, beam_fused.fused_tone_step,
                bk.v2_beam_search_decode, bk.tone_beam_search_decode)
    counts = lambda: tuple(c.launches for c in counters)
    zero_counts()
    agree_best, agree_all, dists = [], [], []
    for i, (toks, il, target) in enumerate(reqs, 1):
        routes = {}
        for name, kw, want in (
                ("fused", {}, (0, T, 0, 0)),
                ("beam-only", {"fuse_model": False}, (0, 0, 0, T)),
                ("plain", {"fuse_model": False, "use_pallas": False},
                 (0, 0, 0, 0))):
            before = counts()
            routes[name] = decode.tone_decode(bf, toks, il, beam_width=W,
                                              **kw)
            torch.cuda.synchronize()
            got = tuple(a - b for a, b in zip(counts(), before))
            if got != want:
                raise AssertionError(f"tone request {i} {name}: launches "
                                     f"(fused v2, fused tone, #12, #13) "
                                     f"{got}, not {want}")
            check_tones(i, routes[name], il, K, W)
        for k in ("tones", "prediction", "beam_branch", "log_prob"):
            if not same_bits(routes["beam-only"][k], routes["plain"][k]):
                raise AssertionError(f"tone request {i}: beam-only and plain "
                                     f"routes differ on {k}")
        f, p = routes["fused"]["tones"], routes["plain"]["tones"]
        agree_best.append((f[:, 0] == p[:, 0]).all(1).float().mean().item())
        agree_all.append((f == p).all(2).all(1).float().mean().item())
        dist = edit_distance.levenshtein_edit_distance(
            routes["fused"]["tones"][:, 0], target, il, il)
        dists.append(float((dist.float() / il.float()).mean()))
    main_counts = counts()
    if main_counts != (0, 3 * T, 0, 3 * T):
        raise AssertionError(f"tone path launches {main_counts}")
    log(f"[12 tone serve] 3 requests B={B} T={T} W={W} bf16: {3 * T} fused "
        f"tone launches (fused route), {3 * T} #13 launches (beam-only "
        f"route), none on the plain route; beam-only tones equal the plain "
        f"route's bit for bit; fused vs plain, share of utterances whose "
        f"best-beam tones agree: "
        + ", ".join(f"{a:.3f}" for a in agree_best)
        + "; all beams: " + ", ".join(f"{a:.3f}" for a in agree_all)
        + "; best-beam edit distance per token to the tone targets "
        "(random weights): " + ", ".join(f"{d:.3f}" for d in dists))
    zero_counts()
    toks, il, ol = v2_req
    with torch.no_grad():
        v2_k = decode.v2_duration_decode(
            bf, toks, il, ol, cfg.duration_table, beam_width=W,
            max_frames=U, fuse_model=False)
        torch.cuda.synchronize()
        v2_counts = counts()
        v2_p = decode.v2_duration_decode(
            bf, toks, il, ol, cfg.duration_table, beam_width=W,
            max_frames=U, fuse_model=False, use_pallas=False)
        torch.cuda.synchronize()
    if v2_counts != (0, 0, T, 0) or counts() != v2_counts:
        raise AssertionError(f"v2 beam-only request launches {v2_counts}, "
                             f"then {counts()}")
    for k in ("durations", "beam_branch", "prediction", "log_prob",
              "beam_emptied"):
        if not same_bits(v2_k[k], v2_p[k]):
            raise AssertionError(f"v2 beam-only request differs from the "
                                 f"plain route on {k}")
    n_empty = int(v2_k["beam_emptied"].sum())
    log(f"[12 tone serve] v2 request B={B} T={T} W={W} bf16 through "
        f"v2_duration_decode(fuse_model=False): {T} #12 launches; "
        f"durations equal the plain route's bit for bit; emptied "
        f"{n_empty}/{B}")

    lap("12")
    # ---- 13. timings ----
    toks, il, target = reqs[0]
    targs = tone_step_inputs(bf, toks, il, mid, rng, dev)
    _, il2, ol2 = v2_req
    x = beam_only_inputs(rng, mid, W, D, K, H, il2, ol2, dev)
    v2_args = (x["h"], x["lp"], x["fin"], x["tot"], dtab, x["t"], x["u"],
               x["il"], x["ol"])
    tone_args = (x["h_tone"], x["lp"], x["fin"], x["t"], x["u"], x["il"])
    fns = {
        "fused_tone_step": (
            lambda: beam_fused.fused_tone_step(*targs),
            lambda: beam_fused.fused_tone_step_reference(*targs)),
        "v2_beam_step": (
            lambda: bk.v2_beam_search_decode(*v2_args, state=x["state"]),
            lambda: bk.v2_beam_search_decode_reference(*v2_args,
                                                       state=x["state"])),
        "tone_beam_step": (
            lambda: bk.tone_beam_search_decode(*tone_args, state=x["state"]),
            lambda: bk.tone_beam_search_decode_reference(*tone_args,
                                                         state=x["state"])),
    }
    times = {}
    log(f"[13 time] {smi}: launch floor (one-element in-place add, CUDA "
        f"graph) {launch_floor_ms() * 1e3:.2f} us per call")
    with torch.no_grad():
        for name, (kfn, pfn) in fns.items():
            times[name] = (graph_ms(kfn), graph_ms(pfn), eager_ms(kfn),
                           eager_ms(pfn), host_us(kfn))
            log(f"[13 time] {smi}: {name} B={B} W={W} (bf16 model), device "
                f"time per step (CUDA graph): kernel {times[name][0]:.4f} "
                f"ms, plain {times[name][1]:.4f} ms; eager per call: kernel "
                f"{times[name][2]:.4f} ms, plain {times[name][3]:.4f} ms; "
                f"host time per kernel call (no synchronize) "
                f"{times[name][4]:.1f} us")
    for route in ({}, {"fuse_model": False},
                  {"fuse_model": False, "use_pallas": False}):
        stamps = []

        def stamp():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        with torch.no_grad():
            decode.tone_decode(bf, toks, il, beam_width=W, **route)  # warm
            stamp()
            out = decode.tone_decode(bf, toks, il, beam_width=W, **route)
            stamp()
            bf.encode(toks, il)
            stamp()
            decode.tone_postprocess(out["prediction"], out["beam_branch"],
                                    il, 0, out["log_prob"])
            stamp()
            edit_distance.levenshtein_edit_distance(out["tones"][:, 0],
                                                    target, il, il)
            stamp()
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        loop = ms[0] - ms[1] - ms[2]
        label = ("fused" if not route else "beam-only" if len(route) == 1
                 else "plain")
        log(f"[13 time] {smi}: one tone request B={B} T={T} W={W} bf16, "
            f"{label} route (host clock): tone_decode {ms[0]:.1f} ms, of "
            f"which encode {ms[1]:.1f} and post-processing {ms[2]:.1f} "
            f"(each timed alone), so the decode loop {loop:.1f}; edit "
            f"distance {ms[3]:.1f} ms; request total {ms[0] + ms[3]:.1f} ms")

    # Bounds: inputs read once and outputs written once; the fused step's
    # GRU (2 matmuls of (W, H) x (H, 3H)) and head in bf16 operations,
    # the beam-only steps' ranks (2 C^2 compares per utterance) in float32.
    with torch.no_grad():
        t_out = beam_fused.fused_tone_step(*targs)
        v_out = bk.v2_beam_search_decode(*v2_args, state=x["state"])
        o_out = bk.tone_beam_search_decode(*tone_args, state=x["state"])
    s30 = targs[0]
    tone_bytes = nbytes(targs[1][s30], targs[2][s30], *targs[3],
                        *targs[4:]) + nbytes(*t_out)
    bounds = {
        "fused_tone_step": bound(tone_bytes, 2 * B * W * H * 3 * H * 2
                                 + 2 * B * W * H * K, BF16_OPS),
        "v2_beam_step": bound(nbytes(*v2_args, x["state"]) + nbytes(*v_out),
                              2 * B * (W * D) ** 2, F32_OPS),
        "tone_beam_step": bound(nbytes(*tone_args, x["state"])
                                + nbytes(*o_out), 2 * B * (W * K) ** 2,
                                F32_OPS),
    }
    for name, bd in bounds.items():
        log(f"[13 time] {smi}: {name} bound {bd[0] * 1e3:.3f} us "
            f"({bd[1]})")
    meta = {
        "fused_tone_step": ("ssnt_tts_tpu_torch/csrc/fused_class_step.cu",
                            "ssnt_tts_tpu/ops/beam_fused.py:486",
                            main_counts[1], worst[torch.float32]),
        "v2_beam_step": ("ssnt_tts_tpu_torch/csrc/beam_step.cu",
                         "ssnt_tts_tpu/ops/beam_pallas.py:1055",
                         v2_counts[2], 0.0),
        "tone_beam_step": ("ssnt_tts_tpu_torch/csrc/beam_step.cu",
                           "ssnt_tts_tpu/ops/beam_pallas.py:1202",
                           main_counts[3], 0.0),
    }
    return [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": n, "max_abs_err": err, "ms": times[name][0],
        "plain_ms": times[name][1], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": None,
    } for name, (src, rep, n, err) in meta.items()]


def v1_carries(model, toks, il, frames, Wn: int, dev):
    """Drive the fused v1 step (the kernel) from the decode's zero carry
    and keep the step's inputs at each frame in `frames`. Returns
    (enc_pack, fused weights, {frame: carry})."""
    from ssnt_tts_tpu_torch.models import stepmath
    from ssnt_tts_tpu_torch.ops import beam_fused

    cfg = model.config
    with torch.no_grad():
        w = model.v1_step_weights()
        fw = beam_fused.prepare_v1_fused_weights(w, model.dtype)
        pack = stepmath.v1_enc_pack(w, model.encode(toks, il),
                                    model.dtype).contiguous()
        z = lambda dt: torch.zeros(B, Wn, dtype=dt, device=dev)
        c = dict(t=z(torch.int32), u=z(torch.int32), lp=z(torch.float32),
                 fin=z(torch.bool),
                 pm=torch.zeros(B, Wn, cfg.mel_dim, device=dev),
                 state=torch.zeros(B, Wn, cfg.decoder_dim, device=dev))
        kept = {}
        for f in range(max(frames) + 1):
            if f in frames:
                kept[f] = {k: v.clone() for k, v in c.items()}
            if f == max(frames):
                break
            o = beam_fused.fused_v1_beam_step(pack, c["t"], c["u"], c["lp"],
                                              c["fin"], il, c["pm"],
                                              c["state"], fw)
            c = dict(t=o.next_t, u=o.next_u, lp=o.log_prob,
                     fin=o.is_finished, pm=o.mel, state=o.state)
    return pack, fw, kept


def v1_perturb(c, il, rng, dev):
    """A carry with ~10% of beams moved onto their last frame, ~5% past
    it (rows clipped to T-1 where t >= T; inactive) and ~10% more
    finished."""
    Bn, Wn = c["t"].shape
    r = rng.random((Bn, Wn))
    il_n = il.cpu().numpy()[:, None]
    t = c["t"].cpu().numpy()
    t = np.where(r < 0.1, il_n - 1, t)
    t = np.where((r >= 0.1) & (r < 0.15),
                 il_n + rng.integers(0, 3, (Bn, Wn)), t)
    out = dict(c)
    out["t"] = torch.tensor(t, dtype=torch.int32, device=dev)
    out["fin"] = c["fin"] | torch.tensor((r >= 0.15) & (r < 0.25),
                                         device=dev)
    return out


def check_v1_step(pack, fw, c, il, tol: float) -> float:
    """Phase 14 for one carry: the fused v1 kernel's h, new_h and mel
    against the plain step (within tol), then the plain selection on the
    kernel's own h, with the reorder and finished-beam keep on the
    kernel's own new_h and mel, against the kernel's outputs, bit for
    bit. Returns the largest error."""
    from ssnt_tts_tpu_torch.ops import beam_fused, beam_v1

    Bn, Wn, H = c["state"].shape
    M = c["pm"].shape[2]
    dev = c["state"].device
    dbg_k = tuple(torch.empty(Bn, Wn, n, device=dev) for n in (2, H, M))
    dbg_r = tuple(torch.empty_like(x) for x in dbg_k)
    args = (pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"], c["state"])
    with torch.no_grad():
        k = beam_fused.fused_v1_beam_step(*args, fw, debug_out=dbg_k)
        beam_fused.fused_v1_beam_step_reference(*args, fw, debug_out=dbg_r)
        torch.cuda.synchronize()
        errs = [(a - b).abs().max().item() for a, b in zip(dbg_k, dbg_r)]
        if not max(errs) <= tol:
            raise AssertionError(f"fused v1 kernel vs plain step: |dh|, "
                                 f"|dnew_h|, |dmel| {errs} > {tol}")
        sel = beam_v1.beam_search_step(dbg_k[0], c["lp"], c["fin"], c["t"],
                                       c["u"], il)
        br = sel[5]
        fin_prev = torch.gather(c["fin"], 1, br.long())
        want = list(sel) + [
            torch.gather(c["t"], 1, br.long()),
            beam_fused.keep_finished_mel(
                beam_fused.reorder_state(dbg_k[2], br),
                beam_fused.reorder_state(c["pm"], br), sel[4], fin_prev),
            beam_fused.reorder_state(dbg_k[1], br)]
        for name, a, b in zip(beam_fused.V1FusedStep._fields, k, want):
            if not same_bits(a, b):
                raise AssertionError(f"fused v1 selection differs on {name} "
                                     f"(W={Wn})")
    return max(errs)


def v1_beam_only_inputs(rng, s: int, Wn: int, il, F: int, dev):
    """h (B, Wn, 2) emit/shift log-probs (dyadic in every other utterance,
    so ties and duplicate candidates occur), beams around step s (some on
    their last frame, past it, at t = -1 or finished; beams 0 and 1
    identical in every third utterance) and F-wide state rows with -0.0
    lanes."""
    il_n = il.cpu().numpy()
    h = torch.log_softmax(torch.tensor(rng.normal(0, 1.5, (B, Wn, 2)),
                                       dtype=torch.float32), -1).numpy()
    h[::2] = -rng.integers(0, 8, (B, Wn, 2))[::2] / 8.0
    t = np.minimum(s, il_n - 1)[:, None] - rng.integers(0, 3, (B, Wn))
    r = rng.random((B, Wn))
    t = np.where(r < 0.1, il_n[:, None] - 1, t)
    t = np.where((r >= 0.1) & (r < 0.15), il_n[:, None] + 1, t)
    t = np.where((r >= 0.15) & (r < 0.18), -1, t)
    u = np.maximum(t, 0) + rng.integers(0, 4, (B, Wn))
    fin = rng.random((B, Wn)) < 0.15
    lp = -rng.integers(0, 40, (B, Wn)) / 8.0
    state = rng.normal(0, 0.5, (B, Wn, F))
    state[:, :, ::7] = -0.0
    if Wn > 1:
        for a in (h, t, u, fin, lp):
            a[::3, 1] = a[::3, 0]
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return dict(h=f32(h), lp=f32(lp), fin=torch.tensor(fin, device=dev),
                t=i32(t), u=i32(u), il=il, state=f32(state))


def check_v1_beam_only(x, w_out=None) -> None:
    """Phase 15 for one input set: #11 and #10 against their plain
    versions at max_beam_width w_out (None: W), every output bit for
    bit."""
    from ssnt_tts_tpu_torch.ops import beam_kernels as bk

    args = (x["h"], x["lp"], x["fin"], x["t"], x["u"], x["il"])
    kw = {"max_beam_width": w_out}
    with torch.no_grad():
        pairs = [
            ("#11", bk.beam_search_step_reorder(*args, x["state"], **kw),
             bk.beam_search_step_reorder_reference(*args, x["state"], **kw)),
            ("#10", bk.beam_search_step_batched(*args, **kw),
             bk.beam_search_step_batched_reference(*args, **kw)),
        ]
        torch.cuda.synchronize()
    for what, k, r in pairs:
        for name, a, b in zip(k._fields, k, r):
            if (a is None) != (b is None) or (
                    a is not None and not same_bits(a, b)):
                raise AssertionError(
                    f"{what} kernel differs on {name} (W={x['h'].shape[1]}, "
                    f"W_out={w_out}, F={x['state'].shape[-1]})")


def check_v1_request(what: str, out, il, Wn: int) -> int:
    """Phase 16 gates for one decode; returns how many best beams
    finished (num_frames < U)."""
    M = SERVE_CFG["mel_dim"]
    mel, al, lp, n = (out["mel"], out["alignment"], out["log_prob"],
                      out["num_frames"])
    if mel.shape != (B, U, M) or not bool(torch.isfinite(mel).all()):
        raise AssertionError(f"{what}: mel {tuple(mel.shape)} or not finite")
    steps = al[:, 1:] - al[:, :-1]
    if not bool(((steps == 0) | (steps == 1)).all()) or not bool(
            ((al >= 0) & (al < il[:, None])).all()):
        raise AssertionError(f"{what}: alignment steps not 0/1 or outside "
                             f"the utterance")
    if not bool((n <= U).all()) or out["beam_branch"].shape != (B, U, Wn):
        raise AssertionError(f"{what}: num_frames > {U} or branch shape")
    if not bool((lp[:, 0] == lp.max(dim=1).values).all()):
        raise AssertionError(f"{what}: slot 0 is not the best beam")
    return int((n < U).sum())


def v1_phases(seed: int, dev, smi: str, models) -> list:
    """Phases 14-17; returns the v1 kernels' entries of the JSON line."""
    from ssnt_tts_tpu_torch.bench_fused import host_us
    from ssnt_tts_tpu_torch.ops import beam_fused
    from ssnt_tts_tpu_torch.ops import beam_kernels as bk
    from ssnt_tts_tpu_torch.parallel import decode

    rng = np.random.default_rng(seed + 6)
    bf = models[torch.bfloat16]
    cfg = bf.config
    H, M = cfg.decoder_dim, cfg.mel_dim
    F = H + 2 * M + 2
    reqs = [make_request(rng, cfg.vocab_size, dev)[:2] for _ in range(3)]
    toks, il = reqs[0]

    # ---- 14. fused v1 step against the plain step ----
    worst, n_checks = {}, 0
    carry100 = None
    for dt, model in models.items():
        errs = []
        for Wn, frames in ((W, (0, 100, U - 1)), (1, (0, 100)),
                           (16, (0, 100))):
            pack, fw, kept = v1_carries(model, toks, il, frames, Wn, dev)
            for f, c in kept.items():
                errs.append(check_v1_step(pack, fw, c, il, TOL[dt]))
                if f > 0:
                    errs.append(check_v1_step(pack, fw,
                                              v1_perturb(c, il, rng, dev),
                                              il, TOL[dt]))
            if dt == torch.bfloat16 and Wn == W:
                carry100 = (pack, fw, kept[100])
        worst[dt] = max(errs)
        n_checks += len(errs)
        log(f"[14 v1 step] {str(dt)[6:]}: {len(errs)} steps (W={W} at "
            f"frames 0/100/{U - 1} of a request's carry, W=1 and W=16 at "
            f"0/100, each later frame also with beams moved onto and past "
            f"their last frame and more finished), selection, reorder and "
            f"mel keep bit-exact; max |dh|, |dnew_h|, |dmel| "
            f"{worst[dt]:.3e} (tol {TOL[dt]})")

    lap("14")
    # ---- 15. beam-only v1 kernels against their plain versions ----
    n15 = 0
    for Wn in (1, W, 16):
        for s in (0, 40, T - 1):
            check_v1_beam_only(v1_beam_only_inputs(rng, s, Wn, il, F, dev))
            n15 += 1
    # Other output widths, and F odd at W=3 (spans of 1251 floats).
    widths = ((W, W - 1, F), (W, W + 5, F), (3, 3, F - 1), (3, W, F - 1))
    for Wn, w_out, Fn in widths:
        for s in (0, 40, T - 1):
            check_v1_beam_only(v1_beam_only_inputs(rng, s, Wn, il, Fn, dev),
                               w_out)
            n15 += 1
    log(f"[15 v1 beam-only] #11 (F={F} rows) and #10 (no rows) at W=1, "
        f"{W}, 16, and (W, W_out, F) in {widths}, s=0/40/{T - 1} on ragged "
        f"lengths ({n15} checks each): every output bit-exact against the "
        f"plain versions")

    lap("15")
    # ---- 16. v1 serve (the v1 path) ----
    counters = (beam_fused.fused_v1_beam_step, bk.beam_search_step_reorder,
                bk.beam_search_step_batched)
    counts = lambda: tuple(c.launches for c in counters)
    zero_counts()
    agree, finished = [], []
    routes_kw = (("fused", {}), ("beam-only", {"fuse_model": False}),
                 ("plain", {"fuse_model": False, "use_pallas": False}))

    def run(i, fn, Wn, name, kw, want):
        before = counts()
        out = fn(bf, *reqs[i], max_frames=U, **kw)
        torch.cuda.synchronize()
        got = tuple(a - b for a, b in zip(counts(), before))
        if got != want:
            raise AssertionError(f"v1 request {i + 1} {name}: launches "
                                 f"(#15, #11, #10) {got}, not {want}")
        return out, check_v1_request(f"v1 request {i + 1} {name}", out,
                                     reqs[i][1], Wn)

    keys = ("alignment", "beam_branch", "t_history", "prediction",
            "num_frames", "log_prob", "mel")
    with torch.no_grad():
        for i in range(3):
            outs = {}
            for name, kw in routes_kw:
                want = {"fused": (U, 0, 0), "beam-only": (0, U, 0),
                        "plain": (0, 0, 0)}[name]
                outs[name], nf = run(
                    i, lambda *a, **k: decode.beam_decode(*a, beam_width=W,
                                                          **k),
                    W, name, kw, want)
                if name == "fused":
                    finished.append(nf)
            for k in keys:
                if not same_bits(outs["beam-only"][k], outs["plain"][k]):
                    raise AssertionError(f"v1 request {i + 1}: beam-only and "
                                         f"plain routes differ on {k}")
            agree.append((outs["fused"]["alignment"]
                          == outs["plain"]["alignment"]).all(1)
                         .float().mean().item())
        greedy = {}
        for name, kw in routes_kw:
            want = {"fused": (U, 0, 0), "beam-only": (0, U, 0),
                    "plain": (0, 0, 0)}[name]
            greedy[name], nf = run(0, decode.greedy_decode, 1,
                                   f"greedy {name}", kw, want)
            if name == "fused":
                g_fin = nf
        for k in keys:
            if not same_bits(greedy["beam-only"][k], greedy["plain"][k]):
                raise AssertionError(f"greedy: beam-only and plain routes "
                                     f"differ on {k}")
    main_counts = counts()
    if main_counts != (4 * U, 4 * U, 0):
        raise AssertionError(f"v1 path launches {main_counts}")
    g_agree = (greedy["fused"]["alignment"] == greedy["plain"]["alignment"]
               ).all(1).float().mean().item()
    log(f"[16 v1 serve] 3 requests B={B} T={T} max_frames={U} W={W} bf16 "
        f"through encode -> beam_decode: {U} #15 launches per request on "
        f"the fused route, {U} #11 per request on the beam-only route, none "
        f"on the plain route; beam-only outputs equal the plain route's bit "
        f"for bit; greedy_decode (W=1): {U} #15 (fused), {U} #11 "
        f"(beam-only), beam-only equal to plain; #10 has no decode caller. Gates passed (alignment "
        f"steps 0/1 inside each utterance, num_frames <= {U}, mel finite, "
        f"slot 0 best). Not gated (random weights): fused vs plain, share "
        f"of utterances whose alignment agrees: "
        + ", ".join(f"{a:.3f}" for a in agree)
        + f" (greedy {g_agree:.3f}); best beams finished before frame {U}: "
        + ", ".join(f"{n}/{B}" for n in finished)
        + f" (greedy {g_fin}/{B})")

    lap("16")
    # ---- 17. timings ----
    pack, fw, c = carry100
    fargs = (pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"],
             c["state"])
    x = v1_beam_only_inputs(rng, 40, W, il, F, dev)
    bargs = (x["h"], x["lp"], x["fin"], x["t"], x["u"], x["il"])
    fns = {
        "fused_v1_step": (
            lambda: beam_fused.fused_v1_beam_step(*fargs, fw),
            lambda: beam_fused.fused_v1_beam_step_reference(*fargs, fw)),
        "beam_v1_step_reorder": (
            lambda: bk.beam_search_step_reorder(*bargs, x["state"]),
            lambda: bk.beam_search_step_reorder_reference(*bargs,
                                                          x["state"])),
        "beam_v1_step": (
            lambda: bk.beam_search_step_batched(*bargs),
            lambda: bk.beam_search_step_batched_reference(*bargs)),
    }
    times = {}
    log(f"[17 time] {smi}: launch floor (one-element in-place add, CUDA "
        f"graph) {launch_floor_ms() * 1e3:.2f} us per call")
    with torch.no_grad():
        for name, (kfn, pfn) in fns.items():
            times[name] = (graph_ms(kfn), graph_ms(pfn), eager_ms(kfn),
                           eager_ms(pfn), host_us(kfn))
            alone = (" (no decode caller: a standalone check at the "
                     "beam-only route's shape)" if name == "beam_v1_step"
                     else "")
            log(f"[17 time] {smi}: {name}{alone} B={B} W={W} (bf16 "
                f"model), device time per step (CUDA graph): kernel {times[name][0]:.4f} "
                f"ms, plain {times[name][1]:.4f} ms; eager per call: kernel "
                f"{times[name][2]:.4f} ms, plain {times[name][3]:.4f} ms; "
                f"host time per kernel call (no synchronize) "
                f"{times[name][4]:.1f} us")
        for Wn in (1, 16):
            pk, fwn, kept = v1_carries(bf, toks, il, (100,), Wn, dev)
            cn = kept[100]
            fn = (lambda a=(pk, cn["t"], cn["u"], cn["lp"], cn["fin"], il,
                            cn["pm"], cn["state"], fwn):
                  beam_fused.fused_v1_beam_step(*a))
            log(f"[17 time] {smi}: fused_v1_step B={B} W={Wn} (bf16 model), "
                f"device time per step (CUDA graph): kernel "
                f"{graph_ms(fn):.4f} ms")
    for label, kw in routes_kw:
        stamps = []

        def stamp():
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        with torch.no_grad():
            decode.beam_decode(bf, toks, il, max_frames=U, beam_width=W,
                               **kw)  # warm
            stamp()
            out = decode.beam_decode(bf, toks, il, max_frames=U,
                                     beam_width=W, **kw)
            stamp()
            bf.encode(toks, il)
            stamp()
            decode.v1_postprocess(
                out["beam_branch"], out["t_history"],
                torch.empty(B, U, W, M, device=dev), out["prediction"],
                out["log_prob"], out["num_frames"][:, None])
            stamp()
        ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        loop = ms[0] - ms[1] - ms[2]
        audio = B * U * 0.0125 / (ms[0] / 1e3)
        log(f"[17 time] {smi}: one v1 request B={B} T={T} max_frames={U} "
            f"W={W} bf16, {label} route (host clock): beam_decode "
            f"{ms[0]:.1f} ms, of which encode {ms[1]:.1f} and backtrace + "
            f"mel gather {ms[2]:.1f} (each timed alone), so the frame loop "
            f"{loop:.1f}; {audio:.1f} audio-seconds per second "
            f"(B*{U}*0.0125 s / latency)")

    # Bounds: inputs read once and outputs written once (for #15 the
    # gathered enc_pack rows, not the whole pack; the weights once); the
    # fused step's dots (prenet, GRU, joints: ~526k MAC per beam) in bf16
    # operations, the beam-only steps' ranks (2 C^2 compares per
    # utterance) in float32.
    with torch.no_grad():
        f_out = beam_fused.fused_v1_beam_step(*fargs, fw)
        r_out = bk.beam_search_step_reorder(*bargs, x["state"])
        b_out = bk.beam_search_step_batched(*bargs)
    R = cfg.joint_rank
    P = pack.shape[2]
    macs = M * H + H * H + 2 * H * 3 * H + H * R + R * 2 * R + H * M + 2 * H
    f_bytes = (nbytes(*fw) + B * W * P * 4 + nbytes(*fargs[1:])
               + nbytes(*f_out))
    C = 2 * W
    bounds = {
        "fused_v1_step": bound(f_bytes, 2 * B * W * macs, BF16_OPS),
        "beam_v1_step_reorder": bound(
            nbytes(*bargs, x["state"]) + nbytes(*r_out), 2 * B * C * C,
            F32_OPS),
        "beam_v1_step": bound(nbytes(*bargs) + nbytes(*b_out[:6]),
                              2 * B * C * C, F32_OPS),
    }
    for name, bd in bounds.items():
        log(f"[17 time] {smi}: {name} bound {bd[0] * 1e3:.3f} us "
            f"({bd[1]})")
    log(f"[17 time] fused_v1_step moves {f_bytes / 1e6:.3f} MB and does "
        f"{2 * B * W * macs / 1e9:.3f} GFLOP per frame")
    meta = {
        "fused_v1_step": ("ssnt_tts_tpu_torch/csrc/fused_v1_step.cu",
                          "ssnt_tts_tpu/ops/beam_fused.py:695",
                          main_counts[0], worst[torch.float32]),
        "beam_v1_step_reorder": ("ssnt_tts_tpu_torch/csrc/beam_step.cu",
                                 "ssnt_tts_tpu/ops/beam_pallas.py:728",
                                 main_counts[1], 0.0),
        "beam_v1_step": ("ssnt_tts_tpu_torch/csrc/beam_step.cu",
                         "ssnt_tts_tpu/ops/beam_pallas.py:674",
                         main_counts[2], 0.0),
    }
    return [{
        "name": name, "route": "cuda", "source": src, "replaces": rep,
        "launches": n, "max_abs_err": err, "ms": times[name][0],
        "plain_ms": times[name][1], "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1], "library_ms": None,
    } for name, (src, rep, n, err) in meta.items()]


# ---------------------------------------------------------------------------
# Phase 25: distribution (the sharded train step, the T-sharded lattice ring
# and the decodes over data shards)
# ---------------------------------------------------------------------------

# Sharded step against one process on the same global batch: JAX's own
# tolerances (tests/test_parallel.py). Its parameter tolerance is met after
# a step at learning rate 0 (JAX's test takes one); after a step at lr > 0
# the one-process step misses it against itself with its batch split in
# two (Adam turns near-zero gradients' rounding into steps of up to ~lr),
# so phase 25b gates parameters bit for bit against that split step and
# reports the count outside this tolerance.
DIST_LOSS_RTOL, DIST_PARAM_RTOL, DIST_PARAM_ATOL = 2e-4, 2e-3, 2e-5
# Every spawned group's deadline (its collectives time out after it too).
DIST_TIMEOUT_S = 300
# Phase 25b's sharded steps on each mesh (cut from 3 for time); its
# decodes follow 3 (with 2, every utterance of the plain route empties).
DIST_STEPS = 2


def dist_batches(cfg, seed: int, n: int) -> list:
    """n synthetic global batches of B (ragged lengths), rows sorted by
    input length, longest first: the first data rank holds more tokens
    than the second."""
    from ssnt_tts_tpu_torch import data as data_lib

    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed + 5)
    out = []
    for _ in range(n):
        b = {k: v for k, v in ds.batch(B).items() if k != "alignment"}
        order = np.argsort(-b["input_length"], kind="stable")
        out.append({k: v[order] for k, v in b.items()})
    return out


def params_outside(got: dict, want: dict) -> tuple:
    """(entries outside DIST_PARAM_RTOL / ATOL, entries, largest
    |difference|) of two parameter dicts."""
    bad = n = 0
    worst = 0.0
    for k, w in want.items():
        g = torch.as_tensor(got[k]).float()
        w = w.detach().cpu().float()
        d = (g - w).abs()
        bad += int((d > DIST_PARAM_ATOL + DIST_PARAM_RTOL * w.abs()).sum())
        n += w.numel()
        worst = max(worst, float(d.max()))
    return bad, n, worst


def distribution_phase(seed: int, dev, smi: str) -> None:
    """Phase 25: (a) NCCL, one rank, in this process: two sharded steps
    (mesh 1x1) against three train_steps from the same state, bit for bit;
    run_training with checkpoints over the NCCL mesh, then resumed; and
    run_training resumed from a checkpoint that four ranks saved from
    split parameter storage (2x2); (b) four ranks (gloo on the one card,
    each on cuda:0; NCCL one rank a card when there are four cards), at
    the flagship ModelConfig(): the gloo operations on the tensors the
    port hands them, DIST_STEPS sharded steps on a 2x2 and on a 1x4 mesh
    (the parameters split over the model axis), each with the T-sharded ring
    and without, against the one-process step with whole parameters, the
    bytes each rank stores, the ring alone against the plain lattice loss,
    the four decodes over data shards after sharded training against
    one-process decodes, every rank's launches."""
    import shutil
    from pathlib import Path

    import torch.distributed as dist

    from ssnt_tts_tpu_torch import dryrun
    from ssnt_tts_tpu_torch.ops import lattice as lattice_ops
    from ssnt_tts_tpu_torch.ops import lattice_sharded
    from ssnt_tts_tpu_torch.parallel import decode as decode_lib
    from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
    from ssnt_tts_tpu_torch.parallel import multihost
    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.train_loop import run_training
    from ssnt_tts_tpu_torch.utils import checkpoint as ckpt_lib
    from ssnt_tts_tpu_torch.utils.config import (
        MeshConfig, ModelConfig, TrainConfig)

    from ssnt_tts_tpu_torch import data as data_lib

    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "dist"
    work.mkdir(parents=True, exist_ok=True)
    cfg = ModelConfig(**SERVE_CFG)
    tcfg = TrainConfig(warmup_steps=2, batch_size=B)
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 4 else "gloo"

    # run_training over a 2x2 mesh (parameters split over "model") to step
    # 1: the checkpoint (whole tensors) that 25a resumes on one rank.
    layout = work / "layout_ckpt"
    shutil.rmtree(layout, ignore_errors=True)
    t0 = time.perf_counter()
    dryrun.launch("run_training", {
        "mesh": (2, 2), "cfg": cfg, "tcfg": tcfg, "steps": 1, "seed": seed,
        "checkpoint_dir": str(layout)}, 4, work / "layout", backend=backend,
        timeout=DIST_TIMEOUT_S)
    t_layout = time.perf_counter() - t0
    if ckpt_lib.latest_step(str(layout)) != 1:
        raise AssertionError("25a: the 2x2 run_training saved no step 1")
    # its first batch, as run_training draws it (the init draw first)
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        max_input_length=tcfg.max_input_length,
        max_output_length=tcfg.max_output_length,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed)
    ds.batch(B)
    first = to_device(ds.batch(B), dev)
    txl = train_lib.make_optimizer(tcfg)
    one = train_lib.init_train_state(cfg, tcfg, seed=seed, device=dev)
    dryrun.split_step(txl, one, first)
    n_layout = same_record(
        state_record(ckpt_lib.restore(str(layout), train_lib.init_train_state(
            cfg, tcfg, seed=seed + 1, device=dev))), state_record(one),
        "25a: step 1 saved from 2x2 split storage against the one-process "
        "step over the two row halves")
    train_lib.train_step(txl, one, first)  # the resumed run replays it

    batches = dist_batches(cfg, seed, 2)
    tokens = [int(b["input_length"][:B // 2].sum()) for b in batches]
    log(f"[25 dist] global batches B={B} T={T} U={U} bf16, rows sorted by "
        f"input length: data rank 0 holds {tokens} of "
        f"{[int(b['input_length'].sum()) for b in batches]} tokens")

    # ---- (a) NCCL, one rank, in this process ----
    store = work / "nccl_rendezvous"
    store.unlink(missing_ok=True)
    multihost.initialize(f"file://{store}", 1, 0, backend="nccl",
                         timeout_s=DIST_TIMEOUT_S)
    try:
        mesh = mesh_lib.make_mesh(MeshConfig(1, 1), device=dev)
        sharded = train_lib.init_train_state(cfg, tcfg, seed=seed,
                                             device=dev)
        plain = train_lib.init_train_state(cfg, tcfg, seed=seed, device=dev)
        tx = train_lib.make_optimizer(tcfg)
        step_fn, sharded = train_lib.make_sharded_train_step(tx, mesh,
                                                             sharded)
        zero_counts()
        ms = {"sharded": [], "train_step": []}
        for b in batches:
            batch = to_device(b, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m_s = step_fn(sharded, batch)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, m_p = train_lib.train_step(tx, plain, batch)
            torch.cuda.synchronize()
            ms["sharded"].append((t1 - t0) * 1e3)
            ms["train_step"].append((time.perf_counter() - t1) * 1e3)
            if {k: float(v) for k, v in m_s.items()} != {
                    k: float(v) for k, v in m_p.items()}:
                raise AssertionError(f"25a: metrics differ: {m_s} vs {m_p}")
        launches = lattice_counts()
        for (k, a), b in zip(sharded.model.state_dict().items(),
                             plain.model.state_dict().values()):
            if not torch.equal(a, b):
                raise AssertionError(f"25a: parameter {k} differs")
        # run_training over the NCCL mesh with checkpoints, then resumed:
        # the primary's saves and the end-of-run barrier on NCCL; then
        # resumed from the 2x2 layout's step 1.
        ckpt = work / "nccl_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        run_secs = []
        for n, where in ((1, ckpt), (2, ckpt), (2, layout)):
            t0 = time.perf_counter()
            run_training(n, cfg, tcfg, seed=seed, log_every=1,
                         metrics_path=str(work / "nccl_run.jsonl"),
                         mesh_config=MeshConfig(1, 1),
                         checkpoint_dir=str(where))
            torch.cuda.synchronize()
            run_secs.append(time.perf_counter() - t0)
            if ckpt_lib.latest_step(str(where)) != n:
                raise AssertionError(f"25a: run_training to step {n} over "
                                     f"NCCL: latest checkpoint "
                                     f"{ckpt_lib.latest_step(str(where))}")
        same_record(state_record(ckpt_lib.restore(
            str(layout), train_lib.init_train_state(cfg, tcfg, seed=seed + 1,
                                                    device=dev))),
                    state_record(one), "25a: step 2 resumed on one rank "
                    "from the 2x2 checkpoint against train_step from its "
                    "step 1")
    finally:
        dist.destroy_process_group()
    if launches != (2 * len(batches), 0, 0, 0, 0, 0, 0, 0):
        raise AssertionError(f"25a: launches {LAUNCH_NAMES} {launches}")
    log(f"[25a nccl] backend {mesh.backend}, mesh 1x1, {len(batches)} "
        f"sharded steps vs {len(batches)} train_steps from the same state: "
        f"losses and every parameter bit for bit (loss "
        f"{float(m_s['loss']):.6f}); "
        f"{step_fn.all_reduces // len(batches)} all_reduces a step (the "
        f"normalizers, "
        f"then gradients + metrics in one flat buffer); launches "
        f"{LAUNCH_NAMES} {launches}")
    log(f"[25a nccl] run_training over the NCCL mesh with checkpoint_dir: "
        f"step 1 saved in {run_secs[0]:.1f}s, resumed to step 2 and saved "
        f"in {run_secs[1]:.1f}s (host clock, the end-of-run barrier on "
        f"NCCL); run_training over a 2x2 mesh ({backend}, 4 ranks, "
        f"parameters split over model) to step 1 in {t_layout:.1f}s with "
        f"start-up: its checkpoint bit for bit the one-process step over "
        f"the two row halves ({n_layout} tensors), resumed here on the 1x1 "
        f"NCCL mesh to step 2 in {run_secs[2]:.1f}s, bit for bit train_step "
        f"from that step 1 on the replayed batch")
    log(f"[25a time] {smi}: step ms (host clock), sharded "
        + " ".join(f"{x:.1f}" for x in ms["sharded"]) + ", train_step "
        + " ".join(f"{x:.1f}" for x in ms["train_step"]))

    lap("25a")
    # ---- (b) four ranks, at the flagship width ----
    cfg = ModelConfig()
    batches = dist_batches(cfg, seed, 3)
    log(f"[25b dist] {cards} card(s): four ranks on {backend}"
        + (", one rank a card" if backend == "nccl" else
           ", every rank on cuda:0")
        + f"; ModelConfig() (vocab {cfg.vocab_size}, encoder "
          f"{cfg.encoder_dim} x {cfg.encoder_layers} x {cfg.encoder_heads} "
          f"heads, {cfg.dtype}) at global B={B} T={T} U={U}")
    if backend == "gloo":
        table = dryrun.launch("probe", {"mesh": (2, 1)}, 2, work / "probe",
                              backend="gloo", timeout=DIST_TIMEOUT_S)[0]
        log(f"[25b probe] gloo, 2 ranks on cuda:0: all_reduce "
            f"{table['all_reduce']}, all_gather {table['all_gather']}, "
            f"broadcast {table['broadcast']} on CUDA tensors; send/recv "
            f"{table['send_recv']} on {table['send_recv_tensors']} tensors:"
            f" the ring's hops go through host memory explicitly "
            f"(Mesh.stage_p2p; gloo's send of a CUDA tensor aborts the "
            f"process); the compute stays on the card")
    lap("25b probe")
    # One-process references with whole parameters on the same global
    # batches: train_step on the whole batch, and the same step over the
    # data ranks' row blocks (gradients summed in one process: a data
    # group's sum), with the lattice on the plain route or on a one-rank
    # ring.
    # Each keeps (metrics a step, parameters, state) after the sharded
    # arms' steps; the halves' state then takes the decode's last step.
    steps = batches[:DIST_STEPS]
    ref = {}
    for name, parts, ring in (("whole", 1, False), ("whole_ring", 1, True),
                              ("halves", 2, False),
                              ("halves_ring", 2, True)):
        st = train_lib.init_train_state(cfg, tcfg, seed=seed, device=dev)
        txr = train_lib.make_optimizer(tcfg)
        ms = []
        for i, b in enumerate(batches if name == "halves" else steps):
            if i == len(steps):
                ref[name] = (ms, {k: v.detach().clone() for k, v in
                                  st.model.state_dict().items()}, st)
            batch = to_device(b, dev)
            m = (train_lib.train_step(txr, st, batch)[1] if name == "whole"
                 else dryrun.split_step(txr, st, batch, ring=ring,
                                        parts=parts)[1])
            if i < len(steps):
                ms.append({k: float(v) for k, v in m.items()})
        if name != "halves":
            ref[name] = (ms, st.model.state_dict(), st)

    # (mesh, T-shard on, reference): a 2x2 rank holds its data half, a 1x4
    # rank the whole batch.
    layouts = [((2, 2), True, "halves_ring"), ((2, 2), False, "halves"),
               ((1, 4), True, "whole_ring"), ((1, 4), False, "whole")]
    runs = [{"cfg": dataclasses.replace(
        cfg, lattice_tshard_min_cells=0 if ring else None), "tcfg": tcfg,
        "seed": seed, "batches": steps, "mesh": mesh}
        for mesh, ring, _ in layouts]
    lap("25b one-process references")
    t0 = time.perf_counter()
    ranks = dryrun.launch("steps", {"mesh": (2, 2), "runs": runs,
                                    "ring": (U, B // 2, T)}, 4,
                          work / "steps", backend=backend,
                          timeout=DIST_TIMEOUT_S)
    secs = time.perf_counter() - t0
    K = lattice_sharded._pick_block(U)
    whole_loss = [m["loss"] for m in ref["whole"][0]]
    whole_bytes = sum(p.numel() * p.element_size()
                      for p in ref["whole"][2].model.parameters())
    stored = {}
    for (mesh, ring, rname), run_i in zip(layouts, range(len(layouts))):
        d, m = mesh
        owners = mesh_lib.param_sharding(m, cfg)
        want_bytes = sum(
            p.numel() * p.element_size() // (1 if owners[n] is None else m)
            for n, p in ref["whole"][2].model.named_parameters())
        stored[mesh] = want_bytes
        hops = lattice_sharded.hops_per_walk(U, m, K)
        split = ref[rname]
        want_params = split[1]
        for r in ranks:
            run = r["runs"][run_i]
            what = (f"25b rank {r['rank']} mesh {d}x{m} T-shard "
                    f"{'on' if ring else 'off'}")
            losses = [s["metrics"]["loss"] for s in run["steps"]]
            if not np.allclose(losses, whole_loss, rtol=DIST_LOSS_RTOL,
                               atol=0):
                raise AssertionError(f"{what}: losses {losses} vs one "
                                     f"process {whole_loss}")
            norms = [s["metrics"]["grad_norm"] for s in run["steps"]]
            if norms != [x["grad_norm"] for x in split[0]] or not all(
                    torch.equal(torch.as_tensor(run["params"][k]), v.cpu())
                    for k, v in want_params.items()):
                raise AssertionError(
                    f"{what}: grad_norm {norms} or parameters not bit for "
                    f"bit the one-process step ({rname}) with whole "
                    f"parameters")
            if run["stored_bytes"] != want_bytes or run["mesh"] != {
                    "data": d, "model": m}:
                raise AssertionError(f"{what}: stores {run['stored_bytes']}"
                                     f" bytes, not {want_bytes}")
            run["outside"] = params_outside(run["params"], ref["whole"][1])
            for s_ in run["steps"]:
                want_ring = {"hops_forward": hops, "hops_backward": hops,
                             "all_reduce": 1, "all_gather": 1} if ring else {
                    "hops_forward": 0, "hops_backward": 0, "all_reduce": 0,
                    "all_gather": 0}
                bidir = s_["launches"]["lattice_bidir"]
                others = sum(v for k, v in s_["launches"].items()
                             if k != "lattice_bidir")
                if (s_["ring"] != want_ring or s_["all_reduces"] != 2
                        or s_["all_gathers"] != 1
                        or bidir != (0 if ring else 1) or others):
                    raise AssertionError(
                        f"{what}: ring {s_['ring']}, all_reduces "
                        f"{s_['all_reduces']}, all_gathers "
                        f"{s_['all_gathers']}, launches {s_['launches']}")
    r0 = ranks[0]
    for r in ranks[1:]:
        for run, run0 in zip(r["runs"], r0["runs"]):
            if not all(np.array_equal(run["params"][k], v)
                       for k, v in run0["params"].items()):
                raise AssertionError(f"25b: rank {r['rank']}'s parameters "
                                     f"differ from rank 0's")
        if not all(np.array_equal(a, b) for a, b in zip(
                r["ring"]["grads"], r0["ring"]["grads"])):
            raise AssertionError(f"25b: rank {r['rank']}'s ring gradients "
                                 f"differ from rank 0's")
    floor = params_outside({k: v.cpu() for k, v in
                            ref["halves"][1].items()}, ref["whole"][1])
    fmt = lambda xs: " ".join(f"{x:.6f}" for x in xs)
    losses = [[s_["metrics"]["loss"] for s_ in run["steps"]]
              for run in r0["runs"]]
    log(f"[25b steps] {backend}, 4 ranks ({secs:.1f}s with start-up), "
        f"parameters split over the model axis (mesh.param_sharding); a "
        f"rank stores {stored[(2, 2)]} bytes of parameters at 2x2 "
        f"(model 2) and {stored[(1, 4)]} at 1x4 (model 4) of "
        f"{whole_bytes} whole (asserted for every rank); Adam's mu and nu "
        f"whole; per step 1 all_gather over the model group and 2 "
        f"all_reduces over the data group (asserted). {len(steps)} steps "
        f"on each "
        f"mesh with lattice_tshard_min_cells=0 (T={T} over the model "
        f"axis's shards, K={K}, "
        f"{lattice_sharded.hops_per_walk(U, 2, K)} / "
        f"{lattice_sharded.hops_per_walk(U, 4, K)} hops a walk at 2 / 4 "
        f"shards, one group sum, one all_gather; no lattice kernel launch) "
        f"and with it off (one lattice_bidir launch a step at local B="
        f"{B // 2} / {B}): parameters and grad_norm bit for bit the "
        f"one-process step with whole parameters over the same data rows "
        f"(2x2: the two row halves; 1x4: train_step, and the whole batch "
        f"on a one-rank ring when the ring is on); losses against "
        f"train_step (rtol {DIST_LOSS_RTOL}): 2x2 on {fmt(losses[0])}, off "
        f"{fmt(losses[1])}, 1x4 on {fmt(losses[2])}, off {fmt(losses[3])}, "
        f"one process {fmt(whole_loss)}; every rank's parameters equal; "
        f"ring send/recv through host memory: {r0['stage_p2p']}")
    log(f"[25b steps] parameters after the steps outside rtol "
        f"{DIST_PARAM_RTOL} / atol {DIST_PARAM_ATOL} of train_step on the "
        f"whole batch (not gated; JAX's tolerance, whose test takes one "
        f"step at learning rate 0): 2x2 ring on / off "
        f"{r0['runs'][0]['outside'][0]} / {r0['runs'][1]['outside'][0]}, "
        f"1x4 {r0['runs'][2]['outside'][0]} / {r0['runs'][3]['outside'][0]}"
        f", the one-process step over the two row halves {floor[0]} of "
        f"{floor[1]} (largest |d| {r0['runs'][1]['outside'][2]:.2e} / "
        f"{floor[2]:.2e}): Adam turns the rounding of near-zero gradients "
        f"into steps of up to ~lr")
    xs, il, ol = dryrun.ring_inputs(U, B // 2, T, dev)
    leaves = [x.clone().requires_grad_() for x in xs]
    want = lattice_ops.ssnt_loss(*leaves, il, ol, layout="ubt")
    want.sum().backward()
    want = want.detach()
    got = r0["ring"]
    got = [torch.as_tensor(x).to(dev) for x in [got["loss"]] + got["grads"]]
    if not all(torch.equal(a, b) for a, b in zip(
            got, [want] + [x.grad for x in leaves])):
        raise AssertionError("25b ring: loss or gradients not bit for bit "
                             "ops/lattice.ssnt_loss's")
    log(f"[25b ring] ssnt_loss_tsharded fwd+bwd at U={U} B={B // 2} T={T} "
        f"over 2 shards, ragged lengths: loss and gradients bit for bit "
        f"ops/lattice.ssnt_loss's (plain, one process; the ring runs its "
        f"column and posterior code on each slice); every rank's whole-T "
        f"gradients equal")
    step_ms = lambda run: " ".join(f"{s_['ms']:.1f}" for s_ in run["steps"])
    for r in ranks:
        log(f"[25b time] {smi}: rank {r['rank']} (data {r['data']}, model "
            f"{r['model']} of the 2x2 mesh) step ms (host clock) 2x2 T-shard"
            f" on {step_ms(r['runs'][0])}, off {step_ms(r['runs'][1])}; 1x4 "
            f"on {step_ms(r['runs'][2])}, off {step_ms(r['runs'][3])}; ring "
            f"fwd+bwd alone U={U} B={B // 2} T={T} over 2 shards "
            f"{r['ring']['ms']:.1f} ms "
            f"({2 * lattice_sharded.hops_per_walk(U, 2, K)} hops)")

    lap("25b steps")
    # The four decodes over data shards, after three sharded steps (2x2,
    # T-shard off; the one-process halves' state took the same three), on
    # the model made whole again.
    rng = np.random.default_rng(seed + 6)
    toks, il, ol = (x.cpu().numpy() for x in make_request(
        rng, cfg.vocab_size, dev))
    job = {"mesh": (2, 2), "cfg": cfg, "seed": seed,
           "batch": {"tokens": toks, "input_length": il,
                     "output_length": ol},
           "beam_width": W, "max_frames": U,
           "train": {"tcfg": tcfg, "batches": batches}}
    t0 = time.perf_counter()
    dec = dryrun.launch("decode", job, 4, work / "decode", backend=backend,
                        timeout=DIST_TIMEOUT_S)
    secs = time.perf_counter() - t0
    model = ref["halves"][2].model.eval()
    req = tuple(torch.as_tensor(x, device=dev) for x in (toks, il, ol))
    halves_rows = (slice(0, B // 2), slice(B // 2, B))

    def decodes(model_, toks_, il_, ol_, names=None) -> dict:
        routes = dryrun.decode_routes(model_, toks_, il_, ol_, W, U)
        with torch.no_grad():
            return {k: f() for k, f in routes.items()
                    if names is None or k in names}

    want = decodes(model, *req)
    halves = [decodes(model, *(x[rows] for x in req))
              for rows in halves_rows]
    expect = {"v2": ("fused_class_beam_step", T), "v2_plain": (None, 0),
              "tone": ("fused_tone_step", T),
              "v1": ("fused_v1_beam_step", U)}
    for r in dec:
        for name, (kern, n) in expect.items():
            got = r[name + "_launches"]
            if (kern and got[kern] != n) or sum(got.values()) != n:
                raise AssertionError(f"25b decode rank: {name} launches "
                                     f"{got}")
    parts = dec[::2]  # the model-axis 0 rank of each data rank
    if [p["rows"] for p in parts] != [slice(0, B // 2), slice(B // 2, B)]:
        raise AssertionError("25b decode: rows")
    gathered = {name: {k: torch.as_tensor(np.concatenate(
        [p[name][k] for p in parts])).to(dev) for k in want[name]}
        for name in want}
    for name in want:
        for k in want[name]:
            one = torch.cat([h[name][k] for h in halves])
            if not torch.equal(gathered[name][k], one):
                raise AssertionError(f"25b decode {name}: {k} differs from "
                                     f"a one-process decode of the rows")
    il_t, ol_t = req[1], req[2]
    shares = {}
    for name in ("v2", "v2_plain"):
        out = gathered[name]
        ok = ~out["beam_emptied"]
        if int(ok.sum()) == 0:
            raise AssertionError(f"25b {name}: every utterance emptied")
        if not bool((out["output_length"][ok] == ol_t[ok, None]).all()):
            raise AssertionError(f"25b {name}: a non-emptied utterance's "
                                 f"beams miss their output length")
        lp = out["log_prob"][ok]
        if not bool((lp[:, 0] == lp.max(dim=1).values).all()):
            raise AssertionError(f"25b {name}: slot 0 is not the best")
        shares[name] = (float((out["durations"] == want[name]["durations"])
                              .all(2).all(1).float().mean()),
                        int(out["beam_emptied"].sum()))
    check_tones("25b", gathered["tone"], il_t, cfg.tone_class_size, W)
    shares["tone"] = float((gathered["tone"]["tones"][:, 0] ==
                            want["tone"]["tones"][:, 0]).all(1).float()
                           .mean())
    check_v1_request("25b v1", gathered["v1"], il_t, W)
    shares["v1"] = float((gathered["v1"]["alignment"] ==
                          want["v1"]["alignment"]).all(1).float().mean())
    log(f"[25b decode] {backend}, 4 ranks ({secs:.1f}s with start-up), "
        f"after {len(batches)} 2x2 sharded steps with split parameters "
        f"(train.unshard; the one-process reference: the step over the two "
        f"row halves), each "
        f"data rank's {B // 2} rows, beams rank-local, W={W}: launches a "
        f"rank v2 {T} #14, plain 0, tone {T} #14, v1 {U} #15 (asserted); "
        f"gathered outputs pass the request gates (v2: exact-length "
        f"landing, emptied {shares['v2'][1]} fused / {shares['v2_plain'][1]}"
        f" plain of {B}; v1: steps 0/1, finite mel, slot 0 best); agreement "
        f"with one process on the same route (not gated: bf16 products at "
        f"B={B // 2} and B={B} may round differently; every output equals "
        f"a one-process decode of the same {B // 2} rows bit for bit): v2 "
        f"durations "
        f"{shares['v2'][0]:.3f}, v2 plain {shares['v2_plain'][0]:.3f}, "
        f"tone best beam {shares['tone']:.3f}, v1 alignment "
        f"{shares['v1']:.3f}")

    lap("25b decode")
    # A witness for the cause of those shares: the plain routes, in the
    # bf16 model and in a float32 one (same weights, no TF32), the whole
    # batch against its two halves decoded apart in this process.
    def plain_routes(model_, toks_, il_, ol_) -> dict:
        kw = dict(fuse_model=False, use_pallas=False)
        with torch.no_grad():
            return {
                "v2": decode_lib.v2_duration_decode(
                    model_, toks_, il_, ol_, cfg.duration_table,
                    beam_width=W, max_frames=U, **kw)["durations"],
                "tone": decode_lib.tone_decode(
                    model_, toks_, il_, beam_width=W, **kw)["tones"][:, 0],
                "v1": decode_lib.beam_decode(
                    model_, toks_, il_, max_frames=U, beam_width=W,
                    **kw)["alignment"],
            }

    witness = {}
    for dt in ("bfloat16", "float32"):
        m_ = dryrun.make_model(dataclasses.replace(cfg, dtype=dt), None,
                               seed, dev)
        whole = plain_routes(m_, *req)
        parts_ = [plain_routes(m_, *(x[rows] for x in req))
                  for rows in halves_rows]
        same = {k: (torch.cat([p[k] for p in parts_]) == v).reshape(B, -1)
                for k, v in whole.items()}
        witness[dt] = " ".join(f"{k} {float(x.all(1).float().mean()):.3f}"
                               for k, x in same.items())
    log(f"[25b witness] plain routes, B={B} decoded at once against its "
        f"two halves of {B // 2} decoded apart (one process, W={W}), "
        f"agreement (not gated): bf16 model {witness['bfloat16']}; float32"
        f" model {witness['float32']}")


# ---------------------------------------------------------------- phase 26

# The keys of scripts/eval_e2e.py's record (EVAL_r05.json).
EVAL_KEYS = (
    "config", "batch", "steps", "data_source", "corpus_examples",
    "padding_stats", "decode_backend", "loss_first_logged", "loss_final",
    "train_step_ms", "train_examples_per_s",
    "mel_l2_teacher_forced_alignment", "mel_l2_v2_decoded_alignment",
    "v2_beam_emptied_rate", "v2_beam_emptied_stderr",
    "v2_output_length_mae_frames", "mel_l2_v2_decoded_alignment_guard",
    "v2_beam_emptied_rate_guard", "v2_beam_emptied_stderr_guard",
    "v2_output_length_mae_frames_guard", "eval_n",
    "tone_edit_distance_mean", "tone_edit_distance_per_token", "wall_s")
# Phase 26's corpora (examples materialized into .npz shards: two
# batches of B_LARGE, cut from 1024 for time) and eval_e2e's training
# steps (cut from 8); the runs of each chain that utils/timing.bench_step
# times in eval_e2e (26c) and profile_decode (28a), its default 3.
CORPUS = 512
EVAL_STEPS = 2
BENCH_REPEATS = 1


def state_record(state) -> dict:
    """A detached copy of a TrainState: step, count, and its parameters, mu
    and nu by name."""
    named = list(state.model.named_parameters())
    opt = state.opt_state
    tensors = ([(n, p) for n, p in named]
               + [(f"mu/{n}", m) for (n, _), m in zip(named, opt.mu)]
               + [(f"nu/{n}", v) for (n, _), v in zip(named, opt.nu)])
    return {"step": state.step, "count": opt.count,
            "tensors": [(n, t.detach().clone()) for n, t in tensors]}


def same_record(a: dict, b: dict, what: str) -> int:
    """Raises unless two state_records are equal bit for bit; returns the
    number of tensors compared."""
    if (a["step"], a["count"]) != (b["step"], b["count"]):
        raise AssertionError(f"{what}: step/count {a['step']}/{a['count']} "
                             f"vs {b['step']}/{b['count']}")
    if [n for n, _ in a["tensors"]] != [n for n, _ in b["tensors"]]:
        raise AssertionError(f"{what}: tensor names differ")
    for (n, x), (_, y) in zip(a["tensors"], b["tensors"]):
        if not same_bits(x, y):
            raise AssertionError(f"{what}: {n} differs")
    return len(a["tensors"])


def finite_values(record) -> bool:
    if isinstance(record, dict):
        return all(finite_values(v) for v in record.values())
    if isinstance(record, (int, float)) and not isinstance(record, bool):
        return bool(np.isfinite(record))
    return True


def cli_phase(work, dev) -> None:
    """26a: the train CLI at the flagship width, then resumed."""
    import shutil
    from unittest import mock

    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.scripts import train as train_cli
    from ssnt_tts_tpu_torch.utils import checkpoint as ckpt_lib
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

    ckpt = work / "cli_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    step = train_lib.train_step
    seen = {"last": None, "resumed": None}

    def recorded_step(tx, state, batch):
        """train_step, keeping the state it trains and, in the resumed
        run, its first batch and the state after it."""
        state, metrics = step(tx, state, batch)
        seen["last"] = state
        if seen["resumed"] is None and seen.get("arm"):
            seen["resumed"] = ({k: v.clone() for k, v in batch.items()},
                               state_record(state), float(metrics["loss"]))
        return state, metrics

    zero_counts()
    secs = []
    with mock.patch.object(train_lib, "train_step", recorded_step):
        for steps in (2, 3):
            seen["arm"] = steps == 3
            t0 = time.perf_counter()
            rc = train_cli.main(["--steps", str(steps), "--batch-size",
                                 str(B), "--ckpt", str(ckpt), "--metrics",
                                 str(work / f"cli_{steps}.jsonl")])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            if rc != 0 or ckpt_lib.latest_step(str(ckpt)) != steps:
                raise AssertionError(f"train CLI --steps {steps}: rc {rc}, "
                                     f"latest step "
                                     f"{ckpt_lib.latest_step(str(ckpt))}")
            if steps == 2:
                saved = state_record(seen["last"])
    counts = read_counts()
    expect_counts("26a CLI (2 steps, then 1 resumed)", counts,
                  {"lattice_bidir": 3})
    # restore of step 2 against the state the first run saved
    cfg = ModelConfig()
    tcfg = TrainConfig(batch_size=B, warmup_steps=2)
    like = train_lib.init_train_state(cfg, tcfg, seed=1, device=dev)
    restored = ckpt_lib.restore(str(ckpt), like, step=2)
    n = same_record(state_record(restored), saved, "26a restore of step 2")
    # the resumed run's first step, taken here from the restored state
    batch, after, loss = seen["resumed"]
    _, metrics = train_lib.train_step(train_lib.make_optimizer(tcfg),
                                      restored, batch)
    same_record(state_record(restored), after,
                "26a the first step after the resume")
    if float(metrics["loss"]) != loss:
        raise AssertionError(f"26a resumed step loss {loss} vs "
                             f"{float(metrics['loss'])}")
    rows = [json.loads(x) for x in
            (work / "cli_3.jsonl").read_text().splitlines()]
    n_params = sum(p.numel() for p in restored.model.parameters())
    log(f"[26a cli] scripts.train at ModelConfig() ({n_params} parameters; "
        f"vocab {cfg.vocab_size}, encoder {cfg.encoder_dim} x "
        f"{cfg.encoder_layers} x {cfg.encoder_heads} heads, decoder "
        f"{cfg.decoder_dim}, {cfg.dtype}), B={B} T={T} U={U}: 2 steps "
        f"in {secs[0]:.1f}s, resumed to 3 in {secs[1]:.1f}s (process "
        f"start to exit, host clock); launches {counts}; latest_step 2 "
        f"then 3; restore of step 2 bit for bit the saved state ({n} "
        f"tensors, step, count); step 3 after the resume bit for bit the "
        f"same step from the restored state (loss {loss:.6f}); final loss "
        f"{rows[-1]['loss']:.4f}")


def files_phase(work, seed: int, dev) -> None:
    """26b: run_training(data_dir=) at the flagship width, B=256."""
    import shutil

    from ssnt_tts_tpu_torch import data as data_lib
    from ssnt_tts_tpu_torch import data_files
    from ssnt_tts_tpu_torch.train_loop import run_training
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

    cfg = ModelConfig()
    shards = work / "shards"
    shutil.rmtree(shards, ignore_errors=True)
    ds = data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed + 4)
    t0 = time.perf_counter()
    paths = data_files.materialize_synthetic(ds, CORPUS, str(shards))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    stream = data_files.NpzShardDataset(str(shards)).batches(
        B_LARGE, shuffle_seed=seed)
    first = next(stream)
    t_read = time.perf_counter() - t0
    # the shapes run_training's first steps see: its initialization draw
    # is this stream's first batch
    buckets = [(b["tokens"].shape[1], b["mel"].shape[1])
               for b in (first, next(stream), next(stream))]
    size = sum(p.stat().st_size for p in shards.glob("*.npz"))
    metrics = work / "files.jsonl"
    metrics.unlink(missing_ok=True)
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    last = run_training(3, cfg, TrainConfig(batch_size=B_LARGE,
                                            warmup_steps=2),
                        seed=seed, device=dev, log_every=1,
                        metrics_path=str(metrics), data_dir=str(shards))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    expect_counts("26b file-backed training", counts,
                  {"lattice_forward_alphas": 3,
                   "lattice_backward_grads": 3})
    rows = [json.loads(x) for x in metrics.read_text().splitlines()]
    for k in ("token_padding_efficiency", "frame_padding_efficiency"):
        if not 0 < last[k] <= 1:
            raise AssertionError(f"26b {k} {last[k]}")
    if not finite_values(last):
        raise AssertionError(f"26b metrics not finite: {last}")
    step_ms = [1e3 * (b["t"] - a["t"]) for a, b in zip(rows, rows[1:])]
    log(f"[26b files] materialize_synthetic {CORPUS} examples (T <= {T}, "
        f"U <= {U}, mel {cfg.mel_dim}) into {len(paths)} shards "
        f"({size / 1e6:.1f} MB) in {t_write:.1f}s; NpzShardDataset index + "
        f"first B={B_LARGE} batch {t_read:.2f}s; buckets (T_pad, U_pad) of "
        f"the first three batches {buckets}")
    log(f"[26b files] run_training(data_dir=) ModelConfig() B={B_LARGE}, 3 "
        f"steps in {secs:.1f}s (init, restore check and prefetch "
        f"included); step ms from the metrics clock "
        f"{', '.join(f'{x:.0f}' for x in step_ms)}; launches {counts}; "
        f"padding efficiency token {last['token_padding_efficiency']:.4f} "
        f"frame {last['frame_padding_efficiency']:.4f}; losses "
        + " ".join(f"{r['loss']:.4f}" for r in rows)
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def eval_steps(seed: int, dev) -> str:
    """26c: #14 at eval_e2e's decode batch, B=256 W=8, on its model's width
    (random weights from the seed), as phases 3 and 10 hold it at B=32: the
    v2 step in both of eval_e2e's arms (defaults, final_feasible_guard) and
    the tone step (empty_tone_id 0, tone_decode's), float32 and bfloat16,
    at s = 0, 30, T-1. Each step's h and new_h within TOL of the plain
    step's, its selection bit for bit the plain selection on the kernel's
    h. Returns the log line."""
    from ssnt_tts_tpu_torch import convert
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, V2BeamConfig

    cfg = ModelConfig(**SERVE_CFG, use_duration_lattice=True)
    tree = convert.random_flax_tree(cfg, seed + 9)
    rng = np.random.default_rng(seed + 9)
    arms = ({}, {"config": V2BeamConfig(final_feasible_guard=True)})
    worst = {}
    for dt, name in ((torch.float32, "float32"),
                     (torch.bfloat16, "bfloat16")):
        model = make_model(cfg, tree, name, dev)
        req = make_request(rng, cfg.vocab_size, dev, Bn=B_LARGE)
        v2, tone = [], []
        for s in (0, 30, T - 1):
            inputs = step_inputs(model, req, s, rng, dev)
            v2 += [check_step(inputs, opts, dt) for opts in arms]
            tone.append(check_tone_step(
                tone_step_inputs(model, req[0], req[1], s, rng, dev), 0,
                TOL[dt]))
        worst[name] = ([max(e[i] for e in v2) for i in (0, 1)],
                       [max(e[i] for e in tone) for i in (0, 1)], TOL[dt])
    return (f"[26c steps] #14 at B={B_LARGE} W={W} (the eval decode's "
            f"batch; eval model width): v2 step x 2 arms and tone step at "
            f"s=0/30/{T - 1}, selection bit-exact against the plain "
            f"selection on the kernel's h; max |dh| and |dnew_h|, v2 / "
            f"tone: " + ", ".join(
                f"{n} |dh| {v[0]:.3e} / {t[0]:.3e}, |dnew_h| {v[1]:.3e} / "
                f"{t[1]:.3e} (tol {tol})"
                for n, (v, t, tol) in worst.items()))


def eval_phase(work, seed: int, dev, smi: str) -> None:
    """26c: scripts.eval_e2e, reduced."""
    from unittest import mock

    from ssnt_tts_tpu_torch import data as data_lib
    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.scripts import eval_e2e
    from ssnt_tts_tpu_torch.utils import timing
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

    zero_counts()
    t0 = time.perf_counter()
    with mock.patch.object(timing, "bench_step", functools.partial(
            timing.bench_step, repeats=BENCH_REPEATS)):
        record = eval_e2e.main([
            "--steps", str(EVAL_STEPS), "--corpus", str(CORPUS),
            "--eval-batch", str(B_LARGE), "--beam", str(W), "--data-dir",
            str(work / "eval_shards"), "--out", str(work / "eval.json")])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    missing = [k for k in EVAL_KEYS if k not in record]
    if missing or not finite_values(record):
        raise AssertionError(f"26c eval record: missing {missing} or not "
                             f"finite: {record}")
    fused = ("fused_class_beam_step", "fused_tone_step")
    expect_counts("26c eval (v2 decode in two arms, tone decode)",
                  {k: counts.get(k) for k in fused},
                  dict(zip(fused, (2 * T, T))))
    lap("26c eval_e2e")
    steps_line = eval_steps(seed, dev)
    lap("26c #14 at B=256")
    cfg = ModelConfig(**SERVE_CFG, use_duration_lattice=True)
    tcfg = TrainConfig(batch_size=B_LARGE, warmup_steps=2)
    state = train_lib.init_train_state(cfg, tcfg, seed=seed, device=dev)
    tx = train_lib.make_optimizer(tcfg)
    batch = to_device(data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed + 7).batch(B_LARGE), dev)
    split = split_step_ms(tx, state, batch)
    log(f"[26c eval] scripts.eval_e2e --steps {EVAL_STEPS} --corpus "
        f"{CORPUS} "
        f"--eval-batch {B_LARGE} --beam {W} in {secs:.1f}s; launches "
        f"{counts}")
    log(steps_line)
    log(f"[26c eval] record {json.dumps(record)}")
    log(f"[26c eval] {smi}: train step B={B_LARGE} (eval config, duration "
        f"lattice on): bench_step {record['train_step_ms']} ms (CUDA "
        f"events, slope of 2- and 8-step chains); split_step_ms "
        f"{split['total']:.1f} ms = forward {split['forward']:.1f} + "
        f"backward {split['backward']:.1f} + optimizer "
        f"{split['optimizer']:.1f} (host clock); emptied rates default "
        f"{record['v2_beam_emptied_rate']} guard "
        f"{record['v2_beam_emptied_rate_guard']} (not gated)")


def tools_phase(work, seed: int, dev) -> None:
    """26d: the profiler trace, the NaN guard and the checks on the
    card."""
    from ssnt_tts_tpu_torch import data as data_lib
    from ssnt_tts_tpu_torch.ops import checks
    from ssnt_tts_tpu_torch.parallel import train as train_lib
    from ssnt_tts_tpu_torch.utils import debug, profiling
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

    cfg = ModelConfig()
    tcfg = TrainConfig(batch_size=B, warmup_steps=2)
    state = train_lib.init_train_state(cfg, tcfg, seed=seed, device=dev)
    tx = train_lib.make_optimizer(tcfg)
    batch = to_device(data_lib.SyntheticTTSDataset(
        vocab_size=cfg.vocab_size, mel_dim=cfg.mel_dim,
        duration_class_size=cfg.duration_class_size,
        tone_class_size=cfg.tone_class_size, seed=seed + 8).batch(B), dev)
    split = split_step_ms(tx, state, batch)
    log(f"[26d tools] train step B={B} T={T} U={U} at ModelConfig() "
        f"(flagship; phase 9 times the smoke width): {split['total']:.1f} "
        f"ms = forward {split['forward']:.1f} + backward "
        f"{split['backward']:.1f} + optimizer {split['optimizer']:.1f} "
        f"(host clock, one step)")
    lap("26d split step")
    trace_dir = work / "trace"
    for old in trace_dir.glob("*.json"):
        old.unlink()
    with profiling.trace(str(trace_dir)):
        with profiling.annotate("ssnt_train_step"):
            train_lib.train_step(tx, state, batch)
        torch.cuda.synchronize()
    files = list(trace_dir.glob("*.json"))
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    bidir = [e for e in kernels if "bidir_warp_kernel" in e.get("name", "")]
    marked = [e for e in events if e.get("name") == "ssnt_train_step"]
    if len(files) != 1 or not bidir or not marked:
        raise AssertionError(f"26d trace: {len(files)} files, "
                             f"{len(kernels)} kernel events, {len(bidir)} "
                             f"named bidir_warp_kernel, {len(marked)} "
                             f"annotations")
    busy = sum(e.get("dur", 0) for e in kernels)
    span = max(e["ts"] + e.get("dur", 0) for e in kernels) - min(
        e["ts"] for e in kernels)
    # The trace's own summary: key_averages() would take tens of seconds
    # over its ~200k events.
    names = {e["name"] for e in events if e.get("cat") in ("cpu_op",
                                                          "kernel")}
    log(f"[26d tools] trace of one B={B} train step (ModelConfig()): "
        f"{files[0].stat().st_size / 1e6:.1f} MB, {len(kernels)} kernel "
        f"events, the lattice_bidir kernel as {bidir[0]['name'][:60]!r} "
        f"({bidir[0].get('dur', 0):.1f} us), kernel time {busy / 1e3:.1f} "
        f"ms over a {span / 1e3:.1f} ms span (busy share "
        f"{busy / max(span, 1):.3f}); {len(names)} distinct operator and "
        f"kernel names")

    lap("26d trace")
    guarded = debug.guard_nans(
        lambda st, b: train_lib.train_step(tx, st, b), "train_step")
    err, _ = guarded(state, batch)
    if err.get() is not None:
        raise AssertionError(f"26d guard_nans on a clean step: {err.get()}")
    bad = dict(batch)
    bad["mel"] = batch["mel"].clone()
    bad["mel"][0, 0, 0] = float("nan")
    err, _ = guarded(state, bad)
    report = debug.tree_nan_report(state.model)
    if err.get() is None or not report:
        raise AssertionError("26d guard_nans: the injected NaN not flagged")
    log(f"[26d tools] guard_nans: clean step passes; a NaN mel frame "
        f"flagged ({err.get()!r}); tree_nan_report after it: "
        f"{len(report)} of {len(state.model.state_dict())} tensors")

    W2, i32 = 2, torch.int32
    h = torch.log(torch.full((1, W2, 2), 0.5, device=dev))
    z = lambda dt: torch.zeros(1, W2, dtype=dt, device=dev)
    flags = {}
    for name, U_ in (("empty", 100), ("ok", 2)):
        err, outs = checks.v2_beam_search_step_checked(
            h, z(torch.float32), z(torch.bool), z(i32),
            torch.tensor([1, 2], dtype=i32, device=dev), z(i32), z(i32),
            torch.tensor([1], device=dev), torch.tensor([U_], device=dev),
            zero_duration_id=0, allow_skip=False, test_mode=False)
        flags[f"v2 {name}"] = err.get() is not None
    dur = torch.tensor([[[2, 1]]], dtype=i32, device=dev)
    for name, ol in (("bad", 4), ("ok", 3)):
        err, idx = checks.upsample_source_indexes_checked(
            dur, torch.tensor([[ol]], dtype=i32, device=dev), -1, max_u=4)
        flags[f"upsample {name}"] = err.get() is not None
    if flags != {"v2 empty": True, "v2 ok": False, "upsample bad": True,
                 "upsample ok": False} or idx.device.type != "cuda":
        raise AssertionError(f"26d checks on CUDA tensors: {flags}")
    log(f"[26d tools] ops/checks on CUDA tensors, flagged: {flags}")


def utilities_phase(seed: int, dev, smi: str) -> None:
    """Phase 26: the train CLI and resume, file-backed training, the eval
    entry point and the utilities, at the flagship width."""
    from pathlib import Path

    from ssnt_tts_tpu_torch.utils.config import ModelConfig

    work = Path(__file__).resolve().parent / "build" / "chip_smoke" / "util"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    cli_phase(work, dev)
    lap("26a")
    files_phase(work, seed, dev)
    lap("26b")
    eval_phase(work, seed, dev, smi)
    lap("26c split step")
    tools_phase(work, seed, dev)
    lap("26d guard_nans, checks")
    remat_compare("26e", ModelConfig(), (B,), seed, dev, smi, reps=0)
    remat_compare("26e", ModelConfig(), (B_LARGE,), seed, dev, smi, reps=1)
    lap("26e")
    log(f"[26 util] phase 26 in {time.time() - t0:.1f}s")


# ---------------------------------------------------------------- phase 27

# Phase 27a's beam widths (16 the narrow instances' last; above it the
# wide ones: 17, 24 and 100 pad the fused steps' wgmma N to a multiple of
# 8) and the width of its requests (JAX's triage's beam_x4).
WIDTHS = (16, 17, 24, 32, 64, 100, 128)
W_WIDE = 32
# The beam kernels' entries of the JSON line.
BEAM_ENTRIES = ("fused_v2_step", "fused_tone_step", "v2_beam_step",
                "tone_beam_step", "fused_v1_step", "beam_v1_step_reorder",
                "beam_v1_step")


# Phase 27a's tie-heavy grids through the wide selection: the beam-only
# steps at (W, D = K) with C = 2048 candidates (a power of two) and 2047
# (not one), and the fused steps at W=128 on the 16-class model (C = 2048)
# and W=100 on the smoke model (v2 C = 1000, tone 800). Scores take these
# values: ties, +-0.0 (which tie), -inf and a score near the JAX
# kernels' sentinel, which the port keeps valid.
TIE_BEAM_ONLY = ((128, 16), (89, 23))
TIE_SCORES = (0.0, -0.0, -0.25, -0.5, -1.0, -float("inf"), -2.7e38)


def tie_values(rng, shape, dev):
    """A tensor of `shape` drawn from TIE_SCORES."""
    pick = rng.integers(0, len(TIE_SCORES), shape)
    return torch.tensor(TIE_SCORES, dtype=torch.float32)[
        torch.from_numpy(pick)].to(dev)


def copy_beams(x, Wn: int):
    """x (B, Wn, ...) with every other utterance's beams copies of its
    first four (candidates equal on every field but the parent)."""
    x = x.clone()
    x[::2] = x[::2][:, torch.arange(Wn, device=x.device) % 4]
    return x


def tie_beam_only_inputs(rng, s: int, Wn: int, D: int, H: int, il, ol,
                         dev):
    """beam_only_inputs (K = D) with ties the rule: class log-probs and
    beam scores from TIE_SCORES and copied beams."""
    x = beam_only_inputs(rng, s, Wn, D, D, H, il, ol, dev)
    for k in ("h", "h_tone", "lp"):
        x[k] = tie_values(rng, tuple(x[k].shape), dev)
    for k in ("h", "h_tone", "lp", "fin", "tot", "t", "u", "state"):
        x[k] = copy_beams(x[k], Wn)
    return x


def tie_step(args, rng):
    """A fused step's inputs (step_inputs or tone_step_inputs) with beam
    scores from TIE_SCORES, a third of the beams finished (their padding
    candidates keep the score: +-0.0 ties) and copied beams."""
    out = list(args)
    Bn, Wn = out[6].shape
    out[6] = tie_values(rng, (Bn, Wn), out[6].device)
    out[7] = torch.from_numpy(rng.random((Bn, Wn)) < 0.35).to(out[7].device)
    for i in range(4, len(out)):
        if out[i].dim() >= 2 and tuple(out[i].shape[:2]) == (Bn, Wn):
            out[i] = copy_beams(out[i], Wn)
    return tuple(out)


def v2_gates(what: str, out, il, ol, Wn: int) -> int:
    """Phase 4's gates for one v2 decode at width Wn (every utterance of
    the batch); returns the emptied count."""
    ok = ~out["beam_emptied"]
    if not bool(ok.any()):
        raise AssertionError(f"{what}: every utterance emptied")
    if not bool((out["output_length"][ok] == ol[ok, None]).all()):
        raise AssertionError(f"{what}: a non-emptied utterance's beams miss "
                             f"their output length")
    lp = out["log_prob"][ok]
    if not bool((lp[:, 0] == lp.max(dim=1).values).all()):
        raise AssertionError(f"{what}: slot 0 is not the best beam")
    br = out["beam_branch"]
    if br.shape[2] != Wn or not bool(((br >= 0) & (br < Wn)).all()):
        raise AssertionError(f"{what}: beam_branch shape or range")
    return int((~ok).sum())


def check_limits(rng, dev, models, req) -> None:
    """The libraries' limits equal the Python constants, and each kernel
    wrapper refuses W = MAX_BEAMS + 1 (v2 / tone also max_beam_width) and
    MAX_CANDIDATES + 1 candidates with a ValueError before any launch."""
    from ssnt_tts_tpu_torch.ops import _build, beam_fused
    from ssnt_tts_tpu_torch.ops import beam_kernels as bk

    MB, MC = beam_fused.MAX_BEAMS, beam_fused.MAX_CANDIDATES
    lib_b = _build.beam_step_library()
    lib_c = _build.fused_class_library()
    lib_v = _build.fused_v1_library()
    got = {"beam_step": (lib_b.ssnt_beam_step_max_beams(),
                         lib_b.ssnt_beam_step_max_candidates()),
           "fused_class_step": (lib_c.ssnt_fused_step_max_beams(),
                                lib_c.ssnt_fused_step_max_candidates()),
           "fused_v1_step": (lib_v.ssnt_fused_v1_max_beams(),
                             lib_v.ssnt_fused_v1_max_candidates())}
    want = {"beam_step": (MB, MC), "fused_class_step": (MB, MC),
            "fused_v1_step": (MB, 2 * MB)}
    if got != want:
        raise AssertionError(f"library limits {got}, not {want}")
    bf = models[torch.bfloat16]
    cfg = bf.config
    H, D, K = cfg.decoder_dim, cfg.duration_class_size, cfg.tone_class_size
    _, il, ol = req
    dtab = torch.tensor(cfg.duration_table, dtype=torch.int32, device=dev)
    zero_counts()
    refused = []

    def refuse(what, match, fn):
        try:
            fn()
        except ValueError as e:
            if match not in str(e):
                raise
            refused.append(what)
            return
        raise AssertionError(f"{what}: no ValueError")

    x = beam_only_inputs(rng, 0, MB + 1, D, K, H, il, ol, dev)
    v2a = (x["h"], x["lp"], x["fin"], x["tot"], dtab, x["t"], x["u"],
           x["il"], x["ol"])
    tonea = (x["h_tone"], x["lp"], x["fin"], x["t"], x["u"], x["il"])
    refuse("#12 W=129", "MAX_BEAMS",
           lambda: bk.v2_beam_search_decode(*v2a, state=x["state"]))
    refuse("#13 W=129", "MAX_BEAMS",
           lambda: bk.tone_beam_search_decode(*tonea, state=x["state"]))
    x8 = beam_only_inputs(rng, 0, W, D, K, H, il, ol, dev)
    refuse("#12 W_out=129", "MAX_BEAMS", lambda: bk.v2_beam_search_decode(
        x8["h"], x8["lp"], x8["fin"], x8["tot"], dtab, x8["t"], x8["u"],
        x8["il"], x8["ol"], state=x8["state"], max_beam_width=MB + 1))
    # 2049 = 3 x 683 candidates: a tone step of K = 683 classes at W = 3.
    x3 = beam_only_inputs(rng, 0, 3, D, (MC + 1) // 3, H, il, ol, dev)
    refuse("#13 C=2049", "MAX_CANDIDATES", lambda: bk.tone_beam_search_decode(
        x3["h_tone"], x3["lp"], x3["fin"], x3["t"], x3["u"], x3["il"],
        state=x3["state"]))
    F = H + 2 * cfg.mel_dim + 2
    xv = v1_beam_only_inputs(rng, 0, MB + 1, il, F, dev)
    v1a = (xv["h"], xv["lp"], xv["fin"], xv["t"], xv["u"], xv["il"])
    refuse("#11 W=129", "MAX_BEAMS",
           lambda: bk.beam_search_step_reorder(*v1a, xv["state"]))
    refuse("#10 W=129", "MAX_BEAMS", lambda: bk.beam_search_step_batched(*v1a))
    xv8 = v1_beam_only_inputs(rng, 0, W, il, F, dev)
    refuse("#10 W_out=129", "MAX_BEAMS", lambda: bk.beam_search_step_batched(
        xv8["h"], xv8["lp"], xv8["fin"], xv8["t"], xv8["u"], xv8["il"],
        max_beam_width=MB + 1))
    args = step_inputs(bf, req, 0, rng, dev, Wn=MB + 1)
    refuse("#14 v2 W=129", "MAX_BEAMS",
           lambda: beam_fused.fused_class_beam_step(*args))
    a3 = step_inputs(bf, req, 0, rng, dev, Wn=3)
    base = torch.zeros(T, B, (MC + 1) // 3, device=dev)
    tone3 = (a3[0], a3[1], base, *a3[3:8], a3[9], a3[10], a3[11])
    refuse("#14 tone C=2049", "MAX_CANDIDATES",
           lambda: beam_fused.fused_tone_step(*tone3))
    pack, fw, kept = v1_carries(bf, req[0], il, (0,), 1, dev)
    z = lambda dt, *shape: torch.zeros(B, MB + 1, *shape, dtype=dt,
                                       device=dev)
    i32 = torch.int32
    refuse("#15 W=129", "MAX_BEAMS", lambda: beam_fused.fused_v1_beam_step(
        pack, z(i32), z(i32), z(torch.float32), z(torch.bool), il,
        z(torch.float32, cfg.mel_dim), z(torch.float32, H), fw))
    torch.cuda.synchronize()
    if read_counts():
        raise AssertionError(f"launches after the refused calls: "
                             f"{read_counts()}")
    log(f"[27a limits] every library's MAX_BEAMS / MAX_CANDIDATES equals "
        f"ops/beam_fused's ({MB} / {MC}; v1: {MB} / {2 * MB}); ValueError "
        f"before any launch for {', '.join(refused)}; launch counts 0")


def route_shares(kind: str, f: dict, p: dict) -> tuple:
    """(best-beam share, all-beams share) of utterances on which two
    routes' decodes agree: v2 durations and tones of slot 0 / of every
    beam; v1 the best path's alignment / every beam's t_history."""
    if kind == "v1":
        best = (f["alignment"] == p["alignment"]).all(1)
        every = (f["t_history"] == p["t_history"]).flatten(1).all(1)
    else:
        k = "durations" if kind == "v2" else "tones"
        best = (f[k][:, 0] == p[k][:, 0]).all(1)
        every = (f[k] == p[k]).flatten(1).all(1)
    return best.float().mean().item(), every.float().mean().item()


def share_text(agree: dict) -> str:
    names = {"v2": "v2 durations", "tone": "tones", "v1": "v1 alignment"}
    return ", ".join(f"{names[k]} {a:.3f} / {e:.3f}"
                     for k, (a, e) in agree.items())


# The step each decode route calls once a step, by (kind, route): the
# module holding it and its name there.
STEP_FNS = {("v2", "fused"): ("beam_fused", "fused_class_beam_step"),
            ("tone", "fused"): ("beam_fused", "fused_tone_step"),
            ("v1", "fused"): ("beam_fused", "fused_v1_beam_step"),
            ("v2", "plain"): ("beam_kernels",
                              "v2_beam_search_decode_reference"),
            ("tone", "plain"): ("beam_kernels",
                                "tone_beam_search_decode_reference"),
            ("v1", "plain"): ("beam_kernels",
                              "beam_search_step_reorder_reference")}


def step_scores(kind: str, route: str, run):
    """run()'s outputs, and the log-probs (B, W) each step of the decode
    selected, in step order: the route's step wrapped for the call (a
    kernel wrapper counts its launches through its module's name, so the
    count moves to the stand-in and back)."""
    import importlib

    mod_name, fn_name = STEP_FNS[(kind, route)]
    mod = importlib.import_module(f"ssnt_tts_tpu_torch.ops.{mod_name}")
    orig = getattr(mod, fn_name)
    kept = []

    def wrapped(*a, **k):
        out = orig(*a, **k)
        kept.append(out.log_prob.clone())
        return out

    wrapped.launches = getattr(orig, "launches", 0)
    setattr(mod, fn_name, wrapped)
    try:
        return run(), kept
    finally:
        setattr(mod, fn_name, orig)
        if hasattr(orig, "launches"):
            orig.launches = wrapped.launches


def parting(kind: str, outs: dict, scores: dict) -> str:
    """Where the routes' best beams part in the first utterance on which
    they do: the first step whose selection differs, and the scores
    there."""
    f, p = outs["fused"], outs["plain"]
    if kind == "v1":
        best = (f["alignment"] == p["alignment"]).all(1)
    else:
        k = "durations" if kind == "v2" else "tones"
        best = (f[k][:, 0] == p[k][:, 0]).all(1)
    b = int((~best).nonzero()[0, 0])
    same = ((f["prediction"][b] == p["prediction"][b])
            & (f["beam_branch"][b] == p["beam_branch"][b])).all(-1)
    s = int((~same).nonzero()[0, 0]) if not bool(same.all()) else -1
    at = lambda r, i: scores[r][i][b]
    gap = lambda i: float((at("fused", i) - at("plain", i)).abs().max())
    before = f"{gap(s - 1):.3e}" if s > 0 else "none (first step)"
    return (f"{kind}: utterance {b}, step {s}: slot 0 score fused "
            f"{float(at('fused', s)[0]):.6f}, plain "
            f"{float(at('plain', s)[0]):.6f}; largest |fused - plain| over "
            f"the beams there {gap(s):.3e}, at the step before {before}")


def wide_phase(seed: int, dev, smi: str, models) -> dict:
    """Phase 27a; returns, by entry name of the JSON line, the keys it adds
    to the beam kernels' entries."""
    from ssnt_tts_tpu_torch import convert
    from ssnt_tts_tpu_torch.ops import beam_fused
    from ssnt_tts_tpu_torch.ops import beam_kernels as bk
    from ssnt_tts_tpu_torch.parallel import decode
    from ssnt_tts_tpu_torch.utils.config import V2BeamConfig

    t_phase = time.time()
    rng = np.random.default_rng(seed + 27)
    bf = models[torch.bfloat16]
    cfg = bf.config
    H, M, D, K = (cfg.decoder_dim, cfg.mel_dim, cfg.duration_class_size,
                  cfg.tone_class_size)
    F = H + 2 * M + 2
    mid = min(30, T - 1)
    req = make_request(rng, cfg.vocab_size, dev)
    toks, il, ol = req
    check_limits(rng, dev, models, req)

    # 16 duration and 16 tone classes: 2048 candidates at W = 128.
    cfg16 = dataclasses.replace(cfg, duration_class_size=16,
                                tone_class_size=16,
                                duration_table=tuple(range(16)))
    tree16 = convert.random_flax_tree(cfg16, seed + 27)
    models16 = {dt: make_model(cfg16, tree16, name, dev) for dt, name in
                ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"))}
    dtabs = {n: torch.tensor(tuple(range(n)), dtype=torch.int32, device=dev)
             for n in (D, 16, 23)}
    option_sets = (({}, 0),
                   ({"config": V2BeamConfig(final_feasible_guard=True)}, 3),
                   ({"allow_skip": True}, 0), ({"test_mode": True}, 3))

    # ---- beam-only #12 / #13 and #11 / #10 against their plain versions
    n_bo = 0
    cases = ([(Wn, D, K, None, H) for Wn in WIDTHS]
             + [(128, 16, 16, None, H), (W, D, K, 128, H),
                (17, D, K, 40, H - 1), (64, D, K, 10, H)])
    for Wn, Dn, Kn, w_out, Fn in cases:
        for s in (0, mid, T - 1):
            x = beam_only_inputs(rng, s, Wn, Dn, Kn, Fn, il, ol, dev)
            for opts, empty in option_sets:
                check_beam_only(x, dtabs[Dn], opts, empty, w_out)
                n_bo += 1
    v1_cases = ([(Wn, None, F) for Wn in WIDTHS]
                + [(W, 128, F), (17, 40, F - 1), (128, 128, F - 1),
                   (64, 10, F)])
    n_v1 = 0
    for Wn, w_out, Fn in v1_cases:
        for s in (0, 40, T - 1):
            check_v1_beam_only(v1_beam_only_inputs(rng, s, Wn, il, Fn, dev),
                               w_out)
            n_v1 += 1
    log(f"[27a beam-only] #12 / #13 at (W, D, K, W_out, F) in "
        f"{[c for c in cases]} ({n_bo} checks, 4 option sets) and #11 / #10 "
        f"at (W, W_out, F) in {v1_cases} ({n_v1} checks), s=0/{mid}/"
        f"{T - 1}, ragged lengths: every output bit-exact against the plain "
        f"versions")

    # ---- fused #14 (v2, tone) and #15 against the plain steps ----
    carries = {}
    for dt, model in models.items():
        errs_v2, errs_tone, errs_v1 = [], [], []
        for Wn in WIDTHS:
            for s in (0, mid, T - 1):
                inputs = step_inputs(model, req, s, rng, dev, Wn=Wn)
                for opts, _ in option_sets:
                    errs_v2.append(check_step(inputs, opts, dt))
                for empty in (0, 3):
                    errs_tone.append(check_tone_step(tone_step_inputs(
                        model, toks, il, s, rng, dev, Wn), empty, TOL[dt]))
            pack, fw, kept = v1_carries(model, toks, il, (0, 100), Wn, dev)
            for f, c in kept.items():
                errs_v1.append(check_v1_step(pack, fw, c, il, TOL[dt]))
                if f > 0:
                    errs_v1.append(check_v1_step(
                        pack, fw, v1_perturb(c, il, rng, dev), il, TOL[dt]))
            if dt == torch.bfloat16:
                carries[Wn] = (pack, fw, kept[100])
        m16 = models16[dt]
        for s in (0, mid, T - 1):
            inputs = step_inputs(m16, req, s, rng, dev, Wn=128)
            for opts, _ in option_sets:
                errs_v2.append(check_step(inputs, opts, dt))
            errs_tone.append(check_tone_step(tone_step_inputs(
                m16, toks, il, s, rng, dev, 128), 3, TOL[dt]))
        log(f"[27a fused] {str(dt)[6:]}: #14 v2 ({len(errs_v2)} steps: W in "
            f"{WIDTHS} at D={D}, s=0/{mid}/{T - 1}, 4 option sets; W=128 at "
            f"D=16, C=2048), #14 tone ({len(errs_tone)}: K={K}, empty 0 / 3; "
            f"W=128 at K=16), #15 ({len(errs_v1)}: a request's carry at "
            f"frames 0/100, perturbed at 100): selection and reorder "
            f"bit-exact; max |dh|, |dnew_h| v2 "
            f"{max(max(e) for e in errs_v2):.3e}, tone "
            f"{max(max(e) for e in errs_tone):.3e}, #15 |dh|, |dnew_h|, "
            f"|dmel| {max(errs_v1):.3e} (tol {TOL[dt]})")

    # ---- tie-heavy grids through the wide selection, bit for bit ----
    n_bo = 0
    for Wn, Dn in TIE_BEAM_ONLY:
        for s in (0, mid):
            x = tie_beam_only_inputs(rng, s, Wn, Dn, H, il, ol, dev)
            for opts, empty in option_sets:
                for w_out in (None, 1):
                    check_beam_only(x, dtabs[Dn], opts, empty, w_out)
                    n_bo += 1
    n_fused = 0
    for dt, model in models.items():
        for m, Wn in ((models16[dt], 128), (model, 100)):
            inputs = tie_step(step_inputs(m, req, mid, rng, dev, Wn=Wn), rng)
            for opts, _ in option_sets:
                check_step(inputs, opts, dt)
            tone = tie_step(tone_step_inputs(m, toks, il, mid, rng, dev, Wn),
                            rng)
            for empty in (0, 3):
                check_tone_step(tone, empty, TOL[dt])
            n_fused += len(option_sets) + 2
    log(f"[27a ties] scores from {TIE_SCORES}, copied beams: #12 / #13 at "
        f"(W, D = K) in {TIE_BEAM_ONLY} (C = 2048, 2047), s=0/{mid}, 4 "
        f"option sets, W_out = W and 1 ({n_bo} checks); #14 v2 / tone at "
        f"W=128 on the 16-class model and W=100 on the smoke model, f32 and "
        f"bf16 ({n_fused} steps): selection and reorder bit-exact against "
        f"the plain versions")

    # ---- one v2, tone and v1 request at W_WIDE on each route ----
    counters = (beam_fused.fused_class_beam_step, beam_fused.fused_tone_step,
                beam_fused.fused_v1_beam_step, bk.v2_beam_search_decode,
                bk.tone_beam_search_decode, bk.beam_search_step_reorder)
    counts = lambda: tuple(c.launches for c in counters)
    routes = (("fused", {}), ("beam-only", {"fuse_model": False}),
              ("plain", {"fuse_model": False, "use_pallas": False}))
    tone_toks, tone_il, _ = tone_requests(cfg, seed + 27, dev, n=1)[0]
    runs = {
        "v2": (lambda m, kw: decode.v2_duration_decode(
            m, toks, il, ol, cfg.duration_table, beam_width=W_WIDE,
            max_frames=U, **kw), ("durations", "output_length",
                                  "beam_emptied"),
            {"fused": (T, 0, 0, 0, 0, 0), "beam-only": (0, 0, 0, T, 0, 0)}),
        "tone": (lambda m, kw: decode.tone_decode(
            m, tone_toks, tone_il, beam_width=W_WIDE, **kw), ("tones",),
            {"fused": (0, T, 0, 0, 0, 0), "beam-only": (0, 0, 0, 0, T, 0)}),
        "v1": (lambda m, kw: decode.beam_decode(
            m, toks, il, max_frames=U, beam_width=W_WIDE, **kw),
            ("alignment", "num_frames", "mel"),
            {"fused": (0, 0, U, 0, 0, 0), "beam-only": (0, 0, 0, 0, 0, U)}),
    }
    agree, wide_launches = {}, {}
    with torch.no_grad():
        for kind, (fn, keys, want) in runs.items():
            outs = {}
            for name, kw in routes:
                before = counts()
                outs[name] = fn(bf, kw)
                torch.cuda.synchronize()
                got = tuple(a - b for a, b in zip(counts(), before))
                if got != want.get(name, (0,) * 6):
                    raise AssertionError(f"{kind} W={W_WIDE} {name}: "
                                         f"launches {got}")
                if name == "fused":
                    wide_launches[f"fused_{kind}_step"] = max(got)
                what = f"{kind} request W={W_WIDE} {name}"
                if kind == "v2":
                    v2_gates(what, outs[name], il, ol, W_WIDE)
                elif kind == "v1":
                    check_v1_request(what, outs[name], il, W_WIDE)
            for k in keys:
                if not same_bits(outs["beam-only"][k], outs["plain"][k]):
                    raise AssertionError(f"{kind} W={W_WIDE}: beam-only and "
                                         f"plain routes differ on {k}")
            agree[kind] = route_shares(kind, outs["fused"], outs["plain"])
    log(f"[27a requests] W={W_WIDE}, B={B}, bf16: v2 (T={T}), tone and v1 "
        f"({U} frames) on the fused, beam-only and plain routes, with exact "
        f"launch counts (T #14 / T #12; T #14 tone / T #13; {U} #15 / {U} "
        f"#11); beam-only outputs equal the plain route's bit for bit; "
        f"gates of phases 4 and 16 passed. Not gated (random weights): "
        f"fused vs plain, share of utterances that agree, best beam / all "
        f"beams: " + share_text(agree))
    # The same requests in a float32 model: the routes' class steps round
    # alike, so a drift of the wide fused kernels shows as a share below 1.
    f32 = models[torch.float32]
    agree32, parted = {}, []
    with torch.no_grad():
        for kind, (fn, _, _) in runs.items():
            outs, scores = {}, {}
            for name, kw in routes[::2]:  # fused, plain
                outs[name], scores[name] = step_scores(
                    kind, name, lambda: fn(f32, kw))
            agree32[kind] = route_shares(kind, outs["fused"], outs["plain"])
            if agree32[kind][0] < 1.0:
                parted.append(parting(kind, outs, scores))
    log(f"[27a requests] W={W_WIDE}, B={B}, float32 model, fused vs plain, "
        f"share of utterances that agree, best beam / all beams: "
        + share_text(agree32)
        + ("" if not parted else "; where a best beam parts: "
           + "; ".join(parted)))

    # ---- device time a step under a CUDA graph at each W, and bounds ----
    R = cfg.joint_rank
    macs = M * H + H * H + 2 * H * 3 * H + H * R + R * 2 * R + H * M + 2 * H
    times = {n: {} for n in BEAM_ENTRIES}
    with torch.no_grad():
        for Wn in WIDTHS:
            v2s = step_inputs(bf, req, mid, rng, dev, Wn=Wn)
            ts = tone_step_inputs(bf, toks, il, mid, rng, dev, Wn)
            pack, fw, c = carries[Wn]
            fa = (pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"],
                  c["state"])
            x = beam_only_inputs(rng, mid, Wn, D, K, H, il, ol, dev)
            v2a = (x["h"], x["lp"], x["fin"], x["tot"], dtabs[D], x["t"],
                   x["u"], x["il"], x["ol"])
            tonea = (x["h_tone"], x["lp"], x["fin"], x["t"], x["u"],
                     x["il"])
            xv = v1_beam_only_inputs(rng, 40, Wn, il, F, dev)
            v1a = (xv["h"], xv["lp"], xv["fin"], xv["t"], xv["u"], xv["il"])
            fns = {
                "fused_v2_step": (
                    lambda: beam_fused.fused_class_beam_step(*v2s),
                    nbytes(v2s[1][mid], v2s[2][mid], *v2s[3], *v2s[4:]),
                    2 * B * Wn * H * 3 * H * 2 + 2 * B * Wn * H * D,
                    BF16_OPS),
                "fused_tone_step": (
                    lambda: beam_fused.fused_tone_step(*ts),
                    nbytes(ts[1][mid], ts[2][mid], *ts[3], *ts[4:]),
                    2 * B * Wn * H * 3 * H * 2 + 2 * B * Wn * H * K,
                    BF16_OPS),
                "fused_v1_step": (
                    lambda: beam_fused.fused_v1_beam_step(*fa, fw),
                    nbytes(*fw) + B * Wn * pack.shape[2] * 4
                    + nbytes(*fa[1:]), 2 * B * Wn * macs, BF16_OPS),
                "v2_beam_step": (
                    lambda: bk.v2_beam_search_decode(*v2a,
                                                     state=x["state"]),
                    nbytes(*v2a, x["state"]), 2 * B * (Wn * D) ** 2,
                    F32_OPS),
                "tone_beam_step": (
                    lambda: bk.tone_beam_search_decode(*tonea,
                                                       state=x["state"]),
                    nbytes(*tonea, x["state"]), 2 * B * (Wn * K) ** 2,
                    F32_OPS),
                "beam_v1_step_reorder": (
                    lambda: bk.beam_search_step_reorder(*v1a, xv["state"]),
                    nbytes(*v1a, xv["state"]), 2 * B * (2 * Wn) ** 2,
                    F32_OPS),
                "beam_v1_step": (
                    lambda: bk.beam_search_step_batched(*v1a),
                    nbytes(*v1a), 2 * B * (2 * Wn) ** 2, F32_OPS),
            }
            for name, (fn, in_bytes, ops, rate) in fns.items():
                out_bytes = nbytes(*(o for o in fn() if o is not None))
                times[name][Wn] = (graph_ms(fn),
                                   bound(in_bytes + out_bytes, ops, rate))
            log(f"[27a time] {smi}: W={Wn}, B={B}, bf16 model, device time "
                f"a step (CUDA graph) against its bound, and the bound's "
                f"share of it: "
                + "; ".join(f"{n} {times[n][Wn][0]:.4f} ms (bound "
                            f"{times[n][Wn][1][0] * 1e3:.3f} us, "
                            f"{times[n][Wn][1][1]}, share "
                            f"{times[n][Wn][1][0] / times[n][Wn][0]:.4f})"
                            for n in fns))
    log(f"[27a] done in {time.time() - t_phase:.1f}s")
    MB = beam_fused.MAX_BEAMS
    return {name: {
        "max_beams": MB,
        "max_candidates": (2 * MB if "v1" in name  # C = 2W
                           else beam_fused.MAX_CANDIDATES),
        **{f"ms_w{Wn}": times[name][Wn][0] for Wn in (32, 128)},
        **{f"bound_ms_w{Wn}": times[name][Wn][1][0] for Wn in (32, 128)},
        **({f"launches_w{W_WIDE}_request": wide_launches[name]}
           if name in wide_launches else {}),
    } for name in BEAM_ENTRIES}


# The keys of scripts/decode_scale.py's record (DECODE_SCALE_r05.json)
# and of scripts/triage_empty_beam.py's (TRIAGE_EMPTYBEAM_r04.json).
SCALE_KEYS = ("config", "platform", "T", "U", "beam", "sharding", "runs",
              "scaling_note", "wall_s")
TRIAGE_KEYS = ("eval_batch", "beam", "train_batch", "checkpoints",
               "sweeps_at_final", "wall_s")
TRIAGE_ENTRY_KEYS = ("emptied_rate", "n_emptied", "rescued_by",
                     "first_empty_t_relative", "output_length_mae_frames")
B_SCALE, B_SCALE_SLICE, SCALE_RANKS = 2048, 256, 4


def scale_phase(dev, smi: str) -> None:
    """Phase 27b: scripts.decode_scale at B_SCALE (one process, and over
    SCALE_RANKS data ranks) and B_SCALE_SLICE, the fused route; the
    B_SCALE decode bit for bit its rows decoded in slices of B_SCALE_SLICE
    and the ranks' decode."""
    from ssnt_tts_tpu_torch.ops import beam_fused
    from ssnt_tts_tpu_torch.scripts import decode_scale

    t_phase = time.time()
    work = pathlib.Path("build") / "chip_smoke" / "scale"
    got = {}
    torch.cuda.reset_peak_memory_stats(dev)
    before = beam_fused.fused_class_beam_step.launches
    rec = decode_scale.main(
        ["--batch", str(B_SCALE), "--small-batch", str(B_SCALE_SLICE),
         "--seq", str(T), str(U), "--beam", str(W), "--reps", "2",
         "--ranks", str(SCALE_RANKS), "--job-dir", str(work / "ranks"),
         "--json", str(work / "scale.json")], outputs=got)
    peak = torch.cuda.max_memory_allocated(dev)
    n = beam_fused.fused_class_beam_step.launches - before
    if tuple(rec) != SCALE_KEYS:
        raise AssertionError(f"decode_scale record keys {tuple(rec)}")
    # B=256 and B=2048 in this process: one warm decode and two timed each.
    if n != 3 * 2 * T:
        raise AssertionError(f"decode_scale: {n} #14 launches in this "
                             f"process, not {3 * 2 * T}")
    for r, got_l in enumerate(got["sharded_launches"]):  # its first decode
        if got_l["fused_class_beam_step"] != T:
            raise AssertionError(f"decode_scale rank {r}: launches {got_l}")
    one = {k: v.cpu() for k, v in got["one"].items()}
    model, batch = got["model"], got["batch"]
    dec = decode_scale.decoder
    for i in range(B_SCALE // B_SCALE_SLICE):
        rows = slice(i * B_SCALE_SLICE, (i + 1) * B_SCALE_SLICE)
        with torch.no_grad():
            part = dec(model, {k: v[rows] for k, v in batch.items()}, W, U,
                       False)()
        for k, v in part.items():
            if not same_bits(v.cpu(), one[k][rows]):
                raise AssertionError(f"B={B_SCALE}: rows {rows} differ on "
                                     f"{k} from their slice's decode")
    for k, v in got["sharded"].items():
        if not same_bits(torch.as_tensor(v), one[k]):
            raise AssertionError(f"B={B_SCALE} over {SCALE_RANKS} ranks "
                                 f"differs on {k} from one process")
    runs = {(r["B"], r["sharded"]): r for r in rec["runs"]}
    big, small = runs[(B_SCALE, False)], runs[(B_SCALE_SLICE, False)]
    sh = runs[(B_SCALE, True)]
    log(f"[27b decode_scale] {smi}: v2_duration_decode (fused #14) T={T} "
        f"U={U} W={W} bf16, host clock, mean of 2 after a warm one: "
        f"B={B_SCALE} {big['ms_per_decode']} ms "
        f"({big['audio_s_per_s']} audio-s/s, emptied rate "
        f"{big['beam_emptied_rate']}), B={B_SCALE_SLICE} "
        f"{small['ms_per_decode']} ms ({small['audio_s_per_s']} audio-s/s), "
        f"B={B_SCALE} over {SCALE_RANKS} ranks ({rec['sharding']['mesh']}) "
        f"{sh['ms_per_decode']} ms ({sh['audio_s_per_s']} audio-s/s); peak "
        f"device memory of this process {peak / 2**30:.3f} GiB; B={B_SCALE} "
        f"bit for bit its {B_SCALE // B_SCALE_SLICE} slices of "
        f"{B_SCALE_SLICE} and the {SCALE_RANKS}-rank run; "
        f"{rec['scaling_note']}")
    log(f"[27b decode_scale] record: {json.dumps(rec)}")
    log(f"[27b] done in {time.time() - t_phase:.1f}s")


def triage_phase(dev) -> None:
    """Phase 27c: a reduced scripts.triage_empty_beam at the smoke width
    (JAX's keys, every sweep, beam_x4 at W = 4 --beam), then its final
    checkpoint decoded at that width on the fused and beam-only routes,
    beside the plain step's sweep."""
    from ssnt_tts_tpu_torch.ops import beam_fused
    from ssnt_tts_tpu_torch.ops import beam_kernels as bk
    from ssnt_tts_tpu_torch.parallel import decode
    from ssnt_tts_tpu_torch.scripts import triage_empty_beam

    t_phase = time.time()
    got = {}
    rec = triage_empty_beam.main(
        ["--steps", "2", "4", "--batch", "64", "--eval-batch", "64",
         "--beam", str(W), "--out",
         "build/chip_smoke/triage/triage.json"], outputs=got)
    entries = list(rec["checkpoints"].values()) + list(
        rec["sweeps_at_final"].values())
    if (tuple(rec) != TRIAGE_KEYS
            or tuple(rec["checkpoints"]) != ("2", "4")
            or tuple(rec["sweeps_at_final"]) != (
                "allow_skip", "band_x2", "band_x4", "beam_x2", "beam_x4")
            or any(tuple(e)[:5] != TRIAGE_ENTRY_KEYS for e in entries)):
        raise AssertionError(f"triage record: keys {json.dumps(rec)[:400]}")
    log(f"[27c triage] record: {json.dumps(rec)}")
    model, toks, il, ol = (got[k] for k in ("model", "tokens", "il", "ol"))
    Wn = 4 * W
    line = []
    with torch.no_grad():
        for name, kw, kern in (
                ("fused", {}, beam_fused.fused_class_beam_step),
                ("beam-only", {"fuse_model": False},
                 bk.v2_beam_search_decode)):
            before = kern.launches
            out = decode.v2_duration_decode(
                model, toks, il, ol, model.config.duration_table,
                beam_width=Wn, max_frames=got["max_frames"], **kw)
            torch.cuda.synchronize()
            if kern.launches - before != toks.shape[1]:
                raise AssertionError(f"triage W={Wn} {name}: launches")
            e = out["beam_emptied"].cpu().numpy()
            mae = (out["output_length"][:, 0] - ol).abs().float().mean()
            line.append(f"{name} emptied rate {e.mean():.4f} "
                        f"({int(e.sum())}), output_length MAE "
                        f"{float(mae):.2f} frames")
    log(f"[27c triage] final checkpoint at W={Wn} (B={toks.shape[0]}): "
        + "; ".join(line) + f"; plain step (the record's beam_x4): "
        f"{rec['sweeps_at_final']['beam_x4']['emptied_rate']:.4f} "
        f"({rec['sweeps_at_final']['beam_x4']['n_emptied']}), MAE "
        f"{rec['sweeps_at_final']['beam_x4']['output_length_mae_frames']}")
    log(f"[27c] done in {time.time() - t_phase:.1f}s")


# Phase 28: profile_decode's rounds (the host clock drifts between
# components); the ring's shard counts and blocks, and the timed calls of
# the ring and of the proof's step. Cut for the run's time from JAX's
# tool's defaults (shards 2 4 8, blocks 1 8 16 40 80 100, 6 calls; the
# proof's 10 steps), which phase 28 run alone measured (PERF.md, section
# 6); profile_decode's chains of at most PROFILE_MAX_ITERS steps (its
# default 5000), the triage's steps (its 10) and the proof's shard counts
# (its 1 2 4 8) likewise.
PROFILE_ROUNDS = 1
PROFILE_MAX_ITERS = 1000
TSHARD_DEVICES = (2,)
TSHARD_BLOCKS = (1, 40)
TSHARD_SHAPE = (400, 8, 64)
TOOL_STEPS = 1
TRIAGE_STEPS = 1
PROOF_DEVICES = (1, 4)
# Wrapper name -> its entry in the JSON line, for the kernels phase 28
# launches in this process.
TOOL_ENTRIES = {"beam_search_step_batched": "beam_v1_step",
                "beam_search_step_reorder": "beam_v1_step_reorder",
                "lattice_bidir": "lattice_bidir"}


def lattice_launches(rows: int, Tn: int, grad: bool) -> dict:
    """The lattice kernels one loss call launches at `rows` examples of T
    columns (ops/lattice_kernels' routing): the bidirectional kernel, or
    forward alphas and backward gradients, with gradients; forward alphas
    alone without."""
    from ssnt_tts_tpu_torch.ops import lattice_kernels

    if not grad:
        return {"lattice_forward_alphas": 1}
    if lattice_kernels.grad_mode("log", rows, Tn)[0] == "fused":
        return {"lattice_bidir": 1}
    return {"lattice_forward_alphas": 1, "lattice_backward_grads": 1}


def profile_phase(work, dev, smi: str) -> dict:
    """28a; returns the launches the phase should count, by wrapper."""
    from unittest import mock

    from ssnt_tts_tpu_torch.parallel import decode
    from ssnt_tts_tpu_torch.scripts import profile_decode

    want = {}
    for route in profile_decode.ROUTES:
        got = {}
        with mock.patch.object(profile_decode, "bench_step", functools.partial(
                profile_decode.bench_step, repeats=BENCH_REPEATS)):
            rec = profile_decode.main(
                ["--route", route, "--rounds", str(PROFILE_ROUNDS),
                 "--max-iters", str(PROFILE_MAX_ITERS), "--trace",
                 str(work / f"trace_{route}"), "--json",
                 str(work / f"profile_{route}.json")], outputs=got)
        if (tuple(rec)[:6] != profile_decode.COMPONENTS
                + ("components_sum", "unattributed")
                or (rec["B"], rec["W"], rec["T"], rec["U"]) != (B, W, T, U)):
            raise AssertionError(f"profile_decode record: {rec}")
        log(f"[28a profile_decode] {smi}: record ({route}): "
            f"{json.dumps(rec)}")
        model, toks = got["model"], got["tokens"]
        il = got["input_length"].clone()
        il[:4] = torch.tensor([2, 3, 5, 8], dtype=torch.int32)
        kw = {"fuse_model": False}
        if route == "plain":
            kw["use_pallas"] = False
        with torch.no_grad():
            frames = profile_decode.decode_by_frames(model, toks, il, U, W,
                                                     route)
            ref = decode.beam_decode(model, toks, il, max_frames=U,
                                     beam_width=W, **kw)
        torch.cuda.synchronize()
        kept = frames.pop("kept")
        for k, v in ref.items():
            if not same_bits(frames[k], v):
                raise AssertionError(f"28a {route}: the full step over {U} "
                                     f"frames differs from beam_decode on "
                                     f"{k}")
        if kept == 0:
            raise AssertionError(f"28a {route}: no finished beam kept its "
                                 f"mel: the gate did not reach the keep")
        log(f"[28a profile_decode] {route}: the full step run over {U} "
            f"frames (B={B}, W={W}, utterances of 2/3/5/8 tokens and the "
            f"rest of {T}) bit for bit beam_decode's {route} route "
            f"(alignment, log-probs, mel and every other output); "
            f"{kept} beam-frames took the finished-beam mel keep")
        if route == "beam-only":
            want = {"beam_search_step_batched": rec["steps"]["beam"],
                    "beam_search_step_reorder": rec["steps"]["full"]
                    + rec["steps"]["traced"] + 2 * U}
    return want


def tshard_phase(work, dev, smi: str) -> dict:
    """28b; returns the launches the phase should count, by wrapper."""
    from ssnt_tts_tpu_torch.ops import lattice as lattice_ops
    from ssnt_tts_tpu_torch.scripts import tshard_bench

    got = {}
    steps = TOOL_STEPS
    rec = tshard_bench.main(
        ["--devices", *map(str, TSHARD_DEVICES), "--shape",
         *map(str, TSHARD_SHAPE), "--blocks", *map(str, TSHARD_BLOCKS),
         "--steps", str(steps), "--job-dir", str(work / "tshard"),
         "--json", str(work / "tshard.json")], outputs=got)
    x = got["inputs"]
    xs = [torch.tensor(x[k], device=dev, requires_grad=True)
          for k in ("le", "ls", "lf")]
    il, ol = (torch.as_tensor(x[k], device=dev) for k in ("il", "ol"))
    plain = lattice_ops.ssnt_loss(*xs, il, ol, layout="ubt")
    plain.sum().backward()
    plain = [plain.detach()] + [v.grad for v in xs]
    k_loss, k_grads = got["unsharded"]
    for run, res in zip(rec["runs"], got["runs"]):
        ring = [torch.as_tensor(a).to(dev) for a in [res["loss"]]
                + res["grads"]]
        if not all(same_bits(a, b) for a, b in zip(ring, plain)):
            raise AssertionError(f"28b n={run['shards']} block="
                                 f"{run['block']}: ring loss or gradients "
                                 f"not bit for bit the plain unsharded "
                                 f"loss's")
    # The rings are the plain loss bit for bit, so one comparison holds
    # them all to the kernel loss, by phase 24's rule for the kernel
    # route against the plain one.
    rel = float(((k_loss - plain[0]).abs() / plain[0].abs()).max())
    gerr, ulps = route_grads_err(k_grads, plain[1:], plain[0])
    if not (rel <= ROUTE_LOSS_RTOL and gerr <= BANDED_GRAD_ATOL):
        raise AssertionError(f"28b: the unsharded kernel loss against the "
                             f"plain one: loss {rel} relative, gradients "
                             f"{gerr} past the tolerance ({ulps:.1f} eps "
                             f"|logZ|)")
    log(f"[28b tshard_bench] {smi}: record: {json.dumps(rec)}")
    log(f"[28b tshard_bench] {len(rec['runs'])} runs (n in "
        f"{TSHARD_DEVICES}, blocks {TSHARD_BLOCKS}, {steps} timed calls; "
        f"cut from JAX's 2 4 8, 1 8 16 40 80 100 and 6 for time; U, B, T = "
        f"{TSHARD_SHAPE}): every ring loss and gradient bit for bit the "
        f"plain unsharded loss's (25b's check), which the unsharded kernel "
        f"loss (#8) meets within {rel:.2e} relative (tol "
        f"{ROUTE_LOSS_RTOL}) and its gradients within {ulps:.2f} eps "
        f"|logZ| (tol max({BANDED_GRAD_RTOL}, {GRAD_ULPS} eps |logZ|) + "
        f"{BANDED_GRAD_ATOL}, phase 24's rule); hops a walk U/K + n - 1 "
        f"asserted by the tool")
    return {"lattice_bidir": steps + 1}


def triage_tool_phase(work, smi: str) -> None:
    """28c."""
    from ssnt_tts_tpu_torch.scripts import weak_scaling_triage as triage

    n, per, (Tn, Un) = 4, 8, (32, 80)
    got = {}
    rec = triage.main(
        ["--devices", str(n), "--per-device-batch", str(per), "--seq",
         str(Tn), str(Un), "--steps", str(TRIAGE_STEPS), "--full",
         "--job-dir", str(work / "triage"), "--json",
         str(work / "triage.json")],
        outputs=got)
    rows = {"sharded": per, "unsharded": per * n}
    routes = []
    for name, ranks in got.items():
        for arm in (triage.ARMS if name == "sharded"
                    else triage.UNSHARDED_ARMS):
            r = rows[name] * (4 if arm == "D_train_4x_batch" else 1) * (
                2 if arm == "E_data_x_model" else 1)
            want = ({} if arm in ("C_allreduce", "G_optimizer_only",
                                  "I_model_grad_no_lattice")
                    else lattice_launches(r, Tn, arm != "B_fwd_only"))
            for rank in ranks:
                lat = {k: v for k, v in rank[arm]["launches"].items()
                       if k.startswith("lattice_")}
                if lat != want:
                    raise AssertionError(f"28c {name} {arm}: lattice "
                                         f"launches a call {lat}, not "
                                         f"{want}")
            routes.append(f"{name} {arm} {triage.lattice_route(want)}")
    log(f"[28c weak_scaling_triage] {smi}: record: {json.dumps(rec)}")
    log(f"[28c weak_scaling_triage] ModelConfig(), {n} ranks x {per} rows, "
        f"T={Tn} U={Un}: each arm's lattice launches a call, every rank, "
        f"exactly its route's: " + "; ".join(routes))


def proof_tool_phase(work, smi: str) -> None:
    """28d."""
    from ssnt_tts_tpu_torch.scripts import weak_scaling_proof

    got = {}
    rec = weak_scaling_proof.main(
        ["--devices", *map(str, PROOF_DEVICES), "--per-device-batch", "8",
         "--seq", "32", "80", "--steps", str(TOOL_STEPS), "--full",
         "--job-dir",
         str(work / "proof"), "--json", str(work / "proof.json")],
        outputs=got)
    for run in rec["runs"]:
        n = run["devices"]
        if (abs(run["total_flops_vs_unsharded"] - 1) > 1e-3
                or run["allreduce_ops"] != 2):
            raise AssertionError(f"28d n={n}: {run}")
        for rank in got[n]:
            if rank["launches"] != lattice_launches(32 // n, 32, True):
                raise AssertionError(f"28d n={n}: the counted step's "
                                     f"launches {rank['launches']}")
    log(f"[28d weak_scaling_proof] {smi}: record: {json.dumps(rec)}")
    log(f"[28d weak_scaling_proof] {TOOL_STEPS} timed steps (JAX's 10, cut "
        f"for time); total counted FLOPs at n = "
        f"{', '.join(map(str, PROOF_DEVICES[1:]))} within "
        f"1e-3 of n = 1's (the matrix products only: the lattice kernels "
        f"and elementwise operations are not counted); 2 all_reduces a "
        f"step; one #8 launch in each rank's counted step")


def tools_slice_phase(dev, smi: str) -> dict:
    """Phase 28: profile_decode, tshard_bench, weak_scaling_triage and
    weak_scaling_proof on the card. Every count is zeroed before and read
    after; returns the JSON line's additions by entry name."""
    t_phase = time.time()
    work = pathlib.Path("build") / "chip_smoke" / "tools"
    work.mkdir(parents=True, exist_ok=True)
    zero_counts()
    want = {}
    for name, fn in (("28a", lambda: profile_phase(work, dev, smi)),
                     ("28b", lambda: tshard_phase(work, dev, smi)),
                     ("28c", lambda: triage_tool_phase(work, smi)),
                     ("28d", lambda: proof_tool_phase(work, smi))):
        want.update(fn() or {})
        lap(name)
    got = read_counts()
    expect_counts("phase 28", got, want)
    log(f"[28 launches] phase 28's own path, counted apart from phases "
        f"1-27 (this process; the ranks' launches are checked above): "
        + ", ".join(f"{k} {v}" for k, v in got.items())
        + f"; #10 beam_search_step_batched's first launches on a path")
    log(f"[28] done in {time.time() - t_phase:.1f}s")
    out = {TOOL_ENTRIES[k]: {"launches_phase28": v} for k, v in got.items()}
    out["beam_v1_step"]["launches"] = got["beam_search_step_batched"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 1
    from ssnt_tts_tpu_torch import convert
    from ssnt_tts_tpu_torch.bench_fused import host_us
    from ssnt_tts_tpu_torch.ops import _build, beam_fused
    from ssnt_tts_tpu_torch.utils.config import ModelConfig, V2BeamConfig

    # True float32 on the plain path: no TF32 in matmuls or convolutions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = _LAP[0] = _LAP[1] = time.time()

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

    lap("1 device")
    # ---- 2. build ----
    # nvcc runs in other processes: meanwhile this one imports
    # torch._dynamo (which the first step through torch.utils.checkpoint
    # would import) and makes the models and requests.
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        built = pool.submit(_build.build_all, list(SOURCES))
        importlib.import_module("torch._dynamo")

        cfg = ModelConfig(**SERVE_CFG)
        tree = convert.random_flax_tree(cfg, args.seed)
        models = {dt: make_model(cfg, tree, name, dev) for dt, name in
                  ((torch.float32, "float32"), (torch.bfloat16, "bfloat16"))}
        rng = np.random.default_rng(args.seed)
        reqs = [make_request(rng, cfg.vocab_size, dev) for _ in range(3)]
        built.result()
    _build.fused_class_library()
    _build.fused_v1_library()
    _build.beam_step_library()
    _build.lattice_library()
    log(f"[2 build] {', '.join(f'{n}.cu' for n in SOURCES)} built/loaded "
        f"in {time.time() - t0:.1f}s (nvcc at once, each: "
        + (", ".join(f"{n} {t:.1f}s" for n, t in _build.BUILD_SECONDS.items())
           or "none, all built before") + ")")
    for name in SOURCES:
        for ln in _build.build_log(name).splitlines():
            if ("registers" in ln or "spill" in ln or "Compiling" in ln
                    or "smem" in ln):
                log(f"[2 build] {name} ptxas: {ln.strip()}")
    lib_c, lib_v1 = _build.fused_class_library(), _build.fused_v1_library()
    for bf16 in (0, 1):
        for Wn in (1, W, 16, 32, 128):
            log(f"[2 build] fused steps {('f32', 'bf16')[bf16]} W={Wn}: "
                f"cluster of {lib_c.ssnt_fused_cluster_blocks()} blocks per "
                f"utterance ({B * lib_c.ssnt_fused_cluster_blocks()} blocks "
                f"at B={B}), 256 threads, dynamic shared memory per block: "
                f"class {lib_c.ssnt_fused_class_smem_bytes(bf16, Wn, 10, 256)}"
                f" B, v1 {lib_v1.ssnt_fused_v1_smem_bytes(bf16, Wn, 256, 80, 64)}"
                f" B (16 KB weight-ring slots included)")

    lap("2 build")

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

    lap("3")
    # ---- 4. serve (the main path) ----
    bf = models[torch.bfloat16]
    req_cfgs = [None, None, V2BeamConfig(final_feasible_guard=True)]
    zero_counts()
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

    lap("4")
    # ---- 5. kernel vs plain over the whole path ----
    for dt, model in models.items():
        agree = []
        for i, (req, c) in enumerate(zip(reqs, req_cfgs)):
            fused = served[i] if dt == torch.bfloat16 else serve(
                model, req, config=c)[0]
            plain = serve(model, req, config=c, fuse_model=False,
                          use_pallas=False)[0]
            agree.append((fused["durations"] == plain["durations"])
                         .all(dim=2).all(dim=1).float().mean().item())
        log(f"[5 path] {str(dt)[6:]}: utterances whose durations agree, "
            f"kernel vs plain, per request: "
            + ", ".join(f"{a:.3f}" for a in agree))

    lap("5")
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
        k_host = host_us(lambda: beam_fused.fused_class_beam_step(*step_args))
    log(f"[6 time] {smi}: v2 step B={B} W={W} bf16, device time per step "
        f"(CUDA graph): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms; eager "
        f"per call: kernel {k_eager:.4f} ms, plain {p_eager:.4f} ms; host "
        f"time per kernel call (no synchronize) {k_host:.1f} us")
    for fm, label in ((None, "kernel"), (False, "plain")):
        route = dict(fuse_model=fm, use_pallas=fm)
        serve(bf, reqs[0], **route)  # warm
        ms = {}
        serve(bf, reqs[0], times=ms, **route)
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
        "source": "ssnt_tts_tpu_torch/csrc/fused_class_step.cu",
        "replaces": "ssnt_tts_tpu/ops/beam_fused.py:486",
        "launches": launches,
        "max_abs_err": max(worst[torch.float32]),
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": v2_bound[0], "bound_by": v2_bound[1],
        "library_ms": None,
    }]
    lap("6")
    kernels += train_phases(args.seed, dev, smi)
    lap("9")
    kernels += tone_phases(args.seed, dev, smi, models, reqs[0])
    lap("13")
    kernels += v1_phases(args.seed, dev, smi, models)
    lap("17")
    kernels += exp_phases(args.seed, dev, smi)
    lap("20")
    kernels += banded_phases(args.seed, dev, smi)
    lap("23")
    long_phase(args.seed, dev)
    lap("24")
    distribution_phase(args.seed, dev, smi)
    lap("25b witness")
    utilities_phase(args.seed, dev, smi)
    extra = wide_phase(args.seed, dev, smi, models)
    lap("27a")
    for entry in kernels:
        entry.update(extra.get(entry["name"], {}))
    scale_phase(dev, smi)
    lap("27b")
    triage_phase(dev)
    lap("27c")
    extra = tools_slice_phase(dev, smi)
    for entry in kernels:
        entry.update(extra.get(entry["name"], {}))
    log(json.dumps({"kernels": kernels}))
    log(f"[done] {time.time() - t_start:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
