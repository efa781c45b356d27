"""Time the fused decode kernels, the beam-only steps, the banded lattice
walks and the exp-native pass of one or more checkouts, in turns.

    python3 ssnt_tts_tpu_torch/bench_fused.py [--roots DIR ...] [--json OUT]

For each root (a checkout of this repository; default the one this file
is in), in the order given, the fused steps at chip_smoke.py's model
(decoder 256, mel 80, joint rank 64, bf16, random weights from seed 0)
and batch (B=32, T=80):
  - #15 fused_v1_beam_step at W=1, 8 and 16 (the narrow instances) and
    at W=32 and 128 (the wide ones) on a request's own carry at frame 100;
  - #14 fused_class_beam_step (v2) and fused_tone_step at W=8, 32 and
    128, step 30;
  - the beam-only steps at W=8, 32 and 128 (above 16 the wide instance,
    csrc/beam_select.cuh wide_select): #11 beam_search_step_reorder (F =
    418 rows), #10 beam_search_step_batched, #13 tone (K=8, H=256) and #12
    v2 (D=10 and D=16, H=256);
  - torch.sort(stable=True) of (B=32, L) float32 keys at the sort lengths
    of those wide grids (L = 512 and 2048), a yardstick for the wide
    selection's sort stage alone (no call of the port makes it);
each as device time per call under a CUDA graph (chip_smoke.graph_ms),
eager time per call with a synchronize at the end (chip_smoke.eager_ms)
and host time per call (the wrapper's own cost: the median of 5 runs of
200 calls issued without a synchronize, host clock); then, device time
only, the launch floor (an in-place add on a one-element tensor), and at
B=32 and B=256 (T=80, U=400, f32) the banded forward #2 and the banded
backward gradients #6 at each K in chip_smoke.BANDS beside the plain
forward alphas #1, the exp-native pass #9 and the exp-domain
bidirectional pass #4, at B=32 and B=64 the log-domain bidirectional
pass #8, and the two-pass route's forward alphas #1 and backward
gradients #5 at B=256 (float32 and bfloat16 storage) and B=128 (float32),
with, where a root has them, their block walks at the same shapes
(ssnt_lattice_forward_alphas_block / _backward_grads_block, which only
this script, chip_smoke.py and the probes call), the betas-only pass #3
at B=32 and B=256 (its entry: the warp walk, or in a checkout from
before it the block walk; and, where the root has
ssnt_lattice_backward_betas_block, its block walk), and the block walks at one thread a position of #8, #1,
#5, #4 and #9 at T = chip_smoke.T_BLOCK_WALK (200), B=8. Give the roots as
parent, change, change, parent to compare two commits on one card. Each root's package and
chip_smoke.py are imported afresh, so each times its own wrappers and
kernels (built into the root's own build/ directory).

    python3 ssnt_tts_tpu_torch/bench_fused.py --split [--roots DIR ...]

instead prints #2's and #6's device time by CUDA kernel at each K and B
(torch.profiler over 10 calls of each, one session per batch size: the
passes of the split design, or the one kernel of the design before it).
Give it a process of its own: after a few profiler sessions in one
process the later ones record nothing.

After the timings, the fused wide steps' float outputs at fixed inputs,
the same for every root: #14 v2 and tone at W=32 (step 30, h and new_h)
and #15 at W=24 on a carry driven 20 frames by the plain step (h, new_h,
mel), each root's largest difference from the plain step and from the
first root's outputs (0 where two roots agree bit for bit).

Prints one JSON object per root and call, then the card's name and power
limit; --json writes them all. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def host_us(fn, n: int = 200, reps: int = 5) -> float:
    """Host microseconds per call of fn, issued without a synchronize: the
    median of reps runs of n calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return sorted(runs)[reps // 2]


def load(root: Path):
    """Import root's chip_smoke and package afresh."""
    for name in list(sys.modules):
        if name == "chip_smoke" or name.startswith("ssnt_tts_tpu_torch"):
            del sys.modules[name]
    sys.path[0] = str(root)
    importlib.invalidate_caches()
    cs = importlib.import_module("chip_smoke")
    beam_fused = importlib.import_module("ssnt_tts_tpu_torch.ops.beam_fused")
    return cs, beam_fused


def bench_root(root: Path, dev) -> tuple:
    import numpy as np
    import torch

    cs, beam_fused = load(root)
    from ssnt_tts_tpu_torch import convert
    from ssnt_tts_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(**cs.SERVE_CFG)
    model = cs.make_model(cfg, convert.random_flax_tree(cfg, 0), "bfloat16",
                          dev)
    rng = np.random.default_rng(0)
    req = cs.make_request(rng, cfg.vocab_size, dev)
    toks, il, _ = req
    fns = {}
    for Wn in (1, 8, 16, 32, 128):
        pack, fw, kept = cs.v1_carries(model, toks, il, (100,), Wn, dev)
        c = kept[100]
        args = (pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"],
                c["state"], fw)
        fns[f"fused_v1_step W={Wn}"] = (
            lambda a=args: beam_fused.fused_v1_beam_step(*a))
    for Wn in (8, 32, 128):
        sa = cs.step_inputs(model, req, 30, rng, dev, Wn=Wn)
        fns[f"fused_v2_step W={Wn}"] = (
            lambda a=sa: beam_fused.fused_class_beam_step(*a))
        ta = cs.tone_step_inputs(model, toks, il, 30, rng, dev, Wn)
        fns[f"fused_tone_step W={Wn}"] = (
            lambda a=ta: beam_fused.fused_tone_step(*a))
    fns.update(beam_only_fns(cs, cfg, req, rng, dev))
    out = {}
    with torch.no_grad():
        for name, fn in fns.items():
            out[name] = {"graph_ms": cs.graph_ms(fn),
                         "eager_ms": cs.eager_ms(fn),
                         "host_us": host_us(fn)}
        one = torch.zeros(1, device=dev)
        out["launch floor"] = {"graph_ms": cs.graph_ms(lambda: one.add_(1))}
        for name, fn in lattice_fns(cs, rng, dev).items():
            out[name] = {"graph_ms": cs.graph_ms(fn, k=20, reps=10)}
    return out, wide_outputs(cs, beam_fused, model, req, dev)


def wide_outputs(cs, beam_fused, model, req, dev) -> dict:
    """The wide steps' (kernel, plain) float outputs at inputs every root
    builds alike: #14 v2 / tone at W=32, step 30, and #15 at W=24 on the
    carry after 20 frames of the plain step."""
    import numpy as np
    import torch

    toks, il, _ = req
    rng = np.random.default_rng(1)
    kinds = {
        "fused_v2_step W=32": (beam_fused.fused_class_beam_step,
                               beam_fused.fused_class_beam_step_reference,
                               cs.step_inputs(model, req, 30, rng, dev, Wn=32)),
        "fused_tone_step W=32": (beam_fused.fused_tone_step,
                                 beam_fused.fused_tone_step_reference,
                                 cs.tone_step_inputs(model, toks, il, 30, rng,
                                                     dev, 32)),
    }
    pack, fw, kept = cs.v1_carries(model, toks, il, (0,), 24, dev)
    c = kept[0]
    for _ in range(20):
        o = beam_fused.fused_v1_beam_step_reference(
            pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"], c["state"],
            fw)
        c = dict(t=o.next_t, u=o.next_u, lp=o.log_prob, fin=o.is_finished,
                 pm=o.mel, state=o.state)
    out = {}
    with torch.no_grad():
        for name, (kern, ref, args) in kinds.items():
            B, W, H = args[5].shape
            dbg = lambda: (torch.empty(B, W, args[2].shape[2], device=dev),
                           torch.empty(B, W, H, device=dev))
            k, r = dbg(), dbg()
            kern(*args, debug_out=k)
            ref(*args, debug_out=r)
            out[name] = (k, r)
        fa = (pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"], c["state"])
        dims = (2, c["state"].shape[2], c["pm"].shape[2])
        k = tuple(torch.empty(*c["t"].shape, n, device=dev) for n in dims)
        r = tuple(torch.empty_like(x) for x in k)
        beam_fused.fused_v1_beam_step(*fa, fw, debug_out=k)
        beam_fused.fused_v1_beam_step_reference(*fa, fw, debug_out=r)
        out["fused_v1_step W=24 frame 20"] = (k, r)
        torch.cuda.synchronize()
    return {n: tuple(tuple(x.cpu() for x in t) for t in v)
            for n, v in out.items()}


def parity(outputs: list) -> list:
    """Per root and wide step: the largest |kernel - plain| and |kernel -
    first root's kernel| of each float output."""
    rows = []
    for i, outs in enumerate(outputs):
        for name, (k, r) in outs.items():
            first = outputs[0][name][0]
            rows.append({
                "root": i, "step": name,
                "vs_plain": [float((a - b).abs().max()) for a, b in zip(k, r)],
                "vs_first_root": [float((a - b).abs().max())
                                  for a, b in zip(k, first)]})
    return rows


def split_root(root: Path, dev) -> dict:
    """#2's and #6's device microseconds per call by CUDA kernel, at each
    batch size: every K and direction in one profiler session (their
    kernels' names carry K and the direction)."""
    import numpy as np
    import torch

    cs, _ = load(root)
    rng = np.random.default_rng(0)
    fns = {name: fn for name, fn in lattice_fns(cs, rng, dev).items()
           if "banded" in name}
    with torch.no_grad():
        return {f"B={Bn}": kernel_split(
            [fn for name, fn in fns.items() if name.endswith(f" B={Bn}")])
            for Bn in (cs.B, cs.B_LARGE)}


def kernel_split(fns, n: int = 10) -> dict:
    """Device microseconds per call of each CUDA kernel the fns launch
    (torch.profiler, n calls of each after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_time_total > 0 and e.count >= n:
            split[e.key[:100]] = e.device_time_total / n
    return split


def beam_only_fns(cs, cfg, req, rng, dev) -> dict:
    """#11, #10, #13 and #12 (D = 10 and 16) at chip_smoke's batch (B=32)
    and W = 8, 32 and 128, and torch.sort beside them."""
    import torch

    bk = importlib.import_module("ssnt_tts_tpu_torch.ops.beam_kernels")
    H, M = cfg.decoder_dim, cfg.mel_dim
    D, K = cfg.duration_class_size, cfg.tone_class_size
    _, il, ol = req
    fns = {}
    for Wn in (8, 32, 128):
        x1 = cs.v1_beam_only_inputs(rng, 40, Wn, il, H + 2 * M + 2, dev)
        a1 = (x1["h"], x1["lp"], x1["fin"], x1["t"], x1["u"], x1["il"])
        fns[f"beam_v1_step_reorder W={Wn} F=418"] = (
            lambda a=a1, st=x1["state"]: bk.beam_search_step_reorder(*a, st))
        fns[f"beam_v1_step W={Wn}"] = (
            lambda a=a1: bk.beam_search_step_batched(*a))
        for Dn in (D, 16):
            x2 = cs.beam_only_inputs(rng, 30, Wn, Dn, K, H, il, ol, dev)
            dtab = torch.arange(Dn, dtype=torch.int32, device=dev)
            if Dn == D:
                at = (x2["h_tone"], x2["lp"], x2["fin"], x2["t"], x2["u"],
                      x2["il"])
                fns[f"tone_beam_step W={Wn}"] = (
                    lambda a=at, st=x2["state"]:
                    bk.tone_beam_search_decode(*a, state=st))
            a2 = (x2["h"], x2["lp"], x2["fin"], x2["tot"], dtab, x2["t"],
                  x2["u"], x2["il"], x2["ol"])
            fns[f"v2_beam_step W={Wn}" + ("" if Dn == D else f" D={Dn}")] = (
                lambda a=a2, st=x2["state"]:
                bk.v2_beam_search_decode(*a, state=st))
    for L in (512, 2048):
        keys = torch.randn(cs.B, L, device=dev)
        fns[f"torch.sort stable B={cs.B} L={L}"] = (
            lambda k=keys: torch.sort(k, dim=1, descending=True, stable=True))
    return fns


def lattice_fns(cs, rng, dev) -> dict:
    """#2 and #6 at each K, #1, #9 and #4 at B=32 and B=256, #8 at B=32
    and B=64 (the largest batch the "fused" route takes at T=80) (T=80,
    U=400, f32; #6 on #1's alphas and their logZ, g = 1), and #1 and #5
    at B=256 (f32, bf16) and B=128 (f32), by their block walks too where
    the root has them (#5 on #1's alphas, g = 1)."""
    import torch

    lk = importlib.import_module("ssnt_tts_tpu_torch.ops.lattice_kernels")
    lat = importlib.import_module("ssnt_tts_tpu_torch.ops.lattice")
    fns = {}
    for Bn in (cs.B, cs.B_LARGE):
        (le, ls, lf), (il, ol) = cs.lattice_inputs(rng, Bn, torch.float32,
                                                   dev)
        x = (le, ls, lf)
        a = lk.lattice_forward_alphas(*x)
        bwd = (a, il, ol, torch.ones(Bn, device=dev),
               lat.gather_logz(a, le, il, ol))
        fns[f"lattice_forward_alphas B={Bn}"] = (
            lambda x=x: lk.lattice_forward_alphas(*x))
        for K in cs.BANDS:
            fns[f"lattice_forward_alphas_banded K={K} B={Bn}"] = (
                lambda x=x, K=K: lk.lattice_forward_alphas_banded(*x, K))
            fns[f"lattice_backward_grads_banded K={K} B={Bn}"] = (
                lambda x=x, bwd=bwd, K=K:
                lk.lattice_backward_grads_banded(*x, *bwd, K))
        e, logs, (il, ol) = cs.exp_lattice_inputs(rng, Bn, dev)
        fns[f"lattice_expin B={Bn}"] = (
            lambda e=e, il=il, ol=ol: lk.lattice_expin(*e, il, ol))
        fns[f"lattice_bidir_exp B={Bn}"] = (
            lambda x=logs, il=il, ol=ol: lk.lattice_bidir_exp(*x, il, ol))
    for Bn in (cs.B, 2 * cs.B):
        x, (il, ol) = cs.lattice_inputs(rng, Bn, torch.float32, dev)
        fns[f"lattice_bidir B={Bn}"] = (
            lambda x=x, il=il, ol=ol: lk.lattice_bidir(*x, il, ol))
    blocks = hasattr(cs, "block_backward_grads")
    for Bn, dt in ((cs.B_LARGE, torch.float32), (cs.B_LARGE, torch.bfloat16),
                   (cs.B_LARGE // 2, torch.float32)):
        x, (il, ol) = cs.lattice_inputs(rng, Bn, dt, dev)
        a = lk.lattice_forward_alphas(*x)
        bwd = (a, il, ol, torch.ones(Bn, device=dev),
               lat.gather_logz(a, x[0], il, ol))
        tag = f"{str(dt)[6:]} B={Bn}"
        fns[f"two-pass forward alphas {tag}"] = (
            lambda x=x: lk.lattice_forward_alphas(*x))
        fns[f"two-pass backward grads {tag}"] = (
            lambda x=x, bwd=bwd: lk.lattice_backward_grads(*x, *bwd))
        if blocks:
            fns[f"two-pass forward alphas block walk {tag}"] = (
                lambda x=x: cs.block_forward_alphas(*x))
            fns[f"two-pass backward grads block walk {tag}"] = (
                lambda x=x, bwd=bwd: cs.block_backward_grads(*x, *bwd))
    # #3 at T=80 (its entry's walk, and its block walk where the root has
    # ssnt_lattice_backward_betas_block), and the block walks at one thread
    # a position of every log- and exp-domain kernel at T =
    # chip_smoke.T_BLOCK_WALK (B=8).
    for Bn in (cs.B, cs.B_LARGE):
        x, (il, ol) = cs.lattice_inputs(rng, Bn, torch.float32, dev)
        fns[f"lattice_backward_betas B={Bn}"] = (
            lambda x=x, il=il, ol=ol: lk.lattice_backward_betas(*x, il, ol))
        if hasattr(cs, "block_backward_betas"):
            fns[f"lattice_backward_betas block walk B={Bn}"] = (
                lambda x=x, il=il, ol=ol: cs.block_backward_betas(*x, il, ol))
    Tb = cs.T_BLOCK_WALK
    x, (il, ol) = cs.lattice_inputs(rng, 8, torch.float32, dev, Tb)
    a = lk.lattice_forward_alphas(*x)
    bwd = (a, il, ol, torch.ones(8, device=dev),
           lat.gather_logz(a, x[0], il, ol))
    e, logs, (eil, eol) = cs.exp_lattice_inputs(rng, 8, dev, Tb)
    fns.update({
        f"block walk T={Tb} B=8 lattice_bidir":
            lambda: lk.lattice_bidir(*x, il, ol),
        f"block walk T={Tb} B=8 lattice_forward_alphas":
            lambda: lk.lattice_forward_alphas(*x),
        f"block walk T={Tb} B=8 lattice_backward_grads":
            lambda: lk.lattice_backward_grads(*x, *bwd),
        f"block walk T={Tb} B=8 lattice_bidir_exp":
            lambda: lk.lattice_bidir_exp(*logs, eil, eol),
        f"block walk T={Tb} B=8 lattice_expin":
            lambda: lk.lattice_expin(*e, eil, eol)})
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE)])
    ap.add_argument("--json", default=None)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_fused: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results, outputs = [], []
    for i, root in enumerate(args.roots):
        t0 = time.time()
        if args.split:
            kernels = split_root(Path(root).resolve(), dev)
        else:
            kernels, wide = bench_root(Path(root).resolve(), dev)
            outputs.append(wide)
        r = {"call": i, "root": root, "kernels": kernels,
             "seconds": time.time() - t0}
        print(json.dumps(r), flush=True)
        results.append(r)
    rows = parity(outputs)
    for row in rows:
        print(json.dumps({"parity": row}), flush=True)
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "runs": results, "parity": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
