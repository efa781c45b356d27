"""Where the fused decode steps spend their time, stage by stage.

    python3 -m ssnt_tts_tpu_torch.probe_fused [--no-dot] [--cluster N]
        [--widths W ...] [--json OUT]

`ncu` and `nsys` do not run on the machines this port is measured on, so
this probe builds a copy of csrc/fused_class_step.cu and
csrc/fused_v1_step.cu (under build/probe_fused/, which .gitignore lists)
with thread 0 of each block writing the %globaltimer (ns; it ticks in
steps of about 0.26 us on an H100) at fixed points of each kernel: its
start, after the ring's first copies are issued, after the prologue's
loads, after each cluster barrier, around each weight-ring piece (wait
done, slot released), around each round of the bfloat16 wide instances
(csrc/wide_step.cuh wide_round: entered, left), before the candidates,
after the selection, at the end. It then runs the v2 step and the v1 step
at chip_smoke.py's model (bf16, B=32) at each width (default W=8, the
narrow instances, and W=32 and 128, the wide ones, with the tone step
too) and prints, over the blocks, the median time of each stamp from the
block's start, each piece's wait and work, the spread of the blocks'
start times (a second wave of clusters shows as a jump) and the device
time under a CUDA graph; for a wide instance, a step split into the
prologue, the weight stream (the rounds' time outside their pieces'
products), the dots (the pieces' products), the epilogues and barriers
between rounds, wide_select and the reorder; with the toolkit's
cuobjdump, each kernel's SASS instructions, local-memory loads and
stores, barriers, shuffles and loops (sass_counts).

    python3 -m ssnt_tts_tpu_torch.probe_fused --sass-roots DIR ... [--json OUT]

only builds each root's csrc/ (a checkout of this repository) and prints
those SASS counts for every kernel of csrc/fused_class_step.cu,
csrc/fused_v1_step.cu and csrc/beam_step.cu.

--no-dot skips the tile products (the weight stream, the barriers and the
rest remain); --cluster N packs and builds for N blocks per utterance.
The stamped copy is found by text anchors in the sources and the probe
stops if one is missing. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ssnt_tts_tpu_torch.ops import _build, beam_fused

OUT_DIR = _build.BUILD_DIR.parent / "probe_fused"
# Stamps per block: 0-15 marks (0 start, 1 ring issued, 2 loads, 3.. the
# kernel's cluster barriers in order), 16 + 2p / 17 + 2p weight-ring piece
# p (wait done, slot released; p < 48), 112 + 2r / 113 + 2r wide round r
# (entered, left; r < 24), 189-191 candidates, selected, end.
STAMPS, BLOCKS = 192, 256
START, RING, LOADS = 0, 1, 2
SLOT0, PIECES = 16, 48
ROUND0, ROUNDS = 112, 24
CAND, SELECTED, END = 189, 190, 191
# The kernels the probe runs, which must take every stamp.
PROBED = ("fused_class_step_kernel", "fused_class_wgmma_kernel",
          "fused_v1_step_kernel", "fused_v1_wgmma_kernel")
WIDTHS = (8, 32, 128)

HEADER = f'''#include "beam_select.cuh"
__device__ unsigned long long g_probe[{BLOCKS} * {STAMPS}];
__device__ __forceinline__ unsigned long long probe_time() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define PROBE(i) do {{ if (threadIdx.x == 0 && blockIdx.x < {BLOCKS}) \\
  g_probe[blockIdx.x * {STAMPS} + (i)] = probe_time(); }} while (0)
'''
READ = '''
extern "C" int ssnt_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));
}
extern "C" int ssnt_probe_clear() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_probe);
  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_probe)));
}
'''
WAIT = "    mbar_wait(&full[s], (piece / nst) & 1);\n"
RELEASE = "  __device__ void release() {\n    __syncthreads();\n"
LOADS_AT = ("  cluster_arrive();  // this block's buffers are ready for its "
            "peers\n  __syncthreads();\n")
CAND_AT = ("  // ---- 2. candidate grid", "  // ---- 2. candidates, 3. selection")


def patch(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) < count:
        raise SystemExit(f"probe_fused: anchor not found: {old[:60]!r}")
    return text.replace(old, new, count)


def kernel_bodies(text: str) -> list:
    """(name, start, end) of each __global__ function's body: the text
    between its braces."""
    out, at = [], 0
    while (g := text.find("__global__", at)) >= 0:
        paren = text.index("(", text.index("\n", g))
        name = text[text.rindex("\n", 0, paren) + 1:paren].split()[-1]
        i = text.index("{\n", paren) + 1
        depth, j = 1, i
        while depth:
            j += 1
            depth += {"{": 1, "}": -1}.get(text[j], 0)
        out.append((name, i, j))
        at = j
    return out


def stamp_kernel(name: str, body: str) -> str:
    """One kernel's body with its marks: start, ring issued, loads, each
    cluster barrier, candidates, selected, end. The kernels in PROBED must
    have every anchor."""
    need = name in PROBED

    def at(b, old, new):
        return patch(b, old, new) if need or old in b else b

    body = f"\n  PROBE({START});" + body
    body = at(body, "  ring.start();\n", f"  ring.start();\n  PROBE({RING});\n")
    body = at(body, LOADS_AT, LOADS_AT + f"  PROBE({LOADS});\n")
    parts = body.split("  cluster_sync();\n")
    if len(parts) > SLOT0 - 3 + 1:
        raise SystemExit(f"probe_fused: {name}: too many cluster barriers")
    body = parts[0] + "".join(f"  cluster_sync();\n  PROBE({3 + i});\n" + p
                              for i, p in enumerate(parts[1:]))
    cand = [c for c in CAND_AT if c in body]
    if need and not cand:
        raise SystemExit(f"probe_fused: no candidates anchor in {name}")
    if cand:
        i = body.index(cand[0])
        j = body.index("  if (rank == 0) {\n", i)
        body = (body[:i] + f"  PROBE({CAND});\n" + body[i:j]
                + f"  PROBE({SELECTED});\n" + body[j:])
    return body + f"  PROBE({END});\n"


def stamped_sources(dst: Path, no_dot: bool, cluster: int) -> None:
    """Copy csrc/ to dst with the stamps (and the variant) written in."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_build.CSRC, dst)
    pieces = (f"    if (piece < {PIECES}) PROBE({SLOT0} + 2 * piece);\n",
              f"    if (piece < {PIECES}) PROBE({SLOT0 + 1} + 2 * piece);\n")
    g = (dst / "gru_step.cuh").read_text()
    g = patch(g, '#include "beam_select.cuh"\n', HEADER)
    g = patch(g, WAIT, WAIT + pieces[0])
    g = patch(g, RELEASE, RELEASE + pieces[1])
    g = patch(g, "constexpr int kCL = 2;", f"constexpr int kCL = {cluster};")
    if no_dot:
        g = patch(g, "    if (active) {  // this warp's tiles",
                  "    if (false) {  // this warp's tiles")
    (dst / "gru_step.cuh").write_text(g)
    w = (dst / "wide_step.cuh").read_text()
    w = patch(w, WAIT, WAIT + pieces[0])
    w = patch(w, RELEASE, RELEASE + pieces[1])
    w = patch(w, "  const uint32_t sbo = (uint32_t)Kp * 16;\n",
              "  const uint32_t sbo = (uint32_t)Kp * 16;\n"
              f"  if (r < {ROUNDS}) PROBE({ROUND0} + 2 * r);\n")
    w = patch(w, "    ring.release();\n  }\n}\n",
              "    ring.release();\n  }\n"
              f"  if (r < {ROUNDS}) PROBE({ROUND0 + 1} + 2 * r);\n}}\n")
    if no_dot:
        w = patch(w, "    if (wg < nw) {\n", "    if (false) {\n")
    (dst / "wide_step.cuh").write_text(w)
    for name in ("fused_class_step.cu", "fused_v1_step.cu"):
        v = (dst / name).read_text()
        for kname, i, j in reversed(kernel_bodies(v)):
            v = v[:i] + stamp_kernel(kname, v[i:j]) + v[j:]
        (dst / name).write_text(v + READ)


def stage_report(name: str, fn, lib, graph_ms) -> dict:
    buf = np.zeros(BLOCKS * STAMPS, dtype=np.uint64)
    with torch.no_grad():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        # Only this launch's stamps: another kernel's (the carries') go.
        if lib.ssnt_probe_clear() != 0:
            raise RuntimeError("probe clear failed")
        fn()
        torch.cuda.synchronize()
        if lib.ssnt_probe_read(buf.ctypes.data) != 0:
            raise RuntimeError("probe read failed")
        ms = graph_ms(fn)
    t = buf.reshape(BLOCKS, STAMPS).astype(np.float64)
    t = t[t[:, START] > 0]
    has = lambda i: bool(t[:, i].any())
    rel = lambda i: float(np.median(t[:, i] - t[:, START]) / 1e3)
    marks = {i: rel(i) for i in list(range(SLOT0)) + [CAND, SELECTED, END]
             if has(i)}
    slots = [p for p in range(PIECES) if has(SLOT0 + 1 + 2 * p)]
    waits = [rel(SLOT0 + 2 * p) - (rel(SLOT0 - 1 + 2 * p) if p else rel(LOADS))
             for p in slots]
    work = [rel(SLOT0 + 1 + 2 * p) - rel(SLOT0 + 2 * p) for p in slots]
    starts = np.sort(t[:, START] - t[:, START].min()) / 1e3
    out = {"graph_ms": ms, "blocks": int(len(t)),
           "start_spread_us": float(starts[-1]),
           "marks_us": marks, "slot_wait_us": waits, "slot_work_us": work}
    print(f"== {name}: device {ms:.4f} ms per call (CUDA graph); {len(t)} "
          f"blocks, start spread {starts[-1]:.2f} us")
    print(f"   stamps (median us after the block's start; 0 start, 1 ring "
          f"issued, 2 loads, 3.. cluster barriers, {CAND} candidates, "
          f"{SELECTED} selected, {END} end): "
          + ", ".join(f"{i}: {v:.2f}" for i, v in marks.items()))
    print("   slot wait us: " + " ".join(f"{x:.2f}" for x in waits))
    print("   slot work us: " + " ".join(f"{x:.2f}" for x in work))
    rounds = [r for r in range(ROUNDS) if has(ROUND0 + 1 + 2 * r)]
    if rounds:
        enter = [rel(ROUND0 + 2 * r) for r in rounds]
        leave = [rel(ROUND0 + 1 + 2 * r) for r in rounds]
        dots = sum(work)
        split = {
            "prologue": enter[0],
            "weight stream": sum(b - a for a, b in zip(enter, leave)) - dots,
            "dots": dots,
            "epilogues and barriers": sum(enter[i + 1] - leave[i]
                                          for i in range(len(rounds) - 1))
                                      + marks[CAND] - leave[-1],
            "wide_select": marks[SELECTED] - marks[CAND],
            "reorder": marks[END] - marks[SELECTED],
        }
        out["rounds_us"] = list(zip(enter, leave))
        out["split_us"] = split
        print("   rounds (entered-left us): " + " ".join(
            f"{a:.2f}-{b:.2f}" for a, b in zip(enter, leave)))
        print("   split us: " + ", ".join(f"{k} {v:.2f}"
                                          for k, v in split.items()))
    return out


# The sources sass_counts reads, and the opcodes it counts in each kernel
# instance: local-memory loads and stores (spills, or a register array
# indexed at run time), block barriers and warp shuffles.
SASS_SOURCES = ("fused_class_step", "fused_v1_step", "beam_step")
SASS_OPS = ("LDL", "STL", "BAR.SYNC", "SHFL")
SASS_LINE = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s*(.*?);")


def sass_counts() -> dict:
    """Each kernel instance's SASS (the libraries _build gives now, where
    cuobjdump exists): instructions, SASS_OPS, and loops (branches back
    to an earlier address)."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    counts = {}
    for src in SASS_SOURCES:
        r = subprocess.run([str(tool), "-sass", str(_build.build(src))],
                           capture_output=True, text=True, check=False)
        cur = None
        for ln in r.stdout.splitlines():
            if "Function :" in ln:
                cur = {"instructions": 0, "loops": 0,
                       **{op: 0 for op in SASS_OPS}}
                counts[f"{src}:{ln.split('Function :')[1].strip()}"] = cur
                continue
            m = SASS_LINE.match(ln)
            if cur is None or not m:
                continue
            cur["instructions"] += 1
            words = [w for w in m.group(2).split() if not w.startswith("@")]
            op = words[0] if words else ""
            for name in SASS_OPS:
                cur[name] += op == name or op.startswith(name + ".")
            if op.startswith("BRA") and len(words) > 1:
                target = words[-1].strip("`()")
                if (target.startswith("0x")
                        and int(target, 16) <= int(m.group(1), 16)):
                    cur["loops"] += 1
    return counts


def sass_roots(roots, out_json) -> int:
    """sass_counts of each root's csrc/ (a checkout of this repository),
    built under build/probe_fused/sass/<i>; no kernel runs."""
    out = {}
    for i, root in enumerate(roots):
        _build.CSRC = Path(root).resolve() / "ssnt_tts_tpu_torch" / "csrc"
        _build.BUILD_DIR = OUT_DIR / "sass" / str(i)
        _build.build_all(list(SASS_SOURCES))
        out[root] = sass_counts()
        for k, v in out[root].items():
            print(f"SASS {root} {k}: " + ", ".join(
                f"{n} {c}" for n, c in v.items()), flush=True)
    if out_json:
        Path(out_json).parent.mkdir(parents=True, exist_ok=True)
        Path(out_json).write_text(json.dumps(out, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-dot", action="store_true")
    ap.add_argument("--cluster", type=int, default=beam_fused.CLUSTER)
    ap.add_argument("--widths", type=int, nargs="+", default=list(WIDTHS))
    ap.add_argument("--json", default=None)
    ap.add_argument("--sass-roots", nargs="+", default=None)
    args = ap.parse_args()
    if args.sass_roots:
        return sass_roots(args.sass_roots, args.json)
    if not torch.cuda.is_available():
        print("probe_fused: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(_build.BUILD_DIR.parent.parent))
    import chip_smoke as cs
    from ssnt_tts_tpu_torch import convert
    from ssnt_tts_tpu_torch.utils.config import ModelConfig

    tag = f"{'nodot' if args.no_dot else 'full'}_cl{args.cluster}"
    stamped_sources(OUT_DIR / tag / "csrc", args.no_dot, args.cluster)
    _build.CSRC = OUT_DIR / tag / "csrc"
    _build.BUILD_DIR = OUT_DIR / tag / "lib"
    beam_fused.CLUSTER = args.cluster
    _build.build_all(["fused_class_step", "fused_v1_step"])
    libs = (_build.fused_class_library(), _build.fused_v1_library())
    for lib in libs:
        lib.ssnt_probe_read.argtypes = [ctypes.c_void_p]
        lib.ssnt_probe_read.restype = ctypes.c_int
        lib.ssnt_probe_clear.argtypes = []
        lib.ssnt_probe_clear.restype = ctypes.c_int

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = ModelConfig(**cs.SERVE_CFG)
    model = cs.make_model(cfg, convert.random_flax_tree(cfg, 0), "bfloat16",
                          dev)
    rng = np.random.default_rng(0)
    req = cs.make_request(rng, cfg.vocab_size, dev)
    toks, il, _ = req
    steps = {}
    for Wn in args.widths:
        sa = cs.step_inputs(model, req, 30, rng, dev, Wn=Wn)
        ta = cs.tone_step_inputs(model, toks, il, 30, rng, dev, Wn)
        pack, fw, kept = cs.v1_carries(model, toks, il, (100,), Wn, dev)
        c = kept[100]
        fa = (pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"],
              c["state"], fw)
        steps[f"fused_v2_step B=32 W={Wn} bf16"] = (
            lambda a=sa: beam_fused.fused_class_beam_step(*a), libs[0])
        if Wn > 16:
            steps[f"fused_tone_step B=32 W={Wn} bf16"] = (
                lambda a=ta: beam_fused.fused_tone_step(*a), libs[0])
        steps[f"fused_v1_step B=32 W={Wn} bf16"] = (
            lambda a=fa: beam_fused.fused_v1_beam_step(*a), libs[1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"probe_fused {tag} on {smi}")
    out = {"card": smi, "variant": tag, "stages": {
        name: stage_report(name, fn, lib, cs.graph_ms)
        for name, (fn, lib) in steps.items()}}
    out["sass"] = sass_counts()
    for k, v in out["sass"].items():
        print(f"   SASS {k}: " + ", ".join(f"{n} {c}" for n, c in v.items()))
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
