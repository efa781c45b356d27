"""Where the fused decode steps spend their time, stage by stage.

    python3 -m ssnt_tts_tpu_torch.probe_fused [--no-dot] [--cluster N]
        [--json OUT]

`ncu` and `nsys` do not run on the machines this port is measured on, so
this probe builds a copy of csrc/fused_class_step.cu and
csrc/fused_v1_step.cu (under build/probe_fused/, which .gitignore lists)
with thread 0 of each block writing the %globaltimer (ns; it ticks in
steps of about 0.26 us on an H100) at fixed points: the kernel's start,
after the ring's first copies are issued, after the prologue's loads,
after each cluster barrier, around each weight-ring slot (wait done, slot
released), before the candidates, after the selection, at the end. It then
runs the v2 step and the v1 step at chip_smoke.py's model (bf16, B=32,
W=8) and prints, over the blocks, the median time of each stamp from the
block's start, each slot's wait and work, the spread of the blocks' start
times (a second wave of clusters shows as a jump) and the device time
under a CUDA graph; with the toolkit's cuobjdump, each kernel's SASS
instruction count.

--no-dot skips the tile products (the weight stream, the barriers and the
rest remain); --cluster N packs and builds for N blocks per utterance.
The stamped copy is found by text anchors in the sources and the probe
stops if one is missing. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ssnt_tts_tpu_torch.ops import _build, beam_fused

OUT_DIR = _build.BUILD_DIR.parent / "probe_fused"
STAMPS = 128  # per block: 0-7 marks, 8 + 2p / 9 + 2p slot p, 125-127 tail
BLOCKS = 256
START, RING, LOADS, CAND, SELECTED, END = 0, 1, 2, 125, 126, 127

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
'''


def patch(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) < count:
        raise SystemExit(f"probe_fused: anchor not found: {old[:60]!r}")
    return text.replace(old, new, count)


def stamped_sources(dst: Path, no_dot: bool, cluster: int) -> None:
    """Copy csrc/ to dst with the stamps (and the variant) written in."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(_build.CSRC, dst)
    g = (dst / "gru_step.cuh").read_text()
    g = patch(g, '#include "beam_select.cuh"\n', HEADER)
    g = patch(g, "    mbar_wait(&full[s], (piece / nst) & 1);\n",
              "    mbar_wait(&full[s], (piece / nst) & 1);\n"
              "    if (piece < 58) PROBE(8 + 2 * piece);\n")
    g = patch(g, "  __device__ void release() {\n    __syncthreads();\n",
              "  __device__ void release() {\n    __syncthreads();\n"
              "    if (piece < 58) PROBE(9 + 2 * piece);\n")
    g = patch(g, "constexpr int kCL = 2;", f"constexpr int kCL = {cluster};")
    if no_dot:
        g = patch(g, "    if (active) {  // this warp's tiles",
                  "    if (false) {  // this warp's tiles")
    (dst / "gru_step.cuh").write_text(g)

    common = [
        ("  const int b = blockIdx.x / kCL, tid = threadIdx.x;\n",
         f"  const int b = blockIdx.x / kCL, tid = threadIdx.x;\n"
         f"  PROBE({START});\n"),
        ("  ring.start();\n", f"  ring.start();\n  PROBE({RING});\n"),
        ("  cluster_arrive();  // this block's buffers are ready for its "
         "peers\n  __syncthreads();\n",
         "  cluster_arrive();  // this block's buffers are ready for its "
         f"peers\n  __syncthreads();\n  PROBE({LOADS});\n"),
    ]
    for name, cand, sel, end in (
            ("fused_class_step.cu", "  // ---- 2. candidate grid",
             "  if (rank == 0) {\n    write_selected(sel, b, W, D, a.out);",
             "nh_s[(sel.src[j] / D) * U + c];\n  }\n}"),
            ("fused_v1_step.cu", "  // ---- 2. candidates, 3. selection",
             "  if (rank == 0) {\n    write_selected(sel, b, W, 2, a.out);",
             "mel_s[parent * UM + c];\n  }\n}")):
        v = (dst / name).read_text()
        for old, new in common:
            v = patch(v, old, new)
        parts = v.split("  cluster_sync();\n")
        v = parts[0] + "".join(f"  cluster_sync();\n  PROBE({3 + i});\n" + p
                               for i, p in enumerate(parts[1:]))
        v = patch(v, cand, f"  PROBE({CAND});\n" + cand)
        v = patch(v, sel, f"  PROBE({SELECTED});\n" + sel)
        v = patch(v, end, end[:-1] + f"  PROBE({END});\n}}")
        (dst / name).write_text(v + READ)


def stage_report(name: str, fn, lib, graph_ms) -> dict:
    buf = np.zeros(BLOCKS * STAMPS, dtype=np.uint64)
    with torch.no_grad():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        buf[:] = 0
        if lib.ssnt_probe_read(buf.ctypes.data) != 0:
            raise RuntimeError("probe read failed")
        fn()
        torch.cuda.synchronize()
        if lib.ssnt_probe_read(buf.ctypes.data) != 0:
            raise RuntimeError("probe read failed")
        ms = graph_ms(fn)
    t = buf.reshape(BLOCKS, STAMPS).astype(np.float64)
    t = t[t[:, START] > 0]
    rel = lambda i: float(np.median(t[:, i] - t[:, START]) / 1e3)
    marks = {i: rel(i) for i in list(range(8)) + [CAND, SELECTED, END]
             if t[:, i].any()}
    slots = [p for p in range(58) if t[:, 9 + 2 * p].any()]
    waits = [rel(8 + 2 * p) - (rel(7 + 2 * p) if p else rel(LOADS))
             for p in slots]
    work = [rel(9 + 2 * p) - rel(8 + 2 * p) for p in slots]
    starts = np.sort(t[:, START] - t[:, START].min()) / 1e3
    out = {"graph_ms": ms, "blocks": int(len(t)),
           "start_spread_us": float(starts[-1]),
           "marks_us": marks, "slot_wait_us": waits, "slot_work_us": work}
    print(f"== {name}: device {ms:.4f} ms per call (CUDA graph); {len(t)} "
          f"blocks, start spread {starts[-1]:.2f} us")
    print("   stamps (median us after the block's start; 0 start, 1 ring "
          "issued, 2 loads, 3.. cluster barriers, 125 candidates, 126 "
          "selected, 127 end): "
          + ", ".join(f"{i}: {v:.2f}" for i, v in marks.items()))
    print("   slot wait us: " + " ".join(f"{x:.2f}" for x in waits))
    print("   slot work us: " + " ".join(f"{x:.2f}" for x in work))
    return out


def sass_counts() -> dict:
    """SASS instructions of each kernel instance, where cuobjdump exists."""
    tool = Path(_build.find_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    counts = {}
    for src in ("fused_class_step", "fused_v1_step"):
        r = subprocess.run([str(tool), "-sass", str(_build.build(src))],
                           capture_output=True, text=True, check=False)
        cur = None
        for ln in r.stdout.splitlines():
            if "Function :" in ln:
                cur = f"{src}:{ln.split('Function :')[1].strip()}"
                counts[cur] = 0
            elif cur and ln.strip().startswith("/*") and "*/" in ln:
                counts[cur] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-dot", action="store_true")
    ap.add_argument("--cluster", type=int, default=beam_fused.CLUSTER)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
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

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    cfg = ModelConfig(**cs.SERVE_CFG)
    model = cs.make_model(cfg, convert.random_flax_tree(cfg, 0), "bfloat16",
                          dev)
    rng = np.random.default_rng(0)
    req = cs.make_request(rng, cfg.vocab_size, dev)
    toks, il, _ = req
    sa = cs.step_inputs(model, req, 30, rng, dev)
    pack, fw, kept = cs.v1_carries(model, toks, il, (100,), cs.W, dev)
    c = kept[100]
    fa = (pack, c["t"], c["u"], c["lp"], c["fin"], il, c["pm"], c["state"],
          fw)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"probe_fused {tag} on {smi}")
    out = {"card": smi, "variant": tag, "stages": {
        "fused_v2_step": stage_report(
            "fused_v2_step B=32 W=8 bf16",
            lambda: beam_fused.fused_class_beam_step(*sa), libs[0],
            cs.graph_ms),
        "fused_v1_step": stage_report(
            "fused_v1_step B=32 W=8 bf16",
            lambda: beam_fused.fused_v1_beam_step(*fa), libs[1],
            cs.graph_ms)}}
    out["sass_instructions"] = sass_counts()
    for k, v in out["sass_instructions"].items():
        print(f"   SASS {k}: {v} instructions")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
