"""Where the beam-only step kernels (csrc/beam_step.cu) spend their time.

    python3 ssnt_tts_tpu_torch/probe_beam.py [--roots DIR ...] [--json OUT]

For each root (a checkout of this repository; default the one this file
is in), in the order given, this builds a copy of the root's csrc/ under
build/probe_beam/<call>/ (which .gitignore lists) in which both beam-only
kernels, the narrow beam_step_kernel and the wide beam_step_wide_kernel,
write the %globaltimer (ns; it ticks in steps of about 0.26 us on an
H100) at fixed points: 0 the block's start, 1 the rows' bulk copy issued,
2 the candidates computed (thread 0's; the wide kernel's stored in shared
memory), 3 the selection done (block_select / warp_select; wide_select),
4 the selected beams written, 5 the rows landed in shared memory, 6 the
last warp done (the latest of every warp's stamp), and in the wide kernel
7 wide_select's sort done (its keys sorted and their order stored). It runs the root's
own wrappers on that build at chip_smoke.py's batch (B=32): at W=8 (the
narrow kernel) #11 beam_search_step_reorder (F = 418 rows), #13 tone
(K=8, H=256) and #12 v2 (D=10, H=256); at W=32 and 128 (the wide one)
#11, #13 and #12, and #12 at D=16 (2048 candidates at W=128); and prints,
over the blocks, the median time of each stamp from the block's start,
the spread of the blocks' starts and the device time per call under a
CUDA graph (chip_smoke.graph_ms); and the launch floor: one in-place add
on a one-element tensor timed the same way. Each root's package and
chip_smoke.py are imported afresh. The stamped copy is found by text
anchors in each kernel's body and the probe stops if one is missing.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
STAMPS = 8
BLOCKS = 64
START, ISSUED, CAND, SELECTED, WRITTEN, LANDED, END, SORTED = range(8)
NAMES = ("start", "rows issued", "candidate", "selected", "beams written",
         "rows landed", "end", "sorted")
# In beam_select.cuh's wide_select (where the stamped beam_step.cu defines
# PROBE): the keys sorted and their order stored.
SORT_AT = "  else wide_order<8>(s, C);\n  __syncthreads();\n"

# The stamps, then the include they replace (so that beam_select.cuh sees
# PROBE).
HEADER = f'''__device__ unsigned long long g_probe[{BLOCKS} * {STAMPS}];
__device__ __forceinline__ unsigned long long probe_time() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define PROBE(i) do {{ if (threadIdx.x == 0 && blockIdx.x < {BLOCKS}) \\
  g_probe[blockIdx.x * {STAMPS} + (i)] = probe_time(); }} while (0)
#define PROBE_AFTER(i, v) do {{ \\
  asm volatile("" :: "r"(__float_as_uint((float)(v)))); PROBE(i); }} while (0)
#define PROBE_LAST(i) do {{ __syncwarp(); \\
  if ((threadIdx.x & 31) == 0 && blockIdx.x < {BLOCKS}) \\
  atomicMax(&g_probe[blockIdx.x * {STAMPS} + (i)], probe_time()); }} while (0)
#include "beam_select.cuh"
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

USE_DIAG = "  const bool use_diag = KIND == kV2 && !a.v2.test_mode;\n"
NSURV = "  if (KIND == kV2 && tid == 0) a.o_nsurv[b] = n;\n"
LAND = "    if (sp.nb) mbar_wait(&bar, 0);\n"
# (old text, new text) in each kernel's body; the end stamp closes it.
EDITS = {
    "beam_step_kernel": [
        (USE_DIAG, USE_DIAG + f"  PROBE({START});\n"),
        ("  // 2. Candidates, 3. selection.\n",
         f"  PROBE({ISSUED});\n  // 2. Candidates, 3. selection.\n"),
        ("  if (c < C) x = candidate<KIND>(a, b, c);\n",
         "  if (c < C) x = candidate<KIND>(a, b, c);\n"
         f"  PROBE_AFTER({CAND}, x.lp);\n"),
        ("    n = warp_select(wsm[warp], x, Wo, use_diag, &src);\n",
         "    n = warp_select(wsm[warp], x, Wo, use_diag, &src);\n"
         f"    PROBE_AFTER({SELECTED}, src);\n"),
        ("    n = block_select(bsm, x, C, Wo, use_diag, &src);\n",
         "    n = block_select(bsm, x, C, Wo, use_diag, &src);\n"
         f"    PROBE_AFTER({SELECTED}, src);\n"),
        (NSURV, f"  PROBE({WRITTEN});\n" + NSURV),
        (LAND, LAND + f"    PROBE({LANDED});\n"),
    ],
    "beam_step_wide_kernel": [
        (USE_DIAG, USE_DIAG + f"  PROBE({START});\n"),
        ("  // 2. Candidates, 3. selection (",
         f"  PROBE({ISSUED});\n  // 2. Candidates, 3. selection ("),
        ("  const int n = wide_select(sel, C, Wo, use_diag);\n",
         f"  PROBE({CAND});\n"
         "  const int n = wide_select(sel, C, Wo, use_diag);\n"
         f"  PROBE_AFTER({SELECTED}, n);\n"),
        (NSURV, f"  PROBE({WRITTEN});\n" + NSURV),
        (LAND, LAND + f"    PROBE({LANDED});\n"),
    ],
}


def body_span(text: str, name: str) -> tuple:
    """(start, end) of the body of the __global__ function `name`: the
    text between its braces."""
    at = text.find(f" {name}(")
    if at < 0 or "__global__" not in text[text.rfind("\n", 0, at):at]:
        raise SystemExit(f"probe_beam: kernel {name} not found")
    i = text.index("{\n", at) + 1
    depth, j = 1, i
    while depth:
        j += 1
        depth += {"{": 1, "}": -1}.get(text[j], 0)
    return i, j


def stamped_sources(src: Path, dst: Path) -> None:
    """Copy src (a csrc/ directory) to dst with the stamps written into
    beam_step.cu's two kernels."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    text = (dst / "beam_step.cu").read_text()
    for name, edits in EDITS.items():
        i, j = body_span(text, name)
        body = text[i:j]
        for old, new in edits:
            if body.count(old) != 1:
                raise SystemExit(f"probe_beam: anchor {old.strip()!r} not "
                                 f"found once in {name}")
            body = body.replace(old, new)
        text = text[:i] + body + f"  PROBE_LAST({END});\n" + text[j:]
    text = text.replace('#include "beam_select.cuh"\n', HEADER, 1)
    (dst / "beam_step.cu").write_text(text + READ)
    sel = (dst / "beam_select.cuh").read_text()
    if sel.count(SORT_AT) == 1:  # the sort network's wide_select
        sel = sel.replace(SORT_AT, SORT_AT + "#ifdef PROBE\n"
                          f"  PROBE({SORTED});\n#endif\n")
        (dst / "beam_select.cuh").write_text(sel)


def load(root: Path):
    """Import root's chip_smoke and package afresh."""
    for name in list(sys.modules):
        if name == "chip_smoke" or name.startswith("ssnt_tts_tpu_torch"):
            del sys.modules[name]
    sys.path[0] = str(root)
    importlib.invalidate_caches()
    return (importlib.import_module("chip_smoke"),
            importlib.import_module("ssnt_tts_tpu_torch.ops._build"),
            importlib.import_module("ssnt_tts_tpu_torch.ops.beam_kernels"))


def stage_report(name: str, fn, lib, graph_ms) -> dict:
    import numpy as np
    import torch

    buf = np.zeros(BLOCKS * STAMPS, dtype=np.uint64)
    with torch.no_grad():
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        # Only this launch's stamps: the other kernel's go.
        if lib.ssnt_probe_clear() != 0:
            raise RuntimeError("probe clear failed")
        fn()
        torch.cuda.synchronize()
        if lib.ssnt_probe_read(buf.ctypes.data) != 0:
            raise RuntimeError("probe read failed")
        ms = graph_ms(fn)
    t = buf.reshape(BLOCKS, STAMPS).astype(np.float64)
    t = t[t[:, START] > 0]
    marks = {NAMES[i]: float(np.median(t[:, i] - t[:, START]) / 1e3)
             for i in range(1, STAMPS) if t[:, i].all()}
    spread = float((t[:, START].max() - t[:, START].min()) / 1e3)
    span = float((t[:, END].max() - t[:, START].min()) / 1e3)
    print(f"== {name}: device {ms * 1e3:.2f} us per call (CUDA graph); "
          f"{len(t)} blocks, start spread {spread:.2f} us, first start to "
          f"last end {span:.2f} us; stamps (median us after the block's "
          "start): " + ", ".join(f"{k} {v:.2f}" for k, v in marks.items()),
          flush=True)
    return {"graph_ms": ms, "blocks": int(len(t)), "start_spread_us": spread,
            "span_us": span, "marks_us": marks}


def probe_root(call: int, root: Path, dev) -> dict:
    import numpy as np
    import torch

    cs, build, bk = load(root)
    stamped_sources(root / "ssnt_tts_tpu_torch" / "csrc",
                    HERE / "build" / "probe_beam" / str(call) / "csrc")
    build.CSRC = HERE / "build" / "probe_beam" / str(call) / "csrc"
    build.BUILD_DIR = HERE / "build" / "probe_beam" / str(call) / "lib"
    build.beam_step_library.cache_clear()
    lib = build.beam_step_library()
    lib.ssnt_probe_read.argtypes = [ctypes.c_void_p]
    lib.ssnt_probe_read.restype = ctypes.c_int
    lib.ssnt_probe_clear.argtypes = []
    lib.ssnt_probe_clear.restype = ctypes.c_int

    from ssnt_tts_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(**cs.SERVE_CFG)
    H, M = cfg.decoder_dim, cfg.mel_dim
    D, K = cfg.duration_class_size, cfg.tone_class_size
    rng = np.random.default_rng(0)
    _, il, ol = cs.make_request(rng, cfg.vocab_size, dev)
    fns = {}
    for Wn in (cs.W, 32, 128):
        x1 = cs.v1_beam_only_inputs(rng, 40, Wn, il, H + 2 * M + 2, dev)
        a1 = (x1["h"], x1["lp"], x1["fin"], x1["t"], x1["u"], x1["il"])
        fns[f"beam_v1_step_reorder (#11) B=32 W={Wn} F=418"] = (
            lambda a=a1, st=x1["state"]: bk.beam_search_step_reorder(*a, st))
        for Dn in ((D,) if Wn < 128 else (D, 16)):
            x2 = cs.beam_only_inputs(rng, 30, Wn, Dn, K, H, il, ol, dev)
            dtab = torch.arange(Dn, dtype=torch.int32, device=dev)
            if Dn == D:
                at = (x2["h_tone"], x2["lp"], x2["fin"], x2["t"], x2["u"],
                      x2["il"])
                fns[f"tone_beam_step (#13) B=32 W={Wn} K={K} H={H}"] = (
                    lambda a=at, st=x2["state"]:
                    bk.tone_beam_search_decode(*a, state=st))
            a2 = (x2["h"], x2["lp"], x2["fin"], x2["tot"], dtab, x2["t"],
                  x2["u"], x2["il"], x2["ol"])
            fns[f"v2_beam_step (#12) B=32 W={Wn} D={Dn} H={H}"] = (
                lambda a=a2, st=x2["state"]:
                bk.v2_beam_search_decode(*a, state=st))
    one = torch.zeros(1, device=dev)
    floor = cs.graph_ms(lambda: one.add_(1.0))
    print(f"probe_beam call {call}: {root}; launch floor (one-element "
          f"in-place add, CUDA graph) {floor * 1e3:.2f} us", flush=True)
    return {"root": str(root), "launch_floor_ms": floor,
            "stages": {n: stage_report(n, fn, lib, cs.graph_ms)
                       for n, fn in fns.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE)])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_beam: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    runs = [probe_root(i, Path(r).resolve(), dev)
            for i, r in enumerate(args.roots)]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": smi, "runs": runs},
                                              indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
