"""Where the beam-only step kernel (csrc/beam_step.cu) spends its time.

    python3 ssnt_tts_tpu_torch/probe_beam.py [--roots DIR ...] [--json OUT]

For each root (a checkout of this repository; default the one this file
is in), in the order given, this builds a copy of the root's csrc/ under
build/probe_beam/<call>/ (which .gitignore lists) in which the beam-only
kernel writes the %globaltimer (ns; it ticks in steps of about 0.26 us on
an H100) at fixed points: 0 the block's start, 1 the rows' bulk copy
issued, 2 the block's candidate computed (its inputs loaded), 3 the
selection done, 4 the selected beams written, 5 the rows landed in shared
memory, 6 the last warp done (the latest of every warp's stamp).
Points 1 and 5 exist only in the design that stages the rows; the older
design reads the rows during its reorder, which ends at 6. It runs the
root's own wrappers on that build at chip_smoke.py's shapes (B=32, W=8):
#11 beam_search_step_reorder (F = 418 rows), #13 tone (K=8, H=256) and
#12 v2 (D=10, H=256), and prints, over the blocks, the median time of each
stamp from the block's start, the spread of the blocks' starts and the
device time per call under a CUDA graph (chip_smoke.graph_ms); and the
launch floor: one in-place add on a one-element tensor timed the same
way. Each root's package and chip_smoke.py are imported afresh. The
stamped copy is found by text anchors and the probe stops if one is
missing. Needs one CUDA device.
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
START, ISSUED, CAND, SELECTED, WRITTEN, LANDED, END = range(7)
NAMES = ("start", "rows issued", "candidate", "selected", "beams written",
         "rows landed", "end")

HEADER = f'''#include "beam_select.cuh"
__device__ unsigned long long g_probe[{BLOCKS} * {STAMPS}];
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
'''
READ = '''
extern "C" int ssnt_probe_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_probe, sizeof(g_probe));
}
'''

# (old text, new text) for the design that stages the rows by TMA, and for
# the one before it (rows read during the reorder).
STAGED = [
    ("  const bool use_diag = KIND == kV2 && !a.v2.test_mode;\n",
     "  const bool use_diag = KIND == kV2 && !a.v2.test_mode;\n"
     f"  PROBE({START});\n"),
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
    ("  if (KIND == kV2 && tid == 0) a.o_nsurv[b] = n;\n",
     f"  PROBE({WRITTEN});\n"
     "  if (KIND == kV2 && tid == 0) a.o_nsurv[b] = n;\n"),
    ("    if (sp.nb) mbar_wait(&bar, 0);\n",
     f"    if (sp.nb) mbar_wait(&bar, 0);\n    PROBE({LANDED});\n"),
    ("    reorder_span(sp, src / D, Wo, H, a.o_state + (size_t)b * Wo * H);"
     "\n  }\n}",
     "    reorder_span(sp, src / D, Wo, H, a.o_state + (size_t)b * Wo * H);"
     f"\n  }}\n  PROBE_LAST({END});\n}}"),
]
UNSTAGED = [
    ("  __shared__ SelectSmem sel;\n\n  bool valid = false;\n",
     f"  __shared__ SelectSmem sel;\n  PROBE({START});\n\n"
     "  bool valid = false;\n"),
    ("    store_cand(sel, tid, x);\n",
     f"    store_cand(sel, tid, x);\n    PROBE_AFTER({CAND}, x.lp);\n"),
    ("  write_selected(sel, b, W, D, a.out);\n",
     f"  PROBE({SELECTED});\n  write_selected(sel, b, W, D, a.out);\n"
     f"  PROBE({WRITTEN});\n"),
    ("    reorder_rows(a.state + row0, a.o_state + row0, sel, W, D, H);\n"
     "  }\n}",
     "    reorder_rows(a.state + row0, a.o_state + row0, sel, W, D, H);\n"
     f"  }}\n  PROBE_LAST({END});\n}}"),
]


def stamped_sources(src: Path, dst: Path) -> str:
    """Copy src (a csrc/ directory) to dst with the stamps written into
    beam_step.cu; returns which design was found."""
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(src, dst)
    text = (dst / "beam_step.cu").read_text()
    for design, edits in (("staged", STAGED), ("unstaged", UNSTAGED)):
        if all(text.count(old) == 1 for old, _ in edits):
            break
    else:
        raise SystemExit("probe_beam: anchors of neither design found in "
                         f"{src / 'beam_step.cu'}")
    for old, new in edits:
        text = text.replace(old, new)
    text = text.replace('#include "beam_select.cuh"\n', HEADER, 1)
    (dst / "beam_step.cu").write_text(text + READ)
    return design


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
        fn()
        torch.cuda.synchronize()
        if lib.ssnt_probe_read(buf.ctypes.data) != 0:
            raise RuntimeError("probe read failed")
        ms = graph_ms(fn)
    t = buf.reshape(BLOCKS, STAMPS).astype(np.float64)
    t = t[t[:, START] > 0]
    marks = {NAMES[i]: float(np.median(t[:, i] - t[:, START]) / 1e3)
             for i in range(1, 7) if t[:, i].all()}
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
    design = stamped_sources(
        root / "ssnt_tts_tpu_torch" / "csrc",
        HERE / "build" / "probe_beam" / str(call) / "csrc")
    build.CSRC = HERE / "build" / "probe_beam" / str(call) / "csrc"
    build.BUILD_DIR = HERE / "build" / "probe_beam" / str(call) / "lib"
    build.beam_step_library.cache_clear()
    lib = build.beam_step_library()
    lib.ssnt_probe_read.argtypes = [ctypes.c_void_p]
    lib.ssnt_probe_read.restype = ctypes.c_int

    from ssnt_tts_tpu_torch.utils.config import ModelConfig

    cfg = ModelConfig(**cs.SERVE_CFG)
    H, M = cfg.decoder_dim, cfg.mel_dim
    D, K = cfg.duration_class_size, cfg.tone_class_size
    rng = np.random.default_rng(0)
    _, il, ol = cs.make_request(rng, cfg.vocab_size, dev)
    x1 = cs.v1_beam_only_inputs(rng, 40, cs.W, il, H + 2 * M + 2, dev)
    x2 = cs.beam_only_inputs(rng, 30, cs.W, D, K, H, il, ol, dev)
    dtab = torch.tensor(cfg.duration_table, dtype=torch.int32, device=dev)
    a1 = (x1["h"], x1["lp"], x1["fin"], x1["t"], x1["u"], x1["il"])
    a2 = (x2["h"], x2["lp"], x2["fin"], x2["tot"], dtab, x2["t"], x2["u"],
          x2["il"], x2["ol"])
    at = (x2["h_tone"], x2["lp"], x2["fin"], x2["t"], x2["u"], x2["il"])
    fns = {
        "beam_v1_step_reorder (#11) B=32 W=8 F=418":
            lambda: bk.beam_search_step_reorder(*a1, x1["state"]),
        "tone_beam_step (#13) B=32 W=8 K=8 H=256":
            lambda: bk.tone_beam_search_decode(*at, state=x2["state"]),
        "v2_beam_step (#12) B=32 W=8 D=10 H=256":
            lambda: bk.v2_beam_search_decode(*a2, state=x2["state"]),
    }
    one = torch.zeros(1, device=dev)
    floor = cs.graph_ms(lambda: one.add_(1.0))
    print(f"probe_beam call {call}: {root} ({design} design); launch floor "
          f"(one-element in-place add, CUDA graph) {floor * 1e3:.2f} us",
          flush=True)
    return {"root": str(root), "design": design, "launch_floor_ms": floor,
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
