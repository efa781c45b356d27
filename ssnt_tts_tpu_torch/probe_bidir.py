"""Where the bidirectional passes' warp walks (csrc/lattice.cu: #8/#7
lattice_bidir, the log domain; #4 lattice_bidir_exp, the exp domain)
spend their time, and which of their designs is fastest.

    python3 ssnt_tts_tpu_torch/probe_bidir.py [--roots DIR ...] [--json OUT]

For each root (a checkout of this repository; default the one this file
is in), in the order given, this builds copies of the root's
csrc/lattice.cu under build/probe_bidir/<call>/ (which .gitignore lists):
the source as it is and, where it has the warp walks, the other designs
(#8 in rounds of 8 or 32 columns instead of 16, or on two chain warps of
2 positions a lane instead of ceil(T / 32) of 1; #4 in rounds of 8
columns instead of 4, with one loader warp at B=32 instead of two, with
its loader's and storer's loops unrolled, or dividing by the float
division instead of the double reciprocal) and timing-only ablations
whose outputs mean nothing: the storers' global stores removed (their values
kept alive by empty asm), the loaders' copies removed (the ring's stale
values read), #4's input exps and stored logs removed, and all three
("chain alone"). It calls each copy's ssnt_lattice_bidir (B=32 and B=64)
and ssnt_lattice_bidir_exp (B=32 and B=256) through ctypes at
chip_smoke.py's shapes (T=80, U=400, chip_smoke.lattice_inputs) and
prints the device time per call under a CUDA graph (chip_smoke.graph_ms),
whether each design's outputs equal the plain versions bit for bit (and
#8's alphas #1's), the instructions each backward branch of the walk
kernels spans, 40 or more (cuobjdump -sass, longest first; a span counts
all code placed between a loop's head and its branch, run or not: the
size of the code a warp loops over), and ptxas's register report for the
walk kernels. Each root's
package and chip_smoke.py are imported afresh. The edits are found by
text anchors and the probe stops if one is missing. Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
OUT = HERE / "build" / "probe_bidir"
WALKS = ("bidir_warp_kernel", "bidir_exp_warp_kernel")

KEEP = 'asm volatile("" ::"f"(x[j]));'
STORES = [
    ("if (w.live) store_lane<V>(dst, x);",
     "for (int j = 0; j < V; ++j) " + KEEP),
    ("if (w.t0 + j < w.T) dst[j] = x[j];", KEEP),
]
# The vector copy's text in either form of stage_round (before and after
# its rows took the storage type: a copy of 4 V or of N bytes).
COPIES = [
    ((f"cp_async_zfill<4 * V>(rows[{i}] + w.t0, {x} + o, n);",
      f"cp_async_zfill<N>(rows[{i}] + w.t0, {x} + o, n);"), "")
    for i, x in enumerate("ESF")
] + [
    (f"cp_async_zfill<4>(rows[{i}] + w.t0 + k, {x} + o + k, n);", "")
    for i, x in enumerate("ESF")
]
EXPS = [
    ("for (int i = 0; i < V; ++i) x[i] = expf(x[i]);", ""),
    ("if (w.t0 + i < w.T) p[i] = expf(p[i]);", ";"),
    ("y[j] = logf(x[j]) + acc;", "y[j] = x[j] + acc;"),
    ("acc = acc + logf(nrm);", "acc = acc + nrm;"),
]
EXP_ROUND8 = [("constexpr int kBidirRound = 4;",
               "constexpr int kBidirRound = 8;")]
LOG_ROUND = {n: [("constexpr int kLogRound = 16;",
                  f"constexpr int kLogRound = {n};")] for n in (8, 32)}
LOADERS1 = [("constexpr int kExpLoaders = 2;",
             "constexpr int kExpLoaders = 1;")]
LOG_VC2 = [("constexpr int kLogVC = 1;", "constexpr int kLogVC = 2;")]
EXP_UNROLL = [("constexpr int kExpUnroll = 1;",
               "constexpr int kExpUnroll = kBidirRound;")]
FLOAT_DIV = [("p[j] = div_rn(x[k][j], rn);", "p[j] = x[k][j] / norm[k];"),
             ("field[j] = div_rn(x[k][j], rn);",
              "field[j] = x[k][j] / norm[k];")]


def ablate(src: str, edits) -> str:
    """src with each edit (old, new) made; old may be a tuple of texts of
    which the first found is replaced."""
    for old, new in edits:
        found = [o for o in (old if isinstance(old, tuple) else (old,))
                 if o in src]
        if not found:
            raise SystemExit(f"probe_bidir: anchor not found: {old!r}")
        src = src.replace(found[0], new)
    return src


def build(src: str, path: Path, csrc: Path, nvcc: str, flags) -> tuple:
    """(library, compiler output) of src compiled at path."""
    path.write_text(src)
    lib = path.with_suffix(".so")
    proc = subprocess.run([nvcc, *flags, "-I", str(csrc), "-o", str(lib),
                           str(path)], check=True, capture_output=True,
                          text=True, timeout=900)
    return lib, proc.stdout + proc.stderr


def sass_loops(lib: Path, nvcc: str, kernel: str, least: int = 40) -> dict:
    """Instructions spanned by each backward branch, at least `least`, in
    the functions whose mangled name holds `kernel` (one list per
    function, longest first)."""
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    funcs, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = name if kernel in name else None
            if name:
                funcs[name] = []
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if name and m:
            funcs[name].append((int(m.group(1), 16), m.group(2)))
    out = {}
    for fname, ins in funcs.items():
        lens = []
        for addr, text in ins:
            target = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)\s*)?0x([0-9a-f]+)",
                               text)
            if target and int(target.group(1), 16) < addr:
                lo = int(target.group(1), 16)
                lens.append(sum(1 for a, _ in ins if lo <= a <= addr))
        short = re.search(r"(bidir(?:_exp)?_warp_kernelI(?:L[ib]\d+E)+)", fname)
        out[short.group(1) if short else fname[:60]] = sorted(
            (n for n in lens if n >= least), reverse=True)
    return out


def registers(log: str) -> dict:
    """ptxas's 'Used N registers' line of each walk kernel instance."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and any(w in fn for w in WALKS):
            short = re.search(r"(bidir(?:_exp)?_warp_kernelI(?:L[ib]\d+E)+)",
                              fn)
            out[short.group(1) if short else fn[:60]] = line.strip()
            fn = None
    return out


def probe_root(call: int, root: Path, dev) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, str(HERE))
    from ssnt_tts_tpu_torch import bench_fused

    cs, _ = bench_fused.load(root)
    from ssnt_tts_tpu_torch.ops import _build
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    src = (root / "ssnt_tts_tpu_torch" / "csrc" / "lattice.cu").read_text()
    variants = {"as is": src}
    designs = ["as is"]
    if "bidir_warp_kernel" in src:
        designs += ["log round 8", "log round 32", "log VC 2",
                    "exp round 8", "1 exp loader", "exp unrolled",
                    "float division"]
        variants.update({
            "log round 8": ablate(src, LOG_ROUND[8]),
            "log round 32": ablate(src, LOG_ROUND[32]),
            "log VC 2": ablate(src, LOG_VC2),
            "exp round 8": ablate(src, EXP_ROUND8),
            "1 exp loader": ablate(src, LOADERS1),
            "exp unrolled": ablate(src, EXP_UNROLL),
            "float division": ablate(src, FLOAT_DIV),
            "no stores": ablate(src, STORES),
            "no copies": ablate(src, COPIES),
            "no exps/logs": ablate(src, EXPS),
            "chain alone": ablate(src, STORES + COPIES + EXPS),
        })
    out = OUT / str(call)
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    with ThreadPoolExecutor(len(variants)) as pool:
        futures = {name: pool.submit(build, text, out / f"v{i}.cu",
                                     _build.CSRC, nvcc, _build.NVCC_FLAGS)
                   for i, (name, text) in enumerate(variants.items())}
        built = {name: f.result() for name, f in futures.items()}
    result = {"root": str(root), "times_ms": {}, "bit_for_bit": {}}
    if "bidir_warp_kernel" in src:
        lib = built["as is"][0]
        result["loops"] = {k: v for w in WALKS
                           for k, v in sass_loops(lib, nvcc, w).items()}
        result["registers"] = registers(built["as is"][1])
    rng = np.random.default_rng(0)
    shapes = (("ssnt_lattice_bidir", cs.B), ("ssnt_lattice_bidir", 2 * cs.B),
              ("ssnt_lattice_bidir_exp", cs.B),
              ("ssnt_lattice_bidir_exp", cs.B_LARGE))
    for entry, Bn in shapes:
        x, (il, ol) = cs.lattice_inputs(rng, Bn, torch.float32, dev)
        U, B, T = x[0].shape
        exp_domain = entry.endswith("_exp")
        want = (lk.lattice_bidir_exp_reference(*x, il, ol) if exp_domain
                else lk.lattice_bidir_reference(*x, il, ol))
        fwd = None if exp_domain else lk.lattice_forward_alphas(*x)
        tag = f"{'#4' if exp_domain else '#8'} B={Bn}"
        for name, (lib_path, _) in built.items():
            fn = getattr(ctypes.CDLL(str(lib_path)), entry)
            fn.argtypes = _build.LATTICE_BIDIR_ARGTYPES
            got = [torch.empty((U, B, T), device=dev) for _ in range(2)]
            ptrs = [a.data_ptr() for a in (*x, il, ol, *got)]

            def call_kernel():
                rc = fn(B, T, U, *ptrs,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            call_kernel()
            torch.cuda.synchronize()
            if name in designs:
                same = all(cs.same_bits(a, b) for a, b in zip(got, want))
                if fwd is not None:
                    same = same and cs.same_bits(got[0], fwd)
                result["bit_for_bit"][f"{name} {tag}"] = same
            result["times_ms"][f"{name} {tag}"] = cs.graph_ms(
                call_kernel, k=20, reps=10)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE)])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_bidir: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = []
    for i, root in enumerate(args.roots):
        r = probe_root(i, Path(root).resolve(), dev)
        print(json.dumps(r), flush=True)
        results.append(r)
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
