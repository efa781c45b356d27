"""Where the exp-native pass's warp walk (csrc/lattice.cu, #9) spends its
time.

    python3 ssnt_tts_tpu_torch/probe_expin.py [--roots DIR ...] [--json OUT]

For each root (a checkout of this repository; default the one this file
is in), in the order given, this builds copies of the root's
csrc/lattice.cu under build/probe_expin/<call>/ (which .gitignore lists):
the source as it is and, where it has the warp walk, timing-only
ablations whose outputs mean nothing: the storer warp's global stores
(the fields and M / N) removed, the chain's renormalization (the warp's
max and the reciprocal; normalizer 1) removed, the loader warp's copies
removed (the ring's stale values read), and all three ("chain alone").
It calls each copy's ssnt_lattice_expin
through ctypes at chip_smoke.py's shapes (T=80, U=400, B=32 and B=256,
chip_smoke.exp_lattice_inputs) and prints the device time per call under
a CUDA graph (chip_smoke.graph_ms), whether the copy as it is equals the
plain version bit for bit, and the instructions in the chain warp's
round loop at T=80 (cuobjdump -sass: the longest loop of
expin_warp_kernel<4, true>). Each root's package and chip_smoke.py are
imported afresh. The ablations are found by text anchors and the probe
stops if one is missing. Needs one CUDA device.
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
OUT = HERE / "build" / "probe_expin"

STORES = [
    ("if (w.live) store_lane<V>(dst, x);", ""),
    ("if (i / kRenorm <= r && ul >= 0 && ul < w.U) logs[ul * w.B] = keep;",
     "if (keep == 12345.0f) logs[0] = keep;"),
]
RENORM = [
    ("if (k == kRenorm - 1) norm[0] = warp_renorm<V, kVec>(w, q[k]);",
     "norm[0] = 1.0f;"),
    ("if (k == kRenorm - 1) norm[0] = warp_renorm<V, kVec>(w, b[k]);",
     "norm[0] = 1.0f;"),
]
# The vector copies in either form of stage_round (a copy of 4 V bytes, or
# of N since its rows took the storage type).
COPIES = [
    ((f"cp_async_zfill<4 * V>(rows[{i}] + w.t0, {x} + o, n);",
      f"cp_async_zfill<N>(rows[{i}] + w.t0, {x} + o, n);"), "")
    for i, x in enumerate("ESF")
]
ABLATIONS = {"no stores": STORES, "no renorm": RENORM, "no copies": COPIES,
             "chain alone": STORES + RENORM + COPIES}


def ablate(src: str, edits) -> str:
    """src with each edit (old, new) made; old may be a tuple of texts of
    which the first found is replaced."""
    for old, new in edits:
        found = [o for o in (old if isinstance(old, tuple) else (old,))
                 if o in src]
        if not found:
            raise SystemExit(f"probe_expin: anchor not found: {old!r}")
        src = src.replace(found[0], new)
    return src


def build(src: str, path: Path, csrc: Path, nvcc: str, flags) -> Path:
    path.write_text(src)
    lib = path.with_suffix(".so")
    subprocess.run([nvcc, *flags, "-I", str(csrc), "-o", str(lib),
                    str(path)], check=True, capture_output=True, timeout=900)
    return lib


def round_loop(lib: Path, nvcc: str) -> int:
    """Instructions in the longest loop of expin_warp_kernel<4, true>
    (the chain warp's round)."""
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    keep, ins = False, []
    for line in dump.splitlines():
        if "Function :" in line:
            keep = "expin_warp_kernelILi4ELb1E" in line
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if keep and m:
            ins.append((int(m.group(1), 16), m.group(2)))
    best = 0
    for addr, text in ins:
        target = re.search(r"BRA\s+0x([0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            best = max(best, sum(1 for a, _ in ins if lo <= a <= addr))
    return best


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
    if "expin_warp_kernel" in src:
        variants.update((k, ablate(src, e)) for k, e in ABLATIONS.items())
    out = OUT / str(call)
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    with ThreadPoolExecutor(len(variants)) as pool:
        futures = {name: pool.submit(build, text, out / f"v{i}.cu",
                                     _build.CSRC, nvcc, flags)
                   for i, (name, text) in enumerate(variants.items())}
        libs = {name: f.result() for name, f in futures.items()}
    result = {"root": str(root), "times_ms": {}, "bit_for_bit": {}}
    if "expin_warp_kernel" in src:
        result["round_loop_instructions"] = round_loop(libs["as is"], nvcc)
    rng = np.random.default_rng(0)
    for Bn in (cs.B, cs.B_LARGE):
        x, _, (il, ol) = cs.exp_lattice_inputs(rng, Bn, dev)
        U, B, T = x[0].shape
        want = lk.lattice_expin_reference(*x, il, ol)
        for name, lib_path in libs.items():
            fn = ctypes.CDLL(str(lib_path)).ssnt_lattice_expin
            fn.argtypes = _build.LATTICE_EXPIN_ARGTYPES
            got = [torch.empty((U, B, T), device=dev) for _ in range(2)] + [
                torch.empty((U, B), device=dev) for _ in range(2)]
            ptrs = [a.data_ptr() for a in (*x, il, ol, *got)]

            def call_kernel():
                rc = fn(B, T, U, *ptrs,
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            call_kernel()
            torch.cuda.synchronize()
            if name == "as is":
                result["bit_for_bit"][f"B={Bn}"] = all(
                    cs.same_bits(a, b) for a, b in zip(got, want))
            result["times_ms"][f"{name} B={Bn}"] = cs.graph_ms(
                call_kernel, k=20, reps=10)
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--roots", nargs="+", default=[str(HERE)])
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_expin: no CUDA device", file=sys.stderr)
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
