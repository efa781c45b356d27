"""Where the two-pass route's warp walks (csrc/lattice.cu: #5
lattice_backward_grads, grads_warp_kernel; #1 lattice_forward_alphas,
lattice_bidir's forward walk alone; #3 lattice_backward_betas, its
backward walk alone) spend their time, and which of their designs is
fastest.

    python3 ssnt_tts_tpu_torch/probe_grads.py [--json OUT] [--parent ROOT]
        [--designs NAME ...]

Builds copies of this checkout's csrc/lattice.cu under build/probe_grads/
(which .gitignore lists): the source as it is, the other designs (every
log walk in rounds of 8 columns instead of 16; the block walks' device
functions forced inline, or their shared row picked by a select instead
of a multiply) and timing-only ablations whose outputs mean nothing:
#5's posterior warps without their three expf or without their stores,
or both ("#5 chain alone": the posteriors still read and free every
slot), and #1's storer without its stores and its loader without its
copies ("#1 chain alone"). It calls each copy's
ssnt_lattice_backward_betas (#3, float32; its block walk too where the
copy has ssnt_lattice_backward_betas_block),
ssnt_lattice_backward_grads and ssnt_lattice_forward_alphas through
ctypes at chip_smoke.py's shapes (T=80, U=400, chip_smoke.lattice_inputs)
at B=32, 128 and 256 in float32 and at B=256 in bfloat16 storage, and
each design's block-walk entries beside them, and prints the
device time per call under a CUDA graph (chip_smoke.graph_ms), whether each
design's outputs equal the block walk's (#3: the plain version's) bit for
bit, ptxas's register report for grads_warp_kernel and the CALL
instructions in each block-walk kernel (as is, and inlined). With
--parent ROOT (a checkout of another commit, e.g. a `git archive` of the
parent under build/parent) it builds ROOT's lattice.cu too, times its #3
beside this one's, and writes both copies' SASS of backward_betas_kernel
(#3's block walk at one thread a position) beside the --json file, with
the instructions of each opcode in the JSON. Each copy is timed in a
process of its own (a fault costs that copy's numbers only). Needs one
CUDA device.
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
OUT = HERE / "build" / "probe_grads"

KEEP = 'asm volatile("" ::"f"({}));'
ROUND8 = [("constexpr int kLogRound = 16;", "constexpr int kLogRound = 8;")]
POST_EXPS = [
    ("expf(fminf(anorm + e + cont_emit, 30.0f))",
     "fminf(anorm + e + cont_emit, 30.0f)"),
    ("expf(fminf(anorm + s + cont_shift, 30.0f))",
     "fminf(anorm + s + cont_shift, 30.0f)"),
    ("expf(fminf(anorm + be, 30.0f))", "fminf(anorm + be, 30.0f)"),
]
POST_STORES = [(f"st(d_{n}, o, neg_g * p_{n});",
                KEEP.format(f"neg_g * p_{n}")) for n in ("le", "ls", "lf")]
FWD_STORES = [("if (w.live) store_lane<V>(dst, x);",
               "for (int j = 0; j < V; ++j) " + KEEP.format("x[j]")),
              ("if (w.t0 + j < w.T) dst[j] = x[j];", KEEP.format("x[j]"))]
FWD_COPIES = [(f"cp_async_zfill<N>(rows[{i}] + w.t0, {x} + o, n);", "")
              for i, x in enumerate("ESF")]
INLINED = [(f"__device__ void {w}(", f"__device__ __forceinline__ void {w}(")
           for w in ("alpha_walk", "beta_walk", "exp_alpha_walk",
                     "exp_beta_walk", "expin_alpha_walk", "expin_beta_walk",
                     "grads_walk")]
ROW_SELECT = [("  return sh + (u & 1) * (T + 1);",
               "  return (u & 1) ? sh + T + 1 : sh;")]
DESIGNS = {"as is": [], "round 8": ROUND8, "walks inlined": INLINED,
           "row select": ROW_SELECT}
ABLATIONS = {"#5 no exps": POST_EXPS, "#5 no stores": POST_STORES,
             "#5 chain alone": POST_EXPS + POST_STORES,
             "#1 chain alone": FWD_STORES + FWD_COPIES}


def ablate(src: str, edits) -> str:
    """src with each edit (old, new) made."""
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"probe_grads: anchor not found: {old!r}")
        src = src.replace(old, new)
    return src


def build(src: str, path: Path, csrc: Path, nvcc: str, flags) -> tuple:
    """(library, compiler output) of src compiled at path."""
    path.write_text(src)
    lib = path.with_suffix(".so")
    proc = subprocess.run([nvcc, *flags, "-I", str(csrc), "-o", str(lib),
                           str(path)], check=True, capture_output=True,
                          text=True, timeout=900)
    return lib, proc.stdout + proc.stderr


def calls(lib: Path, nvcc: str) -> dict:
    """CALL instructions in each block-walk kernel's SASS (a walk that is
    not inlined is called, its shared rows then reached by generic
    loads and stores)."""
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            tail = fn.split("lattice_cu_")[-1]
            short = re.search(r"(\w+_kernel(?:_p)?)", tail)
            name = short.group(1) if short and "warp" not in fn else None
            if name:
                out.setdefault(name, 0)
        elif name and "CALL" in line:
            out[name] += 1
    return out


def registers(log: str) -> dict:
    """ptxas's 'Used N registers' line of each grads_warp_kernel."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and "grads_warp_kernel" in fn:
            short = re.search(r"(grads_warp_kernelI.*?E)E", fn)
            out[short.group(1) if short else fn[:60]] = line.strip()
            fn = None
    return out


def kernel_sass(lib: Path, nvcc: str, mangled: str) -> str:
    """The SASS of the kernel whose mangled name matches `mangled`."""
    dump = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                           str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, keep = [], False
    for line in dump.splitlines():
        if "Function :" in line:
            keep = bool(re.search(mangled, line.split("Function :")[1]))
        if keep:
            out.append(line)
    return "\n".join(out)


def opcodes(sass: str) -> dict:
    """Instructions of each opcode (predicates and modifiers dropped)."""
    out = {}
    for line in sass.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                     line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


# backward_betas_kernel, the P = 1 instance (not a template), in the global
# or an anonymous namespace
BETAS_SASS = r"21backward_betas_kernel[Ei]"


def time_variant(name: str, path: str) -> dict:
    """Times one built copy: {"times_ms": ..., "bit_for_bit": ...}."""
    import numpy as np
    import torch

    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from ssnt_tts_tpu_torch.ops import _build
    from ssnt_tts_tpu_torch.ops import lattice as lat
    from ssnt_tts_tpu_torch.ops import lattice_kernels as lk

    dev = torch.device("cuda:0")
    lib = ctypes.CDLL(path)
    out_json = {"times_ms": {}, "bit_for_bit": {}}
    rng = np.random.default_rng(0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    kinds = (("#3", "ssnt_lattice_backward_betas",
              _build.LATTICE_BETAS_ARGTYPES),
             ("#3 block walk", "ssnt_lattice_backward_betas_block",
              _build.LATTICE_BETAS_ARGTYPES),
             ("#5", "ssnt_lattice_backward_grads",
              _build.LATTICE_BWD_ARGTYPES),
             ("#1", "ssnt_lattice_forward_alphas",
              _build.LATTICE_FWD_ARGTYPES),
             ("#5 block walk", "ssnt_lattice_backward_grads_block",
              _build.LATTICE_BWD_ARGTYPES),
             ("#1 block walk", "ssnt_lattice_forward_alphas_block",
              _build.LATTICE_FWD_ARGTYPES))
    for Bn, dt in ((cs.B, torch.float32), (cs.B_LARGE // 2, torch.float32),
                   (cs.B_LARGE, torch.float32),
                   (cs.B_LARGE, torch.bfloat16)):
        x, (il, ol) = cs.lattice_inputs(rng, Bn, dt, dev)
        U, B, T = x[0].shape
        bf16 = int(dt == torch.bfloat16)
        with torch.no_grad():
            a = cs.block_forward_alphas(*x)
            z = lat.gather_logz(a, x[0], il, ol)
            g = torch.ones(Bn, device=dev)
            want = cs.block_backward_grads(*x, a, il, ol, g, z)
            betas = lk.lattice_backward_betas_reference(
                *(t.float() for t in x), il, ol)
        tag = f"{str(dt)[6:]} B={Bn}"
        for kind, entry, types_ in kinds:
            if ("block" in kind and name in ABLATIONS) or (
                    name in ABLATIONS and not name.startswith(kind[:2])) or (
                    name == "parent" and kind != "#3"):
                continue
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = types_, ctypes.c_int
            if kind.startswith("#3"):
                if dt != torch.float32 or name in ABLATIONS:
                    continue
                out = [torch.empty((U, B, T), device=dev)]
                ptrs = [t.data_ptr() for t in (*x, il, ol, *out)]
            elif kind.startswith("#5"):
                out = [torch.empty((U, B, T), dtype=dt, device=dev)
                       for _ in range(3)]
                ptrs = [t.data_ptr() for t in (*x, a, il, ol, g, z, *out)]
            else:
                out = [torch.empty((U, B, T), device=dev)]
                ptrs = [t.data_ptr() for t in (*x, *out)]

            def call(fn=fn, ptrs=ptrs, kind=kind):
                lead = (B, T, U) if kind.startswith("#3") else (bf16, B, T, U)
                rc = fn(*lead, *ptrs, stream())
                if rc != 0:
                    raise RuntimeError(f"{name} {kind}: cudaError {rc}")

            call()
            torch.cuda.synchronize()
            if name in DESIGNS or name == "parent":
                ref = (want if kind.startswith("#5") else [betas]
                       if kind.startswith("#3") else [a])
                out_json["bit_for_bit"][f"{name} {kind} {tag}"] = all(
                    cs.same_bits(p, q) for p, q in zip(out, ref))
            out_json["times_ms"][f"{name} {kind} {tag}"] = cs.graph_ms(
                call, k=20, reps=10)
    return out_json


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--designs", nargs="+", default=None, metavar="NAME",
                    help="build and time these copies and the source as "
                         "it is only (default: every design and ablation)")
    ap.add_argument("--parent", default=None, metavar="ROOT",
                    help="another checkout: its #3 timed and its SASS "
                         "written beside this one's")
    ap.add_argument("--time", nargs=2, metavar=("NAME", "LIB"),
                    help="time one built copy (the probe runs this itself)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_grads: no CUDA device", file=sys.stderr)
        return 1
    if args.time:
        print(json.dumps(time_variant(*args.time)), flush=True)
        return 0
    sys.path.insert(0, str(HERE))
    from ssnt_tts_tpu_torch.ops import _build

    src = (_build.CSRC / "lattice.cu").read_text()
    variants = {name: (ablate(src, e), _build.CSRC) for name, e in
                {**DESIGNS, **ABLATIONS}.items()
                if args.designs is None or name in ("as is", *args.designs)}
    if args.parent:
        csrc = Path(args.parent).resolve() / "ssnt_tts_tpu_torch" / "csrc"
        variants["parent"] = ((csrc / "lattice.cu").read_text(), csrc)
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    with ThreadPoolExecutor(len(variants)) as pool:
        futures = {name: pool.submit(build, text, OUT / f"v{i}.cu", csrc,
                                     nvcc, _build.NVCC_FLAGS)
                   for i, (name, (text, csrc)) in enumerate(variants.items())}
        built = {name: f.result() for name, f in futures.items()}
    result = {"times_ms": {}, "bit_for_bit": {}, "failed": {},
              "registers": registers(built["as is"][1]),
              "calls": {name: calls(path, nvcc) for name, (path, _) in
                        built.items() if name in ("as is", "walks inlined")}}
    if args.parent:
        result["sass_opcodes"] = {}
        for name in ("as is", "parent"):
            sass = kernel_sass(built[name][0], nvcc, BETAS_SASS)
            result["sass_opcodes"][name] = opcodes(sass)
            if args.json:
                tag = name.replace(" ", "_")
                Path(args.json).parent.mkdir(parents=True, exist_ok=True)
                Path(args.json).with_suffix(f".{tag}.sass").write_text(sass)
    for name, (path, _) in built.items():
        proc = subprocess.run([sys.executable, __file__, "--time", name,
                               str(path)], capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            result["failed"][name] = proc.stderr[-600:]
            print(f"probe_grads: {name} failed", flush=True)
            continue
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        for key in ("times_ms", "bit_for_bit"):
            result[key].update(r[key])
        print(json.dumps(r["times_ms"]), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result["card"] = smi
    print(json.dumps(result), flush=True)
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
