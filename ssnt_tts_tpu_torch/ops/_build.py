"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The kernel sources live in ssnt_tts_tpu_torch/csrc/. At first use they are
compiled for Hopper (sm_90a) into a shared library with a plain C entry,
in build/ssnt_tts_tpu_torch/ beside the package (a directory .gitignore
lists), and loaded with ctypes. The library's name carries a hash of the
source and flags, so an edited source is rebuilt. There is no fallback:
without nvcc, or when the build fails, this raises.

One library per source: csrc/fused_v2_step.cu (the fused v2 decode step)
and csrc/lattice.cu (the SSNT lattice forward-backward); build_all starts
one nvcc per source at once.

Flags: -fmad=false keeps every float32 multiply and add separately
rounded (the beam band edges depend on it; the dot products use explicit
fused multiply-adds; the lattice kernels follow the JAX kernels'
operation order); --use_fast_math is never passed, so expf/log1pf are
the accurate ones.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ssnt_tts_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ssnt_fused_v2_step(compute_bf16, B, W, D, H, s, 20 inputs, 12 outputs,
#                    5 int options, 4 float options, stream)
FUSED_V2_ARGTYPES = [_I] * 6 + [_P] * 32 + [_I] * 5 + [_F] * 4 + [_P]
# ssnt_lattice_bidir(B, T, U, le, ls, lf, il, ol, alphas, betas, stream)
LATTICE_BIDIR_ARGTYPES = [_I] * 3 + [_P] * 8
# ssnt_lattice_forward_alphas(bf16, B, T, U, le, ls, lf, alphas, stream)
LATTICE_FWD_ARGTYPES = [_I] * 4 + [_P] * 5
# ssnt_lattice_backward_grads(bf16, B, T, U, le, ls, lf, alphas, il, ol,
#                             g, logz, d_le, d_ls, d_lf, stream)
LATTICE_BWD_ARGTYPES = [_I] * 4 + [_P] * 12


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from csrc/ with nvcc for sm_90a; "
        "there is no fallback for CUDA tensors")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu into BUILD_DIR (once per source+flags hash).
    The compiler's output, with ptxas's register and spill report, is kept
    beside the library as <library>.log."""
    src = CSRC / f"{name}.cu"
    nvcc = find_nvcc()
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, check=False)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {src}:\n{log}")
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    return lib


def build_all(names) -> None:
    """Build several sources at once, one nvcc process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for future in [pool.submit(build, n) for n in names]:
            future.result()


def build_log(name: str) -> str:
    """The compiler output kept with the built library of csrc/<name>.cu."""
    return build(name).with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def fused_v2_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("fused_v2_step")))
    lib.ssnt_fused_v2_step.argtypes = FUSED_V2_ARGTYPES
    lib.ssnt_fused_v2_step.restype = ctypes.c_int
    for fn in (lib.ssnt_fused_v2_step_max_candidates,
               lib.ssnt_fused_v2_step_max_beams):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def lattice_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build("lattice")))
    for fn, argtypes in (
            (lib.ssnt_lattice_bidir, LATTICE_BIDIR_ARGTYPES),
            (lib.ssnt_lattice_forward_alphas, LATTICE_FWD_ARGTYPES),
            (lib.ssnt_lattice_backward_grads, LATTICE_BWD_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ssnt_lattice_max_t.argtypes = []
    lib.ssnt_lattice_max_t.restype = ctypes.c_int
    return lib


def check_arg(name, x, dtype, shape, device):
    """Raise unless x is a contiguous tensor of `dtype` (one dtype or a
    tuple of them) and `shape` on `device`: what a kernel may be handed."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if x.dtype not in dtypes or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device != device or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous tensor on {device}")
