"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The kernel sources live in ssnt_tts_tpu_torch/csrc/. At first use they are
compiled for Hopper (sm_90a) into a shared library with a plain C entry,
in build/ssnt_tts_tpu_torch/ beside the package (a directory .gitignore
lists), and loaded with ctypes. The library's name carries a hash of the
source and flags, so an edited source is rebuilt. There is no fallback:
without nvcc, or when the build fails, this raises.

Flags: -fmad=false keeps every float32 multiply and add separately
rounded (the beam band edges depend on it; the dot products use explicit
fused multiply-adds); --use_fast_math is never passed.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
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
