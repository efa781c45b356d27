"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The kernel sources live in ssnt_tts_tpu_torch/csrc/. At first use they are
compiled for Hopper (sm_90a) into a shared library with a plain C entry,
in build/ssnt_tts_tpu_torch/ beside the package (a directory .gitignore
lists), and loaded with ctypes. The library's name carries a hash of the
source and flags, so an edited source is rebuilt. There is no fallback:
without nvcc, or when the build fails, this raises.

One library per source: csrc/fused_class_step.cu (the fused v2 and tone
decode steps), csrc/fused_v1_step.cu (the fused v1 decode step; both
fused sources include csrc/gru_step.cuh and csrc/wide_step.cuh),
csrc/beam_step.cu (the beam-only v2, tone and v1 steps; the three beam
sources include csrc/beam_select.cuh) and csrc/lattice.cu (the SSNT
lattice forward-backward, log and exp domains, and the K-banded walks);
build_all starts one nvcc per source at once.

Flags: -fmad=false keeps every float32 multiply and add separately
rounded (the beam band edges depend on it; the dot products use explicit
fused multiply-adds; the lattice kernels follow the JAX kernels'
operation order); --use_fast_math is never passed, so expf/log1pf are
the accurate ones; --split-compile=0 (the sources in SPLIT_COMPILE) runs
the device code's optimization passes on several threads, which shortens
the longest build, fused_v1_step.cu's, by about a third.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ssnt_tts_tpu_torch"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
# Seconds each nvcc run of this process took, by source name.
BUILD_SECONDS: dict = {}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Sources whose device code is optimized on several threads: the fused
# steps' kernels time the same either way on an H100; lattice.cu's
# exp-native walk ran ~3 % slower there so built, so it is one unit.
SPLIT_COMPILE = ("fused_class_step", "fused_v1_step")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# ssnt_fused_v2_step(compute_bf16, B, W, D, H, s, 19 inputs (the GRU
#                    matrices as one packed stream), 12 outputs, 5 int
#                    options, 4 float options, stream)
FUSED_V2_ARGTYPES = [_I] * 6 + [_P] * 31 + [_I] * 5 + [_F] * 4 + [_P]
# ssnt_fused_tone_step(compute_bf16, B, W, K, H, s, 15 inputs, 9 outputs,
#                      empty_tone_id, stream)
FUSED_TONE_ARGTYPES = [_I] * 6 + [_P] * 24 + [_I] + [_P]
# ssnt_beam_v2_step(B, W, W_out, D, H, 10 inputs, 9 outputs, 5 int
#                   options, 4 float options, stream)
BEAM_V2_ARGTYPES = [_I] * 5 + [_P] * 19 + [_I] * 5 + [_F] * 4 + [_P]
# ssnt_beam_tone_step(B, W, W_out, K, H, 7 inputs, 7 outputs,
#                     empty_tone_id, stream)
BEAM_TONE_ARGTYPES = [_I] * 5 + [_P] * 14 + [_I] + [_P]
# ssnt_beam_v1_step(B, W, W_out, F, 7 inputs, 7 outputs, stream); the
# state row pointers may be null (F = 0)
BEAM_V1_ARGTYPES = [_I] * 4 + [_P] * 14 + [_P]
# ssnt_fused_v1_step(compute_bf16, B, W, T, H, M, R, 18 inputs (the six
#                    matrices as one packed stream), 9 outputs, 3 debug
#                    outputs, stream)
FUSED_V1_ARGTYPES = [_I] * 7 + [_P] * 30 + [_P]
# ssnt_lattice_bidir(B, T, U, le, ls, lf, il, ol, alphas, betas, stream)
LATTICE_BIDIR_ARGTYPES = [_I] * 3 + [_P] * 8
# ssnt_lattice_forward_alphas(bf16, B, T, U, le, ls, lf, alphas, stream);
# ssnt_lattice_forward_alphas_block takes the same (the block walk at any
# T, for chip_smoke.py and bench_fused.py only)
LATTICE_FWD_ARGTYPES = [_I] * 4 + [_P] * 5
# ssnt_lattice_backward_grads(bf16, B, T, U, le, ls, lf, alphas, il, ol,
#                             g, logz, d_le, d_ls, d_lf, stream);
# ssnt_lattice_backward_grads_block likewise
LATTICE_BWD_ARGTYPES = [_I] * 4 + [_P] * 12
# ssnt_lattice_backward_betas(B, T, U, le, ls, lf, il, ol, betas, stream);
# ssnt_lattice_backward_betas_block likewise
LATTICE_BETAS_ARGTYPES = [_I] * 3 + [_P] * 7
# ssnt_lattice_bidir_exp takes lattice_bidir's arguments.
# ssnt_lattice_expin(B, T, U, E, S, F, mcol, il, ol, qn, bn, M, N, stream)
LATTICE_EXPIN_ARGTYPES = [_I] * 3 + [_P] * 11
# ssnt_lattice_forward_alphas_banded(K, B, T, U, le, ls, lf, alphas,
#                                    workspace, stream)
LATTICE_FWD_BANDED_ARGTYPES = [_I] * 4 + [_P] * 6
# ssnt_lattice_backward_grads_banded(K, B, T, U, le, ls, lf, alphas, il,
#                                    ol, g, logz, d_le, d_ls, d_lf,
#                                    workspace, bottoms, stream);
# ssnt_lattice_banded_max_t(K, backward).
LATTICE_BWD_BANDED_ARGTYPES = [_I] * 4 + [_P] * 14


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
    """Compile csrc/<name>.cu into BUILD_DIR (once per hash of the source,
    the csrc/ headers and the flags). The compiler's output, with ptxas's
    register and spill report, is kept beside the library as
    <library>.log."""
    src = CSRC / f"{name}.cu"
    nvcc = find_nvcc()
    flags = NVCC_FLAGS + (["--split-compile=0"] if name in SPLIT_COMPILE
                          else [])
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        text + " ".join(flags).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc, *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True, check=False)
    BUILD_SECONDS[name] = time.perf_counter() - t0
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


def _load(name: str, entries: dict, limits=()) -> ctypes.CDLL:
    """Build and load csrc/<name>.cu; declare its C entries (name ->
    argtypes, returning a cudaError_t) and its int limit queries."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in {**entries, **{n: [] for n in limits}}.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def fused_class_library() -> ctypes.CDLL:
    return _load("fused_class_step",
                 {"ssnt_fused_v2_step": FUSED_V2_ARGTYPES,
                  "ssnt_fused_tone_step": FUSED_TONE_ARGTYPES,
                  "ssnt_fused_class_smem_bytes": [_I] * 4,
                  "ssnt_fused_class_is_wide": [_I] * 2,
                  "ssnt_fused_class_wide_stream": [_I] * 3},
                 ("ssnt_fused_step_max_candidates",
                  "ssnt_fused_step_max_beams", "ssnt_fused_cluster_blocks"))


@functools.lru_cache(maxsize=None)
def fused_v1_library() -> ctypes.CDLL:
    return _load("fused_v1_step",
                 {"ssnt_fused_v1_step": FUSED_V1_ARGTYPES,
                  "ssnt_fused_v1_smem_bytes": [_I] * 5,
                  "ssnt_fused_v1_is_wide": [_I],
                  "ssnt_fused_v1_wide_stream": [_I] * 2},
                 ("ssnt_fused_v1_max_beams", "ssnt_fused_v1_max_candidates"))


@functools.lru_cache(maxsize=None)
def beam_step_library() -> ctypes.CDLL:
    return _load("beam_step",
                 {"ssnt_beam_v2_step": BEAM_V2_ARGTYPES,
                  "ssnt_beam_tone_step": BEAM_TONE_ARGTYPES,
                  "ssnt_beam_v1_step": BEAM_V1_ARGTYPES},
                 ("ssnt_beam_step_max_candidates",
                  "ssnt_beam_step_max_beams"))


@functools.lru_cache(maxsize=None)
def lattice_library() -> ctypes.CDLL:
    return _load("lattice",
                 {"ssnt_lattice_bidir": LATTICE_BIDIR_ARGTYPES,
                  "ssnt_lattice_forward_alphas": LATTICE_FWD_ARGTYPES,
                  "ssnt_lattice_forward_alphas_block": LATTICE_FWD_ARGTYPES,
                  "ssnt_lattice_backward_grads": LATTICE_BWD_ARGTYPES,
                  "ssnt_lattice_backward_grads_block": LATTICE_BWD_ARGTYPES,
                  "ssnt_lattice_backward_betas": LATTICE_BETAS_ARGTYPES,
                  "ssnt_lattice_backward_betas_block":
                      LATTICE_BETAS_ARGTYPES,
                  "ssnt_lattice_bidir_exp": LATTICE_BIDIR_ARGTYPES,
                  "ssnt_lattice_expin": LATTICE_EXPIN_ARGTYPES,
                  "ssnt_lattice_forward_alphas_banded":
                      LATTICE_FWD_BANDED_ARGTYPES,
                  "ssnt_lattice_backward_grads_banded":
                      LATTICE_BWD_BANDED_ARGTYPES,
                  "ssnt_lattice_banded_max_t": [_I, _I]},
                 ("ssnt_lattice_max_t",))


def check_arg(name, x, dtype, shape, device):
    """Raise unless x is a contiguous tensor of `dtype` (one dtype or a
    tuple of them) and `shape` on `device`: what a kernel may be handed."""
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if x.dtype not in dtypes or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, "
                         f"got {x.dtype} {tuple(x.shape)}")
    if x.device != device or not x.is_contiguous():
        raise ValueError(f"{name}: want a contiguous tensor on {device}")
