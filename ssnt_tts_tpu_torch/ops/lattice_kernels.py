"""SSNT lattice loss on hand-written CUDA kernels.

Port of ssnt_tts_tpu/ops/lattice_pallas.py's default (log-domain) path.
Three kernels in csrc/lattice.cu (built by ops/_build.py) replace the four
TPU kernels the training loss runs:

  lattice_bidir           fused_alphas_betas_pallas (:817) and its
                          lane-packed twin fused_alphas_betas_pallas_packed
                          (:993): alphas and betas in one launch
  lattice_forward_alphas  forward_alphas_pallas (:165)
  lattice_backward_grads  backward_grads_pallas (:596): the reverse beta
                          walk writing d_le/d_ls/d_lf, betas never stored

Each wrapper launches its kernel for CUDA tensors (or raises) and adds one
to its `launches` count per launch; for CPU tensors it runs its plain
version, `<name>_reference`, which repeats the kernel's arithmetic in
PyTorch column by column. The plain versions are used by the tests and by
chip_smoke.py, and by nothing on the main path when a card is present.

`ssnt_loss_kernels` keeps lattice_pallas._grad_mode's routing: columns
with B * pad128(T) <= 8192 (the B=32, T=80 training shape) take the
bidirectional kernel plus the plain-PyTorch posterior pass (XLA
elementwise work in the JAX package); larger columns (B=256) and the
bfloat16-storage variant take forward alphas plus the backward-gradients
kernel. Without gradients only forward alphas run. The 8192 threshold was
measured on a TPU; it is kept so that the same shapes take the same
kernels as in JAX, not because it is right for an H100.
"""

from __future__ import annotations

import torch

from ssnt_tts_tpu_torch.ops import _build
from ssnt_tts_tpu_torch.ops.lattice import (
    NEG,
    _forward_alphas,
    canonicalize,
    gather_logz,
    logaddexp,
    posterior_grads,
    shift_up_t,
    to_ubt,
)

_FUSED_MAX_COLUMN_ELEMS = 8192
_QUEUED = ("exp", "scan", "banded")  # kernels still to port (ROADMAP.md)


def _t_pad(T: int) -> int:
    return ((T + 127) // 128) * 128


def grad_mode(variant: str, B: int, T: int) -> str:
    """"fused" (bidirectional kernel + posterior pass) or "plain" (forward
    alphas + backward gradients), as lattice_pallas._grad_mode routes it.
    variant: "log" (auto), "fused"/"fusedpack" (both the bidirectional
    kernel here), "plain", "bf16" (plain, bfloat16 storage)."""
    if variant in ("plain", "bf16"):
        return "plain"
    if variant in ("fused", "fusedpack"):
        return "fused"
    if variant.startswith(_QUEUED):
        raise NotImplementedError(
            f"lattice variant {variant!r}: its kernel is not ported yet "
            f"(ROADMAP.md, Queue 2)")
    if variant != "log":
        raise ValueError(f"unknown lattice variant {variant!r}")
    return "fused" if B * _t_pad(T) <= _FUSED_MAX_COLUMN_ELEMS else "plain"


# ------------------------------------------------------- plain versions

def lattice_bidir_reference(le, ls, lf, input_length, output_length):
    """Alphas and betas (U, B, T) f32, in the bidirectional kernel's
    operation order (the beta continuation is le + (lf_next + beta))."""
    U, B, T = le.shape
    alphas = _forward_alphas(le, ls, lf)
    t_idx = torch.arange(T, device=le.device)[None, :]
    is_last_t = t_idx == input_length.long()[:, None] - 1
    last_u = output_length.long()[:, None] - 1
    neg = torch.full((B, T), NEG, device=le.device)
    betas = torch.empty_like(alphas)
    beta, lf_next = neg, neg
    for u in range(U - 1, -1, -1):
        cont = lf_next + beta
        rec = logaddexp(le[u] + cont, ls[u] + shift_up_t(cont))
        beta = torch.where(last_u == u, torch.where(is_last_t, le[u], neg),
                           rec)
        betas[u] = beta
        lf_next = lf[u]
    return alphas, betas


def lattice_forward_alphas_reference(le, ls, lf):
    """Alphas (U, B, T) f32 from f32 or bf16 inputs (upcast on load)."""
    return _forward_alphas(le.float(), ls.float(), lf.float())


def lattice_backward_grads_reference(le, ls, lf, alphas, input_length,
                                     output_length, g, logz):
    """(d_le, d_ls, d_lf) in le's dtype: the backward-gradients kernel's
    reverse walk (beta and the three posteriors per column, the
    posterior exponent clamped at 30, zero for an example whose
    logz <= NEG/2), in its operation order."""
    U, B, T = le.shape
    dev = le.device
    le32, ls32, lf32 = le.float(), ls.float(), lf.float()
    t_idx = torch.arange(T, device=dev)[None, :]
    in_len = input_length.long()[:, None]
    out_len = output_length.long()[:, None]
    is_last_t = t_idx == in_len - 1
    t_valid = t_idx < in_len
    logz_c = logz[:, None]
    neg_g = torch.where(logz_c <= NEG / 2, 0.0, -g[:, None])
    neg = torch.full((B, T), NEG, device=dev)
    zero = torch.zeros((), device=dev)
    d = torch.empty((3, U, B, T), device=dev)
    beta, lf_next = neg, neg
    for u in range(U - 1, -1, -1):
        is_last_u = out_len - 1 == u
        valid = t_valid & (u < out_len)

        def post(score):
            return neg_g * torch.where(
                valid, torch.exp(torch.clamp(score, max=30.0)), zero)

        cont = lf_next + beta
        cont_shift_raw = shift_up_t(cont)
        cont_emit = torch.where(is_last_u,
                                torch.where(is_last_t, zero, neg), cont)
        cont_shift = torch.where(is_last_u, neg, cont_shift_raw)
        anorm = alphas[u] - logz_c
        d[0, u] = post(anorm + le32[u] + cont_emit)
        d[1, u] = post(anorm + ls32[u] + cont_shift)
        rec = logaddexp(le32[u] + cont, ls32[u] + cont_shift_raw)
        beta = torch.where(is_last_u, torch.where(is_last_t, le32[u], neg),
                           rec)
        d[2, u] = post(anorm + beta)
        lf_next = lf32[u]
    return tuple(x.to(le.dtype) for x in d)


# ------------------------------------------------------------- wrappers

_STORE = (torch.float32, torch.bfloat16)


def _cuda_args(le, ls, lf, dtypes):
    """Common checks of a (U, B, T) lattice on the card; returns U, B, T
    and the device."""
    dev = le.device
    if dev.type != "cuda":
        raise ValueError(f"lattice kernels run on cuda or cpu, not {dev}")
    U, B, T = le.shape
    lib = _build.lattice_library()
    if not 1 <= T <= lib.ssnt_lattice_max_t() or U < 1:
        raise ValueError(f"lattice (U={U}, B={B}, T={T}) exceeds the kernel")
    for name, x in (("le", le), ("ls", ls), ("lf", lf)):
        _build.check_arg(name, x, dtypes, (U, B, T), dev)
    if not le.dtype == ls.dtype == lf.dtype:
        raise ValueError("le, ls, lf must share one dtype")
    return lib, U, B, T, dev


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def lattice_bidir(le, ls, lf, input_length, output_length):
    """(U, B, T) f32 lattice + (B,) int32 lengths -> (alphas, betas)
    (U, B, T) f32."""
    if le.device.type == "cpu":
        return lattice_bidir_reference(le, ls, lf, input_length,
                                       output_length)
    lib, U, B, T, dev = _cuda_args(le, ls, lf, torch.float32)
    for name, x in (("input_length", input_length),
                    ("output_length", output_length)):
        _build.check_arg(name, x, torch.int32, (B,), dev)
    alphas = torch.empty((U, B, T), device=dev)
    betas = torch.empty((U, B, T), device=dev)
    _raise_on(lib.ssnt_lattice_bidir(
        B, T, U, le.data_ptr(), ls.data_ptr(), lf.data_ptr(),
        input_length.data_ptr(), output_length.data_ptr(),
        alphas.data_ptr(), betas.data_ptr(), _stream(dev)), "lattice_bidir")
    lattice_bidir.launches += 1
    return alphas, betas


def lattice_forward_alphas(le, ls, lf):
    """(U, B, T) f32 or bf16 lattice -> alphas (U, B, T) f32."""
    if le.device.type == "cpu":
        return lattice_forward_alphas_reference(le, ls, lf)
    lib, U, B, T, dev = _cuda_args(le, ls, lf, _STORE)
    alphas = torch.empty((U, B, T), device=dev)
    _raise_on(lib.ssnt_lattice_forward_alphas(
        int(le.dtype == torch.bfloat16), B, T, U, le.data_ptr(),
        ls.data_ptr(), lf.data_ptr(), alphas.data_ptr(), _stream(dev)),
        "lattice_forward_alphas")
    lattice_forward_alphas.launches += 1
    return alphas


def lattice_backward_grads(le, ls, lf, alphas, input_length, output_length,
                           g, logz):
    """(U, B, T) lattice (f32 or bf16) + f32 alphas, (B,) int32 lengths,
    (B,) f32 upstream cotangent g and logz -> (d_le, d_ls, d_lf) in the
    lattice's dtype."""
    if le.device.type == "cpu":
        return lattice_backward_grads_reference(
            le, ls, lf, alphas, input_length, output_length, g, logz)
    lib, U, B, T, dev = _cuda_args(le, ls, lf, _STORE)
    _build.check_arg("alphas", alphas, torch.float32, (U, B, T), dev)
    for name, x, dt in (("input_length", input_length, torch.int32),
                        ("output_length", output_length, torch.int32),
                        ("g", g, torch.float32),
                        ("logz", logz, torch.float32)):
        _build.check_arg(name, x, dt, (B,), dev)
    d = [torch.empty((U, B, T), dtype=le.dtype, device=dev)
         for _ in range(3)]
    _raise_on(lib.ssnt_lattice_backward_grads(
        int(le.dtype == torch.bfloat16), B, T, U,
        *(x.data_ptr() for x in (le, ls, lf, alphas, input_length,
                                 output_length, g, logz, *d)),
        _stream(dev)), "lattice_backward_grads")
    lattice_backward_grads.launches += 1
    return tuple(d)


lattice_bidir.launches = 0
lattice_forward_alphas.launches = 0
lattice_backward_grads.launches = 0
KERNELS = (lattice_bidir, lattice_forward_alphas, lattice_backward_grads)


# ---------------------------------------------------------- the loss

class _KernelLoss(torch.autograd.Function):
    """Time-major core, as lattice_pallas._core: (U, B, T) -> (B,) loss.
    The forward runs the bidirectional kernel when gradients are needed on
    the fused route, and forward alphas alone otherwise."""

    @staticmethod
    def forward(ctx, le, ls, lf, input_length, output_length, mode,
                need_grad):
        betas = None
        if need_grad and mode == "fused":
            alphas, betas = lattice_bidir(le, ls, lf, input_length,
                                          output_length)
        else:
            alphas = lattice_forward_alphas(le, ls, lf)
        logz = gather_logz(alphas, le, input_length, output_length)
        ctx.save_for_backward(le, ls, lf, alphas, betas, logz, input_length,
                              output_length)
        return -logz

    @staticmethod
    def backward(ctx, g):
        le, ls, lf, alphas, betas, logz, il, ol = ctx.saved_tensors
        g = g.float().contiguous()
        if betas is None:
            d = lattice_backward_grads(le, ls, lf, alphas, il, ol, g, logz)
        else:
            d = posterior_grads(le, ls, lf, alphas, betas, logz, il, ol, g)
        return tuple(d) + (None,) * 4


def ssnt_loss_kernels(log_emit, log_shift, log_frame=None,
                      input_length=None, output_length=None, *,
                      variant: str = "log", layout: str = "btu"):
    """ops.lattice.ssnt_loss on the lattice kernels (same semantics and
    gradients). variant "bf16" stores the lattice in bfloat16 (f32 compute
    in the kernels, f32 alphas, bf16 gradients); see grad_mode for the
    others. layout "btu" (B, T, U) or "ubt" (time-major, what the model's
    joints emit). Returns the (B,) float32 per-example NLL."""
    store = torch.bfloat16 if variant == "bf16" else torch.float32
    args = canonicalize(log_emit, log_shift, log_frame, input_length,
                        output_length, layout, dtype=store)
    le, ls, lf, il, ol = to_ubt(args, layout)
    U, B, T = le.shape
    mode = grad_mode(variant, B, T)
    need_grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (le, ls, lf))
    return _KernelLoss.apply(le.contiguous(), ls.contiguous(),
                             lf.contiguous(), il.contiguous(),
                             ol.contiguous(), mode, need_grad)
