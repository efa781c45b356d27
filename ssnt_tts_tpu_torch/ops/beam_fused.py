"""Model-fused decode steps (v2, tone and v1): one launch per step.

Port of ssnt_tts_tpu/ops/beam_fused.py. A class step (kind="v2" or
"tone") runs the AR class cell (embedding + GRU + correction head +
log_softmax) for every beam, the candidate grid (v2: every duration
prune; tone: none), the stable top-W selection and the parent-pointer
reorder of the GRU state. The v1 step runs the mel prenet, the GRU and
the transition and frame joints at each beam's source row, the
emit/shift candidates, the selection, and the reorder of the GRU state
and the mel frames.

  - `fused_class_beam_step` (v2), `fused_tone_step` and
    `fused_v1_beam_step` are the wrappers. For CUDA tensors they launch
    the hand-written kernels csrc/fused_class_step.cu and
    csrc/fused_v1_step.cu (built by ops/_build.py) or raise; each adds one
    to its own `.launches` per launch. For CPU tensors they run the plain
    version.
  - The `*_reference` functions are the plain versions: the stepmath
    step (class_step_from_paths, v1_step_math), then the plain beam_v2 /
    tone_latent / beam_v1 step, then gathers by parent pointer.
  - `prepare_fused_weights` / `prepare_v1_fused_weights` cast and check
    the weights once per decode and pack the kernels' matrices into the
    streams the kernels read, beside the fields: `.packed` (`pack_dense`,
    `pack_gru`: one stream per block of an utterance's cluster, 16x16
    tiles in mma.sync fragment order, csrc/gru_step.cuh), which the narrow
    instances and the float32 wide ones read, and `.packed_wide`
    (`pack_wide_dense`, `pack_wide_gru`: rounds of 64-column tiles in
    wgmma's canonical layout, csrc/wide_step.cuh), which the bfloat16 wide
    instances (W > 16, or more than 256 class candidates) read. The
    wrappers then check only the per-step tensors; weights built by hand
    run the plain version on the CPU and are refused on the card.

The TPU kernel's carry layouts ((B, 1, W) lane rows, (B, W, 1) prev_class,
a kernel-emitted step counter) are dropped: beam state is (B, W), and the
step index s is an argument.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.ops import _build, beam_v1, beam_v2, tone_latent
from ssnt_tts_tpu_torch.utils.config import V2BeamConfig


# Blocks of an utterance's cluster (csrc/gru_step.cuh kCL): each packed
# stream has one row per block.
CLUSTER = 2

# The widths every beam kernel takes (csrc/beam_select.cuh kMaxBeams,
# kMaxCands; each library reports its own): beams in and slots out, and
# candidates a step (v2 W*D, tone W*K, v1 2W). JAX sizes its blocks to
# VMEM and takes any width; at D=10, H=256 its fused step admits W up to
# about 128. The plain versions take every width.
MAX_BEAMS = 128
MAX_CANDIDATES = 2048


def check_beam_shape(W: int, W_out: int, C: int) -> None:
    """Raise ValueError unless a beam kernel takes W beams, W_out output
    slots and C candidates (the kernels' limits; callable on any
    device, before a launch)."""
    if not 1 <= W <= MAX_BEAMS or not 1 <= W_out <= MAX_BEAMS:
        raise ValueError(f"beam width {W}, output width {W_out}: the beam "
                         f"kernels take 1 to MAX_BEAMS = {MAX_BEAMS}")
    if C > MAX_CANDIDATES:
        raise ValueError(f"{C} candidates a step: the beam kernels take at "
                         f"most MAX_CANDIDATES = {MAX_CANDIDATES}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _fragment_order():
    """(m, k) of each of a 16x16 tile's 256 values in the kernels' order:
    lane L = 4g + t holds values 8L .. 8L + 7 at (g, 2t), (g, 2t+1),
    (g+8, 2t), (g+8, 2t+1), (g, 2t+8), (g, 2t+9), (g+8, 2t+8),
    (g+8, 2t+9): its mma.sync m16n8k16 A fragment."""
    p = torch.arange(256)
    lane, j = p // 8, p % 8
    g, t, reg = lane // 4, lane % 4, j // 2
    return g + 8 * (reg % 2), 2 * t + j % 2 + 8 * (reg // 2)


_FRAG_M, _FRAG_K = _fragment_order()


def _tiles(a: torch.Tensor) -> torch.Tensor:
    """(..., 16 m, 16 k) tiles of W^T -> (..., 256) in fragment order."""
    return a[..., _FRAG_M.to(a.device), _FRAG_K.to(a.device)]


def pack_dense(w: torch.Tensor) -> torch.Tensor:
    """A dense kernel w (K, N), (in, out) layout, as the fused kernels
    stream it: (CLUSTER, KT * MT * 256) with KT = ceil(K/16) input tiles
    and MT = ceil(ceil(N/16) / CLUSTER) 16-column tiles per block; block r
    owns column tiles r*MT .. r*MT + MT - 1; tile (kt, mt) at kt*MT + mt
    holds A[m][k] = w[16 kt + k][16 (r MT + mt) + m], zero past K and N."""
    K, N = w.shape
    KT, MT = _cdiv(K, 16), _cdiv(_cdiv(N, 16), CLUSTER)
    p = w.new_zeros(KT * 16, CLUSTER * MT * 16)
    p[:K, :N] = w
    a = p.reshape(KT, 16, CLUSTER, MT, 16).permute(2, 0, 3, 4, 1)
    return _tiles(a).reshape(CLUSTER, -1)


def pack_gru(wi: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The GRU kernels wi, wh (H, 3H) [r|z|n] as the fused kernels stream
    them: block r owns hidden-unit tiles r*HR .. r*HR + HR - 1 (HR =
    ceil(ceil(H/16) / CLUSTER)), each as six column tiles [wi_r, wi_z,
    wi_n, wh_r, wh_z, wh_n] (MT = 6 HR), input-tile-major as pack_dense."""
    H = wh.shape[0]
    KT, HR = _cdiv(H, 16), _cdiv(_cdiv(H, 16), CLUSTER)
    gates = []
    for w in (wi, wh):
        for g in range(3):
            p = w.new_zeros(KT * 16, CLUSTER * HR * 16)
            p[:H, :H] = w[:, g * H:(g + 1) * H]
            gates.append(p)
    a = torch.stack(gates).reshape(6, KT, 16, CLUSTER, HR, 16)
    return _tiles(a.permute(3, 1, 4, 0, 5, 2)).reshape(CLUSTER, -1)


def _share(N: int) -> int:
    """A block's share of a layer of N outputs: its 16-column tiles."""
    return _cdiv(_cdiv(N, 16), CLUSTER) * 16


def _wide_tiles(a: torch.Tensor) -> torch.Tensor:
    """(..., 64 m, 16 k) A tiles -> (..., 1024) in wgmma's K-major
    canonical order without swizzle (csrc/wide_step.cuh): (m, k) at
    ((m//8) 2 + k//8) 64 + (m%8) 8 + k%8."""
    lead = a.shape[:-2]
    return a.reshape(*lead, 8, 8, 2, 8).transpose(-3, -2).reshape(*lead, 1024)


def _wide_blocks(w: torch.Tensor) -> torch.Tensor:
    """A dense kernel w (K, N) as each block's 64-column m-tiles:
    (CLUSTER, MT, KT*16, 64), block r's share of columns r*UN ..
    r*UN + UN - 1 (UN = _share(N)) from its first m-tile on, zero past
    K, the share and N."""
    K, N = w.shape
    UN = _share(N)
    MT, KT = _cdiv(UN, 64), _cdiv(K, 16)
    p = w.new_zeros(KT * 16, CLUSTER, MT * 64)
    for r in range(CLUSTER):
        n = max(0, min(UN, N - r * UN))
        p[:K, r, :n] = w[:, r * UN:r * UN + n]
    return p.reshape(KT * 16, CLUSTER, MT, 64).permute(1, 2, 0, 3)


def _wide_pairs(blocks: torch.Tensor) -> list:
    """(CLUSTER, T, Kp, 64) m-tiles -> the rounds that take them, two a
    round (warpgroups 0 and 1), the last round one when T is odd."""
    return [blocks[:, i:i + 2] for i in range(0, blocks.shape[1], 2)]


def _wide_stream(rounds: list) -> torch.Tensor:
    """Rounds, each (CLUSTER, nwg, Kp, 64), -> the wide stream
    (CLUSTER, tiles * 1024): a round's A tiles input-tile-major, its
    warpgroups' tiles of an input tile side by side."""
    out = []
    for r in rounds:
        CL, nwg, Kp, _ = r.shape
        a = r.reshape(CL, nwg, Kp // 16, 16, 64).transpose(-1, -2)
        out.append(_wide_tiles(a).transpose(1, 2).reshape(CL, -1))
    return torch.cat(out, 1)


def pack_wide_dense(w: torch.Tensor) -> torch.Tensor:
    """A dense kernel w (K, N) as the bfloat16 wide instances stream it
    (csrc/wide_step.cuh): (CLUSTER, tiles * 1024), the block's m-tiles
    (_wide_blocks) two a round."""
    return _wide_stream(_wide_pairs(_wide_blocks(w)))


# The GRU's gate rounds (csrc/wide_step.cuh gru_gate), by index into
# [wi_r, wi_z, wi_n, wh_r, wh_z, wh_n].
_WIDE_GRU_GATES = (0, 3, 5, 2, 1, 4)


def _wide_gru_rounds(wi: torch.Tensor, wh: torch.Tensor) -> list:
    H = wh.shape[0]
    gates = [_wide_blocks(w[:, g * H:(g + 1) * H])
             for w in (wi, wh) for g in range(3)]
    UG = gates[0].shape[1]
    return [gates[j][:, p:p + 2] for p in range(0, UG, 2)
            for j in _WIDE_GRU_GATES]


def pack_wide_gru(wi: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The GRU kernels wi, wh (H, 3H) [r|z|n] as the bfloat16 wide
    instances stream them: for each pair of the block's 64-unit groups
    (its share of the hidden units, _share(H)), six rounds, the gates in
    _WIDE_GRU_GATES' order (r, then n, then z), warpgroup g taking unit
    group g of the pair."""
    return _wide_stream(_wide_gru_rounds(wi, wh))


def pack_wide_v1(f: dict) -> torch.Tensor:
    """The v1 step's six matrices as its bfloat16 wide instance streams
    them (csrc/fused_v1_step.cu v1_wide_stream): prenet w1, w2, the GRU,
    dec_pre and dec_mel as one group of m-tiles (dec_pre's first),
    dec_proj."""
    dense = lambda k: _wide_pairs(_wide_blocks(f[k]))
    heads = torch.cat([_wide_blocks(f["dec_pre_k"]),
                       _wide_blocks(f["dec_mel_k"])], 1)
    return _wide_stream(dense("prenet_w1") + dense("prenet_w2")
                        + _wide_gru_rounds(f["wi"], f["wh"])
                        + _wide_pairs(heads) + dense("dec_proj_k"))


def _check_weights(what, fields, shapes, dtypes) -> None:
    """Raise unless each field has its shape and dtype."""
    for name, x in fields.items():
        if tuple(x.shape) != shapes[name] or x.dtype != dtypes[name]:
            raise ValueError(f"{what} {name}: want {dtypes[name]} "
                             f"{shapes[name]}, got {x.dtype} "
                             f"{tuple(x.shape)}")


def _check_compute_dtype(dtype) -> None:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} is not float32 or bfloat16")


class FusedWeights(NamedTuple):
    """Kernel-ready weights, cast once per decode: the compute dtype for
    embed/wi/bi/wh/bhn (it is the kernel's compute dtype), float32 for the
    correction head. All contiguous, on the decode's device."""

    embed: torch.Tensor  # (D, H)
    wi: torch.Tensor     # (H, 3H)
    bi: torch.Tensor     # (3H,)
    wh: torch.Tensor     # (H, 3H)
    bhn: torch.Tensor    # (H,)
    out_k: torch.Tensor  # (H, D) float32
    out_b: torch.Tensor  # (D,) float32


class _Packed:
    """Weights as prepare_*_fused_weights return them: the NamedTuple's
    fields (the plain step's; iterating gives exactly those) and, beside
    them, the kernels' streams `packed`, (CLUSTER, tiles * 256), and
    `packed_wide`, (CLUSTER, tiles * 1024)."""

    def __new__(cls, packed: torch.Tensor, packed_wide: torch.Tensor,
                **fields):
        self = super().__new__(cls, **fields)
        self.packed = packed
        self.packed_wide = packed_wide
        return self


class PackedFusedWeights(_Packed, FusedWeights):
    """FusedWeights with packed = pack_gru(wi, wh) and packed_wide =
    pack_wide_gru(wi, wh)."""


def prepare_fused_weights(w: stepmath.ClassStepWeights,
                          dtype) -> PackedFusedWeights:
    """Cast, check and pack the AR class cell's weights once per decode;
    raises on a compute dtype other than float32 / bfloat16 or on weights
    whose shapes do not fit together."""
    _check_compute_dtype(dtype)
    D, H = w.embed.shape
    cast = lambda x, dt: x.detach().to(dt).contiguous()
    f32 = torch.float32
    fields = dict(embed=cast(w.embed, dtype), wi=cast(w.wi, dtype),
                  bi=cast(w.bi, dtype), wh=cast(w.wh, dtype),
                  bhn=cast(w.bhn, dtype), out_k=cast(w.out_k, f32),
                  out_b=cast(w.out_b, f32))
    shapes = dict(embed=(D, H), wi=(H, 3 * H), bi=(3 * H,), wh=(H, 3 * H),
                  bhn=(H,), out_k=(H, D), out_b=(D,))
    _check_weights("class step weights", fields, shapes,
                   {k: f32 if k.startswith("out") else dtype for k in fields})
    return PackedFusedWeights(
        pack_gru(fields["wi"], fields["wh"]),
        pack_wide_gru(fields["wi"], fields["wh"]).contiguous(), **fields)


class V2Step(NamedTuple):
    """One step's outputs. (B, W): prediction (also the next prev_class),
    log_prob, next_t, next_u, is_finished, total_duration, branch;
    (B,): num_survivors, emptied; state (B, W, H) reordered."""

    prediction: torch.Tensor
    log_prob: torch.Tensor
    next_t: torch.Tensor
    next_u: torch.Tensor
    is_finished: torch.Tensor
    total_duration: torch.Tensor
    branch: torch.Tensor
    num_survivors: torch.Tensor
    emptied: torch.Tensor
    state: torch.Tensor


class ToneStep(NamedTuple):
    """One tone step's outputs. (B, W): prediction (also the next
    prev_class), log_prob, next_t, next_u, is_finished, branch; state
    (B, W, H) reordered."""

    prediction: torch.Tensor
    log_prob: torch.Tensor
    next_t: torch.Tensor
    next_u: torch.Tensor
    is_finished: torch.Tensor
    branch: torch.Tensor
    state: torch.Tensor


def _model_step(s, xin_path, base_path, fw, prev_class, state, debug_out):
    """The plain AR class cell on path row s: (h, new_h), copied into
    debug_out when given."""
    h, new_h = stepmath.class_step_from_paths(
        *fw, xin_path[s][:, None], base_path[s][:, None], state, prev_class)
    if debug_out is not None:
        debug_out[0].copy_(h)
        debug_out[1].copy_(new_h)
    return h, new_h


def reorder_state(state, branch):
    """state (B, W, H) -> state[b, branch[b, j]] (B, W, H)."""
    return torch.gather(
        state, 1, branch.long()[..., None].expand(-1, -1, state.shape[-1]))


def fused_class_beam_step_reference(
    s: int, xin_path, base_path, fw: FusedWeights, prev_class, state,
    log_prob, is_finished, total_duration, t, u, input_length,
    output_length, duration_table, emptied,
    *, zero_duration_id: int = 0, allow_skip: bool = False,
    test_mode: bool = False, config: Optional[V2BeamConfig] = None,
    debug_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> V2Step:
    """Plain PyTorch version of the fused v2 step (any device)."""
    h, new_h = _model_step(s, xin_path, base_path, fw, prev_class, state,
                           debug_out)
    (pred, lp, nt, nu, fin, tot, branch, nsurv) = beam_v2.beam_search_step(
        h, log_prob, is_finished, total_duration, duration_table, t, u,
        input_length, output_length, zero_duration_id=zero_duration_id,
        allow_skip=allow_skip, test_mode=test_mode, config=config)
    return V2Step(pred, lp, nt, nu, fin, tot, branch, nsurv,
                  emptied | (nsurv == 0), reorder_state(new_h, branch))


def _check_model_args(s, xin_path, base_path, fw, prev_class, state,
                      log_prob, is_finished, t, u, input_length, debug_out):
    """Raise unless the fused kernel can take these (CUDA) tensors; the
    weights were checked and packed by prepare_fused_weights. Returns
    (library, compute dtype, B, W, D, H, debug outputs: the caller's, the
    float32 wide kernel's scratch or None, the weight stream the launch
    reads)."""
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"fused class step runs on cuda or cpu, not {dev}")
    packed = getattr(fw, "packed", None)
    if packed is None or packed.device != dev:
        raise ValueError("fused class step: weights not packed on "
                         f"{dev}; prepare them with prepare_fused_weights")
    B, W, H = state.shape
    T, D = base_path.shape[0], base_path.shape[2]
    check_beam_shape(W, W, W * D)
    ct = packed.dtype
    lib = _build.fused_class_library()
    if not 0 <= s < T:
        raise ValueError(f"step {s} out of range [0, {T})")
    if fw.embed.shape != (D, H):
        raise ValueError(f"weights are for (D, H) {tuple(fw.embed.shape)}, "
                         f"the step has ({D}, {H})")
    i32, f32 = torch.int32, torch.float32
    for name, x, dt, shape in (
        ("xin_path", xin_path, ct, (T, B, H)),
        ("base_path", base_path, f32, (T, B, D)),
        ("prev_class", prev_class, i32, (B, W)),
        ("state", state, f32, (B, W, H)), ("log_prob", log_prob, f32, (B, W)),
        ("is_finished", is_finished, torch.bool, (B, W)),
        ("t", t, i32, (B, W)), ("u", u, i32, (B, W)),
        ("input_length", input_length, i32, (B,)),
    ):
        _build.check_arg(name, x, dt, shape, dev)
    wide = bool(lib.ssnt_fused_class_wide_stream(int(ct == torch.bfloat16),
                                                 W, D))
    dbg = (None, None)
    if debug_out is not None:
        _build.check_arg("debug h", debug_out[0], f32, (B, W, D), dev)
        _build.check_arg("debug new_h", debug_out[1], f32, (B, W, H), dev)
        dbg = tuple(debug_out)
    elif lib.ssnt_fused_class_is_wide(W, D) and not wide:
        # The float32 wide kernel keeps new_h before the reorder in device
        # memory.
        dbg = (None, torch.empty(B, W, H, dtype=f32, device=dev))
    return lib, ct, B, W, D, H, dbg, fw.packed_wide if wide else packed


def _ptr_or_null(x):
    return None if x is None else x.data_ptr()


def _weight_ptrs(fw: FusedWeights, stream: torch.Tensor):
    """The kernels' weight arguments: embed, the packed GRU stream, bi,
    bhn, out_k, out_b."""
    return tuple(x.data_ptr() for x in (fw.embed, stream, fw.bi, fw.bhn,
                                        fw.out_k, fw.out_b))


def fused_class_beam_step(
    s: int, xin_path, base_path, fw: FusedWeights, prev_class, state,
    log_prob, is_finished, total_duration, t, u, input_length,
    output_length, duration_table, emptied,
    *, zero_duration_id: int = 0, allow_skip: bool = False,
    test_mode: bool = False, config: Optional[V2BeamConfig] = None,
    debug_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> V2Step:
    """One fused v2 decode step.

    s: step index; xin_path (T, B, H) compute dtype and base_path (T, B, D)
    f32 from stepmath.class_decode_paths; prev_class (B, W) int32;
    state (B, W, H) f32; log_prob (B, W) f32; is_finished (B, W) bool;
    total_duration/t/u (B, W) int32; input_length/output_length (B,)
    int32 (output_length already zeroed in test_mode); duration_table (D,)
    int32; emptied (B,) bool. debug_out: optional (h (B, W, D),
    new_h (B, W, H)) float32 tensors that receive the step's class
    log-probs and pre-reorder state.
    """
    kw = dict(zero_duration_id=zero_duration_id, allow_skip=allow_skip,
              test_mode=test_mode, config=config, debug_out=debug_out)
    args = (s, xin_path, base_path, fw, prev_class, state, log_prob,
            is_finished, total_duration, t, u, input_length, output_length,
            duration_table, emptied)
    dev = state.device
    if dev.type == "cpu":
        return fused_class_beam_step_reference(*args, **kw)
    lib, ct, B, W, D, H, dbg, stream = _check_model_args(
        s, xin_path, base_path, fw, prev_class, state, log_prob,
        is_finished, t, u, input_length, debug_out)
    if not 0 <= zero_duration_id < D:
        raise ValueError(f"zero_duration_id {zero_duration_id} out of range")
    cfg = config if config is not None else V2BeamConfig()
    i32 = torch.int32
    for name, x, dt, shape in (
        ("total_duration", total_duration, i32, (B, W)),
        ("output_length", output_length, i32, (B,)),
        ("duration_table", duration_table, i32, (D,)),
        ("emptied", emptied, torch.bool, (B,)),
    ):
        _build.check_arg(name, x, dt, shape, dev)

    f32, bl = torch.float32, torch.bool
    new = lambda dt: torch.empty(B, W, dtype=dt, device=dev)
    out = V2Step(
        prediction=new(i32), log_prob=new(f32), next_t=new(i32),
        next_u=new(i32), is_finished=new(bl), total_duration=new(i32),
        branch=new(i32),
        num_survivors=torch.empty(B, dtype=i32, device=dev),
        emptied=torch.empty(B, dtype=bl, device=dev),
        state=torch.empty(B, W, H, dtype=f32, device=dev),
    )
    ptr = lambda x: x.data_ptr()
    rc = lib.ssnt_fused_v2_step(
        int(ct == torch.bfloat16), B, W, D, H, int(s),
        ptr(xin_path), ptr(base_path), *_weight_ptrs(fw, stream),
        *map(ptr, (prev_class, state, log_prob, is_finished, total_duration,
                   t, u, input_length, output_length, duration_table,
                   emptied)),
        *map(ptr, out), *map(_ptr_or_null, dbg),
        int(zero_duration_id), int(bool(allow_skip)), int(bool(test_mode)),
        int(cfg.overrun_multiplier), int(bool(cfg.final_feasible_guard)),
        float(cfg.band_lower_frac), float(cfg.band_upper_frac),
        float(cfg.diagonal_window[0]), float(cfg.diagonal_window[1]),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused v2 step kernel launch failed: "
                           f"cudaError {rc}")
    fused_class_beam_step.launches += 1
    return out


fused_class_beam_step.launches = 0


def fused_tone_step_reference(
    s: int, xin_path, base_path, fw: FusedWeights, prev_class, state,
    log_prob, is_finished, t, u, input_length, *, empty_tone_id: int = 0,
    debug_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> ToneStep:
    """Plain PyTorch version of the fused tone step (any device)."""
    h, new_h = _model_step(s, xin_path, base_path, fw, prev_class, state,
                           debug_out)
    (pred, lp, nt, nu, fin, branch) = tone_latent.beam_search_step(
        h, log_prob, is_finished, t, u, input_length,
        empty_tone_id=empty_tone_id)
    return ToneStep(pred, lp, nt, nu, fin, branch,
                    reorder_state(new_h, branch))


def fused_tone_step(
    s: int, xin_path, base_path, fw: FusedWeights, prev_class, state,
    log_prob, is_finished, t, u, input_length, *, empty_tone_id: int = 0,
    debug_out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> ToneStep:
    """One fused tone decode step.

    Arguments as fused_class_beam_step's, with K tone classes in place of
    D (xin_path/base_path from stepmath.class_decode_paths(kind="tone"))
    and no duration state. The padding candidate of an inactive beam
    predicts empty_tone_id."""
    args = (s, xin_path, base_path, fw, prev_class, state, log_prob,
            is_finished, t, u, input_length)
    dev = state.device
    if dev.type == "cpu":
        return fused_tone_step_reference(
            *args, empty_tone_id=empty_tone_id, debug_out=debug_out)
    lib, ct, B, W, K, H, dbg, stream = _check_model_args(*args, debug_out)
    new = lambda dt: torch.empty(B, W, dtype=dt, device=dev)
    i32 = torch.int32
    out = ToneStep(
        prediction=new(i32), log_prob=new(torch.float32), next_t=new(i32),
        next_u=new(i32), is_finished=new(torch.bool), branch=new(i32),
        state=torch.empty(B, W, H, dtype=torch.float32, device=dev),
    )
    ptr = lambda x: x.data_ptr()
    rc = lib.ssnt_fused_tone_step(
        int(ct == torch.bfloat16), B, W, K, H, int(s),
        ptr(xin_path), ptr(base_path), *_weight_ptrs(fw, stream),
        *map(ptr, args[4:]),
        *map(ptr, out), *map(_ptr_or_null, dbg), int(empty_tone_id),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused tone step kernel launch failed: "
                           f"cudaError {rc}")
    fused_tone_step.launches += 1
    return out


fused_tone_step.launches = 0


# ------------------------------------------------------------------- v1

# Kernel-ready v1 decode-step weights, cast once per decode: the compute
# dtype except dec_bias (float32), contiguous, on the decode's device. The
# fields are stepmath.V1StepWeights' decode side, in its order, so
# stepmath.v1_step_math takes either.
V1FusedWeights = NamedTuple("V1FusedWeights", [
    (k, torch.Tensor) for k in stepmath.V1StepWeights._fields
    if not k.startswith("enc_")])


class PackedV1FusedWeights(_Packed, V1FusedWeights):
    """V1FusedWeights with packed = the six matrices in V1_PACKED's order
    and packed_wide = pack_wide_v1 of them."""


# The v1 kernel's stream: the dense matrices and the GRU in the order the
# frame runs them (csrc/fused_v1_step.cu v1_stream).
V1_PACKED = ("prenet_w1", "prenet_w2", "gru", "dec_pre_k", "dec_mel_k",
             "dec_proj_k")
# The v1 kernel's other weight arguments, in its order.
V1_UNPACKED = ("prenet_b1", "prenet_b2", "bi", "bhn", "dec_pre_b",
               "dec_proj_b", "dec_bias_k", "dec_bias_b", "dec_mel_b")


def v1_weight_shapes(H: int, M: int, R: int) -> dict:
    return {"prenet_w1": (M, H), "prenet_b1": (H,), "prenet_w2": (H, H),
            "prenet_b2": (H,), "wi": (H, 3 * H), "bi": (3 * H,),
            "wh": (H, 3 * H), "bhn": (H,), "dec_pre_k": (H, R),
            "dec_pre_b": (R,), "dec_proj_k": (R, 2 * R),
            "dec_proj_b": (2 * R,), "dec_bias_k": (H, 2),
            "dec_bias_b": (2,), "dec_mel_k": (H, M), "dec_mel_b": (M,)}


def prepare_v1_fused_weights(w: stepmath.V1StepWeights,
                             dtype) -> PackedV1FusedWeights:
    """Cast, check and pack the v1 step's weights once per decode; raises
    on a compute dtype other than float32 / bfloat16 or on weights whose
    shapes do not fit together."""
    _check_compute_dtype(dtype)
    f32 = ("dec_bias_k", "dec_bias_b")
    fields = {k: getattr(w, k).detach().to(torch.float32 if k in f32
                                           else dtype).contiguous()
              for k in V1FusedWeights._fields}
    M, H = fields["prenet_w1"].shape
    R = fields["dec_pre_k"].shape[1]
    _check_weights("v1 step weights", fields, v1_weight_shapes(H, M, R),
                   {k: torch.float32 if k in f32 else dtype for k in fields})
    packed = torch.cat([
        pack_gru(fields["wi"], fields["wh"]) if k == "gru"
        else pack_dense(fields[k]) for k in V1_PACKED], dim=1).contiguous()
    return PackedV1FusedWeights(packed, pack_wide_v1(fields).contiguous(),
                                **fields)


class V1FusedStep(NamedTuple):
    """One fused v1 step's outputs. (B, W): prediction, log_prob, next_t,
    next_u, is_finished, branch, t_history (the parent's source position:
    the frame's alignment); mel (B, W, M) f32 reordered, a finished beam
    keeping its last frame (also the next prev_mel); state (B, W, H)
    reordered."""

    prediction: torch.Tensor
    log_prob: torch.Tensor
    next_t: torch.Tensor
    next_u: torch.Tensor
    is_finished: torch.Tensor
    branch: torch.Tensor
    t_history: torch.Tensor
    mel: torch.Tensor
    state: torch.Tensor


def keep_finished_mel(mel, prev_mel, is_finished, fin_prev):
    """A beam that was finished and stays finished emits no new frame: it
    keeps its last one (JAX beam_decode's post-step where)."""
    return torch.where((is_finished & fin_prev)[..., None], prev_mel, mel)


def fused_v1_beam_step_reference(
    enc_pack, t, u, log_prob, is_finished, input_length, prev_mel, state,
    fw: V1FusedWeights, *,
    debug_out: Optional[Tuple[torch.Tensor, ...]] = None,
) -> V1FusedStep:
    """Plain PyTorch version of fused_v1_beam_step (any device)."""
    B, T, P = enc_pack.shape
    idx = t.long().clamp(0, T - 1)
    gath = torch.gather(enc_pack, 1, idx[..., None].expand(-1, -1, P))
    h, mel, new_h = stepmath.v1_step_math(fw, gath, state, prev_mel,
                                          fw.wi.dtype)
    if debug_out is not None:
        for dst, src in zip(debug_out, (h, new_h, mel)):
            dst.copy_(src)
    pred, lp, nt, nu, fin, branch = beam_v1.beam_search_step(
        h, log_prob, is_finished, t, u, input_length)
    bl = branch.long()
    return V1FusedStep(
        pred, lp, nt, nu, fin, branch, torch.gather(t, 1, bl),
        keep_finished_mel(reorder_state(mel, branch),
                          reorder_state(prev_mel, branch), fin,
                          torch.gather(is_finished, 1, bl)),
        reorder_state(new_h, branch))


def fused_v1_beam_step(
    enc_pack, t, u, log_prob, is_finished, input_length, prev_mel, state,
    fw: V1FusedWeights, *,
    debug_out: Optional[Tuple[torch.Tensor, ...]] = None,
) -> V1FusedStep:
    """One fused v1 decode step: the v1 model step (stepmath.v1_step_math)
    at each beam's enc_pack row, the emit/shift candidates, the stable
    top-W selection, and the reorder of state and mel by parent.

    enc_pack (B, T, 2R+2+M) f32 from stepmath.v1_enc_pack (each beam's
    row is read at clip(t, 0, T - 1)); t, u (B, W) int32; log_prob (B, W)
    f32; is_finished (B, W) bool; input_length (B,) int32; prev_mel
    (B, W, M) f32; state (B, W, H) f32. debug_out: optional float32
    (h (B, W, 2), new_h (B, W, H), mel (B, W, M)) that receive the step's
    log-probs, state and frame before the reorder.
    """
    args = (enc_pack, t, u, log_prob, is_finished, input_length, prev_mel,
            state)
    dev = state.device
    if dev.type == "cpu":
        return fused_v1_beam_step_reference(*args, fw, debug_out=debug_out)
    if dev.type != "cuda":
        raise ValueError(f"fused v1 step runs on cuda or cpu, not {dev}")
    packed = getattr(fw, "packed", None)
    if packed is None or packed.device != dev:
        raise ValueError("fused v1 step: weights not packed on "
                         f"{dev}; prepare them with prepare_v1_fused_weights")
    B, W, H = state.shape
    T, P = enc_pack.shape[1], enc_pack.shape[2]
    M = prev_mel.shape[2]
    R = fw.dec_pre_k.shape[1]
    check_beam_shape(W, W, 2 * W)
    ct = packed.dtype
    lib = _build.fused_v1_library()
    if P != 2 * R + 2 + M or fw.prenet_w1.shape != (M, H):
        raise ValueError(f"row width {P} or widths (H, M) = ({H}, {M}) do "
                         f"not fit the kernel and weights")
    i32, f32 = torch.int32, torch.float32
    for name, x, dt, shape in (
        ("enc_pack", enc_pack, f32, (B, T, P)), ("t", t, i32, (B, W)),
        ("u", u, i32, (B, W)), ("log_prob", log_prob, f32, (B, W)),
        ("is_finished", is_finished, torch.bool, (B, W)),
        ("input_length", input_length, i32, (B,)),
        ("prev_mel", prev_mel, f32, (B, W, M)),
        ("state", state, f32, (B, W, H)),
    ):
        _build.check_arg(name, x, dt, shape, dev)
    wide = bool(lib.ssnt_fused_v1_wide_stream(int(ct == torch.bfloat16), W))
    dbg = (None, None, None)
    if debug_out is not None:
        for name, x, shape in zip(("debug h", "debug new_h", "debug mel"),
                                  debug_out, ((B, W, 2), (B, W, H),
                                              (B, W, M))):
            _build.check_arg(name, x, f32, shape, dev)
        dbg = tuple(debug_out)
    elif lib.ssnt_fused_v1_is_wide(W) and not wide:
        # The float32 wide kernel keeps new_h and mel before the reorder in
        # device memory.
        dbg = (None, *(torch.empty(B, W, n, dtype=f32, device=dev)
                       for n in (H, M)))
    new = lambda dt: torch.empty(B, W, dtype=dt, device=dev)
    out = V1FusedStep(
        prediction=new(i32), log_prob=new(f32), next_t=new(i32),
        next_u=new(i32), is_finished=new(torch.bool), branch=new(i32),
        t_history=new(i32),
        mel=torch.empty(B, W, M, dtype=f32, device=dev),
        state=torch.empty(B, W, H, dtype=f32, device=dev),
    )
    ptr = lambda x: x.data_ptr()
    rc = lib.ssnt_fused_v1_step(
        int(ct == torch.bfloat16), B, W, T, H, M, R,
        *map(ptr, args), ptr(fw.packed_wide if wide else packed),
        *(ptr(getattr(fw, k)) for k in V1_UNPACKED), *map(ptr, out),
        *map(_ptr_or_null, dbg),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused v1 step kernel launch failed: "
                           f"cudaError {rc}")
    fused_v1_beam_step.launches += 1
    return out


fused_v1_beam_step.launches = 0
