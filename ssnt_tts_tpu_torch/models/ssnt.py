"""SSNTModel (PyTorch): the training loss and the serving methods.

Mirrors ssnt_tts_tpu/models/ssnt.py:
  encode -> enc (B, T, He) float32
  decoder_states -> teacher-forced GRU states (B, U, H), the recurrence
    rematerialized in chunks of 8 frames
  lattice_quantities -> (log_emit, log_shift, log_frame), each (U, B, T),
    or in the exp domain (E, S, F, mcol)
  forward / loss -> per-example SSNT NLL / total loss + metrics, with the
    teacher-forced duration and tone AR class heads
  duration_decode_step / tone_decode_step -> per-beam h (B, W, D) + new
    AR class state
  decode_step -> the v1 step: per-beam emit/shift h (B, W, 2), new GRU
    state and mel frame
  synthesize_from_alignment -> mel (B, U, M) through a decoded alignment

The parameter names follow the flax tree's module names (encoder, ar_cell,
transition, frame, duration_head, duration_ar, tone_head, tone_ar), so
ssnt_tts_tpu_torch.convert maps every leaf one to one.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.models.decoder import (
    ARDecoderCell,
    FrameJoint,
    TransitionJoint,
)
from ssnt_tts_tpu_torch.models.encoder import (
    ARClassCell,
    ClassHead,
    TextEncoder,
)
from ssnt_tts_tpu_torch.models.layers import length_mask
from ssnt_tts_tpu_torch.ops import lattice, lattice_kernels, lattice_sharded
from ssnt_tts_tpu_torch.utils.config import ModelConfig
from ssnt_tts_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str, what: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported {what} {name!r}")
    return _DTYPES[name]


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.dtype, "compute dtype")


def lattice_loss(impl: str, lattice_dtype: str, quantities, input_length,
                 output_length, lattice_domain: str = "log"):
    """The lattice NLL (B,) of time-major (U, B, T) quantities: (le, ls,
    lf), or (E, S, F, mcol) in the exp domain.

    impl "auto": the CUDA kernels for CUDA tensors, the plain route
    (ops/lattice.py) for CPU tensors; "xla": the plain route on any
    device; "pallas": the kernel route (whose wrappers run their plain
    versions on CPU tensors). lattice_dtype "bfloat16" selects the kernels'
    bf16-storage variant; the plain route upcasts to float32. The exp
    domain's kernel route is the exp-native loss (lattice_expin); its plain
    route takes logs, log(max(x, 1e-38)) with lf = log(max(F, 1e-38)) +
    mcol, and runs the plain log-domain loss, as JAX's dispatch_exp
    does off the TPU.

    Under an active ops/lattice_sharded.tshard_lattice context whose
    threshold the lattice meets, either domain goes to the T-sharded ring
    in float32 (the exp domain log-ified as above), as JAX's dispatch
    does."""
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown lattice_impl {impl!r}")
    U, B, T = quantities[0].shape
    ts = lattice_sharded.active_tshard(U, B, T)
    kernels = impl == "pallas" or (impl == "auto"
                                   and quantities[0].is_cuda)
    if lattice_domain == "exp":
        if kernels and ts is None:
            return lattice_kernels.ssnt_loss_expin_kernels(
                *quantities, input_length, output_length)
        E, S, F, mcol = quantities
        logs = [torch.log(torch.clamp(x.float(), min=1e-38))
                for x in (E, S, F)]
        logs[2] = logs[2] + mcol[:, :, None]
        if ts is not None:
            return lattice_sharded.ssnt_loss_tsharded(
                *logs, input_length, output_length, ts[0], axis=ts[1])
        return lattice.ssnt_loss(*logs, input_length, output_length,
                                 layout="ubt")
    if ts is not None:
        return lattice_sharded.ssnt_loss_tsharded(
            *(x.float() for x in quantities), input_length, output_length,
            ts[0], axis=ts[1])
    if not kernels:
        return lattice.ssnt_loss(*quantities, input_length, output_length,
                                 layout="ubt")
    variant = "bf16" if lattice_dtype == "bfloat16" else "log"
    return lattice_kernels.ssnt_loss_kernels(
        *quantities, input_length, output_length, variant=variant,
        layout="ubt")


def _gru_chunk(gi, wh, bhn, state) -> tuple:
    """The GRU recurrence over gi's frames (B, c, 3H): each frame's state."""
    outs = []
    for gi_u in gi.unbind(1):
        state = stepmath.gru_update(gi_u, wh, bhn, state)
        outs.append(state)
    return tuple(outs)


def token_mask(tokens, input_length=None) -> torch.Tensor:
    """(B, T) bool: the positions inside each utterance."""
    B, T = tokens.shape
    if input_length is None:
        return torch.ones(B, T, dtype=torch.bool, device=tokens.device)
    return length_mask(input_length, T)


def loss_normalizers(tokens, input_length=None) -> torch.Tensor:
    """(2,) int64 [batch size, valid tokens]: what SSNTModel.loss divides
    by."""
    return torch.stack([torch.tensor(tokens.shape[0], device=tokens.device),
                        token_mask(tokens, input_length).sum()])


class SSNTModel(nn.Module):
    """Parameters are uninitialized until a state dict is loaded
    (ssnt_tts_tpu_torch.convert.flax_to_torch). They are built on the first
    CUDA device unless `device` names another (the tests pass "cpu")."""

    def __init__(self, config: ModelConfig, *, device=None):
        super().__init__()
        cfg = self.config = config
        dt = self.dtype = compute_dtype(cfg)
        ldt = _dtype(cfg.lattice_dtype, "lattice dtype")
        He, H = cfg.encoder_dim, cfg.decoder_dim
        kw = dict(device=resolve_device(device))
        self.encoder = TextEncoder(cfg.vocab_size, He, cfg.encoder_layers,
                                   cfg.encoder_heads, dt, **kw)
        self.ar_cell = ARDecoderCell(cfg.mel_dim, H, dt, **kw)
        self.transition = TransitionJoint(He, H, cfg.joint_rank, dt, ldt,
                                          cfg.lattice_domain, **kw)
        self.frame = FrameJoint(He, H, cfg.mel_dim, dt, ldt,
                                cfg.lattice_domain, **kw)
        self.duration_head = ClassHead(He, cfg.duration_class_size, He, dt,
                                       **kw)
        self.duration_ar = ARClassCell(He, cfg.duration_class_size, H, dt,
                                       **kw)
        self.tone_head = ClassHead(He, cfg.tone_class_size, He, dt, **kw)
        self.tone_ar = ARClassCell(He, cfg.tone_class_size, H, dt, **kw)

    # ------------------------------------------------------------- pieces

    def encode(self, tokens, input_length=None):
        return self.encoder(tokens, input_length)

    def decoder_states(self, mel_target, *, chunk: int = 8):
        """Teacher-forced AR states: dec[u] summarizes frames < u.

        mel_target (B, U, M) -> (B, U, H) float32; frame 0 sees a zero
        frame. The prenet and the GRU's input projection do not depend on
        the carry, so they run once over all U frames; the recurrence runs
        in chunks of `chunk` frames (the last one shorter when chunk does
        not divide U), each under a non-reentrant checkpoint, as JAX's
        nn.remat over chunks: autograd keeps each chunk's input carry
        instead of every frame's activations (about ten (B, H) tensors a
        frame) and recomputes one chunk at a time in the backward. The
        recomputation runs the same operations, and the graph is the
        unchunked loop's (each frame's state is its own output, stacked
        once), so values and gradients are those of the plain loop bit for
        bit."""
        B, U, M = mel_target.shape
        shifted = torch.cat(
            [torch.zeros_like(mel_target[:, :1]), mel_target[:, :-1]], dim=1)
        cell = self.ar_cell.cell
        gi = stepmath.gru_input(cell.wi, cell.bi,
                                self.ar_cell.prenet(shifted).to(self.dtype))
        state = torch.zeros(B, self.config.decoder_dim,
                            device=mel_target.device)
        outs = []
        for gi_c in gi.split(chunk, dim=1):
            # The chunk draws no random numbers and its recomputation's
            # tensors are its forward's by construction: the RNG stash and
            # the metadata comparison (a Python call a saved tensor) go.
            outs += checkpoint(_gru_chunk, gi_c, cell.wh, cell.bhn, state,
                               use_reentrant=False, preserve_rng_state=False,
                               determinism_check="none")
            state = outs[-1]
        return torch.stack(outs, dim=1)

    def lattice_quantities(self, enc, dec, mel_target, input_length=None):
        """(log_emit, log_shift, log_frame), each (U, B, T) in the
        configured lattice dtype; in the exp domain (E, S, F, mcol), where
        input_length restricts the column max to valid t."""
        a, b = self.transition(enc, dec)
        f = self.frame(enc, dec, mel_target, input_length)
        return (a, b) + (f if self.config.lattice_domain == "exp" else (f,))

    def _nll(self, enc, mel_target, input_length, output_length):
        cfg = self.config
        q = self.lattice_quantities(enc, self.decoder_states(mel_target),
                                    mel_target, input_length)
        return lattice_loss(cfg.lattice_impl, cfg.lattice_dtype, q,
                            input_length, output_length, cfg.lattice_domain)

    # ------------------------------------------------------------ training

    def forward(self, tokens, mel_target, input_length=None,
                output_length=None):
        """Training forward: per-example SSNT NLL (B,) float32."""
        enc = self.encode(tokens, input_length)
        return self._nll(enc, mel_target, input_length, output_length)

    def loss(self, tokens, mel_target, input_length=None, output_length=None,
             duration_target=None, tone_target=None, *, batch_size=None,
             token_count=None):
        """Total training loss (0-d) + metrics dict of 0-d tensors.

        Auxiliary heads train from optional (B, T) int targets, masked by
        input_length: durations (teacher-forced AR CE, and the duration
        lattice when config.use_duration_lattice) and tones.

        The per-frame NLLs are summed over the batch and divided by
        batch_size, the token NLLs by token_count (a 0-d int tensor);
        by default this batch's own (loss_normalizers), as JAX's mean over
        the batch and sum over its valid tokens. A data-parallel rank
        passes the global batch's, so that the ranks' losses sum to the
        global batch's loss (parallel/train.make_sharded_train_step)."""
        B, U, _ = mel_target.shape
        T = tokens.shape[1]
        dev = mel_target.device
        enc = self.encode(tokens, input_length)
        nll = self._nll(enc, mel_target, input_length, output_length)
        if output_length is None:
            frames = torch.full((B,), float(U), device=dev)
        else:
            frames = output_length.float()
        if batch_size is None:
            batch_size = B
        loss = (nll / frames.clamp(min=1.0)).sum() / batch_size
        metrics = {"nll_per_frame": loss}

        tmask = token_mask(tokens, input_length)
        if token_count is None:
            token_count = tmask.sum()
        denom = token_count.clamp(min=1)

        def masked_ce(logp, target):
            nll_t = -torch.gather(logp, -1, target.long()[..., None])[..., 0]
            return torch.where(tmask, nll_t, 0.0).sum() / denom

        cfg = self.config
        if duration_target is not None:
            dur_loss = masked_ce(
                self.duration_ar_log_probs(enc, duration_target),
                duration_target)
            loss = loss + dur_loss
            metrics["duration_nll"] = dur_loss
        if cfg.use_duration_lattice and output_length is not None:
            dur_lat_nll = lattice.ssnt_duration_loss(
                self._head_log_probs(self.duration_head, enc),
                cfg.duration_table, input_length, output_length)
            dur_lat = ((dur_lat_nll / frames.clamp(min=1.0)).sum()
                       / batch_size)
            loss = loss + cfg.duration_lattice_weight * dur_lat
            metrics["duration_lattice_nll_per_frame"] = dur_lat
        if tone_target is not None:
            tone_loss = masked_ce(self.tone_ar_log_probs(enc, tone_target),
                                  tone_target)
            loss = loss + tone_loss
            metrics["tone_nll"] = tone_loss
        metrics["loss"] = loss
        return loss, metrics

    # ------------------------------------------------------------- heads

    @staticmethod
    def _head_log_probs(head, enc):
        """ClassHead's per-position log-probs (flax ClassHead.__call__)."""
        return stepmath.log_softmax(head.out(torch.relu(head.h1(enc))))

    def duration_log_probs(self, tokens, input_length=None):
        """(B, T, D) per-position log-probs (non-AR)."""
        return self._head_log_probs(self.duration_head,
                                    self.encode(tokens, input_length))

    def tone_log_probs(self, tokens, input_length=None):
        """(B, T, K) per-position log-probs."""
        return self._head_log_probs(self.tone_head,
                                    self.encode(tokens, input_length))

    def _ar_class_log_probs(self, head, ar, enc, classes):
        """Teacher-forced AR class log-probs: (B, T) target ids ->
        (B, T, D), with the parameters the per-beam decode steps use."""
        B = enc.shape[0]
        w = stepmath.extract_class_step_weights(head, ar)
        xin = stepmath.enc_in_proj(w, enc, self.dtype)  # (B, T, H)
        base = stepmath.head_base(w, enc, self.dtype)   # (B, T, D)
        prev = torch.cat([torch.zeros_like(classes[:, :1]), classes[:, :-1]],
                         dim=1)
        embed = w.embed.to(self.dtype)
        state = torch.zeros(B, self.config.decoder_dim, device=enc.device)
        outs = []
        for xin_t, base_t, prev_t in zip(xin.unbind(1), base.unbind(1),
                                         prev.unbind(1)):
            logp, state = stepmath.class_step_from_paths(
                embed, w.wi, w.bi, w.wh, w.bhn, w.out_k, w.out_b, xin_t,
                base_t, state, prev_t)
            outs.append(logp)
        return torch.stack(outs, dim=1)

    def duration_ar_log_probs(self, enc, duration_classes):
        return self._ar_class_log_probs(self.duration_head, self.duration_ar,
                                        enc, duration_classes)

    def tone_ar_log_probs(self, enc, tone_classes):
        return self._ar_class_log_probs(self.tone_head, self.tone_ar, enc,
                                        tone_classes)

    # ------------------------------------------------------------- decode

    def duration_step_weights(self) -> stepmath.ClassStepWeights:
        return stepmath.extract_class_step_weights(self.duration_head,
                                                   self.duration_ar)

    def tone_step_weights(self) -> stepmath.ClassStepWeights:
        return stepmath.extract_class_step_weights(self.tone_head,
                                                   self.tone_ar)

    def duration_decode_step(self, enc, beam_t, state, prev_class):
        """Per-beam v2 conditioning. enc (B, T, He); beam_t (B, W) source
        positions; state (B, W, H); prev_class (B, W).
        Returns (h (B, W, D) log-probs, new_state (B, W, H))."""
        return self._class_decode_step(self.duration_step_weights(), enc,
                                       beam_t, state, prev_class)

    def tone_decode_step(self, enc, beam_t, state, prev_class):
        """Per-beam tone conditioning, as duration_decode_step:
        (h (B, W, K) log-probs, new_state (B, W, H))."""
        return self._class_decode_step(self.tone_step_weights(), enc,
                                       beam_t, state, prev_class)

    def _class_decode_step(self, w, enc, beam_t, state, prev_class):
        T = enc.shape[1]
        idx = beam_t.long().clamp(0, T - 1)
        enc_t = torch.gather(
            enc, 1, idx[..., None].expand(-1, -1, enc.shape[2]))
        return stepmath.class_step_math(w, enc_t, state, prev_class,
                                        self.dtype)

    def v1_step_weights(self) -> stepmath.V1StepWeights:
        return stepmath.extract_v1_step_weights(self.ar_cell,
                                                self.transition, self.frame)

    def decode_step(self, enc, beam_t, dec_state, prev_mel):
        """One v1 decode step for every beam of every utterance.

        enc (B, T, He); beam_t (B, W) source positions (clipped to
        [0, T - 1]); dec_state (B, W, H) GRU carries; prev_mel (B, W, M).
        Returns (h (B, W, 2) emit/shift log-probs, new dec_state
        (B, W, H), mel (B, W, M)): the ar_cell step, then
        transition.step and frame.predict at each beam's enc row."""
        T = enc.shape[1]
        idx = beam_t.long().clamp(0, T - 1)
        enc_t = torch.gather(
            enc, 1, idx[..., None].expand(-1, -1, enc.shape[2]))
        B, W, H = dec_state.shape
        new_state, dec_out = self.ar_cell(dec_state.reshape(B * W, H),
                                          prev_mel.reshape(B * W, -1))
        dec_out = dec_out.reshape(B, W, H)
        return (self.transition.step(enc_t, dec_out),
                new_state.reshape(B, W, H),
                self.frame.predict(enc_t, dec_out))

    def synthesize_from_alignment(self, enc, source_indexes):
        """Mel frames through a decoded alignment map.

        enc (B, T, He); source_indexes (B, U) int (out-of-range entries are
        clipped; callers mask with the true output length).
        Returns mel (B, U, M) float32."""
        B, T, He = enc.shape
        U = source_indexes.shape[1]
        src = source_indexes.long().clamp(0, T - 1)
        enc_path = torch.gather(enc, 1, src[..., None].expand(-1, -1, He))
        state = torch.zeros(B, self.config.decoder_dim, device=enc.device)
        prev_mel = torch.zeros(B, self.config.mel_dim, device=enc.device)
        mels = []
        for j in range(U):
            state, dec_out = self.ar_cell(state, prev_mel)
            prev_mel = self.frame.predict(enc_path[:, j], dec_out)
            mels.append(prev_mel)
        return torch.stack(mels, dim=1)
