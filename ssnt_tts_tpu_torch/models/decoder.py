"""Mel prenet, AR decoder cell and the lattice joints (PyTorch).

Mirrors ssnt_tts_tpu/models/decoder.py: the GRU over mel frames, the
factorized transition joint (emit/shift log-probs) and the Gaussian frame
joint. The joints emit the time-major (U, B, T) lattice the loss kernels
consume, normalized in float32 and stored in `lattice_dtype`; each also has
its decode-side method (FrameJoint.predict, the point prediction
a(enc_t) + b(dec_u) that synthesis emits). With lattice_domain="exp" they
emit probabilities instead (E, S and the column-max normalized F with its
column scalars mcol), the quadruple the exp-native loss consumes.

  transition logits: logit_k[t, u] = <p_k(enc_t), q_k(dec_u)> + b_k(t)
                                     + b_k(u), normalized over k
  frame likelihood:  log N(y_u; a(enc_t) + b(dec_u), sigma^2 I), as one
                     (B, T, M) x (B, U, M) product plus rank-1 terms
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ssnt_tts_tpu_torch.models import stepmath
from ssnt_tts_tpu_torch.models.encoder import GRUCell
from ssnt_tts_tpu_torch.models.layers import Dense


def _check_domain(lattice_domain: str) -> None:
    if lattice_domain not in ("log", "exp"):
        raise ValueError(f"unknown lattice_domain {lattice_domain!r}")


class MelPrenet(nn.Module):
    def __init__(self, mel_dim: int, dim: int, dtype, *, device=None):
        super().__init__()
        self.fc1 = Dense(mel_dim, dim, dtype, device=device)
        self.fc2 = Dense(dim, dim, dtype, device=device)

    def forward(self, mel):
        return torch.relu(self.fc2(torch.relu(self.fc1(mel))))


class ARDecoderCell(nn.Module):
    """GRU cell over generated mel frames."""

    def __init__(self, mel_dim: int, dim: int, dtype, *, device=None):
        super().__init__()
        self.prenet = MelPrenet(mel_dim, dim, dtype, device=device)
        self.cell = GRUCell(dim, dim, dtype, device=device)

    def forward(self, carry, mel_frame):
        new_carry = self.cell(carry, self.prenet(mel_frame))
        return new_carry, new_carry.float()


class TransitionJoint(nn.Module):
    """Factorized emit/shift logits of rank R, normalized per lattice
    point in float32."""

    def __init__(self, enc_dim: int, dec_dim: int, rank: int, dtype,
                 lattice_dtype=torch.float32, lattice_domain: str = "log",
                 *, device=None):
        super().__init__()
        _check_domain(lattice_domain)
        self.lattice_domain = lattice_domain
        self.rank = rank
        self.dtype = dtype
        self.lattice_dtype = lattice_dtype
        self.enc_proj = Dense(enc_dim, 2 * rank, dtype, device=device)
        self.dec_pre = Dense(dec_dim, rank, dtype, device=device)
        self.dec_proj = Dense(rank, 2 * rank, dtype, device=device)
        self.enc_bias = Dense(enc_dim, 2, torch.float32, device=device)
        self.dec_bias = Dense(dec_dim, 2, torch.float32, device=device)

    def _factors(self, enc, dec):
        p = self.enc_proj(enc)  # (..., 2R)
        q = self.dec_proj(
            torch.tanh(self.dec_pre(dec).float()).to(self.dtype))
        return p, q

    def step(self, enc_t, dec_state):
        """Per-step decode scores: enc_t (..., He) at each beam's source
        position, dec_state (..., H) -> (..., 2) emit/shift log-probs
        (the h input of the v1 beam step)."""
        R = self.rank
        p, q = self._factors(enc_t, dec_state)
        logits = (p.reshape(*p.shape[:-1], 2, R)
                  * q.reshape(*q.shape[:-1], 2, R)).sum(-1).float()
        logits = logits + self.enc_bias(enc_t) + self.dec_bias(dec_state)
        # flax's association (nn.log_softmax), as the fused v1 step has it.
        return stepmath.log_softmax(logits)

    def forward(self, enc, dec):
        """enc (B, T, He) f32, dec (B, U, H) f32 -> (log_emit, log_shift),
        each (U, B, T) contiguous in lattice_dtype; in the exp domain the
        probabilities (E, S) = exp of those, the softmax without its
        final log."""
        R = self.rank
        p, q = self._factors(enc, dec)  # (B, T, 2R), (B, U, 2R)
        B, T, U = p.shape[0], p.shape[1], q.shape[1]
        # Operands in the compute dtype, products accumulated in float32.
        logits = torch.einsum("btkr,bukr->kubt",
                              p.float().reshape(B, T, 2, R),
                              q.float().reshape(B, U, 2, R))
        logits = (logits + self.enc_bias(enc).permute(2, 0, 1)[:, None]
                  + self.dec_bias(dec).permute(2, 1, 0)[..., None])
        le, ls = logits[0], logits[1]
        norm = torch.logaddexp(le, ls)
        if self.lattice_domain == "exp":
            return tuple(torch.exp(x - norm).to(self.lattice_dtype)
                         .contiguous() for x in (le, ls))
        return tuple((x - norm).to(self.lattice_dtype).contiguous()
                     for x in (le, ls))


class FrameJoint(nn.Module):
    """Isotropic-Gaussian frame log-likelihood over the full lattice, and
    the matching decode-time point prediction."""

    def __init__(self, enc_dim: int, dec_dim: int, mel_dim: int, dtype,
                 lattice_dtype=torch.float32, lattice_domain: str = "log",
                 *, device=None):
        super().__init__()
        _check_domain(lattice_domain)
        self.lattice_domain = lattice_domain
        self.lattice_dtype = lattice_dtype
        self.enc_mel = Dense(enc_dim, mel_dim, dtype, device=device)
        self.dec_mel = Dense(dec_dim, mel_dim, dtype, device=device)
        self.log_sigma = nn.Parameter(torch.empty((), device=device))

    def forward(self, enc, dec, mel_target, input_length=None):
        """enc (B, T, He), dec (B, U, H), mel_target (B, U, M) ->
        log p(y_u | t) (U, B, T) contiguous in lattice_dtype.

        In the exp domain: (F, mcol), mcol (U, B) f32 the max over valid
        t < input_length (all t without lengths) of log p, F = exp(log p -
        mcol) (U, B, T) in lattice_dtype and 0 at t >= input_length. A
        padded position's likelihood above every valid one would otherwise
        flush the valid F to 0 and make the example degenerate."""
        M = mel_target.shape[-1]
        a = self.enc_mel(enc).float()  # (B, T, M)
        b = self.dec_mel(dec).float()  # (B, U, M)
        c = mel_target.float() - b
        inv_var = torch.exp(-2.0 * self.log_sigma)
        cross = torch.einsum("btm,bum->ubt", a, c)
        sq_c = (c * c).sum(dim=-1).T  # (U, B)
        sq_a = (a * a).sum(dim=-1)    # (B, T)
        sq_err = sq_c[:, :, None] - 2.0 * cross + sq_a[None, :, :]
        const = -0.5 * M * (math.log(2.0 * math.pi) + 2.0 * self.log_sigma)
        out = -0.5 * inv_var * sq_err + const
        if self.lattice_domain == "exp":
            if input_length is None:
                mcol = out.amax(dim=2)
                F = torch.exp(out - mcol[:, :, None])
            else:
                T = out.shape[2]
                tmask = (torch.arange(T, device=out.device)[None, None, :]
                         < input_length[None, :, None])
                mcol = torch.where(tmask, out, -1e30).amax(dim=2)
                # exp(-inf) = 0 where masked: a padded cell above mcol
                # never overflows, in the values or in their gradient.
                F = torch.exp(torch.where(tmask, out - mcol[:, :, None],
                                          -torch.inf))
            return F.to(self.lattice_dtype).contiguous(), mcol.float()
        return out.to(self.lattice_dtype).contiguous()

    def predict(self, enc_t, dec_state):
        """Decode-time mel frame: (..., He) and (..., H) -> (..., M) f32."""
        return (self.enc_mel(enc_t) + self.dec_mel(dec_state)).float()
