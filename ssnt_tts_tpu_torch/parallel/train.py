"""Training step on one device, and over a (data, model) mesh (PyTorch).

Mirrors ssnt_tts_tpu/parallel/train.py: TrainState, make_optimizer,
init_train_state, train_step and make_sharded_train_step. The optimizer is
optax's chain written out, with optax's order of operations:

  clip_by_global_norm(c): g_norm = sqrt(sum_i sum(g_i^2)); when
    g_norm >= c every g is scaled by c / g_norm (torch's clip_grad_norm_
    divides by g_norm + 1e-6 instead, and is not used);
  adamw(schedule, b1=0.9, b2=0.999, eps=1e-8, weight_decay):
    mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,  k = count + 1
    u  = (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps) + wd * p
    p  = p - lr(count) * u
  decoupled weight decay on every parameter (optax's adamw has no mask:
  biases, LayerNorm scales and log_sigma decay too);
  lr = warmup_cosine_decay_schedule(0, peak, warmup, max(10 warmup,
    warmup + 1)) with end value 0, read at the update count, so the first
    update has lr 0.

It is written with torch._foreach_* operations (a few multi-tensor
launches per step), not torch.optim.AdamW, whose update rounds in
another order.

The sharded step is the same step with the batch split over the mesh's
data axis: the loss divides by the global batch's normalizers, the data
group sums the gradients (and the metrics) in one all_reduce of one flat
buffer, and every rank clips and updates on the global gradient. JAX gets
there by annotating shardings and letting XLA insert the collectives
(168 all-reduces a step); here they are written out, two a step.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel, loss_normalizers
from ssnt_tts_tpu_torch.ops import lattice_sharded
from ssnt_tts_tpu_torch.utils.config import ModelConfig, TrainConfig

BATCH_KEYS = ("tokens", "mel", "input_length", "output_length",
              "duration_target", "tone_target")


def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int,
                        count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay, 0)."""
    if count < warmup_steps:
        return peak * (count / warmup_steps)
    span = decay_steps - warmup_steps
    c = min(count - warmup_steps, span)
    return peak * 0.5 * (1 + math.cos(math.pi * c / span))


@dataclasses.dataclass
class OptState:
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class ClipAdamW:
    """optax.chain(clip_by_global_norm, adamw) over a list of parameters,
    updated in place (see the module docstring)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: TrainConfig):
        self.peak = cfg.learning_rate
        self.warmup = cfg.warmup_steps
        self.decay_steps = max(10 * cfg.warmup_steps, cfg.warmup_steps + 1)
        self.weight_decay = cfg.weight_decay
        self.max_norm = cfg.grad_clip_norm

    def learning_rate(self, count: int) -> float:
        return warmup_cosine_decay(self.peak, self.warmup, self.decay_steps,
                                   count)

    def init(self, params: List[torch.Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p) for p in params]
        return OptState(count=0, mu=zeros(), nu=zeros())

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: OptState,
               params: List[torch.Tensor]) -> torch.Tensor:
        """Applies one step to `params` and `state` in place; `grads` are
        clipped in place. Returns the global norm before clipping (0-d)."""
        b1, b2 = self.b1, self.b2
        g_norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
        scale = torch.where(g_norm < self.max_norm, 1.0,
                            self.max_norm / g_norm)
        torch._foreach_mul_(grads, scale)
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1 - b2)
        k = state.count + 1
        denom = torch._foreach_div(state.nu, 1 - b2 ** k)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, 1 - b1 ** k)
        torch._foreach_div_(upd, denom)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_add_(params, upd, alpha=-self.learning_rate(
            state.count))
        state.count = k
        return g_norm


def make_optimizer(cfg: TrainConfig) -> ClipAdamW:
    return ClipAdamW(cfg)


@dataclasses.dataclass
class TrainState:
    step: int
    model: SSNTModel  # holds the float32 parameters
    opt_state: OptState


def init_train_state(model_config: ModelConfig, train_config: TrainConfig,
                     *, params: Optional[dict] = None, seed: int = 0,
                     device=None) -> TrainState:
    """A model with converted flax parameters (a flax tree of numpy
    arrays; by default convert.random_flax_tree(model_config, seed)) and a
    fresh optimizer state, on the card unless `device` names another."""
    model = SSNTModel(model_config, device=device)
    tree = params if params is not None else convert.random_flax_tree(
        model_config, seed)
    model.load_state_dict(convert.flax_to_torch(tree, model_config))
    tx = make_optimizer(train_config)
    return TrainState(step=0, model=model,
                      opt_state=tx.init(list(model.parameters())))


def train_step(tx: ClipAdamW, state: TrainState,
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step, in place on state.model and state.opt_state.
    batch: the BATCH_KEYS tensors on the model's device (lengths and
    targets may be absent). Returns (state, metrics): loss,
    nll_per_frame, the auxiliary NLLs present, and grad_norm (before
    clipping), as detached 0-d tensors."""
    return _step(tx, state, batch)


def _step(tx: ClipAdamW, state: TrainState, batch: Dict[str, torch.Tensor],
          normalizers: Optional[torch.Tensor] = None, reduce=None,
          context=contextlib.nullcontext()):
    """train_step; with `normalizers` ([batch size, valid tokens]) the loss
    divides by them, and `reduce(grads, metrics)` sums the gradients in
    place and returns the summed metrics before the update."""
    model = state.model
    model.train()
    params = list(model.parameters())
    for p in params:
        p.grad = None
    kw = {} if normalizers is None else dict(
        batch_size=int(normalizers[0]), token_count=normalizers[1])
    with context:
        loss, metrics = model.loss(*(batch.get(k) for k in BATCH_KEYS), **kw)
        loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    metrics = {k: v.detach() for k, v in metrics.items()}
    if reduce is not None:
        metrics = reduce(grads, metrics)
    g_norm = tx.update(grads, state.opt_state, [p.detach() for p in params])
    for p in params:
        p.grad = None
    metrics["grad_norm"] = g_norm
    state.step += 1
    return state, metrics


def _flat(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: List[torch.Tensor]) -> None:
    """Copy consecutive pieces of flat back into `tensors`, in place."""
    pieces = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_(tensors, [p.view_as(t)
                                   for p, t in zip(pieces, tensors)])


def make_sharded_train_step(tx: ClipAdamW, mesh, state: TrainState):
    """The train step over `mesh` (parallel/mesh.make_mesh). Returns
    (step_fn, state): state's parameters and optimizer state are broadcast
    from rank 0 (one broadcast), so every rank starts equal.

    step_fn(state, batch) takes this rank's rows of the global batch
    (parallel/mesh.data_sharding; the ranks of one model group take the
    same rows) on its device, and returns (state, metrics) as train_step
    does, the metrics those of the global batch. A step makes two
    all_reduces over the data group: the batch size and valid-token count
    (the loss's normalizers), then the gradients and the metrics as one
    flat buffer; step_fn.all_reduces counts them. With
    ModelConfig.lattice_tshard_min_cells set, the loss runs inside
    tshard_lattice(mesh, "model", min_cells), so lattices that meet it take
    the ring over the model axis."""
    opt = state.opt_state
    owned = [t.detach() for t in list(state.model.parameters()) + opt.mu
             + opt.nu]
    flat = _flat(owned)
    dist.broadcast(flat, src=0)
    _unflat_into(flat, owned)
    min_cells = state.model.config.lattice_tshard_min_cells
    group = mesh.groups["data"]

    def reduce(grads, metrics):
        names = sorted(metrics)
        flat = torch.cat([_flat(grads)] + [metrics[k].float().reshape(1)
                                           for k in names])
        dist.all_reduce(flat, group=group)
        step_fn.all_reduces += 1
        _unflat_into(flat[:-len(names)], grads)
        return dict(zip(names, flat[-len(names):].unbind()))

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        counts = loss_normalizers(batch["tokens"], batch.get("input_length"))
        dist.all_reduce(counts, group=group)
        step_fn.all_reduces += 1
        context = (lattice_sharded.tshard_lattice(mesh, "model", min_cells)
                   if min_cells is not None else contextlib.nullcontext())
        return _step(tx, state, batch, counts, reduce, context)

    step_fn.all_reduces = 0
    return step_fn, state
