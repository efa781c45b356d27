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

With a model axis of m > 1 ranks the parameters are stored as JAX's
make_sharded_train_step places them (parallel/mesh.param_sharding): a
rank keeps only its block of each split parameter (ParamShard), and the
step gathers the whole weights over the model group in one all_gather
before its forward. The ranks of a model group compute the same rows, so
each already holds the whole gradient: no collective follows the
backward. Adam's mu and nu stay whole, as JAX places opt_state
replicated; the global norm is taken over the whole gradients and each
rank keeps its block of the updated weights. The arithmetic is the
replicated step's, on gathered copies of the same values, so the numbers
are equal bit for bit. gather_params is the collective that gives the
whole state dict (checkpoints, decodes after training); load_params
writes one back into either layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.models.ssnt import SSNTModel, loss_normalizers
from ssnt_tts_tpu_torch.ops import lattice_sharded
from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
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
    # Set when the parameters are stored split over a model axis.
    shard: Optional["ParamShard"] = None


# Elements between the starts of two gathered parameters: 512 bytes of
# float32, the CUDA caching allocator's block alignment, so a gathered
# weight sits as a freshly allocated one does (kernels that pick their
# code by pointer alignment pick the same).
_ALIGN = 128


class ParamShard:
    """This rank's storage of the parameters that mesh.param_sharding
    splits over the model axis of `mesh`.

    Between steps each split parameter of `model` holds only this rank's
    elements, as a 1-D view into one flat buffer (`owned`, in parameter
    order, each parameter's elements in flat order); the others stay
    whole. gather() all_gathers the model group's buffers once and points
    each split parameter at its whole tensor; release() keeps this rank's
    elements of the whole tensors (updated in place by the step) and
    points the parameters at them again. Every rank of the model group
    calls gather() together."""

    def __init__(self, model: SSNTModel, mesh):
        m, i = mesh.shape["model"], mesh.index("model")
        owners = mesh_lib.param_sharding(m, model.config)
        self.group = mesh.groups["model"]
        self.model_size = m
        self.params = [(n, p) for n, p in model.named_parameters()
                       if owners[n] is not None]
        self.shapes = [p.shape for _, p in self.params]
        dev = self.params[0][1].device
        self.bases, base = [], 0
        places = [[] for _ in range(m)]  # rank j's elements in the buffer
        for (n, _), shape in zip(self.params, self.shapes):
            o = torch.from_numpy(owners[n].reshape(-1).astype(np.int64))
            for j in range(m):
                places[j].append(base + (o == j).nonzero()[:, 0])
            self.bases.append(base)
            base += -(-shape.numel() // _ALIGN) * _ALIGN
        self.full_size = base
        self.dst = torch.cat([torch.cat(pl) for pl in places]).to(dev)
        self.src = torch.cat(places[i]).to(dev)
        self.counts = [len(x) for x in places[i]]
        self._full = None
        self.owned = torch.empty(len(self.src), device=dev)
        self.load(dict(self.params))
        self._point_at_owned()

    def _point_at_owned(self) -> None:
        for (_, p), piece in zip(self.params, self.owned.split(self.counts)):
            p.data = piece

    def _whole(self, full: torch.Tensor):
        """(name, whole parameter) views of a gathered buffer."""
        return [(n, full[b:b + shape.numel()].view(shape))
                for (n, _), b, shape in zip(self.params, self.bases,
                                            self.shapes)]

    def _all_gather(self) -> torch.Tensor:
        """The whole split parameters, in one buffer (one all_gather)."""
        rows = torch.empty(self.model_size, len(self.owned),
                           device=self.owned.device)
        dist.all_gather(list(rows.unbind(0)), self.owned, group=self.group)
        full = torch.empty(self.full_size, device=self.owned.device)
        full.index_copy_(0, self.dst, rows.reshape(-1))
        return full

    def gather(self) -> None:
        """Point every split parameter at its whole tensor."""
        self._full = self._all_gather()
        for (_, p), (_, w) in zip(self.params, self._whole(self._full)):
            p.data = w

    def release(self) -> None:
        """Keep this rank's elements of the whole tensors gather() made."""
        self.owned.copy_(self._full[self.src])
        self._full = None
        self._point_at_owned()

    def whole_params(self) -> Dict[str, torch.Tensor]:
        """The whole split parameters by name (one all_gather); the
        model's storage is not touched."""
        return dict(self._whole(self._all_gather()))

    @torch.no_grad()
    def load(self, whole: Dict[str, torch.Tensor]) -> None:
        """Keep this rank's elements of whole split parameters (by name,
        any device)."""
        full = torch.empty(self.full_size, device=self.owned.device)
        for (n, _), b, shape in zip(self.params, self.bases, self.shapes):
            if whole[n].shape != shape:
                raise ValueError(f"{n}: shape {tuple(whole[n].shape)}, "
                                 f"expected {tuple(shape)}")
            full[b:b + shape.numel()] = whole[n].reshape(-1)
        self.owned.copy_(full[self.src])


def gather_params(state: TrainState) -> Dict[str, torch.Tensor]:
    """The model's whole state dict. With split storage (state.shard) it
    is a collective: every rank of the model group calls it (one
    all_gather); the whole tensors are new, the model is not touched."""
    params = state.model.state_dict()
    if state.shard is not None:
        params.update(state.shard.whole_params())
    return params


def load_params(state: TrainState, params: Dict[str, torch.Tensor]) -> None:
    """Loads a whole state dict (gather_params', a checkpoint's) into
    state.model, keeping only this rank's elements of the split
    parameters when state.shard is set."""
    if state.shard is None:
        state.model.load_state_dict(params)
        return
    split = {n for n, _ in state.shard.params}
    names = [n for n, _ in state.model.named_parameters()]
    if set(params) != set(names):
        raise ValueError(f"state dict keys {sorted(params)}, expected "
                         f"{sorted(names)}")
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            if n not in split:
                p.copy_(params[n])
    state.shard.load(params)


def unshard(state: TrainState) -> TrainState:
    """Makes every parameter of state.model whole again (a collective of
    the model group, as gather_params) and drops state.shard: the model
    then serves decodes or single-device training as any other."""
    if state.shard is not None:
        state.shard.gather()
        state.shard = None
    return state


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
    from rank 0 (one broadcast), so every rank starts equal; with a model
    axis of more than one rank each rank then keeps only its elements of
    the parameters mesh.param_sharding splits (state.shard; `state` must
    hold whole parameters).

    step_fn(state, batch) takes this rank's rows of the global batch
    (parallel/mesh.data_sharding; the ranks of one model group take the
    same rows) on its device, and returns (state, metrics) as train_step
    does, the metrics those of the global batch. A step makes two
    all_reduces over the data group: the batch size and valid-token count
    (the loss's normalizers), then the gradients and the metrics as one
    flat buffer; step_fn.all_reduces counts them. With
    ModelConfig.lattice_tshard_min_cells set, the loss runs inside
    tshard_lattice(mesh, "model", min_cells), so lattices that meet it take
    the ring over the model axis. With split storage a step first gathers
    the whole weights over the model group (one all_gather;
    step_fn.all_gathers counts them) and keeps its block of the updated
    ones after."""
    if state.shard is not None:
        raise ValueError("make_sharded_train_step takes a state with whole "
                         "parameters (unshard it first)")
    opt = state.opt_state
    owned = [t.detach() for t in list(state.model.parameters()) + opt.mu
             + opt.nu]
    flat = _flat(owned)
    dist.broadcast(flat, src=0)
    _unflat_into(flat, owned)
    if mesh.shape["model"] > 1:
        state.shard = ParamShard(state.model, mesh)
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
        if state.shard is None:
            return _step(tx, state, batch, counts, reduce, context)
        state.shard.gather()
        step_fn.all_gathers += 1
        state, metrics = _step(tx, state, batch, counts, reduce, context)
        state.shard.release()
        return state, metrics

    step_fn.all_reduces = step_fn.all_gathers = 0
    return step_fn, state
