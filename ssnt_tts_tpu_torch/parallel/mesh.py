"""Device mesh over the ranks of a torch.distributed process group.

Mirrors ssnt_tts_tpu/parallel/mesh.py: a 2-D ("data", "model") layout with
one rank per device slot. Rank r sits at (r // model, r % model), where
JAX's `reshape(data, model)` places device r.

  - batch-major arrays shard dim 0 over "data" (`data_sharding`: this
    rank's rows); gradients are summed over the data group
    (parallel/train.make_sharded_train_step);
  - parameter storage splits over "model" by JAX's rule
    (`param_sharding`): every parameter whose flax leaf has ndim >= 2 and
    a last dim that the model-axis size m divides (and >= m) splits that
    dim into m contiguous blocks, block i on the rank at model index i;
    every other parameter is whole on every rank. The train step gathers
    the whole weights before its forward (parallel/train.ParamShard).
    Adam's mu and nu stay whole, as JAX places opt_state `replicated`;
  - the "model" axis also carries the T-shard of the lattice
    (ops/lattice_sharded);
  - beams stay rank-local: decodes run on the data rank's rows and need
    no collective.

Each rank names its device explicitly. The groups are built with
`dist.new_group` in every layout: `init_device_mesh` would give the same
groups, but picks a device per rank by itself, which fails when several
ranks share one card (gloo, every rank on cuda:0).

Transport: NCCL takes CUDA tensors for every operation. gloo takes them
for all_reduce, all_gather and broadcast (it copies through host memory
itself), but its send of a CUDA tensor aborts the process, so the ring's
send / recv go through host memory explicitly (`Mesh.stage_p2p`);
dryrun's "probe" task checks both on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ssnt_tts_tpu_torch import convert
from ssnt_tts_tpu_torch.utils.config import MeshConfig, ModelConfig

AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a (data, model) mesh."""

    shape: Dict[str, int]               # {"data": d, "model": m}
    rank: int                           # global rank
    device: torch.device
    backend: str                        # "gloo" or "nccl"
    groups: Dict[str, object]           # axis -> ProcessGroup of this rank
    ranks: Dict[str, Tuple[int, ...]]   # axis -> its global ranks, in order

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        m = self.shape["model"]
        return self.rank // m if axis == "data" else self.rank % m

    @property
    def stage_p2p(self) -> bool:
        """Whether send / recv go through host memory (gloo, CUDA)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def rows(self, n: int) -> slice:
        """This rank's rows of a dim-0 extent n (n divisible by data)."""
        d = self.shape["data"]
        if n % d:
            raise ValueError(f"batch {n} not divisible by data={d}")
        i = self.index("data")
        return slice(i * n // d, (i + 1) * n // d)


def default_device() -> torch.device:
    """The card of this rank: cuda:(LOCAL_RANK, else the global rank,
    modulo the card count). No card raises (utils/device.py)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _layout(d: int, m: int) -> Dict[str, list]:
    """Every group of each axis, as lists of global ranks."""
    return {"data": [[i * m + j for i in range(d)] for j in range(m)],
            "model": [[i * m + j for j in range(m)] for i in range(d)]}


def make_mesh(config: Optional[MeshConfig] = None, *,
              device=None) -> Mesh:
    """The (data, model) mesh over every rank of the initialized process
    group (parallel/multihost.initialize); data * model must equal the
    world size. Every rank calls it with the same config. `device`: this
    rank's device (default_device() when None)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(ssnt_tts_tpu_torch.parallel.multihost."
                           "initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    config = config or MeshConfig(data=world, model=1)
    d, m = config.data, config.model
    if d * m != world:
        raise ValueError(f"mesh {d}x{m} needs {d * m} ranks, the process "
                         f"group has {world}")
    dev = torch.device(device) if device is not None else default_device()
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = dist.get_backend()
    layout = _layout(d, m)
    mine = {ax: next(g for g in layout[ax] if rank in g) for ax in AXES}
    groups = {}
    for ax in AXES:
        for g in layout[ax]:  # every rank creates every group, in order
            pg = dist.new_group(g)
            if rank in g:
                groups[ax] = pg
    return Mesh(shape={"data": d, "model": m}, rank=rank, device=dev,
                backend=backend, groups=groups,
                ranks={ax: tuple(mine[ax]) for ax in AXES})


def data_sharding(mesh: Mesh, x) -> torch.Tensor:
    """This rank's slice of dim 0 of a global batch-major array, on its
    device."""
    x = torch.as_tensor(x)
    return x[mesh.rows(x.shape[0])].to(mesh.device)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """The whole array, on this rank's device."""
    return torch.as_tensor(x).to(mesh.device)


def _leaf_owners(shape: tuple, m: int) -> np.ndarray:
    """JAX's param_sharding rule on one flax leaf: the model index that
    stores each element, -1 where every rank stores it (every element
    when m is 1)."""
    if (m > 1 and len(shape) >= 2 and shape[-1] % m == 0
            and shape[-1] >= m):
        block = np.arange(shape[-1]) // (shape[-1] // m)
        return np.broadcast_to(block, shape).astype(np.int16)
    return np.full(shape, -1, np.int16)


def param_sharding(model_size: int, cfg: ModelConfig
                   ) -> Dict[str, Optional[np.ndarray]]:
    """The storage layout over a model axis of `model_size` ranks, by
    SSNTModel parameter name: an int16 array of the parameter's shape
    giving the model index that stores each element, or None for a
    parameter that every rank stores whole (all of them when model_size
    is 1).

    JAX's rule (ssnt_tts_tpu/parallel/mesh.py param_sharding) is stated on
    flax leaves; each leaf's owner ids go through the leaf's own transform
    into the torch layout (convert._mapping), so a transposed Dense or
    Conv kernel splits on torch dim 0, an attention q/k/v kernel on hd/m
    rows of every head, a GRU's wi / wh on one column block per gate, an
    embedding on dim 1. A parameter built from leaves of which some split
    and some do not raises ValueError."""
    out: Dict[str, Optional[np.ndarray]] = {}
    shapes = convert.flax_leaf_shapes(cfg)
    for key, paths, fn in convert._mapping(cfg):
        owners = np.asarray(fn(*(_leaf_owners(shapes[p], model_size)
                                 for p in paths)))
        if (owners < 0).all():
            out[key] = None
        elif (owners < 0).any():
            raise ValueError(f"{key}: its flax leaves {paths} split "
                             f"unevenly over {model_size} ranks")
        else:
            out[key] = np.ascontiguousarray(owners)
    return out
