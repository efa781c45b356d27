"""Multi-process execution over torch.distributed.

Mirrors ssnt_tts_tpu/parallel/multihost.py. Every process runs the same
program with one rank and one device; `initialize` wires the process
group, the global mesh spans every rank, each process loads its own rows
of the global batch (`host_local_batch_to_global`), and the training
step is parallel/train.make_sharded_train_step, whose gradient sum crosses
the process boundary.

A single process without a cluster runs through the same code with no
process group: process_count() == 1, is_primary() is true.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from ssnt_tts_tpu_torch.parallel import mesh as mesh_lib
from ssnt_tts_tpu_torch.utils.config import MeshConfig

# The environment a launcher (torchrun) sets for init_method="env://".
CLUSTER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def default_backend(world_size: int) -> str:
    """NCCL when every rank can have a card of its own, else gloo."""
    if torch.cuda.is_available() and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None, *,
               backend: Optional[str] = None,
               timeout_s: float = 300.0) -> None:
    """Wire up the process group.

    With explicit arguments (init_method "tcp://host:port" or
    "file://path", world_size, rank), or with a launcher's environment
    (CLUSTER_ENV, any of it) present, a failure RAISES: a misconfigured
    cluster must not silently train on one of its processes. Only with
    neither does it warn and run single-process, as JAX's does. Every
    collective of the group times out after timeout_s seconds."""
    explicit = any(a is not None for a in (init_method, world_size, rank))
    cluster_env = any(k in os.environ for k in CLUSTER_ENV)
    if not explicit and not cluster_env:
        logging.getLogger(__name__).warning(
            "no process group arguments and no cluster environment (%s); "
            "running single-process.", ", ".join(CLUSTER_ENV))
        return
    if explicit:
        kwargs = dict(init_method=init_method, world_size=world_size,
                      rank=rank)
        world = world_size
    else:
        kwargs = dict(init_method="env://")
        world = int(os.environ.get("WORLD_SIZE", "1"))
    try:
        dist.init_process_group(
            backend or default_backend(world),
            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    except Exception as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed although "
            f"{'arguments' if explicit else 'cluster environment'} were "
            f"given: refusing to fall back to single-process: {e!r}") from e


def global_data_mesh(model_axis: int = 1, *, device=None) -> mesh_lib.Mesh:
    """Mesh over every rank of the cluster, (world // model_axis,
    model_axis). Every process calls it with the same arguments."""
    n = process_count()
    if n % model_axis:
        raise ValueError(f"{n} ranks not divisible by model={model_axis}")
    return mesh_lib.make_mesh(MeshConfig(data=n // model_axis,
                                         model=model_axis), device=device)


def host_local_batch_to_global(batch: Dict[str, object], mesh: mesh_lib.Mesh
                               ) -> Dict[str, torch.Tensor]:
    """This process's rows of the global batch, on its device.

    Each process passes its own rows (the ranks of one model group pass the
    same rows); the global batch is the per-process size times
    mesh.shape["data"]. Raises unless every array has the same dim 0 and
    every process passes the same per-process size (one all_gather)."""
    sizes = {int(torch.as_tensor(v).shape[0]) for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch arrays disagree on dim 0: {sorted(sizes)}")
    local = torch.tensor([sizes.pop()], dtype=torch.int64,
                         device=mesh.device)
    every = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(every, local)
    every = [int(x) for x in every]
    if len(set(every)) != 1:
        raise ValueError(f"processes pass different per-host batch sizes: "
                         f"{every}")
    return {k: mesh_lib.replicated(mesh, v) for k, v in batch.items()}


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
