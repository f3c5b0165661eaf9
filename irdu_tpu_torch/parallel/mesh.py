"""Process groups, the ("data", "model") mesh and the data-parallel batch
(counterpart: ``irdu_tpu/parallel/mesh.py``).

JAX lays one program over a device mesh and lets the partitioner place the
arrays; the port runs one process a rank (``torchrun``, or spawned ranks in
the tests) and says where each tensor lives. What stands for JAX's names:

  ``jax.sharding.Mesh``         ``Mesh``: this rank's place in a dp × tp grid
                                of ranks (rank = data index · tp + model
                                index, JAX's ``reshape(dp, tp)``) and the two
                                process groups it belongs to;
  ``batch_sharding(mesh)``      ``shard_batch``: this rank's contiguous slice
                                of the global batch, placed on its device;
  ``replicated_sharding(mesh)`` ``broadcast_params``: rank 0's parameters and
                                buffers on every rank.

Backends: NCCL for CUDA ranks, gloo for CPU ranks (the tests), or gloo for
CUDA ranks when asked (several ranks on one card, which NCCL refuses).
Gloo's all-reduce, broadcast and all-gather take CUDA tensors; its
point-to-point ops are used here on host tensors only (``host_staged``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def rank_device(kind: str = "cuda", rank: int | None = None) -> torch.device:
    """This rank's device: ``cuda:{rank % device_count}``, or the CPU when
    asked for. RuntimeError for "cuda" without a card."""
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: ask for the CPU (device='cpu') to run there")
    rank = dist.get_rank() if rank is None and dist.is_initialized() else (rank or 0)
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(device: str = "cuda", *, backend: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     init_method: str | None = None) -> torch.device:
    """Join the default process group and return this rank's device.

    Rank and world size come from the arguments, else from the launcher's
    ``RANK`` and ``WORLD_SIZE`` (``torchrun`` also sets ``MASTER_ADDR`` and
    ``MASTER_PORT``, read by the default ``env://`` rendezvous). The backend
    defaults to NCCL for ``device="cuda"``, gloo for the CPU. Without a
    launcher's environment and without arguments, nothing is joined: the
    run is one process (world size 1, no group)."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None and "WORLD_SIZE" in
                  os.environ else world_size)
    if world_size is None or dist.is_initialized():
        return rank_device(device, dist.get_rank() if dist.is_initialized() else 0)
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return dev


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass(frozen=True, eq=False)
class Mesh:
    """A dp × tp grid of ranks. ``data_group``: the ranks that share this
    rank's model index (the batch is split over them, DDP averages over
    them); ``model_group``: the ranks that share its data index (the
    tensor and expert split). A group is None where the run is one
    process."""

    dp: int
    tp: int
    rank: int
    device: torch.device
    data_group: object = None
    model_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    @property
    def size(self) -> int:
        return self.dp * self.tp


def build_mesh(dp: int, tp: int, device: torch.device | str | None = None) -> Mesh:
    """The dp × tp mesh over every rank of the default group (its world size
    must be dp · tp); every rank calls it, as ``new_group`` asks. ``device``:
    this rank's (default: ``rank_device("cuda")``)."""
    n = world_size()
    if dp * tp != n:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} ranks; the world has {n}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = torch.device(device) if device is not None else rank_device("cuda", rank)
    if not dist.is_initialized():
        return Mesh(dp, tp, 0, device)
    data_group = model_group = None
    for m in range(tp):  # every rank creates every group, in the same order
        g = dist.new_group([d * tp + m for d in range(dp)])
        if rank % tp == m:
            data_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + m for m in range(tp)])
        if rank // tp == d:
            model_group = g
    return Mesh(dp, tp, rank, device, data_group, model_group)


def make_mesh(device: torch.device | str | None = None) -> Mesh:
    """The 1-D "data" mesh over every rank (JAX: ``Mesh(devices, ("data",))``)."""
    return build_mesh(world_size(), 1, device)


def shard_batch(batch, mesh: Mesh):
    """Place a host batch (an array or tensor, or a tuple/list/dict of them,
    leading batch axis) as this rank's contiguous slice on its device (JAX:
    the batch-sharded ``device_put``). The batch must divide by the data
    degree, as JAX's batch sharding requires."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    t = batch if isinstance(batch, torch.Tensor) else torch.from_numpy(np.asarray(batch))
    if t.shape[0] % mesh.dp:
        raise ValueError(f"global batch {t.shape[0]} does not divide by "
                         f"data_parallel={mesh.dp}")
    n = t.shape[0] // mesh.dp
    return t[mesh.data_index * n:(mesh.data_index + 1) * n].contiguous().to(mesh.device)


@torch.no_grad()
def broadcast_params(module: torch.nn.Module, group=None, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank of ``group``
    (JAX: ``replicated_sharding``); nothing without a process group."""
    if not dist.is_initialized():
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)


def host_staged(group=None) -> bool:
    """Whether point-to-point transfers in ``group`` go through host memory:
    under gloo, whose send and receive read and write host buffers."""
    return dist.is_initialized() and dist.get_backend(group) == "gloo"


def all_gather_host(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along dim 0 in rank
    order, as a host tensor; gloo gathers host copies, NCCL gathers on the
    device and copies the result to the host once."""
    n = dist.get_world_size(group) if dist.is_initialized() else 1
    if n == 1:
        return t.cpu()
    src = t.contiguous().cpu() if host_staged(group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).cpu()
