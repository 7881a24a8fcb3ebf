"""The data-parallel mesh over the process group, and the data-parallel
train step.

The JAX package's strategies run over a 1-D ``jax.sharding.Mesh``: the
batch (or a chunk's temporal windows) is sharded over its ``data`` axis
and XLA's SPMD partitioner inserts the collectives.  The port runs one
process per GPU (``parallel.multihost``), and a ``Mesh`` here is the
first ``size`` ranks of the process group; the collectives are explicit:

- **training**: every rank holds the whole state (``replicate_tree``
  broadcasts it from rank 0) and its own rows of the global batch
  (``shard_batch``); ``data_parallel_step`` runs the train step with a
  ``GradSync``, which averages G's and D's gradients over the mesh with
  one all-reduce per optimizer step, and the logged metrics with one
  more.  Batch norm takes its statistics over the global batch
  (``sync_batch_norm``).
- **inference**: ``pipeline.Stabilizer(mesh=...)`` splits each chunk's
  temporal windows over the mesh and all-gathers the results
  (``all_gather_rows``), so every rank returns the whole chunk.

A mesh over a process group runs its collectives even at size 1; with no
process group a mesh has size 1, no group and no collectives.

The reference's ``batch_sharding`` and ``replicated`` describe where XLA
places an array; eager PyTorch has no such placement object, so the port
has neither: ``shard_batch`` and ``replicate_tree`` do the placing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from pwstablenet_tpu_torch.config import MeshConfig
from pwstablenet_tpu_torch.models.blocks import BatchNorm


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The first ``size`` ranks of the process group, along ``data_axis``.

    ``rank`` is this process's index in the mesh, -1 outside it (a rank
    the mesh leaves out); ``group`` is the process group of the mesh's
    ranks, None without a process group."""

    size: int = 1
    rank: int = 0
    group: Any = None
    data_axis: str = "data"

    @property
    def member(self) -> bool:
        return self.rank >= 0


def _mesh(n: int, cfg: MeshConfig) -> Mesh:
    if not dist.is_initialized():
        return Mesh(data_axis=cfg.data_axis)
    world, rank = dist.get_world_size(), dist.get_rank()
    # every rank must take part in making a subgroup, members or not
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return Mesh(n, rank if rank < n else -1, group, cfg.data_axis)


def _limit(cfg: MeshConfig) -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return world if cfg.num_devices in (-1, 0) else min(cfg.num_devices, world)


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """All ranks, or the first ``cfg.num_devices``."""
    cfg = cfg or MeshConfig()
    return _mesh(_limit(cfg), cfg)


def make_mesh_for_batch(batch_size: int, cfg: Optional[MeshConfig] = None) -> Mesh:
    """Largest usable mesh whose size divides the global batch."""
    cfg = cfg or MeshConfig()
    n = max(d for d in range(1, _limit(cfg) + 1) if batch_size % d == 0)
    return _mesh(n, cfg)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's rows of a global host batch (an array, or a dict of
    them): rows ``[r*B/n, (r+1)*B/n)`` of the leading axis, as
    ``PartitionSpec("data")`` places them.  Every rank makes the same
    global batch; the rows stay where the batch is (the training loop's
    ``batch_to_device`` copies them to the card)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    b = batch.shape[0]
    if b % mesh.size:
        raise ValueError(f"batch of {b} must divide over {mesh.size} mesh ranks")
    k = b // mesh.size
    return batch[mesh.rank * k : (mesh.rank + 1) * k]


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    if isinstance(tree, torch.optim.Optimizer):
        return [v for s in tree.state.values() for v in s.values()
                if isinstance(v, torch.Tensor)]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _wire_device(mesh: Mesh, device: torch.device) -> torch.device:
    """NCCL moves CUDA tensors only; gloo takes CPU and CUDA tensors."""
    if dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return device


@torch.no_grad()
def replicate_tree(tree: Any, mesh: Mesh) -> Any:
    """Broadcast every tensor of ``tree`` from the mesh's rank 0, in
    place, and return ``tree``: a module's parameters and buffers, an
    optimizer's state, and the tensors of a ``TrainState`` (its modules
    and both optimizers) or of a list or dict of these.  One broadcast
    per (device, dtype).  Plain numbers (the step count, the schedules)
    and the dropout generator are left alone: every rank makes them from
    the same seed or restores them from the same checkpoint."""
    if mesh.group is None:
        return tree
    buckets = {}
    for t in {id(t): t for t in _tensors(tree)}.values():
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for (device, _), ts in buckets.items():
        flat = torch.cat([t.detach().reshape(-1) for t in ts]).to(_wire_device(mesh, device))
        dist.broadcast(flat, src=0, group=mesh.group)
        for t, chunk in zip(ts, flat.to(device).split([t.numel() for t in ts])):
            t.copy_(chunk.view_as(t))
    return tree


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every mesh rank's ``t`` concatenated along the leading axis, in
    rank order, on every rank.  The tensors cross as bytes, so any dtype
    travels (gloo reduces only some)."""
    if mesh.group is None:
        return t
    wire = t.contiguous().view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire, group=mesh.group)
    return torch.cat(parts).view(t.dtype)


class GradSync:
    """The gradient sync of a data-parallel train step over ``mesh``.

    Called with a module after its ``backward()``: flattens the module's
    gradients into one buffer, all-reduces it (sum), divides by the mesh
    size and writes the mean back: one collective per optimizer step.
    ``mean`` does the same for the step's metrics, so the logged values
    are the global batch's.  ``rank`` is this process's mesh index (the
    step folds it into its dropout seed)."""

    def __init__(self, mesh: Mesh):
        if not mesh.member:
            raise ValueError("this process is outside the mesh")
        self.mesh = mesh
        self.rank = mesh.rank

    def _mean_(self, flat: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(flat, group=self.mesh.group)
        return flat.div_(self.mesh.size)

    @torch.no_grad()
    def __call__(self, module: torch.nn.Module) -> None:
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        if not grads:
            return
        flat = self._mean_(torch.cat([g.reshape(-1) for g in grads]))
        chunks = flat.split([g.numel() for g in grads])
        torch._foreach_copy_(grads, [c.view_as(g) for g, c in zip(grads, chunks)])

    @torch.no_grad()
    def mean(self, metrics: dict) -> dict:
        keys = list(metrics)
        flat = self._mean_(torch.stack([metrics[k].to(torch.float32) for k in keys]))
        return dict(zip(keys, flat.unbind()))


def data_parallel_step(train_step: Callable, mesh: Mesh) -> Callable:
    """``train_step`` (a step of ``train.step.make_train_step``) run with
    the mesh's ``GradSync``.  The state must be replicated
    (``replicate_tree``) and each batch this rank's shard
    (``shard_batch``).

    The port's step is an eager closure: the all-reduce cannot be
    inserted into it afterwards, as XLA's partitioner inserts it into a
    jitted step, so the step is built again from its configurations with
    the sync.  Without a process group the step is returned as it is."""
    if mesh.group is None:
        return train_step
    from pwstablenet_tpu_torch.train.step import make_train_step

    return make_train_step(train_step.model_cfg, train_step.train_cfg,
                           grad_sync=GradSync(mesh))


def sync_batch_norm(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Give every ``models.blocks.BatchNorm`` of ``module`` the mesh's
    group, so that its statistics are those of the global batch (as
    torch's ``convert_sync_batchnorm`` does for its own class); returns
    ``module``.  Instance and group norm are per sample and need no
    sync."""
    if mesh.group is not None:
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.group = mesh.group
    return module
