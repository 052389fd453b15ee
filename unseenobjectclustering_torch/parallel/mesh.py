"""The data-parallel "mesh": a process group with one card per process.

Port of ``unseenobjectclustering_tpu/parallel/mesh.py``.  The JAX package
puts a 1-D device mesh over every chip, shards the batch axis over it and
lets XLA compile the reductions.  Here the mesh is the torch.distributed
process group that ``parallel.initialize`` formed (or a single process of
world size 1 without one): each rank holds a replica of the parameters on
its own card and one slice of each global batch, and the code that needs
the global batch (train-mode BatchNorm, the embedding loss, the gradient
sum, the sharded stage 1) reduces across the group itself.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from unseenobjectclustering_torch.parallel.distributed import (local_rank,
                                                               process_count,
                                                               process_index,
                                                               rank_slice)


class Mesh(NamedTuple):
    """This process's place in the data-parallel group: its rank, the
    world size and the device it computes on."""
    rank: int
    world: int
    device: torch.device

    def batch_slice(self, global_batch: int) -> slice:
        """This rank's rows of a global batch; the batch must divide
        evenly over the ranks."""
        return rank_slice(global_batch, self.rank, self.world)


def make_mesh(device: Any = None) -> Mesh:
    """The mesh of the current process group (world size 1 without one).
    The device is `device` ("cuda" names the current card), else
    cuda:<LOCAL_RANK> (raises without a card); a card becomes the
    process's current one."""
    # imported here: engine.pipeline imports the models, whose BatchNorm
    # imports parallel.distributed
    from unseenobjectclustering_torch.engine.pipeline import resolve_device

    dev = resolve_device(device if device is not None
                         else f"cuda:{local_rank()}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)  # NCCL's collectives use this card
    return Mesh(process_index(), process_count(), dev)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's slice of each [B, ...] array or tensor of a nested
    tuple/list/dict (None stays None), on the mesh's device.  B must be
    divisible by the world size: training rounds its batch up to a
    multiple, the sharded evaluation pads its trailing batch."""
    def one(x):
        x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return x[mesh.batch_slice(int(x.shape[0]))].to(mesh.device)
    return _map(one, batch)


def _broadcast_(tensors: list[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values into `tensors` in place, on every rank (a tensor off
    the mesh's device, such as Adam's step count, goes through a copy on
    it: NCCL moves device memory only)."""
    if mesh.world == 1:
        return
    with torch.no_grad():
        for t in tensors:
            buf = t.to(mesh.device)
            dist.broadcast(buf, src=0)
            if buf is not t:
                t.copy_(buf)


def replicate(obj: Any, mesh: Mesh) -> Any:
    """Rank 0's state on every rank, on the mesh's device.

    A torch.nn.Module: its parameters and buffers, in place.  An object
    with `model` and `optimizer` (engine.train.TrainState): the model, the
    optimizer's state tensors and the step, in place.  A tensor or a
    nested tuple/list/dict of tensors or arrays: moved to the device and
    broadcast.  The ranks must hold the same structure (the same network
    and optimizer), as processes that built it with the same code do."""
    if isinstance(obj, torch.nn.Module):
        obj.to(mesh.device)
        _broadcast_(list(obj.parameters()) + list(obj.buffers()), mesh)
        return obj
    if hasattr(obj, "model") and hasattr(obj, "optimizer"):
        replicate(obj.model, mesh)
        state = obj.optimizer.state
        per_param = [state[p] for group in obj.optimizer.param_groups
                     for p in group["params"] if p in state]
        _broadcast_([v for s in per_param for _, v in sorted(s.items())
                     if torch.is_tensor(v)], mesh)
        step = torch.tensor([obj.step], dtype=torch.int64)
        _broadcast_([step], mesh)
        obj.step = int(step)
        return obj

    def one(x):
        x = (x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
             ).to(mesh.device)
        _broadcast_([x], mesh)
        return x
    return _map(one, obj)
