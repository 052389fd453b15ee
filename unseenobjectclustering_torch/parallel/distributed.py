"""Process-group set-up for multi-GPU data parallelism.

Port of ``unseenobjectclustering_tpu/parallel/distributed.py``.  The JAX
package joins hosts with ``jax.distributed.initialize``; here each card is
one process, and the processes form a ``torch.distributed`` process group,
the layout that ``torchrun --nproc_per_node N``, NCCL and DDP assume.

``initialize`` takes the JAX function's arguments and environment variables
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID), and torchrun's
(MASTER_ADDR, WORLD_SIZE, RANK) fill the same fields.  With
nothing configured it does nothing: the run is one process of world size 1.
"""

from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

# how long a rank waits for the others to join the group (and, once it has
# formed, for a collective) before it raises
_TIMEOUT = datetime.timedelta(seconds=600)


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join this process to the process group that the arguments, or else
    the environment, describe.

    coordinator_address is "host:port" (tcp://host:port) or a URL that
    torch.distributed takes as an init_method (tcp://..., file://...).
    Without one, COORDINATOR_ADDRESS, and then torchrun's MASTER_ADDR (the
    group forms through torchrun's store, "env://").  backend defaults to
    "nccl" when a CUDA device is visible and "gloo" otherwise.  A no-op
    when no address and no process count are given, and when the group
    already exists.  Raises when the group cannot be formed within
    _TIMEOUT, or forms with another size than the one asked for: a run
    never goes on alone when more processes were asked for.
    """
    if dist.is_available() and dist.is_initialized():
        return
    address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if address is None and os.environ.get("MASTER_ADDR"):
        address = "env://"
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK")
    if address is None and num_processes is None:
        return  # one process
    if address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs an address, a process count and this "
            f"process's id; got address={address!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r}")
    if not dist.is_available():
        raise RuntimeError("this PyTorch build has no torch.distributed")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=address if "://" in address else
        f"tcp://{address}", world_size=int(num_processes),
        rank=int(process_id), timeout=_TIMEOUT)
    if dist.get_world_size() != int(num_processes):
        raise RuntimeError(f"the process group formed with "
                           f"{dist.get_world_size()} processes, not "
                           f"{num_processes}")


def local_rank() -> int:
    """This process's index among the processes of its host (torchrun's
    LOCAL_RANK; 0 without a launcher): the card it drives."""
    return _env_int("LOCAL_RANK") or 0


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


# the mesh of the data-parallel step running in this context (None: the
# process's batch is the whole batch)
_DATA_PARALLEL: contextvars.ContextVar[Any] = contextvars.ContextVar(
    "data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Any):
    """For the length of the block, the batch is `mesh`'s rank's rows of a
    global batch split over its ranks (a parallel.Mesh; None or a mesh of
    one rank: the batch is the whole batch).  The mesh that the caller
    passes is the one source of the data-parallel rank and world: train-
    mode BatchNorm, the embedding loss and VGG's dropout read it here
    (data_parallel_group, data_parallel_mesh), so code that uses the
    process group with another meaning (the spatial route, whose ranks
    split one frame's columns) never reaches their reductions.  Raises
    when the mesh's rank or world is not the process group's."""
    if mesh is not None and (mesh.rank, mesh.world) != (process_index(),
                                                        process_count()):
        raise ValueError(f"mesh rank {mesh.rank} of {mesh.world} is not "
                         f"the process group's rank {process_index()} of "
                         f"{process_count()}")
    token = _DATA_PARALLEL.set(
        mesh if mesh is not None and mesh.world > 1 else None)
    try:
        yield
    finally:
        _DATA_PARALLEL.reset(token)


def data_parallel_mesh() -> Any:
    """The mesh of the enclosing data_parallel block when it has more than
    one rank, else None."""
    return _DATA_PARALLEL.get()


def data_parallel_group():
    """The default process group inside a data_parallel block whose mesh
    has more than one rank, else None.  Train-mode BatchNorm, the
    embedding loss and VGG's dropout take their batch-wide quantities over
    this group's global batch."""
    return None if _DATA_PARALLEL.get() is None else dist.group.WORLD


def rank_slice(global_batch: int, rank: int, world: int) -> slice:
    """Rank `rank`'s rows of a global batch split over `world` ranks:
    global_batch // world rows from rank * global_batch // world.  The
    batch must divide evenly; an uneven one raises rather than drop rows."""
    if global_batch % world:
        raise ValueError(f"a batch of {global_batch} does not divide "
                         f"over {world} ranks")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a globally indexed batch this process should load
    (per-process data loading for data parallelism)."""
    return rank_slice(global_batch, process_index(), process_count())
