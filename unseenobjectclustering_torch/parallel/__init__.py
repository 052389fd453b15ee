"""Multi-GPU data parallelism: one process per card in a torch.distributed
process group.

Port of ``unseenobjectclustering_tpu/parallel/``.  The JAX package shards
the batch over a 1-D device mesh and lets XLA insert the all-reduces; here
``initialize`` forms the process group (or leaves a single process),
``make_mesh`` names this rank's place and card in it, ``shard_batch`` cuts
a global batch to the rank's rows and ``replicate`` copies rank 0's state
to every rank.  The batch-coupled quantities that XLA reduces over the
global batch are reduced over the group explicitly: train-mode BatchNorm
statistics (models.resnet), the embedding loss's batch scalars
(models.losses) and the gradient (engine.train).  Launch one process per
card with ``torchrun --nproc_per_node N``.
"""

from unseenobjectclustering_torch.parallel.distributed import (
    data_parallel_group, initialize, local_batch_slice, local_rank)
from unseenobjectclustering_torch.parallel.mesh import (Mesh, make_mesh,
                                                        replicate,
                                                        shard_batch)

__all__ = ["initialize", "local_batch_slice", "local_rank",
           "data_parallel_group", "Mesh", "make_mesh", "shard_batch",
           "replicate"]
