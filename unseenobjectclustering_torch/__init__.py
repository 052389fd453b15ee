"""unseenobjectclustering_torch — the PyTorch/CUDA port of
unseenobjectclustering_tpu for NVIDIA Hopper (H100), held against the JAX
package on the same inputs.

Subpackages:
  config    — frozen config objects, YAML-compatible with the reference cfgs
  models    — SEGNET embedding networks (dilated-ResNet FCN, the U-Net and
              VGG alternates) and the embedding loss
  ops       — preprocessing, resizes, mean-shift clustering, the
              hand-written CUDA kernels' wrappers (csrc/ holds the sources)
              and the training augmentation on the device
  data      — the TableTop/OCID/OSD readers, PCD IO and the native IO
              library, the host augmentation, the procedural synthetic
              renderer, the dataset registry, the threaded loader and the
              device-resident scene cache
  engine    — the two-stage inference pipeline (Segmentor: stage 1 and
              zoom-in refinement, stage 1 sharded across processes), the
              builder, dataset evaluation, the stream server
              (StreamSegmentor) and the trainer
  parallel  — multi-GPU data parallelism: the process group (one process
              per card, torchrun), the mesh, batch sharding and
              replication
  utils     — the metrics (Overlap/Boundary P/R/F), masks, the PNG codec
              and result grids, the .pth and ImageNet checkpoint loaders,
              training snapshots, the weight carry from flax variables,
              SE(3) helpers and timers
  tools     — the entry points: the dataset evaluation, .npy and image
              CLIs, the demo evaluation and overlay artifact, the ROS
              adapter, the trainer, the scene renderer and the OCID/OSD
              fixture writer
              (python -m unseenobjectclustering_torch.tools.<name>)

Entry points run on the CUDA device unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from unseenobjectclustering_torch.config import Config

_PARALLEL = ("initialize", "local_batch_slice", "make_mesh", "replicate",
             "shard_batch")
__all__ = ["Config", "__version__", *_PARALLEL]


def __getattr__(name: str):
    # the parallel names import torch on first use only: the renderer's
    # worker processes import this package and stay numpy-only
    if name in _PARALLEL:
        from unseenobjectclustering_torch import parallel
        return getattr(parallel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
