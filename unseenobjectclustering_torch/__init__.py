"""unseenobjectclustering_torch — the PyTorch/CUDA port of
unseenobjectclustering_tpu for NVIDIA Hopper (H100), held against the JAX
package on the same inputs.

Subpackages:
  config    — frozen config objects, YAML-compatible with the reference cfgs
  models    — SEGNET embedding networks (dilated-ResNet FCN)
  ops       — preprocessing, resizes, mean-shift clustering and the
              hand-written CUDA kernels' wrappers (csrc/ holds the sources)
  engine    — the two-stage inference pipeline (Segmentor: stage 1 and
              zoom-in refinement), the builder, dataset evaluation and the
              stream server (StreamSegmentor)
  utils     — the metrics (Overlap/Boundary P/R/F), masks and result
              grids, the reference .pth checkpoint loader and the weight
              carry from flax variables
  tools     — the entry points: .npy and image CLIs, the demo evaluation
              and overlay artifact, the ROS adapter
              (python -m unseenobjectclustering_torch.tools.<name>)

Entry points run on the CUDA device unless the caller passes device="cpu".
"""

__version__ = "0.1.0"

from unseenobjectclustering_torch.config import Config

__all__ = ["Config", "__version__"]
