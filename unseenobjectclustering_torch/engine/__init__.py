"""Engine: the two-stage inference pipeline (stage 1 and zoom-in
refinement), the builder that loads checkpoints into it, dataset
evaluation (one frame at a time, or stage 1 sharded across the ranks of
a parallel.Mesh), the latest-frame stream server and the trainer
(engine.train)."""

from unseenobjectclustering_torch.engine.builder import (build_segmentor,
                                                         init_state_dict,
                                                         load_network_state)
from unseenobjectclustering_torch.engine.evaluate import (
    evaluate_dataset, evaluate_dataset_sharded)
from unseenobjectclustering_torch.engine.pipeline import (SegmentationResult,
                                                          Segmentor)
from unseenobjectclustering_torch.engine.stream import StreamSegmentor

__all__ = ["Segmentor", "SegmentationResult", "build_segmentor",
           "init_state_dict", "load_network_state", "evaluate_dataset",
           "evaluate_dataset_sharded", "StreamSegmentor"]
