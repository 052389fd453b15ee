"""Dataset evaluation harness — the test_segnet equivalent.

Port of ``unseenobjectclustering_tpu/engine/evaluate.py``: runs samples
through the two-stage Segmentor, computes Overlap / Boundary P/R/F per image
(pre- and post-refinement), saves per-image results, and prints the same
averaged metric table as the reference (lib/fcn/test_dataset.py:271-381).

Depth-filter thresholds follow the reference: 0.5 for OCID, 0.8 for OSD
(test_dataset.py:299-305); anything else keeps the Segmentor's configured
threshold.

evaluate_dataset_sharded is the throughput route: stage 1 only, batches
segmented across the ranks of a parallel.Mesh (Segmentor.segment_sharded).
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np

from unseenobjectclustering_torch.data.loader import DataLoader
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.utils.evaluation import multilabel_metrics


def depth_threshold_for(dataset_name: str) -> Optional[float]:
    """Reference per-dataset depth-validity thresholds
    (test_dataset.py:299-305)."""
    if "ocid" in dataset_name:
        return 0.5
    if "osd" in dataset_name:
        return 0.8
    return None


def average_metrics(metrics_all: list[dict]) -> dict:
    out: dict = {}
    n = max(len(metrics_all), 1)
    for m in metrics_all:
        for k, v in m.items():
            out[k] = out.get(k, 0.0) + v
    return {k: v / n for k, v in out.items()}


def print_metric_table(result: dict, header: str = "") -> None:
    """The reference's averaged table layout (test_dataset.py:347-381)."""
    print("========================================================")
    if header:
        print(header)
    for k in sorted(result.keys()):
        print("%s: %f" % (k, result[k]))
    for k in ("Objects Precision", "Objects Recall", "Objects F-measure",
              "Boundary Precision", "Boundary Recall", "Boundary F-measure",
              "obj_detected_075_percentage"):
        if k in result:
            print("%.6f" % result[k])
    print("========================================================")


def evaluate_dataset_sharded(dataset: Sequence[dict], segmentor: Segmentor,
                             mesh, batch_size: Optional[int] = None,
                             max_images: Optional[int] = None,
                             num_workers: int = 4,
                             verbose: bool = True) -> dict:
    """Stage-1 evaluation with batches segmented across the ranks of a
    parallel.Mesh (no zoom-in refinement: evaluate_dataset runs both
    stages).  batch_size (default: the world size) must be a multiple of
    the world size; the trailing batch is padded with its last frame.
    Every rank reads each batch, segments its frames and receives all the
    labels; the metrics of each frame are multilabel_metrics of its
    segment(refine=False) labels on the same (padded) batch, which may
    differ from those of the frame segmented alone
    (Segmentor.make_sharded_stage1).  Returns the averaged stage-1 metrics
    (on every rank); rank 0 prints."""
    batch_size = batch_size or mesh.world
    if batch_size % mesh.world:
        raise ValueError(f"batch_size {batch_size} is not a multiple of "
                         f"the world size {mesh.world}")
    n = len(dataset) if max_images is None else min(len(dataset), max_images)
    verbose = verbose and mesh.rank == 0

    class _View:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return dataset[i]

    loader = DataLoader(_View(), batch_size=batch_size, shuffle=False,
                        num_workers=num_workers, drop_last=False)
    metrics_all: list[dict] = []
    t0 = time.time()
    done = 0
    for batch in loader:
        img, xyz = batch.get("image_color"), batch.get("depth")
        gt = batch["label"]
        b = gt.shape[0]
        pad = -b % mesh.world
        if pad:  # the trailing batch, padded to a multiple of the world
            img, xyz = (None if a is None
                        else np.concatenate([a] + [a[-1:]] * pad)
                        for a in (img, xyz))
        labels = segmentor.segment_sharded(mesh, img, xyz)
        metrics_all += [multilabel_metrics(labels[i], gt[i])
                        for i in range(b)]
        done += b
        if verbose:
            print(f"[{done}/{n}] {done / (time.time() - t0):.2f} img/s")
    result = average_metrics(metrics_all)
    if verbose:
        print_metric_table(result, f"{n} images (sharded stage-1)")
    return result


def _save_grid(segmentor: Segmentor, sample: dict, prediction: np.ndarray,
               prediction_refined: np.ndarray, path: str) -> None:
    """cfg.TEST.VISUALIZE (test_dataset.py:332-334): save the
    image/depth/labels grid instead of showing a window."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from unseenobjectclustering_torch.utils.visualization import (
        segmentation_grid)

    img_u8 = np.clip((np.asarray(sample["image_color"])
                      + segmentor.cfg.pixel_means / 255.0) * 255, 0,
                     255).astype(np.uint8)
    xyz = sample.get("depth")
    fig = segmentation_grid(img_u8, None if xyz is None else np.asarray(xyz),
                            None, prediction,
                            labels_refined=prediction_refined)
    fig.savefig(path, dpi=90)
    plt.close(fig)


def evaluate_dataset(dataset: Sequence[dict], segmentor: Segmentor,
                     output_dir: Optional[str] = None,
                     refine: bool = True,
                     save_results: bool = True,
                     max_images: Optional[int] = None,
                     verbose: bool = True) -> tuple[dict, dict]:
    """Run the full two-stage evaluation over a sequence of sample dicts
    ({'image_color': [H,W,3] normalized BGR, 'depth': optional [H,W,3] XYZ,
    'label': [H,W] GT ids, optional 'filename'}).

    Returns (averaged stage-1 metrics, averaged refined metrics).
    """
    if output_dir and save_results:
        os.makedirs(output_dir, exist_ok=True)

    metrics_all: list[dict] = []
    metrics_refined: list[dict] = []
    n = len(dataset) if max_images is None else min(len(dataset), max_images)

    for i in range(n):
        t0 = time.time()
        sample = dataset[i]
        image = sample["image_color"][None]
        xyz = sample.get("depth")
        xyz_b = xyz[None] if xyz is not None else None
        gt = np.asarray(sample["label"])

        res = segmentor.segment(image, xyz_b, refine=refine)
        prediction = res.labels[0]
        m = multilabel_metrics(prediction, gt)
        metrics_all.append(m)

        if res.labels_refined is not None:
            prediction_refined = res.labels_refined[0]
            m_ref = multilabel_metrics(prediction_refined, gt)
        else:
            # no refinement ran: identical prediction, reuse the metrics
            # instead of recomputing boundary maps + Hungarian a second time
            prediction_refined = prediction
            m_ref = m
        metrics_refined.append(m_ref)

        if output_dir and save_results:
            import scipy.io

            scipy.io.savemat(
                os.path.join(output_dir, "%06d.mat" % i),
                {"labels": prediction, "labels_refined": prediction_refined,
                 "filename": sample.get("filename", str(i))},
                do_compression=True)
        seg_cfg = getattr(segmentor, "cfg", None)
        if output_dir and seg_cfg is not None and bool(
                seg_cfg.TEST.VISUALIZE):
            _save_grid(segmentor, sample, prediction, prediction_refined,
                       os.path.join(output_dir, "%06d_vis.png" % i))

        if verbose:
            print(f"[{i}/{n}] F={m['Objects F-measure']:.4f} "
                  f"F_ref={m_ref['Objects F-measure']:.4f} "
                  f"time={time.time() - t0:.2f}s")

    result = average_metrics(metrics_all)
    result_refined = average_metrics(metrics_refined)
    if verbose:
        print_metric_table(result, f"{n} images")
        print_metric_table(result_refined, "Refined")
    return result, result_refined
