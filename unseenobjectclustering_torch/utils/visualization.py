"""Visualization: the result grid that evaluation saves with
cfg.TEST.VISUALIZE.

Port of the grid half of ``unseenobjectclustering_tpu/utils/
visualization.py`` (the reference's lib/fcn/test_common.py:
normalize_descriptor :15-36, the every-3rd-channel feature-to-RGB
reduction :152-158, the image/depth/feature/labels grid :103-216).
matplotlib is imported inside ``segmentation_grid``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from unseenobjectclustering_torch.utils.masks import visualize_segmentation


def normalize_descriptor(res: np.ndarray,
                         stats: Optional[dict] = None) -> np.ndarray:
    """Normalize a descriptor image to [0, 1] per channel
    (test_common.py:15-36)."""
    if stats is None:
        res_min = res.min()
        res_max = res.max()
        return (res - res_min) / max(res_max - res_min, 1e-12)
    normed = np.zeros_like(res)
    for c in range(res.shape[-1]):
        mn, mx = stats["min"][c], stats["max"][c]
        normed[..., c] = np.clip((res[..., c] - mn) / max(mx - mn, 1e-12),
                                 0, 1)
    return normed


def features_to_rgb(features: np.ndarray) -> np.ndarray:
    """[H, W, C] embedding -> [H, W, 3] uint8 by summing every 3rd channel
    (test_common.py:152-158)."""
    h, w, c = features.shape
    rgb = np.zeros((h, w, 3), np.float32)
    for i in range(3):
        rgb[..., i] = features[..., i::3].sum(axis=-1)
    rgb = normalize_descriptor(rgb)
    return (rgb * 255).astype(np.uint8)


def xyz_to_rgb(xyz: np.ndarray) -> np.ndarray:
    """Depth/XYZ image -> displayable uint8 (z-channel colormap)."""
    z = xyz[..., 2] if xyz.ndim == 3 else xyz
    z = normalize_descriptor(z.astype(np.float32))
    return (np.stack([z, z, z], axis=-1) * 255).astype(np.uint8)


def segmentation_grid(image_bgr: np.ndarray, xyz: Optional[np.ndarray],
                      features: Optional[np.ndarray],
                      labels: np.ndarray,
                      labels_refined: Optional[np.ndarray] = None,
                      seed_indices: Optional[np.ndarray] = None):
    """Matplotlib figure of the full pipeline state — image / depth /
    features / initial labels / refined labels (+ seed pixels), mirroring
    _vis_minibatch_segmentation_final (test_common.py:103-216).

    Returns the matplotlib Figure (caller shows or saves it).
    """
    import matplotlib.pyplot as plt

    panels: list[tuple[str, np.ndarray]] = [
        ("image", image_bgr[..., ::-1].astype(np.uint8))]
    if xyz is not None:
        panels.append(("depth (z)", xyz_to_rgb(xyz)))
    if features is not None:
        feat_rgb = features_to_rgb(features)
        if seed_indices is not None:
            h, w = feat_rgb.shape[:2]
            ys, xs = np.unravel_index(np.asarray(seed_indices), (h, w))
            feat_rgb = feat_rgb.copy()
            feat_rgb[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)] = (255,
                                                                      0, 0)
        panels.append(("features", feat_rgb))
    panels.append(("initial labels",
                   visualize_segmentation(
                       image_bgr[..., ::-1].astype(np.uint8), labels)))
    if labels_refined is not None:
        panels.append(("refined labels",
                       visualize_segmentation(
                           image_bgr[..., ::-1].astype(np.uint8),
                           labels_refined)))

    n = len(panels)
    cols = min(n, 3)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 4 * rows),
                             squeeze=False)
    for ax in axes.ravel():
        ax.axis("off")
    for ax, (title, img) in zip(axes.ravel(), panels):
        ax.imshow(img)
        ax.set_title(title)
    fig.tight_layout()
    return fig
