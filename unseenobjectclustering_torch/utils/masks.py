"""Mask utilities: indexed-PNG IO, color overlays.

Port of ``unseenobjectclustering_tpu/utils/masks.py`` (the reference's
lib/utils/mask.py): imread_indexed/imwrite_indexed (:152-169),
build_matrix_of_indices (:41-46), get_color_mask (:17-39),
visualize_segmentation (:49-147, a cv2 overlay).

numpy only at import: PIL and cv2 are imported inside the functions that
need them, since the GPU machine may have neither.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def imread_indexed(filename: str) -> np.ndarray:
    """Load a palette-indexed segmentation PNG as its raw index array
    (mask.py:152-156)."""
    from PIL import Image

    return np.array(Image.open(filename))


def imwrite_indexed(filename: str, array: np.ndarray,
                    palette: Optional[np.ndarray] = None) -> None:
    """Save a [H, W] label array as an indexed PNG (mask.py:158-169; the
    reference hardcodes a palette file path — here a deterministic palette is
    generated when none is given)."""
    from PIL import Image

    if array.ndim != 2:
        raise ValueError("Saving indexed PNGs requires a 2D array")
    if palette is None:
        palette = default_palette()
    im = Image.fromarray(array.astype(np.uint8))
    im.putpalette(palette.astype(np.uint8).ravel())
    im.save(filename, format="PNG")


def default_palette(n: int = 256) -> np.ndarray:
    """[n, 3] deterministic label palette (label 0 = black)."""
    rng = np.random.RandomState(3)
    pal = rng.randint(0, 256, size=(n, 3)).astype(np.uint8)
    pal[0] = 0
    return pal


def build_matrix_of_indices(height: int, width: int) -> np.ndarray:
    """[H, W, 2] array of (y, x) indices (mask.py:41-46)."""
    return np.indices((height, width), dtype=np.float32).transpose(1, 2, 0)


def get_color_mask(labels: np.ndarray) -> np.ndarray:
    """Map a label image to RGB colors, background black (mask.py:17-39)."""
    pal = default_palette()
    out = pal[labels.astype(np.int64) % 256]
    out[labels == 0] = 0
    return out.astype(np.uint8)


def visualize_segmentation(im: np.ndarray, masks: np.ndarray,
                           alpha: float = 0.6,
                           draw_contours: bool = True) -> np.ndarray:
    """Overlay instance masks on an RGB/BGR uint8 image with per-instance
    colors and optional contours (mask.py:49-147 capability; the contours
    need cv2)."""
    im = im.astype(np.float32)
    color = get_color_mask(masks).astype(np.float32)
    fg = (masks > 0)[..., None].astype(np.float32)
    out = im * (1 - fg * (1 - alpha)) + color * fg * (1 - alpha)
    out = out.astype(np.uint8)
    if draw_contours:
        import cv2

        for lab in np.unique(masks):
            if lab == 0:
                continue
            m = (masks == lab).astype(np.uint8)
            contours, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                           cv2.CHAIN_APPROX_SIMPLE)
            cv2.drawContours(out, contours, -1, (255, 255, 255), 1)
    return out
