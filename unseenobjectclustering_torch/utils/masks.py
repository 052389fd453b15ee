"""Mask utilities: indexed-PNG IO, tight boxes, color overlays.

Port of ``unseenobjectclustering_tpu/utils/masks.py`` (the reference's
lib/utils/mask.py): imread_indexed/imwrite_indexed (:152-169),
mask_to_tight_box (:171-195), build_matrix_of_indices (:41-46),
get_color_mask (:17-39), visualize_segmentation (:49-147, a cv2 overlay).

The indexed PNGs go through ``utils/png.py`` (zlib and numpy), whose arrays
are PIL's, and the contours are drawn in numpy (``draw_contours``, the
pixels of cv2's): the GPU machine has neither PIL nor OpenCV.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from scipy import ndimage

from unseenobjectclustering_torch.utils import png

# 4-connected background (the complement of 8-connected objects)
_FOUR = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool)


def imread_indexed(filename: str) -> np.ndarray:
    """Load a palette-indexed segmentation PNG as its raw index array
    (mask.py:152-156): the array PIL's ``np.array(Image.open(...))``
    gives."""
    return png.read_indexed(filename)


def imwrite_indexed(filename: str, array: np.ndarray,
                    palette: Optional[np.ndarray] = None) -> None:
    """Save a [H, W] label array as an indexed PNG (mask.py:158-169; the
    reference hardcodes a palette file path — here a deterministic palette is
    generated when none is given).  PIL reads back the index array and the
    palette that PIL's own writer would store."""
    if array.ndim != 2:
        raise ValueError("Saving indexed PNGs requires a 2D array")
    if palette is None:
        palette = default_palette()
    png.write_png(filename, array.astype(np.uint8),
                  palette=np.asarray(palette).astype(np.uint8).reshape(-1, 3))


def default_palette(n: int = 256) -> np.ndarray:
    """[n, 3] deterministic label palette (label 0 = black)."""
    rng = np.random.RandomState(3)
    pal = rng.randint(0, 256, size=(n, 3)).astype(np.uint8)
    pal[0] = 0
    return pal


def build_matrix_of_indices(height: int, width: int) -> np.ndarray:
    """[H, W, 2] array of (y, x) indices (mask.py:41-46)."""
    return np.indices((height, width), dtype=np.float32).transpose(1, 2, 0)


def mask_to_tight_box(mask: np.ndarray) -> tuple[int, int, int, int]:
    """(x_min, y_min, x_max, y_max) of the nonzero extent (mask.py:171-178)."""
    ys, xs = np.nonzero(mask)
    return int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())


def get_color_mask(labels: np.ndarray) -> np.ndarray:
    """Map a label image to RGB colors, background black (mask.py:17-39)."""
    pal = default_palette()
    out = pal[labels.astype(np.int64) % 256]
    out[labels == 0] = 0
    return out.astype(np.uint8)


def outer_border(mask: np.ndarray) -> np.ndarray:
    """[H, W] bool: the pixels that cv2.findContours(mask, RETR_EXTERNAL,
    CHAIN_APPROX_SIMPLE) followed by cv2.drawContours(..., thickness=1)
    marks.  Those are the border pixels of the outermost 8-connected
    components: the pixels of the mask that are 4-adjacent to the
    background region that reaches the frame (cv2 pads the frame with
    zeros).  A hole's border is not one, and a component inside a hole is
    not outermost; a 1-pixel line is a border on both sides."""
    fg = np.pad(np.asarray(mask) != 0, 1)
    regions, _ = ndimage.label(~fg, structure=_FOUR)
    outside = regions == regions[0, 0]
    touches = np.zeros_like(fg)
    touches[1:-1, 1:-1] = (outside[:-2, 1:-1] | outside[2:, 1:-1]
                           | outside[1:-1, :-2] | outside[1:-1, 2:])
    return (fg & touches)[1:-1, 1:-1]


def visualize_segmentation(im: np.ndarray, masks: np.ndarray,
                           alpha: float = 0.6,
                           draw_contours: bool = True) -> np.ndarray:
    """Overlay instance masks on an RGB/BGR uint8 image with per-instance
    colors and optional white contours (mask.py:49-147 capability; the
    pixels of the JAX package's cv2 overlay)."""
    im = im.astype(np.float32)
    color = get_color_mask(masks).astype(np.float32)
    fg = (masks > 0)[..., None].astype(np.float32)
    out = im * (1 - fg * (1 - alpha)) + color * fg * (1 - alpha)
    out = out.astype(np.uint8)
    if draw_contours:  # label after label, as cv2.drawContours per label
        for lab in np.unique(masks):
            if lab != 0:
                out[outer_border(masks == lab)] = 255
    return out
