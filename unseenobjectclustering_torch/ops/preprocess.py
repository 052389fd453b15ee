"""RGB-D preprocessing on the device.

Port of ``unseenobjectclustering_tpu/ops/preprocess.py``: depth (m) ->
pinhole backprojection to XYZ, and BGR/255 - pixel_mean
(lib/datasets/tabletop_object.py:57-93,303-306 in the reference).  The work
runs on whatever device the input tensors live on.

Layout: NHWC at the public surface, like the JAX package, so the two are
compared like with like; the network permutes to NCHW inside.

Every division is a true float32 division on every device, so the device
path gives the bits of the host numpy one (``compute_xyz_np`` and
x/255 - mean/255): CUDA would otherwise divide by a Python number as a
product with its float32 reciprocal.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def focal_from_fov(img_width: int, img_height: int, fov_deg: float,
                   near: float) -> float:
    """Focal length of the synthetic TOD frustum camera
    (lib/datasets/tabletop_object.py:71-78; fov is the vertical field of
    view in degrees)."""
    aspect_ratio = img_width / img_height
    e = 1.0 / np.tan(np.radians(fov_deg / 2.0))
    t = near / e
    r = t * aspect_ratio
    alpha = img_width / (2.0 * r)  # pixels per meter
    return float(near * alpha)


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """a / b rounded once, on any device: b as a 0-d tensor on a's device
    (on CUDA a host scalar divisor becomes a product with its reciprocal)."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def compute_xyz_np(depth_m: np.ndarray, fx: float, fy: float, px: float,
                   py: float) -> np.ndarray:
    """Host-side backprojection (tabletop_object.py:57-93), a copy of the
    JAX package's data/datasets.compute_xyz_np; compute_xyz is the device
    path and gives the same bits."""
    h, w = depth_m.shape
    ys, xs = np.indices((h, w), dtype=np.float32)
    z = depth_m.astype(np.float32)
    return np.stack([(xs - px) * z / fx, (ys - py) * z / fy, z], axis=-1)


def compute_xyz(depth_m: torch.Tensor, fx: float, fy: float, px: float,
                py: float) -> torch.Tensor:
    """Backproject a depth map (meters) to an ordered XYZ point cloud.

    x = (u - px) * z / fx ; y = (v - py) * z / fy
    (lib/datasets/tabletop_object.py:87-93).

    Args:
      depth_m: [H, W] depth in meters.
    Returns:
      [H, W, 3] float32 XYZ image on depth_m's device.
    """
    height, width = depth_m.shape[-2:]
    dev = depth_m.device
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :]
    z = depth_m.to(torch.float32)
    x = _div((u - px) * z, fx)
    y = _div((v - py) * z, fy)
    return torch.stack([x, y, z], dim=-1)


def normalize_bgr(image_bgr_u8: torch.Tensor,
                  pixel_means: torch.Tensor | np.ndarray) -> torch.Tensor:
    """BGR uint8 image -> float32 (x/255 - mean/255)
    (lib/datasets/tabletop_object.py:303-305; the checkpoints expect
    OpenCV's BGR order).

    Args:
      image_bgr_u8: [..., H, W, 3] BGR image, uint8 or float in 0..255.
      pixel_means: [3] BGR means in 0..255 (cfg.PIXEL_MEANS).
    Returns:
      [..., H, W, 3] float32 normalized image (NHWC).
    """
    means = torch.as_tensor(pixel_means, dtype=torch.float32,
                            device=image_bgr_u8.device)
    img = _div(image_bgr_u8.to(torch.float32), 255.0)
    return img - _div(means, 255.0)


def preprocess_rgbd(image_bgr_u8: torch.Tensor, depth_m: torch.Tensor,
                    pixel_means: torch.Tensor | np.ndarray, fx: float,
                    fy: float, px: float, py: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalize RGB + backproject depth.

    Returns (image [H,W,3] float32 NHWC, xyz [H,W,3] float32).
    """
    return (normalize_bgr(image_bgr_u8, pixel_means),
            compute_xyz(depth_m, fx, fy, px, py))


def pad_to_multiple(im: np.ndarray, factor: int,
                    value: float = 0.0) -> np.ndarray:
    """Pad bottom/right so H and W are multiples of `factor`
    (lib/utils/blob.py:48-58)."""
    h, w = im.shape[:2]
    ph = int(np.ceil(h / float(factor)) * factor - h)
    pw = int(np.ceil(w / float(factor)) * factor - w)
    if im.ndim == 3:
        return np.pad(im, ((0, ph), (0, pw), (0, 0)), constant_values=value)
    return np.pad(im, ((0, ph), (0, pw)), constant_values=value)


def unpad(im: np.ndarray, orig_hw: tuple[int, int]) -> np.ndarray:
    """Inverse of pad_to_multiple; crops back to the original (H, W)."""
    h, w = orig_hw
    return im[:h, :w] if im.ndim == 2 else im[:h, :w, :]


def camera_params_to_arrays(params: Mapping[str, float]
                            ) -> tuple[float, float, float, float]:
    """Extract (fx, fy, px, py) from a camera_params.json-style dict, falling
    back to the synthetic-frustum model (tabletop_object.py:68-86)."""
    if "fx" in params and "fy" in params:
        fx, fy = float(params["fx"]), float(params["fy"])
    else:
        f = focal_from_fov(int(params["img_width"]), int(params["img_height"]),
                           float(params["fov"]), float(params["near"]))
        fx = fy = f
    if "x_offset" in params and "y_offset" in params:
        px, py = float(params["x_offset"]), float(params["y_offset"])
    else:
        px = params["img_width"] / 2.0
        py = params["img_height"] / 2.0
    return fx, fy, px, py
