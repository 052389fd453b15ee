"""cv2.resize of a uint8 image by one scale factor, in numpy, with cv2's
bits (the GPU machine has no OpenCV).

``resize_u8(img, s)`` is ``cv2.resize(img, None, fx=s, fy=s)`` (default
INTER_LINEAR) as OpenCV 5.0 computes it for uint8:

  * dsize is (round(w * s), round(h * s)), rounded half to even, while the
    source coordinates step by 1 / s; a dsize equal to the source's copies
    the image.
  * At s = 0.5, OpenCV switches INTER_LINEAR to its fast INTER_AREA: the
    mean of each 2x2 block, (sum + 2) >> 2; an output cell that runs past
    an odd source edge averages the pixels it holds, rounded half to even.
  * Otherwise fixed-point linear interpolation with 11-bit weights:
    x = (d + 0.5) / s - 0.5 in float32, weights round((1 - f) * 2048) and
    round(f * 2048); columns past a border are clamped to it with weight
    (2048, 0), rows are clipped by index only (their weights stay
    fractional).  A row is the int32 sum of its two taps; the vertical pass
    is the SIMD one, (((r0 >> 4) * b0 >> 16) + ((r1 >> 4) * b1 >> 16) + 2)
    >> 2, saturated to uint8.
"""

from __future__ import annotations

import numpy as np

_ONE = 2048  # INTER_RESIZE_COEF_SCALE (11 bits)


def _taps(n_in: int, n_out: int, inv: float, clamp: bool):
    f = ((np.arange(n_out) + 0.5) * inv - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:  # the horizontal taps move to the border pixel
        out = (s < 0) | (s >= n_in - 1)
        f[out] = 0.0
        s = np.clip(s, 0, n_in - 1)
    w1 = np.rint(f * np.float32(_ONE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_ONE)).astype(np.int64)
    return np.clip(s, 0, n_in - 1), np.clip(s + 1, 0, n_in - 1), w0, w1


def _area_half(src: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    s = src.astype(np.int64)[:2 * out_h, :2 * out_w]
    pad = ((0, 2 * out_h - s.shape[0]), (0, 2 * out_w - s.shape[1]))
    cells = np.pad(s, pad + ((0, 0),) * (s.ndim - 2))
    held = np.pad(np.ones(s.shape[:2], np.int64), pad)

    def block_sum(a):
        return a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2]

    total, n = block_sum(cells), block_sum(held)
    n = n.reshape(n.shape + (1,) * (s.ndim - 2))
    partial = np.rint(total.astype(np.float32) / n.astype(np.float32))
    return np.where(n == 4, (total + 2) >> 2, partial).astype(np.uint8)


def resize_u8(img: np.ndarray, scale: float) -> np.ndarray:
    """cv2.resize(img, None, fx=scale, fy=scale) of a uint8 [H, W] or
    [H, W, C] image, bit for bit (see the module docstring)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize_u8 takes a uint8 [H, W(, C)] image, not "
                         f"{img.dtype} {img.shape}")
    if not scale > 0:
        raise ValueError(f"scale must be positive, got {scale}")
    h, w = img.shape[:2]
    out_h, out_w = int(np.rint(h * scale)), int(np.rint(w * scale))
    if out_h < 1 or out_w < 1:
        raise ValueError(f"a {h}x{w} image at scale {scale} is empty")
    if (out_h, out_w) == (h, w):
        return img.copy()
    if scale == 0.5:
        return _area_half(img, out_h, out_w)
    inv = 1.0 / scale
    x0, x1, a0, a1 = _taps(w, out_w, inv, clamp=True)
    y0, y1, b0, b1 = _taps(h, out_h, inv, clamp=False)
    s = img.astype(np.int64).reshape(h, w, -1)
    rows = s[:, x0] * a0[:, None] + s[:, x1] * a1[:, None]
    r0, r1 = rows[y0] >> 4, rows[y1] >> 4
    v = (((r0 * b0[:, None, None]) >> 16) + ((r1 * b1[:, None, None]) >> 16)
         + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8).reshape(
        (out_h, out_w) + img.shape[2:])
