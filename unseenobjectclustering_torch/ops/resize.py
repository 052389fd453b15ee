"""Bilinear align_corners=True upsampling and the legacy nearest resize.

Port of ``unseenobjectclustering_tpu/ops/resize.upsample_bilinear``,
``resize_nearest_legacy`` and ``_nearest_index_legacy`` (which stage 2's
paste-back uses).  The
reference upsamples logits with ``nn.functional.upsample_bilinear``
(bilinear, align_corners=True; lib/networks/resnet_dilated.py:325).  The
interpolation is two dense matmuls (out = W_h @ x @ W_w^T) with the same
float64-built weight matrices as the JAX package, so both agree to rounding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _bilinear_matrix_align_corners(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] interpolation matrix, align_corners=True.

    Output coordinate i samples input position i*(in-1)/(out-1).
    """
    w = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        w[:, 0] = 1.0
        return w
    if out_size == 1:
        # align_corners=True with a single output samples position 0
        w[0, 0] = 1.0
        return w
    pos = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.floor(pos).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 2)
    frac = pos - lo
    w[np.arange(out_size), lo] = (1.0 - frac).astype(np.float32)
    w[np.arange(out_size), lo + 1] = frac.astype(np.float32)
    return w


@functools.lru_cache(maxsize=64)
def _nearest_index_legacy(in_size: int, out_size: int) -> np.ndarray:
    """[out_size] source indices with legacy torch nearest semantics:
    src = floor(dst * in/out)."""
    idx = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


def upsample_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear align_corners=True upsample via two matmuls in float32 (in
    float64 for float64 input).

    Args:
      x: [..., H, W, C] (NHWC; leading batch dims allowed).
      out_hw: target (H_out, W_out).
    Returns:
      [..., H_out, W_out, C] in x.dtype.
    """
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = out_hw
    if (h_in, w_in) == (h_out, w_out):
        return x
    ft = torch.promote_types(x.dtype, torch.float32)
    wh = torch.from_numpy(_bilinear_matrix_align_corners(h_in, h_out)).to(
        x.device, ft)
    ww = torch.from_numpy(_bilinear_matrix_align_corners(w_in, w_out)).to(
        x.device, ft)
    y = torch.einsum("oh,...hwc->...owc", wh, x.to(ft))
    y = torch.einsum("pw,...owc->...opc", ww, y)
    return y.to(x.dtype)


def resize_nearest_legacy(x: torch.Tensor, out_hw: tuple[int, int]
                          ) -> torch.Tensor:
    """Nearest-neighbour resize of the last two axes with the legacy torch
    index (src = floor(dst * in/out)); used for label masks.

    Args:
      x: [..., H, W].
    """
    iy = torch.from_numpy(_nearest_index_legacy(x.shape[-2], out_hw[0]))
    ix = torch.from_numpy(_nearest_index_legacy(x.shape[-1], out_hw[1]))
    y = torch.index_select(x, -2, iy.to(x.device))
    return torch.index_select(y, -1, ix.to(x.device))
