"""Zoom-in refinement ops (stage 2): RoI crops, the crop veto and paste
order, the host paste-back, and the dense relabel of stage-1 ids.

Port of ``unseenobjectclustering_tpu/ops/roi.py`` (reference
lib/fcn/test_dataset.py:62-228) and of ``_dense_relabel`` in
``unseenobjectclustering_tpu/ops/train_pipeline.py``.  As in the JAX
package, everything is padded to a static instance count M: slot i holds
instance id i+1, and ``valid`` marks the slots whose id is present.

Boxes, crops, veto and order keys are plain PyTorch on the tensors' device,
with no host sync and no atomic adds onto a few hot addresses where a
reduction does (boxes, the dense relabel's presence); the order-dependent
paste-back runs on the host (the native library, numpy as its plain version).

  * The crops compute the JAX package's coordinates in the same float32
    order, as XLA compiles them: a division by the constant S - 1 or S is
    a product with its float32 reciprocal, and y0 + t * extent is one fused
    multiply-add.  F.interpolate / grid_sample
    are not used: their coordinate arithmetic differs in the last bit,
    which moves floor() at integer boundaries.
  * Counts are exact integers (scatter-adds into fixed-size bins; the JAX
    package sums a bf16 one-hot in float32, equal below 2^24 pixels).
    ``torch.bincount`` is not used: on CUDA it reads its input's maximum
    on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from unseenobjectclustering_torch.data import native as _native
from unseenobjectclustering_torch.ops.resize import _nearest_index_legacy


def _counts(bins: torch.Tensor, size: int,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact int64 count of each bin in [0, size) over bins (int64), each
    entry weighted by 0/1 weights when given."""
    src = torch.ones_like(bins) if weights is None else weights.to(bins.dtype)
    return torch.zeros(size, dtype=bins.dtype,
                       device=bins.device).scatter_add_(0, bins, src)


# ---------------------------------------------------------------------------
# stage-1 ids
# ---------------------------------------------------------------------------

def _dense_relabel(label: torch.Tensor, max_id: int = 255) -> torch.Tensor:
    """Remap ids 0..max_id to their presence rank, order kept
    (tabletop_object.py:158-172; datasets.process_label): rank(i) = number
    of present ids below i.  When id 0 is absent the smallest present id
    becomes 0.  Ids outside 0..max_id become 0, as the JAX package's
    one-hot drops them.  Returns int32 of label's shape."""
    flat = label.reshape(-1).long()
    inside = (flat >= 0) & (flat <= max_id)
    ids = torch.where(inside, flat, max_id + 1)
    present = torch.zeros(max_id + 2, dtype=torch.bool,
                          device=label.device).scatter_(0, ids, True)
    present = present[:max_id + 1]
    rank = torch.cumsum(present.long(), 0) - 1
    out = torch.where(inside, rank[ids.clamp(max=max_id)], 0)
    return out.to(torch.int32).reshape(label.shape)


def filter_labels_boxes(labels: torch.Tensor, boxes: torch.Tensor,
                        threshold: float = 0.8,
                        max_labels: int = 128) -> torch.Tensor:
    """Zero out instances lying mostly INSIDE the given boxes
    (filter_labels, test_dataset.py:205-228; the ROS pipeline uses it to
    suppress detections on known-object boxes).

    Args:
      labels: [H, W] int instance labels (0 = background).
      boxes: [K, 4] (x1, y1, x2, y2) float or int boxes; rows of zeros
        cover nothing.
      threshold: remove an instance when more than this fraction of its
        pixels falls in the union of the boxes.
    """
    h, w = labels.shape
    dev = labels.device
    ys = torch.arange(h, device=dev)[None, :, None]
    xs = torch.arange(w, device=dev)[None, None, :]
    b = boxes.to(torch.int32)  # truncates toward zero, as astype does
    x1, y1 = b[:, 0].clamp(0, w - 1), b[:, 1].clamp(0, h - 1)
    x2, y2 = b[:, 2].clamp(0, w - 1), b[:, 3].clamp(0, h - 1)
    inside = ((xs >= x1[:, None, None]) & (xs < x2[:, None, None])
              & (ys >= y1[:, None, None]) & (ys < y2[:, None, None]))
    bbox_mask = inside.any(dim=0).reshape(-1)
    lab = labels.reshape(-1).long()
    known = (lab >= 0) & (lab < max_labels)
    ids = torch.where(known, lab, max_labels)
    counts = _counts(ids, max_labels + 1)
    covered = _counts(ids, max_labels + 1, weights=bbox_mask)
    frac = covered.float() / counts.float().clamp(min=1.0)
    drop = frac > threshold
    drop[0] = False
    drop[max_labels] = False  # ids outside 0..max_labels-1 are kept
    out = torch.where(drop[ids], 0, labels.reshape(-1).to(torch.int32))
    return out.reshape(h, w)


# ---------------------------------------------------------------------------
# RoI extraction
# ---------------------------------------------------------------------------

class CropBatch(NamedTuple):
    rgb_crops: torch.Tensor    # [M, S, S, 3]
    mask_crops: torch.Tensor   # [M, S, S] float (nearest-resized instance)
    depth_crops: torch.Tensor  # [M, S, S, 3] (zeros without depth)
    rois: torch.Tensor         # [M, 4] (x_min, y_min, x_max, y_max) int32
    valid: torch.Tensor        # [M] bool: which slots hold an instance


def _instance_boxes(labels: torch.Tensor, max_instances: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Tight boxes of instance ids 1..max_instances (masked min/max).

    Returns (boxes [M, 4] int32 (x0, y0, x1, y1), present [M] bool); row i
    is id i+1 (background 0 is skipped, test_dataset.py:68-70) and an
    absent id's box is 0.
    """
    h, w = labels.shape
    ids = torch.arange(1, max_instances + 1, device=labels.device)
    masks = labels[None] == ids[:, None, None].to(labels.dtype)  # [M, H, W]
    # the min/max over an instance's pixels is the min/max over the rows
    # (columns) that hold any of them: two any-reductions, no atomics
    rows, cols = masks.any(dim=2), masks.any(dim=1)
    big = 1 << 30
    ys = torch.arange(h, device=labels.device)
    xs = torch.arange(w, device=labels.device)
    x0 = torch.where(cols, xs, big).amin(dim=1)
    y0 = torch.where(rows, ys, big).amin(dim=1)
    x1 = torch.where(cols, xs, -big).amax(dim=1)
    y1 = torch.where(rows, ys, -big).amax(dim=1)
    present = rows.any(dim=1)
    boxes = torch.where(present[:, None],
                        torch.stack([x0, y0, x1, y1], dim=1), 0)
    return boxes.to(torch.int32), present


def _pad_boxes(boxes: torch.Tensor, h: int, w: int,
               padding_percentage: float = 0.25) -> torch.Tensor:
    """25%-padded, boundary-clamped boxes (test_dataset.py:83-90).  The pad
    is round(0.25 * extent) with round-half-even (torch.round, as in the
    JAX package); 0.25 * extent ends in .5 only for extent % 4 == 2."""
    x0, y0, x1, y1 = boxes.unbind(1)
    xpad = torch.round((x1 - x0).float() * padding_percentage).to(torch.int32)
    ypad = torch.round((y1 - y0).float() * padding_percentage).to(torch.int32)
    return torch.stack([(x0 - xpad).clamp(min=0),
                        (y0 - ypad).clamp(min=0),
                        (x1 + xpad).clamp(max=w - 1),
                        (y1 + ypad).clamp(max=h - 1)], dim=1)


def _reciprocal(n: int) -> torch.Tensor:
    """float32(1/n): XLA turns a float32 division by a constant into a
    product with its reciprocal."""
    return torch.tensor(1.0 / n, dtype=torch.float32)


def _fma(t: torch.Tensor, extent: torch.Tensor, start: torch.Tensor
         ) -> torch.Tensor:
    """float32(start + t * extent) with one rounding, [M, S] from t [S] and
    int extent, start [M]: XLA fuses the product and the sum into one
    multiply-add.  In float64 both are exact (t has 24 significant bits,
    the ints fewer than 24), so rounding once to float32 gives the fused
    result on any device."""
    return (start.double()[:, None]
            + t.double() * extent.double()[:, None]).float()


def _roi_bilinear_crop(img: torch.Tensor, boxes: torch.Tensor,
                       size: int) -> torch.Tensor:
    """Crop img[y0:y1+1, x0:x1+1] per box and bilinear-resize it
    (align_corners=True) to [M, size, size, C] with a coordinate-mapped
    gather: t = arange(S) * (1/(S-1)), then y0 + t*(y1-y0) fused, in
    float32."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = boxes.unbind(1)
    t = (torch.arange(size, dtype=torch.float32, device=img.device)
         * _reciprocal(size - 1))
    ys = _fma(t, y1 - y0, y0)   # [M, S]
    xs = _fma(t, x1 - x0, x0)
    y_lo = torch.floor(ys).long().clamp(0, h - 1)
    y_hi = (y_lo + 1).clamp(0, h - 1)
    x_lo = torch.floor(xs).long().clamp(0, w - 1)
    x_hi = (x_lo + 1).clamp(0, w - 1)
    wy = (ys - y_lo.float())[:, :, None, None]
    wx = (xs - x_lo.float())[:, None, :, None]

    def g(yy, xx):  # [M, S, S, C]
        return img[yy[:, :, None], xx[:, None, :]]

    return ((1 - wy) * (1 - wx) * g(y_lo, x_lo)
            + (1 - wy) * wx * g(y_lo, x_hi)
            + wy * (1 - wx) * g(y_hi, x_lo)
            + wy * wx * g(y_hi, x_hi))


def _roi_nearest_crop(img: torch.Tensor, boxes: torch.Tensor,
                      size: int) -> torch.Tensor:
    """Crop + nearest resize per box with the legacy torch index
    (src = floor(dst * crop * (1/size)) in float32): [M, size, size, ...]."""
    h, w = img.shape[:2]
    x0, y0, x1, y1 = boxes.unbind(1)
    d = torch.arange(size, dtype=torch.float32, device=img.device)
    crop_h = (y1 - y0 + 1).float()[:, None]
    crop_w = (x1 - x0 + 1).float()[:, None]
    inv = _reciprocal(size)
    ys = y0[:, None] + torch.floor(d * crop_h * inv).to(torch.int32)
    xs = x0[:, None] + torch.floor(d * crop_w * inv).to(torch.int32)
    ys = ys.clamp(0, h - 1).long()
    xs = xs.clamp(0, w - 1).long()
    return img[ys[:, :, None], xs[:, None, :]]


def crop_rois(rgb: torch.Tensor, labels: torch.Tensor,
              xyz: Optional[torch.Tensor], *, max_instances: int = 32,
              crop_size: int = 224) -> CropBatch:
    """RoI extraction for the zoom-in network (test_dataset.py:62-112),
    padded to a static instance count.

    Args:
      rgb: [H, W, 3] normalized image (NHWC).
      labels: [H, W] int stage-1 instance labels (0 = background).
      xyz: [H, W, 3] XYZ image, or None (then the depth crops are zeros).
    """
    h, w = labels.shape
    boxes, present = _instance_boxes(labels, max_instances)
    boxes = _pad_boxes(boxes, h, w)
    crop_rgb = _roi_bilinear_crop(rgb, boxes, crop_size)
    ids = torch.arange(1, max_instances + 1, device=labels.device)
    crop_mask = (_roi_nearest_crop(labels, boxes, crop_size)
                 == ids[:, None, None].to(labels.dtype)).float()
    if xyz is not None:
        crop_xyz = _roi_bilinear_crop(xyz, boxes, crop_size)
    else:
        crop_xyz = torch.zeros((max_instances, crop_size, crop_size, 3),
                               dtype=torch.float32, device=labels.device)

    def zero(a):  # absent slots hold zeros
        return torch.where(present.reshape((-1,) + (1,) * (a.ndim - 1)),
                           a, 0)

    return CropBatch(rgb_crops=zero(crop_rgb), mask_crops=zero(crop_mask),
                     depth_crops=zero(crop_xyz), rois=boxes, valid=present)


# ---------------------------------------------------------------------------
# veto + paste order (on the device: the host fetches only the label crops)
# ---------------------------------------------------------------------------

def veto_and_order(labels_crop: torch.Tensor, mask_crops: torch.Tensor,
                   depth_z: Optional[torch.Tensor], valid: torch.Tensor,
                   max_labels: int = 128
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Crop-cluster veto and paste order key, the first two phases of
    match_label_crop (test_dataset.py:116-148):

      * a crop cluster overlapping the stage-1 instance mask < 50% becomes
        -1,
      * order key = mean valid depth (z > 0) over the surviving pixels, over
        the whole crop when none survive; +inf (farthest, pasted first) when
        there is no valid depth; -inf for invalid slots.

    Args:
      labels_crop: [M, S, S] int per-crop cluster labels (>= 0).
      mask_crops: [M, S, S] stage-1 instance mask resized into each crop.
      depth_z: [M, S, S] z of the crop point cloud, or None (key 0; the
        caller orders by RoI area).
      valid: [M] bool.
    Returns:
      (labels_veto [M, S, S] int8, or int16 when max_labels > 128, with -1
       for vetoed pixels; key [M] float32, larger = pasted earlier).
    """
    m, s, _ = labels_crop.shape
    lab = labels_crop.reshape(m, s * s).long()
    # bins per crop: ids 0..max_labels-1, then one for ids outside, which
    # the JAX package's one-hot drops (never vetoed)
    ids = torch.where((lab >= 0) & (lab < max_labels), lab, max_labels)
    nb = max_labels + 1
    bins = (ids + nb * torch.arange(m, device=lab.device)[:, None]).reshape(-1)
    counts = _counts(bins, m * nb).reshape(m, nb)
    overlap = _counts(bins, m * nb,
                      weights=(mask_crops.reshape(-1) > 0)).reshape(m, nb)
    vetoed = (overlap.float() / counts.float().clamp(min=1.0)) < 0.5
    vetoed[:, max_labels] = False
    lab_veto = torch.where(vetoed.gather(1, ids), -1, lab)

    if depth_z is not None:
        z = depth_z.reshape(m, s * s)
        sel = lab_veto >= 0
        use = sel | ~sel.any(dim=1, keepdim=True)  # none survive: all
        ok = (z > 0) & use
        cnt = ok.sum(dim=1)
        avg = torch.where(ok, z, 0.0).sum(dim=1) / cnt.clamp(min=1)
        key = torch.where(cnt > 0, avg, torch.inf)
    else:
        key = torch.zeros(m, dtype=torch.float32, device=lab.device)
    key = torch.where(valid, key, -torch.inf)
    # int8 holds ids < 128 only: wider label spaces keep int16
    out_dtype = torch.int8 if max_labels <= 128 else torch.int16
    return lab_veto.reshape(m, s, s).to(out_dtype), key


# ---------------------------------------------------------------------------
# paste-back (host-side numpy: per frame, order-dependent)
# ---------------------------------------------------------------------------

def paste_back(initial_labels: np.ndarray, labels_veto: np.ndarray,
               order_key: np.ndarray, rois: np.ndarray,
               valid: np.ndarray,
               fallback_labels: Optional[np.ndarray] = None,
               native: bool = True) -> np.ndarray:
    """Final paste (test_dataset.py:150-179): crops by key descending
    (farther first), surviving clusters relabeled sequentially, each crop
    nearest-resized back into its RoI; later (closer) crops overwrite.

    fallback_labels (cfg.CLUSTER.REFINE_FALLBACK): [H, W] DENSE stage-1
    labels where crop slot i holds instance id i+1.  When given and every
    zoom-in cluster of a crop was vetoed, the stage-1 instance mask is
    pasted unchanged (at its depth-order position) instead of the instance
    being deleted.  None = the reference's semantics.

    Each crop's resize and overwrite runs in the native library
    (``data/native.nearest_paste_nonzero``, as the JAX package's
    ``ops/roi.py`` does) for int32 labels; native=False, or other label
    dtypes, take the numpy paste, its plain version."""
    order = np.argsort(-order_key, kind="stable")
    refined = np.zeros_like(initial_labels)
    count = 0
    for i in order:
        if not valid[i]:
            continue
        ids = [m for m in np.unique(labels_veto[i]) if m != -1]
        if not ids and fallback_labels is not None:
            inst = fallback_labels == (i + 1)
            if inst.any():
                count += 1
                refined[inst] = count
            continue
        relabeled = np.zeros(labels_veto[i].shape, initial_labels.dtype)
        for mask_id in ids:
            count += 1
            relabeled[labels_veto[i] == mask_id] = count
        x0, y0, x1, y1 = (int(v) for v in rois[i])
        region = refined[y0:y1 + 1, x0:x1 + 1]
        if native and refined.dtype == np.int32:
            _native.nearest_paste_nonzero(relabeled, region)
            continue
        resized = _nearest_resize_np(relabeled, (y1 - y0 + 1, x1 - x0 + 1))
        nz = resized > 0
        region[nz] = resized[nz]
    return refined


def _nearest_resize_np(mask: np.ndarray, out_hw: tuple[int, int]
                       ) -> np.ndarray:
    iy = _nearest_index_legacy(mask.shape[0], out_hw[0])
    ix = _nearest_index_legacy(mask.shape[1], out_hw[1])
    return mask[iy][:, ix]


def match_label_crop(initial_labels: np.ndarray, labels_crop: np.ndarray,
                     mask_crops: np.ndarray, rois: np.ndarray,
                     depth_crops: Optional[np.ndarray],
                     valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All-host merge of per-crop cluster labels into a refined mask
    (test_dataset.py:116-179), the oracle of veto_and_order + paste_back:

      1. veto crop clusters overlapping the original instance mask < 50%,
      2. order instances back to front by mean z (or RoI area),
      3. paste nearest-resized crops; later (closer) instances overwrite.

    Args:
      initial_labels: [H, W] stage-1 labels.
      labels_crop: [M, S, S] clustering labels of each crop.
      mask_crops: [M, S, S] the stage-1 instance mask resized into the crop.
      rois: [M, 4] (x0, y0, x1, y1).
      depth_crops: [M, S, S, 3] or None.
      valid: [M] bool.
    Returns:
      (refined [H, W] int labels, labels_crop after the veto).
    """
    labels_crop = labels_crop.copy()
    num = labels_crop.shape[0]
    order_key = np.full((num,), -np.inf, np.float32)
    for i in range(num):
        if not valid[i]:
            continue
        for mask_id in np.unique(labels_crop[i]):
            m = labels_crop[i] == mask_id
            pct = (mask_crops[i][m] > 0).sum() / max(m.sum(), 1)
            if pct < 0.5:
                labels_crop[i][m] = -1
        if depth_crops is not None:
            sel = labels_crop[i] > -1
            z = depth_crops[i, :, :, 2][sel] if sel.any() \
                else depth_crops[i, :, :, 2]
            z = z[z > 0]
            # no valid depth: +inf = farthest = pasted first, as
            # veto_and_order (the reference's mean over nothing is NaN)
            order_key[i] = z.mean() if z.size else np.inf
        else:
            x0, y0, x1, y1 = rois[i]
            order_key[i] = (y1 - y0 + 1) * (x1 - x0 + 1)
    refined = paste_back(initial_labels, labels_crop, order_key, rois, valid)
    return refined, labels_crop
