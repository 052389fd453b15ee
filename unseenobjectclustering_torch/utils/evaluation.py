"""Segmentation evaluation metrics: Overlap + Boundary P/R/F per image.

Port of ``unseenobjectclustering_tpu/utils/evaluation.py`` (the reference's
lib/utils/evaluation.py:15-257, itself modeled on the DAVIS boundary
F-measure and Dave et al. arXiv19), kept as the port's own copy so that it
imports nothing of the JAX package:

  * ``seg2bmap`` — 1-pixel-wide binary boundary map by shifted XOR.
  * ``boundary_overlap`` — dilate each boundary by a disk of radius
    ceil(0.003 * ||(H,W)||) and count precision/recall true positives.
  * ``multilabel_metrics`` — pairwise GT x pred F-matrix, Hungarian
    assignment on F.max() - F, Objects/Boundary P/R/F and the fraction of GT
    objects detected with F > 0.75, including the three empty-GT/pred edge
    cases.

The G x P true-positive matrix is one confusion-matrix bincount; boundary
true positives gather each mask's sparse boundary pixels from the other
side's dilated-boundary stack (G + P dilations, not G * P).  Hungarian
assignment is scipy.optimize.linear_sum_assignment.

Host-side numpy: metrics consume final label images.  OpenCV dilates when it
is installed; without it a numpy shift-OR gives the same map.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

BACKGROUND_LABEL = 0
OBJECTS_LABEL = 1


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Binary boundary map with 1-px-wide boundaries (evaluation.py:15-72).

    Boundary pixels are offset by 1/2 pixel towards the origin from the
    actual segment boundary (XOR against east/south/southeast shifts).
    """
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]

    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def disk(radius: int) -> np.ndarray:
    """Boolean disk structuring element — replicates
    skimage.morphology.disk(radius) (x^2 + y^2 <= r^2 on an integer grid)."""
    r = int(radius)
    y, x = np.mgrid[-r:r + 1, -r:r + 1]
    return (x * x + y * y <= r * r).astype(np.uint8)


def _dilate(bmap: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation by a disk; cv2 when it is installed, else a numpy
    shift-OR (the same map)."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.dilate(bmap.astype(np.uint8), disk(radius),
                          iterations=1).astype(bool)
    r = int(radius)
    out = np.zeros_like(bmap, dtype=bool)
    h, w = bmap.shape
    k = disk(r).astype(bool)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if not k[dy + r, dx + r]:
                continue
            ys = slice(max(0, dy), min(h, h + dy))
            yd = slice(max(0, -dy), min(h, h - dy))
            xs = slice(max(0, dx), min(w, w + dx))
            xd = slice(max(0, -dx), min(w, w - dx))
            out[yd, xd] |= bmap[ys, xs]
    return out


def _bound_pix(shape: tuple[int, int], bound_th: float = 0.003) -> int:
    """Dilation radius: ceil(bound_th * ||(H, W)||_2) (evaluation.py:88-89)."""
    if bound_th >= 1:
        return int(bound_th)
    return int(np.ceil(bound_th * np.linalg.norm(shape)))


def boundary_overlap(predicted_mask: np.ndarray, gt_mask: np.ndarray,
                     bound_th: float = 0.003) -> tuple[int, int]:
    """(precision TPs, recall TPs) of dilated-boundary overlap
    (evaluation.py:75-106)."""
    radius = _bound_pix(predicted_mask.shape, bound_th)
    fg_boundary = seg2bmap(predicted_mask)
    gt_boundary = seg2bmap(gt_mask)
    gt_dil = _dilate(gt_boundary, radius)
    fg_dil = _dilate(fg_boundary, radius)
    fg_match = np.logical_and(fg_boundary, gt_dil)
    gt_match = np.logical_and(gt_boundary, fg_dil)
    return int(np.sum(fg_match)), int(np.sum(gt_match))


def _edge_case(num_pred: int, num_gt: int) -> dict:
    """The three empty-side returns (evaluation.py:142-177)."""
    if num_pred == 0 and num_gt > 0:      # all false negatives
        vals = dict(F=0., P=1., R=0., pct=0.)
    elif num_pred > 0 and num_gt == 0:    # all false positives
        vals = dict(F=0., P=0., R=1., pct=0.)
    else:                                 # correctly predicted nothing
        vals = dict(F=1., P=1., R=1., pct=1.)
    return {
        "Objects F-measure": vals["F"],
        "Objects Precision": vals["P"],
        "Objects Recall": vals["R"],
        "Boundary F-measure": vals["F"],
        "Boundary Precision": vals["P"],
        "Boundary Recall": vals["R"],
        "obj_detected": num_pred,
        "obj_detected_075": 0.,
        "obj_gt": num_gt,
        "obj_detected_075_percentage": vals["pct"],
    }


def multilabel_metrics(prediction: np.ndarray, gt: np.ndarray,
                       obj_detect_threshold: float = 0.75) -> dict:
    """Overlap + Boundary P/R/F with Hungarian matching
    (evaluation.py:109-257).

    Only object labels (> 0) participate; label 0 is background (datasets map
    the table class to 0 upstream).  A "confident object" is a GT object
    matched with F > obj_detect_threshold.
    """
    prediction = np.asarray(prediction)
    gt = np.asarray(gt)

    labels_gt = np.unique(gt)
    labels_gt = labels_gt[labels_gt != BACKGROUND_LABEL]
    labels_pred = np.unique(prediction)
    labels_pred = labels_pred[labels_pred != BACKGROUND_LABEL]
    num_gt, num_pred = labels_gt.shape[0], labels_pred.shape[0]

    if num_pred == 0 or num_gt == 0:
        return _edge_case(num_pred, num_gt)

    # --- pairwise overlap TP via one confusion-matrix bincount --------------
    gt_idx = np.searchsorted(labels_gt, gt.ravel())
    gt_idx = np.clip(gt_idx, 0, num_gt - 1)
    gt_valid = gt.ravel() == labels_gt[gt_idx]
    pred_idx = np.searchsorted(labels_pred, prediction.ravel())
    pred_idx = np.clip(pred_idx, 0, num_pred - 1)
    pred_valid = prediction.ravel() == labels_pred[pred_idx]
    both = gt_valid & pred_valid
    true_positives = np.bincount(
        gt_idx[both] * num_pred + pred_idx[both],
        minlength=num_gt * num_pred).reshape(num_gt, num_pred).astype(np.int64)

    gt_sizes = np.bincount(gt_idx[gt_valid], minlength=num_gt)      # |gt_i|
    pred_sizes = np.bincount(pred_idx[pred_valid], minlength=num_pred)

    with np.errstate(divide="ignore", invalid="ignore"):
        prec = true_positives / pred_sizes[None, :]
        rec = true_positives / gt_sizes[:, None]
        F = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    F = np.nan_to_num(F)

    # --- boundary maps + dilations (G + P of each, not G*P) -----------------
    radius = _bound_pix(prediction.shape)
    pred_bmaps = [seg2bmap(prediction == p) for p in labels_pred]
    gt_bmaps = [seg2bmap(gt == g) for g in labels_gt]
    pred_dils = [_dilate(b, radius) for b in pred_bmaps]
    gt_dils = [_dilate(b, radius) for b in gt_bmaps]

    # boundary_stuff[i, j] = (precision TPs, recall TPs) for (gt_i, pred_j):
    # gather each side's sparse boundary pixels in the other side's dilation
    boundary_stuff = np.zeros((num_gt, num_pred, 2))
    gt_dil_stack = np.stack([d.ravel() for d in gt_dils])    # [G, HW] bool
    pred_dil_stack = np.stack([d.ravel() for d in pred_dils])
    for j, pb in enumerate(pred_bmaps):
        idx = np.flatnonzero(pb.ravel())
        boundary_stuff[:, j, 0] = gt_dil_stack[:, idx].sum(axis=1)
    for i, gb in enumerate(gt_bmaps):
        idx = np.flatnonzero(gb.ravel())
        boundary_stuff[i, :, 1] = pred_dil_stack[:, idx].sum(axis=1)

    boundary_prec_denom = float(sum(b.sum() for b in pred_bmaps))
    boundary_rec_denom = float(sum(b.sum() for b in gt_bmaps))

    # --- Hungarian assignment on F.max() - F --------------------------------
    row_ind, col_ind = linear_sum_assignment(F.max() - F)
    idx = (row_ind, col_ind)

    num_obj_detected = int(np.sum(F[idx] > obj_detect_threshold))

    # overlap measures: denominators are ALL non-background pixels
    # (evaluation.py:233-236 — clip(0,1) == OBJECTS_LABEL)
    n_pred_px = np.sum(prediction > 0)
    n_gt_px = np.sum(gt > 0)
    precision = np.sum(true_positives[idx]) / n_pred_px if n_pred_px else 0.0
    recall = np.sum(true_positives[idx]) / n_gt_px if n_gt_px else 0.0
    F_measure = ((2 * precision * recall) / (precision + recall)
                 if precision + recall > 0 else 0.0)

    bp = (np.sum(boundary_stuff[idx][:, 0]) / boundary_prec_denom
          if boundary_prec_denom else 0.0)
    br = (np.sum(boundary_stuff[idx][:, 1]) / boundary_rec_denom
          if boundary_rec_denom else 0.0)
    bF = (2 * bp * br) / (bp + br) if bp + br > 0 else 0.0

    return {
        "Objects F-measure": float(F_measure),
        "Objects Precision": float(precision),
        "Objects Recall": float(recall),
        "Boundary F-measure": float(bF),
        "Boundary Precision": float(bp),
        "Boundary Recall": float(br),
        "obj_detected": int(num_pred),
        "obj_detected_075": num_obj_detected,
        "obj_gt": int(num_gt),
        "obj_detected_075_percentage": num_obj_detected / num_gt,
    }
