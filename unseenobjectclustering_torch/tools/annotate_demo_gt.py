"""Semi-automatic ground-truth instance masks for the real demo frames
(the port of the JAX repo's tools/annotate_demo_gt.py).

  1. `propose`: fit the table plane (RANSAC on the backprojected cloud),
     mark points more than --height-mm above it as foreground, and number
     its connected components (at least --min-px pixels) as proposals:
     <work-dir>/<frame>-proposal.npy and an overlay PNG for review.
  2. `apply`: a per-frame JSON spec of edits (keep / merge / erase /
     split / polygon / ellipse / grabcut / refine / erase_final / clip,
     written by a person looking at the overlays) turns the proposals
     into <out-dir>/<frame>-label.png (0 = background, 1..K instances
     in scan order) and a verification overlay.

The GT convention matches OCID/OSD: the table and everything off it are
background, each object on the table one id.  The frames are read from
--demo-dir (<frame>-color.png, <frame>-depth.png in millimetres,
camera_params.json with fx, fy, x_offset, y_offset).

PNGs go through utils/png (cv2.imread's arrays, cv2.imwrite's bytes),
connected components through scipy.ndimage.label (cv2's 4- and
8-connectivity and its numbering), polygons, ellipses and
morphology through utils/imgproc (cv2's bits).  GrabCut, the flood fill
and the overlay's numbers have no replica: those steps import cv2 where
they run and raise without it.

Usage:
  python -m unseenobjectclustering_torch.tools.annotate_demo_gt propose \\
      --demo-dir data/demo --frame 0
  python -m unseenobjectclustering_torch.tools.annotate_demo_gt apply \\
      --demo-dir data/demo --frame 0 --spec data/demo_gt/specs/000000.json
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
from scipy import ndimage

from unseenobjectclustering_torch.utils import imgproc, png

DEFAULT_DEMO = os.path.join("data", "demo")


def _cv2(step: str):
    """OpenCV for a step that has no replica in the port."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"annotate_demo_gt: {step} needs OpenCV (cv2), "
                          "which is not installed") from e
    return cv2


def load_frame(demo_dir: str, idx: int):
    """BGR uint8, depth in metres (float32) and the camera parameters."""
    color = png.imread(os.path.join(demo_dir, f"{idx:06d}-color.png"))
    depth = png.imread(os.path.join(demo_dir, f"{idx:06d}-depth.png"),
                       "anydepth").astype(np.float32)
    depth /= 1000.0
    with open(os.path.join(demo_dir, "camera_params.json")) as fh:
        cam = json.load(fh)
    return color, depth, cam


def backproject(depth: np.ndarray, cam: dict) -> np.ndarray:
    h, w = depth.shape
    us, vs = np.meshgrid(np.arange(w), np.arange(h))
    z = depth
    x = (us - cam["x_offset"]) * z / cam["fx"]
    y = (vs - cam["y_offset"]) * z / cam["fy"]
    return np.stack([x, y, z], axis=-1)


def fit_table_plane(xyz: np.ndarray, iters: int = 500, tol: float = 0.006,
                    seed: int = 0, roi=None):
    """RANSAC dominant-plane fit on the valid cloud, refined by least
    squares on its inliers.  `roi` (x0, y0, x1, y1) restricts the fit to
    a box (frames where the floor, not the table, is the dominant plane).
    Returns (normal, d), the normal toward the camera, so that
    xyz @ normal + d > 0 is above the table."""
    if roi is not None:
        x0, y0, x1, y1 = roi
        xyz = xyz[y0:y1, x0:x1]
    pts = xyz.reshape(-1, 3)
    pts = pts[pts[:, 2] > 0.1]
    rng = np.random.RandomState(seed)
    sub = pts[rng.choice(len(pts), min(len(pts), 40000), replace=False)]
    best = (None, -1)
    for _ in range(iters):
        p = sub[rng.choice(len(sub), 3, replace=False)]
        n = np.cross(p[1] - p[0], p[2] - p[0])
        nn = np.linalg.norm(n)
        if nn < 1e-9:
            continue
        n = n / nn
        d = -n.dot(p[0])
        cnt = int((np.abs(sub @ n + d) < tol).sum())
        if cnt > best[1]:
            best = ((n, d), cnt)
    (n, d), _ = best
    q = sub[np.abs(sub @ n + d) < tol]
    c = q.mean(axis=0)
    _, _, vt = np.linalg.svd(q - c, full_matrices=False)
    n = vt[2]
    d = -n.dot(c)
    if d < 0:  # the camera origin on the positive side
        n, d = -n, -d
    return n, d


def connected_components(mask: np.ndarray, connectivity: int
                         ) -> tuple[int, np.ndarray]:
    """cv2.connectedComponents(mask, connectivity=4 or 8): the number of
    labels with the background's, and int32 labels numbered as cv2
    numbers them: at 4-connectivity (SAUF, row by row) in raster order of
    each component's first pixel, at 8-connectivity (its 2x2-block
    scan) in raster order of the first 2x2 block (rows 2i, 2i+1, columns
    2j, 2j+1) that holds a pixel of the component."""
    structure = ndimage.generate_binary_structure(
        2, 1 if connectivity == 4 else 2)
    labels, num = ndimage.label(mask != 0, structure=structure)
    if connectivity == 8 and num > 1:
        ys, xs = np.nonzero(labels)
        block = (ys // 2) * ((mask.shape[1] + 1) // 2) + xs // 2
        first = np.full(num + 1, np.iinfo(np.int64).max)
        np.minimum.at(first, labels[ys, xs], block)
        order = np.zeros(num + 1, np.int64)
        order[np.argsort(first[1:], kind="stable") + 1] = np.arange(
            1, num + 1)
        labels = order[labels]
    return num + 1, labels.astype(np.int32)


def draw_overlay(color: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """The frame with each instance tinted and numbered at its centroid
    (the numbers through cv2.putText)."""
    rng = np.random.RandomState(1)
    palette = rng.randint(60, 255, size=(labels.max() + 1, 3))
    palette[0] = 0
    over = color.copy()
    mask = labels > 0
    over[mask] = (0.45 * color[mask] + 0.55 * palette[labels[mask]]).astype(
        np.uint8)
    if labels.max() < 1:
        return over
    cv2 = _cv2("the overlay's instance numbers (cv2.putText)")
    for k in range(1, labels.max() + 1):
        ys, xs = np.nonzero(labels == k)
        if len(ys) == 0:
            continue
        cy, cx = int(ys.mean()), int(xs.mean())
        cv2.putText(over, str(k), (cx - 8, cy + 6),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (255, 255, 255), 3)
        cv2.putText(over, str(k), (cx - 8, cy + 6),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 0, 0), 1)
    return over


def propose(idx: int, height_mm: float, min_px: int, out_dir: str,
            roi=None, demo_dir: str = DEFAULT_DEMO) -> np.ndarray:
    """Proposals of one frame: writes <idx>-proposal.npy and its overlay
    PNG into out_dir; returns the labels."""
    color, depth, cam = load_frame(demo_dir, idx)
    xyz = backproject(depth, cam)
    n, d = fit_table_plane(xyz, roi=roi)
    dist = xyz @ n + d
    fg = (depth > 0.1) & (dist > height_mm / 1000.0)
    num, cc = connected_components(fg.astype(np.uint8), 4)
    labels = np.zeros_like(cc)
    k = 0
    for c in range(1, num):
        m = cc == c
        if m.sum() >= min_px:
            k += 1
            labels[m] = k
    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, f"{idx:06d}-proposal.npy"),
            labels.astype(np.uint8))
    png.imwrite(os.path.join(out_dir, f"{idx:06d}-proposal.png"),
                draw_overlay(color, labels))
    print(f"frame {idx}: {k} proposals (plane n={np.round(n, 3)}, "
          f"d={d:.3f}) -> {out_dir}/{idx:06d}-proposal.png")
    return labels


def _polygon_mask(shape, poly) -> np.ndarray:
    mask = np.zeros(shape, np.uint8)
    imgproc.fill_poly(mask, np.asarray(poly, np.int32).reshape(-1, 2), 1)
    return mask


def _grabcut(color, mask, rect, iters, mode):
    cv2 = _cv2("GrabCut (cv2.grabCut)")
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    cv2.grabCut(color, mask, rect, bgd, fgd, iters,
                cv2.GC_INIT_WITH_RECT if mode == "rect"
                else cv2.GC_INIT_WITH_MASK)
    return cv2


# cv2's GrabCut mask values
GC_BGD, GC_FGD, GC_PR_BGD, GC_PR_FGD = 0, 1, 2, 3


def apply_spec(idx: int, spec_path: str, out_dir: str, work_dir: str,
               demo_dir: str = DEFAULT_DEMO) -> np.ndarray:
    """The spec's edits on the frame's proposals, in this order: erase ->
    split -> merge -> keep -> polygon -> ellipse -> grabcut -> split
    remainders -> hole fill -> refine -> close -> erase_final -> clip,
    then the ids re-densified to 1..K in scan order.

    Spec keys (all optional):
      erase:    [[x0,y0,x1,y1], ...]  proposal pixels in these boxes -> 0
      split:    [{"src": id, "polygon": [[x,y], ...]}, ...]  src pixels
                inside the polygon become a new instance
      merge:    [[a, b, c], ...]      proposal ids b, c -> a
      keep:     [ids]                 whitelist after the merges
      polygon:  {"new" or id: [[x,y], ...]}  hand-drawn regions claiming
                background (or their own id's pixels) only
      ellipse:  {"new" or id: [cx, cy, rx, ry, angle]}  the same with a
                filled ellipse
      grabcut:  [[x0,y0,x1,y1], ...]  GrabCut inside a box, a new instance
      refine:   false turns off the per-instance GrabCut snap;
      norefine: [ids] it skips
      erase_final: [[x0,y0,x1,y1], ...]  boxes cleared after refinement
      clip:     {id: [x0,y0,x1,y1]}  an instance kept inside a box
    Writes <idx>-label.png and <idx>-verify.png into out_dir; returns the
    labels."""
    with open(spec_path) as fh:
        spec = json.load(fh)
    color, _, _ = load_frame(demo_dir, idx)
    labels = np.load(os.path.join(work_dir, f"{idx:06d}-proposal.npy")
                     ).astype(np.int32)

    for x0, y0, x1, y1 in spec.get("erase", []):
        labels[y0:y1, x0:x1] = 0
    for op in spec.get("split", []):
        sel = (labels == op["src"]) & (_polygon_mask(labels.shape,
                                                     op["polygon"]) > 0)
        labels[sel] = labels.max() + 1
    for group in spec.get("merge", []):
        for src in group[1:]:
            labels[labels == src] = group[0]
    if "keep" in spec:
        labels[~np.isin(labels, list(set(spec["keep"])))] = 0
    next_id = labels.max() + 1
    for key, poly in spec.get("polygon", {}).items():
        mask = _polygon_mask(labels.shape, poly)
        tid = next_id if key == "new" else int(key)
        if key == "new":
            next_id += 1
        # a sloppy vertex never steals a neighbouring instance's pixels
        labels[(mask > 0) & ((labels == 0) | (labels == tid))] = tid
    for key, (ecx, ecy, erx, ery, eang) in spec.get("ellipse", {}).items():
        # the whole silhouette of a bowl or can whose inside sits at table
        # height (the depth cannot see it); background only
        mask = imgproc.fill_ellipse(np.zeros(labels.shape, np.uint8),
                                    (int(ecx), int(ecy)),
                                    (int(erx), int(ery)), float(eang), 1)
        tid = next_id if key == "new" else int(key)
        if key == "new":
            next_id += 1
        labels[(mask > 0) & ((labels == 0) | (labels == tid))] = tid
    for x0, y0, x1, y1 in spec.get("grabcut", []):
        gmask = np.zeros(labels.shape, np.uint8)
        _grabcut(color, gmask, (x0, y0, x1 - x0, y1 - y0), 5, "rect")
        labels[(gmask == GC_FGD) | (gmask == GC_PR_FGD)] = next_id
        next_id += 1
    # split remainders: only the largest 8-connected piece of a split
    # source stays; smaller scraps go to background
    for src in {op["src"] for op in spec.get("split", [])}:
        m = (labels == src).astype(np.uint8)
        if not m.any():
            continue
        num, cc = connected_components(m, 8)
        if num > 2:
            sizes = np.bincount(cc.ravel())
            sizes[0] = 0
            labels[(cc > 0) & (cc != sizes.argmax())] = 0
    # fill each instance's enclosed holes (background not reachable from
    # the corner, by cv2.floodFill)
    for k in [v for v in np.unique(labels) if v]:
        m = (labels == k).astype(np.uint8)
        ff = m.copy()
        ffmask = np.zeros((m.shape[0] + 2, m.shape[1] + 2), np.uint8)
        _cv2("the hole fill (cv2.floodFill)").floodFill(ff, ffmask, (0, 0),
                                                        1)
        labels[(ff == 0) & (m == 0) & (labels == 0)] = k
    # colour snap: GrabCut from each instance's mask may only add
    # background pixels to it
    if spec.get("refine", True):
        skip = set(spec.get("norefine", []))
        for k in [v for v in np.unique(labels) if v and v not in skip]:
            m0 = (labels == k).astype(np.uint8)
            g = np.full(labels.shape, GC_BGD, np.uint8)
            g[imgproc.morphology(m0, "dilate", np.ones((13, 13), np.uint8))
              > 0] = GC_PR_BGD
            g[m0 > 0] = GC_PR_FGD
            g[imgproc.morphology(m0, "erode", np.ones((7, 7), np.uint8))
              > 0] = GC_FGD
            cv2 = _cv2("GrabCut (cv2.grabCut)")
            try:
                _grabcut(color, g, None, 3, "mask")
            except cv2.error:
                continue  # all-FG / all-BG mask: keep the depth mask
            labels[((g == GC_FGD) | (g == GC_PR_FGD)) & (labels == 0)] = k
    # close small holes inside each instance (depth speckle)
    for k in np.unique(labels):
        if k == 0:
            continue
        m = imgproc.morphology((labels == k).astype(np.uint8), "close",
                               np.ones((5, 5), np.uint8))
        labels[(m > 0) & (labels == 0)] = k
    for x0, y0, x1, y1 in spec.get("erase_final", []):
        labels[y0:y1, x0:x1] = 0
    for key, (x0, y0, x1, y1) in spec.get("clip", {}).items():
        keep_box = np.zeros(labels.shape, bool)
        keep_box[y0:y1, x0:x1] = True
        labels[(labels == int(key)) & ~keep_box] = 0
    # densify ids in scan order
    out = np.zeros_like(labels)
    seen: dict[int, int] = {}
    for v in labels.ravel()[np.flatnonzero(labels)]:
        if v not in seen:
            seen[v] = len(seen) + 1
    for v, t in seen.items():
        out[labels == v] = t
    os.makedirs(out_dir, exist_ok=True)
    png.imwrite(os.path.join(out_dir, f"{idx:06d}-label.png"),
                out.astype(np.uint8))
    png.imwrite(os.path.join(out_dir, f"{idx:06d}-verify.png"),
                draw_overlay(color, out))
    print(f"frame {idx}: {len(seen)} instances -> "
          f"{out_dir}/{idx:06d}-label.png")
    return out


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Semi-automatic GT masks for the demo frames")
    p.add_argument("cmd", choices=["propose", "apply"])
    p.add_argument("--frame", type=int, required=True)
    p.add_argument("--demo-dir", type=str, default=DEFAULT_DEMO,
                   help="the frames' <n>-color.png, <n>-depth.png and "
                        "camera_params.json")
    p.add_argument("--height-mm", type=float, default=10.0)
    p.add_argument("--min-px", type=int, default=400)
    p.add_argument("--spec", type=str, default=None)
    p.add_argument("--work-dir", type=str, default="demo_gt_work")
    p.add_argument("--out-dir", type=str, default="data/demo_gt")
    p.add_argument("--plane-roi", type=int, nargs=4, default=None,
                   metavar=("X0", "Y0", "X1", "Y1"),
                   help="fit the table plane inside this box (frames "
                        "where the floor is the dominant plane)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    args = parse_args(argv)
    if args.cmd == "propose":
        return propose(args.frame, args.height_mm, args.min_px,
                       args.work_dir, roi=args.plane_roi,
                       demo_dir=args.demo_dir)
    if not args.spec:
        raise SystemExit("apply needs --spec")
    return apply_spec(args.frame, args.spec, args.out_dir, args.work_dir,
                      demo_dir=args.demo_dir)


if __name__ == "__main__":
    main()
