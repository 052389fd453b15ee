"""Write rendered scenes into the OCID and OSD on-disk layouts.

The port's copy of the JAX package's tools/make_real_fixtures.py, with
neither OpenCV nor PIL: images and indexed labels go through
``utils/png.py`` and the clouds through ``data/pcd.py``.  The files are
the datasets' own formats (reference readers:
lib/datasets/ocid_object.py:43-112, lib/datasets/osd_object.py:60-88), so
the same ``tools.test_net --dataset ocid_object_test --dataset_root
<root>/OCID`` command reads these trees and the real datasets.

OCID conventions (ocid_object.py:86-95): label 1 is the support plane and
background; in sequences whose path holds "table", label 2 is background
too; objects follow (2+ on floor sequences, 3+ on table sequences); the
clouds are organized HxW binary_compressed PCDs with NaN where there is
no depth.  OSD: image_color/ + annotation/ (objects 1..K) + pcd/.

Usage:
  python -m unseenobjectclustering_torch.tools.make_real_fixtures \\
      --root output/fixtures --num 20
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data.pcd import save_pcd_xyz
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)
from unseenobjectclustering_torch.ops.preprocess import compute_xyz_np
from unseenobjectclustering_torch.utils import png
from unseenobjectclustering_torch.utils.masks import imwrite_indexed


def _cloud(ds, depth_mm: np.ndarray) -> np.ndarray:
    """The organized [H, W, 3] cloud of a scene, NaN where depth is 0."""
    depth = depth_mm.astype(np.float32) / 1000.0
    xyz = compute_xyz_np(depth, ds.f, ds.f, ds.cx, ds.cy)
    xyz[depth == 0] = np.nan
    return xyz


def write_ocid(root: str, ds, indices: Sequence[int], *,
               compressed: bool = True) -> None:
    """OCID tree: ARID20/{floor/seq01,table/seq02}/{rgb,label,pcd}/."""
    half = (len(indices) + 1) // 2
    seqs = [("ARID20/floor/seq01", False, indices[:half]),
            ("ARID20/table/seq02", True, indices[half:])]
    for seq, is_table, idxs in seqs:
        for sub in ("rgb", "label", "pcd"):
            os.makedirs(os.path.join(root, seq, sub), exist_ok=True)
        for i in idxs:
            bgr, depth_mm, gt = ds.get_scene(i)
            name = f"result_2026_{i:04d}.png"
            png.write_bgr(os.path.join(root, seq, "rgb", name), bgr)
            # plane = 1 (table sequences also reserve 2), objects after
            shift = 2 if is_table else 1
            lab = np.where(gt > 0, gt + shift, 1).astype(np.uint8)
            if is_table:
                # a second support-plane strip with id 2, which the reader
                # must erase on "table" paths
                strip = (gt == 0) & (np.arange(gt.shape[0])[:, None]
                                     > gt.shape[0] * 3 // 4)
                lab[strip] = 2
            imwrite_indexed(os.path.join(root, seq, "label", name), lab)
            save_pcd_xyz(os.path.join(root, seq, "pcd",
                                      name.replace("png", "pcd")),
                         _cloud(ds, depth_mm), compressed=compressed)


def write_osd(root: str, ds, indices: Sequence[int], *,
              compressed: bool = True) -> None:
    """OSD tree: image_color/ + annotation/ + pcd/."""
    for sub in ("image_color", "annotation", "pcd"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in indices:
        bgr, depth_mm, gt = ds.get_scene(i)
        name = f"learn{i:02d}.png"
        png.write_bgr(os.path.join(root, "image_color", name), bgr)
        imwrite_indexed(os.path.join(root, "annotation", name),
                        gt.astype(np.uint8))
        save_pcd_xyz(os.path.join(root, "pcd", name.replace("png", "pcd")),
                     _cloud(ds, depth_mm), compressed=compressed)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--root", default="output/fixtures")
    p.add_argument("--num", type=int, default=20)
    p.add_argument("--dataset", default="both",
                   choices=["ocid", "osd", "both"])
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--start", type=int, default=100,
                   help="first test-split scene index")
    p.add_argument("--uncompressed", action="store_true",
                   help="write binary PCDs instead of binary_compressed")
    return p.parse_args(sys.argv[1:] if argv is None else list(argv))


def main(argv: Optional[Sequence[str]] = None) -> SyntheticTabletopDataset:
    """Write the trees; returns the dataset whose scenes they hold."""
    args = parse_args(argv)
    cfg = Config.from_dict({"INPUT": "RGBD", "MODE": "TEST"})
    ds = SyntheticTabletopDataset("test", cfg, height=args.height,
                                  width=args.width,
                                  size=args.start + args.num)
    idxs = list(range(args.start, args.start + args.num))
    comp = not args.uncompressed
    if args.dataset in ("ocid", "both"):
        write_ocid(os.path.join(args.root, "OCID"), ds, idxs,
                   compressed=comp)
        print(f"OCID tree: {args.root}/OCID ({len(idxs)} images, "
              f"{'binary_compressed' if comp else 'binary'} PCDs)")
    if args.dataset in ("osd", "both"):
        write_osd(os.path.join(args.root, "OSD"), ds, idxs, compressed=comp)
        print(f"OSD tree: {args.root}/OSD ({len(idxs)} images)")
    return ds


if __name__ == "__main__":
    main()
