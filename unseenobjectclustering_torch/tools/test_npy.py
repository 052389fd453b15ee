"""Segment .npy sample dicts (CLI parity with the reference
tools/test_npy.py and the JAX package's tools/test_npy.py: input files are
numpy dicts with 'rgb', 'depth', and optionally 'debug_info' carrying
intrinsics).  numpy only, so it runs where OpenCV and PIL are missing.

Example:
  python -m unseenobjectclustering_torch.tools.test_npy --imgdir samples/ \\
      --network seg_resnet34_8s_embedding --pretrained ckpt.pth [--fast]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Optional, Sequence

import numpy as np

from unseenobjectclustering_torch.tools.common import (add_model_args,
                                                       host_inputs, make_cfg,
                                                       make_segmentor)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Segment unseen objects in .npy RGB-D dumps (PyTorch)")
    add_model_args(parser)
    parser.add_argument("--imgdir", type=str, required=True)
    parser.add_argument("--outdir", type=str, default=None)
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        parser.print_help()
        sys.exit(1)
    return parser.parse_args(argv)


def read_npy_sample(path: str
                    ) -> tuple[np.ndarray, Optional[np.ndarray], tuple]:
    """Decode one .npy dump into (rgb u8 BGR, depth_m float|None,
    (fx, fy, px, py)).

    Two dump flavors, mirroring the reference (tools/test_npy.py:105-122):
    'debug_info' carries a 3x3 intrinsics matrix, an already-in-meters
    depth image and the rgb; the plain flavor stores uint16 MILLIMETER
    depth that must be /1000'd.
    """
    data = np.load(path, allow_pickle=True, encoding="latin1").item()
    if "debug_info" in data:
        info = data["debug_info"]
        rgb = info["rgb"]
        depth_m = info["depth_image"]
        k = np.asarray(info["intrinsics"], np.float64)
        fx, fy = float(k[0, 0]), float(k[1, 1])
        px, py = float(k[0, 2]), float(k[1, 2])
    else:
        rgb = data["rgb"]  # BGR uint8 HWC
        depth = data.get("depth")
        depth_m = (depth.astype(np.float32) / 1000.0
                   if depth is not None else None)
        fx = fy = 616.0
        px, py = rgb.shape[1] / 2.0, rgb.shape[0] / 2.0
    return rgb, depth_m, (fx, fy, px, py)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    cfg = make_cfg(args)
    files = sorted(glob.glob(os.path.join(args.imgdir, "*.npy")))
    if not files:
        print(f"no .npy files under {args.imgdir}")
        sys.exit(1)
    outdir = args.outdir or args.imgdir
    os.makedirs(outdir, exist_ok=True)

    segmentor = make_segmentor(cfg, args)
    for path in files:
        rgb, depth_m, intrinsics = read_npy_sample(path)
        image, xyz = host_inputs(cfg, rgb, depth_m, intrinsics)
        res = segmentor.segment(image, xyz,
                                refine=args.pretrained_crop is not None)
        labels = (res.labels_refined if res.labels_refined is not None
                  else res.labels)[0]
        out = os.path.join(
            outdir, os.path.basename(path).replace(".npy", "-label.npy"))
        np.save(out, labels)
        print(f"{path}: {len(np.unique(labels)) - 1} objects -> {out}")


if __name__ == "__main__":
    main()
