"""Segment a directory of RGB-D images (CLI parity with the reference
tools/test_images.py:138-225 and the JAX package's tools/test_images.py).

Expects `<imgdir>/*-color.png` + `*-depth.png` pairs and an optional
`<imgdir>/camera_params.json` (else the RealSense D415 defaults); writes
`<name>-label.png` (and with --vis a color overlay) next to the inputs or
under --outdir.  Needs OpenCV for the PNG IO.

Example:
  python -m unseenobjectclustering_torch.tools.test_images --imgdir data/demo \\
      --pretrained ckpt.pth --pretrained_crop ckpt_crop.pth [--fast] [--gpu 0]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from unseenobjectclustering_torch.ops.preprocess import (
    camera_params_to_arrays)
from unseenobjectclustering_torch.tools.common import (add_model_args,
                                                       host_inputs, make_cfg,
                                                       make_segmentor)

# Intel RealSense D415 intrinsics (ros/test_images_segmentation.py)
D415_PARAMS = {"fx": 616.0, "fy": 616.0, "x_offset": 310.0,
               "y_offset": 240.0}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Segment unseen objects in RGB-D images (PyTorch)")
    add_model_args(parser)
    parser.add_argument("--imgdir", type=str, required=True)
    parser.add_argument("--outdir", type=str, default=None)
    parser.add_argument("--depth_factor", type=float, default=1000.0,
                        help="depth png value per meter")
    parser.add_argument("--vis", action="store_true",
                        help="also save color overlay images")
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        parser.print_help()
        sys.exit(1)
    return parser.parse_args(argv)


def read_sample(color_file: str, depth_file: str, depth_factor: float
                ) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Read one RGB-D pair (tools/test_images.py:96-135 semantics)."""
    import cv2

    im = cv2.imread(color_file)
    if im is None:
        raise IOError(f"cannot read color image {color_file} "
                      "(missing or corrupt; cv2.imread returned None)")
    depth = None
    if depth_file and os.path.exists(depth_file):
        raw = cv2.imread(depth_file, cv2.IMREAD_ANYDEPTH)
        if raw is None:
            raise IOError(f"cannot read depth image {depth_file} "
                          "(corrupt; cv2.imread returned None)")
        depth = raw.astype(np.float32) / depth_factor
    return im, depth


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    import cv2

    from unseenobjectclustering_torch.utils.masks import (
        get_color_mask, visualize_segmentation)

    cfg = make_cfg(args)
    color_files = sorted(glob.glob(os.path.join(args.imgdir, "*-color.png")))
    if not color_files:
        print(f"no *-color.png files under {args.imgdir}")
        sys.exit(1)
    params_file = os.path.join(args.imgdir, "camera_params.json")
    params = D415_PARAMS
    if os.path.exists(params_file):
        with open(params_file) as f:
            params = json.load(f)
    intrinsics = camera_params_to_arrays(params)

    outdir = args.outdir or args.imgdir
    os.makedirs(outdir, exist_ok=True)

    segmentor = make_segmentor(cfg, args)
    for color_file in color_files:
        depth_file = color_file.replace("-color.png", "-depth.png")
        im, depth = read_sample(color_file, depth_file, args.depth_factor)
        image, xyz = host_inputs(cfg, im, depth, intrinsics)
        res = segmentor.segment(image, xyz,
                                refine=args.pretrained_crop is not None)
        labels = (res.labels_refined if res.labels_refined is not None
                  else res.labels)[0]

        base = os.path.basename(color_file).replace("-color.png", "")
        out_label = os.path.join(outdir, base + "-label.png")
        cv2.imwrite(out_label, labels.astype(np.uint8))
        if args.vis:
            overlay = visualize_segmentation(im, labels)
            cv2.imwrite(os.path.join(outdir, base + "-seg.png"), overlay)
            cv2.imwrite(os.path.join(outdir, base + "-mask.png"),
                        get_color_mask(labels))
        n = len(np.unique(labels)) - 1
        print(f"{color_file}: {n} objects -> {out_label} "
              f"({res.timing['total']:.2f}s)")


if __name__ == "__main__":
    main()
