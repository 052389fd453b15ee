"""Qualitative regression artifact: segmentation overlays on the real
RGB-D demo pairs (the reference's data/demo/, README.md:56).

Port of the JAX package's tools/demo_artifact.py: runs the two-stage
Segmentor on every `<imgdir>/*-color.png` and writes ONE grid image
(rows = scenes; columns = color / stage-1 overlay / refined overlay) and a
`.json` sidecar with each frame's stage-1 instance count.  The PNG IO,
the contours and the grid's resize have OpenCV's bits without OpenCV
(``utils/png.py``, ``utils/masks.py``, ``utils/imgproc.py``).

Example:
  python -m unseenobjectclustering_torch.tools.demo_artifact \\
      --pretrained ckpt.pth [--pretrained_crop ckpt_crop.pth] \\
      [--imgdir data/demo] [--out demo_overlays.png] [--fast]
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
from unseenobjectclustering_torch.utils import png
from unseenobjectclustering_torch.utils.imgproc import resize_u8


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Overlay grid of the demo frames")
    add_model_args(p)
    p.add_argument("--imgdir", default="data/demo")
    p.add_argument("--out", default="docs/demo_overlays.png")
    p.add_argument("--scale", type=float, default=0.5)
    p.add_argument("--crop_network", type=str, default=None,
                   help="zoom-in factory (e.g. seg_resnet18_8s_embedding)")
    p.add_argument("--crop_size", type=int, default=None)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    from unseenobjectclustering_torch.utils.masks import (
        visualize_segmentation)

    cfg = make_cfg(args)
    if args.crop_size:
        cfg = cfg.replace(TRAIN={"SYN_CROP_SIZE": args.crop_size})
    color_files = sorted(glob.glob(os.path.join(args.imgdir, "*-color.png")))
    if not color_files:
        sys.exit(f"no *-color.png under {args.imgdir}")
    with open(os.path.join(args.imgdir, "camera_params.json")) as f:
        intrinsics = camera_params_to_arrays(json.load(f))

    segmentor = make_segmentor(cfg, args, args.crop_network)
    rows = []
    counts = {}
    for color_file in color_files:
        im = png.imread(color_file)
        raw = png.imread(color_file.replace("-color.png", "-depth.png"),
                         "anydepth")
        depth = raw.astype(np.float32) / 1000.0
        image, xyz = host_inputs(cfg, im, depth, intrinsics)
        res = segmentor.segment(image, xyz,
                                refine=segmentor.model_crop is not None)
        cells = [im, visualize_segmentation(im, res.labels[0])]
        if res.labels_refined is not None:
            cells.append(visualize_segmentation(im, res.labels_refined[0]))
        rows.append(np.concatenate(cells, axis=1))
        n1 = len(np.unique(res.labels[0])) - 1
        counts[os.path.basename(color_file)] = n1
        print(f"{os.path.basename(color_file)}: {n1} stage-1 objects",
              flush=True)

    grid = np.concatenate(rows, axis=0)
    if args.scale != 1.0:
        grid = resize_u8(grid, args.scale)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    png.imwrite(args.out, grid)
    with open(args.out + ".json", "w") as f:
        json.dump({"pretrained": args.pretrained,
                   "stage1_instances": counts}, f, indent=1)
    print(f"wrote {args.out} ({grid.shape[1]}x{grid.shape[0]})")


if __name__ == "__main__":
    main()
