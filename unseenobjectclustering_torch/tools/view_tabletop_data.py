"""Browse TableTop Object Dataset samples (the port of the JAX package's
tools/view_tabletop_data.py, parity with the reference
tools/view_tabletop_data.py): one image / depth / labels grid per sample,
saved as <outdir>/sample_%05d.png.

Reads through the port's data.get_dataset (TableTop's JPEGs through
utils/jpeg.py: no OpenCV); matplotlib is imported only to draw.

Example:
  python -m unseenobjectclustering_torch.tools.view_tabletop_data \\
      --dataset_root data/tabletop --num 4 --outdir viz/
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data.factory import get_dataset


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="View TOD samples")
    parser.add_argument("--dataset", dest="dataset_name", type=str,
                        default="tabletop_object_train")
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--cfg", dest="cfg_file", type=str, default=None)
    parser.add_argument("--num", type=int, default=8)
    parser.add_argument("--outdir", type=str, default="viz")
    return parser.parse_args(argv)


def grid_inputs(sample: dict, pixel_means: np.ndarray
                ) -> tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """The grid's panels of one sample: the image denormalized to uint8
    BGR, the XYZ image (None without depth) and the labels with ignored
    pixels (-1) shown as background."""
    im = (sample["image_color"] + pixel_means / 255.0) * 255.0
    im = np.clip(im, 0, 255).astype(np.uint8)
    return im, sample.get("depth"), np.maximum(sample["label"], 0)


def main(argv: Optional[Sequence[str]] = None) -> list[str]:
    """Save the grids; returns the paths written."""
    args = parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from unseenobjectclustering_torch.utils.visualization import (
        segmentation_grid)

    cfg = (Config.from_yaml(args.cfg_file) if args.cfg_file
           else Config.default())
    cfg = cfg.replace(MODE="TEST")
    dataset = get_dataset(args.dataset_name, cfg, path=args.dataset_root)
    os.makedirs(args.outdir, exist_ok=True)
    written = []
    for i in range(min(args.num, len(dataset))):
        im, xyz, lab = grid_inputs(dataset[i], cfg.pixel_means)
        fig = segmentation_grid(im, xyz, None, lab)
        out = os.path.join(args.outdir, f"sample_{i:05d}.png")
        fig.savefig(out, dpi=100)
        plt.close(fig)
        print(f"wrote {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
