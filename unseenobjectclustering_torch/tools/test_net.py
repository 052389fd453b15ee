"""Evaluate a network on OCID / OSD / TOD-test / the synthetic test split
(CLI parity with the reference tools/test_net.py:24-131 and the JAX
package's tools/test_net.py).

Runs on cuda:<--gpu> unless given --device cpu; the OCID and OSD readers
need numpy, zlib and g++ only (no OpenCV, no PIL).

Example:
  python -m unseenobjectclustering_torch.tools.test_net \\
      --network seg_resnet34_8s_embedding --dataset ocid_object_test \\
      --dataset_root data/OCID --pretrained ckpt.pth \\
      --pretrained_crop ckpt_crop.pth
"""

from __future__ import annotations

import argparse
import pprint
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from unseenobjectclustering_torch.config import get_output_dir
from unseenobjectclustering_torch.data.factory import get_dataset
from unseenobjectclustering_torch.engine import builder
from unseenobjectclustering_torch.engine.evaluate import (
    depth_threshold_for, evaluate_dataset)
from unseenobjectclustering_torch.tools.common import (add_model_args,
                                                       make_cfg)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Test an unseen-object clustering network (PyTorch)")
    add_model_args(parser)
    parser.add_argument("--dataset", dest="dataset_name", type=str,
                        default="ocid_object_test")
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--rand", dest="randomize", action="store_true")
    parser.add_argument("--network_crop", dest="crop_network_name",
                        type=str, default=None,
                        help="zoom-in backbone factory (default: same as "
                             "--network)")
    parser.add_argument("--max_images", type=int, default=None)
    parser.add_argument("--crop_size", type=int, default=None,
                        help="zoom-in crop side (default "
                             "cfg.TRAIN.SYN_CROP_SIZE)")
    parser.add_argument("--output-dir", type=str, default=None,
                        help="where the .mat results go (default: "
                             "output/<EXP_DIR>/<dataset>)")
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        parser.print_help()
        sys.exit(1)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> tuple[dict, dict]:
    """Run the CLI; returns evaluate_dataset's (stage-1, refined) averaged
    metrics."""
    args = parse_args(argv)
    print("Called with args:")
    print(args)
    cfg = make_cfg(args)
    if args.crop_size:
        cfg = cfg.replace(TRAIN={"SYN_CROP_SIZE": args.crop_size})
    print("Using config:")
    pprint.pprint(cfg.to_dict())
    if not args.randomize:
        np.random.seed(cfg.RNG_SEED)

    dataset = get_dataset(args.dataset_name, cfg, path=args.dataset_root)
    output_dir = args.output_dir or get_output_dir(cfg, dataset.name)
    print(f"Output will be saved to `{output_dir}`")
    segmentor = builder.build_segmentor(
        cfg, args.network_name, pretrained=args.pretrained,
        pretrained_crop=args.pretrained_crop,
        crop_network_name=args.crop_network_name,
        depth_threshold=depth_threshold_for(dataset.name),
        model_dtype=torch.bfloat16 if args.fast else None,
        device=args.device or f"cuda:{args.gpu_id}")
    return evaluate_dataset(dataset, segmentor, output_dir=output_dir,
                            refine=args.pretrained_crop is not None,
                            max_images=args.max_images)


if __name__ == "__main__":
    main()
