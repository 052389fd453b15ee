"""What the entry points share: the model flags, the config, the
Segmentor and the host preprocessing of the JAX package's CLIs."""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from unseenobjectclustering_torch.config import FAST_CLUSTER, Config
from unseenobjectclustering_torch.engine import builder
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.ops.preprocess import compute_xyz_np


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """--gpu, --device, --pretrained, --pretrained_crop, --cfg, --network,
    --fast."""
    parser.add_argument("--gpu", dest="gpu_id", type=int, default=0,
                        help="run on cuda:<gpu>")
    parser.add_argument("--device", type=str, default=None,
                        help="another device than cuda:<gpu> (cpu for the "
                             "tests)")
    parser.add_argument("--pretrained", type=str, default=None)
    parser.add_argument("--pretrained_crop", type=str, default=None)
    parser.add_argument("--cfg", dest="cfg_file", type=str, default=None)
    parser.add_argument("--network", dest="network_name", type=str,
                        default="seg_resnet34_8s_embedding")
    parser.add_argument("--fast", action="store_true",
                        help="FAST_CLUSTER and bfloat16 convolutions")


def make_cfg(args: argparse.Namespace) -> Config:
    """The --cfg file or the shipped-recipe defaults, in TEST mode, with
    the FAST_CLUSTER preset under --fast."""
    cfg = (Config.from_yaml(args.cfg_file) if args.cfg_file
           else Config.inference_default())
    cfg = cfg.replace(MODE="TEST")
    if args.fast:
        cfg = cfg.replace(CLUSTER=dict(FAST_CLUSTER))
    return cfg


def make_segmentor(cfg: Config, args: argparse.Namespace,
                   crop_network_name: Optional[str] = None) -> Segmentor:
    """builder.build_segmentor with the flags' checkpoints, dtype and
    device, and the demo depth threshold 0.8."""
    return builder.build_segmentor(
        cfg, args.network_name, pretrained=args.pretrained,
        pretrained_crop=args.pretrained_crop, depth_threshold=0.8,
        model_dtype=torch.bfloat16 if args.fast else None,
        crop_network_name=crop_network_name,
        device=args.device or f"cuda:{args.gpu_id}")


def host_inputs(cfg: Config, bgr: np.ndarray, depth_m: Optional[np.ndarray],
                intrinsics: tuple) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """[1, H, W, 3] normalized BGR and XYZ (None without depth or for a
    COLOR network), on the host as the JAX package's CLIs build them."""
    image = (bgr.astype(np.float32) / 255.0 - cfg.pixel_means / 255.0)[None]
    xyz = None
    if depth_m is not None and cfg.INPUT in ("DEPTH", "RGBD"):
        xyz = compute_xyz_np(depth_m.astype(np.float32), *intrinsics)[None]
    return image, xyz
