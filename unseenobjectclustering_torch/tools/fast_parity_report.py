"""Fast-mode vs parity-mode quality report on a trained checkpoint (the
port of the JAX package's tools/fast_parity_report.py).

The fast configuration (bfloat16 convolutions and similarities,
stride-SEED_SUBSAMPLE farthest-point seeding: FAST_CLUSTER) departs from
the reference-exact path (float32, every pixel seeded).  This tool puts a
number on it with trained embeddings: it segments held-out rendered
scenes in both modes with one checkpoint (stage 1, the 0.8 depth filter)
and reports Objects/Boundary F against the ground truth, plus the direct
fast-vs-parity agreement (Objects F of the fast labels against the parity
labels).

Runs on cuda:<--gpu> unless given --device cpu.  One difference from the
JAX tool: --out defaults to output/fast_parity.md (git-ignored), not to a
file under docs/.  --render-cache lets the test split's scenes come from a
cache of tools.render_dataset --split test instead of being ray cast here.

Usage:
  python -m unseenobjectclustering_torch.tools.fast_parity_report \\
      --pretrained <snapshot dir or .pth> [--cfg <yml>] [--scenes 50] \\
      [--height 480 --width 640] [--render-cache output/render_cache]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)
from unseenobjectclustering_torch.engine import builder
from unseenobjectclustering_torch.engine.evaluate import average_metrics
from unseenobjectclustering_torch.ops.preprocess import compute_xyz_np
from unseenobjectclustering_torch.utils.evaluation import multilabel_metrics

KEYS = ("Objects F-measure", "Boundary F-measure",
        "obj_detected_075_percentage")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pretrained", required=True)
    p.add_argument("--cfg", dest="cfg_file", type=str, default=None)
    p.add_argument("--network", dest="network_name", type=str,
                   default="seg_resnet34_8s_embedding")
    p.add_argument("--scenes", type=int, default=50)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--out", default=os.path.join("output", "fast_parity.md"))
    p.add_argument("--subsample", type=int, default=8,
                   help="fast-mode farthest-point seeding stride "
                        "(8 = the FAST_CLUSTER preset)")
    p.add_argument("--render-cache", type=str, default=None,
                   help="scene cache of tools.render_dataset --split test")
    p.add_argument("--gpu", dest="gpu_id", type=int, default=0,
                   help="run on cuda:<gpu>")
    p.add_argument("--device", type=str, default=None,
                   help="another device than cuda:<gpu> (cpu for the "
                        "tests)")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the report; returns {"average": {mode: averaged metrics},
    "frames": {mode: [per-scene metrics]}, "agreement": [per-scene Objects
    F of fast against parity]}."""
    args = parse_args(argv)
    if args.cfg_file:
        base = Config.from_yaml(args.cfg_file).replace(MODE="TEST")
    else:
        base = Config.inference_default(INPUT="RGBD")
    ds = SyntheticTabletopDataset("test", base, height=args.height,
                                  width=args.width, size=args.scenes,
                                  cache_dir=args.render_cache)

    modes = {
        "parity": base,
        "fast": base.replace(CLUSTER={"DTYPE": "bfloat16",
                                      "SEED_SUBSAMPLE": args.subsample}),
    }
    device = args.device or f"cuda:{args.gpu_id}"
    segs = {
        name: builder.build_segmentor(
            cfg, args.network_name, pretrained=args.pretrained,
            depth_threshold=0.8,
            model_dtype=torch.bfloat16 if name == "fast" else None,
            device=device)
        for name, cfg in modes.items()
    }

    per_mode: dict[str, list] = {name: [] for name in modes}
    agrees = []
    pm = base.pixel_means.astype(np.float32) / 255.0
    for i in range(args.scenes):
        bgr, depth_mm, gt = ds.get_scene(i)
        img = (bgr.astype(np.float32) / 255.0 - pm)[None]
        xyz = compute_xyz_np(depth_mm.astype(np.float32) / 1000.0,
                             ds.f, ds.f, ds.cx, ds.cy)[None]
        labels = {}
        for name, seg in segs.items():
            res = seg.segment(img, xyz, refine=False)
            labels[name] = res.labels[0]
            per_mode[name].append(
                multilabel_metrics(labels[name], gt.astype(np.int32)))
        # the same instances up to relabelling: F between the two label maps
        cross = multilabel_metrics(labels["fast"],
                                   labels["parity"].astype(np.int32))
        agrees.append(cross["Objects F-measure"])
        if (i + 1) % 10 == 0:
            print(f"[{i + 1}/{args.scenes}]", flush=True)

    avg = {name: average_metrics(ms) for name, ms in per_mode.items()}
    lines = [
        "# Fast-mode vs parity-mode on a trained checkpoint",
        "",
        f"Checkpoint: `{args.pretrained}`; {args.scenes} held-out rendered "
        f"scenes at {args.height}x{args.width}; stage-1 clustering.",
        "",
        f"| metric | parity (fp32, stride-1) | fast (bf16, "
        f"stride-{args.subsample}) | delta |",
        "|---|---|---|---|",
    ]
    for k in KEYS:
        pv, fv = avg["parity"][k], avg["fast"][k]
        lines.append(f"| {k} | {pv:.4f} | {fv:.4f} | {fv - pv:+.4f} |")
    lines += [
        "",
        f"Direct fast-vs-parity instance agreement (Objects F of fast "
        f"labels against parity labels): mean {np.mean(agrees):.4f}, "
        f"min {np.min(agrees):.4f}.",
    ]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    print("\n".join(lines[4:]))
    print(f"wrote {args.out}")
    return {"average": avg, "frames": per_mode, "agreement": agrees}


if __name__ == "__main__":
    main()
