"""Real-image F-measures on hand-annotated demo frames.

Port of the JAX package's tools/eval_demo_gt.py: runs the two-stage
Segmentor on each frame that has a GT mask (`<gtdir>/<name>-label.png`,
made by tools/annotate_demo_gt.py) and reports per-frame and mean
Objects F / Boundary F / %75 (utils/evaluation.py, metric parity with the
reference's lib/utils/evaluation.py:109-257) for the stage-1 and the
refined predictions.  The RGB-D pairs (`<imgdir>/<name>-color.png`,
`-depth.png`, `camera_params.json`) are the reference's data/demo frames.
Needs OpenCV for the PNG IO.

Example:
  python -m unseenobjectclustering_torch.tools.eval_demo_gt --fast \\
      --pretrained ckpt.pth --pretrained_crop ckpt_crop.pth \\
      --crop_network seg_resnet18_8s_embedding --crop_size 128 \\
      --report demo_eval.md
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
from unseenobjectclustering_torch.utils.evaluation import multilabel_metrics

KEYS = ("Objects F-measure", "Objects Precision", "Objects Recall",
        "Boundary F-measure", "obj_detected_075_percentage")
SHORT = ("Objects F", "P", "R", "Boundary F", "%75")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Evaluate demo-frame predictions against hand GT")
    add_model_args(p)
    p.add_argument("--imgdir", type=str, default="data/demo")
    p.add_argument("--gtdir", type=str, default="data/demo_gt")
    p.add_argument("--crop_network", type=str, default=None)
    p.add_argument("--crop_size", type=int, default=None)
    p.add_argument("--refine_fallback", action="store_true",
                   help="keep stage-1 instances whose zoom-in clusters "
                        "were ALL vetoed (cfg.CLUSTER.REFINE_FALLBACK) "
                        "instead of deleting them (reference default)")
    p.add_argument("--depth_factor", type=float, default=1000.0)
    p.add_argument("--report", type=str, default=None,
                   help="write a markdown table + .json sidecar here")
    return p.parse_args(argv)


def write_report(path: str, rows: list[dict], summary: dict,
                 command: str) -> None:
    """The markdown table of every frame and stage plus the means, and a
    .json sidecar with the full metric dicts."""
    lines = [
        "# Real-image F-measures (hand-annotated demo frames)", "",
        f"{len(rows)} annotated RealSense frames (GT: "
        "tools/annotate_demo_gt.py; metrics: "
        "unseenobjectclustering_torch/utils/evaluation.py).", "",
        "Command: `" + command + "`", "",
        "| frame | GT objs | stage | Objects F | P | R | Boundary F "
        "| %75 |", "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        for stage in ("stage1", "refined"):
            if stage not in r:
                continue
            m = r[stage]
            lines.append(f"| {r['frame']} | {r['gt_objects']} | {stage} | "
                         + " | ".join(f"{m[k]:.3f}" for k in KEYS) + " |")
    lines += ["", "| stage | " + " | ".join(SHORT) + " |",
              "|---|" + "---|" * len(SHORT)]
    for stage, m in summary.items():
        lines.append(f"| mean {stage} | "
                     + " | ".join(f"{m[k]:.3f}" for k in KEYS) + " |")
    lines.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
    with open(os.path.splitext(path)[0] + ".json", "w") as fh:
        json.dump({"rows": rows, "mean": summary}, fh, indent=1,
                  default=float)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    import cv2

    cfg = make_cfg(args)
    if args.refine_fallback:
        cfg = cfg.replace(CLUSTER={"REFINE_FALLBACK": True})
    if args.crop_size:
        cfg = cfg.replace(TRAIN={"SYN_CROP_SIZE": args.crop_size})

    gt_files = sorted(glob.glob(os.path.join(args.gtdir, "*-label.png")))
    if not gt_files:
        sys.exit(f"no *-label.png GT under {args.gtdir}")
    with open(os.path.join(args.imgdir, "camera_params.json")) as fh:
        intrinsics = camera_params_to_arrays(json.load(fh))

    segmentor = make_segmentor(cfg, args, args.crop_network)
    rows = []
    for gt_file in gt_files:
        name = os.path.basename(gt_file).replace("-label.png", "")
        im = cv2.imread(os.path.join(args.imgdir, f"{name}-color.png"))
        raw = cv2.imread(os.path.join(args.imgdir, f"{name}-depth.png"),
                         cv2.IMREAD_ANYDEPTH)
        if im is None or raw is None:
            raise IOError(f"cannot read the RGB-D pair of {name} under "
                          f"{args.imgdir}")
        gt = cv2.imread(gt_file, cv2.IMREAD_GRAYSCALE).astype(np.int32)
        depth = raw.astype(np.float32) / args.depth_factor
        image, xyz = host_inputs(cfg, im, depth, intrinsics)
        res = segmentor.segment(image, xyz,
                                refine=args.pretrained_crop is not None)
        row = {"frame": name,
               "gt_objects": int(len(np.unique(gt)) - 1),
               "stage1": multilabel_metrics(res.labels[0], gt)}
        if res.labels_refined is not None:
            row["refined"] = multilabel_metrics(res.labels_refined[0], gt)
        rows.append(row)
        print(f"{name}: gt={row['gt_objects']} "
              f"s1 OF={row['stage1']['Objects F-measure']:.3f} "
              f"BF={row['stage1']['Boundary F-measure']:.3f}"
              + (f" ref OF={row['refined']['Objects F-measure']:.3f} "
                 f"BF={row['refined']['Boundary F-measure']:.3f}"
                 if "refined" in row else ""))

    summary = {stage: {k: float(np.mean([r[stage][k] for r in rows]))
                       for k in KEYS}
               for stage in ("stage1", "refined")
               if any(stage in r for r in rows)}
    print(json.dumps({"frames": len(rows), "mean": summary}, indent=1))
    if args.report:
        command = " ".join(["python -m unseenobjectclustering_torch.tools."
                            "eval_demo_gt"] + list(
                                sys.argv[1:] if argv is None else argv))
        write_report(args.report, rows, summary, command)
        print(f"wrote {args.report}")


if __name__ == "__main__":
    main()
