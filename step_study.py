#!/usr/bin/env python3
"""Readings of chip_smoke.py's card-vs-CPU train step over several draw
seeds, from which its limits (STEP_TOL, R50_STEP_TOL) are calibrated.

    python3 step_study.py [--nets NET,...] [--seeds 7,8,9] [--out FILE]

For each network (default: ResNet-34-8s and ResNet-50-8s, RGB-D add) and
draw seed, chip_smoke.check_step_against_cpu runs ungated: one float32 SGD
step at SMALL_HW, batch 2, on the card and on the CPU from the same
fixed-seed weights and pinned draws, and the two planted faults (TF32 on;
the depth tower's conv1 gradient zeroed).  Prints, per network, every
reading of the sound step and of each fault, and the largest sound
readings and smallest fault readings over the seeds; --out writes them
as JSON.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

import chip_smoke

KEYS = ("loss_rtol", "grad_rel_l2", "grad_median_rel_l2", "grad_max_rel_l2",
        "param_atol")


def readings(row: dict) -> dict:
    """The values that chip_smoke.step_against holds to its limits."""
    return {"loss_rtol": row["loss_rel"],
            "grad_rel_l2": row["vs_cpu"]["rel_l2"],
            "grad_median_rel_l2": row["vs_cpu"]["median_rel_l2"],
            "grad_max_rel_l2": row["vs_cpu"]["max_rel_l2"],
            "param_atol": row["param_max_abs"],
            "stat_max_abs": row["stat_max_abs"]}


def study(net: str, seeds: list[int]) -> dict:
    arch = net[len("seg_"):-len("_embedding")]
    runs = {}
    for seed in seeds:
        res = chip_smoke.check_step_against_cpu(
            seed, net=net, fault_tensor=f"fcn_depth.{arch}.conv1.weight",
            gate=False)
        runs[seed] = {name: readings(res[name]) for name in (
            "card", "card_tf32", "card_zeroed_grad")}
        runs[seed]["cpu_vs_fp64"] = res["cpu_vs_fp64"]
    sound = {k: max(r["card"][k] for r in runs.values())
             for k in KEYS + ("stat_max_abs",)}
    faults = {name: {k: min(r[name][k] for r in runs.values())
                     for k in KEYS + ("stat_max_abs",)}
              for name in ("card_tf32", "card_zeroed_grad")}
    print(f"[{net}] sound step, largest over draws {seeds}: {sound}")
    for name, row in faults.items():
        print(f"[{net}] {name}, smallest over draws {seeds}: {row}")
    return dict(runs=runs, sound_max=sound, faults_min=faults)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nets", default="seg_resnet34_8s_embedding,"
                        "seg_resnet50_8s_embedding")
    parser.add_argument("--seeds", default="7,8,9")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("step_study: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(chip_smoke.card_line())
    seeds = [int(v) for v in args.seeds.split(",")]
    out = {net: study(net, seeds) for net in args.nets.split(",")}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
