#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is caught):
  1. the card's name and power limit; build the CUDA kernels from
     unseenobjectclustering_torch/csrc and report the build time.
  2. each kernel against its plain PyTorch version on the card, at the
     stage-1 shapes (n = 480*640 pixels, d = 64, m = 100 seeds) and at
     stage 2's crop shape (n = 224*224), on clustered unit embeddings made
     from a numpy seed, in parity mode (float32, stride-1 seeding) and fast
     mode (bfloat16, stride-8 seeding); the connected components also on
     pairwise-far seeds (each its own cluster: the most merge steps); the
     launch configuration of the seeding, hill-climb and assignment kernels
     at each shape; the merge steps of the connected components; the pixels
     the assignment re-checked exactly; median CUDA-event times of one
     wrapper call and of the plain version (host latency included) beside
     the bound computed from the shapes, and each kernel's own device time
     from torch.profiler.  Then the whole clustering (mean_shift_smart_init
     with the 0.8 depth filter) on the stage-1 embeddings, kernel route
     against plain route, timed.
  3. stage 1 through Segmentor.segment_sample: seg_resnet34_8s_embedding,
     RGB-D, add fusion, 64-D embeddings, 480x640, weights from a fixed-seed
     init; a few frames in each mode, every launch counter reset just
     before each mode's frames and read just after, and every kernel
     launched in each mode; the outputs checked; in parity mode the kernel
     route's labels held against the plain route's on the same
     embeddings, and stage 1 on the card against stage 1 on the CPU on a
     60x90 window of the frame.
  4. stage 2 (zoom-in refinement) with a ResNet-34-8s RGB-D crop network
     at 224x224, MAX_INSTANCES 32: frames with 8, 16 and 32 boxes (one per
     crop bucket) whose boxes are the stage-1 labels, refined in each mode
     with the counters reset before the mode's frames: every kernel must
     launch exactly once per valid crop; the stage-2 ms per bucket (RoI
     crops, crop network, clustering, veto, fetch, paste) and peak memory;
     a torch.profiler trace of the 32-instance frame per mode (the
     device's busy ms and idle share, the top kernels and host ops);
     in parity the kernel route's refined labels equal to the plain
     route's, one crop's embeddings on the card within 1e-4 of the CPU's;
     segment_sample(refine=True) once through the public path per mode.
  5. serving and evaluation at full width: phase 3's and phase 4's
     networks saved as reference-layout .pth files ({'model': ...} with
     'module.' prefixes) and loaded back through engine.builder.
     build_segmentor in both modes (every loaded tensor equal to the saved
     one); one frame through StreamSegmentor.submit + process_latest per
     mode, its device preprocessing bit-equal to the host numpy path and
     its labels equal to Segmentor.segment's on the host-preprocessed
     frame; then a producer thread submitting 480x640 frames at 30 Hz while
     run_forever serves them (refine on), counters set to 0 before and read
     after: frames submitted, served and dropped, latency median and p90,
     every kernel launched at least once per served frame;
     evaluate_dataset over the 8/16/32-box frames in both modes (the .mat
     files re-read equal to the labels returned; random-init stage 1 finds
     no instance, so the table is the reference's empty-prediction edge
     case) and multilabel_metrics on phase 4's refined box frames (parity:
     kernel route's dicts equal to the plain route's; fast against parity,
     no gate); tools.test_npy.main() on a plain and a debug_info .npy dump,
     its labels equal to Segmentor.segment's.  One {"serving": {...}} line.
  6. training on the card: 16 scenes rendered at 480x640 by the port's
     tools.render_dataset (a process of its own with a pool of spawned
     workers, one per CPU core, numpy only) into a temporary cache; the
     stage-1
     recipe (seg_resnet34_8s_embedding, RGB-D add, Adam, batch 16, the
     rgbd_add yml) through tools.train_net.main() with --device-resident:
     2 epochs, then --resume for a third, loss/intra/inter per step, and 3
     epochs straight, the two held bitwise equal (parameters, BatchNorm
     buffers, Adam moments, step) under deterministic cuDNN; --bf16 for 2
     epochs; the zoom-in crop recipe (224x224, batch 16) for 2 epochs; for
     each recipe the s/step (median after the first of a few steps,
     CUDA events), its split into gather+augmentation, forward+backward
     and optimizer, the peak device memory and the device's idle share
     over one step (torch.profiler); no clustering kernel launches while
     training; one float32 step at 128x160, batch 2, on the card against
     the same step on the CPU with pinned augmentation draws (loss,
     gradients as one vector and per tensor, updated parameters, BatchNorm
     statistics), which must also catch two planted faults (the card's
     step with TF32 on; one tensor's gradient zeroed), every gradient
     also against a float64 step's; a Segmentor
     built by build_segmentor from the snapshot directory, its tensors
     equal to the trainer's, segmenting one cached scene.  One
     {"training": {...}} line.
  7. data: the native IO library built from native/ucio.cpp with g++ (its
     build seconds), its LZF and strided gather equal to the plain Python
     versions on a 480x640 cloud, and each PCD load's ms native and plain;
     4 scenes rendered at 480x640 by tools.render_dataset (test split)
     written by tools.make_real_fixtures as an OCID tree (a floor and a
     table sequence, binary_compressed PCDs) and an OSD tree (binary
     PCDs), with neither PIL nor OpenCV; both read back through
     get_dataset: labels by OCID's plane ids, BGR and XYZ bit-equal to the
     rendered scenes; data/demo_gt's labels through the port's PNG reader
     (ids and pixel counts); the PNG decode ms per frame;
     tools.test_net.main() with phase 5's .pth files (--pretrained and
     --pretrained_crop) on each tree and on synthetic_tabletop_test, in
     parity and with --fast, the counters set to 0 before each run and
     read after (every kernel at least once per frame), the .mat files
     equal to the labels segment returned, the s per frame;
     tools.test_images.main() (--vis) and tools.demo_artifact.main() with
     phase 5's .pth files on two of the rendered scenes written as
     -color.png / -depth.png, with no OpenCV (utils/png.py, the numpy
     contours and resize), every file they write read back.  One
     {"data": {...}} line.
  8. the alternate backbones: seg_unet_embedding and seg_vgg_embedding
     (BatchNorm), RGB-D add, fixed-seed inits, through
     Segmentor.segment_sample in parity on phase 3's 480x640 frame (every
     kernel launched in each of 2 frames; the network ms), and each
     network on the card against the CPU on a 64x96 window within 1e-4.
     One {"alternates": {...}} line.
 8b. trained stage 1: the stage-1 recipe of unseenobjectclustering_torch/
     cfgs/synthetic_240x320_rgbd_add.yml (ResNet-34-8s RGB-D add, Adam
     2e-4, batch 16, bf16) trained from scratch on the card, cut to
     TRAINED_SCENES train-split scenes rendered at 240x320 by
     tools.render_dataset and TRAINED_EPOCHS epochs, through
     tools.train_net.main() with --device-resident (the step ms, no
     clustering kernel launched); tools.fast_parity_report.main() on its
     snapshot over HELD_OUT held-out test-split scenes in both modes, each
     mode's counters set to 0 before each frame and read after (every
     kernel at least once per frame): Objects F, Boundary F and %75
     detected per mode and the fast-vs-parity agreement (mean, min), gated:
     an instance in every held-out frame, parity's mean Objects F at least
     TRAINED_FLOOR, fast's within FAST_GAP of parity's; the same report on
     phase 3's random-init ResNet must find no instance (and so miss the
     floor);
     tools.probe_seed_precision.main() on random unit vectors at the crop
     shape (n = 224*224) and on the trained parity embeddings of one
     held-out frame (n = 240*320): the plain route and the seeding kernel
     each PASS against the float64 replay.  One {"trained": {...}} line.
  9. data parallelism (unseenobjectclustering_torch.parallel), what one
     card can show of it: (a) world size 1 on NCCL (an all-reduce and an
     all-gather checked): Segmentor.segment_sharded on 4 frames at
     480x640 in both modes, the counters set to 0 before each call and
     read after, every call's labels equal per frame to one
     segment(refine=False) call on the same 4 frames of a Segmentor with
     the same seed and each kernel launched exactly once per frame: with
     phase 3's network in 3 calls per mode (frames/s and ms per frame
     beside phase 3's batch-1 stage 1), with phase 8's U-Net and with
     phase 8b's trained ResNet on 4 held-out 240x320 scenes, which must
     each find an instance in every frame (the random-init ResNet finds
     none, so its equality is between empty label maps); against each
     frame segmented alone, the pixels that differ and the embeddings
     (within 1e-4 in parity; cuDNN runs other kernels at batch 1);
     evaluate_dataset_sharded on phase 7's OCID tree (batch 4) with the
     U-Net built from a .pth file equal to the metrics of
     segment(refine=False) on the same batches, with objects detected,
     beside evaluate_dataset(refine=False)'s; Segmentor.
     make_spatial_stage1 at world size 1 (the same sharded layers, edge
     padding only) on phase 3's frame, against one process; (b) two gloo
     processes sharing the card (NCCL refuses two ranks on one device):
     first the spatial stage 1, phase 3's frame split by width over the
     two ranks (bands of 320 columns, per-layer halo exchanges staged
     through the host under gloo) with phase 3's ResNet and phase 8's
     U-Net, and a held-out 240x320 scene (bands of 160 columns) with phase
     8b's trained ResNet, in both modes: the embeddings against the
     one-process batch-1
     stage 1 (within 1e-4 in parity, 2e-2 in fast mode), the labels equal
     to the clustering of the gathered embeddings, the pixels relabelled
     against one process (U-Net and trained ResNet: instances found; in
     parity at most 0.1% of the frame relabelled and as many instances as
     one process), each
     kernel exactly once per frame on each rank, a planted zero halo in
     the ResNet's first dilated convolution that must break the parity
     gate, and the ms/frame of the two time-sliced ranks (a stand-in, not
     a latency) beside phase 3's batch-1 stage 1; then one float32 SGD
     step at 128x160 on
     2 + 2 frames (pinned draws of the global batch) within STEP_TOL of
     one process's step on the 4 frames on the card (loss, gradients,
     parameters, BatchNorm statistics), a gate that per-replica BatchNorm
     statistics and per-rank loss scalars must each break; then the
     full-width resident step of the recipe (Adam, float32), 8 + 8 of
     phase 6's scenes at 480x640, its s/step beside phase 6's one-process
     step; (c) while the ranks start and take their small steps,
     tools.train_net under torchrun --nproc_per_node 1 (NCCL, world size
     1, cuda:<LOCAL_RANK>) on phase 6's cache for one epoch,
     --device-resident: exactly one snapshot directory, from which
     build_segmentor builds a Segmentor that segments a cached scene (the
     ranks time their full-width step after torchrun has ended).  One
     {"data_parallel": ...} line.  Several cards (NCCL across them) are
     not checked here.
 10. one {"kernels": [...]} line: each kernel's launches in the parity
     and fast runs of stage 1, of stage 2, of the stream, of each
     test_net run, of the alternate networks, of phase 8b's report, of
     phase 9's sharded stage 1 and evaluation and of its spatial stage 1
     (rank 0's, per network and mode, and at world size 1), its times and
     bounds in both
     modes at the frame and the crop shape.
 11. the last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero with no result.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import multiprocessing

import numpy as np
import scipy.io
import torch
import torch.distributed as dist
import yaml
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from unseenobjectclustering_torch.config import FAST_CLUSTER, Config
from unseenobjectclustering_torch.data import native as data_native
from unseenobjectclustering_torch.data import pcd
from unseenobjectclustering_torch.data.datasets import process_label
from unseenobjectclustering_torch.data.factory import get_dataset
from unseenobjectclustering_torch.data.loader import DataLoader
from unseenobjectclustering_torch.data.resident import load_resident_scenes
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)
from unseenobjectclustering_torch.engine.builder import (build_segmentor,
                                                         load_network_state)
from unseenobjectclustering_torch.engine.evaluate import (
    average_metrics, evaluate_dataset, evaluate_dataset_sharded)
from unseenobjectclustering_torch.engine.pipeline import (Segmentor,
                                                          _cluster_batch,
                                                          _full_fp32)
from unseenobjectclustering_torch.engine import train as train_engine
from unseenobjectclustering_torch.engine.stream import StreamSegmentor
from unseenobjectclustering_torch.engine.train import (
    LOG_EVERY, create_train_state, make_train_step, make_train_step_raw,
    make_train_step_resident, step_seed)
from unseenobjectclustering_torch import parallel
from unseenobjectclustering_torch.parallel import spatial
from unseenobjectclustering_torch.models import get_network, losses, resnet
from unseenobjectclustering_torch.ops import _build
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_torch.ops.mean_shift import mean_shift_smart_init
from unseenobjectclustering_torch.ops.preprocess import (compute_xyz,
                                                         compute_xyz_np,
                                                         normalize_bgr,
                                                         preprocess_rgbd)
from unseenobjectclustering_torch.ops.roi import _dense_relabel, crop_rois
from unseenobjectclustering_torch.ops.train_pipeline import (
    make_device_augment)
from unseenobjectclustering_torch.tools import (demo_artifact,
                                                fast_parity_report,
                                                make_real_fixtures,
                                                probe_seed_precision,
                                                test_images, test_net,
                                                test_npy, train_net)
from unseenobjectclustering_torch.utils import png
from unseenobjectclustering_torch.utils.evaluation import multilabel_metrics

REPO = os.path.dirname(os.path.abspath(__file__))
H, W, D, M = 480, 640, 64, 100
N = H * W
KAPPA, ITERS, EPS = 20.0, 10, 0.04
FRAMES = 3  # timed frames per mode, after one warm-up frame
CROP = 224  # stage 2's crop side (TRAIN.SYN_CROP_SIZE)
STAGE2_INSTANCES = (8, 16, 32)  # one frame per crop bucket
STAGE2_FRAMES = 2  # timed stage-2 frames per bucket, after one warm-up
# H100 SXM published peaks (dense): the bound of each kernel is the larger
# of its bytes over HBM bandwidth and its operations over the peak rate of
# its input type.  float32 work to fp32 accuracy runs fastest on the tensor
# cores as split TF32 (three TF32 products per fp32 product, as the hill
# climb does), so its least time is 3 * ops / 495 TFLOP/s, not ops over the
# 67 TFLOP/s of the CUDA cores.
TF32_PEAK_OPS = 495e12
PEAK_OPS = {torch.float32: TF32_PEAK_OPS / 3, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12
Z_TOL = {"parity": 1e-5, "fast": 1e-3}
SEED_GAP = 1e-6  # fast mode: a seed flip is allowed below this gap
NET = "seg_resnet34_8s_embedding"
INTR = (615.0, 615.0, W / 2.0, H / 2.0)  # the frames' pinhole camera
STREAM_FRAMES = 12  # frames submitted per mode by the 30 Hz producer
STREAM_HZ = 30.0
TRAIN_YML = ("experiments/cfgs/"
             "seg_resnet34_8s_embedding_cosine_rgbd_add_tabletop.yml")
CROP_YML = ("experiments/cfgs/"
            "seg_resnet34_8s_embedding_cosine_rgbd_add_crop_tabletop.yml")
TRAIN_SCENES = 16  # one batch of the recipe's IMS_PER_BATCH
DEV = "cuda"  # phase 6's training device
TIMED_STEPS = 3  # timed train steps per recipe, after one warm-up step
SMALL_HW = (128, 160)  # the card-vs-CPU train step's scenes (batch 2)
# card vs CPU, one float32 SGD step with TF32 off (convolutions sum in
# another order on the two devices): the loss; the gradient of all
# parameters as one vector and of each tensor, by relative L2 error (the
# median tensor's and the largest); the updated parameters (lr 1e-5 times
# the gradient's error) and the BatchNorm statistics.  The gradient limits
# lie about 4x above the sound step's readings and below those of two
# planted faults, TF32 left on and FAULT_TENSOR's gradient zeroed, on the
# H100 over three draw seeds (PERF.md, training findings): sound at most
# 9.6e-3 / 8.9e-3 / 1.8e-2 (vector / median tensor / largest tensor),
# TF32 at least 0.19 / 0.17 / 0.25, zeroed 0.19 / - / 1.0
STEP_TOL = {"loss_rtol": 1e-4, "grad_rel_l2": 4e-2,
            "grad_median_rel_l2": 4e-2, "grad_max_rel_l2": 0.15,
            "param_atol": 1e-6, "stat_atol": 1e-4, "stat_rtol": 1e-4}
FAULT_TENSOR = "fcn_depth.resnet34_8s.conv1.weight"
DATA_SCENES = 4  # phase 7: rendered scenes in each fixture tree
SYN_FRAMES = 2  # phase 7: synthetic_tabletop_test frames per mode
ALT_NETS = (("seg_unet_embedding", False), ("seg_vgg_embedding", True))
ALT_WINDOW = (64, 96)  # phase 8's card-vs-CPU frame (VGG pools 5 times)
ALT_TOL = 1e-4  # embeddings, card vs CPU (the CPU tests' flax tolerance)
DP_FRAMES = 4  # phase 9: frames of each segment_sharded call
DP_CALLS = 3  # phase 9: segment_sharded calls per mode (the first warms up)
DP_SMALL_BATCH = 4  # phase 9: the two-rank step at SMALL_HW, 2 + 2 frames
DP_TIMED_STEPS = 1  # phase 9: timed full-width DP steps, after a warm-up
SPATIAL_FRAMES = 2  # phase 9: timed spatial calls per network and mode
# phase 9: spatial embeddings against the one-process batch-1 stage 1 (the
# same terms summed in the order cuDNN picks for a band; bfloat16 rounds
# each layer's output, as the batch gap of 8.2e-3 did), and the U-Net's
# parity pixels relabelled at most, as a share of the frame
SPATIAL_TOL = {"parity": 1e-4, "fast": 2e-2}
SPATIAL_RELABEL = 1e-3
# phase 8b: the stage-1 recipe of RECIPE_YML (240x320, Adam 2e-4, batch 16,
# bf16), cut to TRAINED_SCENES rendered scenes and TRAINED_EPOCHS epochs of
# TRAINED_SCENES / 16 steps; the report on HELD_OUT test-split scenes
RECIPE_YML = "unseenobjectclustering_torch/cfgs/synthetic_240x320_rgbd_add.yml"
TH, TW = (int(Config.from_yaml(os.path.join(REPO, RECIPE_YML)).TRAIN[k])
          for k in ("SYN_HEIGHT", "SYN_WIDTH"))
TRAINED_SCENES = 256
TRAINED_EPOCHS = 50
HELD_OUT = 16
# the gates of the trained network on the HELD_OUT scenes (PERF.md,
# trained stage 1 findings): parity's mean Objects F at least
# TRAINED_FLOOR, fast's within FAST_GAP of parity's; the random-init
# network finds no instance, so it misses the floor.  On an NVIDIA H100
# 80GB HBM3 (700.00 W) the smoke reads 0.626 (parity; fast 0.634), the
# recipe's 375-step snapshot 0.260 and the random init 0.
TRAINED_FLOOR = 0.4
FAST_GAP = 0.05

KERNELS = {
    "select_seeds": ("unseenobjectclustering_torch/csrc/seeding.cu",
                     "unseenobjectclustering_tpu/ops/pallas_seeding.py:141"),
    "hill_climb": ("unseenobjectclustering_torch/csrc/mean_shift.cu",
                   "unseenobjectclustering_tpu/ops/pallas_mean_shift.py:116"),
    "connected_components": (
        "unseenobjectclustering_torch/csrc/mean_shift.cu",
        "unseenobjectclustering_tpu/ops/pallas_mean_shift.py:219"),
    "assign_labels": (
        "unseenobjectclustering_torch/csrc/mean_shift.cu",
        "unseenobjectclustering_tpu/ops/pallas_mean_shift.py:321"),
}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# a name that the profiler reports for each kernel's launches
KERNEL_NAMES = {"select_seeds": "select_seeds_kernel", "hill_climb": "hill_",
                "connected_components": "cc_kernel",
                "assign_labels": "assign_"}


def launch_counts() -> dict[str, int]:
    return {"select_seeds": cuda_seeding.launches,
            "hill_climb": cms.hill_climb_launches,
            "connected_components": cms.connected_components_launches,
            "assign_labels": cms.assign_labels_launches}


def reset_counts() -> None:
    cuda_seeding.launches = 0
    cms.hill_climb_launches = 0
    cms.connected_components_launches = 0
    cms.assign_labels_launches = 0


def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of fn() over reps runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, name: str, reps: int, tries: int = 3) -> float:
    """Device time per call of fn of the CUDA kernels whose name holds
    `name` (torch.profiler), after one warm-up call: the kernel's own time,
    without the host latency that time_ms includes.  Now and then the
    profiler returns a window without the kernel's device events (twice in
    seven runs of this script on the H100, both at the 0.01 ms
    connected-components kernel), so a window that shows none is profiled
    again, up to `tries` windows in all."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if name in e.key)
        if us > 0:
            return us / reps / 1e3
        print(f"device_ms: a profiler window without {name}'s device "
              "events; profiling again")
    raise AssertionError(f"the profiler saw no device time for {name} in "
                         f"{tries} windows")


def bound(nbytes: float, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clustered_embeddings(seed: int = 0, k: int = 12, n: int = N
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, D] unit embeddings around k centers (one large background
    cluster), and a [n] validity mask with one mostly-invalid cluster."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, D)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    prob = np.full(k, 1.0)
    prob[0] = 6.0
    assign = rng.choice(k, size=n, p=prob / prob.sum())
    x = centers[assign] + 0.3 * rng.randn(n, D) / np.sqrt(D)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    z_valid = rng.rand(n) > 0.05
    z_valid[assign == 3] = rng.rand(int((assign == 3).sum())) > 0.7
    return (torch.from_numpy(x.astype(np.float32)).cuda(),
            torch.from_numpy(z_valid).cuda())


def pairwise_far_seeds(seed: int = 1) -> torch.Tensor:
    """[M, D] random unit seeds, every pair far outside EPS (cosine
    distance about 0.5): each seed is its own cluster."""
    z = np.random.RandomState(seed).randn(M, D)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return torch.from_numpy(z.astype(np.float32)).cuda()


def merge_steps() -> int | None:
    """Merge steps of the last connected_components launch, where the
    kernel reports them."""
    steps = getattr(cms, "connected_components_steps", None)
    return None if steps is None else int(steps)


def seed_gap(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor
             ) -> tuple[int, float]:
    """First step where two seed sequences differ, and the plain route's
    min-distance gap there between its pick and the kernel's (-1, 0.0 when
    they agree)."""
    diff = (got != want).nonzero()
    if diff.numel() == 0:
        return -1, 0.0
    k = int(diff[0, 0])
    xf = x.float()
    md = torch.full((x.shape[0],), float("inf"), device=x.device)
    for j in want[:k].long():
        md = torch.minimum(md, 0.5 * (1.0 - xf @ xf[j]))
    return k, float(md[want[k].long()] - md[got[k].long()])


def check_kernels(mode: str, x32: torch.Tensor,
                  z_valid: torch.Tensor | None, where: str = ""
                  ) -> dict[str, dict]:
    """Phase 2 for one mode at x32's shape ([n, D]): every kernel against
    its plain version.  z_valid (the stage-1 depth mask) goes to the
    assignment when given; stage 2 has none."""
    dtype = torch.float32 if mode == "parity" else torch.bfloat16
    sub = 1 if mode == "parity" else int(FAST_CLUSTER["SEED_SUBSAMPLE"])
    x = x32.to(dtype)
    n = x.shape[0]
    x_seed = x[::sub]
    n_seed = x_seed.shape[0]
    first = 12345 % n_seed
    esize = x.element_size()
    out: dict[str, dict] = {}
    calls = {}  # each kernel's wrapper call, for its timings
    tag = mode + where  # the tag of this check's lines

    print(f"[{tag}] select_seeds launch (n = {n_seed}): "
          f"{json.dumps(cuda_seeding.launch_config(x_seed))}")
    print(f"[{tag}] hill_climb launch (n = {n}): "
          f"{json.dumps(cms.hill_climb_config(x, M))}")
    print(f"[{tag}] assign_labels launch (n = {n}): "
          f"{json.dumps(cms.assign_labels_config(x, M))}")
    got_s, got_i = cuda_seeding.select_seeds(x_seed, M, first)
    want_s, want_i = cuda_seeding.select_seeds_reference(x_seed, M, first)
    step, gap = seed_gap(x_seed, got_i, want_i)
    print(f"[{tag}] select_seeds: first differing step {step}, "
          f"min-distance gap there {gap:.3e}")
    if step >= 0 and not (mode == "fast" and gap < SEED_GAP):
        raise AssertionError(f"[{tag}] seeding differs at step {step} "
                             f"(gap {gap:.3e})")
    ops = 2.0 * (M - 1) * n_seed * D
    nbytes = n_seed * D * esize + M * (D * esize + 4)
    calls["select_seeds"] = lambda: cuda_seeding.select_seeds(x_seed, M,
                                                              first)
    out["select_seeds"] = dict(
        max_abs_err=float((got_s.float() - want_s.float()).abs().max())
        if step < 0 else float(gap),
        ms=time_ms(calls["select_seeds"], 10),
        plain_ms=time_ms(
            lambda: cuda_seeding.select_seeds_reference(x_seed, M, first), 3),
        bound=bound(nbytes, ops, dtype),
        rereads_ms=(M - 1) * n_seed * D * esize / HBM_BYTES_PER_S * 1e3)

    z0 = want_s.float()
    got_z = cms.hill_climb(x, z0, kappa=KAPPA, max_iters=ITERS)
    want_z = cms.hill_climb_reference(x, z0, kappa=KAPPA, max_iters=ITERS)
    err = float((got_z - want_z).abs().max())
    print(f"[{tag}] hill_climb: max |Z - Z_plain| = {err:.3e}")
    if not err <= Z_TOL[mode]:
        raise AssertionError(f"[{tag}] hill_climb error {err:.3e} > "
                             f"{Z_TOL[mode]}")
    ops = ITERS * 4.0 * M * n * D
    nbytes = n * D * esize + 2 * M * D * 4
    calls["hill_climb"] = lambda: cms.hill_climb(x, z0, kappa=KAPPA,
                                                 max_iters=ITERS)
    out["hill_climb"] = dict(
        max_abs_err=err,
        ms=time_ms(calls["hill_climb"], 10),
        plain_ms=time_ms(lambda: cms.hill_climb_reference(
            x, z0, kappa=KAPPA, max_iters=ITERS), 3),
        bound=bound(nbytes, ops, dtype))

    z, far = want_z, pairwise_far_seeds()
    cc = {}  # input -> (plain labels, merge steps)
    for name, zin in (("clustered", z), ("pairwise-far", far)):
        got_l = cms.connected_components(zin, EPS)
        steps = merge_steps()
        want_l = cms.connected_components_reference(zin, EPS)
        cc[name] = (want_l, steps)
        print(f"[{tag}] connected_components, {name} input: "
              f"{int(want_l.max()) + 1} clusters in {steps} merge steps, "
              f"equal={bool(torch.equal(got_l, want_l))}")
        if not torch.equal(got_l, want_l):
            raise AssertionError(f"[{tag}] connected components differ on "
                                 f"the {name} input")
    if int(cc["pairwise-far"][0].max()) + 1 != M:
        raise AssertionError(f"[{tag}] pairwise-far seeds were merged")
    calls["connected_components"] = lambda: cms.connected_components(z, EPS)
    far_call = functools.partial(cms.connected_components, far, EPS)
    out["connected_components"] = dict(
        max_abs_err=0.0,
        ms=time_ms(calls["connected_components"], 20),
        plain_ms=time_ms(lambda: cms.connected_components_reference(z, EPS),
                         3),
        bound=bound(M * D * 4 + M * 4, 2.0 * M * M * D, torch.float32),
        merge_steps=cc["clustered"][1], far_merge_steps=cc["pairwise-far"][1],
        far_ms=time_ms(far_call, 20),
        far_device_ms=device_ms(far_call, KERNEL_NAMES["connected_components"],
                                10))

    slab = cc["clustered"][0]
    got_a = cms.assign_labels(x, z, slab, z_valid=z_valid)
    rechecked = int(cms.assign_labels_rechecked)
    want_a = cms.assign_labels_reference(x, z, slab, z_valid=z_valid)
    for name, g, w in zip(("labels", "counts", "valid_counts"), got_a,
                          want_a):
        if not torch.equal(g, w):
            raise AssertionError(
                f"[{tag}] assign_labels {name} differ at "
                f"{int((g != w).sum())} entries")
    print(f"[{tag}] assign_labels: labels and both histograms equal; "
          f"{rechecked} pixels re-checked exactly")
    ops = 2.0 * M * n * D
    nbytes = (n * D * esize + n * (4 + (z_valid is not None))
              + M * (D * 4 + 4 + 8))
    calls["assign_labels"] = lambda: cms.assign_labels(x, z, slab,
                                                       z_valid=z_valid)
    out["assign_labels"] = dict(
        max_abs_err=0.0,
        ms=time_ms(calls["assign_labels"], 10),
        plain_ms=time_ms(lambda: cms.assign_labels_reference(
            x, z, slab, z_valid=z_valid), 3),
        bound=bound(nbytes, ops, dtype))
    for name, r in out.items():
        r["device_ms"] = device_ms(calls[name], KERNEL_NAMES[name], 10)
        print(f"[{tag}] {name}: kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})"
              + (f", X re-read every step {r['rereads_ms']:.4f} ms"
                 if "rereads_ms" in r else "")
              + (f"; pairwise-far input {r['far_ms']:.4f} ms (device "
                 f"{r['far_device_ms']:.4f} ms)" if "far_ms" in r else ""))
    return out


def check_route(mode: str, x32: torch.Tensor, z_valid: torch.Tensor
                ) -> dict[str, float]:
    """Phase 2, whole clustering: mean_shift_smart_init with the fused 0.8
    depth filter on the clustered embeddings (several clusters, one of them
    mostly without depth), kernel route against plain route: seeds and
    labels equal.  Returns both routes' median ms."""
    sub = 1 if mode == "parity" else int(FAST_CLUSTER["SEED_SUBSAMPLE"])
    kw = dict(kappa=KAPPA, num_seeds=M, max_iters=ITERS, epsilon=EPS,
              metric="cosine", first_index=777 % -(-N // sub),
              seed_subsample=sub,
              compute_dtype="float32" if mode == "parity" else "bfloat16",
              z_valid=z_valid, filter_threshold=0.8)
    got = mean_shift_smart_init(x32, use_pallas=True, **kw)
    rechecked = int(cms.assign_labels_rechecked)
    want = mean_shift_smart_init(x32, use_pallas=False, **kw)
    ids = torch.unique(want.labels)
    print(f"[{mode}] clustering, kernel route vs plain route: "
          f"{int(want.seed_labels.max()) + 1} seed clusters, {len(ids)} label "
          f"ids after the depth filter, {rechecked} pixels re-checked by the "
          f"assignment, "
          f"{int((got.labels != want.labels).sum())} pixels differ, max |Z - "
          f"Z_plain| {float((got.seeds - want.seeds).abs().max()):.3e}")
    for name in ("seed_indices", "seed_labels", "labels"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"[{mode}] clustering routes differ in "
                                 f"{name}")
    if len(ids) <= 2:
        raise AssertionError(f"[{mode}] the clustered input gave {len(ids)} "
                             "label ids")
    return dict(
        ms=time_ms(lambda: mean_shift_smart_init(x32, use_pallas=True, **kw),
                   5),
        plain_ms=time_ms(
            lambda: mean_shift_smart_init(x32, use_pallas=False, **kw), 2))


def tabletop_frame(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """A 480x640 table with boxes: BGR uint8 and depth in meters (0 where
    the sensor saw nothing)."""
    rng = np.random.RandomState(seed)
    bgr = np.empty((H, W, 3), np.float64)
    bgr[:] = (70, 95, 120)
    depth = np.tile(np.linspace(1.6, 0.9, H, dtype=np.float32)[:, None],
                    (1, W))
    for _ in range(8):
        h, w = rng.randint(H // 12, H // 4), rng.randint(W // 16, W // 5)
        y, x = rng.randint(H // 12, H - h), rng.randint(0, W - w)
        bgr[y:y + h, x:x + w] = rng.randint(0, 256, size=3)
        depth[y:y + h, x:x + w] = depth[y + h - 1, x] - rng.uniform(0.05, 0.3)
    bgr += rng.randn(H, W, 3) * 6.0
    depth[rng.rand(H, W) < 0.02] = 0.0
    return np.clip(bgr, 0, 255).astype(np.uint8), depth


def run_slice(cfg: Config, state_dict: dict, frame: dict
              ) -> tuple[dict, dict, torch.Tensor]:
    """Phase 3: both modes through Segmentor.segment_sample, each mode's
    counters reset just before its frames and read just after; every
    kernel must have launched in each mode."""
    segs = {"parity": Segmentor(cfg, state_dict),
            "fast": Segmentor(cfg.replace(CLUSTER=dict(FAST_CLUSTER)),
                              state_dict, model_dtype=torch.bfloat16)}
    timings: dict[str, dict] = {}
    counts: dict[str, dict] = {}
    features = None
    for mode, seg in segs.items():
        rows = []
        reset_counts()
        for i in range(1 + FRAMES):
            res = seg.segment_sample(frame, return_features=(i == 0))
            labels = res.labels
            if labels.shape != (1, H, W) or labels.dtype != np.int32:
                raise AssertionError(f"[{mode}] labels {labels.shape} "
                                     f"{labels.dtype}")
            if labels.min() < 0 or labels.max() > M:
                raise AssertionError(f"[{mode}] label ids out of range")
            if i == 0:
                f = res.features
                norms = np.linalg.norm(f, axis=-1)
                if (f.shape != (1, H, W, D) or not np.isfinite(f).all()
                        or np.abs(norms - 1.0).max() > 1e-3):
                    raise AssertionError(f"[{mode}] bad embeddings")
                if mode == "parity":
                    features = torch.from_numpy(f[0]).cuda()
                print(f"[{mode}] labels: {len(np.unique(labels))} ids, "
                      f"largest non-background "
                      f"{int(np.bincount(labels.ravel())[1:].max(initial=0))}"
                      " px")
            else:
                rows.append(res.timing)
        counts[mode] = launch_counts()
        print(f"[{mode}] main-path launches: {counts[mode]}; the last "
              f"frame's assignment re-checked "
              f"{int(cms.assign_labels_rechecked)} pixels")
        missing = [k for k, v in counts[mode].items() if v <= 0]
        if missing:
            raise AssertionError(f"[{mode}] kernels not launched on the main "
                                 f"path: {missing}")
        timings[mode] = {k: 1e3 * float(np.median([r[k] for r in rows]))
                         for k in ("network", "cluster", "stage1")}
        print(f"[{mode}] stage 1 ms/frame (median of {FRAMES}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in timings[mode].items()))
    return counts, timings, features


def check_against_cpu(cfg: Config, state_dict: dict, frame: dict) -> None:
    """Parity-mode stage 1 on the card against the same Segmentor on the CPU,
    on a 60x90 window of the frame (padded to 64x96 and cropped back):
    embeddings within 1e-4 (convolutions sum in another order on the two
    devices), labels equal."""
    window = {k: v[H // 2 - 30:H // 2 + 30, W // 2 - 45:W // 2 + 45]
              for k, v in frame.items()}
    card = Segmentor(cfg, state_dict).segment_sample(window,
                                                     return_features=True)
    cpu = Segmentor(cfg, state_dict, device="cpu").segment_sample(
        {k: v.cpu() for k, v in window.items()}, return_features=True)
    err = float(np.abs(card.features - cpu.features).max())
    n_diff = int((card.labels != cpu.labels).sum())
    print(f"[parity] card vs CPU on a 60x90 window: max |embedding diff| "
          f"{err:.3e}, {n_diff} pixels differ")
    if not err <= 1e-4 or n_diff:
        raise AssertionError("stage 1 on the card differs from the CPU")


def instance_frame(k: int, seed: int
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A 480x640 table with k boxes, one in each of k cells of a grid (no
    two overlap): BGR uint8, depth in meters (0 where the sensor saw
    nothing) and the boxes' label map (ids 1..k, 0 elsewhere)."""
    rng = np.random.RandomState(seed)
    cols = int(np.ceil(np.sqrt(k * W / H)))
    rows = -(-k // cols)
    ch, cw = H // rows, W // cols
    bgr = np.empty((H, W, 3), np.float64)
    bgr[:] = (70, 95, 120)
    depth = np.tile(np.linspace(1.6, 0.9, H, dtype=np.float32)[:, None],
                    (1, W))
    labels = np.zeros((H, W), np.int32)
    for i, cell in enumerate(rng.permutation(rows * cols)[:k]):
        h, w = rng.randint(ch // 3, ch - 4), rng.randint(cw // 3, cw - 4)
        y = (cell // cols) * ch + rng.randint(2, ch - h - 1)
        x = (cell % cols) * cw + rng.randint(2, cw - w - 1)
        bgr[y:y + h, x:x + w] = rng.randint(0, 256, size=3)
        depth[y:y + h, x:x + w] = depth[y + h - 1, x] - rng.uniform(0.05, 0.3)
        labels[y:y + h, x:x + w] = i + 1
    bgr += rng.randn(H, W, 3) * 6.0
    depth[rng.rand(H, W) < 0.02] = 0.0
    return np.clip(bgr, 0, 255).astype(np.uint8), depth, labels


def stage2_frames(cfg: Config) -> dict[int, tuple]:
    """Per instance count: (image, XYZ, labels) on the card and the labels
    on the host."""
    frames = {}
    for k in STAGE2_INSTANCES:
        bgr, depth, labels = instance_frame(k, seed=k)
        if len(np.unique(labels)) != k + 1:
            raise AssertionError(f"the {k}-box frame shows "
                                 f"{len(np.unique(labels)) - 1} boxes")
        img, xyz = preprocess_rgbd(torch.from_numpy(bgr).cuda(),
                                   torch.from_numpy(depth).cuda(),
                                   cfg.pixel_means, *INTR)
        frames[k] = (img, xyz, torch.from_numpy(labels).cuda(), labels)
    return frames


def refine(seg: Segmentor, frame: tuple, seed: int,
           timing: dict | None = None) -> np.ndarray:
    """Stage 2 of one frame (_stage2_impl, the fetch and the paste), with
    the frame's boxes as its stage-1 labels; checks the refined labels."""
    img, xyz, labels, labels_np = frame
    t0 = time.perf_counter()
    refined = seg._refine(img, labels, xyz, labels_np,
                          torch.Generator().manual_seed(seed),
                          has_depth=True, timing=timing)
    if timing is not None:
        timing["stage2"] = time.perf_counter() - t0
    if (refined.shape != (H, W) or refined.dtype != np.int32
            or refined.min() < 0):
        raise AssertionError(f"refined labels {refined.shape} "
                             f"{refined.dtype}")
    return refined


def profile_stage2(mode: str, seg: Segmentor, frame: tuple,
                   wall_ms: float) -> dict[str, float]:
    """One stage-2 frame under torch.profiler: the device's busy ms (the
    kernels' own times summed: one stream, so they do not overlap), its idle
    share against wall_ms (the median of the unprofiled frames: the
    profiler slows the host), and the kernels and host ops that take the
    most time."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        refine(seg, frame, seed=0)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    idle = 1.0 - busy / wall_ms
    print(f"[{mode}] stage 2 profile, {len(np.unique(frame[3])) - 1} "
          f"instances: device busy {busy:.3f} ms of {wall_ms:.3f} ms wall, "
          f"idle share {idle:.3f}")
    for key, label, rows in (("self_device_time_total", "device", kernels),
                             ("self_cpu_time_total", "host", events)):
        top = sorted(rows, key=lambda e: -getattr(e, key))[:8]
        print(f"[{mode}]   top {label}: " + "; ".join(
            f"{e.key[:48]} x{e.count} {getattr(e, key) / 1e3:.3f} ms"
            for e in top))
    return dict(device_busy_ms=busy, idle_share=idle)


def run_stage2(segs: dict[str, Segmentor], frames: dict[int, tuple]
               ) -> tuple[dict, dict, dict]:
    """Phase 4: stage 2 at full width in both modes, a frame per crop
    bucket.  Random-init stage-1 embeddings form one cluster, which the
    background swap turns into no instance, so the public path alone crops
    nothing: each frame's boxes are its stage-1 label map.  The counters
    are set to 0 before each mode's frames and read after; every kernel
    must launch exactly once per valid crop."""
    counts: dict[str, dict] = {}
    timings: dict[str, dict] = {}
    memory: dict[str, dict] = {}
    for mode, seg in segs.items():
        reset_counts()
        crops = 0
        timings[mode], memory[mode] = {}, {}
        for k, frame in frames.items():
            torch.cuda.reset_peak_memory_stats()
            rows = []
            for i in range(1 + STAGE2_FRAMES):
                timing: dict[str, float] = {}
                refine(seg, frame, seed=i, timing=timing)
                crops += k  # every box is a valid crop
                if i:
                    rows.append(timing)
            ms = {key[len("stage2_"):] if key != "stage2" else "total":
                  1e3 * float(np.median([r[key] for r in rows]))
                  for key in rows[0]}
            timings[mode][k] = ms
            memory[mode][k] = torch.cuda.max_memory_allocated() / 2 ** 30
            bucket = next(b for b in seg._buckets if b >= k)
            print(f"[{mode}] stage 2, {k} instances (bucket {bucket}) ms "
                  f"(median of {STAGE2_FRAMES}): "
                  + ", ".join(f"{key} {v:.3f}" for key, v in ms.items())
                  + f"; peak device memory {memory[mode][k]:.2f} GiB")
        counts[mode] = launch_counts()
        print(f"[{mode}] stage-2 launches for {crops} valid crops: "
              f"{counts[mode]}")
        wrong = {name: v for name, v in counts[mode].items() if v != crops}
        if wrong:
            raise AssertionError(f"[{mode}] stage 2 launched {wrong}, not "
                                 f"once per valid crop ({crops})")
        k = max(frames)
        timings[mode]["profile"] = profile_stage2(
            mode, seg, frames[k], timings[mode][k]["total"])
    return counts, timings, memory


def check_stage2(segs: dict[str, Segmentor], frames: dict[int, tuple],
                 state_dict_crop: dict, cfg: Config, frame: dict
                 ) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """Phase 4 checks: in parity the kernel route's refined labels equal
    the plain route's on the same crops; one crop's embeddings on the card
    are within 1e-4 of the CPU's; segment_sample(refine=True) runs through
    the public path in both modes.  Returns each box frame's parity refined
    labels of the kernel and the plain route."""
    seg = segs["parity"]
    kernel_kw = seg._ms_kw
    routes = {}
    for k, fr in frames.items():
        got = refine(seg, fr, seed=7)
        seg._ms_kw = dict(kernel_kw, use_pallas=False)
        want = refine(seg, fr, seed=7)
        seg._ms_kw = kernel_kw
        n_diff = int((got != want).sum())
        print(f"[parity] stage 2, {k} instances, kernel route vs plain "
              f"route: {len(np.unique(want)) - 1} refined instances, "
              f"{n_diff} pixels differ")
        if n_diff:
            raise AssertionError("stage 2's kernel route differs from its "
                                 "plain route")
        routes[k] = (got, want)

    img, xyz, labels, _ = frames[STAGE2_INSTANCES[0]]
    crops = crop_rois(img, _dense_relabel(labels, max_id=M), xyz,
                      max_instances=STAGE2_INSTANCES[0], crop_size=CROP)
    rgb, dep = crops.rgb_crops[:1], crops.depth_crops[:1]
    cpu = get_network("seg_resnet34_8s_embedding", cfg)
    cpu.load_state_dict(state_dict_crop, strict=True)
    with torch.inference_mode():
        on_card = seg.model_crop(rgb, dep).cpu()
        on_cpu = cpu.eval()(rgb.cpu(), dep.cpu())
    err = float((on_card - on_cpu).abs().max())
    print(f"[parity] one {CROP}x{CROP} crop's embeddings, card vs CPU: "
          f"max |diff| {err:.3e}")
    if not err <= 1e-4:
        raise AssertionError("the crop network on the card differs from the "
                             "CPU")

    for mode, seg in segs.items():
        res = seg.segment_sample(frame, refine=True)
        refined = res.labels_refined
        if (refined is None or refined.shape != (1, H, W)
                or refined.dtype != np.int32 or "stage2" not in res.timing):
            raise AssertionError(f"[{mode}] segment_sample(refine=True)")
        print(f"[{mode}] segment_sample(refine=True): "
              f"{len(np.unique(res.labels)) - 1} stage-1 instances, "
              f"{len(np.unique(refined)) - 1} refined; stage 2 "
              f"{1e3 * res.timing['stage2']:.3f} ms")
    return routes


def host_frame(cfg: Config, bgr: np.ndarray, depth: np.ndarray,
               intr: tuple | None = None) -> tuple[np.ndarray, np.ndarray]:
    """[H, W, 3] normalized image and XYZ (camera intr, else INTR) built on
    the host in numpy, as a dataset and the CLIs build them."""
    return (bgr.astype(np.float32) / 255.0 - cfg.pixel_means / 255.0,
            compute_xyz_np(depth, *(intr or INTR)))


def load_segmentors(cfg: Config, tmp: str, states: dict[str, dict]
                    ) -> tuple[dict[str, Segmentor], dict[str, str]]:
    """Phase 5: the main and crop networks' state dicts saved as
    reference-layout .pth files wrapped as a DataParallel training snapshot
    ({'model': {'module.' + key: ...}}), then both modes' Segmentors built
    from the files by build_segmentor on the card; every loaded tensor must
    equal the saved one (the fast mode's convolutions: its bfloat16
    rounding)."""
    paths = {}
    for name, state in states.items():
        paths[name] = os.path.join(tmp, f"{name}.pth")
        torch.save({"model": {"module." + k: v for k, v in state.items()}},
                   paths[name])
    segs = {"parity": build_segmentor(cfg, NET, pretrained=paths["main"],
                                      pretrained_crop=paths["crop"]),
            "fast": build_segmentor(cfg.replace(CLUSTER=dict(FAST_CLUSTER)),
                                    NET, pretrained=paths["main"],
                                    pretrained_crop=paths["crop"],
                                    model_dtype=torch.bfloat16)}
    for mode, seg in segs.items():
        for model, name in ((seg.model, "main"), (seg.model_crop, "crop")):
            got, want = model.state_dict(), states[name]
            bad = [k for k in want if k not in got or not torch.equal(
                got[k].cpu(), want[k].to(got[k].dtype))]
            if bad or len(got) != len(want):
                raise AssertionError(f"[{mode}] {name} network loaded from "
                                     f".pth differs at {bad[:3]}")
        print(f"[{mode}] build_segmentor from {os.path.basename(paths['main'])}"
              f" and {os.path.basename(paths['crop'])} on "
              f"{seg.device}: {len(states['main'])} tensors per network "
              f"equal to the saved ones")
    return segs, paths


def check_stream_frame(mode: str, seg: Segmentor) -> None:
    """Phase 5: one frame through StreamSegmentor.submit + process_latest:
    its preprocessing on the card gives the host numpy path's bits, and its
    labels equal Segmentor.segment's on the host-preprocessed frame, the
    Segmentor's generator seeded alike."""
    bgr, depth = tabletop_frame(seed=5)
    image, xyz = host_frame(seg.cfg, bgr, depth)
    on_card = (normalize_bgr(torch.from_numpy(bgr).cuda(),
                             seg.cfg.pixel_means).cpu().numpy(),
               compute_xyz(torch.from_numpy(depth).cuda(), *INTR).cpu().numpy())
    if not (np.array_equal(on_card[0], image)
            and np.array_equal(on_card[1], xyz)):
        raise AssertionError("preprocessing on the card differs from the "
                             "host's: max |diff| image "
                             f"{np.abs(on_card[0] - image).max():.3e}, xyz "
                             f"{np.abs(on_card[1] - xyz).max():.3e}")
    stream = StreamSegmentor(seg.cfg, seg)
    seg._generator.manual_seed(11)
    stream.submit(bgr, depth, INTR, stamp="parity-check")
    got = stream.process_latest(refine=True)
    seg._generator.manual_seed(11)
    want = seg.segment(image[None], xyz[None], refine=True)
    if (got.stamp != "parity-check"
            or not np.array_equal(got.labels, want.labels[0])
            or not np.array_equal(got.labels_refined,
                                  want.labels_refined[0])):
        raise AssertionError(f"[{mode}] the stream's labels differ from "
                             "segment's on the host-preprocessed frame")
    print(f"[{mode}] stream frame: preprocessing on "
          f"the card bit-equal to the host's; labels equal to segment's "
          f"({len(np.unique(got.labels)) - 1} stage-1 instances)")


def run_stream(mode: str, seg: Segmentor) -> dict:
    """Phase 5: a producer thread submits STREAM_FRAMES 480x640 frames at
    STREAM_HZ while run_forever serves them with refine on, until the
    producer is done and the buffer is empty.  The counters are set to 0
    just before and read just after; every kernel must launch at least
    once per served frame."""
    frames = [tabletop_frame(seed=100 + i) for i in range(STREAM_FRAMES)]
    stream = StreamSegmentor(seg.cfg, seg)
    done = threading.Event()
    served: list = []

    def produce() -> None:
        try:
            t0 = time.perf_counter()
            for i, (bgr, depth) in enumerate(frames):
                time.sleep(max(0.0, t0 + i / STREAM_HZ - time.perf_counter()))
                stream.submit(bgr, depth, INTR, stamp=i)
        finally:
            done.set()

    producer = threading.Thread(target=produce)
    reset_counts()
    t0 = time.perf_counter()
    producer.start()
    stream.run_forever(served.append, refine=True,
                       should_stop=lambda: done.is_set() and not stream.pending)
    wall = time.perf_counter() - t0
    producer.join()
    counts = launch_counts()
    stamps = [r.stamp for r in served]
    if (not served or stamps != sorted(set(stamps))
            or stamps[-1] != STREAM_FRAMES - 1
            or any(r.labels.shape != (H, W) or r.labels_refined is None
                   for r in served)):
        raise AssertionError(f"[{mode}] the stream served {stamps}")
    short = {k: v for k, v in counts.items() if v < len(served)}
    if short:
        raise AssertionError(f"[{mode}] kernels launched fewer times than "
                             f"the {len(served)} served frames: {short}")
    lat = np.array([1e3 * r.latency_s for r in served])
    out = dict(submitted=STREAM_FRAMES, served=len(served),
               dropped=STREAM_FRAMES - len(served),
               latency_ms_median=float(np.median(lat)),
               latency_ms_p90=float(np.percentile(lat, 90)),
               wall_s=wall, launches=counts)
    print(f"[{mode}] stream at {STREAM_HZ:g} Hz, refine on: "
          f"{out['submitted']} submitted, {out['served']} served, "
          f"{out['dropped']} dropped in {wall:.2f} s; latency median "
          f"{out['latency_ms_median']:.3f} ms, p90 "
          f"{out['latency_ms_p90']:.3f} ms; launches {counts}")
    return out


class Recorder:
    """A Segmentor's segment, keeping what it returned."""

    def __init__(self, seg: Segmentor):
        self.seg, self.cfg, self.results = seg, seg.cfg, []

    def segment(self, *args, **kwargs):
        self.results.append(self.seg.segment(*args, **kwargs))
        return self.results[-1]


def run_evaluation(mode: str, seg: Segmentor, tmp: str) -> dict:
    """Phase 5: evaluate_dataset over the 8/16/32-box frames (GT = the
    boxes), the .mat files re-read equal to the labels segment returned."""
    samples = []
    for k in STAGE2_INSTANCES:
        bgr, depth, labels = instance_frame(k, seed=k)
        image, xyz = host_frame(seg.cfg, bgr, depth)
        samples.append({"image_color": image, "depth": xyz, "label": labels,
                        "filename": f"boxes{k}"})
    rec = Recorder(seg)
    out = os.path.join(tmp, f"eval_{mode}")
    print(f"[{mode}] evaluate_dataset over the {STAGE2_INSTANCES}-box frames:")
    stage1, refined = evaluate_dataset(samples, rec, output_dir=out)
    for i, res in enumerate(rec.results):
        mat = scipy.io.loadmat(os.path.join(out, "%06d.mat" % i))
        want_ref = (res.labels if res.labels_refined is None
                    else res.labels_refined)
        if not (np.array_equal(mat["labels"], res.labels[0])
                and np.array_equal(mat["labels_refined"], want_ref[0])):
            raise AssertionError(f"[{mode}] {i:06d}.mat differs from the "
                                 "returned labels")
    found = [len(np.unique(r.labels)) - 1 for r in rec.results]
    print(f"[{mode}] the .mat files equal the returned labels; stage-1 "
          f"instances per frame {found}"
          + ("; random-init stage 1 embeds each frame as one cluster, so "
             "the tables are the reference's empty-prediction edge case "
             "(F 0, P 1, R 0)" if not any(found) else ""))
    return {"stage1": stage1, "refined": refined, "stage1_instances": found}


def box_frame_metrics(routes: dict, segs: dict[str, Segmentor],
                      frames: dict[int, tuple]) -> dict:
    """Phase 5: multilabel_metrics on phase 4's refined labels of the box
    frames against their boxes: in parity the kernel route's dicts equal
    the plain route's; the fast route's F beside parity's (no gate: there
    are no trained weights)."""
    out = {}
    for k, (got, want) in routes.items():
        gt = frames[k][3]
        metrics = multilabel_metrics(got, gt)
        if metrics != multilabel_metrics(want, gt):
            raise AssertionError("the kernel route's metrics differ from the "
                                 "plain route's")
        fast = multilabel_metrics(refine(segs["fast"], frames[k], seed=7), gt)
        out[k] = {mode: {key: m[key] for key in (
            "Objects F-measure", "Boundary F-measure", "obj_detected")}
            for mode, m in (("parity", metrics), ("fast", fast))}
        print(f"[box frames] {k} boxes, refined: parity Objects F "
              f"{metrics['Objects F-measure']:.6f}, Boundary F "
              f"{metrics['Boundary F-measure']:.6f} (kernel route = plain "
              f"route); fast {fast['Objects F-measure']:.6f} / "
              f"{fast['Boundary F-measure']:.6f}")
    return out


def run_cli(tmp: str, pretrained: str, seg: Segmentor) -> dict:
    """Phase 5: tools.test_npy.main() on a plain (uint16 mm) and a
    debug_info (meters, 3x3 intrinsics) dump; its -label.npy files must be
    480x640 and equal Segmentor.segment's labels on the same inputs from a
    Segmentor built from the same file with its generator at the seed a new
    one starts from."""
    d = os.path.join(tmp, "npy")
    os.makedirs(d)
    bgr, depth = tabletop_frame(seed=7)
    np.save(os.path.join(d, "a_plain.npy"),
            {"rgb": bgr, "depth": np.round(depth * 1000).astype(np.uint16)})
    bgr, depth, _ = instance_frame(16, seed=3)
    k = np.array([[INTR[0], 0, INTR[2]], [0, INTR[1], INTR[3]], [0, 0, 1]])
    np.save(os.path.join(d, "b_debug.npy"), {"debug_info": {
        "rgb": bgr, "depth_image": depth, "intrinsics": k}})
    test_npy.main(["--imgdir", d, "--pretrained", pretrained])
    seg._generator.manual_seed(3)  # Segmentor's default seed
    out = {}
    for name in ("a_plain", "b_debug"):
        rgb, depth_m, intr = test_npy.read_npy_sample(
            os.path.join(d, name + ".npy"))
        image, xyz = host_frame(seg.cfg, rgb, depth_m, intr)
        want = seg.segment(image[None], xyz[None], refine=False).labels[0]
        got = np.load(os.path.join(d, name + "-label.npy"))
        if got.shape != (H, W) or not np.array_equal(got, want):
            raise AssertionError(f"tools.test_npy's {name} labels differ")
        out[name] = int(len(np.unique(got)) - 1)
    print(f"tools.test_npy: -label.npy of both dump flavours equal "
          f"segment's; objects {out}")
    return out


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

_RENDER_RE = re.compile(r"done: (\d+) rendered, \d+ already cached, "
                        r"([\d.]+) s on (\d+) processes, ([\d.]+) s/scene")


def render_scenes(cache: str, split: str = "train",
                  num: int = TRAIN_SCENES) -> dict:
    """`num` scenes of `split` at H x W, rendered by tools.render_dataset in
    a process of its own (numpy only) on a pool of spawned processes, one
    per CPU core."""
    return render_splits(cache, {split: num}, (H, W))[split]


def render_splits(cache: str, nums: dict[str, int], hw: tuple) -> dict:
    """render_scenes for each split of `nums` (split -> scenes), the
    tools.render_dataset processes started together."""
    h, w = hw
    procs = {split: subprocess.Popen(
        [sys.executable, "-m", "unseenobjectclustering_torch.tools."
         "render_dataset", "--cache-dir", cache, "--split", split,
         "--height", str(h), "--width", str(w), "--num", str(num)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for split, num in nums.items()}
    outs = {}
    try:
        for split, proc in procs.items():
            outs[split] = proc.communicate(timeout=600)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    res = {}
    for split, num in nums.items():
        stdout, stderr = outs[split]
        m = _RENDER_RE.search(stdout)
        if procs[split].returncode or m is None or int(m.group(1)) != num:
            raise AssertionError(f"render_dataset --split {split}: "
                                 f"{stdout[-500:]}{stderr[-2000:]}")
        wall, workers, per = (float(m.group(2)), int(m.group(3)),
                              float(m.group(4)))
        res[split] = dict(scenes=num, processes=workers, wall_s=wall,
                          s_per_scene=per, wall_s_per_scene=wall / num)
        print(f"[{split}] rendered {num} scenes at {h}x{w} in "
              f"{wall:.2f} s with {workers} processes: {per:.3f} s/scene "
              f"in one process, {res[split]['wall_s_per_scene']:.3f} "
              f"s/scene of wall")
    return res


_LOG_RE = re.compile(r"loss ([-\d.]+), loss intra: ([-\d.]+), loss_inter "
                     r"([-\d.]+)")


def run_train_net(tag: str, args: list[str]) -> tuple[object, list[dict]]:
    """tools.train_net.main(args): its final train state, and each step's
    loss, intra and inter from the step callback (unrounded, read after
    the run: the callback does not wait for the card) and its ms (CUDA
    events recorded by consecutive callbacks; None for the first); the
    steps the CLI logs (every LOG_EVERY-th of an epoch: all of them where
    an epoch is one step) are read back as the user sees them and
    printed."""
    steps: list[dict] = []

    def callback(epoch, i, metrics):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        steps.append({"epoch": epoch, "i": i, "event": event, **{
            k: v.detach() if torch.is_tensor(v) else v
            for k, v in metrics.items()}})

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = train_net.main(args, callback=callback)
    torch.cuda.synchronize()
    last = None
    for row in steps:
        event = row.pop("event")
        row["ms"] = None if last is None else last.elapsed_time(event)
        last = event
        row.update({k: float(v) for k, v in row.items()
                    if k not in ("epoch", "i", "ms")})
    logged = _LOG_RE.findall(buf.getvalue())
    shown = [row for row in steps if row["i"] % LOG_EVERY == 0]
    if len(logged) != len(shown):
        raise AssertionError(f"[{tag}] {len(logged)} log lines for "
                             f"{len(shown)} logged steps")
    for row in shown:
        print(f"[{tag}] epoch {row['epoch']} step {row['i']}: loss "
              f"{row['loss']:.6f}, intra {row['intra']:.6f}, inter "
              f"{row['inter']:.6f}")
    if not all(np.isfinite(row[k]) for row in steps
               for k in ("loss", "intra", "inter")):
        raise AssertionError(f"[{tag}] a non-finite loss")
    return state, steps


def train_args(cache: str, out: str, *extra: str, yml: str | None = None,
               scenes: int = TRAIN_SCENES) -> list[str]:
    return ["--cfg", yml or TRAIN_YML, "--network", NET, "--solver", "adam",
            "--device-resident", "--render-cache", cache, "--resident-limit",
            str(scenes), "--batch_size", str(TRAIN_SCENES),
            "--output-dir", out, "--workers", "0", "--device", DEV
            ] + list(extra)


def same_state(a, b) -> list[str]:
    """Names of the tensors (parameters, buffers, optimizer state) in which
    two train states differ."""
    bad = [k for k, v in a.model.state_dict().items()
           if not torch.equal(v, b.model.state_dict()[k])]
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, per in sa["state"].items():
        bad += [f"optimizer {i} {n}" for n, v in per.items()
                if not torch.equal(v, sb["state"][i][n])]
    if a.step != b.step:
        bad.append("step")
    return bad


def time_recipe(tag: str, yml: str, scenes, model_dtype=None) -> dict:
    """A recipe's train step, resident, outside the CLI: TIMED_STEPS steps
    after a warm-up, each split by CUDA events into gather+augmentation,
    forward+backward and optimizer; the peak device memory over them; one
    more step under torch.profiler for the device's busy time and idle
    share (against the median unprofiled step)."""
    cfg = Config.from_yaml(yml).replace(MODE="TRAIN")
    crop = bool(cfg.TRAIN.SYN_CROP)
    state = create_train_state(cfg, network_name=NET, solver="adam",
                               model_dtype=model_dtype, device=DEV)
    f = 0.5 * W
    step = make_train_step_resident(cfg, fx=f, fy=f, px=W / 2.0, py=H / 2.0)
    idx = torch.arange(TRAIN_SCENES, device=DEV)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    for i in range(1 + TIMED_STEPS):
        events = {"start": torch.cuda.Event(enable_timing=True)}

        def mark(name):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()

        gen = torch.Generator(device=DEV).manual_seed(step_seed(3, 0, i))
        events["start"].record()
        _, metrics = step(state, *scenes, idx, gen=gen, mark=mark)
        torch.cuda.synchronize()
        if not torch.isfinite(metrics["loss"]):
            raise AssertionError(f"[{tag}] non-finite loss")
        ms = {"augment": events["start"].elapsed_time(events["augment"]),
              "forward_backward": events["augment"].elapsed_time(
                  events["forward_backward"]),
              "optimizer": events["forward_backward"].elapsed_time(
                  events["optimizer"])}
        ms["step"] = sum(ms.values())
        rows.append(ms)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    timed = rows[1:]
    split = {k: float(np.median([r[k] for r in timed])) for k in rows[0]}
    gen = torch.Generator(device=DEV).manual_seed(7)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, *scenes, idx, gen=gen)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy <= 0:
        raise AssertionError(f"[{tag}] the profiler saw no device time")
    idle = 1.0 - busy / split["step"]
    n_img = TRAIN_SCENES
    out = dict(s_per_step=split["step"] / 1e3,
               scenes_per_s=n_img / (split["step"] / 1e3),
               step_ms=[r["step"] for r in rows], split_ms=split,
               peak_gib=peak, resident_and_model_gib=base / 2 ** 30,
               device_busy_ms=busy, idle_share=idle,
               shape=[n_img] + ([int(cfg.TRAIN.SYN_CROP_SIZE)] * 2 if crop
                                else [H, W]))
    print(f"[{tag}] train step (median of {TIMED_STEPS} after a warm-up): "
          f"{split['step']:.1f} ms = gather+augmentation "
          f"{split['augment']:.1f} + forward+backward "
          f"{split['forward_backward']:.1f} + optimizer "
          f"{split['optimizer']:.1f}; {out['scenes_per_s']:.1f} scenes/s; "
          f"peak {peak:.2f} GiB; profiled step: device busy {busy:.1f} ms, "
          f"idle share {idle:.3f}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    print(f"[{tag}]   top device: " + "; ".join(
        f"{e.key[:40]} x{e.count} {e.self_device_time_total / 1e3:.1f} ms"
        for e in top))
    del state
    torch.cuda.empty_cache()
    return out


def grad_errors(g: dict, ref: dict) -> dict:
    """Gradients `g` against `ref` (name -> tensor): the relative L2 error
    of all of them as one vector, and each tensor's own relative L2 error
    (the median over the tensors, the largest and its tensor)."""
    diff = {k: float((g[k].double() - ref[k].double()).norm()) for k in ref}
    norm = {k: float(ref[k].double().norm()) for k in ref}
    per = {k: diff[k] / max(norm[k], 1e-300) for k in ref}
    worst = max(per, key=per.get)
    return dict(rel_l2=math.hypot(*diff.values()) / math.hypot(*norm.values()),
                median_rel_l2=float(np.median(list(per.values()))),
                max_rel_l2=per[worst], worst=worst)


def step_against(run: tuple, ref: tuple, g64: dict | None = None) -> dict:
    """A card step `run` (loss, gradients, state after the update) against
    the reference step `ref` (the CPU's; phase 9: one process's): its
    errors (vs_cpu: against ref) and the STEP_TOL limits it breaks."""
    loss, grads, state = run
    l_ref, g_ref, s_ref = ref
    row = dict(loss=loss, loss_rel=abs(loss - l_ref) / abs(l_ref),
               vs_cpu=grad_errors(grads, g_ref),
               vs_fp64=None if g64 is None else grad_errors(grads, g64),
               param_max_abs=max(float((state[k] - s_ref[k]).abs().max())
                                 for k in s_ref if "running_" not in k
                                 and "num_batches" not in k),
               stat_max_abs=max(float((state[k] - s_ref[k]).abs().max())
                                for k in s_ref if "running_" in k))
    value = {"loss_rtol": row["loss_rel"],
             "grad_rel_l2": row["vs_cpu"]["rel_l2"],
             "grad_median_rel_l2": row["vs_cpu"]["median_rel_l2"],
             "grad_max_rel_l2": row["vs_cpu"]["max_rel_l2"],
             "param_atol": row["param_max_abs"]}
    row["breaks"] = [k for k, v in value.items() if v > STEP_TOL[k]]
    if not all(torch.allclose(state[k], s_ref[k], rtol=STEP_TOL["stat_rtol"],
                              atol=STEP_TOL["stat_atol"])
               for k in s_ref if "running_" in k):
        row["breaks"].append("stat")
    return row


def _grad_line(e: dict) -> str:
    return (f"gradient relative L2 {e['rel_l2']:.2e}, per tensor median "
            f"{e['median_rel_l2']:.2e}, largest {e['max_rel_l2']:.2e} "
            f"({e['worst']})")


def small_step_inputs(n: int, draw_seed: int = 7) -> tuple:
    """The inputs of one float32 SGD step of the stage-1 recipe at
    SMALL_HW: the config, the dataset, n rendered scenes (CPU tensors),
    the initial weights (a fixed-seed init), the raw step and the batch's
    augmentation draws (drawn on the CPU)."""
    cfg = Config.from_yaml(TRAIN_YML).replace(MODE="TRAIN")
    h, w = SMALL_HW
    ds = SyntheticTabletopDataset(
        "train", Config.from_dict({"INPUT": "RGBD", "MODE": "TRAIN"}),
        height=h, width=w, size=n)
    bgr, depth, label = (torch.from_numpy(np.stack(a)) for a in zip(
        *[ds.get_scene(i) for i in range(n)]))
    depth = depth.to(torch.int32)
    torch.manual_seed(3)
    init = get_network(NET, cfg).state_dict()
    step = make_train_step_raw(cfg, fx=ds.f, fy=ds.f, px=ds.cx, py=ds.cy)
    draws = step.draw(torch.Generator().manual_seed(draw_seed), bgr)
    return cfg, ds, bgr, depth, label, init, step, draws


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def small_step(cfg, init, step, scenes, draws, dev, mesh=None) -> tuple:
    """One SGD step from `init` on `dev` (with a mesh: this rank's rows of
    the scenes, the global batch's draws): (loss, gradients, state), on
    the host."""
    rows = slice(None) if mesh is None else mesh.batch_slice(len(scenes[0]))
    state = create_train_state(cfg, network_name=NET, solver="sgd",
                               state_dict=init, device=dev)
    _, metrics = step(state, *(t[rows].to(dev) for t in scenes),
                      draws=_to(draws, dev), mesh=mesh)
    return (float(metrics["loss"]),
            {k: p.grad.detach().cpu() for k, p in
             state.model.named_parameters()},
            {k: v.detach().cpu() for k, v in
             state.model.state_dict().items()})


def check_step_against_cpu(draw_seed: int = 7) -> dict:
    """One float32 SGD step of the stage-1 recipe at 128x160, batch 2, on
    the card and on the CPU, from the same weights and the same pinned
    augmentation draws (drawn on the CPU): loss, gradients (as one vector
    and tensor by tensor), updated parameters and BatchNorm statistics
    within STEP_TOL.  Two faults must break it: the card's step with TF32
    left on, and the card's gradients with one tensor's zeroed.  For
    scale, every gradient against the same step's in float64."""
    cfg, ds, bgr, depth, label, init, step, draws = small_step_inputs(
        2, draw_seed)
    h, w = SMALL_HW

    def run(dev):
        return small_step(cfg, init, step, (bgr, depth, label), draws, dev)

    cpu = run("cpu")
    card = run(DEV)
    # fault 1: the step without the _full_fp32 rule, TF32 on
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        with mock.patch.object(train_engine, "_full_fp32",
                               contextlib.nullcontext):
            tf32 = run(DEV)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
    # fault 2: one small tensor's gradient lost (the depth tower's conv1)
    zeroed = dict(card[1])
    zeroed[FAULT_TENSOR] = torch.zeros_like(zeroed[FAULT_TENSOR])

    state64 = create_train_state(cfg, network_name=NET, solver="sgd",
                                 state_dict=init, device="cpu")
    state64.model.double()
    _, apply = make_device_augment(cfg, fx=ds.f, fy=ds.f, px=ds.cx,
                                   py=ds.cy)
    img, xyz, lab = apply(bgr, depth, label, draws)
    _, m64 = make_train_step(cfg)(state64, img.double(), xyz.double(), lab)
    if m64["loss"].dtype != torch.float64:
        raise AssertionError("the float64 witness left float64")
    g64 = {k: p.grad for k, p in state64.model.named_parameters()}

    res = dict(draw_seed=draw_seed, loss_cpu=cpu[0],
               loss_fp64=float(m64["loss"]), tol=STEP_TOL,
               fault_tensor=FAULT_TENSOR,
               cpu_vs_fp64=grad_errors(cpu[1], g64))
    head = f"[train] step at {h}x{w}, batch 2, draws {draw_seed}:"
    print(f"{head} the CPU's float32 step vs a float64 step: "
          f"{_grad_line(res['cpu_vs_fp64'])}")
    runs = {"card": card, "card_tf32": tf32,
            "card_zeroed_grad": (card[0], zeroed, card[2])}
    for name, run_ in runs.items():
        row = res[name] = step_against(run_, cpu, g64)
        print(f"{head} {name} vs the CPU: {_grad_line(row['vs_cpu'])}; "
              f"loss {row['loss']:.7f} vs {cpu[0]:.7f}; vs float64 "
              f"{row['vs_fp64']['rel_l2']:.2e} / "
              f"{row['vs_fp64']['median_rel_l2']:.2e}; parameters "
              f"{row['param_max_abs']:.2e}; BatchNorm statistics "
              f"{row['stat_max_abs']:.2e}; breaks {row['breaks']}")
    if res["card"]["breaks"]:
        raise AssertionError(f"the card's train step differs from the "
                             f"CPU's beyond {STEP_TOL}: "
                             f"{res['card']['breaks']}")
    if not res["card_tf32"]["breaks"] or not res["card_zeroed_grad"][
            "breaks"]:
        raise AssertionError("the card-vs-CPU step check misses a planted "
                             "fault (TF32 on, or a zeroed gradient)")
    return res


def serve_snapshot(snapshot_dir: str, state, scenes) -> dict:
    """A Segmentor built by build_segmentor from the trainer's snapshot
    directory: every tensor equal to the trainer's; one cached scene
    segmented."""
    cfg = Config.from_yaml(TRAIN_YML).replace(MODE="TEST")
    seg = build_segmentor(cfg, NET, pretrained=snapshot_dir, device=DEV)
    want = state.model.state_dict()
    got = seg.model.state_dict()
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    if bad or len(got) != len(want):
        raise AssertionError(f"the served network differs from the "
                             f"trainer's at {bad[:3]}")
    f = 0.5 * W
    img, xyz = preprocess_rgbd(scenes[0][0], scenes[1][0].float() / 1000.0,
                               cfg.pixel_means, f, f, W / 2.0, H / 2.0)
    res = seg.segment(img[None], xyz[None], return_features=True)
    if (res.labels.shape != (1, H, W)
            or not np.isfinite(res.features).all()):
        raise AssertionError("bad segmentation from the snapshot")
    k = len(np.unique(res.labels)) - 1
    print(f"[train] Segmentor from {snapshot_dir}: {len(want)} tensors "
          f"equal to the trainer's; one cached scene segmented into {k} "
          f"instances")
    return dict(tensors=len(want), instances=k)


def run_training(tmp: str) -> dict:
    """Phase 6."""
    t0 = time.perf_counter()
    cache = os.path.join(tmp, "render_cache")
    render = render_scenes(cache)
    reset_counts()
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic
    cudnn.deterministic = True
    try:
        resumed_dir = os.path.join(tmp, "resumed")
        _, steps = run_train_net("fp32", train_args(cache, resumed_dir,
                                                    "--epochs", "2"))
        resumed, more = run_train_net("fp32 resume", train_args(
            cache, resumed_dir, "--epochs", "3", "--resume", resumed_dir))
        steps += more
        straight_dir = os.path.join(tmp, "straight")
        straight, _ = run_train_net("fp32 straight", train_args(
            cache, straight_dir, "--epochs", "3"))
    finally:
        cudnn.deterministic = saved
    bad = same_state(straight, resumed)
    print(f"[train] 2 epochs + --resume vs 3 epochs straight (deterministic "
          f"cuDNN): {'bitwise equal' if not bad else f'differ at {bad[:3]}'}"
          f" ({len(straight.model.state_dict())} tensors, Adam moments, "
          f"step {straight.step})")
    if bad:
        raise AssertionError("the resumed run differs from the straight run")
    _, bf16_steps = run_train_net("bf16", train_args(
        cache, os.path.join(tmp, "bf16"), "--epochs", "2", "--bf16"))
    _, crop_steps = run_train_net("crop", train_args(
        cache, os.path.join(tmp, "crop"), "--epochs", "2", yml=CROP_YML))
    scenes = load_resident_scenes(
        os.path.join(cache, f"synthetic_tabletop_train_{H}x{W}_v4"),
        limit=TRAIN_SCENES, device=DEV)
    timing = {"fp32": time_recipe("fp32", TRAIN_YML, scenes),
              "bf16": time_recipe("bf16", TRAIN_YML, scenes, torch.bfloat16),
              "crop": time_recipe("crop", CROP_YML, scenes)}
    launched = launch_counts()
    print(f"[train] clustering kernel launches while training: {launched}")
    if any(launched.values()):
        raise AssertionError("training launched a clustering kernel")
    card_cpu = check_step_against_cpu()
    served = serve_snapshot(straight_dir, straight, scenes)
    out = dict(render=render, steps={"fp32": steps, "bf16": bf16_steps,
                                     "crop": crop_steps},
               resume_exact=True, timing=timing, card_vs_cpu=card_cpu,
               served=served, phase_s=time.perf_counter() - t0)
    print(f"phase 6 {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 7: data
# ---------------------------------------------------------------------------

class TimedRecorder(Recorder):
    """Recorder that also keeps each segment call's seconds (device
    synchronized)."""

    def __init__(self, seg: Segmentor):
        super().__init__(seg)
        self.seconds: list[float] = []

    def segment(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = super().segment(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        return out


def check_native(cloud_path: str, binary_path: str) -> dict:
    """The native library's LZF and strided gather equal to the plain
    Python versions on one 480x640 cloud of each encoding, and each PCD
    load's ms, native and plain."""
    with open(cloud_path, "rb") as f:
        data = f.read()
    start = data.index(b"DATA binary_compressed\n") + 23
    comp_size, size = (int(v) for v in np.frombuffer(data[start:start + 8],
                                                     "<u4"))
    stream = data[start + 8:start + 8 + comp_size]
    t0 = time.perf_counter()
    fast = pcd.lzf_decompress(stream, size)
    native_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    plain = pcd.lzf_decompress_py(stream, size)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if fast != plain or len(fast) != N * 12:
        raise AssertionError("native LZF differs from the plain version")
    with open(binary_path, "rb") as f:
        raw = f.read()
    raw = raw[raw.index(b"DATA binary\n") + 12:]
    for off in (0, 4, 8):
        got = data_native.extract_strided_f32(raw, N, 12, off)
        want = pcd.extract_strided_py(raw, N, 12, off, np.dtype("<f4"))
        if got.tobytes() != np.ascontiguousarray(want).tobytes():
            raise AssertionError("native strided gather differs")
    loads = {}
    for name, path in (("binary_compressed", cloud_path),
                       ("binary", binary_path)):
        for native in (True, False):
            t0 = time.perf_counter()
            xyz = pcd.load_pcd_xyz(path, native=native)
            loads[f"{name}_{'native' if native else 'plain'}_ms"] = (
                1e3 * (time.perf_counter() - t0))
            if xyz.shape != (N, 3):
                raise AssertionError(f"{path}: cloud {xyz.shape}")
    print(f"[data] native LZF = plain on a {H}x{W} cloud ({comp_size} -> "
          f"{size} bytes: native {native_ms:.2f} ms, plain {plain_ms:.1f} "
          f"ms); strided gather = plain; PCD load ms: "
          + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in loads.items()))
    return dict(lzf_native_ms=native_ms, lzf_plain_ms=plain_ms, **loads)


def check_trees(ds: SyntheticTabletopDataset, cfg: Config) -> dict:
    """The trees read back through get_dataset: labels follow OCID's plane
    ids (1, and 2 on table paths, are background; the raw label files hold
    them), BGR and XYZ bit-equal to the rendered scenes (NaN -> 0)."""
    out = {}
    for name, sub in (("ocid_object_test", "OCID"),
                      ("osd_object_test", "OSD")):
        dataset = get_dataset(name, cfg, path=sub)
        if len(dataset) != DATA_SCENES:
            raise AssertionError(f"{name}: {len(dataset)} frames")
        paths = (dataset.image_paths if sub == "OCID"
                 else dataset.image_files)
        strips = 0  # table frames whose id-2 plane the reader erased
        for k, path in enumerate(paths):
            i = int(re.search(r"(\d+)\.png$", str(path)).group(1))
            bgr, depth_mm, gt = ds.get_scene(i)
            sample = dataset[k]
            xyz = compute_xyz_np(depth_mm.astype(np.float32) / 1000.0, ds.f,
                                 ds.f, ds.cx, ds.cy)
            xyz[depth_mm == 0] = 0
            if not (np.array_equal(sample["label"],
                                   process_label(gt.astype(np.int32)))
                    and np.array_equal(sample["image_color_bgr"],
                                       bgr.astype(np.float32) / 255.0)
                    and np.array_equal(sample["depth"], xyz)):
                raise AssertionError(f"{name}: {path} differs from the "
                                     "rendered scene")
            if sub == "OCID":
                raw = png.read_indexed(str(path).replace("rgb", "label"))
                table = "table" in str(path)
                plane = (raw == 1) | ((raw == 2) & table)
                if ((sample["label"][plane] != 0).any()
                        or (sample["label"][~plane] == 0).any()):
                    raise AssertionError(f"{path}: labels break OCID's "
                                         "plane ids")
                strips += int(table and (raw == 2).any())
        if sub == "OCID" and not strips:
            raise AssertionError("no table frame holds the id-2 plane")
        out[name] = len(dataset)
    print(f"[data] read back through get_dataset: {out}; labels follow "
          "OCID's plane ids, BGR and XYZ bit-equal to the rendered scenes")
    return out


def run_test_net(tag: str, args: list[str], frames: int) -> dict:
    """tools.test_net.main on the card, its Segmentor recorded; the counters
    set to 0 before and read after: every kernel launched at least once per
    frame; the .mat files equal the labels segment returned."""
    recorders = []
    build = test_net.builder.build_segmentor

    def recording(*a, **k):
        recorders.append(TimedRecorder(build(*a, **k)))
        return recorders[-1]

    out_dir = args[args.index("--output-dir") + 1]
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(test_net.builder, "build_segmentor", recording):
        stage1, refined = test_net.main(args)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    rec = recorders[0]
    if len(rec.results) != frames:
        raise AssertionError(f"[{tag}] {len(rec.results)} frames")
    short = {k: v for k, v in counts.items() if v < frames}
    if short:
        raise AssertionError(f"[{tag}] kernels launched fewer times than "
                             f"the {frames} frames: {short}")
    for i, res in enumerate(rec.results):
        mat = scipy.io.loadmat(os.path.join(out_dir, "%06d.mat" % i))
        if not (np.array_equal(mat["labels"], res.labels[0])
                and np.array_equal(mat["labels_refined"],
                                   res.labels_refined[0])):
            raise AssertionError(f"[{tag}] {i:06d}.mat differs from the "
                                 "returned labels")
    found = [len(np.unique(r.labels)) - 1 for r in rec.results]
    res = dict(frames=frames, wall_s=wall, s_per_frame=wall / frames,
               segment_s=float(np.median(rec.seconds)), launches=counts,
               stage1_instances=found, stage1_metrics=stage1,
               objects_f=stage1["Objects F-measure"],
               objects_f_refined=refined["Objects F-measure"])
    print(f"[{tag}] test_net: {frames} frames in {wall:.2f} s "
          f"({res['s_per_frame']:.3f} s/frame, segment median "
          f"{res['segment_s']:.3f} s); launches {counts}; stage-1 "
          f"instances {found}; the .mat files equal the returned labels")
    return res


def run_image_tools(work: str, paths: dict[str, str],
                    ds: SyntheticTabletopDataset) -> dict:
    """Phase 7: tools.test_images.main() (--vis) and
    tools.demo_artifact.main() with phase 5's .pth files on two of the
    rendered scenes, written by utils/png.py as <name>-color.png and
    <name>-depth.png (uint16 mm) with the renderer's camera; every file
    they write read back (labels and overlays at 480x640, the grid of 2
    rows of color / stage 1 / refined at the default scale 0.5, its JSON
    sidecar), with no OpenCV on this machine."""
    d = os.path.join(work, "images")
    os.makedirs(d)
    for i in range(2):
        bgr, depth_mm, _ = ds.get_scene(i)
        png.imwrite(os.path.join(d, f"{i:06d}-color.png"), bgr)
        png.write_png(os.path.join(d, f"{i:06d}-depth.png"),
                      np.asarray(depth_mm, np.uint16))
    with open(os.path.join(d, "camera_params.json"), "w") as f:
        json.dump({"fx": 0.5 * W, "fy": 0.5 * W, "x_offset": W / 2.0,
                   "y_offset": H / 2.0}, f)
    model = ["--pretrained", paths["main"], "--pretrained_crop",
             paths["crop"]]
    out_dir, grid_path = os.path.join(d, "out"), os.path.join(d, "grid.png")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        test_images.main(["--imgdir", d, "--outdir", out_dir, "--vis"]
                         + model)
        demo_artifact.main(["--imgdir", d, "--out", grid_path] + model)
    seconds = time.perf_counter() - t0
    objects = {}
    for i in range(2):
        base = os.path.join(out_dir, f"{i:06d}")
        labels = png.imread(base + "-label.png", "grey")
        seg = png.imread(base + "-seg.png")
        mask = png.imread(base + "-mask.png")
        if labels.shape != (H, W) or seg.shape != (H, W, 3) \
                or mask.shape != (H, W, 3):
            raise AssertionError(f"[tools] bad outputs of frame {i}")
        if not (seg == 255).all(-1).any() and labels.max() > 0:
            raise AssertionError(f"[tools] frame {i}: no contour drawn")
        objects[f"{i:06d}"] = int(len(np.unique(labels)) - 1)
    grid = png.imread(grid_path)
    with open(grid_path + ".json") as f:
        sidecar = json.load(f)
    if (grid.shape != (H, 3 * W // 2, 3)
            or len(sidecar["stage1_instances"]) != 2):
        raise AssertionError(f"[tools] grid {grid.shape}, {sidecar}")
    print(f"[tools] test_images --vis and demo_artifact on 2 rendered "
          f"scenes without OpenCV in {seconds:.1f} s: labels, overlays and "
          f"masks at {H}x{W} read back, objects {objects}; grid "
          f"{grid.shape[1]}x{grid.shape[0]}, stage-1 instances "
          f"{sidecar['stage1_instances']}")
    return dict(objects=objects, grid_shape=list(grid.shape), seconds=seconds,
                stage1_instances=sidecar["stage1_instances"])


def run_data(work: str, paths: dict[str, str]) -> dict:
    """Phase 7."""
    t0 = time.perf_counter()
    data_native.library()
    built = data_native.build_seconds
    print(f"[data] native IO library from {data_native.SOURCE}: "
          f"{'reused' if built is None else f'built in {built:.2f} s'}")
    cache = os.path.join(work, "scenes")
    render = render_scenes(cache, "test", DATA_SCENES)
    cfg = Config.from_yaml(TRAIN_YML).replace(MODE="TEST")
    ds = SyntheticTabletopDataset("test", cfg, height=H, width=W,
                                  size=DATA_SCENES, cache_dir=cache)
    idx = list(range(DATA_SCENES))
    # the readers replace "rgb", "png" and "image_color" anywhere in a path
    # and look for "table", "OCID" and "OSD" in it, as the reference does:
    # the trees are read through paths relative to their root
    root = os.path.join(work, "fixtures")
    os.makedirs(root)
    with contextlib.chdir(root):
        t1 = time.perf_counter()
        make_real_fixtures.write_ocid("OCID", ds, idx, compressed=True)
        make_real_fixtures.write_osd("OSD", ds, idx, compressed=False)
        write_s = time.perf_counter() - t1
        print(f"[data] OCID (binary_compressed) and OSD (binary) trees of "
              f"the {DATA_SCENES} scenes written in {write_s:.2f} s")
        rgb = sorted(glob.glob("OCID/*/*/*/rgb/*.png"))
        native = check_native(rgb[0].replace("rgb", "pcd").replace(
            "png", "pcd"), sorted(glob.glob("OSD/pcd/*.pcd"))[0])
        t1 = time.perf_counter()
        for p in rgb:
            png.read_bgr(p)
            png.read_indexed(p.replace("rgb", "label"))
        png_ms = 1e3 * (time.perf_counter() - t1) / len(rgb)
        trees = check_trees(ds, cfg)
        tools = run_image_tools(work, paths, ds)
        demo = {}
        for p in sorted(glob.glob(os.path.join(REPO, "data", "demo_gt",
                                               "*-label.png"))):
            ids, counts = np.unique(png.read_indexed(p), return_counts=True)
            demo[os.path.basename(p)] = {int(i): int(c)
                                         for i, c in zip(ids, counts)}
        print(f"[data] demo_gt label ids and pixel counts: {demo}")
        runs = {}
        for name, sub, frames in (("ocid_object_test", "OCID", DATA_SCENES),
                                  ("osd_object_test", "OSD", DATA_SCENES),
                                  ("synthetic_tabletop_test", cache,
                                   SYN_FRAMES)):
            for mode in ("parity", "fast"):
                tag = f"{mode}, {name}"
                out_dir = os.path.join(work, "test_net", mode, name)
                runs[f"{mode}/{name}"] = run_test_net(tag, [
                    "--dataset", name, "--dataset_root", sub,
                    "--cfg", os.path.join(REPO, TRAIN_YML), "--network", NET,
                    "--pretrained", paths["main"],
                    "--pretrained_crop", paths["crop"],
                    "--max_images", str(frames), "--output-dir", out_dir]
                    + (["--fast"] if mode == "fast" else []), frames)
    out = dict(native_build_s=built, render=render, write_trees_s=write_s,
               png_decode_ms_per_frame=png_ms, pcd=native, trees=trees,
               demo_gt_ids=demo, test_net=runs, image_tools=tools,
               phase_s=time.perf_counter() - t0)
    print(f"[data] PNG decode {png_ms:.1f} ms per frame (BGR + labels); "
          f"phase 7 {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: the alternate backbones
# ---------------------------------------------------------------------------

def alt_network(i: int) -> tuple[Config, dict]:
    """Phase 8's i-th alternate network (ALT_NETS): its config and its
    fixed-seed init."""
    net, bn = ALT_NETS[i]
    cfg = Config.inference_default(INPUT="RGBD", TRAIN={"VGG_BATCH_NORM": bn})
    torch.manual_seed(20 + i)
    return cfg, get_network(net, cfg).state_dict()


def run_alternates(frame: dict) -> dict:
    """Phase 8: the U-Net and the VGG (BatchNorm) RGB-D add networks from
    fixed-seed inits through Segmentor.segment_sample in parity on phase
    3's 480x640 frame (a warm-up and a timed frame; the counters set to 0
    before and read after: every kernel launched in each frame); each
    network on the card against the CPU on a window of the frame."""
    out = {}
    for i, (net, bn) in enumerate(ALT_NETS):
        cfg, state = alt_network(i)
        seg = Segmentor(cfg, state, network_name=net)
        reset_counts()
        results = [seg.segment_sample(frame, return_features=True)
                   for _ in range(2)]
        counts = launch_counts()
        short = {k: v for k, v in counts.items() if v < 2}
        if short:
            raise AssertionError(f"[{net}] kernels launched fewer times "
                                 f"than the 2 frames: {short}")
        f = results[-1].features
        if (f.shape != (1, H, W, D) or not np.isfinite(f).all()
                or np.abs(np.linalg.norm(f, axis=-1) - 1.0).max() > 1e-3
                or results[-1].labels.shape != (1, H, W)):
            raise AssertionError(f"[{net}] bad embeddings or labels")
        h, w = ALT_WINDOW
        window = {k: v[None, H // 2 - h // 2:H // 2 + h // 2,
                       W // 2 - w // 2:W // 2 + w // 2]
                  for k, v in frame.items()}
        cpu = get_network(net, cfg)
        cpu.load_state_dict(state)
        cpu.eval()
        with torch.no_grad():
            card = seg.model(window["image_color"], window["depth"]).cpu()
            want = cpu(window["image_color"].cpu(), window["depth"].cpu())
        err = float((card - want).abs().max())
        timing = results[-1].timing
        out[net] = dict(batch_norm=bn, network_ms=1e3 * timing["network"],
                        cluster_ms=1e3 * timing["cluster"],
                        stage1_ms=1e3 * timing["stage1"], launches=counts,
                        card_vs_cpu_max_abs=err,
                        instances=len(np.unique(results[-1].labels)) - 1)
        print(f"[{net}{' batch_norm' if bn else ''}] parity stage 1 at "
              f"{H}x{W}: network {out[net]['network_ms']:.3f} ms, cluster "
              f"{out[net]['cluster_ms']:.3f} ms; launches {counts}; card vs "
              f"CPU on a {h}x{w} window: max |embedding diff| {err:.3e}")
        if not err <= ALT_TOL:
            raise AssertionError(f"[{net}] the card's embeddings differ from "
                                 f"the CPU's by {err:.3e}")
        del seg, cpu
        torch.cuda.empty_cache()
    return out


# phase 8b: trained stage 1
# ---------------------------------------------------------------------------

def held_out(cache: str, cfg: Config) -> SyntheticTabletopDataset:
    """The test split at TH x TW, its scenes read from the render cache."""
    return SyntheticTabletopDataset("test", cfg, height=TH, width=TW,
                                    size=HELD_OUT, cache_dir=cache)


def held_out_frames(cache: str, count: int, device="cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first `count` held-out scenes of the render cache preprocessed
    on the card: [count, TH, TW, 3] image and XYZ."""
    cfg = Config.from_yaml(os.path.join(REPO, RECIPE_YML))
    ds = held_out(cache, cfg)
    pairs = []
    for i in range(count):
        bgr, depth_mm, _ = ds.get_scene(i)
        pairs.append(preprocess_rgbd(
            torch.from_numpy(bgr).to(device),
            torch.from_numpy(depth_mm.astype(np.float32) / 1000.0).to(device),
            cfg.pixel_means, ds.f, ds.f, ds.cx, ds.cy))
    return tuple(torch.stack(t) for t in zip(*pairs))


class CountingSegmentor(TimedRecorder):
    """TimedRecorder that sets the launch counters to 0 just before each
    segment call and reads them just after."""

    def __init__(self, seg: Segmentor):
        super().__init__(seg)
        self.launches: list[dict] = []

    def segment(self, *args, **kwargs):
        reset_counts()
        out = super().segment(*args, **kwargs)
        self.launches.append(launch_counts())
        return out


def run_report(tag: str, pretrained: str, cache: str, out: str) -> dict:
    """tools.fast_parity_report.main() on the HELD_OUT scenes at TH x TW
    with the recipe's cfg, each mode's Segmentor counting its launches per
    frame: every kernel at least once per frame in each mode."""
    segs: dict[str, CountingSegmentor] = {}
    build = fast_parity_report.builder.build_segmentor

    def counting(*a, **k):
        mode = "parity" if k.get("model_dtype") is None else "fast"
        segs[mode] = CountingSegmentor(build(*a, **k))
        return segs[mode]

    with mock.patch.object(fast_parity_report.builder, "build_segmentor",
                           counting):
        rep = fast_parity_report.main([
            "--pretrained", pretrained, "--cfg", RECIPE_YML, "--network",
            NET, "--scenes", str(HELD_OUT), "--height", str(TH), "--width",
            str(TW), "--render-cache", cache, "--out", out])
    rep["segmentors"] = segs
    rep["launches"] = {}
    for mode, seg in segs.items():
        short = [i for i, c in enumerate(seg.launches)
                 if min(c.values()) < 1]
        if len(seg.launches) != HELD_OUT or short:
            raise AssertionError(f"[{tag} {mode}] {len(seg.launches)} "
                                 f"frames; frames {short} miss a kernel")
        rep["launches"][mode] = {k: sum(c[k] for c in seg.launches)
                                 for k in KERNELS}
        rep[f"{mode}_instances"] = [int(m["obj_detected"])
                                    for m in rep["frames"][mode]]
        rep[f"{mode}_segment_ms"] = 1e3 * float(np.median(seg.seconds))
    avg, agree = rep["average"], rep["agreement"]
    for mode in ("parity", "fast"):
        print(f"[{tag} {mode}] {HELD_OUT} held-out scenes at {TH}x{TW}: "
              + ", ".join(f"{k} {avg[mode][k]:.4f}"
                          for k in fast_parity_report.KEYS)
              + f"; instances per frame {rep[mode + '_instances']}; "
              f"segment median {rep[mode + '_segment_ms']:.2f} ms; "
              f"launches {rep['launches'][mode]}")
    print(f"[{tag}] fast-vs-parity agreement (Objects F of fast labels "
          f"against parity labels): mean {np.mean(agree):.4f}, min "
          f"{np.min(agree):.4f}")
    return rep


def run_probe(tag: str, argv: list[str], x: np.ndarray | None = None
              ) -> dict:
    """tools.probe_seed_precision.main() on the card: both routes, plain
    and kernel, must PASS."""
    res = probe_seed_precision.main(argv, x=x)
    if sorted(res["routes"]) != ["kernel", "plain"] or not res["ok"]:
        raise AssertionError(f"[probe {tag}] {res}")
    print(f"[probe {tag}] n {res['n']}, m {res['m']}: " + "; ".join(
        f"{k} PASS, {r['divergences']} divergences from the float64 "
        f"replay, worst gap {r['worst_gap']:.3e}"
        for k, r in res["routes"].items()))
    return res


def run_trained(tmp: str, random_pth: str) -> dict:
    """Phase 8b: the stage-1 recipe (RECIPE_YML) trained from scratch on
    the card, cut to TRAINED_SCENES scenes and TRAINED_EPOCHS epochs, then
    fast_parity_report on HELD_OUT held-out scenes with the gates, the same
    report on phase 3's random-init network (which must find nothing),
    and the float64 seeding audit of both routes on random unit vectors at
    the crop shape and on the trained embeddings of one held-out frame.
    Phase 9 reads the snapshot and the held-out cache under tmp/trained."""
    t0 = time.perf_counter()
    work = os.path.join(tmp, "trained")
    cache = os.path.join(work, "cache")
    snapshots = os.path.join(work, "snapshots")
    t1 = time.perf_counter()
    render = render_splits(cache, {"train": TRAINED_SCENES,
                                   "test": HELD_OUT}, (TH, TW))
    render_s = time.perf_counter() - t1
    with open(os.path.join(REPO, RECIPE_YML)) as f:
        tree = yaml.safe_load(f)
    tree["TRAIN"]["SNAPSHOT_EPOCHS"] = TRAINED_EPOCHS  # one, at the end
    yml = os.path.join(work, "recipe.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(tree, f)
    reset_counts()
    t1 = time.perf_counter()
    _, steps = run_train_net("trained", train_args(
        cache, snapshots, "--epochs", str(TRAINED_EPOCHS), "--bf16",
        yml=yml, scenes=TRAINED_SCENES))
    train_s = time.perf_counter() - t1
    launched = launch_counts()
    if any(launched.values()):
        raise AssertionError(f"[trained] training launched a clustering "
                             f"kernel: {launched}")
    step_ms = float(np.median([row["ms"] for row in steps[1:]]))
    print(f"[trained] {len(steps)} steps of batch {TRAIN_SCENES} at "
          f"{TH}x{TW}, bf16, in {train_s:.1f} s (train_net.main, start and "
          f"snapshot included); step {step_ms:.2f} ms (median of CUDA "
          f"events between consecutive steps); loss {steps[0]['loss']:.4f} "
          f"-> {steps[-1]['loss']:.4f}")
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    rep = run_report("trained", snapshots, cache,
                     os.path.join(work, "fast_parity.md"))
    report_s = time.perf_counter() - t2
    rnd = run_report("random init", random_pth, cache,
                     os.path.join(work, "fast_parity_random.md"))
    par = rep["average"]["parity"]["Objects F-measure"]
    fast = rep["average"]["fast"]["Objects F-measure"]
    par_random = rnd["average"]["parity"]["Objects F-measure"]
    gates = dict(floor=TRAINED_FLOOR, fast_gap=FAST_GAP,
                 parity_objects_f=par, fast_objects_f=fast,
                 random_parity_objects_f=par_random)
    print(f"[trained] gates: parity Objects F {par:.4f} >= floor "
          f"{TRAINED_FLOOR}; |fast - parity| {abs(fast - par):.4f} <= "
          f"{FAST_GAP}; an instance in every held-out frame (fewest "
          f"{min(rep['parity_instances'])}); the random-init network finds "
          f"nothing and misses the floor ({par_random:.4f}, instances "
          f"{rnd['parity_instances']})")
    if min(rep["parity_instances"]) < 1:
        raise AssertionError("[trained] a held-out frame without an "
                             f"instance: {rep['parity_instances']}")
    if not par >= TRAINED_FLOOR:
        raise AssertionError(f"[trained] parity Objects F {par:.4f} below "
                             f"{TRAINED_FLOOR}")
    if not abs(fast - par) <= FAST_GAP:
        raise AssertionError(f"[trained] fast Objects F {fast:.4f} is more "
                             f"than {FAST_GAP} from parity's {par:.4f}")
    if max(rnd["parity_instances"]) > 0 or not par_random < TRAINED_FLOOR:
        raise AssertionError(f"[trained] the random-init network finds "
                             f"{rnd['parity_instances']}, Objects F "
                             f"{par_random:.4f}")

    feats = rep["segmentors"]["parity"].seg.segment(
        *held_out_frames(cache, 1, DEV), refine=False,
        return_features=True).features[0]
    probes = {"random": run_probe("random", ["--n", str(CROP * CROP)]),
              "trained": run_probe("trained", ["--m", str(M)],
                                   x=feats.reshape(-1, D))}
    out = dict(render=render, render_s=render_s, steps=len(steps),
               batch=TRAIN_SCENES,
               shape=[TH, TW], epochs=TRAINED_EPOCHS, train_s=train_s,
               step_ms=step_ms, loss=[steps[0]["loss"], steps[-1]["loss"]],
               report={k: rep[k] for k in (
                   "average", "agreement", "launches", "parity_instances",
                   "fast_instances", "parity_segment_ms",
                   "fast_segment_ms")},
               report_s=report_s,
               random_report={k: rnd[k] for k in (
                   "average", "parity_instances", "fast_instances")},
               gates=gates, probes=probes, snapshot=snapshots, cache=cache,
               phase_s=time.perf_counter() - t0)
    print(f"phase 8b {out['phase_s']:.1f} s (render {render_s:.1f}, "
          f"train {train_s:.1f}, trained report {report_s:.1f})")
    return out


# phase 9: data parallelism
# ---------------------------------------------------------------------------

def dp_frames() -> tuple[torch.Tensor, torch.Tensor]:
    """DP_FRAMES tabletop frames preprocessed on the card: [B, H, W, 3]."""
    cfg = Config.inference_default(INPUT="RGBD")
    pairs = [preprocess_rgbd(*(torch.from_numpy(a).cuda()
                               for a in tabletop_frame(10 + i)),
                             cfg.pixel_means, *INTR)
             for i in range(DP_FRAMES)]
    return tuple(torch.stack(t) for t in zip(*pairs))


def check_nccl(mesh) -> None:
    """The world-size-1 NCCL group moves data: an all-reduce and an
    all-gather of a label-sized int32 tensor."""
    t = torch.arange(N, dtype=torch.int32, device=mesh.device)
    dist.all_reduce(t)
    parts = [torch.empty_like(t)]
    dist.all_gather(parts, t)
    if not (torch.equal(t, parts[0]) and int(t[-1]) == N - 1):
        raise AssertionError("the NCCL group of one rank altered its data")


def sharded_call(mesh, seg: Segmentor, ref: Segmentor, img: torch.Tensor,
                 xyz: torch.Tensor, tag: str, features: bool = False
                 ) -> tuple[float, np.ndarray, dict, np.ndarray | None]:
    """One segment_sharded call on the frames, the counters set to 0 just
    before and read just after: its wall seconds, its labels, the
    launches, and (with `features`) the embeddings of `ref`'s call.  The
    labels must equal, frame by frame, those of one segment(refine=False)
    call of `ref` (a Segmentor built alike, so drawing the same keys) on
    the same DP_FRAMES frames, and each kernel must launch once per
    frame."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = seg.segment_sharded(mesh, img, xyz)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    if any(v != DP_FRAMES for v in counts.values()):
        raise AssertionError(f"[dp {tag}] launches {counts}, not one per "
                             f"frame of {DP_FRAMES}")
    if labels.shape != img.shape[:3] or labels.dtype != np.int32:
        raise AssertionError(f"[dp {tag}] labels {labels.shape} "
                             f"{labels.dtype}")
    want = ref.segment(img, xyz, refine=False, return_features=features)
    differ = [i for i in range(DP_FRAMES)
              if not np.array_equal(labels[i], want.labels[i])]
    if differ:
        raise AssertionError(f"[dp {tag}] frames {differ} differ from "
                             "segment(refine=False)")
    return seconds, labels, counts, want.features


def batch1_gap(one: Segmentor, img: torch.Tensor, xyz: torch.Tensor,
               labels: np.ndarray, feats: np.ndarray) -> dict:
    """Each frame segmented alone (DP_FRAMES segment(refine=False) calls of
    `one`, a Segmentor built alike) against the batch's labels and
    embeddings: the pixels whose label differs and the largest embedding
    difference.  cuDNN may run other kernels at batch 1 than at batch
    DP_FRAMES."""
    rows = [one.segment(img[i:i + 1], xyz[i:i + 1], refine=False,
                        return_features=True) for i in range(DP_FRAMES)]
    return dict(pixels=[int((labels[i] != r.labels[0]).sum())
                        for i, r in enumerate(rows)],
                instances=[len(np.unique(r.labels)) - 1 for r in rows],
                feature_max_abs=max(float(np.abs(feats[i] - r.features[0])
                                          .max())
                                    for i, r in enumerate(rows)))


def batch_metrics(ds, seg: Segmentor) -> dict:
    """The averaged multilabel_metrics of segment(refine=False) on the
    dataset read in batches of DP_FRAMES frames, as
    evaluate_dataset_sharded batches it."""
    rows = []
    for batch in DataLoader(ds, batch_size=DP_FRAMES, shuffle=False,
                            num_workers=0, drop_last=False):
        labels = seg.segment(batch["image_color"], batch["depth"],
                             refine=False).labels
        rows += [multilabel_metrics(labels[i], batch["label"][i])
                 for i in range(len(labels))]
    return average_metrics(rows)


def run_sharded(cfg: Config, state_dict: dict, work: str,
                timings: dict, trained: dict) -> dict:
    """Phase 9, world size 1 on NCCL: segment_sharded on DP_FRAMES frames
    at 480x640 in each mode, each call's labels equal per frame to one
    segment(refine=False) call on the same frames, each kernel launched
    once per frame: phase 3's ResNet in DP_CALLS calls, timed (frames/s
    and ms per frame beside phase 3's batch-1 stage 1); phase 8's U-Net in
    one call, and phase 8b's trained ResNet in one call on DP_FRAMES
    held-out scenes at TH x TW, which must each find an instance in every
    frame (the random-init ResNet finds none, so its equality holds
    between empty label maps).
    Against the frames segmented one at a time: the pixels that differ and
    the embeddings, within ALT_TOL in parity (cuDNN runs other kernels at
    batch 1).  evaluate_dataset_sharded on phase 7's OCID tree (batch
    DP_FRAMES) with the U-Net loaded from a reference-layout .pth: equal
    to the metrics of segment(refine=False) on the same batches, with
    objects detected, beside evaluate_dataset(refine=False)'s (frames one
    at a time)."""
    parallel.initialize("file://" + os.path.join(work, "nccl_rdzv"), 1, 0,
                        backend="nccl")
    try:
        return sharded_checks(cfg, state_dict, work, timings, trained,
                              parallel.make_mesh())
    finally:
        dist.destroy_process_group()


def sharded_checks(cfg: Config, state_dict: dict, work: str, timings: dict,
                   trained: dict, mesh) -> dict:
    """run_sharded's checks in its process group."""
    print(f"[dp] process group: backend {dist.get_backend()}, world "
          f"{mesh.world}, device {mesh.device}")
    check_nccl(mesh)
    frames = dp_frames()
    unet = ALT_NETS[0][0]
    ucfg, ustate = alt_network(0)
    rcfg = Config.from_yaml(os.path.join(REPO, RECIPE_YML)).replace(
        MODE="TEST")
    out: dict = {}
    for key, net, ncfg, state, calls, (img, xyz) in (
            (None, NET, cfg, state_dict, DP_CALLS, frames),
            (unet, unet, ucfg, ustate, 1, frames),
            ("trained", NET, rcfg, load_network_state(
                rcfg, NET, trained["snapshot"]), 1,
             held_out_frames(trained["cache"], DP_FRAMES))):
        for mode, mcfg, dtype in (
                ("parity", ncfg, None),
                ("fast", ncfg.replace(CLUSTER=dict(FAST_CLUSTER)),
                 torch.bfloat16)):
            tag = mode if key is None else f"{key} {mode}"
            seg, ref, one = (Segmentor(mcfg, state, network_name=net,
                                       model_dtype=dtype) for _ in range(3))
            runs = [sharded_call(mesh, seg, ref, img, xyz, tag,
                                 features=i == 0) for i in range(calls)]
            labels, feats = runs[0][1], runs[0][3]
            alone = batch1_gap(one, img, xyz, labels, feats)
            del seg, ref, one, feats
            found = [len(np.unique(f)) - 1 for f in labels]
            launches = {k: sum(r[2][k] for r in runs) for k in KERNELS}
            row = dict(frames=DP_FRAMES, calls=calls, launches=launches,
                       instances=found, batch1=alone)
            line = (f"[dp {tag}] segment_sharded, world 1: {DP_FRAMES} "
                    f"frames at {img.shape[1]}x{img.shape[2]} per call, "
                    f"labels equal per frame to "
                    f"segment(refine=False) on the same frames in all "
                    f"{calls} calls; instances {found}; launches "
                    f"{launches}; each frame alone (batch 1): "
                    f"{alone['pixels']} pixels differ, instances "
                    f"{alone['instances']}, embeddings within "
                    f"{alone['feature_max_abs']:.3e}")
            if key is None:
                seconds = [r[0] for r in runs]
                t = float(np.median(seconds[1:]))
                row.update(call_s=seconds, frames_per_s=DP_FRAMES / t,
                           ms_per_frame=1e3 * t / DP_FRAMES,
                           batch1_stage1_ms=timings[mode]["stage1"])
                line += (f"; {row['frames_per_s']:.2f} frames/s, "
                         f"{row['ms_per_frame']:.3f} ms/frame (median of "
                         f"{calls - 1} calls after a warm-up), phase 3's "
                         f"batch-1 stage 1 {timings[mode]['stage1']:.3f} "
                         f"ms/frame")
            out[mode if key is None else f"{key}/{mode}"] = row
            print(line)
            if key is not None and min(found) < 1:
                raise AssertionError(f"[dp {tag}] a frame without an "
                                     f"instance: {found}")
            if mode == "parity" and not alone["feature_max_abs"] <= ALT_TOL:
                raise AssertionError(f"[dp {tag}] batch-1 embeddings differ "
                                     f"by {alone['feature_max_abs']:.3e}")
    # the spatial route at world size 1 runs the same sharded layers
    out["spatial_world1"] = spatial_checks(
        mesh, {NET: spatial_cases(mesh)[NET]}, modes=("parity",), frames=1,
        fault=False)
    tcfg = Config.from_yaml(os.path.join(REPO, TRAIN_YML)).replace(
        MODE="TEST")
    upath = os.path.join(work, f"{unet}.pth")
    torch.save({"model": {"module." + k: v for k, v in ustate.items()}},
               upath)

    def built():
        return build_segmentor(tcfg, unet, pretrained=upath,
                               depth_threshold=0.5)

    with contextlib.chdir(os.path.join(work, "fixtures")):
        ds = get_dataset("ocid_object_test", tcfg, path="OCID")
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            got = evaluate_dataset_sharded(ds, built(), mesh,
                                           batch_size=DP_FRAMES,
                                           num_workers=0)
        counts = launch_counts()
        want = batch_metrics(ds, built())
        alone, _ = evaluate_dataset(ds, built(), refine=False,
                                    save_results=False, verbose=False)
    if got != want or any(v != len(ds) for v in counts.values()):
        raise AssertionError(f"[dp] evaluate_dataset_sharded {got} vs "
                             f"{want}; launches {counts}")
    out["ocid"] = dict(network=unet, frames=len(ds), metrics=got,
                       launches=counts, evaluate_dataset=alone,
                       equals_evaluate_dataset=got == alone)
    print(f"[dp] evaluate_dataset_sharded, {unet} from {unet}.pth, on the "
          f"OCID tree ({len(ds)} frames, batch {DP_FRAMES}): equal to "
          f"segment(refine=False)'s metrics on the same batches; Objects F "
          f"{got['Objects F-measure']:.6f}, {got['obj_detected']} objects "
          f"detected per frame; evaluate_dataset(refine=False) (frames one "
          f"at a time) Objects F {alone['Objects F-measure']:.6f}, "
          f"{alone['obj_detected']} (equal: {got == alone}); launches "
          f"{counts}")
    if not got["obj_detected"] > 0:
        raise AssertionError("[dp] the OCID frames gave no instance")
    return out


def zero_halo(real):
    """A planted fault for spatial.SpatialShard.conv2d: zeros instead of
    the neighbours' columns in the first dilated convolution of a call."""
    seen = []

    def conv2d(self, x, weight, bias, stride, padding, dilation, groups):
        if dilation[1] == 1 or seen:
            return real(self, x, weight, bias, stride, padding, dilation,
                        groups)
        seen.append(True)
        reach = dilation[1] * (weight.shape[-1] - 1)
        x = torch.nn.functional.pad(x, (padding[1], reach - padding[1]))
        return torch.nn.functional.conv2d(x, weight, bias, stride,
                                          (padding[0], 0), dilation, groups)
    return conv2d


def attributed_call(fn, *args) -> dict:
    """One more call of a spatial stage 1 with a device sync before and
    after each of its collectives (the halo and embedding all_gathers,
    GroupNorm's all_reduces): the host ms spent waiting for the card's work
    before each collective, inside the collectives, and in all."""
    wait, inside, count = [0.0], [0.0], [0]

    def timed(call):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = call(*a, **k)
            torch.cuda.synchronize()
            wait[0] += t1 - t0
            inside[0] += time.perf_counter() - t1
            count[0] += 1
            return out
        return wrapper

    with mock.patch.object(spatial.SpatialShard, "all_gather",
                           timed(spatial.SpatialShard.all_gather)), \
            mock.patch.object(spatial.dist, "all_reduce",
                              timed(spatial.dist.all_reduce)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    return dict(collectives=count[0], total_ms=1e3 * total,
                wait_ms=1e3 * wait[0], collective_ms=1e3 * inside[0])


def spatial_cases(mesh, trained_dir: str | None = None) -> dict:
    """spatial_checks' networks, each with its weights and frame: phase
    3's random-init ResNet-34-8s and phase 8's U-Net on phase 3's 480x640
    frame; with `trained_dir` (phase 8b's work directory), also phase 8b's
    trained ResNet on the first held-out TH x TW scene."""
    cfg = Config.inference_default(INPUT="RGBD")
    torch.manual_seed(0)  # phase 3's init
    bgr, depth = tabletop_frame()
    frame = tuple(t[None] for t in preprocess_rgbd(
        torch.from_numpy(bgr).to(mesh.device),
        torch.from_numpy(depth).to(mesh.device), cfg.pixel_means, *INTR))
    cases = {NET: (NET, cfg, get_network(NET, cfg).state_dict(), frame),
             ALT_NETS[0][0]: (ALT_NETS[0][0], *alt_network(0), frame)}
    if trained_dir is not None:
        rcfg = Config.from_yaml(os.path.join(REPO, RECIPE_YML)).replace(
            MODE="TEST")
        cases["trained"] = (NET, rcfg, load_network_state(
            rcfg, NET, os.path.join(trained_dir, "snapshots")),
            held_out_frames(os.path.join(trained_dir, "cache"), 1,
                            mesh.device))
    return cases


def spatial_checks(mesh, cases: dict, modes=("parity", "fast"),
                   frames: int = SPATIAL_FRAMES, fault: bool = True) -> dict:
    """Phase 9: Segmentor.make_spatial_stage1 over the mesh, each frame's
    width split over the ranks, for each of spatial_cases' networks (phase
    3's ResNet-34-8s and phase 8's U-Net on phase 3's 480x640 frame, phase
    8b's trained ResNet on a 240x320 held-out scene) in each mode: a
    warm-up call, then `frames` timed calls (a barrier and a device sync
    before each), the counters set to 0 before them and read after (each
    kernel exactly once per frame on this rank).  The embeddings against
    the one-process batch-1 _stage1_impl within SPATIAL_TOL; the labels
    equal to _cluster_batch of the gathered embeddings with the same
    generator; the pixels relabelled against one process (the U-Net and
    the trained ResNet: an instance at least; in parity at most
    SPATIAL_RELABEL of the frame relabelled and as many instances as one
    process finds).  With `fault`, the parity random-init ResNet with a
    zeroed halo in its first dilated convolution must break the embedding
    gate."""

    def gens():
        return [torch.Generator().manual_seed(5)]

    out: dict = {}
    for key, (net, ncfg, state, (img, xyz)) in cases.items():
        h, w = img.shape[1:3]
        for mode in modes:
            fast = mode == "fast"
            seg = Segmentor(ncfg.replace(CLUSTER=dict(FAST_CLUSTER))
                            if fast else ncfg, state, network_name=net,
                            model_dtype=torch.bfloat16 if fast else None,
                            device=mesh.device)
            fn = seg.make_spatial_stage1(mesh)
            fn(img, xyz, gens())
            seconds = []
            reset_counts()
            for _ in range(frames):
                if mesh.world > 1:
                    dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                features, labels = fn(img, xyz, gens())
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            launches = launch_counts()
            ref_f, ref_l = seg._stage1_impl(img, xyz, gens(),
                                            threshold=seg._threshold())
            with torch.inference_mode(), _full_fp32():
                again = _cluster_batch(features, gens(),
                                       z_valid=xyz[..., 2] > 0,
                                       filter_threshold=seg._threshold(),
                                       **seg._ms_kw)
            gap = float((features - ref_f).abs().max())
            relabelled = int((labels != ref_l).sum())
            found = len(torch.unique(labels)) - 1
            alone = len(torch.unique(ref_l)) - 1
            row = dict(world=mesh.world, ms_per_frame=1e3 * float(
                np.median(seconds)), call_s=seconds, feature_max_abs=gap,
                pixels_relabelled=relabelled, instances=found,
                one_process_instances=alone, launches=launches,
                labels_equal_cluster_of_gathered=bool(torch.equal(
                    labels, again)))
            tag = (f"[spatial {key} {mode}, rank {mesh.rank} of "
                   f"{mesh.world}]")
            line = (f"{tag} {h}x{w}, bands of {w // mesh.world} columns: "
                    f"{row['ms_per_frame']:.3f} ms/frame (median of "
                    f"{frames} after a warm-up); embeddings vs one process "
                    f"{gap:.3e}; {relabelled} pixels relabelled; instances "
                    f"{found} (one process {alone}); labels equal to the "
                    f"clustering of the gathered embeddings: "
                    f"{row['labels_equal_cluster_of_gathered']}; launches "
                    f"{launches}")
            if mesh.world > 1:
                row["attribution"] = split = attributed_call(
                    fn, img, xyz, gens())
                line += (f"; a call with a sync around each of its "
                         f"{split['collectives']} collectives: "
                         f"{split['total_ms']:.1f} ms, of it "
                         f"{split['wait_ms']:.1f} waiting for the card "
                         f"before them and {split['collective_ms']:.1f} "
                         f"inside them")
            if fault and key == NET and not fast:
                planted = zero_halo(spatial.SpatialShard.conv2d)
                with mock.patch.object(spatial.SpatialShard, "conv2d",
                                       planted):
                    broken, _ = fn(img, xyz, gens())
                row["zero_halo_max_abs"] = float((broken - ref_f).abs().max())
                line += (f"; planted zero halo: embeddings off by "
                         f"{row['zero_halo_max_abs']:.3e}")
                if not row["zero_halo_max_abs"] > SPATIAL_TOL[mode]:
                    raise AssertionError(f"{tag} the planted zero halo "
                                         "passes the embedding gate")
            print(line, flush=True)
            out[f"{key}/{mode}"] = row
            if not gap <= SPATIAL_TOL[mode]:
                raise AssertionError(f"{tag} embeddings off by {gap:.3e}")
            if not row["labels_equal_cluster_of_gathered"]:
                raise AssertionError(f"{tag} labels differ from the "
                                     "clustering of the gathered embeddings")
            if any(v != frames for v in launches.values()):
                raise AssertionError(f"{tag} launches {launches}, not once "
                                     "per frame")
            # bfloat16 rounds each layer's output where the band's sums
            # differ in their last float32 bits, which may split or merge
            # a near-tie cluster: fast mode's count is printed, not gated
            if key != NET and (found < 1 or (not fast and found != alone)):
                raise AssertionError(f"{tag} {found} instances, one "
                                     f"process {alone}")
            if (key != NET and not fast
                    and relabelled > SPATIAL_RELABEL * h * w):
                raise AssertionError(f"{tag} {relabelled} pixels relabelled")
            del seg, fn, features, labels, ref_f, ref_l, again
            torch.cuda.empty_cache()
    return out


def dp_rank(rank: int, tmp: str, go) -> None:
    """Phase 9's two gloo ranks, each a process on the one card: the
    spatial stage 1 (spatial_checks), the small DP step (and with
    per-replica BatchNorm statistics, and with per-rank
    loss scalars), then, once `go` is set, DP_TIMED_STEPS full-width
    resident steps after a warm-up; rank 0 saves its results in tmp."""
    parallel.initialize("file://" + os.path.join(tmp, "gloo_rdzv"), 2, rank,
                        backend="gloo")
    try:
        dp_rank_steps(rank, tmp, go, parallel.make_mesh(DEV + ":0"))
    finally:
        dist.destroy_process_group()


def dp_rank_steps(rank: int, tmp: str, go, mesh) -> None:
    """dp_rank's work in its process group."""
    out = {"spatial": spatial_checks(
        mesh, spatial_cases(mesh, os.path.join(tmp, "trained")))}
    torch.cuda.reset_peak_memory_stats()
    inputs = small_step_inputs(DP_SMALL_BATCH)
    cfg, _, bgr, depth, label, init, step, draws = inputs

    def small():
        return small_step(cfg, init, step, (bgr, depth, label), draws,
                          mesh.device, mesh)

    out["small"] = small()
    with mock.patch.object(resnet, "data_parallel_group", lambda: None):
        out["bn_local"] = small()
    with mock.patch.object(losses, "data_parallel_group", lambda: None):
        out["loss_local"] = small()
    cfg = Config.from_yaml(TRAIN_YML).replace(MODE="TRAIN")
    scenes = load_resident_scenes(
        os.path.join(tmp, "render_cache",
                     f"synthetic_tabletop_train_{H}x{W}_v4"),
        limit=TRAIN_SCENES, mesh=mesh)
    state = create_train_state(cfg, network_name=NET, solver="adam",
                               device=mesh.device)
    f = 0.5 * W
    step = make_train_step_resident(cfg, fx=f, fy=f, px=W / 2.0, py=H / 2.0)
    idx = torch.arange(TRAIN_SCENES)[mesh.batch_slice(TRAIN_SCENES)]
    if not go.wait(900):
        raise RuntimeError("no go for the timed steps")
    seconds, loss = [], []
    for i in range(1 + DP_TIMED_STEPS):
        gen = torch.Generator(device=mesh.device).manual_seed(
            step_seed(3, 0, i))
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, *scenes, idx.to(mesh.device), gen=gen,
                          mesh=mesh)
        loss.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
    out["full"] = dict(step_s=seconds, loss=loss,
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if rank == 0:
        torch.save(out, os.path.join(tmp, "dp_rank0.pt"))


def train_torchrun(tmp: str) -> tuple[str, str, float]:
    """tools.train_net under torchrun --nproc_per_node 1 (its process
    group, NCCL, world size 1) on phase 6's render cache, one epoch,
    --device-resident, on cuda:<LOCAL_RANK>: the snapshot directory, the
    standard output and the wall seconds, process start included.  The
    launcher and its worker are one process group of their own, killed
    whole if they outlive the time limit."""
    cache = os.path.join(tmp, "render_cache")
    out_dir = os.path.join(tmp, "torchrun")
    args = train_args(cache, out_dir, "--epochs", "1")
    args = args[:args.index("--device")] + args[args.index("--device") + 2:]
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m",
         "unseenobjectclustering_torch.tools.train_net"] + args,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.communicate()
    wall = time.perf_counter() - t0
    if proc.returncode:
        print(stdout[-3000:])
        print(stderr[-3000:])
        raise AssertionError(f"torchrun train_net exited {proc.returncode}")
    return out_dir, stdout, wall


def check_torchrun(tmp: str, out_dir: str, stdout: str, wall: float
                   ) -> dict:
    """Phase 9: the torchrun run wrote exactly one snapshot directory and
    logged its one step; the snapshot builds a Segmentor that segments a
    cached scene."""
    logged = _LOG_RE.findall(stdout)
    written = sorted(os.listdir(out_dir))
    if written != ["1"] or len(logged) != 1:
        raise AssertionError(f"torchrun train_net wrote {written}, logged "
                             f"{len(logged)} steps")
    cfg = Config.from_yaml(TRAIN_YML).replace(MODE="TEST")
    seg = build_segmentor(cfg, NET, pretrained=out_dir, device=DEV)
    scenes = load_resident_scenes(
        os.path.join(tmp, "render_cache",
                     f"synthetic_tabletop_train_{H}x{W}_v4"),
        limit=1, device=DEV)
    f = 0.5 * W
    img, xyz = preprocess_rgbd(scenes[0][0], scenes[1][0].float() / 1000.0,
                               cfg.pixel_means, f, f, W / 2.0, H / 2.0)
    labels = seg.segment(img[None], xyz[None], refine=False).labels
    if labels.shape != (1, H, W):
        raise AssertionError("bad segmentation from the torchrun snapshot")
    res = dict(wall_s=wall, snapshots=written, loss=float(logged[0][0]),
               instances=len(np.unique(labels)) - 1)
    print(f"[dp] torchrun --nproc_per_node 1 train_net: 1 epoch in "
          f"{wall:.1f} s (process start included, beside the gloo ranks' "
          f"start-up and small steps), loss {res['loss']}, snapshots "
          f"{written}; a Segmentor from it segmented a cached scene into "
          f"{res['instances']} instances")
    return res


def run_processes(tmp: str, training: dict, timings: dict
                  ) -> tuple[dict, dict]:
    """Phase 9's processes on the card, the ranks' and torchrun's results.
    Two gloo ranks sharing the card (NCCL refuses two ranks on one
    device): the small DP step (2 + 2 frames at SMALL_HW) within STEP_TOL
    of one process's step on the 4 frames on the card, a gate that
    per-replica BatchNorm statistics and per-rank loss scalars must each
    break; the full-width DP step (8 + 8 frames at 480x640) timed beside
    phase 6's one-process step.  tools.train_net under torchrun runs while
    the ranks start and take their small steps; the ranks time the
    full-width step only after it has ended."""
    cfg, _, bgr, depth, label, init, step, draws = small_step_inputs(
        DP_SMALL_BATCH)
    one = small_step(cfg, init, step, (bgr, depth, label), draws, DEV)
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    go = ctx.Event()
    procs = [ctx.Process(target=dp_rank, args=(r, tmp, go))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        trained = train_torchrun(tmp)
    finally:
        go.set()
        for p in procs:
            p.join(600)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(30)
    codes = [p.exitcode for p in procs]
    if alive or codes != [0, 0]:
        raise AssertionError(f"[dp] gloo ranks: exit codes {codes}")
    wall = time.perf_counter() - t0
    res = torch.load(os.path.join(tmp, "dp_rank0.pt"), weights_only=False)
    out = {"ranks_wall_s": wall, "spatial": res["spatial"]}
    for key, row in res["spatial"].items():
        mode = key.split("/")[1]
        row["batch1_stage1_ms"] = timings[mode]["stage1"]
        print(f"[spatial {key}] two gloo ranks time-sliced on one card: "
              f"{row['ms_per_frame']:.3f} ms/frame, a stand-in and not a "
              f"latency (the ranks share the card and stage each halo "
              f"through the host; NCCL refuses two ranks on one device); "
              f"phase 3's one-process batch-1 stage 1 of the ResNet "
              f"{timings[mode]['stage1']:.3f} ms/frame")
    for name in ("small", "bn_local", "loss_local"):
        row = out[name] = step_against(res[name], one)
        print(f"[dp] {name}: two gloo ranks (2 + 2 frames at "
              f"{SMALL_HW[0]}x{SMALL_HW[1]}) vs one process on the card: "
              f"{_grad_line(row['vs_cpu'])}; loss {row['loss']:.7f} vs "
              f"{one[0]:.7f}; parameters {row['param_max_abs']:.2e}; "
              f"BatchNorm statistics {row['stat_max_abs']:.2e}; breaks "
              f"{row['breaks']}")
    if out["small"]["breaks"]:
        raise AssertionError(f"the DP step differs from one process's "
                             f"beyond {STEP_TOL}: {out['small']['breaks']}")
    if not out["bn_local"]["breaks"] or not out["loss_local"]["breaks"]:
        raise AssertionError("the DP check misses a planted fault "
                             "(per-replica statistics or per-rank loss)")
    full = res["full"]
    if not np.isfinite(full["loss"]).all():
        raise AssertionError("[dp] a non-finite full-width loss")
    s_step = float(np.median(full["step_s"][1:]))
    one_s = training["timing"]["fp32"]["s_per_step"]
    out["full"] = dict(full, s_per_step=s_step, batch=TRAIN_SCENES,
                       one_process_s_per_step=one_s)
    print(f"[dp] full-width DP step, two gloo ranks on one card, "
          f"{TRAIN_SCENES // 2} + {TRAIN_SCENES // 2} frames at {H}x{W}, "
          f"fp32 Adam: {s_step:.3f} s/step (median of {DP_TIMED_STEPS} "
          f"after a warm-up; rank 0's wall with a barrier before each "
          f"step), "
          f"phase 6's one-process batch-{TRAIN_SCENES} step "
          f"{one_s:.3f} s; losses {full['loss']}; rank 0 peak "
          f"{full['peak_gib']:.2f} GiB; ranks and torchrun in {wall:.1f} s")
    return out, check_torchrun(tmp, *trained)


def run_data_parallel(cfg: Config, state_dict: dict, work: str, tmp: str,
                      training: dict, timings: dict, trained: dict) -> dict:
    """Phase 9."""
    t0 = time.perf_counter()
    out = dict(sharded=run_sharded(cfg, state_dict, work, timings, trained))
    out["ranks"], out["torchrun"] = run_processes(tmp, training, timings)
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 9 {out['phase_s']:.1f} s")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # phase 1
    card = card_line()
    print(card)
    _build.library()
    built = _build.build_seconds
    print(f"kernel build: {'reused' if built is None else f'{built:.1f} s'}"
          f" ({_build.BUILD_DIR})")

    # phase 2
    x32, z_valid = clustered_embeddings()
    checks = {mode: check_kernels(mode, x32, z_valid)
              for mode in ("parity", "fast")}
    routes_ms = {mode: check_route(mode, x32, z_valid)
                 for mode in ("parity", "fast")}
    del x32, z_valid
    x_crop, _ = clustered_embeddings(seed=2, n=CROP * CROP)
    crop_checks = {mode: check_kernels(mode, x_crop, None, where=", crop")
                   for mode in ("parity", "fast")}
    del x_crop

    # phase 3
    cfg = Config.inference_default(INPUT="RGBD")
    torch.manual_seed(0)
    state_dict = get_network("seg_resnet34_8s_embedding", cfg).state_dict()
    bgr, depth = tabletop_frame()
    img, xyz = preprocess_rgbd(torch.from_numpy(bgr).cuda(),
                               torch.from_numpy(depth).cuda(),
                               cfg.pixel_means, *INTR)
    frame = {"image_color": img, "depth": xyz}
    counts, timings, features = run_slice(cfg, state_dict, frame)

    # parity: kernel route vs plain route on the same embeddings
    kw = dict(kappa=KAPPA, num_seeds=M, max_iters=ITERS, epsilon=EPS,
              metric="cosine", first_index=4321, seed_subsample=1,
              compute_dtype="float32", filter_threshold=0.8,
              z_valid=(xyz[..., 2] > 0).reshape(N))
    feats = features.reshape(N, D)
    k_route = mean_shift_smart_init(feats, use_pallas=True, **kw)
    p_route = mean_shift_smart_init(feats, use_pallas=False, **kw)
    n_diff = int((k_route.labels != p_route.labels).sum())
    step, gap = seed_gap(feats, k_route.seed_indices, p_route.seed_indices)
    print(f"[parity] kernel route vs plain route on the slice's embeddings: "
          f"{n_diff} pixels differ; seeds first differ at step {step} "
          f"(gap {gap:.3e}); max |Z - Z_plain| "
          f"{float((k_route.seeds - p_route.seeds).abs().max()):.3e}; "
          f"{int(p_route.seed_labels.max()) + 1} seed clusters, "
          f"{len(torch.unique(p_route.labels))} label ids")
    if n_diff or step >= 0:
        raise AssertionError("the kernel route differs from the plain "
                             "route on the slice's embeddings")
    check_against_cpu(cfg, state_dict, frame)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB")

    # phase 4
    torch.manual_seed(1)
    state_dict_crop = get_network("seg_resnet34_8s_embedding",
                                  cfg).state_dict()
    segs = {"parity": Segmentor(cfg, state_dict, state_dict_crop),
            "fast": Segmentor(cfg.replace(CLUSTER=dict(FAST_CLUSTER)),
                              state_dict, state_dict_crop,
                              model_dtype=torch.bfloat16)}
    frames = stage2_frames(cfg)
    s2_counts, s2_timings, s2_memory = run_stage2(segs, frames)
    routes = check_stage2(segs, frames, state_dict_crop, cfg, frame)
    print(f"wall after phase 4 {time.perf_counter() - t_start:.1f} s")

    # phase 5
    t5 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        served, paths = load_segmentors(
            cfg, work, {"main": state_dict, "crop": state_dict_crop})
        for mode, seg in served.items():
            check_stream_frame(mode, seg)
        stream = {mode: run_stream(mode, seg) for mode, seg in served.items()}
        evaluation = {mode: run_evaluation(mode, seg, work)
                      for mode, seg in served.items()}
        boxes = box_frame_metrics(routes, segs, frames)
        cli = run_cli(work, paths["main"], served["parity"])
        serving_s = time.perf_counter() - t5
        print(f"phase 5 {serving_s:.1f} s; wall "
              f"{time.perf_counter() - t_start:.1f} s")
        del segs, served, routes
        torch.cuda.empty_cache()

        with tempfile.TemporaryDirectory() as tmp:
            # phase 6
            training = run_training(tmp)
            print(f"wall after phase 6 {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 7: phase 5's .pth files through tools.test_net
            data = run_data(work, paths)
            print(f"wall after phase 7 {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 8
            alternates = run_alternates(frame)
            print(f"wall after phase 8 {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 8b: phase 5's .pth of phase 3's random-init ResNet
            trained = run_trained(tmp, paths["main"])
            print(f"wall after phase 8b {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 9: phase 3's weights and timings, phase 8's U-Net,
            # phase 6's render cache, phase 7's OCID tree and phase 8b's
            # trained ResNet
            data_parallel = run_data_parallel(cfg, state_dict, work, tmp,
                                              training, timings, trained)
            print(f"wall after phase 9 {time.perf_counter() - t_start:.1f}"
                  " s")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        par, fast = checks["parity"][name], checks["fast"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts["parity"][name], fast_launches=counts["fast"][name],
            stage2_launches=s2_counts["parity"][name],
            fast_stage2_launches=s2_counts["fast"][name],
            serving_launches=stream["parity"]["launches"][name],
            fast_serving_launches=stream["fast"]["launches"][name],
            data_launches={k.split("/", 1)[1]: v["launches"][name]
                           for k, v in data["test_net"].items()
                           if k.startswith("parity/")},
            fast_data_launches={k.split("/", 1)[1]: v["launches"][name]
                                for k, v in data["test_net"].items()
                                if k.startswith("fast/")},
            alternates_launches={net: r["launches"][name]
                                 for net, r in alternates.items()},
            dp_launches=data_parallel["sharded"]["parity"]["launches"][name],
            fast_dp_launches=data_parallel["sharded"]["fast"]["launches"][
                name],
            dp_ocid_launches=data_parallel["sharded"]["ocid"]["launches"][
                name],
            dp_unet_launches=data_parallel["sharded"][
                f"{ALT_NETS[0][0]}/parity"]["launches"][name],
            fast_dp_unet_launches=data_parallel["sharded"][
                f"{ALT_NETS[0][0]}/fast"]["launches"][name],
            spatial_launches={
                key: row["launches"][name] for key, row in
                data_parallel["ranks"]["spatial"].items()},
            spatial_world1_launches=data_parallel["sharded"][
                "spatial_world1"][f"{NET}/parity"]["launches"][name],
            trained_launches=trained["report"]["launches"]["parity"][name],
            fast_trained_launches=trained["report"]["launches"]["fast"][
                name],
            dp_trained_launches=data_parallel["sharded"]["trained/parity"][
                "launches"][name],
            fast_dp_trained_launches=data_parallel["sharded"][
                "trained/fast"]["launches"][name],
            max_abs_err=par["max_abs_err"],
            ms=par["ms"], plain_ms=par["plain_ms"], bound_ms=par["bound"][0],
            bound_by=par["bound"][1], library_ms=None,
            device_ms=par["device_ms"], fast_device_ms=fast["device_ms"],
            fast_max_abs_err=fast["max_abs_err"], fast_ms=fast["ms"],
            fast_plain_ms=fast["plain_ms"], fast_bound_ms=fast["bound"][0],
            fast_bound_by=fast["bound"][1]))
        for mode, prefix in (("parity", "crop_"), ("fast", "fast_crop_")):
            r = crop_checks[mode][name]
            kernels[-1].update({
                prefix + "max_abs_err": r["max_abs_err"],
                prefix + "ms": r["ms"], prefix + "device_ms": r["device_ms"],
                prefix + "plain_ms": r["plain_ms"],
                prefix + "bound_ms": r["bound"][0],
                prefix + "bound_by": r["bound"][1]})
        if name == "connected_components":
            kernels[-1].update(
                merge_steps=par["merge_steps"],
                fast_merge_steps=fast["merge_steps"],
                pairwise_far_ms=par["far_ms"],
                pairwise_far_device_ms=par["far_device_ms"],
                fast_pairwise_far_ms=fast["far_ms"],
                fast_pairwise_far_device_ms=fast["far_device_ms"],
                pairwise_far_merge_steps=par["far_merge_steps"])
    print(json.dumps({"stage1_ms": timings, "cluster_ms_clustered_input":
                      routes_ms, "stage2_ms": s2_timings,
                      "stage2_peak_gib": s2_memory}))
    print(json.dumps({"serving": {
        "stream": stream, "evaluation": evaluation,
        "box_frames_refined": boxes, "test_npy_objects": cli,
        "phase_s": serving_s}}))
    print(json.dumps({"training": training}))
    print(json.dumps({"data": {
        "png_decode_ms_per_frame": data["png_decode_ms_per_frame"],
        "pcd_load_ms": data["pcd"],
        "test_net_s_per_frame": {k: v["s_per_frame"]
                                 for k, v in data["test_net"].items()},
        "test_net": data["test_net"], "trees": data["trees"],
        "native_build_s": data["native_build_s"],
        "render_wall_s": data["render"]["wall_s"],
        "write_trees_s": data["write_trees_s"],
        "demo_gt_ids": data["demo_gt_ids"],
        "image_tools": data["image_tools"], "phase_s": data["phase_s"]}}))
    print(json.dumps({"alternates": alternates}))
    print(json.dumps({"trained": trained}))
    print(json.dumps({"data_parallel": data_parallel}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
