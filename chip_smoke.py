#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is caught):
  1. the card's name and power limit; build the CUDA kernels from
     unseenobjectclustering_torch/csrc and report the build time.
  2. each kernel against its plain PyTorch version on the card, at the
     stage-1 shapes (n = 480*640 pixels, d = 64, m = 100 seeds) and at
     stage 2's crop shapes (n = 224*224 and, for the 128^2 zoom-in
     network, n = 128*128), on clustered unit embeddings made
     from a numpy seed, in parity mode (float32, stride-1 seeding) and fast
     mode (bfloat16, stride-8 seeding); the connected components also on
     pairwise-far seeds (each its own cluster: the most merge steps); the
     launch configuration of the seeding, hill-climb and assignment kernels
     at each shape; the merge steps of the connected components; the pixels
     the assignment re-checked exactly; median CUDA-event times of one
     wrapper call and of the plain version (host latency included) beside
     the bound computed from the shapes, and each kernel's own device time
     from torch.profiler; beside the hill climb its yardstick (library_ms:
     one timed run of 10 calls of torch's scaled_dot_product_attention with
     scale kappa and a row norm, which compute the same function; the
     backend that ran is named; in parity its Z must be within Z_TOL of the
     plain version's; the port never calls it).  Then the whole clustering
     (mean_shift_smart_init with the 0.8 depth filter) on the stage-1
     embeddings, kernel route against plain route, timed.
  3. stage 1 through Segmentor.segment_sample: seg_resnet34_8s_embedding,
     RGB-D, add fusion, 64-D embeddings, 480x640, weights from a fixed-seed
     init; a few frames in each mode, every launch counter reset just
     before each frame and read just after it, and every kernel launched
     in each frame of each mode; the outputs checked; in parity mode the kernel
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
 7b. the data path without OpenCV, with sys.modules["cv2"] and
     sys.modules["PIL"] set to None for the length of the phase: the JPEG
     library (unseenobjectclustering_torch/csrc/jpeg.cpp) built with g++
     (its seconds); every JPEG of tests/torch_fixtures/tabletop decoded by
     utils/jpeg.py with the digest of cv2.imread recorded in its
     digests.json (the progressive one must raise), and the decode ms of
     a 480x640 frame (median of 20); every TableTop sample of the fixture
     tree (TEST, TRAIN with the rgbd_add recipe, TRAIN with SYN_CROP at 224,
     epochs 0 and 1) with every array's digest equal to the JAX reader's
     recorded there; the host loader's samples/s over DataLoader(
     num_workers=4, batch 2) over an epoch of 16 samples from 480x640
     frames and steady (after its second batch), for tabletop_object_train
     (the fixture tree) and synthetic_tabletop_train (host-augmented on
     phase 6's render cache, DEPTH_ARTIFACTS on), and each stage's ms per
     sample in one thread (decode, depth noise and ellipses, XYZ noise,
     crop, chromatic and noise), there and with the crop recipe (TableTop
     cropped at 224); tools.train_net.main() on its default
     host-augmented route: the rgbd_add recipe with --bf16 at batch 16 on
     phase 6's cache for 2 steps (one-batch epochs) and the crop recipe on
     the fixture tree's training_set at batch 4 for 1 epoch (finite
     losses, a snapshot written, no clustering kernel launched); the host
     route's steady step at batch 4 (steps 3-8 of an epoch under
     torch.profiler, the loader two batches ahead: ms a step and a
     sample, idle share) beside phase 6's resident step;
     tools.test_net.main() on
     tabletop_object_test with phase 5's .pth files in parity and fast
     (each kernel at least once per frame; the launches join the kernels
     line's data_launches).  Nothing is caught.  One
     {"data_no_opencv": {...}} line.
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
 8r. (run after phase 8b, whose render cache it reads) ResNet-50-8s, the
     JAX package's third backbone: seg_resnet50_8s_embedding (two dilated
     towers of (3, 4, 6, 3) bottleneck blocks, RGB-D add, 64 units) from a
     fixed-seed init.  (a) stage 1 on phase 3's 480x640 frame through
     Segmentor.segment_sample in both modes, a warm-up and R50_FRAMES
     timed frames, the counters set to 0 before each frame and read after
     it (every kernel in each frame), unit finite embeddings, labels of
     shape (1, 480, 640); network, cluster and stage-1 ms and the peak
     device memory per mode; the parity network against the CPU on a
     64x96 window within ALT_TOL; kernel route against plain route on the
     parity frame's embeddings.  (b) tools.test_net.main() with --network
     seg_resnet50_8s_embedding on phase 7's synthetic tree (SYN_FRAMES
     frames a mode; each kernel exactly once per frame; the .mat files
     equal the labels).  (c) one float32 SGD step at 128x160 on the card
     against the CPU within R50_STEP_TOL (its own limits: ResNet-50's
     float32 gradients break STEP_TOL's parameter limit), with both
     planted faults (TF32 on; R50_FAULT_TENSOR's gradient zeroed) breaking
     it; the recipe's resident step (RECIPE_YML, bf16, batch 16 at
     240x320) timed by part with its peak memory and idle share; and
     tools.train_net.main() with --network seg_resnet50_8s_embedding on
     RECIPE_YML for one epoch of R50_TRAIN_SCENES / 16 steps (no
     clustering kernel launched).  One {"resnet50": {...}} line.
 8c. trained zoom-in networks: the JAX repo's two crop recipes
     (CROP_NETS: ResNet-34-8s at 224^2 and ResNet-18-8s at 128^2, Adam
     2e-4, batch 16, SYN_CROP with depth artifacts) trained from scratch
     on phase 8b's cache through tools.train_net.main() with --bf16
     --device-resident, cut to CROP_EPOCHS epochs each (the step ms; no
     clustering kernel launched); tools.test_net.main() two-stage on the
     HELD_OUT scenes with phase 8b's stage-1 snapshot and each crop
     snapshot (--network_crop, --crop_size) in parity and with --fast,
     every kernel launched exactly once per frame for stage 1 and once
     per valid crop, the .mat files equal the labels: stage-1 and refined
     Objects F, Boundary F and %75 detected, the refined segment median
     ms, the stage-2 ms by part and crop bucket, gated: an instance in
     every held-out frame after refinement in parity, refined parity
     mean Objects F at least TRAINED_FLOOR and within REFINE_DROP of stage
     1's, fast's within FAST_GAP of parity's; the same in parity with
     phase 4's random-init crop network (phase 5's .pth), which must miss
     the floor; on the trained crop embeddings of every valid crop of the
     held-out frames, each network and mode (n = 224*224 and 128*128),
     every kernel against its plain version (the seeds may part at a
     float32 near-tie, below SEED_GAP; the hill climb held to its
     float64 result: within Z_TOL in parity, where the float32 plain
     version is itself up to 2.5e-5 from it; in fast mode no farther from
     it than the plain version, plus Z_TOL), each crop's hill-climb
     readings printed, each frame's crop clustering launching each kernel
     exactly once per valid crop and in parity equal to its plain route
     in seeds (but where they part at a seeding near-tie, below
     SEED_GAP), seed labels and every pixel but those certified as
     near-ties (near_ties), and tools.probe_seed_precision.main() on one
     crop (both routes PASS).  One {"two_stage": {...}} line.
 2c. (run after phase 8c, whose render cache it reads) the JAX repo's
     rgbd_cat recipes: FUSION_TYPE cat concatenates the two towers'
     64-D outputs into 128-D embeddings, which the kernels' width-128
     instantiations take.  (a) each kernel against its plain version at
     the frame and both crop shapes in both modes, with phase 2's checks,
     tolerances, launch configurations and times beside the bound, and
     the seeding's path (lazy tiles at the parity frame, eager elsewhere),
     tile size and share of tiles refreshed a step (mean, largest); (a')
     the lazy seeding in parity on random unit vectors at the frame (seeds
     equal to the plain version's or parting below SEED_GAP; path, share,
     times, bound); (b)
     stage 1 through Segmentor.segment_sample with the cat network of
     experiments/cfgs/seg_resnet34_8s_embedding_cosine_rgbd_cat_tabletop
     .yml at 480x640 (fixed-seed init) in both modes, the counters set to
     0 before each mode's frames and read after (every kernel launched),
     in parity the kernel route's labels equal to the plain route's on
     the same embeddings; stage 2 with a cat crop network at 224x224 on
     phase 4's 8/16/32-box frames in both modes (each kernel once per
     valid crop; parity's kernel route = plain route); (c)
     tools.test_net.main() with that yml on the committed TableTop tree
     in both modes (each kernel exactly once a frame and per valid
     crop); (d) unseenobjectclustering_torch/cfgs/
     synthetic_240x320_rgbd_cat.yml trained on phase 8b's cache (CAT_EPOCHS,
     bf16, device-resident) and, on CAT_FRAMES held-out frames' 128-D
     embeddings, every kernel against its plain version in both modes
     with the hill climb held to the float64 replay within Z_TOL, the
     seeds exact or parting below SEED_GAP, and parity's kernel route's
     labels equal to the plain route's but at certified near-ties; the
     assignment's pixels re-checked exactly per frame and mode.  One
     {"cat": {...}} line.
 2d. (run after phase 2c, on phase 8b's render cache) the JAX repo's
     COLOR, DEPTH and RGB-D early-fusion recipes, one tower each (the
     image; the XYZ image; both as 6 channels).  (a) each kernel against
     its plain version at the frame (n = 480*640, d = 64) with no depth
     mask, as a COLOR frame's stage 1 runs the assignment, in both modes
     with phase 2's checks, tolerances and times beside the bound, and the
     whole clustering with filter_threshold 0, kernel route against plain
     route; (b) for each modality, stage 1 through Segmentor.segment_sample
     with the network of experiments/cfgs/seg_resnet34_8s_embedding_
     cosine_<modality>_tabletop.yml (fixed-seed init) at 480x640 in both
     modes (COLOR passes no XYZ, so no depth filter; DEPTH no image), the
     counters set to 0 before each mode's frames and read after (every
     kernel launched), in parity the kernel route's labels equal to the
     plain route's on the same embeddings; (c) stage 2 with the network
     of the modality's crop yml on phase 4's 8-box frame in both modes
     (the missing modality's crops zeros; COLOR's paste ordered by RoI
     area; each kernel once per valid crop; parity's kernel route = plain
     route); (d) tools.test_net.main() with the modality's yml on the
     committed TableTop tree in both modes (each kernel exactly once a
     frame and per valid crop); (e) unseenobjectclustering_torch/cfgs/
     synthetic_240x320_color.yml trained on phase 8b's cache
     (COLOR_EPOCHS, bf16, device-resident) and, on CAT_FRAMES held-out
     frames' trained embeddings (clustered without the depth filter),
     every kernel against its plain version in both modes with the hill
     climb held to the float64 replay, and parity's kernel route's labels
     equal to the plain route's but at certified near-ties.  One
     {"modalities": {...}} line.
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
     test_net run, of the alternate networks, of phase 8r's stage 1 and
     test_net runs (resnet50_*), of phase 8b's report, of
     phase 9's sharded stage 1 and evaluation and of its spatial stage 1
     (rank 0's, per network and mode, and at world size 1), of phase 8c's
     two-stage test_net runs per crop network and mode, its times and
     bounds in both modes at the frame and both crop shapes; then each
     kernel's width-128 instantiation (name suffixed _d128) with its
     launches on phase 2c's stage 1, stage 2 and test_net runs and its
     readings from phase 2c (a) (the seeding's also its path, tile and
     refreshed share per mode, and (a')'s uniform_* readings; the
     connected components' and the assignment's also the kernel each mode
     launches: cc_cluster_kernel, assign_tf32_wide_kernel<104>,
     assign_bf16_wide_kernel<104>).  The hill-climb, connected-components
     and assignment entries also hold their launch configuration (the
     latter two with the kernel's name; the cluster's CTAs) at every
     shape and mode, and the hill climb's library_ms (the yardstick
     above, with its backend).  The width-64 entries also hold their
     launches on phase 2d's paths per modality and mode
     (modality_launches) and their readings at the frame without a depth
     mask (unfiltered_*, phase 2d (a)).
 11. the last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.  Without a CUDA device, or
outside a checkout of the repository, it exits non-zero with no result.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import importlib.util
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
from unseenobjectclustering_torch.data.loader import (DataLoader,
                                                      stack_samples)
from unseenobjectclustering_torch.data.resident import load_resident_scenes
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)
from unseenobjectclustering_torch.engine.builder import (build_segmentor,
                                                         load_network_state)
from unseenobjectclustering_torch.engine.evaluate import (
    average_metrics, evaluate_dataset, evaluate_dataset_sharded)
from unseenobjectclustering_torch.engine.pipeline import (Segmentor,
                                                          _cluster_batch,
                                                          _cluster_crops,
                                                          _full_fp32, _split)
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
from unseenobjectclustering_torch.data import augmentation
from unseenobjectclustering_torch.data import datasets as data_datasets
from unseenobjectclustering_torch.utils import jpeg, png
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
# a seed flip is allowed below this min-distance gap: fast mode's seeding,
# and phase 8c's seeding on trained crops in parity (the kernel's exact
# fp32 dot chains against the plain version's matrix products)
SEED_GAP = 1e-6
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
# phase 7b: the committed TableTop tree, its JPEG corpus and digests.json
TABLETOP = os.path.join(REPO, "tests", "torch_fixtures", "tabletop")
LOADER_WORKERS = 4
# phase 7b: the loader's epoch of 8 batches and the host route's epoch of
# 8 steps.  With two batches in flight, batches 1-2 are assembled
# together, then 3-4, and so on, so the batches after the second, over the
# time after it, read the steady rate when their number is even.
LOADER_BATCH, LOADER_SAMPLES = 2, 16
HOST_STEP_BATCH, HOST_STEP_SAMPLES = 4, 32
STAGE_SAMPLES = 8  # phase 7b: samples a dataset's stages are timed over
TABLETOP_FRAMES = 2  # phase 7b: tabletop_object_test frames per mode
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
# phase 8c: the JAX repo's two zoom-in recipes (yml, network), each
# trained on phase 8b's cache (bf16, device-resident) for CROP_EPOCHS of
# TRAINED_SCENES / 16 steps, then evaluated two-stage with phase 8b's
# stage 1 on the HELD_OUT scenes; refined parity mean Objects F is gated
# by TRAINED_FLOOR and by REFINE_DROP below stage 1's, fast's by
# FAST_GAP, and every held-out frame keeps an instance after refinement
# in parity; a random-init crop network (REFINE_FALLBACK off, the JAX
# default: its vetoed crops delete their instances) must miss the floor.
# On an NVIDIA H100 80GB HBM3 (700.00 W) the 15-epoch networks read
# refined parity / fast Objects F 0.4777 / 0.4560 (224^2) and 0.4778 /
# 0.4808 (128^2) against stage 1's 0.6243 (10 epochs: 0.4224, 0.4718;
# 20: 0.5468, 0.5442), and 0 with the random-init crop network (PERF.md,
# two-stage findings)
CROP_NETS = {
    "crop224_r34": ("unseenobjectclustering_torch/cfgs/"
                    "synthetic_crop_240x320_rgbd_add.yml",
                    "seg_resnet34_8s_embedding"),
    "crop128_r18": ("unseenobjectclustering_torch/cfgs/"
                    "synthetic_crop128_r18_240x320_rgbd_add.yml",
                    "seg_resnet18_8s_embedding"),
}
CROP_SIDES = {name: int(Config.from_yaml(os.path.join(REPO, yml)).TRAIN[
    "SYN_CROP_SIZE"]) for name, (yml, _) in CROP_NETS.items()}
CROP_EPOCHS = 15
REFINE_DROP = 0.2
STAGE2_PARTS = ("crops", "network", "cluster", "veto", "fetch", "paste")
# phase 2c: the JAX repo's rgbd_cat recipes (FUSION_TYPE cat: the two
# towers' NUM_UNITS = 64 outputs concatenated into CAT_D-dim embeddings),
# the kernels' width-128 instantiations; CAT_RECIPE_YML trained on phase
# 8b's render cache for CAT_EPOCHS epochs of TRAINED_SCENES / 16 steps,
# its kernels checked on CAT_FRAMES held-out frames
CAT_D = 128
CAT_YML = ("experiments/cfgs/"
           "seg_resnet34_8s_embedding_cosine_rgbd_cat_tabletop.yml")
CAT_RECIPE_YML = ("unseenobjectclustering_torch/cfgs/"
                  "synthetic_240x320_rgbd_cat.yml")
CAT_EPOCHS = 10
CAT_FRAMES = 4
# phase 2d: the JAX repo's COLOR, DEPTH and RGB-D early-fusion recipes
# (one tower each: the image, the XYZ image, or both concatenated into 6
# channels); COLOR clusters stage 1 without the depth filter, so the
# kernels also run unfiltered at the frame; COLOR_RECIPE_YML trained on
# phase 8b's render cache for COLOR_EPOCHS epochs, its kernels checked on
# CAT_FRAMES held-out frames
MODALITIES = ("color", "depth", "rgbd_early")
MODALITY_FRAMES = 2  # timed stage-1 frames per modality and mode
COLOR_RECIPE_YML = ("unseenobjectclustering_torch/cfgs/"
                    "synthetic_240x320_color.yml")
COLOR_EPOCHS = 10
# phase 8r: the JAX package's third backbone, ResNet-50-8s (two dilated
# towers of (3, 4, 6, 3) bottleneck blocks, 2048 channels at 60x80), RGB-D
# add with 64 units; R50_FRAMES timed stage-1 frames per mode after a
# warm-up; its card-vs-CPU step with the depth tower's conv1 zeroed as the
# planted fault; tools.train_net for one epoch of R50_TRAIN_SCENES / 16
# steps on phase 8b's cache
R50 = "seg_resnet50_8s_embedding"
R50_FRAMES = 1
R50_FAULT_TENSOR = "fcn_depth.resnet50_8s.conv1.weight"
# ResNet-50's float32 gradients are noisier: its sound card-vs-CPU step
# reads up to 2.2e-2 / 1.8e-2 / 3.3e-2 (vector / median tensor / largest
# tensor) and parameters 6.4e-6, which break STEP_TOL's param_atol; its
# limits lie about 4x above those readings, as STEP_TOL's do, and below
# both planted faults' on the H100 over three draw seeds (step_study.py;
# PERF.md, ResNet-50 findings): TF32 at least 0.51 / 0.47 / 0.63 and
# parameters 7.8e-5, zeroed 0.26 / - / 1.0
R50_STEP_TOL = dict(STEP_TOL, grad_rel_l2=9e-2, grad_median_rel_l2=7e-2,
                    param_atol=2.5e-5)
R50_TRAIN_SCENES = 48

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
                "connected_components": "cc_",
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
    """Device time per launch of the CUDA kernels whose name holds `name`
    (torch.profiler) over reps calls of fn (one launch each), after one
    warm-up call: the kernel's own time, without the host latency that
    time_ms includes.  The time is averaged over the launches the window
    recorded: the profiler drops some launches' device events now and then
    (the width-128 seeding kernel read 1.61 and 0.08 ms where its CUDA
    events gave 5.4 and 0.32 ms a call, on the H100), and a note says when
    it recorded fewer than reps.  A window that shows none (twice in seven
    runs of this script, both at the 0.01 ms connected-components kernel)
    is profiled again, up to `tries` windows in all; when none of them
    shows it (three windows in a row once, at that kernel late in the
    script), the time comes from queued_ms instead, and a note says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if name in e.key]
        us = sum(e.device_time_total for e in events)
        count = sum(e.count for e in events)
        if us > 0:
            if count != reps:
                print(f"device_ms: {count} of {reps} launches of {name} "
                      "recorded; averaged over those")
            return us / count / 1e3
        print(f"device_ms: a profiler window without {name}'s device "
              "events; profiling again")
    ms = queued_ms(fn, reps)
    print(f"device_ms: the profiler saw no device time for {name} in "
          f"{tries} windows; {ms:.4f} ms from CUDA events around {reps} "
          "queued calls")
    return ms


def queued_ms(fn, reps: int, cycles: int = 20_000_000) -> float:
    """Device time per call of fn from CUDA events around reps calls that
    the host queues while a sleep kernel holds the stream, so that the
    events see the device's work back to back and none of the host's
    latency.  fn must not wait for the device.  The sleep doubles until it
    outlasts the host's queueing, at most five times."""
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        queued = time.perf_counter()
        for _ in range(reps):
            fn()
        queued = (time.perf_counter() - queued) * 1e3
        marks[2].record()
        marks[2].synchronize()
        if queued < marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / reps
        cycles *= 2
    raise AssertionError(f"queued_ms: the host took {queued:.3f} ms to "
                         f"queue {reps} calls, longer than every sleep")


def bound(nbytes: float, ops: float, dtype: torch.dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clustered_embeddings(seed: int = 0, k: int = 12, n: int = N, d: int = D
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """[n, d] unit embeddings around k centers (one large background
    cluster), and a [n] validity mask with one mostly-invalid cluster."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    prob = np.full(k, 1.0)
    prob[0] = 6.0
    assign = rng.choice(k, size=n, p=prob / prob.sum())
    x = centers[assign] + 0.3 * rng.randn(n, d) / np.sqrt(d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    z_valid = rng.rand(n) > 0.05
    z_valid[assign == 3] = rng.rand(int((assign == 3).sum())) > 0.7
    return (torch.from_numpy(x.astype(np.float32)).cuda(),
            torch.from_numpy(z_valid).cuda())


def pairwise_far_seeds(seed: int = 1, d: int = D) -> torch.Tensor:
    """[M, d] random unit seeds, every pair far outside EPS (cosine
    distance about 0.5): each seed is its own cluster."""
    z = np.random.RandomState(seed).randn(M, d)
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


def hill_climb_exact(x: torch.Tensor, z0: torch.Tensor) -> torch.Tensor:
    """The plain hill climb's arithmetic in float64 on float32 x: the
    exact result, to which both routes' float32 roundings are compared."""
    x, z = x.double(), z0.double()
    for _ in range(ITERS):
        v = torch.exp(KAPPA * (z @ x.T)) @ x
        z = v / v.norm(dim=1, keepdim=True)
    return z


def seed_path(x: torch.Tensor) -> dict:
    """The seeding kernel's path for x and, on the lazy path, the mean and
    largest share of its tiles that the last launch refreshed a step
    (steps 1 on)."""
    plan = cuda_seeding.launch_config(x)
    out = dict(seed_path="lazy" if plan["lazy"] else "eager",
               tile_pixels=plan["tile_pixels"])
    if plan["lazy"]:
        out["refreshed_share"] = cuda_seeding.refresh_shares(
            cuda_seeding.refreshed)
    return out


def path_text(path: dict) -> str:
    if path["seed_path"] == "eager":
        return "path eager (every pixel on chip, or d = 64)"
    mean, top = path["refreshed_share"]
    return (f"path lazy, {path['tile_pixels']}-pixel tiles, share of tiles "
            f"refreshed a step mean {mean:.4f}, max {top:.4f}")


def sdpa_hill_climb(x: torch.Tensor, z0: torch.Tensor) -> torch.Tensor:
    """The hill climb as one PyTorch call an iteration, the yardstick of
    the hill-climb kernels (library_ms; the port never calls it).
    softmax(kappa Z X^T) X is exp(kappa Z X^T) X with each row scaled by a
    positive number, so scaled_dot_product_attention(Z, X, X,
    scale=kappa) followed by a row normalisation is rownorm(exp(kappa Z
    X^T) X).  Z is rounded to X's type for each call, as the bf16 kernel
    rounds it; the inputs are [1, 1, m or n, d]: one batch, one head."""
    xs = x[None, None]
    z = z0.float()
    for _ in range(ITERS):
        v = torch.nn.functional.scaled_dot_product_attention(
            z.to(x.dtype)[None, None], xs, xs, scale=KAPPA)[0, 0].float()
        z = v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)
    return z


def sdpa_yardstick(x: torch.Tensor, z0: torch.Tensor
                   ) -> tuple[float, str, torch.Tensor]:
    """The hill climb's yardstick at x's shape, at the least cost: one
    profiled call (its warm-up, and which of scaled_dot_product_attention's
    backends ran, from the names of the device kernels it launched), then
    one call timed with CUDA events (ms).  Returns the ms, the backend and
    the profiled call's Z."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        z = sdpa_hill_climb(x, z0)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages()).lower()
    backend = next((b for b, keys in (("flash", ("flash",)),
                                      ("cudnn", ("cudnn",)),
                                      ("efficient", ("fmha", "efficient",
                                                     "cutlass")))
                    if any(k in names for k in keys)), "math")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    sdpa_hill_climb(x, z0)
    end.record()
    end.synchronize()
    return start.elapsed_time(end), backend, z


def check_kernels(mode: str, x32: torch.Tensor,
                  z_valid: torch.Tensor | None, where: str = "",
                  timed: bool = True, against_exact: bool = False,
                  far: bool = True) -> dict[str, dict]:
    """Phase 2 for one mode at x32's shape ([n, d]): every kernel against
    its plain version, and with `timed` each one's times beside its
    bound.  z_valid (the stage-1 depth mask) goes to the assignment when
    given; stage 2 has none.  The seeds must be equal, but in fast mode,
    with `against_exact` (trained embeddings) and at width CAT_D (the
    kernel's sequential 128-term float32 chains and the plain version's
    cuBLAS sums round apart: in parity at the 224^2 crop's clustered input
    on the H100 the two picked pixels whose min-distances were 2^-25
    apart) they may part where the plain version's min-distance gap
    between the two picks is below SEED_GAP, a float32 near-tie (the
    checks after it start from the plain version's seeds).  In parity, and
    in fast mode with `against_exact`, the hill climb's Z is also compared
    with the float64
    result on the same X (hill_climb_exact).  With `against_exact` the
    hill climb is held to that result instead of to its plain version: in
    parity within Z_TOL (on trained crop embeddings the plain float32
    version is itself up to 2.5e-5 from it); in fast mode no farther from it
    than the plain version, plus Z_TOL (both round Z and W to bf16 and
    are up to 2e-2 from it; where a rounding falls differently the two
    part by up to 1.1e-3).  `far` adds the connected components on
    pairwise-far seeds, an input that does not depend on x32."""
    dtype = torch.float32 if mode == "parity" else torch.bfloat16
    sub = 1 if mode == "parity" else int(FAST_CLUSTER["SEED_SUBSAMPLE"])
    x = x32.to(dtype)
    n, d = x.shape
    x_seed = x[::sub]
    n_seed = x_seed.shape[0]
    first = 12345 % n_seed
    esize = x.element_size()
    out: dict[str, dict] = {}
    calls = {}  # each kernel's wrapper call, its plain call, timed reps
    tag = mode + where  # the tag of this check's lines

    if timed:
        print(f"[{tag}] select_seeds launch (n = {n_seed}): "
              f"{json.dumps(cuda_seeding.launch_config(x_seed))}")
        print(f"[{tag}] hill_climb launch (n = {n}): "
              f"{json.dumps(cms.hill_climb_config(x, M))}")
        print(f"[{tag}] assign_labels launch (n = {n}): "
              f"{json.dumps(cms.assign_labels_config(x, M))}")
        print(f"[{tag}] connected_components launch (m = {M}): "
              f"{json.dumps(cms.connected_components_config(x[:M]))}")
    got_s, got_i = cuda_seeding.select_seeds(x_seed, M, first)
    path = seed_path(x_seed)
    want_s, want_i = cuda_seeding.select_seeds_reference(x_seed, M, first)
    step, gap = seed_gap(x_seed, got_i, want_i)
    print(f"[{tag}] select_seeds: first differing step {step}, "
          f"min-distance gap there {gap:.3e}; {path_text(path)}")
    if step >= 0 and not ((mode == "fast" or against_exact or d == CAT_D)
                          and gap < SEED_GAP):
        raise AssertionError(f"[{tag}] seeding differs at step {step} "
                             f"(gap {gap:.3e})")
    ops = 2.0 * (M - 1) * n_seed * d
    nbytes = n_seed * d * esize + M * (d * esize + 4)
    calls["select_seeds"] = (
        lambda: cuda_seeding.select_seeds(x_seed, M, first),
        lambda: cuda_seeding.select_seeds_reference(x_seed, M, first), 10)
    out["select_seeds"] = dict(
        max_abs_err=float((got_s.float() - want_s.float()).abs().max())
        if step < 0 else float(gap), differing_step=step,
        bound=bound(nbytes, ops, dtype), **path,
        # the eager kernel reads X again at every step (the lazy one does not)
        **({} if path["seed_path"] == "lazy" else dict(
            rereads_ms=(M - 1) * n_seed * d * esize / HBM_BYTES_PER_S * 1e3)))

    z0 = want_s.float()
    got_z = cms.hill_climb(x, z0, kappa=KAPPA, max_iters=ITERS)
    want_z = cms.hill_climb_reference(x, z0, kappa=KAPPA, max_iters=ITERS)
    err = float((got_z - want_z).abs().max())
    errs = {"plain": err}
    if mode == "parity" or against_exact:
        exact = hill_climb_exact(x, z0)
        errs["exact"] = float((got_z.double() - exact).abs().max())
        errs["plain_exact"] = float((want_z.double() - exact).abs().max())
    print(f"[{tag}] hill_climb: max |Z - Z_plain| = {err:.3e}"
          + (f"; max |Z - Z_exact| = {errs['exact']:.3e}, the plain "
             f"version's {errs['plain_exact']:.3e}" if "exact" in errs
             else ""))
    if not against_exact:
        held, what = errs["plain"], "from the plain version"
    elif mode == "parity":
        held, what = errs["exact"], "from the float64 result"
    else:
        held = errs["exact"] - errs["plain_exact"]
        what = "farther than the plain version from the float64 result"
    if not held <= Z_TOL[mode]:
        raise AssertionError(f"[{tag}] hill_climb {held:.3e} {what} > "
                             f"{Z_TOL[mode]}")
    ops = ITERS * 4.0 * M * n * d
    nbytes = n * d * esize + 2 * M * d * 4
    calls["hill_climb"] = (
        lambda: cms.hill_climb(x, z0, kappa=KAPPA, max_iters=ITERS),
        lambda: cms.hill_climb_reference(x, z0, kappa=KAPPA,
                                         max_iters=ITERS), 10)
    out["hill_climb"] = dict(max_abs_err=err, bound=bound(nbytes, ops, dtype),
                             # a design that streams X reads it every
                             # iteration (the bound above counts it once)
                             rereads_ms=ITERS * n * d * esize
                             / HBM_BYTES_PER_S * 1e3,
                             **{f"{k}_err": v for k, v in errs.items()
                                if k != "plain"})

    z = want_z
    inputs = {"clustered": z}
    if far:
        inputs["pairwise-far"] = pairwise_far_seeds(d=d)
    cc = {}  # input -> (plain labels, merge steps)
    for name, zin in inputs.items():
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
    if far and int(cc["pairwise-far"][0].max()) + 1 != M:
        raise AssertionError(f"[{tag}] pairwise-far seeds were merged")
    calls["connected_components"] = (
        lambda: cms.connected_components(z, EPS),
        lambda: cms.connected_components_reference(z, EPS), 20)
    out["connected_components"] = dict(
        max_abs_err=0.0,
        bound=bound(M * d * 4 + M * 4, 2.0 * M * M * d, torch.float32),
        merge_steps=cc["clustered"][1],
        far_merge_steps=cc["pairwise-far"][1] if far else None)

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
    ops = 2.0 * M * n * d
    nbytes = (n * d * esize + n * (4 + (z_valid is not None))
              + M * (d * 4 + 4 + 8))
    calls["assign_labels"] = (
        lambda: cms.assign_labels(x, z, slab, z_valid=z_valid),
        lambda: cms.assign_labels_reference(x, z, slab, z_valid=z_valid), 10)
    out["assign_labels"] = dict(max_abs_err=0.0,
                                bound=bound(nbytes, ops, dtype),
                                rechecked=rechecked)
    if not timed:
        return out
    out["connected_components"].update(
        launch=cms.connected_components_config(z))
    out["assign_labels"].update(launch=cms.assign_labels_config(x, M))
    for name, (call, plain, reps) in calls.items():
        out[name].update(ms=time_ms(call, reps), plain_ms=time_ms(plain, 3))
    # the yardstick takes up to 0.3 s a call in float32 at the frame on an
    # H100 (it does not split the keys over blocks): one timed call; in
    # parity its Z is held to the plain version's
    lib_ms, backend, lib_z = sdpa_yardstick(x, z0)
    lib_err = float((lib_z - want_z).abs().max())
    out["hill_climb"].update(launch=cms.hill_climb_config(x, M),
                             library_ms=lib_ms, library_backend=backend,
                             library_err=lib_err)
    print(f"[{tag}] hill_climb yardstick: scaled_dot_product_attention "
          f"({backend}) and a row norm, {ITERS} times: {lib_ms:.4f} ms, "
          f"max |Z - Z_plain| = {lib_err:.3e}")
    if mode == "parity" and not lib_err <= Z_TOL[mode]:
        raise AssertionError(f"[{tag}] the hill climb's yardstick is "
                             f"{lib_err:.3e} from the plain version")
    far_call = functools.partial(cms.connected_components,
                                 inputs["pairwise-far"], EPS)
    out["connected_components"].update(
        far_ms=time_ms(far_call, 20),
        far_device_ms=device_ms(far_call, KERNEL_NAMES["connected_components"],
                                10))
    for name, r in out.items():
        r["device_ms"] = device_ms(calls[name][0], KERNEL_NAMES[name], 10)
        # device_ms's fallback, read every time so that it stays tried
        r["queued_ms"] = queued_ms(calls[name][0], 10)
        print(f"[{tag}] {name}: kernel {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f} ms, queued {r['queued_ms']:.4f} ms), "
              f"plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]})"
              + (f", X re-read every "
                 f"{'iteration' if name == 'hill_climb' else 'step'} "
                 f"{r['rereads_ms']:.4f} ms" if "rereads_ms" in r else "")
              + (f"; pairwise-far input {r['far_ms']:.4f} ms (device "
                 f"{r['far_device_ms']:.4f} ms)" if "far_ms" in r else ""))
    return out


def check_route(mode: str, x32: torch.Tensor,
                z_valid: torch.Tensor | None) -> dict[str, float]:
    """Phase 2, whole clustering: mean_shift_smart_init with the fused 0.8
    depth filter on the clustered embeddings (several clusters, one of them
    mostly without depth), kernel route against plain route: seeds and
    labels equal.  Without z_valid (phase 2d: a COLOR frame) the filter is
    off (filter_threshold 0).  Returns both routes' median ms."""
    sub = 1 if mode == "parity" else int(FAST_CLUSTER["SEED_SUBSAMPLE"])
    kw = dict(kappa=KAPPA, num_seeds=M, max_iters=ITERS, epsilon=EPS,
              metric="cosine", first_index=777 % -(-N // sub),
              seed_subsample=sub,
              compute_dtype="float32" if mode == "parity" else "bfloat16",
              z_valid=z_valid,
              filter_threshold=0.0 if z_valid is None else 0.8)
    got = mean_shift_smart_init(x32, use_pallas=True, **kw)
    rechecked = int(cms.assign_labels_rechecked)
    want = mean_shift_smart_init(x32, use_pallas=False, **kw)
    ids = torch.unique(want.labels)
    filtered = ("after the depth filter" if z_valid is not None
                else "without a depth filter")
    print(f"[{mode}] clustering, kernel route vs plain route: "
          f"{int(want.seed_labels.max()) + 1} seed clusters, {len(ids)} label "
          f"ids {filtered}, {rechecked} pixels re-checked by the assignment, "
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


def run_slice(cfg: Config, state_dict: dict, frame: dict, d: int = D,
              where: str = "", frames: int = FRAMES, network_name: str = NET,
              peaks: dict | None = None) -> tuple[dict, dict, torch.Tensor]:
    """Phase 3 (and 2c's, 2d's and 8r's stage 1, at width d, with
    `network_name`, its lines tagged with `where`; `frames` timed frames
    after a warm-up): both modes through Segmentor.segment_sample, the
    counters set to 0 just before each frame and read just after it;
    every kernel must have launched in each frame of each mode.  With
    `peaks`, each mode's peak device memory over its frames (GiB)."""
    segs = {"parity": Segmentor(cfg, state_dict, network_name=network_name),
            "fast": Segmentor(cfg.replace(CLUSTER=dict(FAST_CLUSTER)),
                              state_dict, network_name=network_name,
                              model_dtype=torch.bfloat16)}
    timings: dict[str, dict] = {}
    counts: dict[str, dict] = {}
    features = None
    for mode, seg in segs.items():
        tag = where + mode
        rows = []
        counts[mode] = dict.fromkeys(KERNELS, 0)
        if peaks is not None:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for i in range(1 + frames):
            reset_counts()
            res = seg.segment_sample(frame, return_features=(i == 0))
            launched = launch_counts()
            missing = [k for k, v in launched.items() if v <= 0]
            if missing:
                raise AssertionError(f"[{tag}] frame {i}: kernels not "
                                     f"launched on the main path: {missing}")
            for k, v in launched.items():
                counts[mode][k] += v
            labels = res.labels
            if labels.shape != (1, H, W) or labels.dtype != np.int32:
                raise AssertionError(f"[{tag}] labels {labels.shape} "
                                     f"{labels.dtype}")
            if labels.min() < 0 or labels.max() > M:
                raise AssertionError(f"[{tag}] label ids out of range")
            if i == 0:
                f = res.features
                norms = np.linalg.norm(f, axis=-1)
                if (f.shape != (1, H, W, d) or not np.isfinite(f).all()
                        or np.abs(norms - 1.0).max() > 1e-3):
                    raise AssertionError(f"[{tag}] bad embeddings")
                if mode == "parity":
                    features = torch.from_numpy(f[0]).cuda()
                print(f"[{tag}] labels: {len(np.unique(labels))} ids, "
                      f"largest non-background "
                      f"{int(np.bincount(labels.ravel())[1:].max(initial=0))}"
                      " px")
            else:
                rows.append(res.timing)
        print(f"[{tag}] main-path launches ({1 + frames} frames, each "
              f"kernel in every frame): {counts[mode]}; the last frame's "
              f"assignment re-checked {int(cms.assign_labels_rechecked)} "
              "pixels")
        timings[mode] = {k: 1e3 * float(np.median([r[k] for r in rows]))
                         for k in ("network", "cluster", "stage1")}
        peak = ""
        if peaks is not None:
            peaks[mode] = torch.cuda.max_memory_allocated() / 2 ** 30
            peak = f"; peak device memory {peaks[mode]:.2f} GiB"
        print(f"[{tag}] stage 1 ms/frame (median of {frames}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in timings[mode].items())
              + peak)
    return counts, timings, features


def slice_routes(where: str, features: torch.Tensor, xyz: torch.Tensor
                 ) -> dict:
    """Phase 3 (and 8r): the whole parity clustering of a stage-1 frame's
    embeddings (the 0.8 depth filter on), kernel route against plain
    route: labels equal and the same seeds picked."""
    kw = dict(kappa=KAPPA, num_seeds=M, max_iters=ITERS, epsilon=EPS,
              metric="cosine", first_index=4321, seed_subsample=1,
              compute_dtype="float32", filter_threshold=0.8,
              z_valid=(xyz[..., 2] > 0).reshape(N))
    feats = features.reshape(N, -1)
    k_route = mean_shift_smart_init(feats, use_pallas=True, **kw)
    p_route = mean_shift_smart_init(feats, use_pallas=False, **kw)
    n_diff = int((k_route.labels != p_route.labels).sum())
    step, gap = seed_gap(feats, k_route.seed_indices, p_route.seed_indices)
    out = dict(pixels_differ=n_diff, seeds_differ_at=step,
               z_max_abs=float((k_route.seeds - p_route.seeds).abs().max()),
               seed_clusters=int(p_route.seed_labels.max()) + 1,
               label_ids=len(torch.unique(p_route.labels)))
    print(f"[{where}parity] kernel route vs plain route on the slice's "
          f"embeddings: {n_diff} pixels differ; seeds first differ at step "
          f"{step} (gap {gap:.3e}); max |Z - Z_plain| {out['z_max_abs']:.3e}"
          f"; {out['seed_clusters']} seed clusters, {out['label_ids']} label"
          " ids")
    if n_diff or step >= 0:
        raise AssertionError("the kernel route differs from the plain "
                             "route on the slice's embeddings")
    return out


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


def stage2_frames(cfg: Config, counts: tuple = STAGE2_INSTANCES
                  ) -> dict[int, tuple]:
    """Per instance count: (image, XYZ, labels) on the card and the labels
    on the host."""
    frames = {}
    for k in counts:
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
           timing: dict | None = None, has_depth: bool = True
           ) -> np.ndarray:
    """Stage 2 of one frame (_stage2_impl, the fetch and the paste), with
    the frame's boxes as its stage-1 labels; checks the refined labels."""
    img, xyz, labels, labels_np = frame
    t0 = time.perf_counter()
    refined = seg._refine(img, labels, xyz, labels_np,
                          torch.Generator().manual_seed(seed),
                          has_depth=has_depth, timing=timing)
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
               scenes: int = TRAIN_SCENES, net: str = NET) -> list[str]:
    return ["--cfg", yml or TRAIN_YML, "--network", net, "--solver", "adam",
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


def time_recipe(tag: str, yml: str, scenes, model_dtype=None,
                network_name: str = NET, hw: tuple = (H, W)) -> dict:
    """A recipe's train step with `network_name`, resident, outside the
    CLI, on `scenes` rendered at `hw`: TIMED_STEPS steps after a warm-up,
    each split by CUDA events into gather+augmentation, forward+backward
    and optimizer; the peak device memory over them; one more step under
    torch.profiler for the device's busy time and idle share (against the
    median unprofiled step)."""
    cfg = Config.from_yaml(yml).replace(MODE="TRAIN")
    crop = bool(cfg.TRAIN.SYN_CROP)
    state = create_train_state(cfg, network_name=network_name,
                               solver="adam", model_dtype=model_dtype,
                               device=DEV)
    h, w = hw
    f = 0.5 * w
    step = make_train_step_resident(cfg, fx=f, fy=f, px=w / 2.0, py=h / 2.0)
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
                                else [h, w]))
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


def step_against(run: tuple, ref: tuple, g64: dict | None = None,
                 tol: dict = STEP_TOL) -> dict:
    """A card step `run` (loss, gradients, state after the update) against
    the reference step `ref` (the CPU's; phase 9: one process's): its
    errors (vs_cpu: against ref) and the limits of `tol` it breaks."""
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
    row["breaks"] = [k for k, v in value.items() if v > tol[k]]
    if not all(torch.allclose(state[k], s_ref[k], rtol=tol["stat_rtol"],
                              atol=tol["stat_atol"])
               for k in s_ref if "running_" in k):
        row["breaks"].append("stat")
    return row


def _grad_line(e: dict) -> str:
    return (f"gradient relative L2 {e['rel_l2']:.2e}, per tensor median "
            f"{e['median_rel_l2']:.2e}, largest {e['max_rel_l2']:.2e} "
            f"({e['worst']})")


def small_step_inputs(n: int, draw_seed: int = 7, net: str = NET) -> tuple:
    """The inputs of one float32 SGD step of the stage-1 recipe with
    network `net` at SMALL_HW: the config, the dataset, n rendered scenes
    (CPU tensors), the initial weights (a fixed-seed init), the raw step
    and the batch's augmentation draws (drawn on the CPU)."""
    cfg = Config.from_yaml(TRAIN_YML).replace(MODE="TRAIN")
    h, w = SMALL_HW
    ds = SyntheticTabletopDataset(
        "train", Config.from_dict({"INPUT": "RGBD", "MODE": "TRAIN"}),
        height=h, width=w, size=n)
    bgr, depth, label = (torch.from_numpy(np.stack(a)) for a in zip(
        *[ds.get_scene(i) for i in range(n)]))
    depth = depth.to(torch.int32)
    torch.manual_seed(3)
    init = get_network(net, cfg).state_dict()
    step = make_train_step_raw(cfg, fx=ds.f, fy=ds.f, px=ds.cx, py=ds.cy)
    draws = step.draw(torch.Generator().manual_seed(draw_seed), bgr)
    return cfg, ds, bgr, depth, label, init, step, draws


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def small_step(cfg, init, step, scenes, draws, dev, mesh=None,
               net: str = NET) -> tuple:
    """One SGD step of network `net` from `init` on `dev` (with a mesh:
    this rank's rows of the scenes, the global batch's draws): (loss,
    gradients, state), on the host."""
    rows = slice(None) if mesh is None else mesh.batch_slice(len(scenes[0]))
    state = create_train_state(cfg, network_name=net, solver="sgd",
                               state_dict=init, device=dev)
    _, metrics = step(state, *(t[rows].to(dev) for t in scenes),
                      draws=_to(draws, dev), mesh=mesh)
    return (float(metrics["loss"]),
            {k: p.grad.detach().cpu() for k, p in
             state.model.named_parameters()},
            {k: v.detach().cpu() for k, v in
             state.model.state_dict().items()})


def check_step_against_cpu(draw_seed: int = 7, net: str = NET,
                           fault_tensor: str = FAULT_TENSOR,
                           tol: dict = STEP_TOL, gate: bool = True) -> dict:
    """One float32 SGD step of the stage-1 recipe with network `net` at
    128x160, batch 2, on the card and on the CPU, from the same weights
    and the same pinned augmentation draws (drawn on the CPU): loss,
    gradients (as one vector and tensor by tensor), updated parameters and
    BatchNorm statistics within `tol`.  Two faults must break it: the
    card's step with TF32 left on, and the card's gradients with
    `fault_tensor`'s zeroed.  For scale, every gradient against the same
    step's in float64.  With gate False (step_study.py) nothing raises:
    the readings are returned."""
    cfg, ds, bgr, depth, label, init, step, draws = small_step_inputs(
        2, draw_seed, net)
    h, w = SMALL_HW

    def run(dev):
        return small_step(cfg, init, step, (bgr, depth, label), draws, dev,
                          net=net)

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
    zeroed[fault_tensor] = torch.zeros_like(zeroed[fault_tensor])

    state64 = create_train_state(cfg, network_name=net, solver="sgd",
                                 state_dict=init, device="cpu")
    state64.model.double()
    _, apply = make_device_augment(cfg, fx=ds.f, fy=ds.f, px=ds.cx,
                                   py=ds.cy)
    img, xyz, lab = apply(bgr, depth, label, draws)
    _, m64 = make_train_step(cfg)(state64, img.double(), xyz.double(), lab)
    if m64["loss"].dtype != torch.float64:
        raise AssertionError("the float64 witness left float64")
    g64 = {k: p.grad for k, p in state64.model.named_parameters()}

    res = dict(network=net, draw_seed=draw_seed, loss_cpu=cpu[0],
               loss_fp64=float(m64["loss"]), tol=tol,
               fault_tensor=fault_tensor,
               cpu_vs_fp64=grad_errors(cpu[1], g64))
    head = f"[train] {net} step at {h}x{w}, batch 2, draws {draw_seed}:"
    print(f"{head} the CPU's float32 step vs a float64 step: "
          f"{_grad_line(res['cpu_vs_fp64'])}")
    runs = {"card": card, "card_tf32": tf32,
            "card_zeroed_grad": (card[0], zeroed, card[2])}
    for name, run_ in runs.items():
        row = res[name] = step_against(run_, cpu, g64, tol)
        print(f"{head} {name} vs the CPU: {_grad_line(row['vs_cpu'])}; "
              f"loss {row['loss']:.7f} vs {cpu[0]:.7f}; vs float64 "
              f"{row['vs_fp64']['rel_l2']:.2e} / "
              f"{row['vs_fp64']['median_rel_l2']:.2e}; parameters "
              f"{row['param_max_abs']:.2e}; BatchNorm statistics "
              f"{row['stat_max_abs']:.2e}; breaks {row['breaks']}")
    if not gate:
        return res
    if res["card"]["breaks"]:
        raise AssertionError(f"the card's train step differs from the "
                             f"CPU's beyond {tol}: "
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


def run_test_net(tag: str, args: list[str], frames: int,
                 exact: bool = False) -> tuple[dict, TimedRecorder]:
    """tools.test_net.main on the card, its Segmentor recorded; the counters
    set to 0 before and read after: every kernel launched at least once per
    frame; the .mat files equal the labels segment returned.  With `exact`
    the counters are set to 0 before each frame and read after it
    (CountingSegmentor): every kernel launched exactly once for stage 1
    and once per valid crop (each stage-1 instance, up to MAX_INSTANCES).
    Returns the readings and the recorder (its Segmentor in .seg)."""
    recorders = []
    build = test_net.builder.build_segmentor

    def recording(*a, **k):
        recorders.append((CountingSegmentor if exact else TimedRecorder)(
            build(*a, **k)))
        return recorders[-1]

    out_dir = args[args.index("--output-dir") + 1]
    reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(test_net.builder, "build_segmentor", recording):
        stage1, refined = test_net.main(args)
    wall = time.perf_counter() - t0
    rec = recorders[0]
    if len(rec.results) != frames:
        raise AssertionError(f"[{tag}] {len(rec.results)} frames")
    if exact:
        cap = rec.seg.max_instances
        refines = rec.seg.model_crop is not None
        for i, (res, got) in enumerate(zip(rec.results, rec.launches)):
            want = 1 + (min(instances(res.labels[0]), cap) if refines else 0)
            if set(got.values()) != {want}:
                raise AssertionError(f"[{tag}] frame {i} launched {got}, "
                                     f"not {want} of each kernel")
        counts = {k: sum(c[k] for c in rec.launches) for k in KERNELS}
    else:
        counts = launch_counts()
    short = {k: v for k, v in counts.items() if v < frames}
    if short:
        raise AssertionError(f"[{tag}] kernels launched fewer times than "
                             f"the {frames} frames: {short}")
    for i, res in enumerate(rec.results):
        mat = scipy.io.loadmat(os.path.join(out_dir, "%06d.mat" % i))
        want_ref = (res.labels if res.labels_refined is None
                    else res.labels_refined)
        if not (np.array_equal(mat["labels"], res.labels[0])
                and np.array_equal(mat["labels_refined"], want_ref[0])):
            raise AssertionError(f"[{tag}] {i:06d}.mat differs from the "
                                 "returned labels")
    found = [len(np.unique(r.labels)) - 1 for r in rec.results]
    res = dict(frames=frames, wall_s=wall, s_per_frame=wall / frames,
               segment_s=float(np.median(rec.seconds)), launches=counts,
               stage1_instances=found, stage1_metrics=stage1,
               refined_metrics=refined,
               objects_f=stage1["Objects F-measure"],
               objects_f_refined=refined["Objects F-measure"])
    print(f"[{tag}] test_net: {frames} frames in {wall:.2f} s "
          f"({res['s_per_frame']:.3f} s/frame, segment median "
          f"{res['segment_s']:.3f} s); launches {counts}; stage-1 "
          f"instances {found}; the .mat files equal the returned labels")
    return res, rec


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
                runs[f"{mode}/{name}"], _ = run_test_net(tag, [
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
# phase 7b: the data path without OpenCV
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def without_opencv():
    """sys.modules["cv2"] and ["PIL"] set to None (an import raises), then
    restored."""
    saved = {k: sys.modules.get(k, mock.sentinel.absent)
             for k in ("cv2", "PIL")}
    for k in saved:
        sys.modules[k] = None
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is mock.sentinel.absent:
                del sys.modules[k]
            else:
                sys.modules[k] = v


def tabletop_fixtures():
    """tests/torch_fixtures/tabletop/make_tabletop_fixtures.py (numpy
    only at import: CASES, array_digest, sample_digests, jpeg_files)."""
    spec = importlib.util.spec_from_file_location(
        "make_tabletop_fixtures",
        os.path.join(TABLETOP, "make_tabletop_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_jpegs(fx, digests: dict) -> dict:
    """Every committed JPEG through utils/jpeg.py: the digest of cv2.imread
    recorded in digests.json, the progressive file refused; the decode ms
    of the 480x640 frame rgb_00000.jpeg (median of 20)."""
    files = fx.jpeg_files()
    if files != sorted(digests["jpeg"]):
        raise AssertionError("the committed JPEGs differ from digests.json")
    refused = []
    for rel in files:
        path = os.path.join(TABLETOP, rel)
        if digests["jpeg"][rel] is None:
            try:
                jpeg.imread(path)
            except ValueError as e:
                if "progressive" not in str(e):
                    raise
                refused.append(rel)
                continue
            raise AssertionError(f"{rel}: the decoder took a progressive "
                                 "file")
        if fx.array_digest(jpeg.imread(path)) != digests["jpeg"][rel]:
            raise AssertionError(f"{rel}: decoded bits differ from "
                                 "cv2.imread's")
    frame = os.path.join(TABLETOP, "training_set", "scene_00000",
                         "rgb_00000.jpeg")
    with open(frame, "rb") as f:
        data = f.read()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        im = jpeg.decode(data)
        times.append(1e3 * (time.perf_counter() - t0))
    if im.shape != (H, W, 3):
        raise AssertionError(f"{frame}: {im.shape}")
    ms = float(np.median(times))
    print(f"[no-opencv] {len(files) - len(refused)} JPEGs decoded with "
          f"cv2.imread's digests, {refused} refused (progressive); decode "
          f"{ms:.3f} ms per {H}x{W} frame ({len(data)} bytes, median of 20)")
    return dict(files=len(files), refused=refused, decode_ms=ms,
                decode_ms_all=times, frame_bytes=len(data))


def check_samples(fx, digests: dict) -> dict:
    """Every array of every TableTop sample of the tree, in each case and
    epoch of digests.json, with the JAX reader's digest."""
    t0 = time.perf_counter()
    got = fx.sample_digests(get_dataset, Config, TABLETOP)
    if got != digests["samples"]:
        bad = [(c, e, i) for c in got for e in got[c]
               for i, (a, b) in enumerate(zip(got[c][e],
                                              digests["samples"][c][e]))
               if a != b]
        raise AssertionError(f"TableTop samples differ from the JAX "
                             f"reader's digests: {bad[:5]}")
    n = sum(len(v) for c in got.values() for v in c.values())
    seconds = time.perf_counter() - t0
    print(f"[no-opencv] {n} TableTop samples "
          f"({', '.join(f'{c}: {len(v[str(fx.EPOCHS[0])])} x {len(v)} epochs' for c, v in got.items())}) "
          f"with every array's digest equal to the JAX reader's, in "
          f"{seconds:.1f} s")
    return dict(samples=n, seconds=seconds)


STAGES = {  # stage -> the functions it times
    "decode": [(data_datasets.jpeg, "imread")],
    "depth_noise_and_ellipses": [
        (augmentation, "add_noise_to_depth"),
        (augmentation, "dropout_random_ellipses"),
        (augmentation, "add_realsense_artifacts")],
    "xyz_noise": [(augmentation, "add_noise_to_xyz")],
    "crop": [(data_datasets.TableTopObject, "pad_crop_resize")],
    "chromatic_and_noise": [(augmentation, "chromatic_transform"),
                            (augmentation, "add_noise")],
}


def stage_ms(ds, count: int) -> dict:
    """Each stage's ms per sample over `count` samples read in one thread
    (the stage's functions wrapped with a clock), and the whole sample's."""
    spent = {k: 0.0 for k in STAGES}
    patches = []
    for stage, targets in STAGES.items():
        for owner, name in targets:
            fn = getattr(owner, name)

            def timed(*a, _fn=fn, _stage=stage, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    spent[_stage] += time.perf_counter() - t0

            patches.append(mock.patch.object(owner, name, timed))
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        t0 = time.perf_counter()
        for i in range(count):
            ds[i % len(ds)]
        total = time.perf_counter() - t0
    out = {k: 1e3 * v / count for k, v in spent.items()}
    out["sample"] = 1e3 * total / count
    return out


class Repeated:
    """`ds` read over and over to `n` samples (index i is ds[i % len]):
    an epoch long enough to read a steady rate from."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        return self.ds[i % len(self.ds)]

    def set_epoch(self, epoch: int) -> None:
        self.ds.set_epoch(epoch)


def loader_rate(ds, batch: int, hw: tuple[int, int]) -> dict:
    """Samples/s of DataLoader(num_workers=LOADER_WORKERS) over one epoch
    of LOADER_SAMPLES samples of `ds` (of `hw`) at `batch`:
    `samples_per_s` over the whole epoch (the pool's start and the first
    batches' wait included), and `steady_samples_per_s`, the samples after
    the second batch over the time after it."""
    loader = DataLoader(Repeated(ds, LOADER_SAMPLES), batch_size=batch,
                        shuffle=True, num_workers=LOADER_WORKERS,
                        drop_last=True, seed=3)
    sizes, arrived = [], []
    t0 = time.perf_counter()
    for b in loader:
        if b["image_color"].shape[1:] != (*hw, 3):
            raise AssertionError("a batch of the wrong shape")
        sizes.append(len(b["label"]))
        arrived.append(time.perf_counter())
    if len(sizes) < 4 or len(sizes) % 2:
        raise AssertionError(f"{len(sizes)} batches: no steady pairs")
    n, steady = sum(sizes), sum(sizes[2:])
    return dict(batch=batch, samples=n, seconds=arrived[-1] - t0,
                samples_per_s=n / (arrived[-1] - t0), steady_samples=steady,
                steady_samples_per_s=steady / (arrived[-1] - arrived[1]))


def host_loaders(cache: str) -> dict:
    """The host loader on the fixture tree (tabletop_object_train, the
    rgbd_add recipe) and on phase 6's render cache
    (synthetic_tabletop_train, DEPTH_ARTIFACTS on): samples/s with
    LOADER_WORKERS threads over an epoch and steady; and each stage's ms
    per sample in one thread, there and with the crop recipe, which crops
    each TableTop sample at 224."""
    cfg = Config.from_yaml(os.path.join(REPO, TRAIN_YML)).replace(
        MODE="TRAIN")
    crop = Config.from_yaml(os.path.join(REPO, CROP_YML)).replace(
        MODE="TRAIN")
    sets = {
        "tabletop_object_train": get_dataset("tabletop_object_train", cfg,
                                             path=TABLETOP),
        "synthetic_tabletop_train": SyntheticTabletopDataset(
            "train", cfg.replace(TRAIN={"DEPTH_ARTIFACTS": True}), height=H,
            width=W, size=TRAIN_SCENES, cache_dir=cache),
        "tabletop_object_train crop": get_dataset(
            "tabletop_object_train", crop, path=TABLETOP)}
    out = {}
    for name, ds in sets.items():
        stages = stage_ms(ds, min(len(ds), STAGE_SAMPLES))
        out[name] = dict(stage_ms=stages)
        line = (f"[no-opencv] {name} from {H}x{W} frames, one thread, ms "
                "per sample: " + ", ".join(f"{k} {v:.1f}"
                                           for k, v in stages.items()))
        if "crop" not in name:
            rate = loader_rate(ds, LOADER_BATCH, (H, W))
            out[name].update(rate)
            line += (f"; loader at batch {LOADER_BATCH} with "
                     f"{LOADER_WORKERS} workers: "
                     f"{rate['steady_samples_per_s']:.2f} samples/s steady "
                     f"({rate['steady_samples']} samples after the second "
                     f"batch), {rate['samples_per_s']:.2f} over the epoch "
                     f"({rate['samples']})")
        print(line)
    if not out["tabletop_object_train crop"]["stage_ms"]["crop"] > 0:
        raise AssertionError("the crop recipe's samples were not cropped")
    return out


def snapshots(out_dir: str) -> list[str]:
    return sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []


def host_train_net(tmp: str, cache: str) -> dict:
    """tools.train_net.main() on its default (host-augmented) route: the
    rgbd_add recipe with --bf16 at batch 16 on phase 6's render cache for 2
    steps, and the crop recipe on the fixture tree's training_set at batch
    4 for one epoch; finite losses, a snapshot each, no clustering kernel
    launched."""
    runs = {}
    common = ["--network", NET, "--solver", "adam", "--workers",
              str(LOADER_WORKERS), "--device", DEV]
    tree = yaml.safe_load(open(os.path.join(REPO, TRAIN_YML)))
    tree["TRAIN"]["SYNNUM"] = TRAIN_SCENES  # the scenes phase 6 rendered
    yml = os.path.join(tmp, "host_rgbd_add.yml")
    with open(yml, "w") as f:
        yaml.safe_dump(tree, f)
    for tag, args in (
            ("host rgbd_add", ["--cfg", yml, "--render-cache", cache,
                               "--batch_size", str(TRAIN_SCENES), "--bf16",
                               "--epochs", "2"]),
            ("host crop tabletop", ["--cfg", CROP_YML, "--dataset",
                                    "tabletop_object_train",
                                    "--dataset_root", TABLETOP,
                                    "--batch_size", "4", "--epochs", "1"])):
        out_dir = os.path.join(tmp, tag.replace(" ", "_"))
        reset_counts()
        t0 = time.perf_counter()
        state, steps = run_train_net(tag, args + common + ["--output-dir",
                                                           out_dir])
        wall = time.perf_counter() - t0
        launched = launch_counts()
        written = snapshots(out_dir)
        if any(launched.values()) or not written or not steps:
            raise AssertionError(f"[{tag}] launches {launched}, snapshots "
                                 f"{written}, {len(steps)} steps")
        step_ms = [r["ms"] for r in steps if r["ms"] is not None]
        runs[tag] = dict(steps=len(steps), step_ms=step_ms, wall_s=wall,
                         snapshots=written, losses=[r["loss"] for r in steps])
        print(f"[{tag}] train_net default route: {len(steps)} steps in "
              f"{wall:.1f} s (step ms after the first {step_ms}); "
              f"snapshots {written}; no clustering kernel launched")
    return runs


def profile_host_step(cache: str) -> dict:
    """The host route's steady step: bf16 rgbd_add steps at
    HOST_STEP_BATCH on phase 6's cache, as train_net takes them; after a
    warm-up step on a batch assembled in this thread, an epoch of
    HOST_STEP_SAMPLES samples whose steps after the second run under
    torch.profiler (the loader assembling the following batches
    meanwhile, two in flight): wall ms per step, the device's busy ms per
    step and its idle share."""
    cfg = Config.from_yaml(os.path.join(REPO, TRAIN_YML)).replace(
        MODE="TRAIN")
    ds = SyntheticTabletopDataset("train", cfg, height=H, width=W,
                                  size=TRAIN_SCENES, cache_dir=cache)
    loader = DataLoader(Repeated(ds, HOST_STEP_SAMPLES),
                        batch_size=HOST_STEP_BATCH, shuffle=True,
                        num_workers=LOADER_WORKERS, seed=3)
    state = create_train_state(cfg, network_name=NET, solver="adam",
                               model_dtype=torch.bfloat16, device=DEV)
    step = make_train_step(cfg)

    def run(b):
        put = (lambda k: torch.as_tensor(b[k]).to(DEV))
        _, m = step(state, put("image_color"), put("depth"), put("label"))
        return m

    run(stack_samples([ds[i] for i in range(HOST_STEP_BATCH)]))  # warm-up
    batches = iter(loader)
    run(next(batches))
    run(next(batches))
    torch.cuda.synchronize()
    n = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            m = run(b)
            n += 1
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    if n < 2 or n % 2 or not torch.isfinite(m["loss"]):
        raise AssertionError(f"[host step] {n} steps, loss {m['loss']}")
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3
    if busy <= 0:
        raise AssertionError("[host step] the profiler saw no device time")
    out = dict(batch=HOST_STEP_BATCH, steps=n, step_ms=wall / n,
               device_busy_ms=busy / n, idle_share=1.0 - busy / wall)
    print(f"[host step] bf16 rgbd_add at batch {HOST_STEP_BATCH}, steady "
          f"(steps 3-{n + 2} of an epoch, the loader two batches ahead): "
          f"{out['step_ms']:.1f} ms a step, device busy "
          f"{out['device_busy_ms']:.1f} ms, idle share "
          f"{out['idle_share']:.3f}")
    del state
    torch.cuda.empty_cache()
    return out


def run_data_no_opencv(work: str, tmp: str, paths: dict[str, str],
                       training: dict) -> dict:
    """Phase 7b."""
    t0 = time.perf_counter()
    cache = os.path.join(tmp, "render_cache")
    with without_opencv():
        jpeg.library()
        built = jpeg.build_seconds
        print(f"[no-opencv] cv2 and PIL blocked; JPEG library from "
              f"{jpeg.SOURCE}: "
              f"{'reused' if built is None else f'built in {built:.2f} s'}")
        fx = tabletop_fixtures()
        with open(os.path.join(TABLETOP, "digests.json")) as f:
            digests = json.load(f)
        jpegs = check_jpegs(fx, digests)
        samples = check_samples(fx, digests)
        loaders = host_loaders(cache)
        runs = host_train_net(tmp, cache)
        host_step = profile_host_step(cache)
        resident = {k: training["timing"][k]["split_ms"]["step"]
                    for k in ("fp32", "bf16")}
        print(f"[no-opencv] host route bf16 rgbd_add: "
              f"{host_step['step_ms'] / HOST_STEP_BATCH:.1f} ms a sample "
              f"steady (batch {HOST_STEP_BATCH}); train_net's one-batch "
              f"epochs at batch {TRAIN_SCENES}: step ms "
              f"{runs['host rgbd_add']['step_ms']}; phase 6's resident "
              f"step {resident['bf16']:.1f} ms at batch {TRAIN_SCENES}, "
              f"{resident['bf16'] / TRAIN_SCENES:.1f} ms a sample (fp32 "
              f"{resident['fp32']:.1f} ms)")
        tests = {}
        for mode in ("parity", "fast"):
            name = "tabletop_object_test"
            tests[f"{mode}/{name}"], _ = run_test_net(f"{mode}, {name}", [
                "--dataset", name, "--dataset_root", TABLETOP,
                "--cfg", os.path.join(REPO, TRAIN_YML), "--network", NET,
                "--pretrained", paths["main"],
                "--pretrained_crop", paths["crop"],
                "--max_images", str(TABLETOP_FRAMES), "--output-dir",
                os.path.join(work, "test_net_tabletop", mode)]
                + (["--fast"] if mode == "fast" else []), TABLETOP_FRAMES)
    out = dict(jpeg_build_s=built, jpeg=jpegs, samples=samples,
               loaders=loaders, train_net=runs, host_step=host_step,
               resident_step_ms=resident, test_net=tests,
               phase_s=time.perf_counter() - t0)
    print(f"phase 7b {out['phase_s']:.1f} s")
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
        err = window_vs_cpu(net, cfg, state, seg, frame)
        timing = results[-1].timing
        out[net] = dict(batch_norm=bn, network_ms=1e3 * timing["network"],
                        cluster_ms=1e3 * timing["cluster"],
                        stage1_ms=1e3 * timing["stage1"], launches=counts,
                        card_vs_cpu_max_abs=err,
                        instances=len(np.unique(results[-1].labels)) - 1)
        print(f"[{net}{' batch_norm' if bn else ''}] parity stage 1 at "
              f"{H}x{W}: network {out[net]['network_ms']:.3f} ms, cluster "
              f"{out[net]['cluster_ms']:.3f} ms; launches {counts}")
        del seg
        torch.cuda.empty_cache()
    return out


def window_vs_cpu(net: str, cfg: Config, state: dict, seg: Segmentor,
                  frame: dict) -> float:
    """Phase 8 (and 8r): the parity Segmentor's network on the card against
    the same weights on the CPU, on an ALT_WINDOW window of the frame:
    the largest embedding difference, at most ALT_TOL."""
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
    print(f"[{net}] card vs CPU on a {h}x{w} window of the frame: max "
          f"|embedding diff| {err:.3e}")
    if not err <= ALT_TOL:
        raise AssertionError(f"[{net}] the card's embeddings differ from "
                             f"the CPU's by {err:.3e}")
    return err


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


def train_recipe(tag: str, recipe: str, net: str, epochs: int, cache: str,
                 out: str, scenes: int = TRAINED_SCENES
                 ) -> tuple[list[dict], float, float]:
    """tools.train_net.main on the recipe yml `recipe` (copied to out.yml
    to snapshot once, after `epochs` epochs, in `out`) with --bf16
    --device-resident on the first `scenes` scenes of `cache`: every
    step's readings, the seconds and the step ms (median of CUDA events
    between consecutive steps); no clustering kernel may launch."""
    with open(os.path.join(REPO, recipe)) as f:
        tree = yaml.safe_load(f)
    tree["TRAIN"]["SNAPSHOT_EPOCHS"] = epochs  # one, at the end
    os.makedirs(os.path.dirname(out), exist_ok=True)
    yml = out + ".yml"
    with open(yml, "w") as f:
        yaml.safe_dump(tree, f)
    reset_counts()
    t0 = time.perf_counter()
    _, steps = run_train_net(tag, train_args(
        cache, out, "--epochs", str(epochs), "--bf16", yml=yml,
        scenes=scenes, net=net))
    train_s = time.perf_counter() - t0
    launched = launch_counts()
    if any(launched.values()):
        raise AssertionError(f"[{tag}] training launched a clustering "
                             f"kernel: {launched}")
    step_ms = float(np.median([row["ms"] for row in steps[1:]]))
    side = tree["TRAIN"].get("SYN_CROP_SIZE") if tree["TRAIN"].get(
        "SYN_CROP") else None
    print(f"[{tag}] {net}: {len(steps)} steps of batch {TRAIN_SCENES} at "
          f"{TH}x{TW}" + (f" ({side}x{side} crops)" if side else "")
          + f", bf16, in {train_s:.1f} s (train_net.main, start and "
          f"snapshot included); step {step_ms:.2f} ms (median of CUDA "
          f"events between consecutive steps); loss {steps[0]['loss']:.4f} "
          f"-> {steps[-1]['loss']:.4f}; no clustering kernel launched")
    torch.cuda.empty_cache()
    return steps, train_s, step_ms


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
    steps, train_s, step_ms = train_recipe(
        "trained", RECIPE_YML, NET, TRAINED_EPOCHS, cache, snapshots)

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


# phase 8r: ResNet-50-8s, the JAX package's third backbone
# ---------------------------------------------------------------------------

def resnet50_stage1(frame: dict, work: str) -> dict:
    """Phase 8r (a) and (b): stage 1 of R50 on phase 3's 480x640 frame in
    both modes through Segmentor.segment_sample (a warm-up and R50_FRAMES
    timed frames; every kernel in each frame); the parity network against
    the CPU on a window; kernel route against plain route on the parity
    frame's embeddings; then tools.test_net.main() with --network R50 on
    phase 7's synthetic tree in both modes (each kernel exactly once per
    frame; the .mat files equal the labels)."""
    cfg = Config.inference_default(INPUT="RGBD")
    torch.manual_seed(50)
    state = get_network(R50, cfg).state_dict()
    n_params = sum(v.numel() for k, v in state.items()
                   if "running_" not in k and "num_batches" not in k)
    print(f"[{R50}] RGB-D add, 64 units, two towers of (3, 4, 6, 3) "
          f"bottleneck blocks: {n_params} parameters (fixed-seed init)")
    peaks: dict[str, float] = {}
    counts, timings, features = run_slice(
        cfg, state, frame, where="resnet50 ", frames=R50_FRAMES,
        network_name=R50, peaks=peaks)
    seg = Segmentor(cfg, state, network_name=R50)
    err = window_vs_cpu(R50, cfg, state, seg, frame)
    del seg
    routes = slice_routes("resnet50 ", features, frame["depth"])
    del features
    torch.cuda.empty_cache()
    pth = os.path.join(work, "resnet50.pth")
    torch.save({"model": {"module." + k: v for k, v in state.items()}}, pth)
    runs = {}
    for mode in ("parity", "fast"):
        runs[mode], _ = run_test_net(f"resnet50 {mode}, test_net", [
            "--dataset", "synthetic_tabletop_test", "--dataset_root",
            os.path.join(work, "scenes"), "--cfg",
            os.path.join(REPO, TRAIN_YML), "--network", R50, "--pretrained",
            pth, "--max_images", str(SYN_FRAMES), "--output-dir",
            os.path.join(work, "test_net", "resnet50", mode)]
            + (["--fast"] if mode == "fast" else []), SYN_FRAMES,
            exact=True)
    torch.cuda.empty_cache()
    return dict(parameters=n_params, launches=counts, stage1_ms=timings,
                peak_gib=peaks, card_vs_cpu_max_abs=err, routes=routes,
                test_net=runs)


def resnet50_training(cache: str, out: str) -> dict:
    """Phase 8r (c): one float32 SGD step of R50 at SMALL_HW on the card
    against the CPU (R50_STEP_TOL, the planted faults on R50_FAULT_TENSOR);
    the resident step of RECIPE_YML with R50 timed on phase 8b's scenes at
    TH x TW (bf16, as the recipe trains); tools.train_net.main() with
    --network R50 on RECIPE_YML for one epoch of R50_TRAIN_SCENES / 16
    steps (no clustering kernel launched)."""
    card_cpu = check_step_against_cpu(net=R50, fault_tensor=R50_FAULT_TENSOR,
                                      tol=R50_STEP_TOL)
    scenes = load_resident_scenes(
        os.path.join(cache, f"synthetic_tabletop_train_{TH}x{TW}_v4"),
        limit=TRAIN_SCENES, device=DEV)
    reset_counts()
    timing = time_recipe("resnet50 bf16", RECIPE_YML, scenes,
                         torch.bfloat16, network_name=R50, hw=(TH, TW))
    del scenes
    launched = launch_counts()
    if any(launched.values()):
        raise AssertionError(f"[resnet50] training launched a clustering "
                             f"kernel: {launched}")
    steps, train_s, step_ms = train_recipe(
        "resnet50 train_net", RECIPE_YML, R50, 1, cache, out,
        scenes=R50_TRAIN_SCENES)
    if not glob.glob(os.path.join(out, "*")):
        raise AssertionError("[resnet50] train_net wrote no snapshot")
    return dict(card_vs_cpu=card_cpu, timing=timing,
                train_net=dict(steps=len(steps), train_s=train_s,
                               step_ms=step_ms,
                               loss=[steps[0]["loss"], steps[-1]["loss"]]))


def run_resnet50(frame: dict, work: str, tmp: str, cache: str) -> dict:
    """Phase 8r: seg_resnet50_8s_embedding through the port's entry points
    (resnet50_stage1, resnet50_training); `work` holds phase 7's trees,
    `cache` is phase 8b's render cache."""
    t0 = time.perf_counter()
    out = resnet50_stage1(frame, work)
    t1 = time.perf_counter()
    out.update(resnet50_training(cache, os.path.join(tmp, "resnet50")))
    out.update(stage1_s=t1 - t0, training_s=time.perf_counter() - t1,
               phase_s=time.perf_counter() - t0)
    modes = out["stage1_ms"]
    print(f"[resnet50] stage 1 ms parity / fast: "
          + " / ".join(f"network {modes[m]['network']:.3f}, cluster "
                       f"{modes[m]['cluster']:.3f}, stage1 "
                       f"{modes[m]['stage1']:.3f}, peak "
                       f"{out['peak_gib'][m]:.2f} GiB"
                       for m in ("parity", "fast")))
    print(f"phase 8r {out['phase_s']:.1f} s (stage 1 and test_net "
          f"{out['stage1_s']:.1f}, training {out['training_s']:.1f})")
    return out


# ---------------------------------------------------------------------------
# phase 8c: trained zoom-in networks
# ---------------------------------------------------------------------------

def instances(labels: np.ndarray) -> int:
    return int((np.unique(labels) > 0).sum())


def crop_embeddings(seg: Segmentor, img: torch.Tensor, xyz: torch.Tensor
                    ) -> tuple[torch.Tensor, list[bool]]:
    """One frame's crop embeddings [M, S, S, D] as segment(refine=True)
    computes them (read by a forward hook on the crop network) and the
    valid slots: one per stage-1 instance, up to the bucket M."""
    feats = []
    hook = seg.model_crop.register_forward_hook(
        lambda module, args, out: feats.append(out))
    try:
        res = seg.segment(img, xyz, refine=True)
    finally:
        hook.remove()
    x = feats[0].float().clone()  # a normal tensor, outside inference mode
    k = instances(res.labels[0])
    return x, [i < k for i in range(x.shape[0])]


def near_ties(x: torch.Tensor, kernel, plain) -> dict:
    """The pixels whose labels differ between a crop's kernel route and
    plain route (MeanShiftResults on the same seeds), with the largest of
    their margins on the plain route's converged seeds (float64: the best
    seed's similarity less the best similarity of a seed of another
    label), and the bound no pixel's margin can exceed if the seeds'
    difference alone flipped it: twice the largest row distance between
    the two routes' seeds, plus twice the float32 rounding of a d-term dot
    product of unit vectors (d * 2^-24)."""
    z = plain.seeds.double()
    delta = float((kernel.seeds.double() - z).norm(dim=1).max())
    out = dict(pixels=int((kernel.labels != plain.labels).sum()),
               margin=0.0, bound=2 * delta + 2 * x.shape[1] * 2.0 ** -24)
    if out["pixels"]:
        diff = (kernel.labels != plain.labels).nonzero()[:, 0]
        sim = x[diff].double() @ z.T
        best = sim.argmax(dim=1)
        lab = plain.seed_labels.long()
        other = torch.where(lab[None, :] == lab[best][:, None],
                            -torch.inf, sim)
        out["margin"] = float((sim.max(dim=1).values
                               - other.max(dim=1).values).max())
    return out


def route_ties(tag: str, x: torch.Tensor, kern, plain
               ) -> tuple[dict | None, dict | None]:
    """One clustering's kernel route against its plain route
    (MeanShiftResults from the same first seed): (the seeding's near-tie
    where the routes part, else None; the pixels near_ties finds where
    some labels differ, else None).  Raises where the seeds part at a gap
    of SEED_GAP or more or, with equal seeds, the seed labels differ."""
    if not torch.equal(kern.seed_indices, plain.seed_indices):
        step, gap = seed_gap(x, kern.seed_indices, plain.seed_indices)
        if not gap < SEED_GAP:
            raise AssertionError(f"[{tag}] the routes' seeds differ at step "
                                 f"{step} (gap {gap:.3e})")
        return dict(step=step, gap=gap), None  # the routes part here
    if not torch.equal(kern.seed_labels, plain.seed_labels):
        raise AssertionError(f"[{tag}] the routes' seed labels differ")
    t = near_ties(x, kern, plain)
    return None, (t if t["pixels"] else None)


def crop_routes(feats: torch.Tensor, valid: list[bool], seed: int,
                ms_kw: dict) -> dict[int, list]:
    """Each valid crop's clustering by the kernel route and by the plain
    route, both from the first seed _cluster_crops(feats, valid,
    Generator(seed)) draws for that crop."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for i, v in enumerate(valid):
        if v:
            state = _split(gen).get_state()
            out[i] = []
            for pallas in (True, False):
                g = torch.Generator()
                g.set_state(state)
                out[i].append(mean_shift_smart_init(
                    feats[i].reshape(-1, feats.shape[-1]), g,
                    **dict(ms_kw, use_pallas=pallas)))
    return out


def check_crop_kernels(name: str, segs: dict[str, Segmentor], cache: str
                       ) -> dict:
    """The four kernels on the trained crop embeddings of every valid crop
    of the HELD_OUT frames, in each mode with that mode's Segmentor: each
    crop through check_kernels with against_exact (discrete outputs exact
    but the seeds at a float32 near-tie; the hill climb held to the
    float64 result); each frame's crop clustering (_cluster_crops)
    launching each kernel exactly once per valid crop; in parity each
    crop's kernel route against its plain route: seeds equal unless they
    part at a float32 near-tie of the seeding (the plain route's
    min-distance gap between the two picks below SEED_GAP; the routes are
    not compared past it), seed labels equal, and every pixel label equal
    unless near_ties shows its decision within what the two routes'
    float32 seeds can move (the routes differ there by rounding, as the
    seeds may in fast mode); probe_seed_precision on frame 0's first valid
    crop in parity (both routes PASS).  Prints every crop's hill-climb
    readings: the kernel's distance from its plain version and from the
    float64 result, and the plain version's from the float64 result."""
    img, xyz = held_out_frames(cache, HELD_OUT, DEV)
    out: dict = {}
    for mode, seg in segs.items():
        errs: dict[str, float] = {}  # the largest over the valid crops
        survey = []  # [frame, crop, kernel-plain, kernel-f64, plain-f64]
        ties, seed_ties, seed_flips, ids = [], [], [], []
        launches, first = 0, None
        for fr in range(HELD_OUT):
            feats, valid = crop_embeddings(seg, img[fr:fr + 1],
                                           xyz[fr:fr + 1])
            crops = [i for i, v in enumerate(valid) if v]
            n = feats.shape[1] * feats.shape[2]
            for i in crops:
                first = first or (fr, i)
                with contextlib.redirect_stdout(io.StringIO()):
                    checked = check_kernels(
                        mode, feats[i].reshape(n, D), None,
                        where=f", {name} frame {fr} crop {i}", timed=False,
                        against_exact=True, far=(fr, i) == first)
                for kernel, r in checked.items():
                    for key in ("max_abs_err", "exact_err",
                                "plain_exact_err"):
                        if key in r:
                            k = kernel + ("" if key == "max_abs_err"
                                          else "_" + key[:-4])
                            errs[k] = max(errs.get(k, 0.0), r[key])
                h = checked["hill_climb"]
                survey.append([fr, i, h["max_abs_err"], h["exact_err"],
                               h["plain_exact_err"]])
                if checked["select_seeds"]["differing_step"] >= 0:
                    seed_flips.append(dict(
                        frame=fr, crop=i,
                        step=checked["select_seeds"]["differing_step"],
                        gap=checked["select_seeds"]["max_abs_err"]))
            with torch.inference_mode(), _full_fp32():
                reset_counts()
                got = _cluster_crops(feats, valid,
                                     torch.Generator().manual_seed(5),
                                     **seg._ms_kw)
                launched = launch_counts()
                if mode == "parity":
                    for i, (kern, plain) in crop_routes(
                            feats, valid, 5, seg._ms_kw).items():
                        if not torch.equal(kern.labels.reshape(got[i].shape),
                                           got[i]):
                            raise AssertionError(
                                f"[{name}] frame {fr} crop {i}: the route "
                                "replay differs from _cluster_crops")
                        seed_tie, t = route_ties(
                            f"{name} parity, frame {fr} crop {i}",
                            feats[i].reshape(n, D), kern, plain)
                        if seed_tie:
                            seed_ties.append(dict(frame=fr, crop=i,
                                                  **seed_tie))
                        if t:
                            ties.append(dict(frame=fr, crop=i, **t))
            if set(launched.values()) != {len(crops)}:
                raise AssertionError(f"[{name} {mode}] frame {fr}: the crop "
                                     f"clustering launched {launched}, not "
                                     f"once per valid crop ({len(crops)})")
            launches += len(crops)
            ids += [len(torch.unique(got[i])) for i in crops]
        if first is None:
            raise AssertionError(f"[{name} {mode}] no valid crop in the "
                                 "held-out frames")
        print(f"[{name} {mode}] kernels on the trained crop embeddings of "
              f"{HELD_OUT} held-out frames (n = {n}, {len(survey)} valid "
              f"crops): each kernel equal to its plain version, the "
              f"seeding but at near-ties (frame, crop: step, gap) "
              + (", ".join(f"{t['frame']}, {t['crop']}: {t['step']}, "
                           f"{t['gap']:.2e}" for t in seed_flips) or "none")
              + f", the hill climb held to the float64 result (largest "
              f"readings {errs}); "
              f"_cluster_crops launched each kernel once per valid crop of "
              f"each frame; label ids per crop from {min(ids)} to "
              f"{max(ids)}"
              + ("" if mode != "parity" else "; kernel route vs plain "
                 "route: seeds that differ at a near-tie (frame, crop: "
                 "step, gap) " + (", ".join(
                     f"{t['frame']}, {t['crop']}: {t['step']}, "
                     f"{t['gap']:.2e}" for t in seed_ties) or "none")
                 + "; elsewhere seeds and seed labels equal, pixels that "
                 "differ (frame, crop: pixels, largest margin, bound) "
                 + (", ".join(
                     f"{t['frame']}, {t['crop']}: {t['pixels']}, "
                     f"{t['margin']:.2e}, {t['bound']:.2e}" for t in ties)
                     or "none")))
        print(f"[{name} {mode}] hill climb per crop [frame, crop, kernel - "
              "plain, kernel - float64, plain - float64]: "
              + json.dumps([r[:2] + [float(f"{v:.3e}") for v in r[2:]]
                            for r in survey]))
        bad = [t for t in ties if t["margin"] > t["bound"]]
        if bad:
            raise AssertionError(f"[{name} parity] the crop clustering's "
                                 f"routes differ beyond a near-tie: {bad}")
        out[mode] = dict(n=n, frames=HELD_OUT, valid_crops=len(survey),
                         max_abs_err=errs, launches=launches,
                         label_ids=[min(ids), max(ids)],
                         seed_near_ties=seed_flips or None,
                         route_near_ties=ties or None,
                         route_seed_near_ties=seed_ties or None)
        if mode == "parity":
            fr, i = first
            feats, _ = crop_embeddings(seg, img[fr:fr + 1], xyz[fr:fr + 1])
            out["probe"] = run_probe(
                f"{name} frame {fr} crop {i}", ["--m", str(M)],
                x=feats[i].reshape(n, D).cpu().numpy())
    return out


def stage2_parts(rec: TimedRecorder) -> dict[int, dict]:
    """The frames' stage-2 ms by part (segment's timing keys
    stage2_crops ... stage2_paste), median per crop bucket."""
    seg = rec.seg
    rows: dict[int, list] = {}
    for res in rec.results:
        k = instances(res.labels[0])
        bucket = next((b for b in seg._buckets if b >= k), seg.max_instances)
        rows.setdefault(bucket, []).append(res.timing)
    return {b: dict(frames=len(r), **{
        part: 1e3 * float(np.median([t["stage2_" + part] for t in r]))
        for part in STAGE2_PARTS}) for b, r in sorted(rows.items())}


def two_stage_test_net(tag: str, stage1: str, crop: str, net: str,
                       side: int, cache: str, out: str, fast: bool
                       ) -> tuple[dict, TimedRecorder]:
    """tools.test_net.main two-stage on the HELD_OUT scenes of the render
    cache: stage 1 from `stage1`, the crop network `net` from `crop` at
    side x side, launches counted exactly per frame; adds the refined
    instances per frame and the stage-2 ms by part and bucket."""
    res, rec = run_test_net(tag, [
        "--cfg", os.path.join(REPO, RECIPE_YML), "--network", NET,
        "--dataset", "synthetic_tabletop_test", "--dataset_root", cache,
        "--pretrained", stage1, "--pretrained_crop", crop,
        "--network_crop", net, "--crop_size", str(side),
        "--max_images", str(HELD_OUT), "--output-dir", out]
        + (["--fast"] if fast else []), HELD_OUT, exact=True)
    res["refined_instances"] = [instances(r.labels_refined[0])
                                for r in rec.results]
    res["segment_ms"] = 1e3 * res["segment_s"]
    res["stage2_ms"] = stage2_parts(rec)
    s1, ref = res["stage1_metrics"], res["refined_metrics"]
    print(f"[{tag}] stage 1 / refined: " + ", ".join(
        f"{k} {s1[k]:.4f} / {ref[k]:.4f}" for k in fast_parity_report.KEYS)
        + f"; refined instances per frame {res['refined_instances']}; "
        f"segment median {res['segment_ms']:.2f} ms; stage 2 ms by bucket: "
        + "; ".join(f"{b} ({r['frames']} frames): " + ", ".join(
            f"{p} {r[p]:.3f}" for p in STAGE2_PARTS)
            for b, r in res["stage2_ms"].items()))
    return res, rec


def run_two_stage(tmp: str, trained: dict, random_crop: str) -> dict:
    """Phase 8c: both zoom-in recipes of CROP_NETS trained on phase 8b's
    cache (bf16, device-resident, CROP_EPOCHS each; no clustering kernel
    launches); tools.test_net two-stage with phase 8b's stage-1 snapshot
    and each crop snapshot on the HELD_OUT scenes in parity and --fast,
    gated; the same in parity with the random-init ResNet-34 crop network
    of phase 5's .pth, which must miss the floor; the kernels on each
    trained crop network's embeddings of every held-out frame."""
    t0 = time.perf_counter()
    work = os.path.join(tmp, "two_stage")
    cache, stage1 = trained["cache"], trained["snapshot"]
    train: dict[str, dict] = {}
    for name, (yml, net) in CROP_NETS.items():
        steps, train_s, step_ms = train_recipe(
            name, yml, net, CROP_EPOCHS, cache, os.path.join(work, name))
        train[name] = dict(network=net, side=CROP_SIDES[name],
                           epochs=CROP_EPOCHS, steps=len(steps),
                           batch=TRAIN_SCENES, train_s=train_s,
                           step_ms=step_ms,
                           loss=[steps[0]["loss"], steps[-1]["loss"]])
    train_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    runs: dict[str, dict] = {}
    kernels: dict[str, dict] = {}
    for name, (_, net) in CROP_NETS.items():
        segs = {}
        for mode in ("parity", "fast"):
            runs[f"{name}/{mode}"], rec = two_stage_test_net(
                f"{name} {mode}", stage1, os.path.join(work, name), net,
                CROP_SIDES[name], cache,
                os.path.join(work, "test_net", name, mode), mode == "fast")
            segs[mode] = rec.seg
        kernels[name] = check_crop_kernels(name, segs, cache)
        del segs, rec
        torch.cuda.empty_cache()
    runs["random/parity"], _ = two_stage_test_net(
        "random crop parity", stage1, random_crop, NET, CROP, cache,
        os.path.join(work, "test_net", "random"), False)
    eval_s = time.perf_counter() - t1

    key = "Objects F-measure"
    gates = dict(floor=TRAINED_FLOOR, fast_gap=FAST_GAP,
                 refine_drop=REFINE_DROP)
    for name in CROP_NETS:
        par, fast = (runs[f"{name}/{m}"]["refined_metrics"][key]
                     for m in ("parity", "fast"))
        stage1 = runs[f"{name}/parity"]["stage1_metrics"][key]
        fewest = min(runs[f"{name}/parity"]["refined_instances"])
        gates[name] = dict(parity_objects_f=par, fast_objects_f=fast,
                           stage1_objects_f=stage1,
                           fewest_refined_instances=fewest)
        print(f"[{name}] gates: refined parity Objects F {par:.4f} >= "
              f"floor {TRAINED_FLOOR} and >= stage 1's {stage1:.4f} - "
              f"{REFINE_DROP}; |fast - parity| {abs(fast - par):.4f} <= "
              f"{FAST_GAP}; an instance in every held-out frame after "
              f"refinement (fewest {fewest})")
        if fewest < 1:
            raise AssertionError(f"[{name}] a held-out frame without an "
                                 "instance after refinement")
        if not par >= TRAINED_FLOOR:
            raise AssertionError(f"[{name}] refined parity Objects F "
                                 f"{par:.4f} below {TRAINED_FLOOR}")
        if not par >= stage1 - REFINE_DROP:
            raise AssertionError(f"[{name}] refined parity Objects F "
                                 f"{par:.4f} more than {REFINE_DROP} below "
                                 f"stage 1's {stage1:.4f}")
        if not abs(fast - par) <= FAST_GAP:
            raise AssertionError(f"[{name}] refined fast Objects F "
                                 f"{fast:.4f} is more than {FAST_GAP} from "
                                 f"parity's {par:.4f}")
    rnd = runs["random/parity"]
    gates["random"] = dict(
        parity_objects_f=rnd["refined_metrics"][key],
        stage1_objects_f=rnd["stage1_metrics"][key],
        refined_instances=rnd["refined_instances"])
    print(f"[random crop] the random-init crop network misses the floor: "
          f"refined parity Objects F {rnd['refined_metrics'][key]:.4f} "
          f"(stage 1 {rnd['stage1_metrics'][key]:.4f}); refined instances "
          f"{rnd['refined_instances']} against stage 1's "
          f"{rnd['stage1_instances']}")
    if not rnd["refined_metrics"][key] < TRAINED_FLOOR:
        raise AssertionError("[random crop] the random-init crop network "
                             "reaches the floor")
    out = dict(train=train, runs=runs, kernels=kernels, gates=gates,
               train_s=train_s, eval_s=eval_s,
               phase_s=time.perf_counter() - t0)
    print(f"phase 8c {out['phase_s']:.1f} s (train {train_s:.1f}, "
          f"evaluation and kernel checks {eval_s:.1f})")
    return out


# ---------------------------------------------------------------------------
# phase 2c: the rgbd_cat recipes (128-D embeddings)
# ---------------------------------------------------------------------------

def crop_shapes() -> list[tuple[int, str]]:
    """Stage 2's crop sides, largest first, with the tag of their lines."""
    return [(side, ", crop" + ("" if side == CROP else f" {side}"))
            for side in sorted(set(CROP_SIDES.values()), reverse=True)]


def stage2_modes(tag: str, cfg: Config, state: dict, state_crop: dict,
                 counts: tuple = STAGE2_INSTANCES) -> dict:
    """Phase 2c (b) and 2d (c), stage 2: cfg's stage-1 and crop networks at
    CROP^2 on phase 4's box frames of `counts` boxes (the boxes as the
    stage-1 labels), the inputs as segment gives them for cfg.INPUT (a
    missing one is zeros; without XYZ, COLOR, the paste is ordered by RoI
    area), in both modes with the counters set to 0 before the mode's
    frames and read after: every kernel exactly once per valid crop; in
    parity the kernel route's refined labels equal the plain route's."""
    segs = {"parity": Segmentor(cfg, state, state_crop),
            "fast": Segmentor(cfg.replace(CLUSTER=dict(FAST_CLUSTER)), state,
                              state_crop, model_dtype=torch.bfloat16)}
    frames = {}
    for k, (img, xyz, labels, labels_np) in stage2_frames(cfg,
                                                          counts).items():
        zeros = torch.zeros_like(img)
        frames[k] = (img if cfg.INPUT != "DEPTH" else zeros,
                     xyz if cfg.INPUT != "COLOR" else zeros, labels,
                     labels_np)
    has_depth = cfg.INPUT != "COLOR"
    out: dict = {"launches": {}, "ms": {}, "refined_instances": {}}
    for mode, seg in segs.items():
        reset_counts()
        ms = {}
        for k, frame in frames.items():
            rows = []
            for i in range(2):  # the first call warms up
                timing: dict[str, float] = {}
                refine(seg, frame, seed=i, timing=timing,
                       has_depth=has_depth)
                rows.append(1e3 * timing["stage2"])
            ms[k] = rows[1]
        crops = 2 * sum(frames)
        out["launches"][mode] = launch_counts()
        out["ms"][mode] = ms
        print(f"[{tag} {mode}] stage 2, {crops} valid crops: launches "
              f"{out['launches'][mode]}; ms per frame at "
              f"{', '.join(map(str, frames))} instances "
              + ", ".join(f"{v:.3f}" for v in ms.values()))
        if set(out["launches"][mode].values()) != {crops}:
            raise AssertionError(f"[{tag} {mode}] stage 2 launched "
                                 f"{out['launches'][mode]}, not once per "
                                 f"valid crop ({crops})")
    seg = segs["parity"]
    kernel_kw = seg._ms_kw
    for k, frame in frames.items():
        got = refine(seg, frame, seed=7, has_depth=has_depth)
        seg._ms_kw = dict(kernel_kw, use_pallas=False)
        want = refine(seg, frame, seed=7, has_depth=has_depth)
        seg._ms_kw = kernel_kw
        out["refined_instances"][k] = instances(want)
        n_diff = int((got != want).sum())
        print(f"[{tag} parity] stage 2, {k} instances, kernel route vs "
              f"plain route: {instances(want)} refined instances, {n_diff} "
              f"pixels differ")
        if n_diff:
            raise AssertionError(f"[{tag}] stage 2's kernel route differs "
                                 "from its plain route")
    return out


def trained_cut(tag: str, recipe: str, epochs: int, work: str, cache: str
                ) -> dict:
    """Phase 2c (d) and 2d (e): the stage-1 recipe yml `recipe` trained on
    phase 8b's render cache (`epochs`, --bf16 --device-resident), then on
    each of CAT_FRAMES held-out frames' trained embeddings (COLOR: the
    image alone, and no depth filter) every kernel against its plain
    version in both modes with the hill climb held to the float64 result
    (check_kernels with against_exact: the seeds exact or parting at a
    near-tie below SEED_GAP), and in parity the kernel route against the
    plain route (route_ties: labels equal but at certified near-ties);
    the assignment's re-checked pixels per frame and mode."""
    snapshots = os.path.join(work, "snapshots")
    steps, train_s, step_ms = train_recipe(tag, recipe, NET, epochs, cache,
                                           snapshots)
    cfg = Config.from_yaml(os.path.join(REPO, recipe))
    seg = build_segmentor(cfg, NET, pretrained=snapshots)
    img, xyz = held_out_frames(cache, CAT_FRAMES, DEV)
    errs: dict[str, float] = {}  # the largest over the frames
    seed_flips, seed_ties, ties, found = [], [], [], []
    rechecked = {"parity": [], "fast": []}  # the assignment's, per frame
    for fr in range(CAT_FRAMES):
        res = seg.segment(*modality_inputs(cfg, img[fr:fr + 1],
                                           xyz[fr:fr + 1]),
                          refine=False, return_features=True)
        found.append(instances(res.labels[0]))
        x = torch.from_numpy(res.features[0]).cuda()
        x = x.reshape(-1, x.shape[-1])
        for mode in ("parity", "fast"):
            with contextlib.redirect_stdout(io.StringIO()):
                checked = check_kernels(
                    mode, x, None, where=f", {tag} frame {fr}",
                    timed=False, against_exact=True, far=False)
            for kernel, r in checked.items():
                for key in ("max_abs_err", "exact_err", "plain_exact_err"):
                    if key in r:
                        k = (f"{mode}/{kernel}" + ("" if key == "max_abs_err"
                                                   else "_" + key[:-4]))
                        errs[k] = max(errs.get(k, 0.0), r[key])
            rechecked[mode].append(checked["assign_labels"]["rechecked"])
            if checked["select_seeds"]["differing_step"] >= 0:
                seed_flips.append(dict(
                    mode=mode, frame=fr,
                    step=checked["select_seeds"]["differing_step"],
                    gap=checked["select_seeds"]["max_abs_err"]))
        routes = [mean_shift_smart_init(
            x, torch.Generator().manual_seed(fr),
            **dict(seg._ms_kw, use_pallas=pallas)) for pallas in (True, False)]
        seed_tie, t = route_ties(f"{tag} parity, frame {fr}", x, *routes)
        if seed_tie:
            seed_ties.append(dict(frame=fr, **seed_tie))
        if t:
            ties.append(dict(frame=fr, **t))
    print(f"[{tag}] kernels on the trained {x.shape[-1]}-D embeddings of "
          f"{CAT_FRAMES} held-out frames at {TH}x{TW} (stage-1 instances "
          f"{found}): each kernel equal to its plain version, the seeding "
          f"but at near-ties (mode, frame: step, gap) "
          + (", ".join(f"{t['mode']}, {t['frame']}: {t['step']}, "
                       f"{t['gap']:.2e}" for t in seed_flips) or "none")
          + f"; largest readings {json.dumps(errs)}; parity kernel route "
          f"vs plain route: seeds parting at a near-tie (frame: step, gap) "
          + (", ".join(f"{t['frame']}: {t['step']}, {t['gap']:.2e}"
                       for t in seed_ties) or "none")
          + ", pixels that differ (frame: pixels, largest margin, bound) "
          + (", ".join(f"{t['frame']}: {t['pixels']}, {t['margin']:.2e}, "
                       f"{t['bound']:.2e}" for t in ties) or "none"))
    print(f"[{tag}] assign_labels pixels re-checked exactly per frame: "
          f"parity {rechecked['parity']}, fast {rechecked['fast']} (of "
          f"{x.shape[0]} a frame)")
    bad = [t for t in ties if t["margin"] > t["bound"]]
    if bad:
        raise AssertionError(f"[{tag}] the routes differ beyond a "
                             f"near-tie: {bad}")
    return dict(steps=len(steps), epochs=epochs, train_s=train_s,
                step_ms=step_ms, loss=[steps[0]["loss"], steps[-1]["loss"]],
                frames=CAT_FRAMES, stage1_instances=found, max_abs_err=errs,
                seed_near_ties=seed_flips or None,
                assign_rechecked=rechecked,
                route_seed_near_ties=seed_ties or None,
                route_near_ties=ties or None)


def lazy_checks() -> dict:
    """Phase 2c (a'): the width-128 seeding's lazy tiles at the frame, in
    parity on random unit vectors (made on the card from a seed): the
    kernel against its plain version (seeds equal, or parting at a float32
    near-tie below SEED_GAP, as on the clustered input), its path and
    refreshed share, timed beside its bound."""
    tag = "cat parity, uniform"
    gen = torch.Generator(device="cuda").manual_seed(49)
    u = torch.randn(N, CAT_D, device="cuda", generator=gen)
    u /= u.norm(dim=1, keepdim=True)
    first = 12345 % N
    got_s, got_i = cuda_seeding.select_seeds(u, M, first)
    path = seed_path(u)
    want_s, want_i = cuda_seeding.select_seeds_reference(u, M, first)
    step, gap = seed_gap(u, got_i, want_i)
    print(f"[{tag}] select_seeds: first differing step {step}, min-distance"
          f" gap there {gap:.3e}; {path_text(path)}")
    if step >= 0 and not gap < SEED_GAP:
        raise AssertionError(f"[{tag}] seeding differs at step {step} "
                             f"(gap {gap:.3e})")
    call = functools.partial(cuda_seeding.select_seeds, u, M, first)
    r = dict(max_abs_err=float((got_s - want_s).abs().max()) if step < 0
             else float(gap), differing_step=step, **path,
             bound=bound(N * CAT_D * 4 + M * (CAT_D * 4 + 4),
                         2.0 * (M - 1) * N * CAT_D, torch.float32),
             ms=time_ms(call, 10),
             plain_ms=time_ms(functools.partial(
                 cuda_seeding.select_seeds_reference, u, M, first), 3),
             device_ms=device_ms(call, KERNEL_NAMES["select_seeds"], 10),
             queued_ms=queued_ms(call, 10))
    print(f"[{tag}] select_seeds: kernel {r['ms']:.4f} ms (device "
          f"{r['device_ms']:.4f} ms, queued {r['queued_ms']:.4f} ms), plain "
          f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
          f"({r['bound'][1]})")
    return r


def run_cat(tmp: str, cache: str) -> dict:
    """Phase 2c: the JAX repo's rgbd_cat recipes, whose cat fusion
    concatenates the two towers' 64-D outputs into 128-D embeddings, on
    the kernels' width-128 instantiations.  (a) each kernel against its
    plain version at the frame (n = 480*640, m = 100) and both crop
    shapes in both modes, timed beside its bound (check_kernels: the same
    checks and tolerances as phase 2; the seeding's path and refreshed
    share), and the lazy seeding on random unit vectors (lazy_checks); (b)
    stage 1 through
    Segmentor.segment_sample with the cat network of CAT_YML at 480x640
    in both modes (run_slice: counters set to 0 before each mode's frames
    and read after, every kernel launched), in parity the kernel route's
    labels equal to the plain route's on the same embeddings, then stage
    2 with a cat crop network (stage2_modes); (c) tools.test_net with
    CAT_YML on the committed TableTop tree in both modes, each kernel
    exactly once a frame and once per valid crop; (d) trained_cut on
    phase 8b's render cache (`cache`)."""
    t0 = time.perf_counter()
    work = os.path.join(tmp, "cat")
    os.makedirs(work, exist_ok=True)
    x32, z_valid = clustered_embeddings(seed=20, d=CAT_D)
    checks = {mode: check_kernels(mode, x32, z_valid, where=", cat")
              for mode in ("parity", "fast")}
    lazy = lazy_checks()
    del x32, z_valid
    crop_checks = {}
    for seed, (side, where) in enumerate(crop_shapes(), start=21):
        x_crop, _ = clustered_embeddings(seed=seed, n=side * side, d=CAT_D)
        crop_checks[side] = {mode: check_kernels(mode, x_crop, None,
                                                 where=", cat" + where)
                             for mode in ("parity", "fast")}
        del x_crop
    kernels_s = time.perf_counter() - t0

    cfg = Config.from_yaml(os.path.join(REPO, CAT_YML)).replace(MODE="TEST")
    torch.manual_seed(20)
    net = get_network(NET, cfg)
    if net.embedding_dim != CAT_D:
        raise AssertionError(f"{CAT_YML}: {net.embedding_dim}-D embeddings")
    state = net.state_dict()
    torch.manual_seed(21)
    state_crop = get_network(NET, cfg).state_dict()
    bgr, depth = tabletop_frame()
    img, xyz = preprocess_rgbd(torch.from_numpy(bgr).cuda(),
                               torch.from_numpy(depth).cuda(),
                               cfg.pixel_means, *INTR)
    frame = {"image_color": img, "depth": xyz}
    counts, timings, features = run_slice(cfg, state, frame, d=CAT_D,
                                          where="cat ")
    kw = dict(kappa=KAPPA, num_seeds=M, max_iters=ITERS, epsilon=EPS,
              metric="cosine", first_index=4321, seed_subsample=1,
              compute_dtype="float32", filter_threshold=0.8,
              z_valid=(xyz[..., 2] > 0).reshape(N))
    feats = features.reshape(N, CAT_D)
    k_route = mean_shift_smart_init(feats, use_pallas=True, **kw)
    p_route = mean_shift_smart_init(feats, use_pallas=False, **kw)
    n_diff = int((k_route.labels != p_route.labels).sum())
    step, gap = seed_gap(feats, k_route.seed_indices, p_route.seed_indices)
    print(f"[cat parity] kernel route vs plain route on the cat network's "
          f"embeddings: {n_diff} pixels differ; seeds first differ at step "
          f"{step} (gap {gap:.3e}); max |Z - Z_plain| "
          f"{float((k_route.seeds - p_route.seeds).abs().max()):.3e}")
    # the labels equal; the seeds too, or parting at a float32 near-tie
    if n_diff or (step >= 0 and not gap < SEED_GAP):
        raise AssertionError("[cat] the kernel route differs from the plain "
                             "route on the cat network's embeddings")
    stage2 = stage2_modes("cat", cfg, state, state_crop)

    paths = {}
    for name, st in (("main", state), ("crop", state_crop)):
        paths[name] = os.path.join(work, f"{name}.pth")
        torch.save({"model": {"module." + k: v for k, v in st.items()}},
                   paths[name])
    tests = {}
    for mode in ("parity", "fast"):
        tests[mode], _ = run_test_net(f"cat {mode}, tabletop_object_test", [
            "--dataset", "tabletop_object_test", "--dataset_root", TABLETOP,
            "--cfg", os.path.join(REPO, CAT_YML), "--network", NET,
            "--pretrained", paths["main"], "--pretrained_crop", paths["crop"],
            "--max_images", str(TABLETOP_FRAMES), "--output-dir",
            os.path.join(work, "test_net", mode)]
            + (["--fast"] if mode == "fast" else []), TABLETOP_FRAMES,
            exact=True)
    del state, state_crop, net
    torch.cuda.empty_cache()
    trained = trained_cut("cat trained", CAT_RECIPE_YML, CAT_EPOCHS, work,
                          cache)
    out = dict(checks=checks, crop_checks=crop_checks, lazy=lazy,
               kernels_s=kernels_s,
               stage1_launches=counts, stage1_ms=timings, stage2=stage2,
               test_net=tests, trained=trained,
               phase_s=time.perf_counter() - t0)
    print(f"phase 2c {out['phase_s']:.1f} s (kernels {kernels_s:.1f}, "
          f"training {trained['train_s']:.1f})")
    return out


# ---------------------------------------------------------------------------
# phase 2d: the COLOR, DEPTH and RGB-D early recipes
# ---------------------------------------------------------------------------

def modality_yml(modality: str, crop: bool = False) -> str:
    """The JAX repo's tabletop yml of a modality (its crop yml with
    `crop`)."""
    return os.path.join(REPO, "experiments", "cfgs",
                        f"seg_resnet34_8s_embedding_cosine_{modality}"
                        f"{'_crop' if crop else ''}_tabletop.yml")


def modality_inputs(cfg: Config, img, xyz) -> tuple:
    """(image, XYZ) as the Segmentor of cfg takes them: COLOR passes no
    XYZ (stage 1 then clusters without the depth filter), DEPTH no image."""
    return (None if cfg.INPUT == "DEPTH" else img,
            None if cfg.INPUT == "COLOR" else xyz)


def modality_slice(modality: str, work: str, seed: int) -> dict:
    """Phase 2d (b)-(d) for one modality: its tabletop yml's network
    (fixed-seed init) through run_slice at 480x640 in both modes, in
    parity the kernel route's labels equal to the plain route's on the
    same embeddings (COLOR without the depth filter); its crop yml's
    network on phase 4's 8-box frame (stage2_modes); tools.test_net with
    both on the committed TableTop tree in both modes (each kernel exactly
    once a frame and once per valid crop)."""
    tag = modality
    cfg = Config.from_yaml(modality_yml(modality)).replace(MODE="TEST")
    torch.manual_seed(seed)
    net = get_network(NET, cfg)
    towers = 1 + hasattr(net, "fcn_depth")
    if towers != 1 or net.embedding_dim != D:
        raise AssertionError(f"[{tag}] {towers} towers, "
                             f"{net.embedding_dim}-D embeddings")
    state = net.state_dict()
    conv1 = state[f"fcn.{net.network_name}.conv1.weight"].shape[1]
    crop_cfg = Config.from_yaml(modality_yml(modality, crop=True))
    torch.manual_seed(seed + 1)
    state_crop = get_network(NET, crop_cfg).state_dict()
    bgr, depth = tabletop_frame()
    img, xyz = preprocess_rgbd(torch.from_numpy(bgr).cuda(),
                               torch.from_numpy(depth).cuda(),
                               cfg.pixel_means, *INTR)
    img, xyz = modality_inputs(cfg, img, xyz)
    frame = {k: v for k, v in (("image_color", img), ("depth", xyz))
             if v is not None}
    print(f"[{tag}] INPUT {cfg.INPUT}, FUSION_TYPE {cfg.TRAIN.FUSION_TYPE}:"
          f" one tower, conv1 takes {conv1} channels; frame inputs "
          f"{sorted(frame)}")
    counts, timings, features = run_slice(cfg, state, frame,
                                          where=tag + " ",
                                          frames=MODALITY_FRAMES)
    z_valid = None if xyz is None else (xyz[..., 2] > 0).reshape(N)
    kw = dict(kappa=KAPPA, num_seeds=M, max_iters=ITERS, epsilon=EPS,
              metric="cosine", first_index=4321, seed_subsample=1,
              compute_dtype="float32", z_valid=z_valid,
              filter_threshold=0.0 if z_valid is None else 0.8)
    feats = features.reshape(N, D)
    k_route = mean_shift_smart_init(feats, use_pallas=True, **kw)
    p_route = mean_shift_smart_init(feats, use_pallas=False, **kw)
    n_diff = int((k_route.labels != p_route.labels).sum())
    step, gap = seed_gap(feats, k_route.seed_indices, p_route.seed_indices)
    print(f"[{tag} parity] kernel route vs plain route on the network's "
          f"embeddings{'' if z_valid is not None else ', unfiltered'}: "
          f"{n_diff} pixels differ; seeds first differ at step {step} (gap "
          f"{gap:.3e})")
    if n_diff or step >= 0:
        raise AssertionError(f"[{tag}] the kernel route differs from the "
                             "plain route on the network's embeddings")
    stage2 = stage2_modes(tag, cfg, state, state_crop,
                          counts=STAGE2_INSTANCES[:1])

    paths = {}
    for name, st in (("main", state), ("crop", state_crop)):
        paths[name] = os.path.join(work, f"{modality}_{name}.pth")
        torch.save({"model": {"module." + k: v for k, v in st.items()}},
                   paths[name])
    tests = {}
    for mode in ("parity", "fast"):
        tests[mode], _ = run_test_net(f"{tag} {mode}, tabletop_object_test", [
            "--dataset", "tabletop_object_test", "--dataset_root", TABLETOP,
            "--cfg", modality_yml(modality), "--network", NET,
            "--pretrained", paths["main"], "--pretrained_crop", paths["crop"],
            "--max_images", str(TABLETOP_FRAMES), "--output-dir",
            os.path.join(work, "test_net", modality, mode)]
            + (["--fast"] if mode == "fast" else []), TABLETOP_FRAMES,
            exact=True)
    del state, state_crop, net
    torch.cuda.empty_cache()
    return dict(input=cfg.INPUT, fusion=cfg.TRAIN.FUSION_TYPE,
                conv1_channels=conv1, stage1_launches=counts,
                stage1_ms=timings, stage2=stage2, test_net=tests)


def run_modalities(tmp: str, cache: str) -> dict:
    """Phase 2d: the JAX repo's COLOR, DEPTH and RGB-D early-fusion
    recipes, each one tower.  (a) each kernel against its plain version at
    the frame (n = 480*640, d = 64, m = 100) with no depth mask, as a COLOR
    frame's stage 1 runs them, in both modes (check_kernels: phase 2's
    checks, tolerances, launch configurations and times beside the bound),
    and the whole clustering with filter_threshold 0, kernel route against
    plain route (check_route); (b)-(d) modality_slice for each modality;
    (e) COLOR_RECIPE_YML trained on phase 8b's render cache (`cache`) and
    its kernels on held-out frames' trained embeddings (trained_cut)."""
    t0 = time.perf_counter()
    work = os.path.join(tmp, "modalities")
    os.makedirs(work, exist_ok=True)
    x32, _ = clustered_embeddings(seed=30)
    checks = {mode: check_kernels(mode, x32, None, where=", unfiltered")
              for mode in ("parity", "fast")}
    routes_ms = {mode: check_route(mode, x32, None)
                 for mode in ("parity", "fast")}
    del x32
    kernels_s = time.perf_counter() - t0
    slices = {m: modality_slice(m, work, seed=30 + 2 * i)
              for i, m in enumerate(MODALITIES)}
    trained = trained_cut("color trained", COLOR_RECIPE_YML, COLOR_EPOCHS,
                          os.path.join(work, "color"), cache)
    out = dict(checks=checks, cluster_ms=routes_ms, kernels_s=kernels_s,
               slices=slices, color_trained=trained,
               phase_s=time.perf_counter() - t0)
    print(f"phase 2d {out['phase_s']:.1f} s (kernels {kernels_s:.1f}, "
          f"color training {trained['train_s']:.1f})")
    return out


# ---------------------------------------------------------------------------
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


def readings(r: dict, prefix: str) -> dict:
    """One kernel's check_kernels reading for the kernels line, its keys
    prefixed: error, ms, device ms, plain ms and bound, the time to read X
    once a step or iteration where the kernel may (the eager seeding, the
    hill climb), and where timed (the hill climb) the library call's ms
    and backend and the launch configuration."""
    out = {prefix + "max_abs_err": r["max_abs_err"], prefix + "ms": r["ms"],
           prefix + "device_ms": r["device_ms"],
           prefix + "plain_ms": r["plain_ms"],
           prefix + "bound_ms": r["bound"][0],
           prefix + "bound_by": r["bound"][1]}
    for key in ("rereads_ms", "library_ms", "library_backend", "library_err",
                "launch"):
        if key in r:
            out[prefix + key] = r[key]
    return out


def kernel_readings(name: str, checks: dict, crop_checks: dict) -> dict:
    """One kernel's readings for the kernels line from check_kernels at the
    frame (checks[mode]) and at each crop side (crop_checks[side][mode]):
    errors, ms, device ms, plain ms and bound in both modes."""
    par, fast = checks["parity"][name], checks["fast"][name]
    out = dict(**readings(par, ""), **readings(fast, "fast_"))
    out.setdefault("library_ms", None)
    for side, by_mode in crop_checks.items():
        crop = "crop_" if side == CROP else f"crop{side}_"
        for mode, prefix in (("parity", crop), ("fast", "fast_" + crop)):
            out.update(readings(by_mode[mode][name], prefix))
    if name == "connected_components":
        out.update(merge_steps=par["merge_steps"],
                   fast_merge_steps=fast["merge_steps"],
                   pairwise_far_ms=par["far_ms"],
                   pairwise_far_device_ms=par["far_device_ms"],
                   fast_pairwise_far_ms=fast["far_ms"],
                   fast_pairwise_far_device_ms=fast["far_device_ms"],
                   pairwise_far_merge_steps=par["far_merge_steps"])
    return out


def seed_readings(cat: dict) -> dict:
    """The width-128 seeding's lazy readings for the kernels line: the
    path and refreshed share at the frame in both modes, and the uniform
    input's reading."""
    out = {}
    for mode, prefix in (("parity", ""), ("fast", "fast_")):
        r = cat["checks"][mode]["select_seeds"]
        out.update({prefix + "seed_path": r["seed_path"],
                    prefix + "tile_pixels": r["tile_pixels"],
                    prefix + "refreshed_share": r.get("refreshed_share")})
    uniform = cat["lazy"]
    out.update(readings(uniform, "uniform_"),
               uniform_queued_ms=uniform["queued_ms"],
               uniform_refreshed_share=uniform.get("refreshed_share"))
    return out


def modality_launches(name: str, modalities: dict) -> dict:
    """One kernel's launches on phase 2d's paths: per modality and mode,
    its stage-1 frames, its stage-2 calls and its test_net run."""
    out = {}
    for m, r in modalities["slices"].items():
        for mode in ("parity", "fast"):
            out[f"{m}/{mode}"] = dict(
                stage1=r["stage1_launches"][mode][name],
                stage2=r["stage2"]["launches"][mode][name],
                test_net=r["test_net"][mode]["launches"][name])
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
    crop_checks = {}  # crop side -> mode -> kernel -> readings
    for seed, (side, where) in enumerate(crop_shapes(), start=2):
        x_crop, _ = clustered_embeddings(seed=seed, n=side * side)
        crop_checks[side] = {mode: check_kernels(mode, x_crop, None,
                                                 where=where)
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
    slice_routes("", features, xyz)
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

            # phase 7b: phase 5's .pth files, phase 6's render cache and
            # resident step
            no_opencv = run_data_no_opencv(work, tmp, paths, training)
            data["test_net"].update(no_opencv["test_net"])
            print(f"wall after phase 7b {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 8
            alternates = run_alternates(frame)
            print(f"wall after phase 8 {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 8b: phase 5's .pth of phase 3's random-init ResNet
            trained = run_trained(tmp, paths["main"])
            print(f"wall after phase 8b {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 8r: ResNet-50-8s on phase 3's frame, phase 7's tree
            # and phase 8b's render cache
            resnet50 = run_resnet50(frame, work, tmp, trained["cache"])
            print(f"wall after phase 8r {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 8c: phase 8b's cache and snapshot, phase 5's .pth of
            # phase 4's random-init crop network
            two_stage = run_two_stage(tmp, trained, paths["crop"])
            print(f"wall after phase 8c {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 2c: the rgbd_cat recipes at width 128; phase 8b's
            # render cache
            cat = run_cat(tmp, trained["cache"])
            print(f"wall after phase 2c {time.perf_counter() - t_start:.1f}"
                  " s")

            # phase 2d: the COLOR, DEPTH and RGB-D early recipes; phase
            # 8b's render cache
            modalities = run_modalities(tmp, trained["cache"])
            print(f"wall after phase 2d {time.perf_counter() - t_start:.1f}"
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
            resnet50_launches=resnet50["launches"]["parity"][name],
            fast_resnet50_launches=resnet50["launches"]["fast"][name],
            resnet50_test_net_launches=resnet50["test_net"]["parity"][
                "launches"][name],
            fast_resnet50_test_net_launches=resnet50["test_net"]["fast"][
                "launches"][name],
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
            refined_launches={
                crop: two_stage["runs"][f"{crop}/parity"]["launches"][name]
                for crop in CROP_NETS},
            fast_refined_launches={
                crop: two_stage["runs"][f"{crop}/fast"]["launches"][name]
                for crop in CROP_NETS},
            random_crop_refined_launches=two_stage["runs"]["random/parity"][
                "launches"][name],
            modality_launches=modality_launches(name, modalities),
            **kernel_readings(name, checks, crop_checks),
            # phase 2d (a): at the frame without a depth mask
            **readings(modalities["checks"]["parity"][name], "unfiltered_"),
            **readings(modalities["checks"]["fast"][name],
                       "fast_unfiltered_")))
    for name, (source, replaces) in KERNELS.items():
        # the width-128 instantiation: launches on phase 2c's paths
        kernels.append(dict(
            name=f"{name}_d{CAT_D}", route="cuda", source=source,
            replaces=replaces, launches=cat["stage1_launches"]["parity"][name],
            fast_launches=cat["stage1_launches"]["fast"][name],
            stage2_launches=cat["stage2"]["launches"]["parity"][name],
            fast_stage2_launches=cat["stage2"]["launches"]["fast"][name],
            test_net_launches=cat["test_net"]["parity"]["launches"][name],
            fast_test_net_launches=cat["test_net"]["fast"]["launches"][name],
            **({"kernel": cat["checks"]["parity"][name]["launch"]["kernel"],
                "fast_kernel": cat["checks"]["fast"][name]["launch"][
                    "kernel"]} if name in ("connected_components",
                                           "assign_labels") else {}),
            **kernel_readings(name, cat["checks"], cat["crop_checks"]),
            **(seed_readings(cat) if name == "select_seeds" else {})))
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
    print(json.dumps({"data_no_opencv": no_opencv}))
    print(json.dumps({"alternates": alternates}))
    print(json.dumps({"trained": trained}))
    print(json.dumps({"resnet50": resnet50}))
    print(json.dumps({"two_stage": two_stage}))
    print(json.dumps({"cat": {k: v for k, v in cat.items()
                              if k not in ("checks", "crop_checks")}}))
    print(json.dumps({"modalities": {k: v for k, v in modalities.items()
                                     if k != "checks"}}))
    print(json.dumps({"data_parallel": data_parallel}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
