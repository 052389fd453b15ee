"""Two-stage refinement on weights the port trained, in both packages, on
the CPU.

The port's tools.train_net trains a stage-1 network on the recipe of
unseenobjectclustering_torch/cfgs/synthetic_240x320_rgbd_add.yml and a
crop network on synthetic_crop128_r18_240x320_rgbd_add.yml, each cut to
48x64 frames (32^2 crops), ResNet-18-8s with 8-D embeddings, batch 2 and
a few steps, on scenes the port's renderer makes.  Both snapshots are
exported as reference-layout .pth files ({'model': {'module.' + key}}), as
a training run's users ship them, and each package builds its two-stage
Segmentor from them through its own build_segmentor (the JAX one reads
them with utils/checkpoint.load_torch_checkpoint).  Two held-out frames
are segmented with refinement, the first seed pinned on both Segmentors:
trained BatchNorm statistics, crop RoIs, the crop network, the crops'
clustering, the veto and the paste all run on weights no flax init made.

Tolerances: stage-1 and refined labels equal; the crop embeddings of
every valid slot within 1e-4 of JAX's on the same crops (convolutions sum
in another order).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)
from unseenobjectclustering_torch.engine import builder as tbuilder
from unseenobjectclustering_torch.ops.preprocess import compute_xyz_np
from unseenobjectclustering_torch.tools import render_dataset, train_net
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.engine import builder as jbuilder
from unseenobjectclustering_tpu.ops import roi as jroi
from unseenobjectclustering_tpu.ops.train_pipeline import (
    _dense_relabel as jax_dense_relabel)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(REPO, "unseenobjectclustering_torch", "cfgs")
NET = "seg_resnet18_8s_embedding"
H, W, SIDE = 48, 64, 32
FIRST = 5
# the cut each recipe takes: 48x64 frames, batch 2, 8-D embeddings
CUT = dict(SYN_HEIGHT=H, SYN_WIDTH=W, SYN_CROP_SIZE=SIDE, IMS_PER_BATCH=2,
           NUM_UNITS=8, SYNNUM=4, EMBEDDING_SAMPLING_NUM=100)
EPOCHS = 4  # of 2 steps each: stage 1 then finds an instance a frame


def train(root, cache, recipe):
    """tools.train_net on the recipe yml cut to CUT; returns the .pth of
    its last snapshot and the cut yml."""
    tree = yaml.safe_load(open(os.path.join(CFGS, recipe)))
    tree["TRAIN"].update(CUT)
    yml = root / (recipe + ".cut.yml")
    yml.write_text(yaml.safe_dump(tree))
    out = root / ("snapshots_" + recipe)
    train_net.main(["--cfg", str(yml), "--network", NET, "--solver", "adam",
                    "--epochs", str(EPOCHS), "--device-resident",
                    "--render-cache", cache, "--workers", "0", "--device",
                    "cpu", "--output-dir", str(out)])
    cfg = tcfg.Config.from_yaml(str(yml)).replace(MODE="TEST")
    state = tbuilder.load_network_state(cfg, NET, str(out / str(EPOCHS)))
    pth = str(root / (recipe + ".pth"))
    torch.save({"model": {"module." + k: v for k, v in state.items()}}, pth)
    return pth, str(yml)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("trained_refinement")
    cache = str(root / "cache")
    for split, num in (("train", 4), ("test", 2)):
        render_dataset.main(["--cache-dir", cache, "--split", split,
                             "--height", str(H), "--width", str(W),
                             "--num", str(num)])
    stage1, yml = train(root, cache, "synthetic_240x320_rgbd_add.yml")
    crop, _ = train(root, cache, "synthetic_crop128_r18_240x320_rgbd_add.yml")
    return dict(stage1=stage1, crop=crop, yml=yml, cache=cache)


def held_out(cfg, cache):
    """The test split's scenes as (image, XYZ) [1, H, W, 3] numpy pairs."""
    ds = SyntheticTabletopDataset("test", cfg, height=H, width=W, size=2,
                                  cache_dir=cache)
    frames = []
    for i in range(2):
        bgr, depth_mm, _ = ds.get_scene(i)
        img = bgr.astype(np.float32) / 255.0 - cfg.pixel_means / 255.0
        xyz = compute_xyz_np(depth_mm.astype(np.float32) / 1000.0, ds.f,
                             ds.f, ds.cx, ds.cy)
        frames.append((img[None], xyz[None]))
    return frames


def test_refinement_on_port_trained_weights_matches_jax(trained):
    """Stage-1 and refined labels of both packages' Segmentors, built from
    the port's trained .pth files, are equal on two held-out frames, and
    the crop network's embeddings of every valid slot agree."""
    tc = tcfg.Config.from_yaml(trained["yml"]).replace(MODE="TEST")
    jc = jcfg.Config.from_yaml(trained["yml"]).replace(
        MODE="TEST", **{"CLUSTER.USE_PALLAS": False})
    tseg = tbuilder.build_segmentor(
        tc, NET, pretrained=trained["stage1"],
        pretrained_crop=trained["crop"], crop_network_name=NET,
        depth_threshold=None, device="cpu")
    jseg = jbuilder.build_segmentor(
        jc, NET, pretrained=trained["stage1"],
        pretrained_crop=trained["crop"], crop_network_name=NET,
        depth_threshold=None, height=H, width=W)
    for seg in (tseg, jseg):
        seg._ms_kw = dict(seg._ms_kw, first_index=FIRST)
    # trained BatchNorm statistics, not an init's
    bn = tseg.model_crop.fcn.resnet18_8s.bn1
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))

    seen = []
    hook = tseg.model_crop.register_forward_hook(
        lambda module, args, out: seen.append(
            (args[0].clone(), args[1].clone(), out.clone())))
    refined_crops = 0
    try:
        for img, xyz in held_out(tc, trained["cache"]):
            got = tseg.segment(img, xyz, refine=True)
            want = jseg.segment(img, xyz, refine=True)
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_array_equal(got.labels_refined,
                                          want.labels_refined)

            # the crop network's embeddings on JAX's crops of this frame
            rgb, dep, feats = seen[-1]
            labels = np.asarray(want.labels[0])
            dense = jax_dense_relabel(
                jnp.asarray(labels), max_id=int(jseg._ms_kw["num_seeds"]))
            crops = jroi.crop_rois(jnp.asarray(img[0]), dense,
                                   jnp.asarray(xyz[0]),
                                   max_instances=feats.shape[0],
                                   crop_size=SIDE)
            valid = np.asarray(crops.valid)
            np.testing.assert_allclose(rgb.numpy(),
                                       np.asarray(crops.rgb_crops), atol=1e-5)
            np.testing.assert_allclose(dep.numpy(),
                                       np.asarray(crops.depth_crops),
                                       atol=1e-5)
            jfeats = np.asarray(jseg.model_crop.apply(
                jseg.variables_crop, crops.rgb_crops, crops.depth_crops,
                train=False))
            np.testing.assert_allclose(feats.numpy()[valid], jfeats[valid],
                                       rtol=0, atol=1e-4)
            refined_crops += int(valid.sum())
    finally:
        hook.remove()
    assert len(seen) == 2
    assert refined_crops > 0  # stage 1 found instances to refine
