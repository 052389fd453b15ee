"""Two-stage refinement with the port's zoom-in recipes, on the CPU.

- The port's crop ymls (unseenobjectclustering_torch/cfgs/
  synthetic_crop*_240x320_rgbd_add.yml) against the JAX repo's
  experiments/cfgs recipes they copy: equal but for the keys each header
  lists, the same Config as the JAX Config with those keys set, and the
  frame size of the stage-1 recipe whose render cache they train on.
- The crop recipe (make_device_augment_crop with the ymls' DEPTH_ARTIFACTS)
  against the JAX package's at the recipe's scale: crops of a frame a
  quarter of 240x320 resized up to a quarter of 224^2, draws replayed
  from the JAX key as tests/test_torch_train_pipeline.py does.
- tools.test_net with --network_crop and --crop_size on the OCID fixture
  tree of tests/test_torch_test_net.py against the JAX evaluate_dataset
  with build_segmentor(crop_network_name=...) and the same SYN_CROP_SIZE
  (ResNet-18 networks, first seed pinned).
- tools.train_net on each crop yml, cut to a 48x64 render cache, with
  --bf16 --device-resident --device cpu: its snapshot directory serves as
  pretrained_crop of build_segmentor, and segment(refine=True) runs.
- The recipe script parses, and every config and network it names exists.

Tolerances: the metric dicts and .mat labels of test_net are equal to
JAX's; the crop recipe's as in tests/test_torch_train_pipeline.py (labels
exact, XYZ within 1e-6, images within 2e-3 of 255); the served crop
network's tensors equal the trainer's.
"""

import os
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
import yaml

from test_torch_serving import NET, files, pinned  # noqa: F401 (fixture)
from test_torch_test_net import H, W, small, tree  # noqa: F401 (fixtures)
from test_torch_train_pipeline import (check_recipe, configs, recipe_draws,
                                       scene, t)
from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)
from unseenobjectclustering_torch.engine import builder as tbuilder
from unseenobjectclustering_torch.models import NETWORK_FACTORIES
from unseenobjectclustering_torch.ops import train_pipeline as ttp
from unseenobjectclustering_torch.ops.preprocess import compute_xyz_np
from unseenobjectclustering_torch.tools import (render_dataset, test_net,
                                                train_net)
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.data import factory as jfactory
from unseenobjectclustering_tpu.engine import builder as jbuilder
from unseenobjectclustering_tpu.engine import evaluate as jevaluate
from unseenobjectclustering_tpu.ops import roi as jroi
from unseenobjectclustering_tpu.ops import train_pipeline as jtp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(REPO, "unseenobjectclustering_torch", "cfgs")
STAGE1_YML = os.path.join(CFGS, "synthetic_240x320_rgbd_add.yml")
RECIPE = os.path.join(REPO, "unseenobjectclustering_torch", "tools",
                      "synthetic_recipe.sh")
# port crop yml -> (the JAX repo's recipe it copies, its network)
CROP_YMLS = {
    "synthetic_crop_240x320_rgbd_add.yml": (
        "synthetic_crop_rgbd_add.yml", "seg_resnet34_8s_embedding"),
    "synthetic_crop128_r18_240x320_rgbd_add.yml": (
        "synthetic_crop128_r18_rgbd_add.yml", "seg_resnet18_8s_embedding"),
}


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def changed_keys(path):
    """The keys a port yml's header says it changed."""
    m = re.search(r"^# Changed keys: (.*)\.$", open(path).read(), re.M)
    return [k.strip() for k in m.group(1).split(",")]


@pytest.mark.parametrize("port", sorted(CROP_YMLS))
def test_crop_yml_is_the_jax_recipe_at_240x320(port):
    path = os.path.join(CFGS, port)
    ref = os.path.join(REPO, "experiments", "cfgs", CROP_YMLS[port][0])
    mine, theirs = (flat(yaml.safe_load(open(p))) for p in (path, ref))
    changed = changed_keys(path)
    assert sorted(mine) == sorted(theirs)
    assert sorted(k for k in mine if mine[k] != theirs[k]) == sorted(changed)
    assert sorted(changed) == ["EXP_DIR", "TRAIN.SYN_HEIGHT",
                               "TRAIN.SYN_WIDTH"]
    cfg = tcfg.Config.from_yaml(path)
    want = jcfg.Config.from_yaml(ref).replace(**{k: mine[k]
                                                 for k in changed})
    assert cfg.to_dict() == want.to_dict()
    stage1 = tcfg.Config.from_yaml(STAGE1_YML)
    for k in ("SYN_HEIGHT", "SYN_WIDTH"):
        assert cfg.TRAIN[k] == stage1.TRAIN[k]
    assert cfg.TRAIN.SYN_CROP and cfg.TRAIN.DEPTH_ARTIFACTS


@pytest.mark.parametrize("seed", [0, 1])
def test_crop_recipe_at_the_recipes_scale_matches_jax(seed):
    """Crops of a 60x80 frame resized up to 56^2 (the ratio of 240x320
    frames to 224^2 crops), with depth artifacts as the crop ymls set."""
    h, w, side = 60, 80, 56
    intr = (75.0, 75.0, w / 2.0, h / 2.0)
    jc, tc = configs(SYN_CROP=True, SYN_CROP_SIZE=side, DEPTH_ARTIFACTS=True)
    bgr, depth, label = scene(30 + seed, b=3, h=h, w=w, k=5)
    key = jax.random.PRNGKey(40 + seed)
    jout = jax.jit(jtp.make_device_augment_crop(
        jc, fx=intr[0], fy=intr[1], px=intr[2], py=intr[3]))(
        jnp.asarray(bgr), jnp.asarray(depth), jnp.asarray(label), key)
    _, apply = ttp.make_device_augment_crop(tc, fx=intr[0], fy=intr[1],
                                            px=intr[2], py=intr[3])
    draws = recipe_draws(key, tc, bgr, depth, label, crop=True)
    tout = apply(t(bgr), t(depth.astype(np.int32)), t(label), draws)
    assert tout[0].shape == (3, side, side, 3)
    check_recipe(jout, tout)


def jax_two_stage(files, side, out):
    cfg = jcfg.Config.from_yaml(files.jax_cfg).replace(
        MODE="TEST", TRAIN={"SYN_CROP_SIZE": side})
    seg = pinned(jbuilder.build_segmentor)(
        cfg, NET, pretrained=files.main, pretrained_crop=files.crop,
        crop_network_name=NET, depth_threshold=0.5, height=H, width=W)
    assert seg.crop_size == side
    ds = jfactory.get_dataset("ocid_object_test", cfg, path="OCID")
    return jevaluate.evaluate_dataset(ds, seg, output_dir=str(out),
                                      save_results=True, verbose=False)


@pytest.mark.parametrize("side", [24, 48])
def test_test_net_crop_flags_match_jax(files, small, tmp_path, monkeypatch,
                                       side):
    """--network_crop and --crop_size (the 128^2 route's flags) reach the
    Segmentor's crop network, RoI crops, veto and paste as the JAX
    builder's crop_network_name and SYN_CROP_SIZE do."""
    built = []
    original = tbuilder.build_segmentor

    def build(*args, **kwargs):
        built.append(pinned(original)(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(test_net.builder, "build_segmentor", build)
    args = ["--dataset", "ocid_object_test", "--dataset_root", "OCID",
            "--cfg", files.port_cfg, "--network", NET,
            "--pretrained", files.main, "--pretrained_crop", files.crop,
            "--network_crop", NET, "--crop_size", str(side),
            "--device", "cpu"]
    stage1, refined = test_net.main(args + ["--output-dir",
                                            str(tmp_path / "port")])
    seg = built[0]
    assert seg.crop_size == side and seg.model_crop is not None
    want1, want_ref = jax_two_stage(files, side, tmp_path / "jax")
    assert stage1 == want1
    assert refined == want_ref
    assert refined["obj_detected"] > 0 and refined != stage1
    for i in range(4):
        got, want = (scipy.io.loadmat(tmp_path / d / f"{i:06d}.mat")
                     for d in ("port", "jax"))
        for k in ("labels", "labels_refined"):
            np.testing.assert_array_equal(got[k], want[k])
    # a crop network the checkpoint does not hold fails to load
    with pytest.raises(KeyError, match="missing"):
        test_net.main(args[:-6] + ["--network_crop",
                                   "seg_resnet34_8s_embedding",
                                   "--max_images", "1", "--device", "cpu",
                                   "--output-dir", str(tmp_path / "bad")])


@pytest.fixture(scope="module")
def crop_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("crop_train")
    cache = root / "cache"
    render_dataset.main(["--cache-dir", str(cache), "--height", "48",
                         "--width", "64", "--num", "4"])
    return root, str(cache)


@pytest.mark.parametrize("port", sorted(CROP_YMLS))
def test_trained_crop_snapshot_serves_stage2(crop_cache, port):
    """train_net on the crop yml (cut to 48x64 frames, 32^2 crops, batch
    2) with --bf16 --device-resident; build_segmentor takes the snapshot
    directory as pretrained_crop with crop_network_name; the crop
    network equals the trainer's, and stage 2 runs on valid crops."""
    root, cache = crop_cache
    net = CROP_YMLS[port][1]
    tree = yaml.safe_load(open(os.path.join(CFGS, port)))
    tree["TRAIN"].update(SYN_HEIGHT=48, SYN_WIDTH=64, SYN_CROP_SIZE=32,
                         IMS_PER_BATCH=2, NUM_UNITS=8, SYNNUM=4,
                         EMBEDDING_SAMPLING_NUM=100)
    yml = root / f"{port}.small.yml"
    yml.write_text(yaml.safe_dump(tree))
    out = root / f"snapshots_{net}"
    state = train_net.main(
        ["--cfg", str(yml), "--network", net, "--solver", "adam",
         "--epochs", "1", "--bf16", "--device-resident", "--render-cache",
         cache, "--workers", "0", "--device", "cpu", "--output-dir",
         str(out)])
    assert state.step == 2 and sorted(os.listdir(out)) == ["1"]
    cfg = tcfg.Config.from_yaml(str(yml)).replace(MODE="TEST")
    seg = tbuilder.build_segmentor(cfg, "seg_resnet18_8s_embedding",
                                   pretrained_crop=str(out),
                                   crop_network_name=net, device="cpu")
    want = state.model.state_dict()
    got = seg.model_crop.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert seg.crop_size == 32

    ds = SyntheticTabletopDataset("train", cfg, height=48, width=64, size=4,
                                  cache_dir=cache)
    bgr, depth_mm, label = ds.get_scene(0)
    image = bgr.astype(np.float32) / 255.0 - cfg.pixel_means / 255.0
    xyz = compute_xyz_np(depth_mm.astype(np.float32) / 1000.0, ds.f, ds.f,
                         ds.cx, ds.cy)
    res = seg.segment(image[None], xyz[None], refine=True)
    assert res.labels_refined.shape == (1, 48, 64)
    labels = label.astype(np.int32)
    assert (np.unique(labels) > 0).sum() >= 2
    refined = seg._refine(torch.from_numpy(image), torch.from_numpy(labels),
                          torch.from_numpy(xyz), labels,
                          torch.Generator().manual_seed(0), has_depth=True)
    assert refined.shape == (48, 64) and refined.dtype == np.int32
    assert set(np.unique(refined)) <= set(range(int(labels.max()) + 1))


def test_recipe_script_names_what_exists():
    out = subprocess.run(["bash", "-n", RECIPE], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    text = open(RECIPE).read()
    ymls = set(re.findall(r"[\w/.]*\.yml", text))
    assert {os.path.basename(y) for y in ymls} >= set(CROP_YMLS)
    for y in ymls:  # named from the root, the package or cfgs/
        assert any(os.path.isfile(os.path.join(d, y)) for d in (
            REPO, os.path.dirname(CFGS), CFGS)), y
    nets = set(re.findall(r"seg_\w+_embedding", text))
    assert nets == {"seg_resnet34_8s_embedding", "seg_resnet18_8s_embedding"}
    assert nets <= set(NETWORK_FACTORIES)
    for flag in ("--network_crop", "--crop_size", "--pretrained_crop",
                 "--fast", "--bf16", "--device-resident"):
        assert flag in text


def plant_port(seg, planted):
    """The port Segmentor's stage 1 runs, then reports `planted` [H, W] as
    its labels (the crop network then sees known instances)."""
    original = seg._stage1_impl

    def stage1(img, xyz, generators, **kw):
        features, _ = original(img, xyz, generators, **kw)
        return features, torch.from_numpy(planted)[None]

    seg._stage1_impl = stage1
    return seg


def record_crop_network(seg, seen):
    """Keep each crop-network call's inputs and embeddings."""
    forward = seg.model_crop.forward

    def recorded(rgb, xyz):
        out = forward(rgb, xyz)
        seen.append((rgb.clone(), xyz.clone(), out.clone()))
        return out

    seg.model_crop.forward = recorded


@pytest.mark.parametrize("side", [224, 128])
def test_refinement_at_the_recipes_crop_sides_matches_jax(
        files, small, tmp_path, monkeypatch, side):
    """test_net --network_crop --crop_size at the two trained recipes' crop
    sides against the JAX evaluate_dataset, on the first OCID frame with
    three of its ground-truth objects planted as the stage-1 labels
    (sparse ids, so the dense relabel runs): the RoI crops and the crop network's
    embeddings of every slot agree with JAX's, and so do the refined
    labels, exactly."""
    jc = jcfg.Config.from_yaml(files.jax_cfg).replace(
        MODE="TEST", TRAIN={"SYN_CROP_SIZE": side})
    jds = jfactory.get_dataset("ocid_object_test", jc, path="OCID")
    sample = jds[0]
    gt = np.asarray(sample["label"])
    keep = (gt > 0) & (gt <= 3)  # three of the frame's objects
    planted = np.pad(np.where(keep, 3 * gt + 1, 0).astype(np.int32),
                     ((0, (-H) % 16), (0, (-W) % 16)))
    assert len(np.unique(gt[keep])) == 3

    seen = []
    original = tbuilder.build_segmentor

    def build(*args, **kwargs):
        seg = plant_port(pinned(original)(*args, **kwargs), planted)
        record_crop_network(seg, seen)
        return seg

    monkeypatch.setattr(test_net.builder, "build_segmentor", build)
    test_net.main(["--dataset", "ocid_object_test", "--dataset_root", "OCID",
                   "--cfg", files.port_cfg, "--network", NET,
                   "--pretrained", files.main, "--pretrained_crop",
                   files.crop, "--network_crop", NET, "--crop_size",
                   str(side), "--max_images", "1", "--device", "cpu",
                   "--output-dir", str(tmp_path / "port")])

    jseg = pinned(jbuilder.build_segmentor)(
        jc, NET, pretrained=files.main, pretrained_crop=files.crop,
        crop_network_name=NET, depth_threshold=0.5, height=H, width=W)
    stage1 = jseg._stage1
    jseg._stage1 = lambda *a: (stage1(*a)[0], jnp.asarray(planted)[None])
    jevaluate.evaluate_dataset(jds, jseg, output_dir=str(tmp_path / "jax"),
                               save_results=True, max_images=1,
                               verbose=False)

    # the crops and embeddings JAX's _stage2_impl computes for this frame
    pad = ((0, (-H) % 16), (0, (-W) % 16), (0, 0))
    img = jnp.asarray(np.pad(sample["image_color"], pad))
    xyz = jnp.asarray(np.pad(sample["depth"], pad))
    dense = jtp._dense_relabel(jnp.asarray(planted),
                              max_id=int(jseg._ms_kw["num_seeds"]))
    crops = jroi.crop_rois(img, dense, xyz, max_instances=jseg.max_instances,
                           crop_size=side)
    feats = jseg.model_crop.apply(jseg.variables_crop, crops.rgb_crops,
                                  crops.depth_crops, train=False)
    [(rgb, dep, got)] = seen
    assert got.shape == (jseg.max_instances, side, side, 8)
    valid = np.asarray(crops.valid)
    assert valid.sum() == 3
    np.testing.assert_allclose(rgb.numpy(), np.asarray(crops.rgb_crops),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(dep.numpy(), np.asarray(crops.depth_crops),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(feats)[valid],
                               rtol=0, atol=1e-4)
    port, want = (scipy.io.loadmat(tmp_path / d / "000000.mat")
                  for d in ("port", "jax"))
    np.testing.assert_array_equal(port["labels"], want["labels"])
    np.testing.assert_array_equal(port["labels_refined"],
                                  want["labels_refined"])
    assert not np.array_equal(want["labels_refined"], want["labels"])
