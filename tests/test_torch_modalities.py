"""The paper's COLOR, DEPTH and RGB-D early-fusion recipes in the port
against the JAX package, on the CPU.

Each check is one test parametrised over the three modalities:

- The port's recipe ymls (unseenobjectclustering_torch/cfgs/
  synthetic_240x320_{color,depth,rgbd_early}.yml) are the JAX repo's
  experiments/cfgs/synthetic_fullres_*_16ep.yml but for the keys each
  header lists, scaled as synthetic_240x320_rgbd_add.yml scales its
  recipe, and their Config equals the JAX Config with those keys set.
- segment(refine=False) with the modality's tabletop yml
  (experiments/cfgs/seg_resnet34_8s_embedding_cosine_*_tabletop.yml,
  ResNet-34-8s) on a 30x44 frame: COLOR passes no XYZ, so stage 1
  clusters without the depth filter; DEPTH passes no image; early fusion
  runs one 6-channel tower.  The JAX side clusters with its Pallas kernels
  in interpret mode, the port through its kernel wrappers' plain versions.
- tools.test_net --pretrained_crop --network_crop with the modality's
  tabletop yml (ResNet-18 networks, 8-D embeddings and the clustering
  settings of tests/test_torch_serving.py) on the OCID fixture tree of
  tests/test_torch_test_net.py against the JAX evaluate_dataset: COLOR's
  samples carry no XYZ, so its stage 2 crops zeros for depth and orders
  the paste by RoI area.
- tools/modality_recipe.sh, which trains these recipes and rgbd_cat's on
  the card, parses and names recipe ymls that exist.

Weights: flax inits with random BatchNorm statistics, carried with
state_dict_from_flax or exported with export_torch_state_dict; the first
seed pinned on both Segmentors.  Tolerances: embeddings within 1e-4
(convolutions sum in another order); labels, metric dicts and .mat labels
equal.
"""

import os
import re
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
import yaml

from test_torch_models import randomize_bn
from test_torch_pipeline import scene
from test_torch_serving import FIRST, no_launches, pinned
from test_torch_two_stage import changed_keys, flat
from test_torch_test_net import H as TH, W as TW, small, tree  # noqa: F401
from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.engine import builder as tbuilder
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.tools import test_net
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.data import factory as jfactory
from unseenobjectclustering_tpu.engine import builder as jbuilder
from unseenobjectclustering_tpu.engine import evaluate as jevaluate
from unseenobjectclustering_tpu.engine.pipeline import Segmentor as JSegmentor
from unseenobjectclustering_tpu.models import get_network as jax_get_network
from unseenobjectclustering_tpu.ops import preprocess as jpre
from unseenobjectclustering_tpu.utils.checkpoint import (
    export_torch_state_dict)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = os.path.join(REPO, "unseenobjectclustering_torch", "cfgs")
MODALITIES = ("color", "depth", "rgbd_early")
H, W = 30, 44  # padded to 32x48 by both Segmentors
# what the 30x44 frame forces: 32x32 crops, one bucket of 4 instances;
# the clustering settings of tests/test_torch_serving.py, under which a
# random-init stage 1 finds instances (the labels are not all background)
SMALL = {"TRAIN.SYN_CROP_SIZE": 32, "CLUSTER.MAX_INSTANCES": 4,
         "CLUSTER.KAPPA": 30.0, "CLUSTER.EPSILON": 0.02}
# test_net's networks and clustering: those of tests/test_torch_serving.py
NET = "seg_resnet18_8s_embedding"
# flax init seeds of the stage-1 and crop networks, per modality: ones
# under which stage 1 finds instances and refinement keeps some
SEEDS = {"color": (0, 10), "depth": (0, 10), "rgbd_early": (2, 10)}
CLI = {"TRAIN": {"NUM_UNITS": 8, "SYN_CROP_SIZE": 32},
       "CLUSTER": {"NUM_SEEDS": 16, "MAX_INSTANCES": 4, "KAPPA": 30.0,
                   "EPSILON": 0.02}}


def tabletop_yml(modality, crop=False):
    return os.path.join(REPO, "experiments", "cfgs",
                        f"seg_resnet34_8s_embedding_cosine_{modality}"
                        f"{'_crop' if crop else ''}_tabletop.yml")


@pytest.mark.parametrize("modality", MODALITIES)
def test_recipe_yml_is_the_jax_recipe_at_240x320(modality):
    """cfgs/synthetic_240x320_<modality>.yml: the JAX repo's
    synthetic_fullres_<modality>_16ep.yml with the keys its header names
    changed, each (but EXP_DIR) to the rgbd_add recipe's value."""
    path = os.path.join(CFGS, f"synthetic_240x320_{modality}.yml")
    ref = os.path.join(REPO, "experiments", "cfgs",
                       f"synthetic_fullres_{modality}_16ep.yml")
    mine, theirs = (flat(yaml.safe_load(open(p))) for p in (path, ref))
    changed = changed_keys(path)
    assert sorted(changed) == ["EXP_DIR", "TRAIN.IMS_PER_BATCH",
                               "TRAIN.MILESTONES", "TRAIN.SYN_HEIGHT",
                               "TRAIN.SYN_WIDTH"]
    assert sorted(mine) == sorted(theirs)
    assert sorted(k for k in mine if mine[k] != theirs[k]) == sorted(changed)
    add = flat(yaml.safe_load(open(os.path.join(
        CFGS, "synthetic_240x320_rgbd_add.yml"))))
    for k in changed:
        if k != "EXP_DIR":
            assert mine[k] == add[k], k
    assert mine["EXP_DIR"] == f"synthetic_tabletop_240x320_{modality}"
    cfg = tcfg.Config.from_yaml(path)
    want = jcfg.Config.from_yaml(ref).replace(**{k: mine[k] for k in changed})
    assert cfg.to_dict() == want.to_dict()
    # the modality of the tabletop recipe it trains for
    table = tcfg.Config.from_yaml(tabletop_yml(modality))
    assert cfg.INPUT == table.INPUT
    if cfg.INPUT == "RGBD":
        assert cfg.TRAIN.FUSION_TYPE == table.TRAIN.FUSION_TYPE == "early"


def inputs(cfg, img, xyz):
    """The frame as the modality takes it: COLOR no XYZ, DEPTH no image."""
    return (None if cfg.INPUT == "DEPTH" else img,
            None if cfg.INPUT == "COLOR" else xyz)


@pytest.mark.parametrize("modality", MODALITIES)
def test_stage1_matches_jax(modality):
    """segment(refine=False) with the modality's tabletop yml on carried
    weights: embeddings within 1e-4 of JAX's, labels equal (COLOR without
    the depth filter)."""
    jc = jcfg.Config.from_yaml(tabletop_yml(modality)).replace(
        MODE="TEST", **SMALL)
    tc = tcfg.Config.from_yaml(tabletop_yml(modality)).replace(
        MODE="TEST", **SMALL)
    assert jc.CLUSTER.USE_PALLAS and tc.CLUSTER.USE_PALLAS
    net = "seg_resnet34_8s_embedding"
    model = jax_get_network(net, jc)
    zeros = jnp.zeros((1, 32, 48, 3), jnp.float32)
    seed = SEEDS[modality][0]
    variables = randomize_bn(model.init(jax.random.PRNGKey(seed), zeros,
                                        zeros, train=False), seed=seed)
    jseg = JSegmentor(jc, variables, network_name=net)
    tseg = Segmentor(tc, state_dict_from_flax(variables, "resnet34_8s"),
                     network_name=net, device="cpu")
    assert tseg._ms_kw == dict(jseg._ms_kw, use_pallas=True)
    conv1 = tseg.model.fcn.resnet34_8s.conv1.weight
    assert conv1.shape[1] == (6 if modality == "rgbd_early" else 3)
    assert hasattr(tseg.model, "fcn_depth") is False
    for seg in (jseg, tseg):
        seg._ms_kw = dict(seg._ms_kw, first_index=FIRST)

    bgr, depth = scene(0, h=H, w=W)
    img, xyz = jpre.preprocess_rgbd(
        jnp.asarray(bgr), jnp.asarray(depth), jnp.asarray(tc.pixel_means),
        40.0, 40.0, W / 2.0, H / 2.0, height=H, width=W)
    img, xyz = inputs(tc, np.array(img)[None], np.array(xyz)[None])
    want = jseg.segment(img, xyz, refine=False, return_features=True)
    got = tseg.segment(img, xyz, refine=False, return_features=True)
    assert got.features.shape == (1, H, W, 64)
    np.testing.assert_allclose(got.features, np.asarray(want.features),
                               atol=1e-4)
    assert got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(np.unique(got.labels)) > 1
    assert no_launches()


@pytest.fixture(scope="module")
def modality_files(tmp_path_factory):
    """Per modality: its tabletop yml cut to the CLI test's settings (the
    JAX one with USE_PALLAS off) and the .pth exports of a stage-1 and a
    crop network (flax inits, random BatchNorm statistics)."""
    d = tmp_path_factory.mktemp("modality_weights")
    out = {}
    for modality in MODALITIES:
        tree = yaml.safe_load(open(tabletop_yml(modality)))
        for section, keys in CLI.items():
            tree[section].update(keys)
        ns = types.SimpleNamespace()
        for name, extra in (("port_cfg", {}),
                            ("jax_cfg", {"USE_PALLAS": False})):
            t = dict(tree, CLUSTER=dict(tree["CLUSTER"], **extra))
            path = str(d / f"{modality}_{name}.yml")
            with open(path, "w") as f:
                yaml.safe_dump(t, f)
            setattr(ns, name, path)
        jc = jcfg.Config.from_yaml(ns.jax_cfg)
        model = jax_get_network(NET, jc)
        zeros = jnp.zeros((1, 32, 48, 3), jnp.float32)
        for name, key in zip(("main", "crop"), SEEDS[modality]):
            variables = randomize_bn(model.init(jax.random.PRNGKey(key),
                                                zeros, zeros, train=False),
                                     seed=key)
            state = {k: torch.from_numpy(np.array(v, order="C"))
                     for k, v in export_torch_state_dict(
                         variables, "resnet18_8s").items()}
            path = str(d / f"{modality}_{name}.pth")
            torch.save(state, path)
            setattr(ns, name, path)
        out[modality] = ns
    return out


@pytest.mark.parametrize("modality", MODALITIES)
def test_test_net_two_stage_matches_jax(modality_files, small, tmp_path,
                                        monkeypatch, modality):
    """test_net --pretrained_crop --network_crop with the modality's yml on
    the OCID fixture tree: the stage-1 and refined metric dicts and every
    frame's .mat labels equal the JAX evaluate_dataset's."""
    files = modality_files[modality]
    built = []
    original = tbuilder.build_segmentor

    def build(*args, **kwargs):
        built.append(pinned(original)(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(test_net.builder, "build_segmentor", build)
    stage1, refined = test_net.main(
        ["--dataset", "ocid_object_test", "--dataset_root", "OCID",
         "--cfg", files.port_cfg, "--network", NET,
         "--pretrained", files.main, "--pretrained_crop", files.crop,
         "--network_crop", NET, "--device", "cpu",
         "--output-dir", str(tmp_path / "port")])
    seg = built[0]
    assert seg.cfg.INPUT == ("COLOR" if modality == "color" else
                             "DEPTH" if modality == "depth" else "RGBD")
    assert seg.model_crop is not None and seg.crop_size == 32

    jc = jcfg.Config.from_yaml(files.jax_cfg).replace(MODE="TEST")
    jseg = pinned(jbuilder.build_segmentor)(
        jc, NET, pretrained=files.main, pretrained_crop=files.crop,
        crop_network_name=NET, depth_threshold=0.5, height=TH, width=TW)
    ds = jfactory.get_dataset("ocid_object_test", jc, path="OCID")
    assert ("depth" in ds[0]) == (modality != "color")
    want1, want_ref = jevaluate.evaluate_dataset(
        ds, jseg, output_dir=str(tmp_path / "jax"), save_results=True,
        verbose=False)
    assert stage1 == want1
    assert refined == want_ref
    assert stage1["obj_detected"] > 0 and refined["obj_detected"] > 0
    for i in range(4):
        got, want = (scipy.io.loadmat(tmp_path / d / f"{i:06d}.mat")
                     for d in ("port", "jax"))
        for k in ("labels", "labels_refined"):
            np.testing.assert_array_equal(got[k], want[k])
    assert no_launches()


def test_modality_recipe_script_names_what_exists():
    """tools/modality_recipe.sh parses, trains every recipe yml of the
    other inputs (and rgbd_cat's), each of which exists, with the rgbd_add
    recipe's flags."""
    script = os.path.join(REPO, "unseenobjectclustering_torch", "tools",
                          "modality_recipe.sh")
    out = subprocess.run(["bash", "-n", script], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    text = open(script).read()
    inputs = re.search(r"for input in ([\w ]+); do", text).group(1).split()
    assert inputs == list(MODALITIES) + ["rgbd_cat"]
    for name in inputs + ["rgbd_add"]:
        assert os.path.isfile(os.path.join(
            CFGS, f"synthetic_240x320_{name}.yml")), name
    for flag in ("--bf16", "--device-resident", "synthetic_tabletop_test",
                 "--max_images"):
        assert flag in text
