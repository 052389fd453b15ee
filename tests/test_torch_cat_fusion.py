"""The RGB-D cat fusion (128-D embeddings) of the port against the JAX
package, on the CPU.

Both Segmentors load the JAX repo's rgbd_cat recipe
(experiments/cfgs/seg_resnet34_8s_embedding_cosine_rgbd_cat_tabletop.yml:
ResNet-34-8s towers whose 64-D outputs are concatenated into 128-D
embeddings) with the crop side cut to 32 and the crop buckets to 4 for the
30x44 frame, get the same weights (flax init with random BN statistics,
carried with state_dict_from_flax) and the same pinned first seed
(``first_index`` through ``_ms_kw``).  The JAX side clusters the 128-D
pixels with its Pallas kernels in interpret mode (USE_PALLAS, the recipe's
default), the port through its kernel wrappers, which run their plain
versions on CPU tensors.  On the card the same wrappers launch the kernels'
width-128 instantiations; chip_smoke.py phase 2c and the cuda-marked tests
in test_torch_cuda_kernels.py hold those to the plain versions.

Tolerances: embeddings within 1e-4 (convolutions sum in another order),
RoI crops within 1e-5, labels and refined labels equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_models import randomize_bn
from test_torch_pipeline import scene
from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.engine.pipeline import (
    _cluster_crops as t_cluster_crops)
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_torch.ops import roi as troi
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.engine.pipeline import Segmentor as JSegmentor
from unseenobjectclustering_tpu.engine.pipeline import (
    _cluster_crops as j_cluster_crops)
from unseenobjectclustering_tpu.models import get_network as jax_get_network
from unseenobjectclustering_tpu.ops import preprocess as jpre
from unseenobjectclustering_tpu.ops import roi as jroi
from unseenobjectclustering_tpu.ops.train_pipeline import (
    _dense_relabel as jax_dense_relabel)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAT_YML = os.path.join(
    REPO, "experiments", "cfgs",
    "seg_resnet34_8s_embedding_cosine_rgbd_cat_tabletop.yml")
NET = "seg_resnet34_8s_embedding"
H, W = 30, 44  # padded to 32x48 by both Segmentors
FIRST = 5
# what the 30x44 frame forces: 32x32 crops, one bucket of 4 instances
SMALL = {"TRAIN.SYN_CROP_SIZE": 32, "CLUSTER.MAX_INSTANCES": 4}
# the three boxes of the scene, planted as stage-1 labels with sparse ids
BOXES = {3: (4, 5), 7: (14, 24), 12: (20, 8)}


def no_launches():
    return (cuda_seeding.launches, cms.hill_climb_launches,
            cms.connected_components_launches,
            cms.assign_labels_launches) == (0, 0, 0, 0)


@pytest.fixture(scope="module")
def segmentors():
    """(JAX Segmentor, port Segmentor, JAX crop variables) of the cat
    recipe on the same carried weights, first seed pinned on both."""
    jc = jcfg.Config.from_yaml(CAT_YML).replace(MODE="TEST", **SMALL)
    tc = tcfg.Config.from_yaml(CAT_YML).replace(MODE="TEST", **SMALL)
    assert jc.TRAIN.FUSION_TYPE == tc.TRAIN.FUSION_TYPE == "cat"
    assert jc.CLUSTER.USE_PALLAS and tc.CLUSTER.USE_PALLAS
    model = jax_get_network(NET, jc)
    zeros = jnp.zeros((1, 32, 48, 3), jnp.float32)

    def init(k):
        return randomize_bn(model.init(jax.random.PRNGKey(k), zeros, zeros,
                                       train=False), seed=k)

    variables, variables_crop = init(0), init(10)
    jseg = JSegmentor(jc, variables, variables_crop, network_name=NET)
    tseg = Segmentor(tc, state_dict_from_flax(variables, "resnet34_8s"),
                     state_dict_from_flax(variables_crop, "resnet34_8s"),
                     network_name=NET, device="cpu")
    assert tseg.model.embedding_dim == tseg.model_crop.embedding_dim == 128
    assert tseg._ms_kw == dict(jseg._ms_kw, use_pallas=True)
    for seg in (jseg, tseg):
        seg._ms_kw = dict(seg._ms_kw, first_index=FIRST)
    return jseg, tseg, variables_crop


def frame(means):
    """The test scene preprocessed by the JAX package: [1, H, W, 3] image
    and XYZ (numpy)."""
    bgr, depth = scene(0, h=H, w=W)
    img, xyz = jpre.preprocess_rgbd(jnp.asarray(bgr), jnp.asarray(depth),
                                    jnp.asarray(means), 40.0, 40.0, W / 2.0,
                                    H / 2.0, height=H, width=W)
    return np.array(img)[None], np.array(xyz)[None]


def planted(img, xyz):
    """The frame padded to 32x48 and the scene's boxes as stage-1 labels."""
    img, xyz = (np.pad(a[0], ((0, 2), (0, 4), (0, 0))) for a in (img, xyz))
    labels = np.zeros((32, 48), np.int32)
    for k, (y, x) in BOXES.items():
        labels[y:y + 9, x:x + 12] = k
    return img, xyz, labels


def test_cat_stage1_matches_jax(segmentors):
    """segment(refine=False) with the cat network: 128-D embeddings within
    1e-4 of JAX's, stage-1 labels (the clustering of the 128-D pixels with
    the fused depth filter) equal."""
    jseg, tseg, _ = segmentors
    img, xyz = frame(tseg.cfg.pixel_means)
    want = jseg.segment(img, xyz, refine=False, return_features=True)
    got = tseg.segment(img, xyz, refine=False, return_features=True)
    assert got.features.shape == (1, H, W, 128)
    np.testing.assert_allclose(got.features, np.asarray(want.features),
                               atol=1e-4)
    assert got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.labels, want.labels)
    assert no_launches()


def test_cat_stage2_on_planted_instances_matches_jax(segmentors):
    """Stage 2 with the cat crop network on the scene's three boxes
    planted as stage-1 labels: the RoI crops within 1e-5 of JAX's, the
    128-D crop embeddings within 1e-4, each crop's clustering equal, the
    refined labels (veto, paste) equal."""
    jseg, tseg, variables_crop = segmentors
    img, xyz, labels = planted(*frame(tseg.cfg.pixel_means))
    dense = jax_dense_relabel(jnp.asarray(labels), max_id=100)
    want_crops = jroi.crop_rois(jnp.asarray(img), dense, jnp.asarray(xyz),
                                max_instances=4, crop_size=32)
    got_crops = troi.crop_rois(
        torch.from_numpy(img), troi._dense_relabel(torch.from_numpy(labels),
                                                   max_id=100),
        torch.from_numpy(xyz), max_instances=4, crop_size=32)
    for name in ("rgb_crops", "depth_crops"):
        np.testing.assert_allclose(getattr(got_crops, name).numpy(),
                                   np.asarray(getattr(want_crops, name)),
                                   atol=1e-5)
    want_feats = np.asarray(jseg.model_crop.apply(
        variables_crop, want_crops.rgb_crops, want_crops.depth_crops,
        train=False))
    with torch.inference_mode():
        got_feats = tseg.model_crop(got_crops.rgb_crops,
                                    got_crops.depth_crops)
    assert got_feats.shape == (4, 32, 32, 128)
    np.testing.assert_allclose(got_feats.numpy(), want_feats, atol=1e-4)

    # each valid crop's clustering of its 128-D pixels, first seed pinned
    valid = np.asarray(want_crops.valid)
    assert valid.tolist() == [True, True, True, False]
    want_labels = np.asarray(j_cluster_crops(
        jnp.asarray(want_feats), want_crops.valid,
        jax.random.split(jax.random.PRNGKey(0), 4), **jseg._ms_kw))
    got_labels = t_cluster_crops(got_feats, valid.tolist(),
                                 torch.Generator().manual_seed(0),
                                 **tseg._ms_kw)
    np.testing.assert_array_equal(got_labels.numpy(), want_labels)

    # veto and paste; a vetoed instance keeps its stage-1 mask (the
    # fallback), so the refined map is not empty
    labels_veto, order_key, rois, valid = jseg._stage2(
        variables_crop, jnp.asarray(img), jnp.asarray(labels),
        jnp.asarray(xyz), jax.random.PRNGKey(0), has_depth=True,
        max_instances=4)
    uniq = np.unique(labels)
    want = jroi.paste_back(labels, np.asarray(labels_veto),
                           np.asarray(order_key), np.asarray(rois),
                           np.asarray(valid),
                           fallback_labels=np.searchsorted(
                               uniq, labels).astype(np.int32))
    tseg.refine_fallback = True
    try:
        got = tseg._refine(torch.from_numpy(img), torch.from_numpy(labels),
                           torch.from_numpy(xyz), labels,
                           torch.Generator().manual_seed(0), has_depth=True)
    finally:
        tseg.refine_fallback = False
    assert got.dtype == np.int32 and got.shape == (32, 48)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 4  # the background and three instances
    assert no_launches()


def test_cat_recipe_yml_is_the_jax_recipe_at_240x320():
    """cfgs/synthetic_240x320_rgbd_cat.yml: the JAX repo's
    synthetic_fullres_rgbd_cat_16ep.yml with the keys its header names
    changed, scaled as synthetic_240x320_rgbd_add.yml scales its recipe;
    its config equal to the JAX Config of the recipe with those keys."""
    cfgs = os.path.join(REPO, "unseenobjectclustering_torch", "cfgs")
    path = os.path.join(cfgs, "synthetic_240x320_rgbd_cat.yml")
    ref = os.path.join(REPO, "experiments", "cfgs",
                       "synthetic_fullres_rgbd_cat_16ep.yml")

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[prefix + k] = v
        return out

    mine, theirs = (flat(yaml.safe_load(open(p))) for p in (path, ref))
    header = next(line for line in open(path)
                  if line.startswith("# Changed keys: "))
    changed = [k.strip() for k in
               header[len("# Changed keys: "):].strip().rstrip(".").split(",")]
    assert sorted(mine) == sorted(theirs)
    assert sorted(k for k in mine if mine[k] != theirs[k]) == sorted(changed)
    add = flat(yaml.safe_load(open(os.path.join(
        cfgs, "synthetic_240x320_rgbd_add.yml"))))
    for k in changed:
        if k != "EXP_DIR":
            assert mine[k] == add[k], k
    cfg = tcfg.Config.from_yaml(path)
    want = jcfg.Config.from_yaml(ref).replace(**{k: mine[k] for k in changed})
    assert cfg.to_dict() == want.to_dict()
    assert cfg.TRAIN.FUSION_TYPE == "cat" and cfg.TRAIN.NUM_UNITS == 64
