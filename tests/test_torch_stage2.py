"""Stage 2 (zoom-in refinement) of the port against the JAX package.

Both Segmentors get the same weights (flax init with random BN statistics,
carried with state_dict_from_flax; ResNet-18, 8-D embeddings, 32x32 crops,
MAX_INSTANCES 4, 16 seeds) and the same pinned first seed (``first_index``
through ``_ms_kw`` on both).  The JAX side clusters through its plain XLA
reference (USE_PALLAS off), the port through its kernel wrappers, which run
their plain versions on CPU tensors.

Tolerances: dense ids, rois, validity, vetoed crop labels and pasted labels
equal; order keys within 1e-6 relative (the mean depth sums in another
order); crop embeddings within 1e-4 (convolutions sum in another order).

Random-init networks mostly embed a frame as one cluster.  The clustering
settings (KAPPA, EPSILON) and weight seeds below are ones under which
stage 1 finds instances on the test scene, so that stage 2 has crops.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import randomize_bn
from test_torch_pipeline import scene
from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.engine.pipeline import Segmentor as JSegmentor
from unseenobjectclustering_tpu.models import get_network as jax_get_network
from unseenobjectclustering_tpu.ops import preprocess as jpre
from unseenobjectclustering_tpu.ops import roi as jroi
from unseenobjectclustering_tpu.ops.train_pipeline import (
    _dense_relabel as jax_dense_relabel)

torch.set_num_threads(1)

NET = "seg_resnet18_8s_embedding"
H, W = 30, 44  # padded to 32x48 by both Segmentors
FIRST = 5


def no_launches():
    return (cuda_seeding.launches, cms.hill_climb_launches,
            cms.connected_components_launches,
            cms.assign_labels_launches) == (0, 0, 0, 0)


def segmentors(input_type="RGBD", kappa=30.0, epsilon=0.02, key=0,
               fallback=False):
    """(JAX Segmentor, port Segmentor) on the same carried weights, first
    seed pinned on both."""
    overrides = dict(
        INPUT=input_type, TRAIN={"NUM_UNITS": 8, "SYN_CROP_SIZE": 32},
        CLUSTER={"NUM_SEEDS": 16, "MAX_INSTANCES": 4, "KAPPA": kappa,
                 "EPSILON": epsilon, "REFINE_FALLBACK": fallback})
    jc = jcfg.Config.inference_default(**overrides).replace(
        **{"CLUSTER.USE_PALLAS": False})
    model = jax_get_network(NET, jc)
    zeros = jnp.zeros((1, 32, 48, 3), jnp.float32)
    depth = zeros if input_type != "COLOR" else None

    def init(k):
        return randomize_bn(model.init(jax.random.PRNGKey(k), zeros, depth,
                                       train=False), seed=k)

    variables, variables_crop = init(key), init(key + 10)
    jseg = JSegmentor(jc, variables, variables_crop, network_name=NET)
    tseg = Segmentor(tcfg.Config.inference_default(**overrides),
                     state_dict_from_flax(variables, "resnet18_8s"),
                     state_dict_from_flax(variables_crop, "resnet18_8s"),
                     network_name=NET, device="cpu")
    assert tseg._ms_kw == dict(jseg._ms_kw, use_pallas=True)
    assert tseg._buckets == jseg._buckets == [4]
    for seg in (jseg, tseg):
        seg._ms_kw = dict(seg._ms_kw, first_index=FIRST)
    return jseg, tseg, variables_crop


def frame(seed=0, means=None):
    """The test scene preprocessed by the JAX package: [1, H, W, 3] image
    and XYZ (numpy)."""
    bgr, depth = scene(seed, h=H, w=W)
    img, xyz = jpre.preprocess_rgbd(jnp.asarray(bgr), jnp.asarray(depth),
                                    jnp.asarray(means), 40.0, 40.0, W / 2.0,
                                    H / 2.0, height=H, width=W)
    return np.array(img)[None], np.array(xyz)[None]


def test_stage2_impl_matches_jax(monkeypatch):
    """_stage2_impl on a label map of the scene's three boxes, with sparse
    ids: crops, crop embeddings, per-crop clustering, veto and paste order
    as JAX's; TF32 off inside the crop network's call only."""
    jseg, tseg, variables_crop = segmentors()
    img, xyz = frame(means=tseg.cfg.pixel_means)
    img, xyz = np.pad(img[0], ((0, 2), (0, 4), (0, 0))), np.pad(
        xyz[0], ((0, 2), (0, 4), (0, 0)))
    labels = np.zeros((32, 48), np.int32)
    for k, (y, x) in zip((3, 7, 12), [(4, 5), (14, 24), (20, 8)]):
        labels[y:y + 9, x:x + 12] = k

    want = jseg._stage2(variables_crop, jnp.asarray(img), jnp.asarray(labels),
                        jnp.asarray(xyz), jax.random.PRNGKey(0),
                        has_depth=True, max_instances=4)
    dense = jax_dense_relabel(jnp.asarray(labels), max_id=16)
    crops = jroi.crop_rois(jnp.asarray(img), dense, jnp.asarray(xyz),
                           max_instances=4, crop_size=32)
    want_feats = np.asarray(jseg.model_crop.apply(
        variables_crop, crops.rgb_crops, crops.depth_crops, train=False))

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    seen = []
    forward = tseg.model_crop.forward

    def spy(*args):
        out = forward(*args)
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32, out))
        return out

    monkeypatch.setattr(tseg.model_crop, "forward", spy)
    timing = {}
    got = tseg._stage2_impl(torch.from_numpy(img), torch.from_numpy(labels),
                            torch.from_numpy(xyz), tseg.next_key(),
                            has_depth=True, max_instances=4, timing=timing)
    (tf32_cudnn, tf32_matmul, feats), = seen
    assert (tf32_cudnn, tf32_matmul) == (False, False)
    assert torch.backends.cudnn.allow_tf32 is True
    np.testing.assert_allclose(feats.numpy(), want_feats, atol=1e-4)

    labels_veto, order_key, rois, valid = (t.numpy() for t in got)
    assert valid.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(rois, np.asarray(want[2]))
    np.testing.assert_array_equal(valid, np.asarray(want[3]))
    assert labels_veto.dtype == np.asarray(want[0]).dtype == np.int8
    np.testing.assert_array_equal(labels_veto, np.asarray(want[0]))
    np.testing.assert_allclose(order_key, np.asarray(want[1]), rtol=1e-6)
    assert (labels_veto[:3] >= 0).any()
    assert {"stage2_crops", "stage2_network", "stage2_cluster",
            "stage2_veto"} <= set(timing)
    assert no_launches()


@pytest.mark.parametrize("mode", ["rgbd", "fallback", "color"])
def test_refined_labels_match_jax(mode):
    """segment(refine=True) end to end on a 30x44 frame (padded to 32x48,
    refined, then cropped back): stage-1 and refined labels equal JAX's.
    With REFINE_FALLBACK a stage-1 instance whose crop clusters are all
    vetoed is kept; COLOR-only input orders the crops by RoI area."""
    jseg, tseg, _ = {
        "rgbd": lambda: segmentors(),
        "fallback": lambda: segmentors(kappa=40.0, epsilon=0.01,
                                       fallback=True),
        "color": lambda: segmentors("COLOR", key=1),
    }[mode]()
    img, xyz = frame(means=tseg.cfg.pixel_means)
    if mode == "color":
        xyz = None
    want = jseg.segment(img, xyz, refine=True)
    got = tseg.segment(img, xyz, refine=True)
    assert got.labels_refined.shape == (1, H, W)
    assert got.labels_refined.dtype == np.int32
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.labels_refined, want.labels_refined)
    # stage 1 found instances, and stage 2 kept some of them
    assert len(np.unique(got.labels)) >= 3
    assert len(np.unique(got.labels_refined)) >= 2
    assert {"stage1", "stage2", "stage2_network", "stage2_cluster",
            "stage2_paste", "total"} <= set(got.timing)
    if mode == "fallback":
        # without the fallback this frame loses an instance to the veto
        tseg.refine_fallback = False
        plain = tseg.segment(img, xyz, refine=True).labels_refined
        assert len(np.unique(plain)) < len(np.unique(got.labels_refined))
    assert no_launches()

