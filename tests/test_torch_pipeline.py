"""Stage 1 of the port against the JAX package as a whole, plus the port's
entry-point rules: no JAX imports, the card by default.

The slice: JAX preprocess_rgbd -> SEGNET.apply -> mean_shift_smart_init
(use_pallas=True, interpret mode on the CPU) against the port's Segmentor
on the same frame, the same weights (through the carry) and a pinned first
seed.  Embeddings within atol 1e-4 (conv summation order); the port's
clustering of the JAX embeddings gives the JAX labels exactly.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_torch.ops import mean_shift as tms
from unseenobjectclustering_torch.ops import preprocess as tpre
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.models import get_network as jax_get_network
from unseenobjectclustering_tpu.ops import mean_shift as jms
from unseenobjectclustering_tpu.ops import preprocess as jpre

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 48
NET = "seg_resnet18_8s_embedding"
OVERRIDES = dict(INPUT="RGBD", TRAIN={"NUM_UNITS": 8},
                 CLUSTER={"NUM_SEEDS": 20})
INTR = (40.0, 40.0, W / 2.0, H / 2.0)


def scene(seed=0, h=H, w=W):
    """A table with three boxes: BGR uint8 and depth in meters (0 where the
    sensor saw nothing)."""
    rng = np.random.RandomState(seed)
    bgr = np.full((h, w, 3), 90, np.uint8)
    depth = np.full((h, w), 1.2, np.float32)
    for k, (y, x, c) in enumerate([(4, 5, 200), (14, 24, 40), (20, 8, 150)]):
        bgr[y:y + 9, x:x + 12] = (c, 255 - c, (60 * k) % 255)
        depth[y:y + 9, x:x + 12] = 0.7 + 0.1 * k
    bgr = np.clip(bgr + rng.randint(-8, 9, size=bgr.shape), 0, 255)
    depth[rng.rand(h, w) < 0.03] = 0.0
    return bgr.astype(np.uint8), depth


@pytest.fixture(scope="module")
def jax_weights():
    cfg = jcfg.Config.inference_default(**OVERRIDES)
    model = jax_get_network(NET, cfg)
    zeros = jnp.zeros((1, H, W, 3), jnp.float32)
    variables = model.init(jax.random.PRNGKey(0), zeros, zeros, train=False)
    return cfg, model, variables


def test_stage1_slice_matches_jax(jax_weights):
    jcfg_, jmodel, variables = jax_weights
    bgr, depth = scene()
    means = jcfg_.pixel_means
    img, xyz = jpre.preprocess_rgbd(jnp.asarray(bgr), jnp.asarray(depth),
                                    jnp.asarray(means), *INTR, height=H,
                                    width=W)
    feats = jmodel.apply(variables, img[None], xyz[None], train=False)
    ms_kw = dict(kappa=20.0, num_seeds=20, max_iters=10, epsilon=0.04,
                 metric="cosine", use_pallas=True, seed_subsample=1,
                 compute_dtype="float32", first_index=5)
    want = jms.mean_shift_smart_init(
        feats.reshape(H * W, -1), jax.random.PRNGKey(0),
        z_valid=(xyz[..., 2] > 0).reshape(H * W), filter_threshold=0.8,
        **ms_kw)

    cfg = tcfg.Config.inference_default(**OVERRIDES)
    seg = Segmentor(cfg, state_dict_from_flax(variables, "resnet18_8s"),
                    network_name=NET, device="cpu")
    assert seg._ms_kw == {k: v for k, v in ms_kw.items()
                          if k != "first_index"}
    t_img, t_xyz = tpre.preprocess_rgbd(torch.from_numpy(bgr),
                                        torch.from_numpy(depth), means,
                                        *INTR)
    features, labels = seg._stage1_impl(
        t_img[None], t_xyz[None], [seg.next_key()], threshold=0.8,
        ms_kw=dict(seg._ms_kw, first_index=5))
    np.testing.assert_allclose(features.numpy(), np.asarray(feats),
                               atol=1e-4)
    assert labels.shape == (1, H, W) and labels.dtype == torch.int32

    # the port's clustering of the JAX embeddings gives the JAX labels
    got = tms.mean_shift_smart_init(
        torch.from_numpy(np.array(feats)).reshape(H * W, -1),
        z_valid=torch.from_numpy(np.array(xyz[..., 2] > 0)).reshape(H * W),
        filter_threshold=0.8, **ms_kw)
    for name in ("seed_indices", "seed_labels", "labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert len(np.unique(np.asarray(want.labels))) > 1
    np.testing.assert_allclose(got.seeds.numpy(), np.asarray(want.seeds),
                               atol=1e-5)
    assert (cuda_seeding.launches, cms.hill_climb_launches,
            cms.connected_components_launches,
            cms.assign_labels_launches) == (0, 0, 0, 0)


def test_segment_crops_back_frames_that_are_not_multiples_of_16(jax_weights):
    _, _, variables = jax_weights
    cfg = tcfg.Config.inference_default(**OVERRIDES)
    seg = Segmentor(cfg, state_dict_from_flax(variables, "resnet18_8s"),
                    network_name=NET, device="cpu")
    bgr, depth = scene(1, h=30, w=44)
    img, xyz = tpre.preprocess_rgbd(torch.from_numpy(bgr),
                                    torch.from_numpy(depth), cfg.pixel_means,
                                    *INTR)
    res = seg.segment_sample({"image_color": img.numpy(),
                              "depth": xyz.numpy()}, return_features=True)
    assert res.labels.shape == (1, 30, 44) and res.labels.dtype == np.int32
    assert res.features.shape == (1, 30, 44, 8)
    assert res.labels_refined is None
    assert {"network", "cluster", "stage1", "total"} <= set(res.timing)
    # the same seeded generator gives the same labels
    seg2 = Segmentor(cfg, state_dict_from_flax(variables, "resnet18_8s"),
                     network_name=NET, device="cpu")
    res2 = seg2.segment(img.numpy()[None], xyz.numpy()[None])
    np.testing.assert_array_equal(res2.labels, res.labels)


def test_stage1_turns_tf32_off_only_inside_its_call(jax_weights, monkeypatch):
    """float32 stage 1 runs without TF32; the caller's switches are left as
    they were, before and after the call."""
    _, _, variables = jax_weights
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = tcfg.Config.inference_default(**OVERRIDES)
    seg = Segmentor(cfg, state_dict_from_flax(variables, "resnet18_8s"),
                    network_name=NET, device="cpu")
    switches = lambda: (torch.backends.cudnn.allow_tf32,  # noqa: E731
                        torch.backends.cuda.matmul.allow_tf32)
    assert switches() == (True, True)
    seen = []
    forward = seg.model.forward

    def spy(*args, **kwargs):
        seen.append(switches())
        return forward(*args, **kwargs)

    monkeypatch.setattr(seg.model, "forward", spy)
    bgr, depth = scene(2)
    img, xyz = tpre.preprocess_rgbd(torch.from_numpy(bgr),
                                    torch.from_numpy(depth), cfg.pixel_means,
                                    *INTR)
    seg.segment(img[None], xyz[None])
    assert seen == [(False, False)]
    assert switches() == (True, True)


def test_segmentor_without_device_needs_a_card(jax_weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    _, _, variables = jax_weights
    cfg = tcfg.Config.inference_default(**OVERRIDES)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Segmentor(cfg, state_dict_from_flax(variables, "resnet18_8s"),
                  network_name=NET)


def test_port_imports_without_jax(tmp_path):
    """Every module of the port, chip_smoke, hill_climb_study and cc_study
    import with jax, flax, the JAX package, OpenCV and PIL blocked; the
    training, data and data-parallel slices' modules and the repo tools
    (fast_parity_report, probe_seed_precision, dataset_statistics) are
    among them, and a palette PNG written by PIL reads back (utils/masks
    through utils/png)."""
    from PIL import Image

    labels = np.random.RandomState(0).randint(0, 9, (13, 17)).astype(
        np.uint8)
    im = Image.fromarray(labels, mode="P")
    im.putpalette(list(range(27)))
    im.save(tmp_path / "labels.png")
    np.save(tmp_path / "labels.npy", labels)
    code = """
import pkgutil, sys, importlib
for name in ("jax", "jaxlib", "flax", "unseenobjectclustering_tpu", "cv2",
             "PIL"):
    sys.modules[name] = None
import unseenobjectclustering_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import hill_climb_study
import cc_study
training = {pkg.__name__ + "." + m for m in (
    "engine.train", "ops.augment", "ops.train_pipeline", "data.synthetic",
    "data.resident", "data.loader", "data.factory", "data.datasets",
    "tools.train_net", "tools.render_dataset")}
data = {pkg.__name__ + "." + m for m in (
    "data.pcd", "data.native", "data.augmentation", "utils.png",
    "utils.se3", "utils.profiling", "models.unets", "models.utils",
    "tools.test_net", "tools.make_real_fixtures")}
training |= {pkg.__name__ + "." + m for m in (
    "parallel", "parallel.mesh", "parallel.distributed")}
data |= {pkg.__name__ + ".tools." + m for m in (
    "fast_parity_report", "probe_seed_precision", "dataset_statistics")}
assert training | data <= set(names), (training | data) - set(names)
assert len(names) >= 35, names
import numpy as np
from unseenobjectclustering_torch.utils.masks import imread_indexed
got = imread_indexed(sys.argv[1] + "/labels.png")
assert got.dtype == np.uint8
assert (got == np.load(sys.argv[1] + "/labels.npy")).all()
print("ok", len(names))
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
