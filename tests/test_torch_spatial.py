"""Spatial stage 1 of the port on the CPU: Segmentor.make_spatial_stage1
with one frame's width split over 2 and 4 gloo processes
(tests/torch_ranks.py), held against the JAX package's make_spatial_stage1
on its 8-device CPU mesh and against the port's one-process _stage1_impl.

The networks: ResNet-34-8s RGB-D with add fusion (tests/test_spatial_
inference.py's: 4-D embeddings, 8 seeds; the flax init with random
BatchNorm statistics, carried with state_dict_from_flax) at 32x64 over 2
ranks (32-column bands: 4 columns at 1/8, exactly layer4's halo) and at
32x128 over 4; ResNet-18-8s with the depth filter at 0.8 and an
invalid-depth band (test_multichip_production_shape.py's set-up at 48x64,
on a scene); the U-Net and VGG at 32x64 over 2 ranks (torch init from a
seed), against one process (tests/test_torch_models_alt.py holds that one
process against flax).  The first seed is pinned on every side, as in
test_torch_sharded.

Tolerances: labels equal; features within 1e-5 (the convolutions on a
band sum the same terms as on the frame, in the order the band's shape
gets).  Each planted fault (a zeroed halo in a dilated convolution, a
head upsample matrix built from the band's width, GroupNorm over the
band's own statistics) must move the features past 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_models import randomize_bn
from test_torch_pipeline import scene
from torch_ranks import run_ranks
from unseenobjectclustering_torch import Config
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.models import get_network
from unseenobjectclustering_torch.parallel import Mesh, spatial
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_tpu.config import Config as JConfig
from unseenobjectclustering_tpu.engine.pipeline import Segmentor as JSegmentor
from unseenobjectclustering_tpu.models import get_network as jax_get_network
from unseenobjectclustering_tpu.parallel import make_mesh

torch.set_num_threads(1)

FIRST = 3
FEATURE_TOL = 1e-5
RESNET34 = dict(INPUT="RGBD", TRAIN={"NUM_UNITS": 4},
                CLUSTER={"NUM_SEEDS": 8, "MAX_INSTANCES": 4})
RESNET18 = dict(INPUT="RGBD", TRAIN={"NUM_UNITS": 8},
                CLUSTER={"NUM_SEEDS": 100, "MAX_INSTANCES": 8, "KAPPA": 30.0,
                         "EPSILON": 0.02})
ALT = dict(INPUT="RGBD", TRAIN={"NUM_UNITS": 8},
           CLUSTER={"NUM_SEEDS": 16, "MAX_INSTANCES": 4, "KAPPA": 30.0,
                    "EPSILON": 0.02})


def flax_case(name, net, arch, overrides, h, w, threshold, inputs):
    """A case whose weights are the JAX network's flax init with random
    BatchNorm statistics (so the frames hold instances), with the JAX
    Segmentor that holds them (first seed pinned)."""
    jc = JConfig.inference_default(**overrides).replace(
        **{"CLUSTER.USE_PALLAS": False})
    units = overrides["TRAIN"]["NUM_UNITS"]
    model = jax_get_network(net, jc, num_units=units)
    zeros = jnp.zeros((1, h, w, 3), jnp.float32)
    variables = randomize_bn(model.init(jax.random.PRNGKey(0), zeros, zeros,
                                        train=False))
    jseg = JSegmentor(jc, variables, network_name=net,
                      depth_threshold=threshold, seed=7)
    jseg._ms_kw = dict(jseg._ms_kw, first_index=FIRST)
    img, xyz = inputs
    return dict(name=name, net=net, overrides=overrides, threshold=threshold,
                first_index=FIRST, img=img, xyz=xyz,
                state_dict=state_dict_from_flax(variables, arch)), jseg


def random_frame(seed, h, w):
    """test_spatial_inference.py's inputs."""
    rng = np.random.RandomState(seed)
    return (rng.rand(1, h, w, 3).astype(np.float32),
            rng.rand(1, h, w, 3).astype(np.float32))


def scene_frame(h, w, invalid_rows=0):
    """test_torch_pipeline's boxes on a table, tiled to the width and
    normalized as the CLIs do, with its XYZ; the top `invalid_rows` rows
    without depth (test_multichip_production_shape's invalid band)."""
    bgr, depth = scene(0, h=h, w=w // 2)
    bgr, depth = np.concatenate([bgr, bgr[:, ::-1]], 1), np.concatenate(
        [depth, depth[:, ::-1]], 1)
    img = (bgr.astype(np.float32) / 255.0 - 0.45)[None]
    ys, xs = np.mgrid[:h, :w].astype(np.float32)
    xyz = np.stack([(xs - w / 2) * depth / 40.0, (ys - h / 2) * depth / 40.0,
                    depth], -1)[None].astype(np.float32)
    xyz[:, :invalid_rows, :, 2] = 0.0
    return img, xyz


def torch_case(name, net, h, w):
    """A case with torch's init from a seed, on scene_frame."""
    torch.manual_seed(4)
    state_dict = get_network(net, Config.inference_default(**ALT)
                             ).state_dict()
    img, xyz = scene_frame(h, w)
    return dict(name=name, net=net, overrides=ALT, threshold=0.8,
                first_index=FIRST, state_dict=state_dict, img=img, xyz=xyz)


def one_process(case):
    """The port's _stage1_impl on the whole frame, in this process."""
    seg = Segmentor(Config.inference_default(**case["overrides"]),
                    case["state_dict"], network_name=case["net"],
                    depth_threshold=case["threshold"], seed=7, device="cpu")
    seg._ms_kw = dict(seg._ms_kw, first_index=case["first_index"])
    gens = [torch.Generator().manual_seed(11)
            for _ in range(len(case["img"]))]
    img = torch.from_numpy(case["img"])
    xyz = torch.from_numpy(case["xyz"])
    features, labels = seg._stage1_impl(img, xyz, gens,
                                        threshold=seg._threshold())
    return dict(features=features, labels=labels)


def exact_features(case):
    """The case's network in float64 on the whole frame, in this
    process."""
    cfg = Config.inference_default(**case["overrides"])
    model = get_network(case["net"], cfg)
    model.load_state_dict(case["state_dict"])
    with torch.no_grad():
        return model.double().eval()(torch.from_numpy(case["img"]).double(),
                                     torch.from_numpy(case["xyz"]).double())


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    r34, j34 = flax_case("resnet34", "seg_resnet34_8s_embedding",
                         "resnet34_8s", RESNET34, 32, 64, None,
                         random_frame(0, 32, 64))
    r18, j18 = flax_case("resnet18", "seg_resnet18_8s_embedding",
                         "resnet18_8s", RESNET18, 48, 64, 0.8,
                         scene_frame(48, 64, invalid_rows=8))
    cases = [r34, r18, torch_case("unet", "seg_unet_embedding", 32, 64),
             torch_case("vgg", "seg_vgg_embedding", 32, 64)]
    faults = [("resnet34", "zero_halo"), ("resnet34", "local_upsample"),
              ("unet", "band_groupnorm")]
    ranks = run_ranks("spatial_stage1", {"cases": cases, "faults": faults},
                      tmp_path_factory.mktemp("spatial2"))
    return dict(cases={c["name"]: c for c in cases},
                jax={"resnet34": j34, "resnet18": j18}, ranks=ranks)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    case, jseg = flax_case("resnet34", "seg_resnet34_8s_embedding",
                           "resnet34_8s", RESNET34, 32, 128, None,
                           random_frame(1, 32, 128))
    ranks = run_ranks("spatial_stage1", {"cases": [case], "faults": []},
                      tmp_path_factory.mktemp("spatial4"), world=4)
    return dict(cases={"resnet34": case}, jax={"resnet34": jseg},
                ranks=ranks)


def jax_spatial(jseg, case):
    keys = jax.random.split(jax.random.PRNGKey(11), len(case["img"]))
    fn = jseg.make_spatial_stage1(make_mesh())
    features, labels = fn(jseg.variables, jnp.asarray(case["img"]),
                          jnp.asarray(case["xyz"]), keys)
    return np.asarray(features), np.asarray(labels)


def assert_ranks_equal(ranks, name):
    for r in ranks[1:]:
        assert torch.equal(r[name]["features"], ranks[0][name]["features"])
        assert torch.equal(r[name]["labels"], ranks[0][name]["labels"])


@pytest.mark.parametrize("world,name", [(2, "resnet34"), (4, "resnet34"),
                                        (2, "resnet18")])
def test_spatial_matches_the_jax_mesh_and_one_process(request, world, name):
    """ResNet-34-8s RGB-D (2 ranks at 32x64, 4 at 32x128) and ResNet-18-8s
    with the depth filter (2 ranks at 48x64): labels equal to JAX's
    make_spatial_stage1 on the 8-device CPU mesh and to one process's
    _stage1_impl, features within 1e-5 of both, the same on every rank."""
    run = request.getfixturevalue("two_ranks" if world == 2
                                  else "four_ranks")
    case = run["cases"][name]
    assert_ranks_equal(run["ranks"], name)
    got = run["ranks"][0][name]
    want = one_process(case)
    jf, jl = jax_spatial(run["jax"][name], case)
    b, h, w = case["img"].shape[:3]
    assert got["features"].shape == want["features"].shape == jf.shape
    assert got["labels"].shape == (b, h, w) and got["labels"].dtype == \
        torch.int32
    np.testing.assert_array_equal(got["labels"].numpy(), jl)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  want["labels"].numpy())
    np.testing.assert_allclose(got["features"].numpy(), jf,
                               atol=FEATURE_TOL)
    np.testing.assert_allclose(got["features"].numpy(),
                               want["features"].numpy(), atol=FEATURE_TOL)
    assert len(np.unique(jl)) > 1


@pytest.mark.parametrize("name", ["unet", "vgg"])
def test_alternate_backbones_match_one_process(two_ranks, name):
    """The U-Net (GroupNorm over the whole frame, the 2x bilinear
    upsample) and VGG (2x2 pools, 4x4/2 transposed convolutions) over two
    ranks: labels equal to one process's, features within 1e-5; the U-Net
    finds instances on the scene.

    The U-Net's features are held to one process's in float64, the exact
    answer: on this frame torch's own float32 GroupNorm puts one process's
    features 1.1e-5 from it, while the route's float64 statistics stay
    within 3e-6, so the float32 process is no 1e-5 reference there."""
    case = two_ranks["cases"][name]
    assert_ranks_equal(two_ranks["ranks"], name)
    got = two_ranks["ranks"][0][name]
    want = one_process(case)
    ref = (exact_features(case) if name == "unet"
           else want["features"]).numpy()
    np.testing.assert_allclose(got["features"].numpy(), ref,
                               atol=FEATURE_TOL)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  want["labels"].numpy())
    if name == "unet":
        assert len(np.unique(want["labels"].numpy())) > 2


@pytest.mark.parametrize("name,fault", [
    ("resnet34", "zero_halo"), ("resnet34", "local_upsample"),
    ("unet", "band_groupnorm")])
def test_planted_faults_fail_the_feature_check(two_ranks, name, fault):
    case = two_ranks["cases"][name]
    got = two_ranks["ranks"][0][f"{name}/{fault}"]["features"].double()
    for want in (one_process(case)["features"].double(),
                 exact_features(case)):
        assert float((got - want).abs().max()) > FEATURE_TOL


def small_model(net, **overrides):
    cfg = Config.inference_default(**dict(ALT, **overrides))
    return get_network(net, cfg).eval()


@pytest.mark.parametrize("net,width,world", [
    ("seg_resnet34_8s_embedding", 48, 2),    # bands of 24: not 8k
    ("seg_resnet34_8s_embedding", 32, 2),    # 2 columns at 1/8 < 4
    ("seg_resnet18_8s_embedding", 63, 1),    # not a multiple of 8
    ("seg_unet_embedding", 48, 2),           # bands of 24: not 16k
    ("seg_vgg_embedding", 96, 2),            # bands of 48: not 32k
    ("seg_resnet34_8s_embedding", 64, 3),    # W does not split in 3
])
def test_the_width_rule_raises(net, width, world):
    plan = spatial.plan_network(small_model(net))
    with pytest.raises(ValueError, match="multiple of the network's total"):
        spatial.SpatialShard(Mesh(0, world, torch.device("cpu")), width,
                             plan)


def test_plans_name_stride_and_halo():
    plans = {net: spatial.plan_network(small_model(net)) for net in (
        "seg_resnet18_8s_embedding", "seg_resnet50_8s_embedding",
        "seg_unet_embedding", "seg_vgg_embedding")}
    assert [(p.stride, p.halo, p.input_halo) for p in plans.values()] == [
        (8, 4, (3, 2)), (8, 4, (3, 2)), (16, 1, (1, 1)), (32, 1, (1, 1))]
    # 480x640 over 2, 4 and 8 ranks fits all of them, but VGG over 8
    # (bands of 80 columns are 2.5 times its stride)
    for plan in plans.values():
        for world in (2, 4, 8)[:2 if plan.name == "vgg" else 3]:
            spatial.SpatialShard(Mesh(0, world, torch.device("cpu")), 640,
                                 plan)


def test_an_uncovered_module_raises_with_its_name():
    model = small_model("seg_resnet18_8s_embedding")
    model.fcn.resnet18_8s.layer1[0].bn1 = nn.InstanceNorm2d(64)
    with pytest.raises(NotImplementedError,
                       match=r"fcn\.resnet18_8s\.layer1\.0\.bn1 "
                             r"\(InstanceNorm2d\)"):
        spatial.plan_network(model)


def test_world_one_runs_the_sharded_layers():
    """One process, one band: the route runs its sharded layers with the
    frame's edge padding only (a planted zero halo in every dilated
    convolution changes nothing there) and gives _stage1_impl's labels
    and features within 1e-5; the train-mode BatchNorm refuses the
    route."""
    case = torch_case("resnet18", "seg_resnet18_8s_embedding", 32, 64)
    seg = Segmentor(Config.inference_default(**ALT), case["state_dict"],
                    network_name=case["net"], seed=7, device="cpu")
    seg._ms_kw = dict(seg._ms_kw, first_index=FIRST)
    fn = seg.make_spatial_stage1(Mesh(0, 1, torch.device("cpu")))
    calls = []
    real = spatial.SpatialShard.halo_exchange

    def spy(self, x, left, right, fill=0.0, dim=-1):
        calls.append((left, right))
        return real(self, x, left, right, fill, dim)

    spatial.SpatialShard.halo_exchange = spy
    try:
        features, labels = fn(case["img"], case["xyz"],
                              [torch.Generator().manual_seed(11)])
    finally:
        spatial.SpatialShard.halo_exchange = real
    assert (4, 4) in calls and (1, 1) in calls  # layer4's and the head's
    want = one_process(case)
    np.testing.assert_allclose(features.numpy(), want["features"].numpy(),
                               atol=FEATURE_TOL)
    np.testing.assert_array_equal(labels.numpy(), want["labels"].numpy())
    seg.model.train()
    with pytest.raises(NotImplementedError, match="eval-mode BatchNorm"):
        fn(case["img"], case["xyz"], [torch.Generator().manual_seed(11)])
