"""The port's networks against the JAX package through the weight carry.

Flax variables are initialized in JAX, their BatchNorm scales, biases and
statistics randomized (so the mean/var mapping is exercised), carried over
with utils.checkpoint.state_dict_from_flax, loaded with strict=True, and
both networks run on the same numpy frame.

Tolerance: embeddings within atol 1e-4 at float32 — convolutions sum in a
different order in XLA and in PyTorch.

The full-depth ResNet-50-8s towers (47.3 M parameters for two) take their
variables from numpy at the shapes flax's init traces (numpy_variables):
running flax's init of them costs tens of seconds on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.models import (NETWORK_FACTORIES,
                                                 cast_convs, compute_convs_in,
                                                 get_network)
from unseenobjectclustering_torch.models import resnet as tresnet
from unseenobjectclustering_torch.models.segnet import SEGNET
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_tpu.models import resnet as jresnet
from unseenobjectclustering_tpu.models.segnet import SEGNET as JSEGNET

torch.set_num_threads(1)

H, W = 32, 48
ATOL = 1e-4


def randomize_bn(variables, seed=0):
    """Random BN scale/bias/mean/var (numpy tree)."""
    rng = np.random.RandomState(seed)
    tree = jax.tree_util.tree_map(np.asarray, variables)

    def walk(node, coll):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, coll)
            elif coll == "batch_stats" and k == "mean":
                node[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
            elif coll == "batch_stats" and k == "var":
                node[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            elif coll == "params" and k == "scale":
                node[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)

    for coll in tree:
        walk(tree[coll], coll)
    return tree


def numpy_variables(jmodel, *inputs, seed=0):
    """Variables of the shapes jmodel.init gives for `inputs` (traced with
    jax.eval_shape, not run), filled from numpy: He-normal kernels, biases
    and BatchNorm offsets 0.1 * N(0, 1), then randomize_bn."""
    shapes = jax.eval_shape(
        lambda key: jmodel.init(key, *inputs, train=False),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(leaf):
        if len(leaf.shape) == 4:  # [kh, kw, in, out]
            std = np.sqrt(2.0 / np.prod(leaf.shape[:3]))
            return (std * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return randomize_bn(jax.tree_util.tree_map(fill, shapes), seed=seed)


@pytest.fixture(scope="module")
def resnet50_variables():
    """One set of full-depth two-tower ResNet-50-8s variables with 64 units
    (add and cat fusion share their shapes)."""
    img, xyz = frame()
    jmodel = JSEGNET(network_name="resnet50_8s", input_type="RGBD",
                     fusion_type="add", num_units=64)
    return numpy_variables(jmodel, jnp.asarray(img), jnp.asarray(xyz))


def frame(seed=0):
    rng = np.random.RandomState(seed)
    img = rng.randn(1, H, W, 3).astype(np.float32)
    xyz = rng.randn(1, H, W, 3).astype(np.float32)
    return img, xyz


@pytest.mark.parametrize("arch,input_type,fusion", [
    pytest.param("resnet18_8s", "RGBD", "add", id="RGBD-add"),
    pytest.param("resnet18_8s", "RGBD", "early", id="RGBD-early"),
    pytest.param("resnet18_8s", "RGBD", "cat", id="RGBD-cat"),
    pytest.param("resnet18_8s", "COLOR", "add", id="COLOR-add"),
    pytest.param("resnet50_8s", "RGBD", "add", id="resnet50_8s-RGBD-add"),
    pytest.param("resnet50_8s", "RGBD", "cat", id="resnet50_8s-RGBD-cat")])
def test_segnet_embeddings_match_through_the_carry(arch, input_type, fusion,
                                                   request):
    """ResNet-18-8s with 8 units under each input and fusion, and the
    full-depth ResNet-50-8s (bottleneck blocks: conv3/bn3 and layer 1's
    64 -> 256 downsample) with 64 units, RGB-D add and cat."""
    full = arch == "resnet50_8s"
    kw = dict(network_name=arch, input_type=input_type, fusion_type=fusion,
              num_units=64 if full else 8)
    jmodel = JSEGNET(**kw)
    img, xyz = frame()
    chans = 6 if (input_type, fusion) == ("RGBD", "early") else 3
    if full:
        variables = request.getfixturevalue("resnet50_variables")
    else:
        variables = randomize_bn(jmodel.init(
            jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(xyz),
            train=False))
    apply = functools.partial(jmodel.apply, train=False)
    want = np.asarray((jax.jit(apply) if full else apply)(
        variables, jnp.asarray(img), jnp.asarray(xyz)))

    tmodel = SEGNET(**kw)
    tmodel.load_state_dict(state_dict_from_flax(variables, arch),
                           strict=True)
    tower = getattr(tmodel.fcn, arch)
    assert tower.conv1.weight.shape[1] == chans
    if full:
        block = tower.layer1[0]
        assert block.conv3.weight.shape == (256, 64, 1, 1)
        assert block.downsample[0].weight.shape == (256, 64, 1, 1)
        assert len(tower.layer3) == 6 and tower.layer4[0].conv2.dilation == (
            4, 4)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(img),
                            torch.from_numpy(xyz)).numpy()
    assert got.shape == want.shape == (1, H, W, jmodel.embedding_dim)
    assert tmodel.embedding_dim == jmodel.embedding_dim
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bottleneck_fcn_matches_through_the_carry():
    """Bottleneck blocks (resnet50's) on a (1,1,1,1) trunk, carried as one
    tower."""
    jnet = jresnet.ResNetFCN(block="bottleneck", layers=(1, 1, 1, 1),
                             num_classes=8)
    img, _ = frame(1)
    variables = jnet.init(jax.random.PRNGKey(1), jnp.asarray(img),
                          train=False)
    variables = randomize_bn(variables, seed=1)
    want = np.asarray(jnet.apply(variables, jnp.asarray(img), train=False))

    towered = {coll: {"fcn": tree} for coll, tree in variables.items()}
    sd = state_dict_from_flax(towered, "resnet50_8s")
    sd = {k[len("fcn.resnet50_8s."):]: v for k, v in sd.items()}
    tnet = tresnet.ResNetFCN("bottleneck", (1, 1, 1, 1), num_classes=8)
    tnet.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tnet.eval()(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("expansion,layers", [(1, (3, 4, 6, 3)),
                                              (4, (3, 4, 6, 3)),
                                              (1, (2, 2, 2, 2))])
def test_plan_layers_matches(expansion, layers):
    assert (tresnet._plan_layers(expansion, layers, 8)
            == jresnet._plan_layers(expansion, layers, 8))


def test_factories_build_the_reference_key_layout():
    cfg = tcfg.Config.inference_default(INPUT="RGBD")
    assert sorted(NETWORK_FACTORIES) == [
        "seg_resnet18_8s_embedding", "seg_resnet34_8s_embedding",
        "seg_resnet34_8s_embedding_early", "seg_resnet50_8s_embedding",
        "seg_unet_embedding", "seg_vgg_embedding"]
    keys = get_network("seg_resnet34_8s_embedding", cfg).state_dict()
    for k in ("fcn.resnet34_8s.layer2.1.conv1.weight",
              "fcn.resnet34_8s.layer2.0.downsample.0.weight",
              "fcn.resnet34_8s.layer2.0.downsample.1.running_var",
              "fcn_depth.resnet34_8s.fc.bias",
              "fcn.resnet34_8s.bn1.num_batches_tracked"):
        assert k in keys
    early = get_network("seg_resnet34_8s_embedding_early", cfg)
    assert early.fcn.resnet34_8s.conv1.weight.shape == (64, 6, 7, 7)
    assert not hasattr(early, "fcn_depth")
    with pytest.raises(KeyError):
        get_network("seg_vgg16", cfg)


def test_bf16_conv_stack_gives_float32_unit_embeddings():
    cfg = tcfg.Config.inference_default(INPUT="RGBD")
    torch.manual_seed(0)
    net = get_network("seg_resnet18_8s_embedding", cfg, num_units=8).eval()
    img, xyz = frame(2)
    with torch.no_grad():
        f32 = net(torch.from_numpy(img), torch.from_numpy(xyz))
        bf = net.to(torch.bfloat16)(torch.from_numpy(img),
                                    torch.from_numpy(xyz))
    assert bf.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(bf, dim=-1).numpy(), 1.0,
                               atol=1e-5)
    # bf16 keeps ~3 significant digits through 8 conv layers
    cos = (bf * f32).sum(-1)
    assert float(cos.mean()) > 0.95


@pytest.mark.parametrize("seed", [2, 3, 5])
def test_bf16_network_matches_the_jax_bf16_network(seed):
    """Fast mode's network as the Segmentor builds it (model_dtype
    bfloat16: convolutions in bf16, BatchNorm in float32) against the JAX
    package's get_network(..., dtype=bfloat16) on the same carried weights
    (random BN scales and statistics), ResNet-18 RGB-D add, 64x96.  Both
    round every conv output to bf16 and sum in float32 in other orders, so
    they stay about as far apart as either is from float32: max |diff| <=
    2e-2 and every pixel's cosine >= 0.9995.  (With BatchNorm rounded to
    bf16 too, seeds 3 and 5 miss both.)"""
    from unseenobjectclustering_torch.engine.pipeline import Segmentor
    from unseenobjectclustering_tpu import config as jcfg
    from unseenobjectclustering_tpu.models import get_network as jax_network

    h, w = 64, 96
    net = "seg_resnet18_8s_embedding"
    overrides = dict(INPUT="RGBD", TRAIN={"NUM_UNITS": 8})
    jmodel = jax_network(net, jcfg.Config.inference_default(**overrides),
                         dtype=jnp.bfloat16)
    rng = np.random.RandomState(seed)
    img = rng.randn(1, h, w, 3).astype(np.float32)
    xyz = rng.randn(1, h, w, 3).astype(np.float32)
    variables = randomize_bn(jmodel.init(jax.random.PRNGKey(seed),
                                         jnp.asarray(img), jnp.asarray(xyz),
                                         train=False), seed=seed)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(img),
                                   jnp.asarray(xyz), train=False))

    seg = Segmentor(tcfg.Config.inference_default(**overrides),
                    state_dict_from_flax(variables, "resnet18_8s"),
                    network_name=net, model_dtype=torch.bfloat16,
                    device="cpu")
    bn = seg.model.fcn.resnet18_8s.bn1
    assert seg.model.fcn.resnet18_8s.conv1.weight.dtype == torch.bfloat16
    assert bn.weight.dtype == bn.running_var.dtype == torch.float32
    with torch.no_grad():
        got = seg.model(torch.from_numpy(img), torch.from_numpy(xyz)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-2
    assert (got * want).sum(-1).min() >= 0.9995


def test_bf16_reaches_every_bottleneck_conv():
    """ResNet-50-8s in bfloat16: compute_convs_in (training's --bf16) sets
    every convolution's compute dtype, conv3 and layer 1's downsample
    conv included, and cast_convs (fast mode) rounds every convolution's
    weights; BatchNorm stays float32 under both."""
    cfg = tcfg.Config.inference_default(INPUT="RGBD")
    net = get_network("seg_resnet50_8s_embedding", cfg)
    block = net.fcn.resnet50_8s.layer1[0]
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    assert block.conv3 in convs and block.downsample[0] in convs
    compute_convs_in(net, torch.bfloat16)
    assert all(m.compute_dtype == torch.bfloat16 for m in convs)
    out = block.conv3(torch.zeros(1, 64, 4, 4))
    assert out.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in net.parameters())
    compute_convs_in(net, None)
    cast_convs(net, torch.bfloat16)
    assert all(m.weight.dtype == torch.bfloat16 for m in convs)
    assert block.bn3.weight.dtype == block.downsample[1].running_var.dtype \
        == torch.float32
