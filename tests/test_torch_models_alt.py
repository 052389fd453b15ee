"""The port's alternate backbones (models/unets.py: the GroupNorm U-Net and
the VGG encoder-decoder with and without BatchNorm), models/utils.py,
utils/se3.py and utils/profiling.py against the JAX package.

Weights are flax-initialized (random GroupNorm/BatchNorm scales and
statistics) and carried by utils.checkpoint.state_dict_from_flax, VGG's
transposed-convolution kernels flipped on the way.  Frames are 32x48
(U-Net: four 2x pools) and 32x64 (VGG: five), 8 embedding units.

Tolerances (float32; XLA and PyTorch sum convolutions in another order):
embeddings within atol 1e-4; the U-Net's train-mode loss within rtol 1e-4
and its gradients within 1e-4 of each tensor's largest entry; VGG's
train-mode BatchNorm statistics within atol 1e-4 + rtol 1e-4 (the train-
mode embeddings are not compared: at the deepest layers a channel's batch
statistics come from 4 values, which magnifies the convolutions' rounding
differences); se3 and the meters to 1e-12.
"""

import functools
import json
import os
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import randomize_bn
from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.engine import train as ttrain
from unseenobjectclustering_torch.models import get_network as tget
from unseenobjectclustering_torch.models import losses as tlosses
from unseenobjectclustering_torch.models import unets as tunets
from unseenobjectclustering_torch.models import utils as tmutils
from unseenobjectclustering_torch.utils import profiling as tprof
from unseenobjectclustering_torch.utils import se3 as tse3
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.models import get_network as jget
from unseenobjectclustering_tpu.models import losses as jlosses
from unseenobjectclustering_tpu.models import unets as junets
from unseenobjectclustering_tpu.models import utils as jmutils
from unseenobjectclustering_tpu.utils import profiling as jprof
from unseenobjectclustering_tpu.utils import se3 as jse3

torch.set_num_threads(1)

UNITS = 8
NETS = {"unet": ("seg_unet_embedding", (32, 48), False),
        "vgg": ("seg_vgg_embedding", (32, 64), False),
        "vgg_bn": ("seg_vgg_embedding", (32, 64), True)}
LOSS = dict(alpha=0.02, delta=0.5, lambda_intra=10.0, lambda_inter=10.0,
            max_k=8, metric="cosine")


@functools.lru_cache(maxsize=None)
def _flax(net, input_type, fusion):
    """The flax model and its numpy variables (random normalization
    scales and statistics), made once per configuration."""
    name, hw, bn = NETS[net]
    jm = jget(name, jcfg.Config.from_dict(_cfg(net, input_type, fusion)))
    x = jnp.zeros((1, *hw, 3), jnp.float32)
    return jm, randomize_bn(jm.init(jax.random.PRNGKey(0), x, x,
                                    train=False))


def _cfg(net, input_type, fusion):
    return {"INPUT": input_type, "TRAIN": {"NUM_UNITS": UNITS,
                                           "FUSION_TYPE": fusion,
                                           "VGG_BATCH_NORM": NETS[net][2]}}


def build(net, input_type="RGBD", fusion="add"):
    """(flax model, numpy variables, a new port model with the same
    weights)."""
    jm, variables = _flax(net, input_type, fusion)
    tm = tget(NETS[net][0],
              tcfg.Config.from_dict(_cfg(net, input_type, fusion)))
    tm.load_state_dict(state_dict_from_flax(variables, net.split("_")[0]))
    return jm, variables, tm


def inputs(net, b=1, seed=0):
    rng = np.random.RandomState(seed)
    hw = NETS[net][1]
    return (rng.randn(b, *hw, 3).astype(np.float32),
            rng.randn(b, *hw, 3).astype(np.float32))


def jax_apply(jm, variables, img, xyz, input_type):
    return jm.apply(variables, None if input_type == "DEPTH" else img,
                    None if input_type == "COLOR" else xyz, train=False)


@pytest.mark.parametrize("net,input_type,fusion", [
    (net, i, "add") for net in NETS for i in ("COLOR", "DEPTH", "RGBD")]
    + [("unet", "RGBD", "early"), ("unet", "RGBD", "cat")])
def test_embeddings_match_flax(net, input_type, fusion):
    jm, variables, tm = build(net, input_type, fusion)
    img, xyz = inputs(net)
    want = np.asarray(jax_apply(jm, variables, img, xyz, input_type))
    tm.eval()
    with torch.no_grad():
        got = tm(None if input_type == "DEPTH" else torch.from_numpy(img),
                 None if input_type == "COLOR" else torch.from_numpy(xyz))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_state_dict_keys_and_the_tconv_flip():
    _, variables, tm = build("vgg_bn")
    sd = tm.state_dict()
    assert set(sd) == set(state_dict_from_flax(variables, "vgg"))
    k = np.asarray(variables["params"]["fcn"]["dec_tconv1"]["kernel"])
    w = sd["fcn.vgg.dec_tconv1.weight"].numpy()
    assert w.shape == (k.shape[2], k.shape[3], 4, 4)
    np.testing.assert_array_equal(w[:, :, 0, 1], k[3, 2])
    assert "fcn_depth.vgg.bn0.running_var" in sd
    assert isinstance(tm.fcn.vgg.dec_tconv1, torch.nn.ConvTranspose2d)


def test_upsample_matches_jax_image_resize():
    x = np.random.RandomState(1).randn(2, 5, 7, 3).astype(np.float32)
    want = np.asarray(junets._upsample2x_bilinear(jnp.asarray(x)))
    got = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_unet_train_loss_and_gradients_match_jax_grad():
    jm, variables, tm = build("unet")
    img, xyz = inputs("unet", b=2, seed=3)
    labels = np.random.RandomState(4).randint(-1, 4, (2, 32, 48)).astype(
        np.int32)

    def jloss(params):
        feats = jm.apply({"params": params}, jnp.asarray(img),
                         jnp.asarray(xyz), train=True)
        return jlosses.embedding_loss(feats, jnp.asarray(labels),
                                      **LOSS).loss

    jv, jg = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    tm.train()
    out = tlosses.embedding_loss(tm(torch.from_numpy(img),
                                    torch.from_numpy(xyz)),
                                 torch.from_numpy(labels), **LOSS)
    out.loss.backward()
    np.testing.assert_allclose(float(out.loss.detach()), float(jv),
                               rtol=1e-4)
    want = state_dict_from_flax(
        {"params": jax.tree_util.tree_map(np.asarray, jg)}, "unet")
    grads = dict(tm.named_parameters())
    assert set(want) == set(grads)
    for key, g in want.items():
        got = grads[key].grad.numpy()
        scale = float(np.abs(g.numpy()).max())
        np.testing.assert_allclose(got, g.numpy(), rtol=0,
                                   atol=1e-4 * scale + 1e-9, err_msg=key)


def _flax_without_dropout(monkeypatch):
    """The JAX VGG's nn.Dropout replaced by the identity, through the
    module's flax name (the JAX package itself is not edited)."""
    patched = types.SimpleNamespace(**{k: getattr(fnn, k) for k in dir(fnn)
                                       if not k.startswith("__")})
    patched.Dropout = lambda **kw: (lambda x: x)
    monkeypatch.setattr(junets, "nn", patched)


def test_vgg_train_batchnorm_statistics_match_flax(monkeypatch):
    """Train mode with dropout off on both sides: the BatchNorm running
    statistics after one forward of a batch of two."""
    _flax_without_dropout(monkeypatch)
    monkeypatch.setattr(tunets.VGGEmbedding, "_dropout",
                        lambda self, x: x)
    jm, variables, tm = build("vgg_bn")
    img, xyz = inputs("vgg", b=2, seed=5)
    _, updated = jm.apply(variables, jnp.asarray(img), jnp.asarray(xyz),
                          train=True, mutable=["batch_stats"])
    tm.train()
    with torch.no_grad():
        tm(torch.from_numpy(img), torch.from_numpy(xyz))
    stats = state_dict_from_flax(
        {"batch_stats": jax.tree_util.tree_map(np.asarray, updated[
            "batch_stats"])}, "vgg")
    sd = tm.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 2 * 30  # two towers, 30 BatchNorms each
    for key in keys:
        np.testing.assert_allclose(sd[key].numpy(), stats[key].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_vgg_dropout_draws_from_its_generator():
    _, _, tm = build("vgg", input_type="COLOR")
    img = torch.from_numpy(inputs("vgg")[0])
    tm.train()
    with pytest.raises(ValueError, match="dropout_generator"):
        tm(img)
    runs = []
    for _ in range(2):
        tm.fcn.vgg.dropout_generator = torch.Generator().manual_seed(7)
        with torch.no_grad():
            runs.append(tm(img))
    assert torch.equal(runs[0], runs[1])
    tm.eval()
    with torch.no_grad():
        assert not torch.equal(tm(img), runs[0])


def test_vgg_trains_through_the_engine():
    """create_train_state seeds VGG's dropout generator; one SGD step."""
    cfg = tcfg.Config.from_dict({"INPUT": "COLOR", "MODE": "TRAIN",
                                 "TRAIN": {"NUM_UNITS": UNITS,
                                           "VGG_BATCH_NORM": True}})
    state = ttrain.create_train_state(cfg, network_name="seg_vgg_embedding",
                                      solver="sgd", device="cpu")
    assert state.model.fcn.vgg.dropout_generator is not None
    step = ttrain.make_train_step(cfg, max_k=4)
    img = torch.from_numpy(inputs("vgg")[0])
    label = torch.zeros((1, 32, 64), dtype=torch.int32)
    label[:, 8:20, 10:30] = 1
    before = state.model.fcn.vgg.bn0.running_mean.clone()
    state, metrics = step(state, img, None, label)
    assert np.isfinite(float(metrics["loss"])) and state.step == 1
    assert not torch.equal(before, state.model.fcn.vgg.bn0.running_mean)


@pytest.mark.parametrize("net", ["unet", "vgg_bn"])
def test_bf16_convolutions(net):
    """Fast mode's cast (models.cast_convs): the network runs with
    bfloat16 convolutions and float32 normalization layers and returns
    float32 unit embeddings close to the float32 network's."""
    from unseenobjectclustering_torch.models import cast_convs

    _, _, tm = build(net)
    img, xyz = (torch.from_numpy(a) for a in inputs(net))
    tm.eval()
    with torch.no_grad():
        want = tm(img, xyz)
        got = cast_convs(tm, torch.bfloat16)(img, xyz)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) < 0.1


def test_model_utils_match_jax():
    x = np.random.RandomState(2).randn(2, 3, 5, 4).astype(np.float32)
    t = torch.from_numpy(x)
    for tf, jf in ((tmutils.log_softmax_stable, jmutils.log_softmax_stable),
                   (tmutils.softmax_stable, jmutils.softmax_stable)):
        np.testing.assert_allclose(tf(t).numpy(), np.asarray(jf(x)),
                                   rtol=1e-6, atol=1e-6)
    for normalize in (True, False):
        np.testing.assert_allclose(
            tmutils.concatenate_spatial_coordinates(t, normalize).numpy(),
            np.asarray(jmutils.concatenate_spatial_coordinates(
                jnp.asarray(x), normalize)), rtol=0, atol=1e-6)


def test_se3_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(5):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        m = tse3.quat2mat(q)
        np.testing.assert_array_equal(m, jse3.quat2mat(q))
        np.testing.assert_array_equal(tse3.mat2quat(m), jse3.mat2quat(m))
        rt = np.concatenate([m, rng.randn(3, 1)], axis=1)
        rt2 = np.concatenate([tse3.quat2mat(rng.randn(4)), rng.randn(3, 1)],
                             axis=1)
        pts = rng.randn(6, 3)
        for name, args in (("se3_inverse", (rt,)), ("se3_mul", (rt, rt2)),
                           ("se3_transform_points", (rt, pts)),
                           ("egocentric2allocentric", (q, rng.randn(3))),
                           ("quat_mul", (q, rng.randn(4)))):
            np.testing.assert_allclose(getattr(tse3, name)(*args),
                                       getattr(jse3, name)(*args),
                                       rtol=0, atol=1e-12, err_msg=name)


def test_meters_match_jax(tmp_path):
    values = np.random.RandomState(1).rand(7)
    tm, jm = tprof.AverageMeter(), jprof.AverageMeter()
    for i, v in enumerate(values):
        tm.update(float(v), n=i + 1)
        jm.update(float(v), n=i + 1)
    assert (tm.val, tm.sum, tm.count) == (jm.val, jm.sum, jm.count)
    assert abs(tm.avg - jm.avg) < 1e-12
    timer = tprof.StageTimer()
    with timer.time("a"):
        pass
    assert timer.summary().startswith("a: ")
    with tprof.trace(str(tmp_path / "trace")) as prof:
        with tprof.annotate("region"):
            torch.ones(4).sum()
    assert any(e.key == "region" for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
