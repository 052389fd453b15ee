"""One whole training step of the port against the JAX package's: the
raw step (augmentation + forward + backward + update) under replayed
draws, the resident step as the raw step behind a gather, and the bf16
mixed-precision step.  Set-up and tolerances as in test_torch_train.py;
the bf16 step's loss within rtol 2e-2 (bfloat16 convolutions round
differently in XLA and in PyTorch).  The raw step also runs the
full-depth ResNet-50-8s (bottleneck towers, layers (3, 4, 6, 3)) under the
RGB-D add recipe, from numpy-filled variables
(test_torch_models.numpy_variables).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (HW, LR, NET, RECIPES, assert_states_close,
                              batches, configs, jax_state, port_state,
                              recipe_inputs)
from test_torch_models import numpy_variables
from test_torch_train_pipeline import INTR, recipe_draws, scene
from unseenobjectclustering_torch.ops.train_pipeline import make_device_augment
from unseenobjectclustering_torch.engine import train as ttrain
from unseenobjectclustering_tpu.engine import train as jtrain
from unseenobjectclustering_tpu.models import get_network as jax_network

torch.set_num_threads(1)

# the raw step's cases: (recipe, network, tower); ResNet-18-8s under every
# input recipe, and the full-depth ResNet-50-8s under RGB-D add
RAW_CASES = {recipe: (recipe, NET, "resnet18_8s") for recipe in RECIPES}
RAW_CASES["resnet50"] = ("rgbd_add", "seg_resnet50_8s_embedding",
                         "resnet50_8s")


@pytest.mark.parametrize("case", list(RAW_CASES))
def test_raw_step_matches_jax(case):
    """One whole step on raw scenes: the JAX package's fused augmentation +
    train step against the port's, the port fed the draws of the JAX
    step's key; under every input recipe (DEPTH with its depth
    artifacts), and through ResNet-50-8s's bottleneck blocks (conv3/bn3
    and layer 1's downsample: their BatchNorm statistics too).

    ResNet-50-8s reaches 4x4 pixels at 32x32, and its float32 gradients
    are ill-conditioned there in both packages: each lies about 2% (by
    relative L2) from the same step computed in float64, so one in 200
    parameters takes Adam's first step with the other sign.  Its float32
    step is held on the loss and the BatchNorm statistics; its
    parameters, at the same tolerances, on the step computed in float64
    by both packages (JAX under jax_enable_x64 with model_dtype float64,
    the port's network in float64) from the augmented batch of the same
    draws."""
    recipe, net, arch = RAW_CASES[case]
    train = {"EMBEDDING_SAMPLING": True, "EMBEDDING_SAMPLING_NUM": 30,
             "CHROMATIC": True, "ADD_NOISE": True}
    jc, tc = configs(recipe, **train)
    bgr, depth, label = scene(12, b=2, h=HW, w=HW)
    variables = None
    if arch == "resnet50_8s":
        zeros = jnp.zeros((1, HW, HW, 3), jnp.float32)
        variables = numpy_variables(jax_network(net, jc), zeros, zeros,
                                    seed=6)
    js = jax_state(jc, "adam", net=net, variables=variables)
    ts = port_state(tc, js, "adam", net=net, arch=arch)
    key = jax.random.PRNGKey(5)
    jstep = jtrain.make_train_step_raw(jc, fx=INTR[0], fy=INTR[1],
                                       px=HW / 2, py=HW / 2, max_k=8)
    js_next, jm = jstep(js, jnp.asarray(bgr), jnp.asarray(depth),
                        jnp.asarray(label), key)
    tstep = ttrain.make_train_step_raw(tc, fx=INTR[0], fy=INTR[1],
                                       px=HW / 2, py=HW / 2, max_k=8)
    draws = recipe_draws(key, tc, bgr, depth, label)
    ts_next, tm = tstep(ts, torch.from_numpy(bgr),
                        torch.from_numpy(depth.astype(np.int32)),
                        torch.from_numpy(label), draws=draws)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    if variables is None:
        assert_states_close(js_next, ts_next, LR, steps=1, adam=True,
                            arch=arch)
        return
    assert_states_close(js_next, ts_next, LR, steps=1, adam=True, arch=arch,
                        params=False)
    # the same step in float64, from the augmented batch of the same draws
    _, augment = make_device_augment(tc, fx=INTR[0], fy=INTR[1], px=HW / 2,
                                     py=HW / 2)
    img, xyz, lab = augment(torch.from_numpy(bgr),
                            torch.from_numpy(depth.astype(np.int32)),
                            torch.from_numpy(label), draws)
    jax.config.update("jax_enable_x64", True)
    try:
        js64 = jax_state(jc, "adam", net=net, variables=variables,
                         model_dtype=jnp.float64)
        js64, jm64 = jtrain.make_train_step(jc, max_k=8)(
            js64, *(jnp.asarray(t.numpy()) for t in (img, xyz, lab)))
    finally:
        jax.config.update("jax_enable_x64", False)
    ts64 = port_state(tc, js, "adam", net=net, arch=arch)
    ts64.model.double()
    ts64, tm64 = ttrain.make_train_step(tc, max_k=8)(
        ts64, img.double(), xyz.double(), lab)
    assert tm64["loss"].dtype == torch.float64
    np.testing.assert_allclose(float(tm64["loss"]), float(jm64["loss"]),
                               rtol=2e-4)
    ts64.model.float()
    assert_states_close(js64, ts64, LR, steps=1, adam=True, arch=arch)


@pytest.mark.parametrize("recipe", ["rgbd_add", "color", "depth"])
def test_resident_step_is_the_raw_step_behind_a_gather(recipe):
    _, tc = configs(recipe, EMBEDDING_SAMPLING=True,
                    EMBEDDING_SAMPLING_NUM=30)
    bgr, depth, label = (torch.from_numpy(a) for a in scene(13, b=4, h=HW,
                                                             w=HW))
    depth = depth.to(torch.int32)
    idx = torch.tensor([2, 0])
    kw = dict(fx=INTR[0], fy=INTR[1], px=HW / 2, py=HW / 2, max_k=8)
    states = [ttrain.create_train_state(tc, network_name=NET,
                                        device="cpu")
              for _ in range(2)]
    _, m_res = ttrain.make_train_step_resident(tc, **kw)(
        states[0], bgr, depth, label, idx,
        gen=torch.Generator().manual_seed(9))
    _, m_raw = ttrain.make_train_step_raw(tc, **kw)(
        states[1], bgr[idx], depth[idx], label[idx],
        gen=torch.Generator().manual_seed(9))
    assert float(m_res["loss"]) == float(m_raw["loss"])
    for a, b in zip(states[0].model.state_dict().values(),
                    states[1].model.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("recipe", ["rgbd_add", "depth"])
def test_bf16_step_keeps_float32_state(recipe):
    """--bf16: convolutions in bfloat16, parameters, Adam moments,
    BatchNorm statistics and the loss in float32; the loss near the JAX
    package's bf16 step (RGB-D add, and DEPTH, whose recipe trains on
    the card with --bf16)."""
    jc, tc = configs(recipe)
    js = jtrain.create_train_state(jc, network_name=NET, height=HW,
                                   width=HW, model_dtype=jnp.bfloat16)
    ts = port_state(tc, js, "adam", model_dtype=torch.bfloat16)
    img, xyz, label = batches(1, seed=3)[0]
    img, xyz = recipe_inputs(tc, img, xyz)
    js, jm = jtrain.make_train_step(jc, max_k=8)(
        js, *(None if a is None else jnp.asarray(a) for a in (img, xyz)),
        jnp.asarray(label))
    ts, tm = ttrain.make_train_step(tc, max_k=8)(
        ts, *(None if a is None else torch.from_numpy(a)
              for a in (img, xyz)), torch.from_numpy(label))
    assert tm["loss"].dtype == torch.float32
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-2)
    for tensor in ts.model.state_dict().values():
        assert tensor.dtype in (torch.float32, torch.int64)
    for per_param in ts.optimizer.state.values():
        assert per_param["exp_avg"].dtype == torch.float32
    conv = ts.model.fcn.resnet18_8s.conv1
    assert conv.compute_dtype == torch.bfloat16
    assert conv(torch.zeros(1, 3, 8, 8)).dtype == torch.bfloat16
