"""One whole training step of the port against the JAX package's: the
raw step (augmentation + forward + backward + update) under replayed
draws, the resident step as the raw step behind a gather, and the bf16
mixed-precision step.  Set-up and tolerances as in test_torch_train.py;
the bf16 step's loss within rtol 2e-2 (bfloat16 convolutions round
differently in XLA and in PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (HW, LR, NET, RECIPES, assert_states_close,
                              batches, configs, jax_state, port_state,
                              recipe_inputs)
from test_torch_train_pipeline import INTR, recipe_draws, scene
from unseenobjectclustering_torch.engine import train as ttrain
from unseenobjectclustering_tpu.engine import train as jtrain

torch.set_num_threads(1)


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_raw_step_matches_jax(recipe):
    """One whole step on raw scenes: the JAX package's fused augmentation +
    train step against the port's, the port fed the draws of the JAX
    step's key; under every input recipe (DEPTH with its depth
    artifacts)."""
    train = {"EMBEDDING_SAMPLING": True, "EMBEDDING_SAMPLING_NUM": 30,
             "CHROMATIC": True, "ADD_NOISE": True}
    jc, tc = configs(recipe, **train)
    bgr, depth, label = scene(12, b=2, h=HW, w=HW)
    js = jax_state(jc, "adam")
    ts = port_state(tc, js, "adam")
    key = jax.random.PRNGKey(5)
    jstep = jtrain.make_train_step_raw(jc, fx=INTR[0], fy=INTR[1],
                                       px=HW / 2, py=HW / 2, max_k=8)
    js, jm = jstep(js, jnp.asarray(bgr), jnp.asarray(depth),
                   jnp.asarray(label), key)
    tstep = ttrain.make_train_step_raw(tc, fx=INTR[0], fy=INTR[1],
                                       px=HW / 2, py=HW / 2, max_k=8)
    draws = recipe_draws(key, tc, bgr, depth, label)
    ts, tm = tstep(ts, torch.from_numpy(bgr),
                   torch.from_numpy(depth.astype(np.int32)),
                   torch.from_numpy(label), draws=draws)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-4)
    assert_states_close(js, ts, LR, steps=1, adam=True)


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
