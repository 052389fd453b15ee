"""The port's training engine against the JAX package's: the optimizer
steps, the schedule, the train-mode BatchNorm statistics inside the
network, and one whole raw step (augmentation + forward + backward +
update) under replayed draws.

The JAX state is created from flax-initialized variables; the port's from
the same variables through utils.checkpoint.state_dict_from_flax.  The
whole raw step and the bf16 step are in test_torch_train_step.py.  The
network is seg_resnet18_8s_embedding with 8 embedding units on 32x32
frames, batch 2.

SGD runs at lr 1e-3, Adam at the recipe's 1e-5.

Tolerances (float32; XLA and PyTorch sum convolutions in another order):
losses within rtol 2e-4; parameters after the updates within
atol 1e-6 + 2e-2 of the lr, except that under Adam at most 1 in 1000
parameters may differ by up to 2 lr per step (Adam moves a parameter by
about lr * sign(g) whatever |g|, so a gradient within rounding of 0 may
move it either way); BatchNorm running statistics within atol 1e-4 +
rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.engine import train as ttrain
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.engine import train as jtrain

torch.set_num_threads(1)

NET, ARCH = "seg_resnet18_8s_embedding", "resnet18_8s"
HW = 32
LR = 1e-3
ADAM_LR = 1e-5  # the recipe's


# The input recipes: INPUT and the TRAIN keys that set each one apart
# (cfgs/synthetic_240x320_<recipe>.yml).  COLOR and DEPTH train one
# 3-channel tower, early one 6-channel tower, add and cat two towers.
RECIPES = {"rgbd_add": ("RGBD", {}),
           "color": ("COLOR", {}),
           "depth": ("DEPTH", {"DEPTH_ARTIFACTS": True}),
           "early": ("RGBD", {"FUSION_TYPE": "early"}),
           "cat": ("RGBD", {"FUSION_TYPE": "cat"})}


def cfg_dict(recipe="rgbd_add", **train):
    input_type, keys = RECIPES[recipe]
    return {"INPUT": input_type, "MODE": "TRAIN",
            "TRAIN": dict({"NUM_UNITS": 8, "EMBEDDING_ALPHA": 0.02,
                           "EMBEDDING_DELTA": 0.5,
                           "EMBEDDING_LAMBDA_INTRA": 10.0,
                           "EMBEDDING_LAMBDA_INTER": 10.0,
                           "LEARNING_RATE": LR, "WEIGHT_DECAY": 5e-4,
                           "MILESTONES": [2], "GAMMA": 0.1}, **keys,
                          **train)}


def configs(recipe="rgbd_add", **train):
    d = cfg_dict(recipe, **train)
    return jcfg.Config.from_dict(d), tcfg.Config.from_dict(d)


def recipe_inputs(cfg, img, xyz):
    """(img, xyz) as the recipe's network takes them: None for the input
    it does not read."""
    return (None if cfg.INPUT == "DEPTH" else img,
            None if cfg.INPUT == "COLOR" else xyz)


def batches(n, b=2, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = rng.randn(b, HW, HW, 3).astype(np.float32)
        xyz = rng.randn(b, HW, HW, 3).astype(np.float32)
        label = rng.randint(-1, 4, (b, HW, HW)).astype(np.int32)
        out.append((img, xyz, label))
    return out


def jax_state(jc, solver, **kw):
    return jtrain.create_train_state(jc, network_name=NET, solver=solver,
                                     height=HW, width=HW, **kw)


def port_state(tc, js, solver, **kw):
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats})
    return ttrain.create_train_state(
        tc, network_name=NET, solver=solver,
        state_dict=state_dict_from_flax(variables, ARCH), device="cpu",
        **kw)


def assert_states_close(js, ts, lr, steps=3, adam=False):
    """Parameters and BatchNorm buffers of the two states.  Under Adam a
    parameter whose gradient is within rounding of 0 moves by up to lr
    either way (m / sqrt(v) is +-1 for any |g| >> eps), so there at most
    1 in 1000 parameters may differ, by no more than 2 * lr * steps."""
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": js.params, "batch_stats": js.batch_stats}),
        ARCH)
    got = ts.model.state_dict()
    tol = 1e-6 + 2e-2 * lr
    far, total = 0, 0
    for key, w in want.items():
        g = got[key].detach().numpy()
        if key.endswith("num_batches_tracked"):
            continue
        if "running_" in key:
            np.testing.assert_allclose(g, w.numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=key)
        elif adam:
            diff = np.abs(g - w.numpy())
            assert diff.max() <= 2 * lr * steps, key
            far += int((diff > tol).sum())
            total += diff.size
        else:
            np.testing.assert_allclose(g, w.numpy(), atol=tol, err_msg=key)
    assert far <= total // 1000, (far, total)


@pytest.mark.parametrize("recipe, solver", [
    pytest.param("rgbd_add", "adam", id="adam"),
    pytest.param("rgbd_add", "sgd", id="sgd"),
    pytest.param("color", "adam", id="color"),
    pytest.param("depth", "adam", id="depth"),
    pytest.param("early", "adam", id="early"),
    pytest.param("cat", "adam", id="cat")])
def test_three_steps_match_jax(recipe, solver):
    """3 Adam steps, or 3 SGD steps across the milestone at step 2: loss
    per step, parameters and BatchNorm buffers (the running variance is
    the biased one, as flax writes it); Adam under every input recipe."""
    lr = ADAM_LR if solver == "adam" else LR
    jc, tc = configs(recipe, LEARNING_RATE=lr)
    js = jax_state(jc, solver, steps_per_epoch=1)
    ts = port_state(tc, js, solver, steps_per_epoch=1)
    jstep = jtrain.make_train_step(jc, max_k=8)
    tstep = ttrain.make_train_step(tc, max_k=8)
    for img, xyz, label in batches(3):
        img, xyz = recipe_inputs(tc, img, xyz)
        js, jm = jstep(js, *(None if a is None else jnp.asarray(a)
                             for a in (img, xyz)), jnp.asarray(label))
        ts, tm = tstep(ts, *(None if a is None else torch.from_numpy(a)
                             for a in (img, xyz)), torch.from_numpy(label))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(float(tm["intra"]), float(jm["intra"]),
                                   rtol=2e-4)
        np.testing.assert_allclose(float(tm["inter"]), float(jm["inter"]),
                                   rtol=2e-4, atol=1e-7)
    assert ts.step == int(js.step) == 3
    assert ts.schedule(ts.step) == pytest.approx(float(js.schedule(3)))
    assert_states_close(js, ts, lr, adam=solver == "adam")


@pytest.mark.parametrize("start_epoch", [0, 2, 5])
def test_schedule_matches_jax(start_epoch):
    """MultiStepLR by optimizer step: milestones relative to start_epoch
    (a fresh start at --startepoch) and absolute (start_epoch 0, the
    --resume convention)."""
    for milestones in ((3,), (2, 4), (4, 4)):
        j = jtrain.multistep_schedule(0.5, milestones, 0.1,
                                      steps_per_epoch=3,
                                      start_epoch=start_epoch)
        t = ttrain.multistep_schedule(0.5, milestones, 0.1,
                                      steps_per_epoch=3,
                                      start_epoch=start_epoch)
        for step in range(20):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-6), (
                milestones, step)


def test_optimizers_follow_the_config():
    _, tc = configs(MOMENTUM=0.8, BETA=0.99)
    model = torch.nn.Linear(2, 2)
    adam, sched = ttrain.make_optimizer(tc, model.parameters(), "adam")
    assert isinstance(adam, torch.optim.Adam)
    assert adam.defaults["betas"] == (0.8, 0.99)
    assert adam.defaults["weight_decay"] == 5e-4
    assert sched(1000) == LR
    sgd, _ = ttrain.make_optimizer(tc, model.parameters(), "sgd")
    assert sgd.defaults["momentum"] == 0.8
    with pytest.raises(ValueError):
        ttrain.make_optimizer(tc, model.parameters(), "rmsprop")


def test_train_state_round_trip():
    _, tc = configs()
    a = ttrain.create_train_state(tc, network_name=NET, seed=1,
                                  device="cpu")
    img, xyz, label = (torch.from_numpy(x) for x in batches(1)[0])
    a, _ = ttrain.make_train_step(tc, max_k=8)(a, img, xyz, label)
    b = ttrain.create_train_state(tc, network_name=NET, seed=2,
                                  device="cpu")
    b.load_state_dict(a.state_dict())
    assert b.step == 1
    for x, y in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        assert torch.equal(x, y)
    for p, q in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        assert torch.equal(p["exp_avg"], q["exp_avg"])
        assert torch.equal(p["exp_avg_sq"], q["exp_avg_sq"])


def test_train_state_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    _, tc = configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.create_train_state(tc, network_name=NET)


def test_step_seed_is_the_jax_key_argument():
    assert ttrain.step_seed(3, 0, 0) == 3 * 1_000_003
    assert ttrain.step_seed(3, 2, 5) == (3 * 1_000_003 + 2 * 97_003 + 5)
    assert ttrain.step_seed(10 ** 6, 10 ** 4, 7) < 2 ** 31 - 1
