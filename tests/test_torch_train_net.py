"""The port's trainer CLI (python -m unseenobjectclustering_torch.tools.
train_net) on the CPU: exact resume, snapshots and their addressing, the
streaming and resident paths, serving from a snapshot, and the ImageNet
partial load against the JAX package's.

A 48x64 render cache of 4 scenes, seg_resnet18_8s_embedding with 8 units,
batch 2 (2 steps an epoch), --device cpu.

Tolerances: resumed and straight runs are bitwise equal; the ImageNet
partial load is exactly the JAX package's convert_imagenet_checkpoint
followed by state_dict_from_flax.
"""

import os

import jax
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.engine import builder as tbuilder
from unseenobjectclustering_torch.tools import render_dataset, train_net
from unseenobjectclustering_torch.utils import checkpoint as tck
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.engine import builder as jbuilder
from unseenobjectclustering_tpu.utils import checkpoint as jck

torch.set_num_threads(1)

NET, ARCH = "seg_resnet18_8s_embedding", "resnet18_8s"
H, W = 48, 64
YML = f"""EXP_DIR: tabletop_object
INPUT: RGBD
MODE: TRAIN
TRAIN:
  LEARNING_RATE: 0.001
  WEIGHT_DECAY: 0.0005
  MILESTONES: [2]
  IMS_PER_BATCH: 2
  NUM_UNITS: 8
  SNAPSHOT_EPOCHS: 1
  CHROMATIC: True
  ADD_NOISE: True
  EMBEDDING_SAMPLING: True
  EMBEDDING_SAMPLING_NUM: 100
  EMBEDDING_LAMBDA_INTRA: 10.0
  EMBEDDING_LAMBDA_INTER: 10.0
  SYN_HEIGHT: {H}
  SYN_WIDTH: {W}
  SYNNUM: 4
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_net")
    yml = root / "small.yml"
    yml.write_text(YML)
    cache = root / "cache"
    render_dataset.main(["--cache-dir", str(cache), "--height", str(H),
                         "--width", str(W), "--num", "4"])
    return root, str(yml), str(cache)


def run(setup, out, *extra, solver="sgd"):
    root, yml, cache = setup
    return train_net.main(
        ["--cfg", yml, "--network", NET, "--solver", solver,
         "--render-cache", cache, "--device", "cpu", "--workers", "0",
         "--keep", "1", "--output-dir", str(root / out)] + list(extra))


def assert_same_state(a, b):
    assert a.step == b.step
    for (k, x), y in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    for i, per in sa["state"].items():
        for name, v in per.items():
            assert torch.equal(v, sb["state"][i][name]), (i, name)


@pytest.mark.parametrize("solver", ["sgd", "adam"])
def test_resume_is_exact(setup, solver):
    """2 epochs + --resume = 3 epochs straight, bitwise: parameters,
    BatchNorm buffers, optimizer moments and step (SGD crosses its
    milestone at epoch 2)."""
    straight = run(setup, f"straight_{solver}", "--epochs", "3",
                   "--device-resident", solver=solver)
    run(setup, f"resumed_{solver}", "--epochs", "2", "--device-resident",
        solver=solver)
    root = setup[0]
    resumed = run(setup, f"resumed_{solver}", "--epochs", "3",
                  "--device-resident", "--resume",
                  str(root / f"resumed_{solver}"), solver=solver)
    assert straight.step == 6
    assert_same_state(straight, resumed)


def test_streaming_equals_resident(setup):
    """The streaming --device-augment path and the resident path see the
    same scenes in the same order with the same draws."""
    a = run(setup, "resident", "--epochs", "2", "--device-resident")
    b = run(setup, "streaming", "--epochs", "2", "--device-augment")
    assert_same_state(a, b)


def test_snapshots_keep_and_addressing(setup):
    root = setup[0]
    state = run(setup, "kept", "--epochs", "3", "--device-resident",
                "--keep", "2")
    out = root / "kept"
    assert sorted(os.listdir(out)) == ["2", "3"]
    payload, step = tck.restore_checkpoint(str(out))
    assert step == 3 and payload["step"] == state.step
    payload2, step2 = tck.restore_checkpoint(str(out / "2"))
    assert step2 == 2 and payload2["step"] == 4
    assert tck.resolve_step_dir(str(out / "2")) == (str(out), 2)
    assert tck.resolve_step_dir(str(out)) == (str(out), None)
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(root / "nothing"))
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(out), step=1)


def test_segmentor_from_a_snapshot(setup):
    root, yml, _ = setup
    state = run(setup, "served", "--epochs", "1", "--device-resident")
    cfg = tcfg.Config.from_yaml(yml).replace(MODE="TEST")
    for path in (root / "served", root / "served" / "1"):
        seg = tbuilder.build_segmentor(cfg, NET, pretrained=str(path),
                                       device="cpu")
        for (k, x), y in zip(state.model.state_dict().items(),
                             seg.model.state_dict().values()):
            assert torch.equal(x, y), k
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randn(1, H, W, 3).astype(np.float32))
    xyz = torch.from_numpy(rng.rand(1, H, W, 3).astype(np.float32))
    out = seg.segment(img, xyz)
    assert out.labels.shape == (1, H, W)
    # a snapshot also seeds a new run (--pretrained: weights only)
    again = run(setup, "seeded", "--epochs", "1", "--device-resident",
                "--pretrained", str(root / "served"))
    assert again.step == 2


def test_train_net_needs_a_card_or_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    root, yml, cache = setup
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_net.main(["--cfg", yml, "--network", NET, "--render-cache",
                        cache, "--device-resident", "--output-dir",
                        str(root / "nocard")])
    # the host-augmented route as well
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_net.main(["--cfg", yml, "--network", NET, "--epochs", "1",
                        "--output-dir", str(root / "nocard_host")])


def torchvision_state_dict(seed=0):
    """A raw torchvision-layout resnet18 state_dict: the trunk of the
    port's tower plus a 1000-way Linear `fc`, random values."""
    from unseenobjectclustering_torch.models.resnet import ResNetFCN

    torch.manual_seed(seed)
    trunk = ResNetFCN("basic", (2, 2, 2, 2), num_classes=8).state_dict()
    out = {k: torch.randn(v.shape) if v.is_floating_point() else v
           for k, v in trunk.items() if not k.startswith("fc.")}
    out["fc.weight"] = torch.randn(1000, 512)
    out["fc.bias"] = torch.randn(1000)
    return out


@pytest.mark.parametrize("fusion", ["add", "early"])
def test_imagenet_partial_load_matches_jax(tmp_path, fusion):
    """Every tower takes the trunk by name and shape; the 1x1 scoring conv
    and (early fusion) the 6-channel conv1 keep their init values -- the
    JAX package's convert_imagenet_checkpoint, carried over."""
    d = {"INPUT": "RGBD", "TRAIN": {"NUM_UNITS": 8, "FUSION_TYPE": fusion}}
    jc, tc = jcfg.Config.from_dict(d), tcfg.Config.from_dict(d)
    tv = torchvision_state_dict()
    expected = jbuilder.init_variables(jc, NET, height=32, width=32)
    want = tck.state_dict_from_flax(
        jck.convert_imagenet_checkpoint(
            {k: v.numpy() for k, v in tv.items()},
            jax.tree_util.tree_map(np.asarray, expected)), ARCH)
    init = tck.state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, expected), ARCH)
    got = tck.convert_imagenet_checkpoint(tv, init)
    assert got.keys() == init.keys()
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=0, atol=0, msg=k)
    prefix = "fcn.resnet18_8s."
    assert torch.equal(got[prefix + "layer2.0.conv1.weight"],
                       tv["layer2.0.conv1.weight"])
    assert torch.equal(got[prefix + "fc.weight"], init[prefix + "fc.weight"])
    if fusion == "early":
        assert torch.equal(got[prefix + "conv1.weight"],
                           init[prefix + "conv1.weight"])
    # through a .pth file and the builder, the same
    path = tmp_path / "resnet18.pth"
    torch.save(tv, path)
    loaded = tck.load_state_dict_file(path, init)
    for k in init:
        assert torch.equal(loaded[k], got[k]), k
    with pytest.raises(KeyError, match="no ImageNet"):
        tck.convert_imagenet_checkpoint({"conv1.weight": torch.zeros(1)},
                                        init)
