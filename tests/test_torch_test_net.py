"""The port's dataset CLI (python -m unseenobjectclustering_torch.tools.
test_net) on the CPU against the JAX package's evaluate_dataset.

A 60x80 OCID tree of four rendered scenes (a floor and a table sequence,
binary_compressed PCDs) written by the port's tools/make_real_fixtures;
the ResNet-18 networks, .pth files and cfg files of
tests/test_torch_serving.py (flax init carried by export_torch_state_dict,
``first_index`` pinned on both Segmentors).  The JAX side reads the tree
with its own reader and clusters through its plain XLA reference
(USE_PALLAS off); the port reads it through its PNG/PCD readers and runs
its kernel wrappers' plain versions on the CPU.

Tolerance: none -- the metric dicts are equal, and the .mat files hold the
labels.
"""

import os

import numpy as np
import pytest
import scipy.io
import torch

from test_torch_serving import NET, files, pinned  # noqa: F401 (fixture)
from unseenobjectclustering_torch.data import datasets as tdatasets
from unseenobjectclustering_torch.engine import builder as tbuilder
from unseenobjectclustering_torch.tools import make_real_fixtures, test_net
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.data import datasets as jdatasets
from unseenobjectclustering_tpu.data import factory as jfactory
from unseenobjectclustering_tpu.engine import builder as jbuilder
from unseenobjectclustering_tpu.engine import evaluate as jevaluate

torch.set_num_threads(1)

H, W = 60, 80


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    make_real_fixtures.main(["--root", str(root), "--num", "4", "--height",
                             str(H), "--width", str(W), "--dataset", "ocid"])
    return root


@pytest.fixture
def small(monkeypatch, tree):
    """Both packages' OCID readers at 60x80, reading the tree through
    paths relative to its root (the reader replaces "rgb" and "png" in the
    whole path and looks for "table" in it)."""
    for cls in (tdatasets.OCIDObject, jdatasets.OCIDObject):
        monkeypatch.setattr(cls, "_height", H)
        monkeypatch.setattr(cls, "_width", W)
    monkeypatch.chdir(tree)


def jax_metrics(files):
    cfg = jcfg.Config.from_yaml(files.jax_cfg).replace(MODE="TEST")
    seg = pinned(jbuilder.build_segmentor)(
        cfg, NET, pretrained=files.main, pretrained_crop=files.crop,
        depth_threshold=0.5, height=H, width=W)
    ds = jfactory.get_dataset("ocid_object_test", cfg, path="OCID")
    return jevaluate.evaluate_dataset(ds, seg, output_dir=None,
                                      save_results=False, verbose=False)


def test_test_net_matches_jax_evaluate_dataset(files, small, tmp_path,
                                               monkeypatch):
    built = []
    original = tbuilder.build_segmentor

    def build(*args, **kwargs):
        built.append(pinned(original)(*args, **kwargs))
        return built[-1]

    monkeypatch.setattr(test_net.builder, "build_segmentor", build)
    out = tmp_path / "results"
    stage1, refined = test_net.main(
        ["--dataset", "ocid_object_test", "--dataset_root", "OCID",
         "--cfg", files.port_cfg, "--network", NET,
         "--pretrained", files.main, "--pretrained_crop", files.crop,
         "--device", "cpu", "--output-dir", str(out)])
    want1, want_ref = jax_metrics(files)
    assert stage1 == want1
    assert refined == want_ref
    assert stage1["obj_detected"] > 0 and refined["obj_detected"] > 0
    assert built[0].depth_threshold == 0.5
    mats = sorted(os.listdir(out))
    assert mats == [f"{i:06d}.mat" for i in range(4)]
    m = scipy.io.loadmat(out / mats[0])
    assert m["labels"].shape == (H, W)
    assert str(m["filename"][0]).startswith("ARID20/")


def test_test_net_needs_a_card_unless_cpu(files, small):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_net.main(["--dataset", "ocid_object_test", "--dataset_root",
                       "OCID", "--cfg", files.port_cfg, "--network", NET,
                       "--pretrained", files.main, "--max_images", "1"])


def test_fast_flag_builds_the_bf16_segmentor(files, small, tmp_path,
                                             monkeypatch):
    """--fast: FAST_CLUSTER and bfloat16 convolutions, as the JAX tool;
    the metrics are those of the dataset's frames (no gate against JAX:
    another float type)."""
    seen = []
    original = tbuilder.build_segmentor

    def build(cfg, *args, **kwargs):
        seen.append((cfg, kwargs))
        return original(cfg, *args, **kwargs)

    monkeypatch.setattr(test_net.builder, "build_segmentor", build)
    stage1, _ = test_net.main(
        ["--dataset", "ocid_object_test", "--dataset_root", "OCID",
         "--cfg", files.port_cfg, "--network", NET, "--pretrained",
         files.main, "--device", "cpu", "--fast", "--max_images", "1",
         "--output-dir", str(tmp_path / "fast")])
    cfg, kwargs = seen[0]
    assert kwargs["model_dtype"] == torch.bfloat16
    assert int(cfg.CLUSTER.SEED_SUBSAMPLE) > 1
    assert np.isfinite(stage1["Objects F-measure"])
