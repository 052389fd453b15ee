"""The port's data layer against the JAX package's: the procedural
renderer's scenes (bit-equal), its numpy replica of cv2's bilinear resize,
the render cache and its manifest, the raw and host-augmented samples, the
resident loader, the threaded loader's batch order and the dataset
registry.

Tolerances: none -- every comparison here is exact.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.data import factory as tfactory
from unseenobjectclustering_torch.data import loader as tloader
from unseenobjectclustering_torch.data import resident as tresident
from unseenobjectclustering_torch.data import synthetic as tsyn
from unseenobjectclustering_torch.data.datasets import process_label
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.data import datasets as jdatasets
from unseenobjectclustering_tpu.data import loader as jloader
from unseenobjectclustering_tpu.data import resident as jresident
from unseenobjectclustering_tpu.data import synthetic as jsyn

H, W = 48, 64
CFG = {"INPUT": "RGBD", "MODE": "TRAIN"}


def datasets(split="train", **kw):
    kw = dict(dict(height=H, width=W, size=8), **kw)
    return (jsyn.SyntheticTabletopDataset(split, jcfg.Config.from_dict(CFG),
                                          **kw),
            tsyn.SyntheticTabletopDataset(split, tcfg.Config.from_dict(CFG),
                                          **kw))


@pytest.mark.parametrize("split,indices", [("train", (0, 1, 5)),
                                           ("test", (0, 3))])
def test_scenes_are_bit_equal_to_the_jax_renderer(split, indices):
    j, t = datasets(split)
    for i in indices:
        for a, b in zip(j.get_scene(i), t.get_scene(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def test_scene_with_no_objects_is_bit_equal():
    j, t = datasets(min_objects=0, max_objects=0)
    for a, b in zip(j.get_scene(2), t.get_scene(2)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("src_hw,out_hw", [((17, 22), (480, 640)),
                                           ((3, 4), (48, 64)),
                                           ((7, 9), (200, 260)),
                                           ((4, 5), (3, 4))])
def test_linear_resize_is_bit_equal_to_cv2(src_hw, out_hw):
    src = np.random.RandomState(sum(src_hw)).rand(*src_hw)
    want = cv2.resize(src, out_hw[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_array_equal(tsyn._resize_linear_cv2(src, out_hw), want)


def test_render_cache_round_trip_and_manifest(tmp_path):
    _, t = datasets(cache_dir=str(tmp_path))
    first = t.get_scene(1)
    path = t._scene_path(1)
    assert os.path.exists(path)
    _, again = datasets(cache_dir=str(tmp_path))
    for a, b in zip(first, again.get_scene(1)):
        np.testing.assert_array_equal(a, b)
    # the JAX package reads the port's cache (same layout and manifest)
    j, _ = datasets(cache_dir=str(tmp_path))
    assert j._scene_path(1) == path
    for a, b in zip(first, j.get_scene(1)):
        np.testing.assert_array_equal(a, b)
    # a cache rendered under other scene parameters is refused
    _, other = datasets(cache_dir=str(tmp_path), max_objects=3)
    with pytest.raises(ValueError, match="render cache"):
        other.get_scene(0)


def test_raw_samples_and_host_path(tmp_path):
    j, t = datasets()
    # the host path: the JAX package's augmented sample, bit for bit
    want, got = j[0], t[0]
    assert got.keys() == want.keys()
    for key in ("image_color", "depth", "label"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    t.raw = True
    sample = t[3]
    bgr, depth, label = t.get_scene(3)
    np.testing.assert_array_equal(sample["bgr"], bgr)
    np.testing.assert_array_equal(sample["depth_mm"], depth)
    np.testing.assert_array_equal(sample["label_raw"], label)
    assert sample["depth_mm"].dtype == np.uint16


def render(tmp_path, n):
    _, t = datasets(cache_dir=str(tmp_path))
    for i in range(n):
        t.get_scene(i)
    return os.path.dirname(t._scene_path(0))


def test_resident_round_trip_matches_jax(tmp_path):
    scene_dir = render(tmp_path, 3)
    got = tresident.load_resident_scenes(scene_dir, limit=3,
                                       device="cpu")
    want = jresident.load_resident_scenes(scene_dir, limit=3)
    assert [g.dtype for g in got] == [torch.uint8, torch.int32, torch.uint8]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    all_ = tresident.load_resident_scenes(scene_dir, device="cpu")
    assert all_[0].shape == (3, H, W, 3)


def test_resident_partial_cache_errors(tmp_path):
    scene_dir = render(tmp_path, 3)
    with pytest.raises(FileNotFoundError, match="only 3 of the 5"):
        tresident.load_resident_scenes(scene_dir, limit=5, device="cpu")
    os.remove(os.path.join(scene_dir, "000001.npz"))
    with pytest.raises(FileNotFoundError, match="not contiguous"):
        tresident.load_resident_scenes(scene_dir, device="cpu")
    with pytest.raises(FileNotFoundError, match="no cached scenes"):
        tresident.load_resident_scenes(str(tmp_path / "empty"),
                                       device="cpu")


def test_resident_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    scene_dir = render(tmp_path, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tresident.load_resident_scenes(scene_dir)


def test_loader_batches_match_jax():
    class Items:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"x": np.full((2,), i, np.int32), "name": f"s{i}"}

    for workers in (0, 2):
        a = tloader.DataLoader(Items(), 3, num_workers=workers, seed=5)
        b = jloader.DataLoader(Items(), 3, num_workers=workers, seed=5)
        a.set_epoch(2)
        b.set_epoch(2)
        got, want = list(a), list(b)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["x"], w["x"])
            assert g["name"] == w["name"]


def test_process_label_matches_jax():
    lab = np.random.RandomState(0).choice([0, 3, 7, 9], (6, 7))
    np.testing.assert_array_equal(process_label(lab),
                                  jdatasets.process_label(lab))


def test_registry(tmp_path):
    cfg = tcfg.Config.from_dict(CFG)
    ds = tfactory.get_dataset("synthetic_tabletop_train", cfg)
    assert ds.name == "synthetic_tabletop_train"
    assert len(tfactory.get_dataset("synthetic_tabletop_test", cfg)) <= 200
    for name in ("tabletop_object_train", "ocid_object_test",
                 "osd_object_test"):
        ds = tfactory.get_dataset(name, cfg, path=str(tmp_path))
        assert ds.name == name and len(ds) == 0
    with pytest.raises(KeyError):
        tfactory.get_dataset("nope", cfg)
