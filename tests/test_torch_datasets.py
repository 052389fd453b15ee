"""The port's dataset readers and host augmentation against the JAX
package's: OCID and OSD trees written at 60x80 by the JAX package's
tools/make_real_fixtures.py and by the port's, a TableTop tree written with
cv2, every sample key in TEST and TRAIN mode (SYN_CROP and pixel sampling
included), each data/augmentation function under the same RandomState, the
synthetic dataset's host-augmented samples, the registry, and the
trainer's host-augmented route for a few steps on the CPU.

The readers derive paths by replacing "rgb", "png", "image_color" in the
whole path and test for "table" and "OCID"/"OSD" in it, as the reference
does, so the trees are read through paths relative to their root (the
test changes into it): nothing above the root can hold those words.

Tolerance: none, every array is compared exactly (dtype included).
"""

import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.data import augmentation as taug
from unseenobjectclustering_torch.data import datasets as tdatasets
from unseenobjectclustering_torch.data import factory as tfactory
from unseenobjectclustering_torch.data import synthetic as tsyn
from unseenobjectclustering_torch.tools import make_real_fixtures as tfix
from unseenobjectclustering_torch.tools import render_dataset, train_net
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.data import augmentation as jaug
from unseenobjectclustering_tpu.data import datasets as jdatasets
from unseenobjectclustering_tpu.data import factory as jfactory
from unseenobjectclustering_tpu.data import synthetic as jsyn
from unseenobjectclustering_tpu.utils.masks import imwrite_indexed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 60, 80
SCENES = [100, 101, 102, 103]


def _jax_fixtures():
    spec = importlib.util.spec_from_file_location(
        "jax_make_real_fixtures",
        os.path.join(REPO, "tools", "make_real_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cfgs(mode, **train):
    d = {"INPUT": "RGBD", "MODE": mode,
         "TRAIN": dict({"CHROMATIC": True, "ADD_NOISE": True}, **train)}
    return jcfg.Config.from_dict(d), tcfg.Config.from_dict(d)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """<root>/{jax,port}/{OCID,OSD}: the same four 60x80 scenes written by
    each package's fixture writer (OCID binary_compressed, OSD binary)."""
    root = tmp_path_factory.mktemp("fixtures")
    jfix = _jax_fixtures()
    jc, tc = cfgs("TEST")
    jds = jsyn.SyntheticTabletopDataset("test", jc, height=H, width=W,
                                        size=104)
    tds = tsyn.SyntheticTabletopDataset("test", tc, height=H, width=W,
                                        size=104)
    jfix.write_ocid(str(root / "jax" / "OCID"), jds, SCENES)
    jfix.write_osd(str(root / "jax" / "OSD"), jds, SCENES, compressed=False)
    tfix.write_ocid(str(root / "port" / "OCID"), tds, SCENES)
    tfix.write_osd(str(root / "port" / "OSD"), tds, SCENES, compressed=False)
    return root, tds


@pytest.fixture
def small(monkeypatch):
    """Both packages' OCID/OSD readers at 60x80."""
    for cls in (tdatasets.OCIDObject, tdatasets.OSDObject,
                jdatasets.OCIDObject, jdatasets.OSDObject):
        monkeypatch.setattr(cls, "_height", H)
        monkeypatch.setattr(cls, "_width", W)


def assert_same_sample(got, want):
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["ocid_object_test", "osd_object_test"])
@pytest.mark.parametrize("mode", ["TEST", "TRAIN"])
def test_samples_equal_the_jax_readers(trees, small, monkeypatch, writer,
                                       name, mode):
    root, _ = trees
    monkeypatch.chdir(root / writer)
    sub = "OCID" if name.startswith("ocid") else "OSD"
    jc, tc = cfgs(mode)
    jds = jfactory.get_dataset(name, jc, path=sub)
    tds = tfactory.get_dataset(name, tc, path=sub)
    assert len(tds) == len(jds) == len(SCENES)
    for i in range(len(tds)):
        assert_same_sample(tds[i], jds[i])


@pytest.mark.parametrize("name", ["ocid_object_test", "osd_object_test"])
def test_both_writers_write_the_same_trees(trees, small, monkeypatch, name):
    """The port's tree reads as the JAX package's does (the PNG bytes
    differ: other encoders; the arrays and the PCD bytes do not)."""
    root, _ = trees
    sub = "OCID" if name.startswith("ocid") else "OSD"
    _, tc = cfgs("TEST")
    samples = {}
    for writer in ("jax", "port"):
        monkeypatch.chdir(root / writer)
        ds = tfactory.get_dataset(name, tc, path=sub)
        samples[writer] = [ds[i] for i in range(len(ds))]
    for a, b in zip(samples["jax"], samples["port"]):
        assert_same_sample(a, b)
    for dirpath, _, files in os.walk(root / "jax" / sub):
        for f in files:
            if f.endswith(".pcd"):
                other = os.path.join(str(root / "port"),
                                     os.path.relpath(dirpath, root / "jax"),
                                     f)
                with open(os.path.join(dirpath, f), "rb") as x, \
                        open(other, "rb") as y:
                    assert x.read() == y.read()


def test_ocid_conventions(trees, small, monkeypatch):
    """Labels follow OCID's plane ids (1, and 2 on "table" paths, are
    background; objects are renumbered 1..K), BGR and XYZ are the rendered
    scene's bits (NaN -> 0)."""
    root, ds = trees
    monkeypatch.chdir(root / "port")
    _, tc = cfgs("TEST")
    ocid = tfactory.get_dataset("ocid_object_test", tc, path="OCID")
    from unseenobjectclustering_torch.ops.preprocess import compute_xyz_np

    names = [os.path.basename(str(p)) for p in ocid.image_paths]
    assert sum("table" in str(p) for p in ocid.image_paths) == 2
    for i in SCENES:
        s = ocid[names.index(f"result_2026_{i:04d}.png")]
        bgr, depth_mm, gt = ds.get_scene(i)
        np.testing.assert_array_equal(
            s["label"], tdatasets.process_label(gt.astype(np.int32)))
        np.testing.assert_array_equal(
            s["image_color_bgr"], bgr.astype(np.float32) / 255.0)
        xyz = compute_xyz_np(depth_mm.astype(np.float32) / 1000.0, ds.f,
                             ds.f, ds.cx, ds.cy)
        xyz[depth_mm == 0] = 0
        np.testing.assert_array_equal(s["depth"], xyz)
        assert s["filename"].startswith("ARID20/")


def tabletop_tree(root, views=7):
    """data/tabletop/training_set/scene_00000: 60x80 rgb_*.jpeg (cv2),
    depth_*.png (16-bit mm) and segmentation_*.png (indexed, ids 0 and 1
    background, objects 2..)."""
    d = root / "training_set" / "scene_00000"
    d.mkdir(parents=True)
    rng = np.random.RandomState(5)
    for v in range(views):
        seg = np.ones((H, W), np.uint8)
        seg[: H // 3] = 0
        for k in range(2, 5):
            y, x = rng.randint(0, H - 15), rng.randint(0, W - 15)
            seg[y:y + rng.randint(6, 15), x:x + rng.randint(6, 15)] = k
        bgr = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        depth = (800 + 40 * rng.rand(H, W) + 100 * (seg > 1)).astype(
            np.uint16)
        depth[rng.rand(H, W) < 0.05] = 0
        cv2.imwrite(str(d / ("rgb_%05d.jpeg" % v)), bgr)
        cv2.imwrite(str(d / ("depth_%05d.png" % v)), depth)
        imwrite_indexed(str(d / ("segmentation_%05d.png" % v)), seg)


@pytest.mark.parametrize("mode,train", [
    ("TEST", {}), ("TRAIN", {}),
    ("TRAIN", {"SYN_CROP": True, "SYN_CROP_SIZE": 32}),
    ("TRAIN", {"EMBEDDING_SAMPLING": True, "EMBEDDING_SAMPLING_NUM": 50}),
    ("TRAIN", {"SYN_CROP": True, "SYN_CROP_SIZE": 32,
               "EMBEDDING_SAMPLING": True, "EMBEDDING_SAMPLING_NUM": 50})])
def test_tabletop_samples_equal_jax(tmp_path_factory, monkeypatch, mode,
                                    train):
    root = tmp_path_factory.mktemp("tod")
    tabletop_tree(root)
    monkeypatch.chdir(root)
    jc, tc = cfgs(mode, **train)
    jds = jfactory.get_dataset("tabletop_object_train", jc, path=".")
    tds = tfactory.get_dataset("tabletop_object_train", tc, path=".")
    assert len(tds) == len(jds) == (5 if train.get("SYN_CROP") else 7)
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        tds.set_epoch(epoch)
        for i in range(len(tds)):
            assert_same_sample(tds[i], jds[i])


@pytest.mark.parametrize("split,mode,train", [
    ("train", "TRAIN", {}),
    ("train", "TRAIN", {"DEPTH_ARTIFACTS": True, "EMBEDDING_SAMPLING": True,
                        "EMBEDDING_SAMPLING_NUM": 80}),
    ("train", "TRAIN", {"SYN_CROP": True, "SYN_CROP_SIZE": 32}),
    ("test", "TEST", {})])
def test_synthetic_host_samples_equal_jax(split, mode, train):
    jc, tc = cfgs(mode, **train)
    kw = dict(height=48, width=64, size=6)
    jds = jsyn.SyntheticTabletopDataset(split, jc, **kw)
    tds = tsyn.SyntheticTabletopDataset(split, tc, **kw)
    for i in (0, 3):
        assert_same_sample(tds[i], jds[i])


def test_synthetic_test_samples_need_no_opencv(monkeypatch):
    """TEST mode without SYN_CROP runs with numpy only."""
    import sys

    _, tc = cfgs("TEST")
    ds = tsyn.SyntheticTabletopDataset("test", tc, height=48, width=64,
                                       size=2)
    want = ds[1]
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert_same_sample(ds[1], want)
    _, tc = cfgs("TRAIN")
    train = tsyn.SyntheticTabletopDataset("train", tc, height=48, width=64,
                                          size=2)
    with pytest.raises(ImportError):
        train[0]


def _depth(rng):
    d = (0.6 + 0.5 * rng.rand(H, W)).astype(np.float32)
    d[:, W // 2:] += 0.2  # a depth edge for the stereo shadows
    d[rng.rand(H, W) < 0.1] = 0
    return d


def _mask(rng):
    m = np.zeros((H, W), np.uint8)
    m[15:40, 20:55] = 1
    m[rng.rand(H, W) < 0.05] = 0
    return m


AUGMENTATIONS = {
    "chromatic_transform": lambda m, r, rng: m.chromatic_transform(
        rng.randint(0, 256, (H, W, 3)).astype(np.uint8), rng=r),
    "chromatic_transform_label": lambda m, r, rng: m.chromatic_transform(
        rng.randint(0, 256, (H, W, 3)).astype(np.uint8),
        label=_mask(rng), rng=r),
    "add_noise": lambda m, r, rng: m.add_noise(
        rng.randint(0, 256, (H, W, 3)).astype(np.uint8), rng=r),
    "add_noise_to_depth": lambda m, r, rng: m.add_noise_to_depth(
        _depth(rng), m.DEFAULT_NOISE_PARAMS, r),
    "add_noise_to_xyz": lambda m, r, rng: m.add_noise_to_xyz(
        rng.rand(H, W, 3).astype(np.float32), _depth(rng),
        m.DEFAULT_NOISE_PARAMS, r),
    "dropout_random_ellipses": lambda m, r, rng: m.dropout_random_ellipses(
        _depth(rng), m.DEFAULT_NOISE_PARAMS, r),
    "add_realsense_artifacts": lambda m, r, rng: m.add_realsense_artifacts(
        _depth(rng), r),
    "morph_open_close": lambda m, r, rng: m.morph_open_close(
        _mask(rng), jcfg.Config.default().TRAIN, r),
    "random_translation": lambda m, r, rng: m.random_translation(
        _mask(rng), jcfg.Config.default().TRAIN, r),
    "random_rotation": lambda m, r, rng: m.random_rotation(
        _mask(rng), jcfg.Config.default().TRAIN, r),
    "random_ellipses_add": lambda m, r, rng: m.random_ellipses(
        _mask(rng), jcfg.Config.default().TRAIN, r, add=True),
    "random_ellipses_drop": lambda m, r, rng: m.random_ellipses(
        _mask(rng), jcfg.Config.default().TRAIN, r, add=False),
    "random_cut": lambda m, r, rng: m.random_cut(
        _mask(rng), jcfg.Config.default().TRAIN, r),
    "random_add": lambda m, r, rng: m.random_add(
        _mask(rng), jcfg.Config.default().TRAIN, r),
    "perturb_mask": lambda m, r, rng: m.perturb_mask(
        _mask(rng), jcfg.Config.default().TRAIN, r),
}


@pytest.mark.parametrize("name", list(AUGMENTATIONS))
def test_augmentations_equal_jax(name):
    """Each function under the same RandomState (ten seeds, so both
    branches of the random choices run), and the state left behind."""
    assert taug.DEFAULT_NOISE_PARAMS == jaug.DEFAULT_NOISE_PARAMS
    fn = AUGMENTATIONS[name]
    for seed in range(10):
        rt, rj = np.random.RandomState(seed), np.random.RandomState(seed)
        got = fn(taug, rt, np.random.RandomState(100 + seed))
        want = fn(jaug, rj, np.random.RandomState(100 + seed))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        assert rt.randint(2 ** 31) == rj.randint(2 ** 31)


def test_augmentations_need_opencv(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        taug.chromatic_transform(np.zeros((4, 4, 3), np.uint8),
                                 rng=np.random.RandomState(0))
    depth = np.ones((8, 8), np.float32)
    assert taug.add_noise_to_depth(
        depth, taug.DEFAULT_NOISE_PARAMS, np.random.RandomState(0)).shape \
        == depth.shape


def test_registry_knows_every_jax_name(tmp_path):
    assert sorted(tfactory.DATASETS) == sorted(jfactory.DATASETS)
    _, tc = cfgs("TEST")
    for name in tfactory.DATASETS:
        ds = tfactory.get_dataset(name, tc, path=str(tmp_path / "none"))
        assert ds.name == name


def test_train_net_host_route_takes_steps_on_the_cpu(tmp_path):
    """tools.train_net without --device-augment: the loader serves
    host-augmented synthetic_tabletop_train samples (chromatic, noise,
    depth noise, pixel sampling) and the trainer steps on them."""
    yml = tmp_path / "small.yml"
    yml.write_text("""EXP_DIR: tabletop_object
INPUT: RGBD
MODE: TRAIN
TRAIN:
  IMS_PER_BATCH: 2
  NUM_UNITS: 8
  SNAPSHOT_EPOCHS: 1
  CHROMATIC: True
  ADD_NOISE: True
  EMBEDDING_SAMPLING: True
  EMBEDDING_SAMPLING_NUM: 100
  SYN_HEIGHT: 48
  SYN_WIDTH: 64
  SYNNUM: 4
""")
    cache = tmp_path / "cache"
    render_dataset.main(["--cache-dir", str(cache), "--height", "48",
                         "--width", "64", "--num", "4"])
    seen = []
    state = train_net.main(
        ["--cfg", str(yml), "--network", "seg_resnet18_8s_embedding",
         "--render-cache", str(cache), "--device", "cpu", "--workers", "2",
         "--keep", "1", "--epochs", "2", "--output-dir", str(tmp_path / "o")],
        callback=lambda epoch, i, m: seen.append(float(m["loss"])))
    assert state.step == 4 and len(seen) == 4
    assert all(np.isfinite(seen))
    assert os.path.exists(tmp_path / "o" / "2")
