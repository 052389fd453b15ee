"""The port's serving and evaluation surface against the JAX package.

One pair of networks (ResNet-18, 8-D embeddings, random BN statistics,
flax init from fixed seeds) is exported with the JAX package's
``export_torch_state_dict`` to reference-layout ``.pth`` files; both
packages build their two-stage Segmentors from those files through their
own ``build_segmentor`` (32x48 frames, 32x32 crops, MAX_INSTANCES 4, 16
seeds, ``first_index`` pinned on both Segmentors' ``_ms_kw`` as
tests/test_torch_stage2.py does, so no random draw decides a label).  The
JAX side clusters through its plain XLA reference (USE_PALLAS off), the
port through its kernel wrappers, which run their plain versions on CPU
tensors.  Tolerance 0 throughout: equal tensors, equal labels, equal metric
dicts.

The clustering settings (KAPPA 30, EPSILON 0.02) and weight seeds are ones
under which stage 1 finds instances on the test scene, so that stage 2 has
crops and the metrics are not an edge case.
"""

import os
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
import yaml

from test_torch_models import randomize_bn
from test_torch_pipeline import scene
from unseenobjectclustering_torch import config as tcfg
from unseenobjectclustering_torch.engine import builder as tbuilder
from unseenobjectclustering_torch.engine import evaluate as tevaluate
from unseenobjectclustering_torch.engine.stream import StreamSegmentor
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_torch.ops.preprocess import compute_xyz_np
from unseenobjectclustering_torch.tools import (demo_artifact, eval_demo_gt,
                                                ros_node, test_images,
                                                test_npy)
from unseenobjectclustering_torch.utils.checkpoint import state_dict_from_flax
from unseenobjectclustering_torch.utils.evaluation import multilabel_metrics
from unseenobjectclustering_tpu import config as jcfg
from unseenobjectclustering_tpu.data.datasets import (
    compute_xyz_np as jax_compute_xyz_np)
from unseenobjectclustering_tpu.engine import builder as jbuilder
from unseenobjectclustering_tpu.engine import evaluate as jevaluate
from unseenobjectclustering_tpu.engine.stream import (
    StreamSegmentor as JStreamSegmentor)
from unseenobjectclustering_tpu.models import get_network as jax_get_network
from unseenobjectclustering_tpu.utils.checkpoint import (
    export_torch_state_dict)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = "seg_resnet18_8s_embedding"
H, W = 32, 48
INTR = (40.0, 40.0, W / 2.0, H / 2.0)
FIRST = 5
OVERRIDES = dict(
    INPUT="RGBD", TRAIN={"NUM_UNITS": 8, "SYN_CROP_SIZE": 32},
    CLUSTER={"NUM_SEEDS": 16, "MAX_INSTANCES": 4, "KAPPA": 30.0,
             "EPSILON": 0.02})
# the boxes of test_torch_pipeline.scene: GT ids 1..3
BOXES = [(4, 5), (14, 24), (20, 8)]


def gt_labels():
    gt = np.zeros((H, W), np.int32)
    for k, (y, x) in enumerate(BOXES):
        gt[y:y + 9, x:x + 12] = k + 1
    return gt


def no_launches():
    return (cuda_seeding.launches, cms.hill_climb_launches,
            cms.connected_components_launches,
            cms.assign_labels_launches) == (0, 0, 0, 0)


def pinned(build):
    """build_segmentor whose Segmentor clusters from a fixed first seed."""
    def wrapper(*args, **kwargs):
        seg = build(*args, **kwargs)
        seg._ms_kw = dict(seg._ms_kw, first_index=FIRST)
        return seg
    return wrapper


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The flax variables, their .pth exports and the two CLI cfg files
    (the JAX one turns USE_PALLAS off)."""
    d = tmp_path_factory.mktemp("weights")
    jc = jcfg.Config.inference_default(**OVERRIDES)
    model = jax_get_network(NET, jc)
    zeros = jnp.zeros((1, H, W, 3), jnp.float32)
    out = types.SimpleNamespace(dir=d)
    for name, key in (("main", 0), ("crop", 10)):
        variables = randomize_bn(model.init(jax.random.PRNGKey(key), zeros,
                                            zeros, train=False), seed=key)
        state = {k: torch.from_numpy(np.array(v, order="C"))
                 for k, v in export_torch_state_dict(
                     variables, "resnet18_8s").items()}
        path = str(d / f"{name}.pth")
        torch.save(state, path)
        setattr(out, name, path)
        setattr(out, name + "_variables", variables)
        setattr(out, name + "_state", state)
    for name, extra in (("port_cfg", {}), ("jax_cfg", {"USE_PALLAS": False})):
        tree = {"INPUT": "RGBD", "TRAIN": dict(OVERRIDES["TRAIN"],
                                               EMBEDDING_METRIC="cosine"),
                "CLUSTER": dict(OVERRIDES["CLUSTER"], **extra)}
        path = str(d / f"{name}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(tree, f)
        setattr(out, name, path)
    return out


def port_cfg():
    return tcfg.Config.inference_default(**OVERRIDES)


def jax_cfg():
    return jcfg.Config.inference_default(**OVERRIDES).replace(
        **{"CLUSTER.USE_PALLAS": False})


@pytest.fixture(scope="module")
def segmentors(files):
    """(JAX Segmentor, port Segmentor), both built from the .pth files."""
    jseg = pinned(jbuilder.build_segmentor)(
        jax_cfg(), NET, pretrained=files.main, pretrained_crop=files.crop,
        height=H, width=W)
    tseg = pinned(tbuilder.build_segmentor)(
        port_cfg(), NET, pretrained=files.main, pretrained_crop=files.crop,
        device="cpu")
    return jseg, tseg


def host_frame(seed=0, means=None):
    """The scene preprocessed on the host as the JAX CLIs do: [1,H,W,3]
    normalized image and XYZ."""
    bgr, depth = scene(seed, h=H, w=W)
    means = port_cfg().pixel_means if means is None else means
    image = (bgr.astype(np.float32) / 255.0 - means / 255.0)[None]
    return image, jax_compute_xyz_np(depth, *INTR)[None]


# -- builder -----------------------------------------------------------------

@pytest.mark.parametrize("wrapping", ["raw", "model", "module",
                                      "model+module"])
def test_build_segmentor_loads_a_jax_exported_pth(files, tmp_path,
                                                  wrapping):
    """Both networks load into exactly the tensors of state_dict_from_flax,
    however the file is wrapped ({'model': ...}, DataParallel 'module.')."""
    paths = {}
    for name in ("main", "crop"):
        state = getattr(files, name + "_state")
        if "module" in wrapping:
            state = {"module." + k: v for k, v in state.items()}
        if "model" in wrapping:
            state = {"model": state, "epoch": 3}
        paths[name] = str(tmp_path / f"{name}.pth")
        torch.save(state, paths[name])
    seg = tbuilder.build_segmentor(port_cfg(), NET, pretrained=paths["main"],
                                   pretrained_crop=paths["crop"],
                                   device="cpu")
    for model, name in ((seg.model, "main"), (seg.model_crop, "crop")):
        want = state_dict_from_flax(getattr(files, name + "_variables"),
                                    "resnet18_8s")
        got = model.state_dict()
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert seg.device == torch.device("cpu")


def test_build_segmentor_without_crop_checkpoint_has_no_stage2(files):
    seg = tbuilder.build_segmentor(port_cfg(), NET, pretrained=files.main,
                                   device="cpu")
    assert seg.model_crop is None
    res = seg.segment(*host_frame(), refine=True)
    assert res.labels_refined is None


def test_checkpoint_missing_key_raises(files, tmp_path):
    state = dict(files.main_state)
    del state["fcn.resnet18_8s.layer2.0.conv1.weight"]
    torch.save(state, tmp_path / "m.pth")
    with pytest.raises(KeyError, match="missing 1 expected"):
        tbuilder.load_network_state(port_cfg(), NET, str(tmp_path / "m.pth"))


def test_checkpoint_shape_mismatch_keeps_init(files, tmp_path):
    """A wrong-shaped tensor warns and keeps the init value; keys of other
    modules are ignored."""
    state = dict(files.main_state)
    key = "fcn.resnet18_8s.fc.weight"
    state[key] = torch.zeros(3, 2, 1, 1)
    state["loss.center"] = torch.ones(4)
    torch.save(state, tmp_path / "m.pth")
    with pytest.warns(UserWarning, match="shape mismatch at " + key):
        got = tbuilder.load_network_state(port_cfg(), NET,
                                          str(tmp_path / "m.pth"))
    init = tbuilder.init_state_dict(port_cfg(), NET)
    assert torch.equal(got[key], init[key])
    other = "fcn.resnet18_8s.layer1.0.conv1.weight"
    assert torch.equal(got[other], files.main_state[other])
    assert "loss.center" not in got


def test_checkpoint_directory_raises(tmp_path):
    """A directory is read as the trainer's snapshot directory; one that
    holds no committed snapshot raises (loading a snapshot:
    tests/test_torch_train_net.py)."""
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        tbuilder.build_segmentor(port_cfg(), NET, pretrained=str(tmp_path),
                                 device="cpu")


def test_init_state_dict_is_seeded_and_leaves_the_rng_alone():
    torch.manual_seed(123)
    before = torch.rand(3)
    torch.manual_seed(123)
    a = tbuilder.init_state_dict(port_cfg(), NET, seed=3)
    assert torch.equal(torch.rand(3), before)
    b = tbuilder.init_state_dict(port_cfg(), NET, seed=3)
    c = tbuilder.init_state_dict(port_cfg(), NET, seed=4)
    key = "fcn.resnet18_8s.layer1.0.conv1.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])


def test_build_segmentor_without_device_needs_a_card(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    for device in (None, "cuda:0"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbuilder.build_segmentor(port_cfg(), NET, pretrained=files.main,
                                     device=device)


def test_get_output_dir_matches_jax(tmp_path):
    """<repo>/output/<EXP_DIR>/<dataset>, anchored at the repository root
    (or the given root), as in the JAX package."""
    for root in (None, str(tmp_path)):
        got = tcfg.get_output_dir(port_cfg(), "ocid_object_test", root)
        assert got == jcfg.get_output_dir(jax_cfg(), "ocid_object_test",
                                          root)
    assert tcfg.get_output_dir(port_cfg(), "x") == os.path.join(
        REPO, "output", "default", "x")


# -- evaluate_dataset ---------------------------------------------------------

class StubDataset:
    def __init__(self, n=3):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(i)
        label = np.zeros((H, W), np.int32)
        label[4:12, 4:12] = 1
        label[16:28, 20:40] = 2
        return {"image_color": rng.rand(H, W, 3).astype(np.float32),
                "depth": rng.rand(H, W, 3).astype(np.float32),
                "label": label, "filename": f"img{i}"}


class StubSegmentor:
    """Predicts the GT shifted by i pixels (i-th call), refined or not."""

    def __init__(self, dataset, cfg=None):
        self.dataset, self.cfg, self.i = dataset, cfg, 0

    def segment(self, image, xyz=None, refine=True, **kw):
        gt = self.dataset[self.i]["label"]
        pred = np.roll(gt, self.i, axis=1)[None]
        self.i += 1
        return types.SimpleNamespace(
            labels=pred, labels_refined=gt[None] if refine else None)


def read_mats(out):
    names = sorted(n for n in os.listdir(out) if n.endswith(".mat"))
    return names, [scipy.io.loadmat(os.path.join(out, n)) for n in names]


def assert_same_mats(got_dir, want_dir):
    got_names, got = read_mats(got_dir)
    want_names, want = read_mats(want_dir)
    assert got_names == want_names
    for g, w in zip(got, want):
        for key in ("labels", "labels_refined", "filename"):
            np.testing.assert_array_equal(g[key], w[key])
            assert g[key].dtype == w[key].dtype


@pytest.mark.parametrize("refine", [True, False])
def test_evaluate_dataset_with_a_stub_matches_jax(tmp_path, refine):
    """The stub's shifted predictions through both harnesses: the same
    averaged dicts and the same .mat files; without refinement the refined
    metrics are the stage-1 ones."""
    ds = StubDataset()
    got = tevaluate.evaluate_dataset(ds, StubSegmentor(ds),
                                     output_dir=str(tmp_path / "port"),
                                     refine=refine, verbose=False)
    want = jevaluate.evaluate_dataset(ds, StubSegmentor(ds),
                                      output_dir=str(tmp_path / "jax"),
                                      refine=refine, verbose=False)
    assert got == want
    assert 0.0 < got[0]["Objects F-measure"] < 1.0
    assert (got[1] == got[0]) == (not refine)
    assert_same_mats(tmp_path / "port", tmp_path / "jax")


def test_evaluate_dataset_visualize_saves_grids(tmp_path, capsys):
    ds = StubDataset(n=2)
    seg = StubSegmentor(ds, cfg=port_cfg().replace(TEST={"VISUALIZE": True}))
    out = tmp_path / "viz"
    tevaluate.evaluate_dataset(ds, seg, output_dir=str(out), refine=False)
    names = sorted(os.listdir(out))
    assert names == ["000000.mat", "000000_vis.png", "000001.mat",
                     "000001_vis.png"]
    printed = capsys.readouterr().out
    assert "2 images" in printed and "Refined" in printed


@pytest.mark.parametrize("name", ["ocid_object_test", "osd_object_test",
                                  "tabletop_object_test"])
def test_depth_threshold_for_matches_jax(name):
    assert (tevaluate.depth_threshold_for(name)
            == jevaluate.depth_threshold_for(name))


def test_average_metrics_matches_jax():
    rows = [{"a": 1.0, "b": 0.25}, {"a": 0.0, "b": 1.0}, {"a": 0.5, "b": 0}]
    assert tevaluate.average_metrics(rows) == jevaluate.average_metrics(rows)
    assert tevaluate.average_metrics([]) == {}


def test_evaluate_dataset_matches_jax_on_real_segmentors(segmentors,
                                                         tmp_path):
    """Both two-stage Segmentors on the same .pth weights over two scenes:
    equal labels in the .mat files, equal metric dicts."""
    jseg, tseg = segmentors
    samples = []
    for seed in range(2):
        image, xyz = host_frame(seed)
        samples.append({"image_color": image[0], "depth": xyz[0],
                        "label": gt_labels(), "filename": f"scene{seed}"})
    got = tevaluate.evaluate_dataset(samples, tseg,
                                     output_dir=str(tmp_path / "port"),
                                     verbose=False)
    want = jevaluate.evaluate_dataset(samples, jseg,
                                      output_dir=str(tmp_path / "jax"),
                                      verbose=False)
    assert_same_mats(tmp_path / "port", tmp_path / "jax")
    assert got == want
    _, mats = read_mats(tmp_path / "port")
    assert all(len(np.unique(m["labels_refined"])) > 1 for m in mats)
    assert 0.0 < got[1]["Objects F-measure"] < 1.0
    assert no_launches()


# -- StreamSegmentor ----------------------------------------------------------

def test_stream_process_latest_matches_jax(segmentors, monkeypatch):
    """A frame through submit + process_latest: the port preprocesses on
    the Segmentor's device into the bits of JAX's host path, and the labels
    equal JAX's StreamSegmentor's.  Idle, it returns None."""
    jseg, tseg = segmentors
    bgr, depth = scene(1, h=H, w=W)
    seen = []
    segment = tseg.segment

    def spy(image, xyz, **kw):
        seen.append((image, xyz))
        return segment(image, xyz, **kw)

    monkeypatch.setattr(tseg, "segment", spy)
    results = []
    for stream in (StreamSegmentor(port_cfg(), tseg),
                   JStreamSegmentor(jax_cfg(), jseg)):
        assert stream.process_latest() is None
        stream.submit(bgr, depth, INTR, stamp="t0")
        results.append(stream.process_latest())
        assert stream.process_latest() is None
    got, want = results
    (image, xyz), = seen
    want_image, want_xyz = host_frame(1)
    assert np.array_equal(image.numpy(), want_image)
    assert np.array_equal(xyz.numpy(), want_xyz)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.labels_refined, want.labels_refined)
    assert len(np.unique(got.labels_refined)) > 1
    assert got.stamp == "t0" and got.bgr is bgr and got.latency_s > 0


def test_stream_keeps_only_the_newest_frame(segmentors):
    _, tseg = segmentors
    stream = StreamSegmentor(port_cfg(), tseg)
    (bgr0, d0), (bgr1, d1) = scene(0, h=H, w=W), scene(2, h=H, w=W)
    stream.submit(bgr0, d0, INTR, stamp="old")
    stream.submit(bgr1, d1, INTR, stamp="new")
    assert stream.pending
    res = stream.process_latest(refine=False)
    assert res.stamp == "new" and res.bgr is bgr1
    assert res.labels_refined is None
    assert not stream.pending and stream.process_latest() is None


def test_stream_run_forever_serves_until_stopped(segmentors):
    """A producer thread submits frames while run_forever serves them; the
    loop returns once the producer is done and the buffer is empty."""
    _, tseg = segmentors
    stream = StreamSegmentor(port_cfg(), tseg)
    done = threading.Event()
    served = []

    def produce():
        for i in range(4):
            bgr, depth = scene(i, h=H, w=W)
            stream.submit(bgr, depth, INTR, stamp=i)
        done.set()

    def serve():
        stream.run_forever(served.append, refine=False,
                           should_stop=lambda: done.is_set()
                           and not stream.pending)

    server = threading.Thread(target=serve)
    server.start()
    produce()
    server.join(timeout=120)
    assert not server.is_alive()
    assert 1 <= len(served) <= 4
    assert served[-1].stamp == 3
    assert [r.stamp for r in served] == sorted(r.stamp for r in served)


# -- entry points -------------------------------------------------------------

def model_args(files, cfg_file, crop=True):
    args = ["--cfg", cfg_file, "--network", NET, "--pretrained", files.main]
    return args + (["--pretrained_crop", files.crop] if crop else [])


def test_test_npy_cli_matches_the_jax_cli(files, tmp_path, monkeypatch):
    """tools.test_npy on a plain (uint16 mm) and a debug_info (meters, 3x3
    intrinsics) dump against the JAX package's tools/test_npy.py on the
    same .pth files: equal -label.npy files."""
    imgdir = tmp_path / "in"
    imgdir.mkdir()
    bgr, depth = scene(0, h=H, w=W)
    np.save(imgdir / "a_plain.npy",
            {"rgb": bgr, "depth": np.round(depth * 1000).astype(np.uint16)})
    k = np.array([[INTR[0], 0, INTR[2]], [0, INTR[1], INTR[3]], [0, 0, 1]])
    bgr, depth = scene(1, h=H, w=W)
    np.save(imgdir / "b_debug.npy", {"debug_info": {
        "rgb": bgr, "depth_image": depth, "intrinsics": k}})

    monkeypatch.setattr(tbuilder, "build_segmentor",
                        pinned(tbuilder.build_segmentor))
    monkeypatch.setattr(jbuilder, "build_segmentor",
                        pinned(jbuilder.build_segmentor))
    test_npy.main(["--imgdir", str(imgdir), "--outdir", str(tmp_path / "p"),
                   "--device", "cpu"] + model_args(files, files.port_cfg))
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    import test_npy as jax_test_npy

    monkeypatch.setattr(sys, "argv", [
        "test_npy.py", "--imgdir", str(imgdir), "--outdir",
        str(tmp_path / "j")] + model_args(files, files.jax_cfg))
    jax_test_npy.main()
    for name in ("a_plain", "b_debug"):
        got = np.load(tmp_path / "p" / f"{name}-label.npy")
        want = np.load(tmp_path / "j" / f"{name}-label.npy")
        assert got.shape == (H, W) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert len(np.unique(got)) > 1
    # read_npy_sample is the JAX CLI's, both flavours
    for name in ("a_plain", "b_debug"):
        got = test_npy.read_npy_sample(str(imgdir / f"{name}.npy"))
        want = jax_test_npy.read_npy_sample(str(imgdir / f"{name}.npy"))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_cli_without_device_needs_a_card(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    bgr, depth = scene(0, h=H, w=W)
    np.save(tmp_path / "a.npy", {"rgb": bgr})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_npy.main(["--imgdir", str(tmp_path), "--gpu", "0"]
                      + model_args(files, files.port_cfg, crop=False))


def write_pair(d, name, h, w, seed):
    import cv2

    bgr, depth = scene(seed, h=h, w=w)
    cv2.imwrite(str(d / f"{name}-color.png"), bgr)
    cv2.imwrite(str(d / f"{name}-depth.png"),
                np.round(depth * 1000).astype(np.uint16))


def test_test_images_cli_on_mixed_sizes(files, tmp_path):
    """A directory mixing 32x48 and 36x52 frames (padded to multiples of 16
    and cropped back): one -label.png of each frame's size, plus the
    overlays with --vis."""
    import cv2

    sizes = [(32, 48), (36, 52)]
    for i, (h, w) in enumerate(sizes):
        write_pair(tmp_path, f"{i:06d}", h, w, seed=i)
    out = tmp_path / "out"
    test_images.main(["--imgdir", str(tmp_path), "--outdir", str(out),
                      "--device", "cpu", "--vis"]
                     + model_args(files, files.port_cfg))
    for i, (h, w) in enumerate(sizes):
        labels = cv2.imread(str(out / f"{i:06d}-label.png"),
                            cv2.IMREAD_GRAYSCALE)
        assert labels is not None and labels.shape == (h, w)
        seg = cv2.imread(str(out / f"{i:06d}-seg.png"))
        assert seg.shape == (h, w, 3)
        assert (out / f"{i:06d}-mask.png").exists()


@pytest.fixture
def demo_dir(tmp_path):
    """Two RGB-D demo pairs with camera_params.json and their GT."""
    import cv2

    imgdir, gtdir = tmp_path / "demo", tmp_path / "demo_gt"
    imgdir.mkdir()
    gtdir.mkdir()
    for i in range(2):
        write_pair(imgdir, f"{i:06d}", H, W, seed=i)
        cv2.imwrite(str(gtdir / f"{i:06d}-label.png"),
                    gt_labels().astype(np.uint8))
    with open(imgdir / "camera_params.json", "w") as f:
        f.write('{"fx": 40.0, "fy": 40.0, "x_offset": 24.0, '
                '"y_offset": 16.0}')
    return imgdir, gtdir


def test_eval_demo_gt_cli_report(files, segmentors, demo_dir, tmp_path,
                                 monkeypatch):
    """Per-frame metrics of both stages, the markdown report and its .json
    sidecar; each row equals multilabel_metrics of the same Segmentor's
    labels on the same frame."""
    import json

    import cv2

    _, tseg = segmentors
    imgdir, gtdir = demo_dir
    monkeypatch.setattr(tbuilder, "build_segmentor",
                        pinned(tbuilder.build_segmentor))
    report = tmp_path / "report.md"
    eval_demo_gt.main(["--imgdir", str(imgdir), "--gtdir", str(gtdir),
                       "--device", "cpu", "--report", str(report)]
                      + model_args(files, files.port_cfg))
    text = report.read_text()
    assert text.count("| stage1 |") == 2 and text.count("| refined |") == 2
    assert "| mean refined |" in text
    data = json.loads((tmp_path / "report.json").read_text())
    assert [r["frame"] for r in data["rows"]] == ["000000", "000001"]
    for row in data["rows"]:
        im = cv2.imread(str(imgdir / f"{row['frame']}-color.png"))
        depth = cv2.imread(str(imgdir / f"{row['frame']}-depth.png"),
                           cv2.IMREAD_ANYDEPTH).astype(np.float32) / 1000.0
        image = (im.astype(np.float32) / 255.0
                 - tseg.cfg.pixel_means / 255.0)[None]
        res = tseg.segment(image, compute_xyz_np(depth, *INTR)[None])
        assert row["gt_objects"] == 3
        assert row["stage1"] == multilabel_metrics(res.labels[0],
                                                   gt_labels())
        assert row["refined"] == multilabel_metrics(res.labels_refined[0],
                                                    gt_labels())
    assert set(data["mean"]) == {"stage1", "refined"}


def test_demo_artifact_cli_grid(files, demo_dir, tmp_path):
    import json

    import cv2

    imgdir, _ = demo_dir
    out = tmp_path / "grid.png"
    demo_artifact.main(["--imgdir", str(imgdir), "--out", str(out),
                        "--device", "cpu"]
                       + model_args(files, files.port_cfg))
    grid = cv2.imread(str(out))
    # rows: 2 frames; columns: color, stage 1, refined; scaled by 0.5
    assert grid.shape == (H, 3 * W // 2, 3)
    counts = json.loads((tmp_path / "grid.png.json").read_text())
    assert sorted(counts["stage1_instances"]) == ["000000-color.png",
                                                  "000001-color.png"]


# -- ROS adapter --------------------------------------------------------------

class _FakePublisher:
    def __init__(self, topic, *a, **k):
        self.topic = topic
        self.published = []

    def publish(self, msg):
        self.published.append(msg)


class _FakeMsg:
    def __init__(self, data=None, encoding=None):
        self.data = data
        self.encoding = encoding
        self.header = types.SimpleNamespace(stamp=0)


class _FakeBridge:
    def imgmsg_to_cv2(self, msg, fmt=None):
        return msg.data

    def cv2_to_imgmsg(self, arr, fmt=None):
        return _FakeMsg(data=arr, encoding=fmt)


def _install_fake_ros(monkeypatch):
    cam_info = types.SimpleNamespace(K=[INTR[0], 0, INTR[2], 0, INTR[1],
                                        INTR[3], 0, 0, 1])
    rospy = types.ModuleType("rospy")
    rospy.Publisher = _FakePublisher
    rospy.wait_for_message = lambda topic, typ: cam_info
    rospy.logerr_throttle = lambda *a, **k: None
    rospy.loginfo_throttle = lambda *a, **k: None

    mf = types.ModuleType("message_filters")

    class _Sub:
        def __init__(self, *a, **k):
            pass

    class _Sync:
        def __init__(self, subs, queue_size, slop):
            pass

        def registerCallback(self, cb):
            _Sync.callback = cb

    mf.Subscriber = _Sub
    mf.ApproximateTimeSynchronizer = _Sync
    cvb = types.ModuleType("cv_bridge")
    cvb.CvBridge = _FakeBridge
    smsg = types.ModuleType("sensor_msgs")
    smsg_msg = types.ModuleType("sensor_msgs.msg")
    smsg_msg.Image = object
    smsg_msg.CameraInfo = object
    smsg.msg = smsg_msg
    for name, mod in [("rospy", rospy), ("message_filters", mf),
                      ("cv_bridge", cvb), ("sensor_msgs", smsg),
                      ("sensor_msgs.msg", smsg_msg)]:
        monkeypatch.setitem(sys.modules, name, mod)
    return _Sync


@pytest.mark.parametrize("encoding", ["16UC1", "32FC1"])
def test_ros_node_publishes_labels_and_overlays(segmentors, monkeypatch,
                                                encoding):
    """The subscribe -> latest frame -> segment -> publish path with fake
    rospy modules: labels and overlays on both topic pairs, with the input
    header; the labels are the Segmentor's on the same frame."""
    _, tseg = segmentors
    sync_cls = _install_fake_ros(monkeypatch)
    args = types.SimpleNamespace(camera="D415", pretrained_crop="crop.pth")
    listener = ros_node.ImageListener(args, StreamSegmentor(port_cfg(),
                                                            tseg))
    assert listener.intrinsics == INTR
    assert listener.run_network() is False

    bgr, depth = scene(0, h=H, w=W)
    if encoding == "16UC1":
        depth = np.round(depth * 1000).astype(np.uint16)
    rgb_msg = _FakeMsg(bgr)
    sync_cls.callback(rgb_msg, _FakeMsg(depth, encoding=encoding))
    assert listener.run_network() is True

    depth_m = (depth.astype(np.float32) / 1000.0 if encoding == "16UC1"
               else depth)
    image = (bgr.astype(np.float32) / 255.0
             - tseg.cfg.pixel_means / 255.0)[None]
    want = tseg.segment(image, compute_xyz_np(depth_m, *INTR)[None])
    for pub, img_pub, labels in (
            (listener.label_pub, listener.image_pub, want.labels[0]),
            (listener.label_refined_pub, listener.image_refined_pub,
             want.labels_refined[0])):
        (lab,), (overlay,) = pub.published, img_pub.published
        assert lab.encoding == "mono8" and lab.header is rgb_msg.header
        np.testing.assert_array_equal(lab.data, labels.astype(np.uint8))
        assert overlay.encoding == "bgr8" and overlay.data.shape == (H, W, 3)
        assert overlay.header is rgb_msg.header

    # an unsupported depth encoding is dropped without a crash
    sync_cls.callback(rgb_msg, _FakeMsg(np.zeros((H, W)), encoding="8UC1"))
    assert listener.run_network() is False


def test_ros_node_main_builds_on_the_requested_device(files, monkeypatch):
    """main() wires the flags through build_segmentor into StreamSegmentor
    and polls until rospy shuts down."""
    sync_cls = _install_fake_ros(monkeypatch)
    rospy = sys.modules["rospy"]
    ticks = []
    rospy.init_node = lambda name: None
    rospy.is_shutdown = lambda: len(ticks) >= 2
    built = []
    build_segmentor = tbuilder.build_segmentor

    def build(*args, **kwargs):
        built.append(kwargs)
        seg = build_segmentor(*args, **kwargs)
        ticks.append(1)
        return seg

    monkeypatch.setattr(tbuilder, "build_segmentor", build)
    monkeypatch.setattr(ros_node.time, "sleep", lambda s: ticks.append(s))
    ros_node.main(["--device", "cpu", "--fast"]
                  + model_args(files, files.port_cfg))
    assert built[0]["device"] == "cpu"
    assert built[0]["model_dtype"] == torch.bfloat16
    assert callable(sync_cls.callback)
