"""The port's metrics, masks and result grids against the JAX package.

utils/evaluation.py (seg2bmap, disk, the dilation radius, boundary_overlap,
multilabel_metrics), utils/masks.py (palette, color masks, index grid,
indexed PNGs, overlays) and utils/visualization.py of
unseenobjectclustering_torch on the same numpy inputs as the JAX package's
copies, made from numpy seeds.  Tolerance 0: the same arrays and the same
metric dicts (same keys, same floats).  Also: the numpy dilation (no
OpenCV) equals OpenCV's, and the modules the GPU machine imports load with
OpenCV, PIL, matplotlib, rospy and JAX all blocked.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from unseenobjectclustering_torch.utils import evaluation as tev
from unseenobjectclustering_torch.utils import masks as tmasks
from unseenobjectclustering_torch.utils import visualization as tvis
from unseenobjectclustering_tpu.utils import evaluation as jev
from unseenobjectclustering_tpu.utils import masks as jmasks
from unseenobjectclustering_tpu.utils import visualization as jvis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def boxes_map(rng, h, w, k, ids=None):
    """[h, w] int32 label map of k random (possibly overlapping) boxes,
    later boxes on top; ids 1..k unless given."""
    ids = np.arange(1, k + 1) if ids is None else ids
    out = np.zeros((h, w), np.int32)
    for i in ids:
        bh, bw = rng.randint(2, h // 2 + 2), rng.randint(2, w // 2 + 2)
        y, x = rng.randint(0, h - bh + 1), rng.randint(0, w - bw + 1)
        out[y:y + bh, x:x + bw] = i
    return out


def perturbed(rng, gt):
    """A prediction near gt: shifted by a pixel or two, one id merged into
    another, ids permuted, a spurious box."""
    pred = np.roll(gt, (rng.randint(-2, 3), rng.randint(-2, 3)), (0, 1))
    ids = np.unique(pred[pred > 0])
    if len(ids) > 2:
        pred[pred == ids[0]] = ids[1]
    perm = np.concatenate([[0], rng.permutation(np.arange(1, 64)) + 3])
    pred = perm[pred].astype(np.int32)
    h, w = gt.shape
    pred[rng.randint(h // 2):, :rng.randint(1, w // 4)] = 99
    return pred


def assert_same_dict(got, want):
    assert list(got) == list(want)
    for k in want:
        assert type(got[k]) is type(want[k]), k
        assert got[k] == want[k], k


@pytest.mark.parametrize("seed", range(4))
def test_boundary_maps_and_overlap_match_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = 40 + 3 * seed, 56 + 5 * seed
    gt = boxes_map(rng, h, w, 4) == 2
    pred = boxes_map(rng, h, w, 4) == 3
    np.testing.assert_array_equal(tev.seg2bmap(pred), jev.seg2bmap(pred))
    for th in (0.003, 0.02, 2):
        assert tev._bound_pix((h, w), th) == jev._bound_pix((h, w), th)
        assert (tev.boundary_overlap(pred, gt, th)
                == jev.boundary_overlap(pred, gt, th))


@pytest.mark.parametrize("radius", [0, 1, 3, 6])
def test_disk_matches_jax(radius):
    np.testing.assert_array_equal(tev.disk(radius), jev.disk(radius))


@pytest.mark.parametrize("seed", range(6))
def test_multilabel_metrics_match_jax(seed):
    """Random box maps against a perturbed prediction (shifted, merged,
    permuted ids, a spurious object), at the small size and at 480x640,
    where the dilation radius is 3."""
    rng = np.random.RandomState(seed)
    h, w = (480, 640) if seed == 0 else (48, 64)
    gt = boxes_map(rng, h, w, 3 + seed)
    pred = perturbed(rng, gt)
    got = tev.multilabel_metrics(pred, gt)
    assert_same_dict(got, jev.multilabel_metrics(pred, gt))
    assert 0.0 < got["Objects F-measure"] < 1.0
    assert 0.0 < got["Boundary F-measure"] < 1.0


@pytest.mark.parametrize("case", ["gt_in_pred", "permuted", "pred_empty",
                                  "gt_empty", "both_empty"])
def test_multilabel_metrics_cases_match_jax(case):
    """GT a subset of the prediction, permuted ids (a perfect score) and
    the three edge cases of _edge_case."""
    rng = np.random.RandomState(7)
    gt = boxes_map(rng, 48, 64, 4)
    empty = np.zeros_like(gt)
    pred, want_f = {
        "gt_in_pred": (np.where(gt > 0, gt, boxes_map(rng, 48, 64, 2) * 9),
                       None),
        "permuted": ((np.array([0, 4, 3, 1, 2]) * 5)[gt], 1.0),
        "pred_empty": (empty, 0.0),
        "gt_empty": (gt, 0.0),
        "both_empty": (empty, 1.0),
    }[case]
    if case in ("gt_empty", "both_empty"):
        gt = empty
    got = tev.multilabel_metrics(pred, gt)
    assert_same_dict(got, jev.multilabel_metrics(pred, gt))
    if want_f is not None:
        assert got["Objects F-measure"] == want_f
    if case == "gt_in_pred":
        assert got["Objects Recall"] == 1.0 > got["Objects Precision"]


@pytest.mark.parametrize("radius", [1, 3, 5])
def test_numpy_dilation_matches_cv2(monkeypatch, radius):
    """Without OpenCV (as on the GPU machine) _dilate shifts and ORs in
    numpy; the map equals cv2.dilate's, and so do the metrics."""
    rng = np.random.RandomState(radius)
    bmap = tev.seg2bmap(boxes_map(rng, 60, 80, 5) > 0)
    with_cv2 = tev._dilate(bmap, radius)
    gt = boxes_map(rng, 60, 80, 4)
    pred = perturbed(rng, gt)
    want = tev.multilabel_metrics(pred, gt)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(tev._dilate(bmap, radius), with_cv2)
    np.testing.assert_array_equal(with_cv2, jev._dilate(bmap, radius))
    assert_same_dict(tev.multilabel_metrics(pred, gt), want)


def test_palette_color_mask_and_indices_match_jax():
    labels = boxes_map(np.random.RandomState(0), 32, 48, 6)
    labels[0, 0] = 300  # wraps around the 256-entry palette
    np.testing.assert_array_equal(tmasks.default_palette(),
                                  jmasks.default_palette())
    np.testing.assert_array_equal(tmasks.default_palette(17),
                                  jmasks.default_palette(17))
    np.testing.assert_array_equal(tmasks.get_color_mask(labels),
                                  jmasks.get_color_mask(labels))
    np.testing.assert_array_equal(tmasks.build_matrix_of_indices(5, 7),
                                  jmasks.build_matrix_of_indices(5, 7))


def test_indexed_png_round_trip_matches_jax(tmp_path):
    labels = boxes_map(np.random.RandomState(1), 32, 48, 5).astype(np.uint8)
    tmasks.imwrite_indexed(str(tmp_path / "port.png"), labels)
    jmasks.imwrite_indexed(str(tmp_path / "jax.png"), labels)
    assert (tmp_path / "port.png").read_bytes() == (
        tmp_path / "jax.png").read_bytes()
    back = tmasks.imread_indexed(str(tmp_path / "port.png"))
    np.testing.assert_array_equal(back, labels)
    np.testing.assert_array_equal(
        back, jmasks.imread_indexed(str(tmp_path / "jax.png")))
    with pytest.raises(ValueError):
        tmasks.imwrite_indexed(str(tmp_path / "x.png"), labels[None])


def test_overlay_and_grid_panels_match_jax():
    rng = np.random.RandomState(2)
    im = rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)
    labels = boxes_map(rng, 32, 48, 4)
    for contours in (True, False):
        np.testing.assert_array_equal(
            tmasks.visualize_segmentation(im, labels,
                                          draw_contours=contours),
            jmasks.visualize_segmentation(im, labels,
                                          draw_contours=contours))
    feats = rng.randn(32, 48, 8).astype(np.float32)
    np.testing.assert_array_equal(tvis.features_to_rgb(feats),
                                  jvis.features_to_rgb(feats))
    np.testing.assert_array_equal(tvis.xyz_to_rgb(feats[..., :3]),
                                  jvis.xyz_to_rgb(feats[..., :3]))
    stats = {"min": [-1.0] * 8, "max": [1.0] * 8}
    np.testing.assert_array_equal(tvis.normalize_descriptor(feats, stats),
                                  jvis.normalize_descriptor(feats, stats))


def test_segmentation_grid_has_the_jax_panels():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(3)
    im = rng.randint(0, 256, (32, 48, 3)).astype(np.uint8)
    xyz = rng.rand(32, 48, 3).astype(np.float32)
    labels = boxes_map(rng, 32, 48, 3)
    feats = rng.randn(32, 48, 8).astype(np.float32)
    figs = [mod.segmentation_grid(im, xyz, feats, labels, labels,
                                  seed_indices=np.array([3, 70]))
            for mod in (tvis, jvis)]
    panels = [[(ax.get_title(), ax.images[0].get_array().tolist())
               for ax in fig.axes if ax.images] for fig in figs]
    assert len(panels[0]) == 5
    assert panels[0] == panels[1]
    for fig in figs:
        plt.close(fig)


def test_serving_modules_import_without_optional_packages(tmp_path):
    """What chip_smoke.py imports loads with OpenCV, PIL, matplotlib, rospy,
    JAX and the JAX package blocked (the GPU machine has none of them),
    the data slice's modules included, and a palette PNG written by PIL
    reads back."""
    from PIL import Image

    labels = np.random.RandomState(1).randint(0, 200, (9, 11)).astype(
        np.uint8)
    im = Image.fromarray(labels, mode="P")
    im.putpalette(list(range(256)) * 3)
    im.save(tmp_path / "labels.png")
    np.save(tmp_path / "labels.npy", labels)
    code = """
import sys, importlib
for name in ("cv2", "PIL", "matplotlib", "rospy", "jax", "jaxlib", "flax",
             "unseenobjectclustering_tpu"):
    sys.modules[name] = None
for name in ("utils.evaluation", "utils.masks", "utils.visualization",
             "utils.png", "engine.evaluate", "engine.stream",
             "engine.builder", "tools.test_npy", "tools.ros_node",
             "tools.test_net", "tools.make_real_fixtures", "data.pcd",
             "data.native", "data.datasets", "data.augmentation",
             "models.unets"):
    importlib.import_module("unseenobjectclustering_torch." + name)
import chip_smoke
import numpy as np
from unseenobjectclustering_torch.utils.evaluation import multilabel_metrics
from unseenobjectclustering_torch.utils.masks import imread_indexed
gt = np.zeros((32, 48), np.int32)
gt[4:12, 5:20] = 1
gt[15:30, 22:40] = 2
m = multilabel_metrics(np.roll(gt, 3, 0), gt)
assert 0.0 < m["Boundary F-measure"] < 1.0, m
got = imread_indexed(sys.argv[1] + "/labels.png")
assert (got == np.load(sys.argv[1] + "/labels.npy")).all()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
