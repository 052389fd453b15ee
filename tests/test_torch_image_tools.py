"""The port's image tools without OpenCV: the numpy contours, the uint8
resize and the PNG writer against cv2 (this sandbox's OpenCV 5.0), and
tools.test_images / eval_demo_gt / demo_artifact run with cv2 blocked
against the same runs through cv2.

Tolerances: none; pixels, arrays and file bytes are equal.
"""

import json
import shutil
import sys

import cv2
import numpy as np
import pytest
from scipy import ndimage

from test_torch_pipeline import scene
from test_torch_serving import files, gt_labels, model_args  # noqa: F401
from test_torch_serving import H, W
from unseenobjectclustering_torch.tools import (demo_artifact, eval_demo_gt,
                                                test_images)
from unseenobjectclustering_torch.utils import imgproc, png
from unseenobjectclustering_torch.utils import masks as tmasks
from unseenobjectclustering_tpu.utils import masks as jmasks


def cv2_border(mask):
    out = np.zeros(mask.shape + (3,), np.uint8)
    cs, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
                             cv2.CHAIN_APPROX_SIMPLE)
    cv2.drawContours(out, cs, -1, (255, 255, 255), 1)
    return out[..., 0] == 255


def label_map(kind, seed, h=40, w=56):
    """Label maps with the contour traps: blobs with holes, a component
    inside another's hole, 1-pixel lines and spurs, edge-touching blobs,
    and noise."""
    rng = np.random.RandomState(seed)
    lab = np.zeros((h, w), np.int32)
    if kind == "holes":
        lab[5:30, 5:40] = 1
        lab[10:20, 10:30] = 0          # a hole
        lab[13:17, 14:20] = 1          # the same label inside the hole
        lab[12:18, 22:28] = 2          # another label inside the hole
        lab[22:26, 30:34] = 0          # a second hole
    elif kind == "lines":
        lab[3, 2:50] = 1               # a horizontal 1-pixel line
        lab[5:35, 20] = 2              # a vertical one
        lab[20:30, 30:40] = 3
        lab[25, 40:52] = 3             # a spur
        for i in range(12):            # a diagonal line
            lab[10 + i, 40 + i // 2 + i % 2] = 4
    elif kind == "edges":
        lab[:10, :12] = 1              # corner blobs touching the frame
        lab[h - 8:, 20:35] = 2
        lab[15:25, w - 6:] = 3
        lab[:, 44] = 4                 # a column from edge to edge
    else:  # noise: random blobs of 5 labels, dilated and pierced
        seeds = rng.randint(0, 6, (h // 4, w // 4)).repeat(4, 0).repeat(4, 1)
        lab = np.where(rng.rand(h, w) < 0.15, 0, seeds)
        lab = ndimage.grey_dilation(lab, size=rng.randint(1, 3))
    return lab.astype(np.int32)


KINDS = [("holes", 0), ("lines", 0), ("edges", 0)] + [
    ("noise", s) for s in range(6)]


@pytest.mark.parametrize("kind,seed", KINDS,
                         ids=[f"{k}{s}" for k, s in KINDS])
def test_outer_border_is_cv2s_contour_pixels(kind, seed):
    lab = label_map(kind, seed)
    for k in np.unique(lab):
        if k:
            np.testing.assert_array_equal(tmasks.outer_border(lab == k),
                                          cv2_border(lab == k),
                                          err_msg=f"label {k}")


def test_outer_border_random_masks():
    """1000 small random masks (1 to 20 pixels a side, any density)."""
    rng = np.random.RandomState(4)
    for _ in range(1000):
        h, w = rng.randint(1, 21, 2)
        m = rng.rand(h, w) < rng.rand()
        if rng.rand() < 0.5:
            m = ndimage.binary_dilation(m) ^ (rng.rand(h, w) < 0.1)
        np.testing.assert_array_equal(tmasks.outer_border(m), cv2_border(m))


@pytest.mark.parametrize("kind,seed", KINDS,
                         ids=[f"{k}{s}" for k, s in KINDS])
def test_visualize_segmentation_matches_the_jax_overlay(kind, seed):
    """The port's overlay with numpy contours equals the JAX package's
    cv2 overlay, pixel for pixel (labels drawn one after another)."""
    lab = label_map(kind, seed)
    im = np.random.RandomState(seed).randint(0, 256, lab.shape + (3,)
                                             ).astype(np.uint8)
    np.testing.assert_array_equal(tmasks.visualize_segmentation(im, lab),
                                  jmasks.visualize_segmentation(im, lab))


@pytest.mark.parametrize("scale", [0.5, 0.25, 1.5, 0.75, 2.0, 0.3])
def test_resize_u8_is_cv2_resize(scale):
    """Random grey, BGR and BGRA images of odd and even sizes, and the
    tool's grid shape at the demo size."""
    rng = np.random.RandomState(int(scale * 100))
    shapes = [(int(h), int(w)) for h, w in rng.randint(1, 80, (40, 2))]
    for i, (h, w) in enumerate(shapes + [(2 * 480, 3 * 640)]):
        c = (1, 3, 4)[i % 3]
        img = rng.randint(0, 256, (h, w, c) if c > 1 else (h, w)
                          ).astype(np.uint8)
        if round(h * scale) < 1 or round(w * scale) < 1:
            continue
        want = cv2.resize(img, None, fx=scale, fy=scale)
        got = imgproc.resize_u8(img, scale)
        assert got.shape == want.shape, (h, w, c)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, c)))


def test_resize_u8_refuses_what_it_does_not_reproduce():
    with pytest.raises(ValueError, match="uint8"):
        imgproc.resize_u8(np.zeros((4, 4), np.float32), 0.5)
    with pytest.raises(ValueError, match="positive"):
        imgproc.resize_u8(np.zeros((4, 4), np.uint8), 0.0)


def test_imwrite_writes_cv2s_bytes(tmp_path):
    """png.imwrite and cv2.imwrite write the same file for grey, BGR and
    16-bit grey images of 1 to 120 pixels a side, and for a large BGR
    image (several IDAT chunks, the full zlib window)."""
    rng = np.random.RandomState(2)
    arrays = [rng.randint(0, 256, (480, 640, 3)).astype(np.uint8)]
    for i in range(60):
        h, w = (int(n) for n in rng.randint(1, 120, 2))
        if i % 5 == 0:
            w = 1
        arrays.append([
            rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            rng.randint(0, 5, (h, w)).astype(np.uint8),
            rng.randint(0, 4000, (h, w)).astype(np.uint16)][i % 3])
    for a in arrays:
        cv2.imwrite(str(tmp_path / "cv.png"), a)
        png.imwrite(str(tmp_path / "np.png"), a)
        assert ((tmp_path / "cv.png").read_bytes()
                == (tmp_path / "np.png").read_bytes()), (a.shape, a.dtype)


def test_imread_is_cv2_imread_and_raises_where_cv2_gives_none(tmp_path):
    rng = np.random.RandomState(3)
    bgr = rng.randint(0, 256, (9, 13, 3)).astype(np.uint8)
    depth = rng.randint(0, 60000, (9, 13)).astype(np.uint16)
    cv2.imwrite(str(tmp_path / "c.png"), bgr)
    cv2.imwrite(str(tmp_path / "d.png"), depth)
    for path, mode, flag in (("c.png", "color", cv2.IMREAD_COLOR),
                             ("d.png", "anydepth", cv2.IMREAD_ANYDEPTH),
                             ("d.png", "grey", cv2.IMREAD_GRAYSCALE)):
        want = cv2.imread(str(tmp_path / path), flag)
        got = png.imread(str(tmp_path / path), mode)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    (tmp_path / "bad.png").write_bytes(b"not a png")
    for path in ("missing.png", "bad.png"):
        assert cv2.imread(str(tmp_path / path)) is None
        with pytest.raises(IOError, match=path):
            png.imread(str(tmp_path / path))


# -- the tools, with cv2 blocked and through cv2 ----------------------------

def cv2_imread(path, mode="color"):
    flag = {"color": cv2.IMREAD_COLOR, "anydepth": cv2.IMREAD_ANYDEPTH,
            "grey": cv2.IMREAD_GRAYSCALE}[mode]
    im = cv2.imread(path, flag)
    if im is None:
        raise IOError(f"cannot read {path}")
    return im


def through_cv2(monkeypatch):
    """The tools' image operations replaced by cv2's (and the JAX
    package's cv2 overlay): the runs the numpy ones must reproduce."""
    monkeypatch.setattr(png, "imread", cv2_imread)
    monkeypatch.setattr(png, "imwrite",
                        lambda path, a: cv2.imwrite(path, a))
    monkeypatch.setattr(demo_artifact, "resize_u8",
                        lambda a, s: cv2.resize(a, None, fx=s, fy=s))
    monkeypatch.setattr(tmasks, "visualize_segmentation",
                        jmasks.visualize_segmentation)


@pytest.fixture
def image_tree(tmp_path):
    """Two RGB-D pairs, camera_params.json and GT labels, written by
    utils/png.py."""
    imgdir, gtdir = tmp_path / "img", tmp_path / "gt"
    imgdir.mkdir()
    gtdir.mkdir()
    for i in range(2):
        bgr, depth = scene(i, h=H, w=W)
        png.imwrite(str(imgdir / f"{i:06d}-color.png"), bgr)
        png.write_png(str(imgdir / f"{i:06d}-depth.png"),
                      np.round(depth * 1000).astype(np.uint16))
        png.write_png(str(gtdir / f"{i:06d}-label.png"),
                      gt_labels().astype(np.uint8))
    with open(imgdir / "camera_params.json", "w") as f:
        json.dump({"fx": 40.0, "fy": 40.0, "x_offset": W / 2.0,
                   "y_offset": H / 2.0}, f)
    return imgdir, gtdir


def run_tools(files, imgdir, gtdir, out):  # noqa: F811
    out.mkdir()
    model = ["--device", "cpu"] + model_args(files, files.port_cfg)
    test_images.main(["--imgdir", str(imgdir), "--outdir", str(out / "ti"),
                      "--vis"] + model)
    eval_demo_gt.main(["--imgdir", str(imgdir), "--gtdir", str(gtdir),
                       "--report", str(out / "report.md")] + model)
    for scale in ("0.5", "1.5"):
        demo_artifact.main(["--imgdir", str(imgdir), "--out",
                            str(out / f"grid{scale}.png"), "--scale",
                            scale] + model)
    written = {str(p.relative_to(out)): p.read_bytes()
               for p in sorted(out.rglob("*")) if p.is_file()}
    shutil.rmtree(out)  # the next run writes the same paths
    return written


def test_tools_without_cv2_write_the_bytes_of_the_cv2_runs(
        files, image_tree, tmp_path, monkeypatch, capsys):  # noqa: F811
    """test_images (--vis), eval_demo_gt (--report) and demo_artifact at
    scales 0.5 and 1.5, with sys.modules["cv2"] = None: every PNG, the
    report and its JSON are byte-equal to the same runs through cv2, and
    the overlays hold contours."""
    imgdir, gtdir = image_tree
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        got = run_tools(files, imgdir, gtdir, tmp_path / "out")
    with monkeypatch.context() as m:
        through_cv2(m)
        want = run_tools(files, imgdir, gtdir, tmp_path / "out")
    capsys.readouterr()
    assert sorted(got) == sorted(want)
    assert {"ti/000000-label.png", "ti/000001-seg.png", "ti/000000-mask.png",
            "report.md", "report.json", "grid0.5.png", "grid1.5.png.json"
            } <= set(got)
    for name in got:
        assert got[name] == want[name], name
    (tmp_path / "seg.png").write_bytes(got["ti/000000-seg.png"])
    seg = png.imread(str(tmp_path / "seg.png"))
    assert (seg == 255).all(-1).any()  # contours were drawn
    (tmp_path / "grid.png").write_bytes(got["grid1.5.png"])
    grid = png.imread(str(tmp_path / "grid.png"))
    # rows: the 2 frames; columns: color, stage 1, refined
    assert grid.shape == (round(2 * H * 1.5), round(3 * W * 1.5), 3)
