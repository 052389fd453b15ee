"""The numpy replicas of utils/imgproc.py against the installed cv2
(OpenCV 5.0), bit for bit: seeded cases at the data path's shapes, the
edge sizes (1 pixel, odd sizes, sizes that are not a multiple of the GP
factor, crops clipped at the border), hypothesis cases, BGR2HLS over all
2^24 colours and HLS2BGR over every H in [0, 180) with every L and S.

Tolerance: none, every array is compared exactly (dtype included).
"""

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from unseenobjectclustering_torch.utils import imgproc

torch.set_num_threads(1)

SETTINGS = settings(max_examples=60, deadline=None, derandomize=True,
                    database=None)


def same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- colour -------------------------------------------------------------------

@pytest.mark.parametrize("chunk", range(4))
def test_bgr_to_hls_every_colour(chunk):
    """A quarter of the 2^24 BGR colours per case."""
    v = np.arange(chunk << 22, (chunk + 1) << 22, dtype=np.uint32)
    im = np.stack([v & 255, (v >> 8) & 255, v >> 16], -1).astype(
        np.uint8).reshape(2048, 2048, 3)
    same(imgproc.bgr_to_hls(im), cv2.cvtColor(im, cv2.COLOR_BGR2HLS))


@pytest.mark.parametrize("hues", [range(0, 90), range(90, 180)])
def test_hls_to_bgr_every_input(hues):
    h, lum, s = np.meshgrid(np.asarray(hues), np.arange(256), np.arange(256),
                            indexing="ij")
    im = np.stack([h, lum, s], -1).astype(np.uint8).reshape(-1, 256, 3)
    same(imgproc.hls_to_bgr(im), cv2.cvtColor(im, cv2.COLOR_HLS2BGR))


# -- resize -------------------------------------------------------------------

def crop_sizes(rng, n):
    """(source h, w, side): square crops clipped at a 480x640 border, as
    pad_crop_resize makes them, plus exact halves and 1-pixel edges."""
    out = [(448, 448, 224), (2, 2, 1), (1, 1, 224), (1, 7, 224), (7, 1, 128),
           (480, 640, 224), (256, 256, 128)]
    for _ in range(n):
        s = int(rng.randint(20, 481))
        out.append((s - int(rng.randint(0, s // 3)),
                    s - int(rng.randint(0, s // 3)),
                    int(rng.choice([224, 128, 32, 56]))))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_crop_resizes(seed):
    """pad_crop_resize's three resizes: linear uint8 BGR, nearest int32
    labels and float32 XYZ, to a square side from a clipped crop."""
    rng = np.random.RandomState(seed)
    for h, w, side in crop_sizes(rng, 12):
        bgr = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        label = rng.randint(0, 12, (h, w)).astype(np.int32)
        xyz = rng.randn(h, w, 3).astype(np.float32)
        same(imgproc.resize_linear_u8(bgr, (side, side)),
             cv2.resize(bgr, (side, side)))
        for a in (label, xyz, bgr[..., 0]):
            same(imgproc.resize_nearest(a, (side, side)),
                 cv2.resize(a, (side, side),
                            interpolation=cv2.INTER_NEAREST))


@SETTINGS
@given(st.integers(1, 90), st.integers(1, 90), st.integers(1, 120),
       st.integers(1, 120), st.sampled_from([1, 3]), st.integers(0, 2 ** 31))
def test_resize_linear_u8_and_nearest_any_size(h, w, oh, ow, c, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)[..., :c]
    if c == 1:
        img = img[..., 0]
    same(imgproc.resize_linear_u8(img, (oh, ow)), cv2.resize(img, (ow, oh)))
    same(imgproc.resize_nearest(img, (oh, ow)),
         cv2.resize(img, (ow, oh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("hw", [(480, 640), (60, 80), (48, 64), (61, 83),
                                (7, 5), (4, 4), (5, 9)])
def test_resize_cubic_f64_gp_noise(hw):
    """add_noise_to_xyz's field: [h // 4, w // 4, 3] up to [h, w], also at
    sizes that are not a multiple of the factor."""
    h, w = hw
    rng = np.random.RandomState(h * 1000 + w)
    field = rng.normal(0.0, 0.005, size=(max(h // 4, 1), max(w // 4, 1), 3))
    same(imgproc.resize_cubic_f64(field, (h, w)),
         cv2.resize(field, (w, h), interpolation=cv2.INTER_CUBIC))


@SETTINGS
@given(st.integers(1, 40), st.integers(1, 40), st.integers(1, 100),
       st.integers(1, 100), st.sampled_from([1, 3]), st.integers(0, 2 ** 31))
def test_resize_cubic_f64_any_size(h, w, oh, ow, c, seed):
    rng = np.random.RandomState(seed)
    field = rng.normal(0.0, 0.005, size=(h, w, c))
    if c == 1:
        field = field[..., 0]
    same(imgproc.resize_cubic_f64(field, (oh, ow)),
         cv2.resize(field, (ow, oh), interpolation=cv2.INTER_CUBIC))


@pytest.mark.parametrize("hw", [(480, 640), (60, 80), (48, 64), (13, 7)])
def test_resize_linear_f64_realsense_fields(hw):
    """add_realsense_artifacts' two fields: [h // 40 + 2, w // 40 + 2] to
    [h, w], and the [h // 16 + 2, 1] column to [h, 1]."""
    h, w = hw
    rng = np.random.RandomState(h + w)
    for src, out in ((rng.rand(h // 40 + 2, w // 40 + 2), (h, w)),
                     (rng.rand(h // 16 + 2, 1), (h, 1))):
        same(imgproc.resize_linear_f64(src, out),
             cv2.resize(src, out[::-1], interpolation=cv2.INTER_LINEAR))


@SETTINGS
@given(st.integers(1, 30), st.integers(1, 30), st.integers(1, 90),
       st.integers(1, 90), st.integers(0, 2 ** 31))
def test_resize_linear_f64_any_size(h, w, oh, ow, seed):
    src = np.random.RandomState(seed).rand(h, w)
    same(imgproc.resize_linear_f64(src, (oh, ow)),
         cv2.resize(src, (ow, oh), interpolation=cv2.INTER_LINEAR))


# -- filter2D -------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 5, 7, 9, 11, 15])
def test_filter2d_box_blur_sizes(k):
    """add_noise's motion blur at every size, both axes, at 480x640 and at
    sizes smaller than the kernel."""
    rng = np.random.RandomState(k)
    line = np.full((1, k), 1.0 / k, np.float32)
    for h, w in ((480, 640), (60, 80), (1, 1), (2, 9), (7, 3), (1, 20)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for kernel in (line, line.T):
            same(imgproc.filter2d_u8(img, kernel),
                 cv2.filter2D(img, -1, kernel))


@SETTINGS
@given(st.integers(1, 50), st.integers(1, 50),
       st.sampled_from([3, 5, 7, 9, 11, 15]), st.booleans(),
       st.integers(0, 2 ** 31))
def test_filter2d_any_size(h, w, k, vertical, seed):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if seed % 3 == 0:  # flat regions: sums that land on .5
        img = (img // 85 * 85).astype(np.uint8)
    kernel = np.full((1, k), 1.0 / k, np.float32)
    kernel = kernel.T if vertical else kernel
    same(imgproc.filter2d_u8(img, kernel), cv2.filter2D(img, -1, kernel))


# -- ellipse -------------------------------------------------------------------

def cv2_ellipse(shape, center, axes, angle):
    return cv2.ellipse(np.zeros(shape, np.uint8), center, axes, angle=angle,
                       startAngle=0, endAngle=360, color=1, thickness=-1)


@pytest.mark.parametrize("seed", range(3))
def test_fill_ellipse_dropout_draws(seed):
    """dropout_random_ellipses' draws at 480x640: gamma(5, 1) radii
    (0 included), every angle, centres anywhere on the frame; and
    random_ellipses' larger ones."""
    rng = np.random.RandomState(seed)
    for i in range(60):
        center = (int(rng.randint(0, 640)), int(rng.randint(0, 480)))
        if i % 2:
            axes = tuple(int(a) for a in np.rint(rng.gamma(5.0, 1.0, 2)))
        else:
            axes = tuple(int(a) for a in rng.randint(0, 120, 2))
        angle = int(rng.randint(0, 360))
        got = imgproc.fill_ellipse(np.zeros((480, 640), np.uint8), center,
                                   axes, angle, 1)
        same(got, cv2_ellipse((480, 640), center, axes, angle))


@SETTINGS
@given(st.integers(1, 60), st.integers(1, 60), st.integers(-30, 90),
       st.integers(-30, 90), st.integers(0, 45), st.integers(0, 45),
       st.integers(0, 359))
def test_fill_ellipse_edges(h, w, cx, cy, ax, ay, angle):
    """Radii of 0, 1 and 2 (a point, a segment), centres off the canvas,
    ellipses clipped at every edge."""
    got = imgproc.fill_ellipse(np.zeros((h, w), np.uint8), (cx, cy),
                               (ax, ay), angle, 1)
    same(got, cv2_ellipse((h, w), (cx, cy), (ax, ay), angle))


# -- warpAffine ---------------------------------------------------------------

@SETTINGS
@given(st.integers(1, 120), st.integers(1, 120), st.integers(-60, 60),
       st.integers(-60, 60), st.floats(-30, 30), st.integers(0, 2 ** 31))
def test_translate_and_rotate_nearest(h, w, tx, ty, angle, seed):
    """_translate's float32 matrix and _rotate's getRotationMatrix2D about
    (w // 2, h // 2), both INTER_NEAREST with a 0 border."""
    rng = np.random.RandomState(seed)
    mask = (rng.rand(h, w) < 0.5).astype(np.uint8)
    m = np.array([[1, 0, tx], [0, 1, ty]], np.float32)
    same(imgproc.warp_affine_nearest(mask, m, (w, h)),
         cv2.warpAffine(mask, m, (w, h), flags=cv2.INTER_NEAREST))
    r = cv2.getRotationMatrix2D((w // 2, h // 2), angle, 1)
    same(imgproc.rotation_matrix_2d((w // 2, h // 2), angle, 1), r)
    same(imgproc.warp_affine_nearest(mask, r, (w, h)),
         cv2.warpAffine(mask, r, (w, h), flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("seed", range(2))
def test_rotate_nearest_at_the_frame(seed):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(480, 640) < 0.3).astype(np.uint8)
    for angle in rng.uniform(-30, 30, 8):
        r = cv2.getRotationMatrix2D((320, 240), angle, 1)
        same(imgproc.warp_affine_nearest(mask, r, (640, 480)),
             cv2.warpAffine(mask, r, (640, 480), flags=cv2.INTER_NEAREST))


# -- morphology -------------------------------------------------------------------

def test_ellipse_kernels():
    for k in range(1, 200):
        same(imgproc.ellipse_kernel(k),
             cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k)))


@SETTINGS
@given(st.integers(1, 70), st.integers(1, 70), st.integers(1, 40),
       st.sampled_from(["erode", "dilate", "open", "close"]),
       st.integers(0, 2 ** 31))
def test_morphology(h, w, k, op, seed):
    """Every op with elliptic kernels up to larger than the mask, odd and
    even sizes, on binary masks and on uint8 values."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((h, w), np.uint8)
    mask[rng.randint(0, h):rng.randint(0, h) + 20,
         rng.randint(0, w):rng.randint(0, w) + 25] = 1
    mask[rng.rand(h, w) < 0.05] ^= 1
    if seed % 4 == 0:
        mask = rng.randint(0, 256, (h, w)).astype(np.uint8)
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
    flag = {"erode": cv2.MORPH_ERODE, "dilate": cv2.MORPH_DILATE,
            "open": cv2.MORPH_OPEN, "close": cv2.MORPH_CLOSE}[op]
    same(imgproc.morphology(mask, op, imgproc.ellipse_kernel(k)),
         cv2.morphologyEx(mask, flag, kernel))


def test_refusals():
    with pytest.raises(ValueError):
        imgproc.resize_linear_u8(np.zeros((4, 4), np.float32), (2, 2))
    with pytest.raises(ValueError):
        imgproc.resize_nearest(np.zeros((4, 4), np.uint8), (0, 2))
    with pytest.raises(ValueError):
        imgproc.filter2d_u8(np.zeros((4, 4), np.uint8),
                            np.ones((3, 3), np.float32))
    with pytest.raises(ValueError):
        imgproc.morphology(np.zeros((4, 4), np.uint8), "gradient",
                           np.ones((3, 3), np.uint8))
    with pytest.raises(ValueError):
        imgproc.bgr_to_hls(np.zeros((4, 4, 3), np.float32))
