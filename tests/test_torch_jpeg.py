"""utils/jpeg.py (the port's C++ JPEG decoder) against the installed
cv2.imread, and the committed TableTop fixture tree against its digests.

- A corpus written here by cv2.imwrite: every IMWRITE_JPEG_SAMPLING_FACTOR
  the decoder takes (4:4:4, 4:2:2, 4:4:0, 4:2:0), restart intervals,
  optimised Huffman tables, grey, qualities 50 / 75 / 95 / 100 and odd
  sizes down to 1x1, each decoded bit-equal to cv2.imread; 4:1:1 and every
  unsupported kind (progressive, arithmetic-coded, 12-bit, lossless, CMYK,
  an EXIF orientation cv2 would apply) raises ValueError naming the file.
- tests/torch_fixtures/tabletop: the digests of cv2.imread of its JPEGs
  and of the JAX package's TableTopObject samples (TEST, TRAIN with the
  rgbd_add recipe, TRAIN with SYN_CROP at 224, epochs 0 and 1) equal
  digests.json, and the port gives the same digests with cv2 blocked.
- A failed build of the library raises.

Tolerance: none (bit equality, or equal SHA-256 digests).
"""

import importlib.util
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch.config import Config as TConfig
from unseenobjectclustering_torch.data import factory as tfactory
from unseenobjectclustering_torch.data import native
from unseenobjectclustering_torch.utils import jpeg
from unseenobjectclustering_tpu.config import Config as JConfig
from unseenobjectclustering_tpu.data import factory as jfactory

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "torch_fixtures", "tabletop")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
SIZES = [(480, 640), (1, 1), (1, 2), (2, 1), (3, 5), (8, 8), (15, 17),
         (16, 32), (33, 47), (9, 40)]


def fixtures_module():
    spec = importlib.util.spec_from_file_location(
        "make_tabletop_fixtures",
        os.path.join(FIXTURES, "make_tabletop_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def image(h, w, seed):
    """Smooth colour fields with noise: every DCT band is used."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 110 * np.sin(x / 6.0 + c) * np.cos(y / 10.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.randn(h, w, 3) * 25, 0, 255).astype(np.uint8)


def write(tmp_path, name, img, params=()):
    path = str(tmp_path / name)
    assert cv2.imwrite(path, img, list(params))
    return path


def assert_same(path):
    got, want = jpeg.imread(path), cv2.imread(path)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_sampling_and_quality(tmp_path, sampling, quality):
    for i, (h, w) in enumerate(SIZES):
        assert_same(write(tmp_path, f"{h}x{w}.jpg", image(h, w, i),
                          [cv2.IMWRITE_JPEG_QUALITY, quality,
                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           SAMPLING[sampling]]))


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("extra", [
    (cv2.IMWRITE_JPEG_RST_INTERVAL, 1), (cv2.IMWRITE_JPEG_RST_INTERVAL, 7),
    (cv2.IMWRITE_JPEG_OPTIMIZE, 1),
    (cv2.IMWRITE_JPEG_OPTIMIZE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 3)])
def test_restart_intervals_and_optimised_tables(tmp_path, sampling, extra):
    for i, (h, w) in enumerate(SIZES):
        assert_same(write(tmp_path, f"{h}x{w}.jpg", image(h, w, 50 + i),
                          [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                           SAMPLING[sampling], *extra]))


@pytest.mark.parametrize("quality", [50, 95])
def test_grey(tmp_path, quality):
    for i, (h, w) in enumerate(SIZES):
        grey = image(h, w, 90 + i)[..., 1]
        assert_same(write(tmp_path, f"{h}x{w}.jpg", grey,
                          [cv2.IMWRITE_JPEG_QUALITY, quality,
                           cv2.IMWRITE_JPEG_RST_INTERVAL, 2 * (i % 2)]))


def test_flat_and_saturated_blocks(tmp_path):
    """Blocks that take the IDCT's DC-only shortcuts and clamp at 0 and
    255."""
    img = np.zeros((40, 56, 3), np.uint8)
    img[:, 20:] = 255
    img[10:30, 5:50] = (0, 255, 40)
    for q in (50, 100):
        assert_same(write(tmp_path, f"flat{q}.jpg", img,
                          [cv2.IMWRITE_JPEG_QUALITY, q]))


def patched(tmp_path, name, fn):
    """A cv2-written baseline file with its bytes changed by fn."""
    ok, buf = cv2.imencode(".jpg", image(24, 32, 7))
    path = tmp_path / name
    path.write_bytes(fn(bytearray(buf.tobytes())))
    return str(path)


def sof(data):
    return data.index(b"\xff\xc0")


def set_sof(marker):
    def fn(data):
        data[sof(data) + 1] = marker
        return bytes(data)
    return fn


def twelve_bit(data):
    data[sof(data) + 4] = 12
    return bytes(data)


def cmyk(data):
    seg = b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * 4, 8, 8, 8, 4) + bytes(
        sum(([i + 1, 0x11, 0] for i in range(4)), []))
    return b"\xff\xd8" + seg + b"\xff\xd9"


def exif_orientation(value):
    def fn(data):
        tiff = b"MM\x00\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1) \
            + struct.pack(">HHIHH", 0x0112, 3, 1, value, 0) \
            + struct.pack(">I", 0)
        body = b"Exif\x00\x00" + tiff
        app1 = b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body
        return bytes(data[:2]) + app1 + bytes(data[2:])
    return fn


@pytest.mark.parametrize("name,make,match", [
    ("progressive.jpg", None, "progressive"),
    ("arithmetic.jpg", set_sof(0xC9), "arithmetic"),
    ("lossless.jpg", set_sof(0xC3), "lossless"),
    ("twelve.jpg", twelve_bit, "12-bit"),
    ("cmyk.jpg", cmyk, "CMYK"),
    ("rotated.jpg", exif_orientation(6), "orientation 6"),
    ("s411.jpg", None, "sampling"),
])
def test_unsupported_kinds_raise_with_the_file_named(tmp_path, name, make,
                                                     match):
    if name == "progressive.jpg":
        path = write(tmp_path, name, image(24, 32, 3),
                     [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    elif name == "s411.jpg":
        path = write(tmp_path, name, image(24, 32, 3),
                     [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    else:
        path = patched(tmp_path, name, make)
    with pytest.raises(ValueError, match=match) as err:
        jpeg.imread(path)
    assert path in str(err.value)


def test_exif_orientation_1_reads_and_6_is_what_cv2_rotates(tmp_path):
    upright = patched(tmp_path, "o1.jpg", exif_orientation(1))
    assert_same(upright)
    rotated = cv2.imread(patched(tmp_path, "o6.jpg", exif_orientation(6)))
    assert rotated.shape == (32, 24, 3)  # cv2 applied the rotation


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(jpeg, "_lib", None)
    bad = tmp_path / "jpeg.cpp"
    bad.write_text("extern \"C\" int ucj_header( {\n")
    monkeypatch.setattr(jpeg, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="JPEG library build failed"):
        jpeg.library()
    assert jpeg._lib is None


# -- the committed TableTop fixture tree ------------------------------------

@pytest.fixture(scope="module")
def digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


def test_committed_jpegs_equal_cv2_and_the_digests(digests):
    fx = fixtures_module()
    files = fx.jpeg_files()
    assert files == sorted(digests["jpeg"])
    assert sum(f.endswith(".jpeg") for f in files) == 14
    for rel in files:
        path = os.path.join(FIXTURES, rel)
        if digests["jpeg"][rel] is None:
            with pytest.raises(ValueError, match="progressive"):
                jpeg.imread(path)
            continue
        want = cv2.imread(path)
        assert fx.array_digest(want) == digests["jpeg"][rel], rel
        got = jpeg.imread(path)
        np.testing.assert_array_equal(got, want, err_msg=rel)


@pytest.mark.parametrize("case", ["test", "train_rgbd_add",
                                  "train_crop224"])
def test_fixture_samples_equal_the_digests(digests, monkeypatch, case):
    """The JAX reader (cv2) gives the committed digests here, and the
    port's reader gives them with cv2 and PIL blocked."""
    fx = fixtures_module()
    only = {case: fx.CASES[case]}
    monkeypatch.setattr(fx, "CASES", only)
    want = {case: digests["samples"][case]}
    assert fx.sample_digests(jfactory.get_dataset, JConfig, FIXTURES) == want
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert fx.sample_digests(tfactory.get_dataset, TConfig, FIXTURES) == want
