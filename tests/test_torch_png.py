"""The port's PNG codec (unseenobjectclustering_torch/utils/png.py) against
PIL and OpenCV: every colour type and bit depth the datasets meet, files
written by PIL, by cv2 and by the port, every row filter, and the round
trip.

read_indexed is held to PIL's ``np.array(Image.open(p))``, read_bgr to
``cv2.imread(p, cv2.IMREAD_COLOR)`` and read_anydepth to
``cv2.imread(p, cv2.IMREAD_ANYDEPTH)``.  Tolerance: none, every array is
compared exactly (dtype included).
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from unseenobjectclustering_torch.utils import masks as tmasks
from unseenobjectclustering_torch.utils import png

H, W = 13, 17  # odd sizes: sub-byte rows end mid-byte


def _random(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


def _smooth(shape, seed=0):
    """An image with local structure, like a photograph's."""
    rng = np.random.RandomState(seed)
    x = np.cumsum(rng.randint(-4, 5, shape), axis=1)
    x = np.cumsum(x, axis=0) // 4 + 128
    return np.clip(x, 0, 255).astype(np.uint8)


def _check(path, indexed=True, bgr=True):
    if indexed:
        want = np.array(Image.open(path))
        got = png.read_indexed(str(path))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if bgr:
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)
        got = png.read_bgr(str(path))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,dtype,channels", [
    ("L", np.uint8, 0), ("I;16", np.uint16, 0), ("RGB", np.uint8, 3),
    ("RGBA", np.uint8, 4), ("LA", np.uint8, 2)])
def test_files_written_by_pil(tmp_path, mode, dtype, channels):
    shape = (H, W) if channels == 0 else (H, W, channels)
    arr = _random(shape, dtype)
    path = tmp_path / "pil.png"
    Image.fromarray(arr, mode=None if mode != "LA" else "LA").save(path)
    _check(path)
    if channels == 0:
        want = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH)
        got = png.read_anydepth(str(path))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colors", [2, 4, 16, 200, 256])
def test_palette_files_written_by_pil(tmp_path, colors):
    """PIL stores a palette of at most 2/4/16 colours at 1/2/4 bits."""
    rng = np.random.RandomState(colors)
    idx = rng.randint(0, colors, (H, W)).astype(np.uint8)
    im = Image.fromarray(idx, mode="P")
    im.putpalette(rng.randint(0, 256, 3 * colors).astype(np.uint8).tolist())
    path = tmp_path / "pal.png"
    im.save(path)
    _check(path)


@pytest.mark.parametrize("shape,dtype", [
    ((H, W), np.uint8), ((H, W), np.uint16), ((H, W, 3), np.uint8),
    ((H, W, 3), np.uint16), ((H, W, 4), np.uint8), ((H, W, 4), np.uint16)])
def test_files_written_by_cv2(tmp_path, shape, dtype):
    path = tmp_path / "cv2.png"
    cv2.imwrite(str(path), _random(shape, dtype, seed=3))
    _check(path)
    if len(shape) == 2:
        np.testing.assert_array_equal(
            png.read_anydepth(str(path)),
            cv2.imread(str(path), cv2.IMREAD_ANYDEPTH))


@pytest.mark.parametrize("flag,kinds", [
    ("IMWRITE_PNG_FILTER_NONE", {0}), ("IMWRITE_PNG_FILTER_SUB", {1}),
    ("IMWRITE_PNG_FILTER_UP", {2}), ("IMWRITE_PNG_FILTER_AVG", {3}),
    ("IMWRITE_PNG_FILTER_PAETH", {4}), ("IMWRITE_PNG_ALL_FILTERS", None)])
def test_filters_written_by_cv2(tmp_path, flag, kinds):
    """A photograph-like 120x160 frame written by libpng with one filter,
    or with its adaptive choice among all five."""
    path = tmp_path / "frame.png"
    cv2.imwrite(str(path), _smooth((120, 160, 3)),
                [cv2.IMWRITE_PNG_FILTER, getattr(cv2, flag)])
    data = path.read_bytes()
    idat = b"".join(body for kind, body in png._chunks(data)
                    if kind == b"IDAT")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(120, -1)
    used = set(rows[:, 0].tolist())
    assert used == kinds if kinds else len(used) > 1
    _check(path, indexed=False)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "cycle", "random"])
@pytest.mark.parametrize("shape,dtype", [
    ((H, W), np.uint8), ((H, W), np.uint16), ((H, W, 3), np.uint8),
    ((H, W, 3), np.uint16), ((H, W, 4), np.uint8), ((H, W, 2), np.uint8)])
def test_round_trip_with_a_chosen_filter_per_row(tmp_path, filters, shape,
                                                 dtype):
    arr = _random(shape, dtype, seed=7)
    if filters == "cycle":
        filters = [i % 5 for i in range(H)]
    elif filters == "random":
        filters = np.random.RandomState(1).randint(0, 5, H).tolist()
    path = tmp_path / "port.png"
    png.write_png(str(path), arr, filters=filters)
    im = png.read(str(path))
    assert im.samples.dtype == dtype
    np.testing.assert_array_equal(im.samples.reshape(arr.shape), arr)
    _check(path)


def test_round_trip_of_a_frame(tmp_path):
    bgr = _smooth((48, 64, 3), seed=2)
    path = tmp_path / "bgr.png"
    png.imwrite(str(path), bgr)
    np.testing.assert_array_equal(png.read_bgr(str(path)), bgr)
    np.testing.assert_array_equal(cv2.imread(str(path)), bgr)


def test_indexed_labels_equal_pil(tmp_path):
    """utils/masks writes through the port's encoder: PIL reads back the
    index array and the palette that PIL's own writer stores."""
    rng = np.random.RandomState(4)
    labels = rng.randint(0, 30, (H, W)).astype(np.uint8)
    tmasks.imwrite_indexed(str(tmp_path / "port.png"), labels)
    im = Image.fromarray(labels)
    im.putpalette(tmasks.default_palette().ravel())
    im.save(tmp_path / "pil.png")
    port, pil = (Image.open(tmp_path / n) for n in ("port.png", "pil.png"))
    assert port.mode == pil.mode == "P"
    np.testing.assert_array_equal(np.array(port), np.array(pil))
    assert port.getpalette() == pil.getpalette()
    np.testing.assert_array_equal(
        tmasks.imread_indexed(str(tmp_path / "pil.png")), labels)


def test_demo_labels(tmp_path):
    """The repository's hand-annotated demo labels read as PIL reads
    them."""
    import glob
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = sorted(glob.glob(os.path.join(root, "data", "demo_gt",
                                          "*-label.png")))
    assert paths
    for p in paths[:3]:
        np.testing.assert_array_equal(png.read_indexed(p),
                                      np.array(Image.open(p)))


def _with_ihdr(data: bytes, **changes) -> bytes:
    """The PNG with its IHDR fields changed (CRC recomputed)."""
    fields = dict(zip(("width", "height", "depth", "color", "compression",
                       "filter", "interlace"),
                      struct.unpack(">IIBBBBB", data[16:29])))
    fields.update(changes)
    body = struct.pack(">IIBBBBB", *fields.values())
    return (data[:16] + body + struct.pack(">I", zlib.crc32(b"IHDR" + body))
            + data[33:])


def test_rejects_what_it_does_not_read(tmp_path):
    data = png.encode(_random((H, W), np.uint8))
    with pytest.raises(NotImplementedError, match="interlaced"):
        png.decode(_with_ihdr(data, interlace=1))
    with pytest.raises(NotImplementedError, match="bit depth"):
        png.decode(_with_ihdr(data, depth=4))
    broken = bytearray(data)
    broken[40] ^= 0xFF
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(broken))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + data[6:])
    rgb = tmp_path / "rgb.png"
    png.write_png(str(rgb), _random((H, W, 3), np.uint8))
    with pytest.raises(NotImplementedError, match="grey"):
        png.read_anydepth(str(rgb))
