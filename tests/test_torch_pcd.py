"""The port's PCD IO (data/pcd.py) and native IO library (data/native.py,
built from native/ucio.cpp) against the JAX package and against their
plain Python versions: the three PCD encodings with NaNs, files written by
either package, extra fields, the LZF codec, the strided gather, the
stage-2 nearest paste, and a failed build.

Tolerance: none, every comparison is exact (NaNs in the same places).
"""

import os

import numpy as np
import pytest

from unseenobjectclustering_torch.data import native as tnative
from unseenobjectclustering_torch.data import pcd as tpcd
from unseenobjectclustering_torch.ops import roi as troi
from unseenobjectclustering_tpu.data import pcd as jpcd
from unseenobjectclustering_tpu.ops import roi as jroi

ENCODINGS = {"ascii": dict(binary=False), "binary": dict(binary=True),
             "binary_compressed": dict(compressed=True)}


def cloud(h=12, w=16, seed=0):
    """An organized cloud of a tilted plane with a box on it and NaNs where
    there is no depth, as the fixtures write them."""
    rng = np.random.RandomState(seed)
    ys, xs = np.indices((h, w), dtype=np.float32)
    z = 1.0 + 0.01 * ys + rng.rand(h, w).astype(np.float32) * 1e-3
    z[h // 4:h // 2, w // 4:w // 2] -= 0.1
    xyz = np.stack([(xs - w / 2) * z / 50, (ys - h / 2) * z / 50, z], -1)
    xyz[rng.rand(h, w) < 0.2] = np.nan
    return xyz.astype(np.float32)


def assert_same(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)  # NaN positions compared too


@pytest.mark.parametrize("encoding", list(ENCODINGS))
def test_port_and_jax_read_each_others_files(tmp_path, encoding):
    xyz = cloud()
    port, jax_ = tmp_path / "port.pcd", tmp_path / "jax.pcd"
    tpcd.save_pcd_xyz(port, xyz, **ENCODINGS[encoding])
    jpcd.save_pcd_xyz(jax_, xyz, **ENCODINGS[encoding])
    assert port.read_bytes() == jax_.read_bytes()
    want = jpcd.load_pcd_xyz(jax_)
    if encoding != "ascii":
        assert_same(want, xyz.reshape(-1, 3))
    for native in (True, False):
        assert_same(tpcd.load_pcd_xyz(jax_, native=native), want)
        assert_same(tpcd.load_pcd_xyz(port, native=native), want)


def test_extra_fields(tmp_path):
    """x y z rgb records, 16 bytes a point: the gather takes each field at
    its offset; binary_compressed stores the fields one after another."""
    xyz = cloud(seed=1).reshape(-1, 3)
    n = len(xyz)
    rgb = np.random.RandomState(2).randint(0, 2 ** 24, n).astype(np.uint32)
    head = ("VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F U\n"
            f"COUNT 1 1 1 1\nWIDTH {n}\nHEIGHT 1\nPOINTS {n}\n")
    rec = np.empty(n, [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                       ("rgb", "<u4")])
    rec["x"], rec["y"], rec["z"], rec["rgb"] = (*xyz.T, rgb)
    binary = tmp_path / "b.pcd"
    binary.write_bytes((head + "DATA binary\n").encode() + rec.tobytes())
    soa = b"".join(np.ascontiguousarray(rec[f]).tobytes()
                   for f in ("x", "y", "z", "rgb"))
    comp = jpcd.lzf_compress(soa)
    compressed = tmp_path / "c.pcd"
    compressed.write_bytes((head + "DATA binary_compressed\n").encode()
                           + np.array([len(comp), len(soa)], "<u4").tobytes()
                           + comp)
    for path in (binary, compressed):
        for native in (True, False):
            assert_same(tpcd.load_pcd_xyz(path, native=native), xyz)
        assert_same(tpcd.load_pcd_xyz(path), jpcd.load_pcd_xyz(path))


def lzf_inputs():
    rng = np.random.RandomState(3)
    return {
        "empty": b"", "short": b"ab", "zeros": bytes(20000),
        "random": rng.bytes(5000),
        "runs": bytes(np.repeat(rng.randint(0, 4, 400), 37).astype(np.uint8)),
        "cloud": np.ascontiguousarray(cloud(40, 60).reshape(-1, 3).T
                                      ).tobytes(),
        "far": rng.bytes(300) + rng.bytes(9000) + rng.bytes(300)}


@pytest.mark.parametrize("name", list(lzf_inputs()))
def test_lzf_codec(name):
    data = lzf_inputs()[name]
    comp = tpcd.lzf_compress(data)
    assert comp == jpcd.lzf_compress(data)
    assert tpcd.lzf_decompress(comp, len(data)) == data
    assert tpcd.lzf_decompress_py(comp, len(data)) == data
    assert jpcd._lzf_decompress_py(comp, len(data)) == data


def test_malformed_lzf_raises():
    comp = tpcd.lzf_compress(bytes(range(256)) * 4)
    for bad in (comp[:-5], bytes([0xE0, 0x05, 0x00]) + comp):
        for native in (True, False):
            with pytest.raises(ValueError, match="malformed"):
                tpcd.lzf_decompress(bad, 1024, native=native)


@pytest.mark.parametrize("stride,offset", [(12, 0), (12, 8), (16, 4),
                                           (7, 3)])
def test_strided_gather(stride, offset):
    rng = np.random.RandomState(stride + offset)
    n = 257
    raw = rng.bytes(n * stride)
    got = tnative.extract_strided_f32(raw, n, stride, offset)
    want = tpcd.extract_strided_py(raw, n, stride, offset,
                                   np.dtype("<f4"))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  np.ascontiguousarray(want).view(np.uint32))
    with pytest.raises(ValueError, match="overrun"):
        tnative.extract_strided_f32(raw, n + 1, stride, offset)


def paste_inputs(seed, m=6, s=16, h=40, w=56):
    """m crops of s x s vetoed labels (-1 vetoed, 0 background, ids), their
    RoIs overlapping each other and the frame's borders, order keys with a
    tie, one invalid slot."""
    rng = np.random.RandomState(seed)
    labels_veto = rng.randint(-1, 4, (m, s, s)).astype(np.int8)
    x0 = rng.randint(0, w - 8, m)
    y0 = rng.randint(0, h - 8, m)
    rois = np.stack([x0, y0, np.minimum(x0 + rng.randint(3, 30, m), w - 1),
                     np.minimum(y0 + rng.randint(3, 30, m), h - 1)],
                    1).astype(np.int32)
    order_key = rng.rand(m).astype(np.float32)
    order_key[1] = order_key[2]
    valid = np.ones(m, bool)
    valid[4] = False
    initial = rng.randint(0, m + 1, (h, w)).astype(np.int32)
    return initial, labels_veto, order_key, rois, valid


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("fallback", [False, True])
def test_native_paste_equals_the_numpy_paste(seed, fallback):
    initial, labels_veto, order_key, rois, valid = paste_inputs(seed)
    fb = initial if fallback else None
    args = (initial, labels_veto, order_key, rois, valid)
    native = troi.paste_back(*args, fallback_labels=fb)
    plain = troi.paste_back(*args, fallback_labels=fb, native=False)
    assert native.dtype == np.int32
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(
        native, jroi.paste_back(*args, fallback_labels=fb))
    assert (native > 0).any()


def test_paste_rejects_a_strided_region():
    dst = np.zeros((8, 8), np.int32)
    with pytest.raises(ValueError, match="contiguous rows"):
        tnative.nearest_paste_nonzero(np.ones((2, 2)), dst[:, ::2])


def test_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    bad = tmp_path / "ucio.cpp"
    bad.write_text("extern \"C\" long ucio_lzf_decompress( {\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.library()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        tnative.library()
    monkeypatch.setattr(tnative, "SOURCE", str(tmp_path / "missing.cpp"))
    with pytest.raises(RuntimeError, match="no source"):
        tnative.library()
    assert tnative._lib is None
    assert not os.listdir(tmp_path / "build")


def test_library_is_built_from_the_source():
    lib = tnative.library()
    path = tnative.build()
    assert os.path.basename(path).startswith("libucio_")
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert tnative.SOURCE.endswith(os.path.join("native", "ucio.cpp"))
    assert lib is tnative.library()
