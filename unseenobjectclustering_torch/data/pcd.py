"""Minimal PCD (Point Cloud Data) reader and writer.

Port of ``unseenobjectclustering_tpu/data/pcd.py`` (which replaces the
reference's python-pcl ``pcl.load(...).to_array()``,
lib/datasets/ocid_object.py:104-112, osd_object.py:94-100): PCD v0.7 in the
ascii, binary and binary_compressed (LZF) encodings; the x/y/z float32
fields as [N, 3], NaNs kept.

The binary gather and the LZF decompression go through the native library
(``data/native.py``, built from ``native/ucio.cpp``) unless the caller asks
for the plain Python versions with ``native=False``; a native failure
raises.  binary_compressed files store their fields one after another
(all x, all y, all z) after LZF, not interleaved per point.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from unseenobjectclustering_torch.data import native as _native

_HEADER_FIELDS = ("VERSION", "FIELDS", "SIZE", "TYPE", "COUNT", "WIDTH",
                  "HEIGHT", "VIEWPOINT", "POINTS", "DATA")


def _parse_header(f) -> dict:
    header: dict = {}
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PCD header")
        line = line.decode("ascii", errors="replace").strip()
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        key = key.upper()
        if key in _HEADER_FIELDS:
            header[key] = rest.split()
        if key == "DATA":
            header["DATA"] = rest.strip()
            break
    for req in ("FIELDS", "SIZE", "TYPE", "COUNT", "POINTS", "DATA"):
        if req not in header:
            raise ValueError(f"PCD header missing {req}")
    return header


def lzf_decompress(data: bytes, expected_size: int,
                   native: bool = True) -> bytes:
    """LZF decompression (the PCL binary_compressed codec): the native
    library, or the plain Python loop with native=False."""
    if native:
        return _native.lzf_decompress(data, expected_size)
    return lzf_decompress_py(data, expected_size)


def lzf_decompress_py(data: bytes, expected_size: int) -> bytes:
    """Pure-Python LZF decompression (the plain version)."""
    out = bytearray(expected_size)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            length = ctrl + 1
            if i + length > n or o + length > expected_size:
                raise ValueError("malformed LZF stream")
            out[o:o + length] = data[i:i + length]
            i += length
            o += length
        else:          # back reference
            length = ctrl >> 5
            if i + (length == 7) >= n:
                raise ValueError("malformed LZF stream")
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            length += 2
            if ref < 0 or o + length > expected_size:
                raise ValueError("malformed LZF stream")
            for _ in range(length):  # may overlap; byte-by-byte copy
                out[o] = out[ref]
                o += 1
                ref += 1
    return bytes(out[:o])


def lzf_compress(data: bytes) -> bytes:
    """LZF compression (the codec's encoder side), byte for byte the JAX
    package's: control bytes < 32 start a literal run of ctrl+1 bytes;
    otherwise a back reference of (ctrl >> 5) + 2 bytes (7 -> + an extra
    length byte) at offset ((ctrl & 0x1F) << 8 | next) + 1."""
    n = len(data)
    out = bytearray()
    htab: dict[bytes, int] = {}
    i = 0
    lit = 0  # start of the pending literal run

    def flush(end: int) -> None:
        s = lit
        while s < end:
            run = min(32, end - s)
            out.append(run - 1)
            out.extend(data[s:s + run])
            s += run

    while i < n - 2:
        key = data[i:i + 3]
        ref = htab.get(key, -1)
        htab[key] = i
        off = i - ref - 1
        if ref >= 0 and off < 8192:
            max_len = min(n - i, 264)  # 2 + 7 + 255
            length = 3
            while length < max_len and data[ref + length] == data[i + length]:
                length += 1
            flush(i)
            enc = length - 2
            if enc < 7:
                out.append((enc << 5) | (off >> 8))
            else:
                out.append((7 << 5) | (off >> 8))
                out.append(enc - 7)
            out.append(off & 0xFF)
            i += length
            lit = i
        else:
            i += 1
    flush(n)
    return bytes(out)


def extract_strided_py(raw: bytes, n_points: int, stride: int, offset: int,
                       dtype: np.dtype) -> np.ndarray:
    """One field of packed per-point records as a strided numpy view (the
    plain version of the native gather)."""
    return np.ndarray((n_points,), dtype=dtype, buffer=raw, offset=offset,
                      strides=(stride,))


def _numpy_dtype(type_char: str, size: int) -> np.dtype:
    return np.dtype({"F": f"<f{size}", "I": f"<i{size}",
                     "U": f"<u{size}"}[type_char])


def load_pcd_xyz(path: str | os.PathLike, native: bool = True) -> np.ndarray:
    """Read a PCD file and return its x, y, z fields as [N, 3] float32.

    NaNs are kept (callers zero them, as lib/datasets/ocid_object.py:106
    does).  native=False reads through the plain Python versions."""
    with open(path, "rb") as f:
        header = _parse_header(f)
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        points = int(header["POINTS"][0])
        data_kind = header["DATA"].lower()

        offsets, offset = [], 0
        for sz, cnt in zip(sizes, counts):
            offsets.append(offset)
            offset += sz * cnt
        point_size = offset

        if data_kind == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, ndmin=2)
            col_index, col = {}, 0
            for name, cnt in zip(fields, counts):
                col_index[name] = col
                col += cnt
            return np.stack([rows[:, col_index[name]]
                             for name in ("x", "y", "z")],
                            axis=1).astype(np.float32)

        if data_kind == "binary":
            raw = f.read(point_size * points)
            if len(raw) < point_size * points:
                raise ValueError(f"{path}: {len(raw)} bytes of binary data, "
                                 f"{point_size * points} expected")
            out = np.empty((points, 3), np.float32)
            for j, name in enumerate(("x", "y", "z")):
                i = fields.index(name)
                off, sz, tc = offsets[i], sizes[i], types[i]
                if native and tc == "F" and sz == 4:
                    out[:, j] = _native.extract_strided_f32(
                        raw, points, point_size, off)
                else:
                    out[:, j] = extract_strided_py(
                        raw, points, point_size, off, _numpy_dtype(tc, sz))
            return out

        if data_kind == "binary_compressed":
            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            raw = lzf_decompress(f.read(comp_size), uncomp_size, native)
            if len(raw) != uncomp_size:
                raise ValueError(f"{path}: LZF gave {len(raw)} bytes, "
                                 f"{uncomp_size} expected")
            out = np.empty((points, 3), np.float32)
            field_off = 0
            for name, sz, tc, cnt in zip(fields, sizes, types, counts):
                if name in ("x", "y", "z"):
                    arr = np.frombuffer(raw, dtype=_numpy_dtype(tc, sz),
                                        count=points, offset=field_off)
                    out[:, ("x", "y", "z").index(name)] = arr
                field_off += sz * cnt * points
            return out

    raise ValueError(f"unsupported PCD DATA encoding: {data_kind}")


def save_pcd_xyz(path: str | os.PathLike, xyz: np.ndarray,
                 width: int | None = None, height: int | None = None,
                 binary: bool = True, compressed: bool = False) -> None:
    """Write an [N, 3] (or [H, W, 3], organized) float32 cloud as a PCD
    file, as the JAX package's save_pcd_xyz does: ascii, binary, or with
    compressed=True binary_compressed (LZF over the x/y/z fields stored one
    after another, with the <compressed size, uncompressed size> prefix),
    the format the real OCID/OSD datasets ship."""
    if xyz.ndim == 3:
        height, width = xyz.shape[:2]
        xyz = xyz.reshape(-1, 3)
    n = xyz.shape[0]
    width = width or n
    height = height or 1
    kind = "binary_compressed" if compressed else (
        "binary" if binary else "ascii")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {width}\nHEIGHT {height}\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\nDATA {kind}\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if compressed:
            soa = np.ascontiguousarray(
                np.asarray(xyz, np.float32).T).tobytes()
            comp = lzf_compress(soa)
            f.write(struct.pack("<II", len(comp), len(soa)))
            f.write(comp)
        elif binary:
            f.write(np.ascontiguousarray(xyz, np.float32).tobytes())
        else:
            np.savetxt(f, xyz, fmt="%.8g")
