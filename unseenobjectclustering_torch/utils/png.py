"""PNG decode and encode with the standard library's zlib and numpy.

The GPU machine has neither PIL nor OpenCV, and every PNG of the OCID/OSD
path (images, label maps) goes through this module.  Three readers give
the arrays the JAX package gets from its libraries:

  read_indexed   PIL's ``np.array(Image.open(p))``: the raw index array of
                 a palette image, uint8 grey or uint16 for 16-bit grey,
                 RGB / RGBA / grey+alpha channels (16-bit colour reduced to
                 its high byte, as PIL does);
  read_bgr       ``cv2.imread(p, cv2.IMREAD_COLOR)``: three BGR uint8
                 channels (grey and palette expanded, alpha dropped, 16-bit
                 reduced to the high byte);
  read_anydepth  ``cv2.imread(p, cv2.IMREAD_ANYDEPTH)`` of a grey image:
                 uint8 or uint16 as stored.

Colour types 0, 2, 3, 4 and 6 at bit depth 8 and 16 are read, and palette
images at 1, 2 and 4 bits too; every row filter (None, Sub, Up, Average,
Paeth).  Interlaced (Adam7) files raise NotImplementedError.

``write_png`` writes grey, RGB, RGBA or palette images at 8 or 16 bits,
with a chosen filter for every row (or one for all), one IDAT chunk;
``imwrite`` writes the very bytes of OpenCV 5.0's ``cv2.imwrite`` (libpng
with OpenCV's defaults) for a grey or BGR image.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGImage:
    """A decoded PNG: samples [H, W, C] (uint8 or uint16; palette indices
    for colour type 3), the colour type, bit depth and palette."""

    def __init__(self, samples: np.ndarray, color_type: int, bit_depth: int,
                 palette: Optional[np.ndarray]):
        self.samples = samples
        self.color_type = color_type
        self.bit_depth = bit_depth
        self.palette = palette


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of int16 byte arrays (left, up, up-left)."""
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftypes: np.ndarray, filt: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: [H, R] filtered bytes -> [H, R] uint8.

    A byte depends on the one bpp bytes to its left, the one above and the
    one above-left, so all groups of bpp bytes on one anti-diagonal
    (row + group = j) are independent: the loop walks the H + R/bpp - 1
    diagonals of a skewed copy, each step vectorized over its rows."""
    if ftypes.size and int(ftypes.max()) > 4:
        raise ValueError(f"unknown PNG row filter {int(ftypes.max())}")
    if not ftypes.any():
        return filt
    h, rb = filt.shape
    groups = rb // bpp
    ys = np.arange(h)[:, None]
    diag = ys + np.arange(groups)[None, :]
    f = np.zeros((h + groups - 1, h, bpp), np.int16)
    f[diag, ys] = filt.reshape(h, groups, bpp)
    # t[j + 2, y + 1] holds the bytes of (row y, group j - y); the zero
    # borders are the bytes before a row's start and above the first row
    t = np.zeros((h + groups + 1, h + 1, bpp), np.int16)
    kinds = ftypes.astype(np.int16)[:, None]
    sub, up, avg, paeth = ((kinds == i).astype(np.int16) for i in range(1, 5))
    for j in range(h + groups - 1):
        lo, hi = max(0, j - groups + 1), min(h - 1, j) + 1
        a = t[j + 1, lo + 1:hi + 1]
        b = t[j + 1, lo:hi]
        c = t[j, lo:hi]
        pred = (a * sub[lo:hi] + b * up[lo:hi] + ((a + b) >> 1) * avg[lo:hi]
                + _paeth(a, b, c) * paeth[lo:hi] + f[j, lo:hi])
        pred &= 255
        t[j + 2, lo + 1:hi + 1] = pred
    return t[diag + 2, ys + 1].reshape(h, rb).astype(np.uint8)


def decode(data: bytes) -> PNGImage:
    """Decode the bytes of a PNG file."""
    header = None
    palette = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, color_type, _, _, interlace = header
    if interlace:
        raise NotImplementedError("interlaced (Adam7) PNG files are not "
                                  "read")
    if color_type not in _CHANNELS:
        raise ValueError(f"PNG colour type {color_type}")
    if color_type == 3 and depth == 16:
        raise ValueError("palette PNG at bit depth 16")
    if depth not in (8, 16) and not (color_type == 3 and depth in (1, 2, 4)):
        raise NotImplementedError(f"PNG bit depth {depth} at colour type "
                                  f"{color_type}")
    if color_type == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    channels = _CHANNELS[color_type]
    bits = channels * depth
    row_bytes = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < height * (row_bytes + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, "
                         f"{height * (row_bytes + 1)} expected")
    rows = raw[:height * (row_bytes + 1)].reshape(height, row_bytes + 1)
    px = _unfilter(rows[:, 0], rows[:, 1:], max(bits // 8, 1))
    if depth == 16:
        samples = px.view(">u2").astype(np.uint16)
    elif depth == 8:
        samples = px
    else:
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((px[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(
            height, row_bytes * per_byte)[:, :width]
    return PNGImage(samples.reshape(height, width, channels), color_type,
                    depth, palette)


def read(path: str) -> PNGImage:
    with open(path, "rb") as f:
        return decode(f.read())


def _high_byte(samples: np.ndarray) -> np.ndarray:
    return (samples >> 8).astype(np.uint8) if samples.dtype == np.uint16 \
        else samples


def read_indexed(path: str) -> np.ndarray:
    """The array PIL gives for the file (``np.array(Image.open(path))``)."""
    im = read(path)
    if im.color_type == 0:
        return im.samples[..., 0]
    if im.color_type == 3:
        return im.samples[..., 0].astype(np.uint8)
    return _high_byte(im.samples)


def read_bgr(path: str) -> np.ndarray:
    """The array of ``cv2.imread(path, cv2.IMREAD_COLOR)``: [H, W, 3] BGR
    uint8."""
    im = read(path)
    s = im.samples
    if im.color_type == 3:
        rgb = im.palette[np.minimum(s[..., 0], len(im.palette) - 1)]
    elif im.color_type in (0, 4):
        rgb = np.repeat(_high_byte(s[..., :1]), 3, axis=-1)
    else:
        rgb = _high_byte(s[..., :3])
    return np.ascontiguousarray(rgb[..., ::-1])


def read_anydepth(path: str) -> np.ndarray:
    """The array of ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` for a grey
    PNG: [H, W] uint8 or uint16 as stored."""
    im = read(path)
    if im.color_type != 0:
        raise NotImplementedError("read_anydepth reads grey PNGs only (colour"
                                  f" type 0), got colour type {im.color_type}")
    return im.samples[..., 0]


def read_grey(path: str) -> np.ndarray:
    """The array of ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` for a grey
    PNG: [H, W] uint8 (16-bit reduced to its high byte, as libpng's
    strip_16 does)."""
    im = read(path)
    if im.color_type != 0:
        raise NotImplementedError("read_grey reads grey PNGs only (colour "
                                  f"type 0), got colour type {im.color_type}")
    return _high_byte(im.samples[..., 0])


_IMREAD = {"color": read_bgr, "anydepth": read_anydepth, "grey": read_grey}


def imread(path: str, mode: str = "color") -> np.ndarray:
    """``cv2.imread(path, flag)`` of a PNG for mode "color"
    (IMREAD_COLOR), "anydepth" (IMREAD_ANYDEPTH) or "grey"
    (IMREAD_GRAYSCALE).  Where cv2 returns None (a missing file, or one
    that is not a readable PNG) this raises IOError naming the file."""
    try:
        return _IMREAD[mode](path)
    except (OSError, ValueError, zlib.error) as e:
        raise IOError(f"cannot read {path} (missing or corrupt: {e})") from e


def _filter_rows(px: np.ndarray, ftypes: np.ndarray, bpp: int) -> np.ndarray:
    """Apply each row's filter to [H, R] uint8 bytes (predictors from the
    unfiltered bytes, so all rows at once)."""
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    k = ftypes.astype(np.int16)[:, None]
    pred = np.select([k == 1, k == 2, k == 3, k == 4],
                     [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
    return ((x - pred) & 255).astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _header_and_rows(array: np.ndarray, palette: Optional[np.ndarray],
                     filters: Union[int, Sequence[int]]
                     ) -> tuple[bytes, bytes]:
    """The IHDR body and the filtered scanlines (each row led by its filter
    type) of a PNG of `array` (see ``encode``)."""
    array = np.asarray(array)
    if array.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG samples are uint8 or uint16, got {array.dtype}")
    h, w = array.shape[:2]
    channels = 1 if array.ndim == 2 else array.shape[2]
    if palette is not None:
        if array.ndim != 2 or array.dtype != np.uint8:
            raise ValueError("a palette image takes [H, W] uint8 indices")
        color_type = 3
    else:
        color_type = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    depth = 8 * array.dtype.itemsize
    px = np.ascontiguousarray(array.astype(array.dtype.newbyteorder(">"))
                              ).view(np.uint8).reshape(h, w * channels
                                                       * depth // 8)
    ftypes = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    rows = np.concatenate(
        [ftypes[:, None], _filter_rows(px, ftypes, channels * depth // 8)],
        axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    return ihdr, rows.tobytes()


def encode(array: np.ndarray, palette: Optional[np.ndarray] = None,
           filters: Union[int, Sequence[int]] = 0, level: int = 6) -> bytes:
    """The bytes of a PNG of `array`: [H, W] grey (or palette indices when
    `palette`, [N, 3] uint8, is given), [H, W, 3] RGB or [H, W, 4] RGBA, in
    uint8 or uint16.  filters: one PNG filter type (0-4) for every row, or
    one per row."""
    ihdr, rows = _header_and_rows(array, palette, filters)
    out = [_SIGNATURE, _chunk(b"IHDR", ihdr)]
    if palette is not None:
        out.append(_chunk(b"PLTE",
                          np.asarray(palette, np.uint8).reshape(-1, 3)
                          .tobytes()))
    out.append(_chunk(b"IDAT", zlib.compress(rows, level)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def encode_cv2(array: np.ndarray) -> bytes:
    """The bytes that ``cv2.imwrite`` (OpenCV 5.0, its bundled libpng)
    writes for a [H, W] grey or [H, W, 3] BGR image, uint8 or uint16:
    every row Sub-filtered (None at width 1), zlib level 1 with the Z_RLE
    strategy and memLevel 8, libpng's window for small images (the
    smallest that holds the scanlines and 262 bytes, at least 2^9) and its
    rewrite of the zlib header to the smallest window the scanlines need,
    IDAT chunks of 8192 bytes."""
    array = np.asarray(array)
    if array.ndim == 3:
        if array.shape[2] != 3:
            raise ValueError(f"encode_cv2 takes grey or BGR, not "
                             f"{array.shape}")
        array = array[..., ::-1]
    # libpng drops Sub for a one-pixel-wide image (png_write_start_row)
    ihdr, rows = _header_and_rows(array, None, 1 if array.shape[1] > 1
                                  else 0)
    size = len(rows)
    wbits, half = 15, 1 << 14  # png_deflate_claim
    if size <= 16384:
        while size + 262 <= half:
            half >>= 1
            wbits -= 1
    wbits = max(wbits, 9)
    z = zlib.compressobj(1, zlib.DEFLATED, wbits, 8, zlib.Z_RLE)
    data = bytearray(z.compress(rows) + z.flush())
    if size <= 16384:  # optimize_cmf
        cinfo = data[0] >> 4
        half = 1 << (cinfo + 7)
        if size <= half:
            while cinfo > 0 and size <= half:
                half >>= 1
                cinfo -= 1
            data[0] = (data[0] & 0x0F) | (cinfo << 4)
            flg = data[1] & 0xE0
            data[1] = flg + 0x1F - ((data[0] << 8) + flg) % 0x1F
    idat = [_chunk(b"IDAT", bytes(data[i:i + 8192]))
            for i in range(0, len(data), 8192)]
    return b"".join([_SIGNATURE, _chunk(b"IHDR", ihdr)] + idat
                    + [_chunk(b"IEND", b"")])


def write_png(path: str, array: np.ndarray,
              palette: Optional[np.ndarray] = None,
              filters: Union[int, Sequence[int]] = 0) -> None:
    """Write `array` to `path` as a PNG (see ``encode``)."""
    data = encode(array, palette, filters)
    with open(path, "wb") as f:
        f.write(data)


def imwrite(path: str, array: np.ndarray) -> None:
    """``cv2.imwrite(path, array)`` of a grey or BGR PNG, byte for byte
    (``encode_cv2``)."""
    with open(path, "wb") as f:
        f.write(encode_cv2(array))
