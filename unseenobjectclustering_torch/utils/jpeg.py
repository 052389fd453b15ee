"""JPEG reading without OpenCV: ``imread(path)`` returns the very array of
``cv2.imread(path)`` (IMREAD_COLOR: [H, W, 3] uint8 BGR) for the files
``cv2.imwrite`` writes and the TableTop dataset holds.

The decoder is host C++ (``unseenobjectclustering_torch/csrc/jpeg.cpp``),
built with g++ at first use into ``_build/`` by ``data/native.load_once``
and loaded through ctypes; a missing compiler or a failed build raises,
and nothing falls back to another decoder.  It replicates libjpeg-turbo
3.1.2 as OpenCV 5.0 drives it: sequential Huffman frames (baseline and
extended, 8-bit), grey or YCbCr, 4:4:4 / 4:2:2 / 4:4:0 / 4:2:0, restart
intervals, the JDCT_ISLOW integer IDCT, fancy upsampling and jdcolor's
fixed-point YCbCr -> BGR.  Progressive, arithmetic-coded, lossless and
12-bit files, CMYK, other sampling layouts and an EXIF orientation other
than 1 raise ``ValueError`` naming the file.  Huffman decoding is
sequential, which is why this is C++ and not numpy.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from unseenobjectclustering_torch.data import native

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "jpeg.cpp")

_P = ctypes.c_void_p
_L = ctypes.c_long
_SIGNATURES = {
    "ucj_header": ([_P, _L, _P, _P, _L], ctypes.c_int),
    "ucj_decode": ([_P, _L, _P, _P, _L], ctypes.c_int),
}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last build, if any


def library() -> ctypes.CDLL:
    """The loaded decoder (built on first call)."""
    return native.load_once(globals(), "libucjpeg", _SIGNATURES,
                            "JPEG library")


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The BGR uint8 [H, W, 3] image of a JPEG byte string; ValueError,
    naming `name`, for a file the decoder does not take."""
    lib = library()
    src = np.frombuffer(data, np.uint8)
    err = ctypes.create_string_buffer(256)
    hw = np.zeros(2, np.intc)
    if lib.ucj_header(src.ctypes.data, src.size, hw.ctypes.data, err,
                      len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((int(hw[0]), int(hw[1]), 3), np.uint8)
    if lib.ucj_decode(src.ctypes.data, src.size, out.ctypes.data, err,
                      len(err)) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def imread(path: str) -> np.ndarray:
    """``cv2.imread(path)`` of a JPEG file: [H, W, 3] uint8 BGR."""
    with open(path, "rb") as f:
        return decode(f.read(), path)
