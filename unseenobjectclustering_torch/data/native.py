"""ctypes binding of the native IO library (``native/ucio.cpp``).

Port of ``unseenobjectclustering_tpu/data/native.py`` with one difference:
nothing falls back quietly.  The library is built from ``native/ucio.cpp``
with ``g++ -O3 -fPIC -shared -std=c++17`` at first use, into
``unseenobjectclustering_torch/_build/`` under a name that carries a digest
of the source and flags (as ``ops/_build.py`` does for the CUDA kernels),
so an edited source is rebuilt and an unchanged one reused.  A missing
compiler, a failed build or a failed load raises.

The pure-Python versions in ``data/pcd.py`` (LZF, the strided gather) and
``ops/roi.py`` (the nearest paste) are the plain versions: callers ask for
them with ``native=False``, and the tests hold the two equal.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "ucio.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_P = ctypes.c_void_p
_L = ctypes.c_long
_SIGNATURES = {
    "ucio_lzf_decompress": ([_P, _L, _P, _L], _L),
    "ucio_extract_strided_f32": ([_P, _L, _L, _L, _P], None),
    "ucio_nearest_paste_nonzero": ([_P, _L, _L, _P, _L, _L, _L], None),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last build, if any


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile native/ucio.cpp unless a build of this source exists; return
    the library's path."""
    global build_seconds
    if not os.path.exists(SOURCE):
        raise RuntimeError(f"native IO library: no source at {SOURCE}")
    lib_path = os.path.join(BUILD_DIR, f"libucio_{_digest()}.so")
    if os.path.exists(lib_path):
        return lib_path
    cxx = shutil.which(os.environ.get("CXX") or "g++")
    if not cxx:
        raise RuntimeError("native IO library: no C++ compiler ($CXX or "
                           "g++) to build native/ucio.cpp with")
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}_{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError("native IO library build failed:\n$ "
                           + " ".join(cmd) + "\n" + out.stdout + out.stderr)
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """LZF decompression (the PCL binary_compressed codec); raises
    ValueError on a malformed stream."""
    src = np.frombuffer(data, np.uint8)
    out = np.empty(expected_size, np.uint8)
    n = library().ucio_lzf_decompress(_ptr(src), src.size, _ptr(out),
                                      expected_size)
    if n < 0:
        raise ValueError("malformed LZF stream")
    return out[:n].tobytes()


def extract_strided_f32(raw: bytes, n_points: int, stride: int,
                        offset: int) -> np.ndarray:
    """out[p] = float32 at raw[p * stride + offset] for p < n_points."""
    src = np.frombuffer(raw, np.uint8)
    if n_points and (n_points - 1) * stride + offset + 4 > src.size:
        raise ValueError(f"{n_points} records of {stride} bytes at offset "
                         f"{offset} overrun {src.size} bytes")
    out = np.empty(n_points, np.float32)
    library().ucio_extract_strided_f32(_ptr(src), n_points, stride, offset,
                                       _ptr(out))
    return out


def nearest_paste_nonzero(src: np.ndarray, dst_region: np.ndarray) -> None:
    """Nearest-resize src ([sh, sw]) onto dst_region ([dh, dw] int32, a view
    whose rows are contiguous) in place, where the resized value is > 0
    (legacy torch nearest: source index floor(dst * s / d))."""
    src = np.ascontiguousarray(src, np.int32)
    if (dst_region.dtype != np.int32 or dst_region.ndim != 2
            or src.ndim != 2 or dst_region.strides[1] != 4
            or dst_region.strides[0] % 4 or not dst_region.flags.writeable):
        raise ValueError("nearest_paste_nonzero takes a writeable 2-D int32 "
                         "region with contiguous rows and a 2-D source")
    if src.size == 0 or dst_region.size == 0:
        return
    library().ucio_nearest_paste_nonzero(
        _ptr(src), src.shape[0], src.shape[1], _ptr(dst_region),
        dst_region.shape[0], dst_region.shape[1],
        dst_region.strides[0] // 4)
