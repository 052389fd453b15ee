"""Build and load the port's hand-written CUDA kernels.

The sources under ``unseenobjectclustering_torch/csrc`` are compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` (one nvcc per source, all
started together) and linked into one shared library with a plain C
interface, loaded with ctypes.  The build happens at first use, into
``unseenobjectclustering_torch/_build/`` (listed in .gitignore); the library's
name carries a digest of the sources and flags, so an edited source is
rebuilt and an unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("seeding.cu", "mean_shift.cu")
HEADERS = ("common.cuh",)
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "uoc_select_seeds": [_P, _I, _I, _I, ctypes.c_longlong, _I, _I, _P, _P,
                         _P, _P],
    "uoc_select_seeds_plan": [_I, _I, _I, _P],
    "uoc_hill_climb": [_P, _I, _I, _I, _P, _I, _F, _I, _P, _P, _P, _P],
    "uoc_hill_climb_plan": [_I, _I, _I, _I, _P],
    "uoc_connected_components": [_P, _I, _I, _F, _P, _P, _P],
    "uoc_connected_components_plan": [_I, _I, _P],
    "uoc_assign_labels": [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P],
    "uoc_assign_labels_passes": [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P,
                                 _P, _P],
    "uoc_assign_labels_plan": [_I, _I, _I, _I, _P],
}
# entries that return a kernel's name (a C string, null on a failed plan)
_NAMED = {
    "uoc_assign_labels_kernel": [_I, _I, _I, _I],
    "uoc_connected_components_kernel": [_I, _I],
}
# The kernels' instantiated widths: NUM_UNITS (64 in every recipe),
# 2 * NUM_UNITS (the RGB-D cat fusion) and the cat fusion of two 128-unit
# heads.  A narrower embedding runs on the next of them with zero columns
# appended (kernel_width, pad_columns).
WIDTHS = (64, 128, 256)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last build, if any


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the card")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))


def build() -> str:
    """Compile the kernels if no build of these sources exists; return the
    library's path."""
    global build_seconds
    lib_path = os.path.join(BUILD_DIR, f"libuoc_kernels_{_digest()}.so")
    if os.path.exists(lib_path):
        return lib_path
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}.{tag}.o")
            for s in SOURCES]
    _run_all([[nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, s), "-o", o]
              for s, o in zip(SOURCES, objs)])
    tmp = f"{lib_path}.{tag}.tmp"
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
    os.replace(tmp, lib_path)
    for o in objs:
        os.remove(o)
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, argtypes in _NAMED.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_char_p
            lib.uoc_error_string.argtypes = [ctypes.c_int]
            lib.uoc_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = library().uoc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def plan(device: torch.device, entry: str, *args: int,
         names: tuple[str, ...]) -> dict[str, int]:
    """The launch configuration that a kernel's ``*_plan`` entry gives for
    these arguments on `device` (an int64 per name), computed once."""
    return dict(zip(names, _plan(device.index, entry, args, len(names))))


@functools.lru_cache(maxsize=128)
def _plan(device: int, entry: str, args: tuple[int, ...],
          count: int) -> tuple[int, ...]:
    out = (ctypes.c_longlong * count)()
    with torch.cuda.device(device):
        check(getattr(library(), entry)(*args, ctypes.addressof(out)), entry)
    return tuple(int(v) for v in out)


@functools.lru_cache(maxsize=128)
def kernel_name(device: torch.device, entry: str, *args: int) -> str:
    """The name of the kernel that a ``*_kernel`` entry picks for these
    arguments on `device`."""
    with torch.cuda.device(device.index):
        name = getattr(library(), entry)(*args)
    if name is None:
        raise ValueError(f"{entry}: no kernel for {args}")
    return name.decode()


def dtype_code(x: torch.Tensor, what: str) -> int:
    """The kernels' element-type code for x: 0 float32, 1 bfloat16."""
    if x.dtype == torch.float32:
        return 0
    if x.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"{what}: the kernel takes float32 or bfloat16, "
                    f"got {x.dtype}")


def kernel_width(what: str, d: int) -> int:
    """The instantiated width that serves embedding width d: 64 for d in
    1..64, 128 for d in 65..128, 256 for d in 129..256; raise above 256."""
    for width in WIDTHS:
        if 1 <= d <= width:
            return width
    raise ValueError(f"{what}: the kernel takes widths 1..{WIDTHS[-1]}, "
                     f"got {d}")


def pad_columns(x: torch.Tensor, width: int) -> torch.Tensor:
    """x ([n, d], d <= width) with width - d zero columns appended, as one
    new contiguous tensor; x itself when d == width.  Zero columns are exact
    for the cosine kernels: every added product is 0 * 0, an fp32 FMA chain
    over them keeps its value (fmaf(0, 0, acc) = acc), norms do not change,
    and the hill climb's W X leaves them at 0."""
    n, d = x.shape
    if d == width:
        return x
    out = x.new_zeros((n, width))
    out[:, :d] = x
    return out


def on_device(what: str, x: torch.Tensor, *others: torch.Tensor | None
              ) -> None:
    """Raise unless x lies on the current device, where the kernels launch,
    and every other tensor given lies with it."""
    if x.get_device() != torch.cuda.current_device():
        raise ValueError(f"{what}: tensor on {x.device}, current device "
                         f"cuda:{torch.cuda.current_device()}")
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f"{what}: tensors on {x.device} and {t.device}")


def stream(x: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on x's device (the raw handle:
    ``torch.cuda.current_stream`` builds a Stream object, which costs more
    host time than a small kernel's launch)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())
