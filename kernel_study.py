"""What seeding_study.py and hill_climb_study.py share, on one NVIDIA GPU:
nvcc builds of one CUDA source (the port's, or another checkout's) into a
ctypes library, ptxas's report of registers and spills, the inputs at the
shapes the port clusters, the timing of one call in turns, and the split
of a clocked build's time into spans.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from unseenobjectclustering_torch.ops import _build

REPS = 10


def nvcc(args: list[str]) -> str:
    """nvcc with the port's flags and `args`; its output, or raises."""
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *args],
                         capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    return out.stdout + out.stderr


def ptxas_lines(log: str, keep: str) -> list[str]:
    """Registers and spills of each kernel whose name holds `keep`, from
    the output of a build with -Xptxas -v."""
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and keep in name and ("registers" in line
                                        or "spill" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def ptxas(src: str, keep: str) -> list[str]:
    """ptxas_lines of `src` compiled with the port's flags."""
    return ptxas_lines(nvcc(["-Xptxas", "-v", "-c", src, "-o", os.devnull]),
                       keep)


def shared_lib(src: str, name: str, *defines: str
               ) -> tuple[ctypes.CDLL, str]:
    """`src` (a .cu file) built with `defines` into the port's build
    directory as `name` and loaded; and the build's ptxas report."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, name)
    log = nvcc([*defines, "-Xptxas", "-v", "-shared", src, "-o", path])
    return ctypes.CDLL(path), log


def units(n: int, d: int, seed: int) -> torch.Tensor:
    """[n, d] random unit vectors on the card, from a seed."""
    x = np.random.RandomState(seed).randn(n, d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x.astype(np.float32)).cuda()


def clustered_inputs() -> list[tuple[str, int, int, torch.Tensor]]:
    """(where, width, seed, float32 X) at every shape the port clusters:
    chip_smoke.py's clustered embeddings of phase 2 (d = 64) and phase 2c
    (d = 128) at the 480x640 frame and both crop sides."""
    shapes = [(cs.N, "frame")] + [(side * side, f"crop {side}")
                                  for side, _ in cs.crop_shapes()]
    out = []
    for d, seeds in ((cs.D, (0, 2, 3)), (cs.CAT_D, (20, 21, 22))):
        for (n, where), seed in zip(shapes, seeds):
            out.append((where, d, seed,
                        cs.clustered_embeddings(seed=seed, n=n, d=d)[0]))
    return out


def timed(fn, kernel: str) -> dict:
    """One turn of fn's timing: chip_smoke.queued_ms (CUDA events around
    REPS queued calls) and chip_smoke.device_ms (torch.profiler, the
    device kernels whose name holds `kernel`)."""
    return {"queued_ms": cs.queued_ms(fn, REPS),
            "device_ms": cs.device_ms(fn, kernel, REPS)}


def clocks(lib: ctypes.CDLL, entry: str, shape: tuple) -> np.ndarray:
    """The clock64 marks that the last launch of a clocked build left in
    its device array, copied out by `entry`."""
    torch.cuda.synchronize()
    buf = np.zeros(shape, dtype=np.int64)
    getattr(lib, entry).argtypes = [ctypes.c_void_p]
    assert getattr(lib, entry)(buf.ctypes.data) == 0
    return buf


def span_us(spans: dict[str, np.ndarray]) -> dict:
    """Each span ([blocks, steps] of cycles) in microseconds at the card's
    largest SM clock, summed over the steps: the mean over the blocks and
    the slowest block's."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    out: dict = {"sm_mhz": mhz}
    for name, v in spans.items():
        out[name] = {"mean_us": float(v.mean(0).sum() / mhz),
                     "slowest_us": float(v.max(0).sum() / mhz)}
    return out
