#!/usr/bin/env python3
"""The seeding kernel of this tree against the kernel of another checkout
(the lazy tiles against the eager kernel they replace), on one NVIDIA GPU.

    python3 seeding_study.py [--parent DIR] [--clocks] [--out FILE]

Builds the port's kernels (and prints what ``nvcc -Xptxas -v`` reports for
every select_seeds_kernel: registers, spills) and, with --parent, the
csrc/seeding.cu of another checkout (say the parent commit, unpacked with
``git archive``) into a library of its own, called as its wrapper called
it.  On chip_smoke.py's inputs (its clustered embeddings, and random unit
vectors), m = 100 and first seed 12345 % n, at every shape the port
seeds: widths 64 and 128 at the 480x640 frame and both crop sides, each in
parity (float32) and fast mode (bfloat16 at stride 8), and at d = 128 the
frame's random unit vectors and its bfloat16 at stride 1.  Each case
prints the plan's path and tile, the share of lazy tiles refreshed a step
(mean, largest, over steps 1-98), the kernel against the plain version
(seeds equal or parting at a float32 near-tie below chip_smoke.SEED_GAP),
the parent's picks against this tree's (bitwise the same: both sum each
dot as one sequential float32 FMA chain), and device ms in turns (parent,
this tree, this tree, parent): chip_smoke.queued_ms (CUDA events around
10 queued calls) and chip_smoke.device_ms (torch.profiler).  Where the plan
re-reads pixels at stride 1 it also runs the torch model of the lazy
schedule (cuda_seeding.select_seeds_lazy_reference, 32-pixel tiles under
the plan's blocks and on-chip pixels) and prints its refreshed share: on
the lazy cases beside the kernel's; at d = 64, where the kernel stays
eager, the share the lazy path would refresh.  --clocks
builds seeding.cu again with -DSEED_CLOCKS and, on each lazy case, splits
the steps' time by phase (each block's clock64 at five points of every
step, in microseconds at the card's largest SM clock): the staging of the
previous step's block bests, the on-chip pixels with the threshold and the
refresh list, the refreshes, the reduction, and the wait at the grid
barrier; summed over the steps as the mean over the blocks and as the
slowest block's, with the tiles of each block's busiest warp.  --out
writes every reading as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

import chip_smoke as cs
from unseenobjectclustering_torch.ops import _build, cuda_seeding

REPS = 10


def nvcc(args: list[str]) -> str:
    out = subprocess.run([_build._nvcc(), *args], capture_output=True,
                         text=True)
    if out.returncode:
        raise RuntimeError(out.stdout + out.stderr)
    return out.stdout + out.stderr


def ptxas_lines() -> list[str]:
    """Registers and spills of each select_seeds_kernel of this tree."""
    log = nvcc([*_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                os.path.join(_build.CSRC, "seeding.cu"), "-o", os.devnull])
    lines, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and ("registers" in line or "spill" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def shared_lib(src: str, name: str, *defines: str) -> ctypes.CDLL:
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, name)
    nvcc([*_build.NVCC_FLAGS, *defines, "-shared", src, "-o", path])
    return ctypes.CDLL(path)


def parent_seeder(lib: ctypes.CDLL):
    """The parent's select_seeds as its wrapper called it: (x, m, first)
    -> seed indices."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uoc_select_seeds.argtypes = [P, I, I, I, ctypes.c_longlong, I, I, P,
                                     P, P, P]
    lib.uoc_select_seeds_plan.argtypes = [I, I, I, P]

    def run(x: torch.Tensor, m: int, first: int) -> torch.Tensor:
        n, d = x.shape
        code = _build.dtype_code(x, "parent")
        plan = (ctypes.c_longlong * 7)()
        assert lib.uoc_select_seeds_plan(code, n, d,
                                         ctypes.addressof(plan)) == 0
        scratch = torch.empty(m + 1, dtype=torch.int64, device=x.device)
        idx = torch.empty(m, dtype=torch.int32, device=x.device)
        xs_t = torch.empty(max(1, d * plan[0] * plan[6]), dtype=x.dtype,
                           device=x.device)
        err = lib.uoc_select_seeds(x.data_ptr(), code, n, d, x.stride(0), m,
                                   first, scratch.data_ptr(), idx.data_ptr(),
                                   xs_t.data_ptr(), _build.stream(x))
        assert err == 0, err
        return idx
    return run


def clocked_seeder(lib: ctypes.CDLL):
    """This tree's select_seeds from the -DSEED_CLOCKS build, called as the
    wrapper calls the kernel: (x, m, first) -> seed indices."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.uoc_select_seeds.argtypes = [P, I, I, I, ctypes.c_longlong, I, I, P,
                                     P, P, P]
    lib.uoc_select_seeds_plan.argtypes = [I, I, I, P]

    def run(x: torch.Tensor, m: int, first: int) -> torch.Tensor:
        n, d = x.shape
        code = _build.dtype_code(x, "x")
        plan = (ctypes.c_longlong * 10)()
        assert lib.uoc_select_seeds_plan(code, n, d,
                                         ctypes.addressof(plan)) == 0
        scratch = torch.empty(m + 1 + m // 2 + 2 * plan[0],
                              dtype=torch.int64, device=x.device)
        idx = torch.empty(m, dtype=torch.int32, device=x.device)
        xs_t = torch.empty(max(1, plan[9]), dtype=x.dtype, device=x.device)
        err = lib.uoc_select_seeds(x.data_ptr(), code, n, d, x.stride(0), m,
                                   first, scratch.data_ptr(), idx.data_ptr(),
                                   xs_t.data_ptr(), _build.stream(x))
        assert err == 0, err
        return idx
    return run


def phase_split(lib: ctypes.CDLL, grid: int, steps: int) -> dict:
    """Microseconds by phase of the last lazy launch of the clocked
    library, summed over the steps: mean over the blocks, slowest block."""
    torch.cuda.synchronize()
    buf = np.zeros((160, 128, 6), dtype=np.int64)
    lib.uoc_seed_clocks.argtypes = [ctypes.c_void_p]
    assert lib.uoc_seed_clocks(buf.ctypes.data) == 0
    c = buf[:grid, :steps].astype(np.float64)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    spans = {"stage_block_bests": c[..., 1] - c[..., 0],
             "on_chip_threshold_list": c[..., 2] - c[..., 1],
             "refreshes": c[..., 3] - c[..., 2],
             "reduce": c[..., 4] - c[..., 3],
             "grid_barrier": np.concatenate(
                 [c[:, 1:, 0] - c[:, :-1, 4], np.zeros((grid, 1))], 1)}
    out = {"sm_mhz": mhz}
    for name, v in spans.items():
        out[name] = {"mean_us": float(v.mean(0).sum() / mhz),
                     "slowest_us": float(v.max(0).sum() / mhz)}
    per_warp = np.ceil(c[..., 5] / 8)  # tiles of the busiest warp
    out["tiles_per_warp"] = {"mean": float(per_warp.mean(0).sum()),
                             "slowest": float(per_warp.max(0).sum())}
    return out


def units(n: int, d: int, seed: int) -> torch.Tensor:
    x = np.random.RandomState(seed).randn(n, d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x.astype(np.float32)).cuda()


def cases() -> list[tuple[str, torch.Tensor]]:
    """(name, x in its working type and stride) at the port's shapes: the
    inputs of chip_smoke.py's phases 2 (d = 64) and 2c (d = 128)."""
    sub = int(cs.FAST_CLUSTER["SEED_SUBSAMPLE"])
    shapes = [(cs.N, "frame")] + [(side * side, f"crop {side}")
                                  for side, _ in cs.crop_shapes()]
    out = []
    for d, seeds in ((cs.D, (0, 2, 3)), (cs.CAT_D, (20, 21, 22))):
        for (n, where), seed in zip(shapes, seeds):
            x = cs.clustered_embeddings(seed=seed, n=n, d=d)[0]
            out += [(f"{where} d{d} parity", x),
                    (f"{where} d{d} fast", x.bfloat16()[::sub])]
            if d == cs.CAT_D and n == cs.N:
                out += [(f"{where} d{d} parity uniform", units(n, d, 48)),
                        (f"{where} d{d} bf16 stride 1", x.bfloat16())]
    return out


def timed(fn) -> dict:
    return {"queued_ms": cs.queued_ms(fn, REPS),
            "device_ms": cs.device_ms(fn, "select_seeds_kernel", REPS)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--clocks", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    out = {"card": cs.card_line(), "cases": {}}
    print(out["card"])
    _build.library()
    out["ptxas"] = ptxas_lines()
    print("\n".join(out["ptxas"]))
    parent = None
    if args.parent:
        parent = parent_seeder(shared_lib(os.path.join(
            args.parent, "unseenobjectclustering_torch", "csrc",
            "seeding.cu"), "libparent_seeding.so"))
    clocked = None
    if args.clocks:
        clocked_lib = shared_lib(os.path.join(_build.CSRC, "seeding.cu"),
                                 "libseed_clocks.so", "-DSEED_CLOCKS")
        clocked = clocked_seeder(clocked_lib)
    ok = True
    for name, x in cases():
        n, d = x.shape
        m, first = cs.M, 12345 % n
        plan = cuda_seeding.launch_config(x)
        ours = lambda: cuda_seeding.select_seeds(x, m, first)  # noqa: E731
        _, idx = ours()
        counts = cuda_seeding.refreshed
        _, want = cuda_seeding.select_seeds_reference(x, m, first)
        step, gap = cs.seed_gap(x, idx, want)
        r = {"lazy": plan["lazy"], "tile_pixels": plan["tile_pixels"],
             "reread_pixels_per_block": plan["reread_pixels_per_block"],
             "differing_step": step, "gap": gap}
        ok &= step < 0 or gap < cs.SEED_GAP
        if counts is not None:
            r["refreshed_share"] = cuda_seeding.refresh_shares(counts)
            r["tiles"] = int(counts[0])
        if plan["reread_pixels_per_block"] and x.stride(0) == d:
            on_chip = (plan["pixels_per_block"]
                       - plan["reread_pixels_per_block"])
            _, model_idx, model_counts = (
                cuda_seeding.select_seeds_lazy_reference(
                    x, m, first, 32, plan["grid"], on_chip))
            r["model"] = dict(
                on_chip=on_chip, tiles=int(model_counts[0]),
                refreshed_share=cuda_seeding.refresh_shares(model_counts),
                same_as_plain=bool(torch.equal(model_idx, want)))
            if counts is not None:
                r["model"]["share_as_kernel"] = (
                    r["model"]["refreshed_share"] == r["refreshed_share"])
        if parent is not None:
            theirs = lambda: parent(x, m, first)  # noqa: E731
            r["same_as_parent"] = bool(torch.equal(theirs(), idx))
            ok &= r["same_as_parent"]
            runs = [("parent", theirs), ("this", ours), ("this", ours),
                    ("parent", theirs)]
        else:
            runs = [("this", ours)]
        for who, fn in runs:
            r.setdefault(who, []).append(timed(fn))
        if clocked is not None and plan["lazy"]:
            r["same_as_clocked"] = bool(torch.equal(clocked(x, m, first),
                                                    idx))
            r["phases"] = phase_split(clocked_lib, plan["grid"], m - 1)
        out["cases"][name] = r
        print(f"[{name}] n {n}: {json.dumps(r)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not ok:
        raise SystemExit("a kernel's seeds differ beyond a near-tie, or "
                         "from the parent's")


if __name__ == "__main__":
    main()
