#!/usr/bin/env python3
"""How fast the assignment kernels are, and the float32 width-128 kernel's
arithmetic emulated on the CPU.

    python3 assign_study.py time [--parent DIR] [--clocks] [--out FILE]
                                                   # on one NVIDIA GPU

`time` builds the port's kernels (and prints what ``nvcc -Xptxas -v``
reports for every assignment kernel: registers, spills, and ptxas's
notes on serialized wgmmas) and, with --parent, the csrc/mean_shift.cu of
another checkout (say the parent commit, unpacked with ``git archive``)
into a library of its own, called through the same C entry point.  At
every shape the port assigns (widths 64 and 128; the 480x640 frame and
both crop sides; parity, float32, and fast mode, bfloat16), on
chip_smoke.py's clustered input and on random unit vectors, with m = 100
seeds from the port's own seeding, hill climb and connected components
(fast mode seeding every SEED_SUBSAMPLE-th pixel) and, at the frame, a
depth mask (90% valid, from a seed), it prints for each tree the labels
and both histograms against the plain version, the count of re-checked
pixels, whether the labels and histograms are bitwise the parent's, and
times in turns (parent, this tree, this tree, parent):
chip_smoke.queued_ms (CUDA events around 10 queued calls),
chip_smoke.device_ms (torch.profiler), and the cost with the host in it
(host_cost: the median of CUDA events around 200 single calls, and the
host's time to queue a call).  --clocks builds mean_shift.cu
again with -DASSIGN_CLOCKS and, on each case at width 128, splits
assign_tf32_wide_kernel's or assign_bf16_wide_kernel's time (each
block's clock64 marks, in microseconds at the card's largest SM clock,
the mean over the blocks and the slowest block's): the fixed cost (Z's
staging, the histograms' flush), the tiles, and for each consumer
warpgroup (float32) its tiles' wait for a tile, the A split (both
passes, with the first pass's wgmma issue) and the wgmmas from the second
pass's issue to their end, or (bf16) its claim of a tile with the wait
for it, the wgmmas' issue and the wgmmas to their end, then thread_best and
merge_quad, the re-check and the labels and histograms, and how much
later than the first it ends; the producer's wait for free stages; and
the dynamic shared memory's base address modulo 1024; and, in float32,
the host's microseconds per encode of the kernel's tensor map (map_us).  --out
writes every reading as JSON.

The emulation (`emulate_s`, `emulate_assign`; tests/test_torch_assign_wide.py
runs them) replays assign_tf32_wide_kernel's float32 product: X and Z
split as split_tf32 splits them (big = tf32(a) by Veltkamp's split, small
= a - big, whose low 13 bits the tensor cores drop), 16 k-chunks of 8 dims
in order, each as three wgmma steps (small X * big Z, big X * small Z, big
X * big Z) into one accumulator per 64 seeds, each step under
hill_climb_study's accumulator model (al2: the step's 9 terms aligned to
the largest and truncated two bits below its last bit, the sum rounded
toward zero); then each pixel's best score b1, its label and the best
score b2 among seeds of other labels, the pixels with b1 - b2 below the
re-check margin re-checked as the sequential float32 FMA chain over the
dims (lowest seed index on a tie), and both histograms.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np
import torch

F32, F64 = torch.float32, torch.float64
WIDE = 128
# |S_kernel - S_exact| for unit rows at d = 128, as the kernel's note bounds
# it: 48 wgmma steps into one accumulator, each truncating its 9 terms
# below 2^-25 and rounding its sum toward zero (below 2^-23), and the
# split's dropped small * small and truncated small parts (1.3 * 2^-20)
S_BOUND_128 = 48 * (9 * 2.0 ** -25 + 2.0 ** -23) + 1.3 * 2.0 ** -20


# ---------------------------------------------------------------------------
# emulation (CPU)
# ---------------------------------------------------------------------------

def split_trunc(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """split_tf32 as the tensor cores read it: big = tf32(a) by Veltkamp's
    split (float32 operations), small = a - big with its low 13 bits
    dropped; both as float64."""
    a = a.to(F32)
    t = a * 8193.0
    big = t - (t - a)
    small = ((a - big).view(torch.int32) & -8192).view(F32)
    return big.to(F64), small.to(F64)


def emulate_s(x: torch.Tensor, z: torch.Tensor,
              model: str = "al2") -> torch.Tensor:
    """S = X Z^T ([n, m] float32) as assign_tf32_wide_kernel sums it: the
    k-chunks of 8 dims in order, each as three wgmma steps (small X * big
    Z, big X * small Z, big X * big Z), every step under `model`."""
    from hill_climb_study import step
    xb, xs = split_trunc(x)
    zb, zs = split_trunc(z)
    acc = torch.zeros((x.shape[0], z.shape[0]), dtype=F32)
    for c in range(0, x.shape[1], 8):
        k = slice(c, c + 8)
        for a, b in ((xs, zb), (xb, zs), (xb, zb)):
            acc = step(acc, a[:, None, k] * b[None, :, k], model)
    return acc


def fma_chain_argmax(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """For each row of x, the index of the seed with the largest dot as the
    sequential float32 FMA chain over the dims from 0 (each step's exact
    product and sum rounded once to float32 through float64), lowest index
    on a tie."""
    acc = torch.zeros((x.shape[0], z.shape[0]), dtype=F32)
    xd, zd = x.to(F64), z.to(F64)
    for j in range(x.shape[1]):
        acc = (acc.to(F64) + xd[:, j, None] * zd[None, :, j]).to(F32)
    best = acc.max(dim=1, keepdim=True).values
    idx = torch.arange(z.shape[0]).expand_as(acc)
    return torch.where(acc == best, idx, z.shape[0]).min(dim=1).values


def emulate_assign(x: torch.Tensor, z: torch.Tensor, seed_labels: torch.Tensor,
                   z_valid: torch.Tensor | None, margin: float,
                   model: str = "al2"):
    """The kernel's (labels [n] int32, counts [m], valid_counts [m] float32,
    re-checked pixels) from float32 x [n, d] and z [m, d]."""
    m = z.shape[0]
    slab = seed_labels.to(torch.int64)
    s = emulate_s(x, z, model)
    b1, best = s.max(dim=1)
    lab = slab[best]
    other = slab[None, :] != lab[:, None]
    b2 = torch.where(other, s, torch.full_like(s, -float("inf"))).max(dim=1)
    near = (b1 - b2.values) < margin
    if bool(near.any()):
        lab[near] = slab[fma_chain_argmax(x[near], z)]
    counts = torch.bincount(lab, minlength=m)[:m].to(F32)
    valid = counts.clone() if z_valid is None else torch.bincount(
        lab[z_valid.bool()], minlength=m)[:m].to(F32)
    return lab.to(torch.int32), counts, valid, int(near.sum())


# ---------------------------------------------------------------------------
# time (card)
# ---------------------------------------------------------------------------

def assign_lib(src: str, name: str, *defines: str):
    """csrc/mean_shift.cu of a checkout (src) built with `defines` as a
    ctypes library with its assignment entry points bound; and the build's
    ptxas report."""
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import _build
    lib, log = ks.shared_lib(src, name, *defines)
    for entry in ("uoc_assign_labels", "uoc_assign_labels_plan"):
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
    return lib, log


def call(lib, x, z, slab, z_valid):
    """The assignment of `lib` as the port's wrapper calls it: (labels,
    counts, valid counts, re-checked pixels as a [1] tensor)."""
    from unseenobjectclustering_torch.ops import _build
    (n, d), m = x.shape, z.shape[0]
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    out = torch.empty(2 * m + 1, dtype=F32, device=x.device)
    err = lib.uoc_assign_labels(
        x.data_ptr(), _build.dtype_code(x, "study"), n, d, z.data_ptr(),
        slab.data_ptr(), m, None if z_valid is None else z_valid.data_ptr(),
        labels.data_ptr(), out.data_ptr(), _build.stream(x))
    _build.check(err, "assign_labels (study)")
    return (labels, *out.split((m, m, 1)))


def ptxas_notes(log: str) -> list[str]:
    """ptxas's lines about the assignment kernels: registers, spills, and
    its notes (serialized wgmmas, injected waits)."""
    import kernel_study as ks
    notes = [line.strip() for line in log.splitlines()
             if "assign" in line and ("C75" in line or "wgmma" in line)]
    return ks.ptxas_lines(log, "assign_") + notes


def cases() -> list:
    """(name, x in its working type, z [100, d], seed labels, z_valid) at
    the port's shapes: chip_smoke's clustered inputs of phases 2 (d = 64)
    and 2c (d = 128), and random unit vectors; the seeds from the port's
    kernels (fast mode seeding every SEED_SUBSAMPLE-th pixel); a depth
    mask at the frame."""
    import chip_smoke as cs
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
    from unseenobjectclustering_torch.ops import cuda_seeding
    sub = int(cs.FAST_CLUSTER["SEED_SUBSAMPLE"])
    out = []
    for where, d, seed, clustered in ks.clustered_inputs():
        n = clustered.shape[0]
        mask = None
        if n == cs.N:
            g = torch.Generator(device=clustered.device).manual_seed(seed)
            mask = torch.rand(n, generator=g, device=clustered.device) > 0.1
        for kind, x32 in (("clustered", clustered),
                          ("uniform", ks.units(n, d, 40 + seed))):
            for mode, x in (("parity", x32), ("fast", x32.bfloat16())):
                xs = x[::1 if mode == "parity" else sub]
                z0, _ = cuda_seeding.select_seeds(xs, cs.M,
                                                  12345 % xs.shape[0])
                z = cms.hill_climb(x, z0.float(), kappa=cs.KAPPA,
                                   max_iters=cs.ITERS)
                slab = cms.connected_components(z, cs.EPS)
                out.append((f"{where} d{d} {mode} {kind}", x, z, slab, mask))
    return out


def clock_split(lib, plan: dict) -> dict:
    """Microseconds by part of the last width-128 assignment launch of the
    clocked library (assign_tf32_wide_kernel or assign_bf16_wide_kernel,
    as `plan` names it): the mean over the blocks and the slowest
    block's."""
    import kernel_study as ks
    c = ks.clocks(lib, "uoc_assign_clocks", (160, 36))[:plan["grid"]]
    c = c.astype(np.float64)[:, :, None]  # one step a block
    # the first two parts: the float32 kernel's wait for a tile and A split
    # (both passes, with the first pass's wgmma issue); the bf16 kernel's
    # claim with the wait for the tile, and its wgmmas' issue
    first = (("wait_tile", "split") if "tf32" in plan["kernel"]
             else ("claim_wait_tile", "issue"))
    parts = (*first, "wgmma", "best_merge", "recheck", "labels_histograms")
    spans = {"stage_z": c[:, 1] - c[:, 0], "tiles": c[:, 2] - c[:, 1],
             "flush": c[:, 3] - c[:, 2], "producer_wait_stage": c[:, 4]}
    # the consumer warpgroups: all but the producer's warps
    for wg in range((plan["threads"] - 1) // 128):
        spans[f"consumer{wg}_later"] = c[:, 8 + wg] - c[:, 2]
        for i, part in enumerate(parts):
            spans[f"consumer{wg}_{part}"] = c[:, 12 + 6 * wg + i]
    out = ks.span_us(spans)
    out["tiles_per_block"] = {"mean": float(c[:, 5].mean()),
                              "most": float(c[:, 5].max())}
    out["smem_base_mod_1024"] = sorted({int(v) % 1024 for v in c[:, 6, 0]})
    return out


def host_cost(fn, reps: int = 200) -> dict:
    """fn's cost with the host in it: call_ms, chip_smoke.time_ms over reps
    single calls (the median of CUDA events around one call, host latency
    included, as chip_smoke's `ms`); and host_us, the host's time per call
    to queue reps calls behind a sleep kernel (the ctypes call, the plan,
    the tensor map where the kernel takes one, and the launch)."""
    import time

    import chip_smoke as cs
    out = {"call_ms": cs.time_ms(fn, reps)}
    torch.cuda._sleep(200_000_000)  # ~0.1 s, longer than the queueing
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    out["host_us"] = (time.perf_counter() - t0) * 1e6 / reps
    torch.cuda.synchronize()
    return out


def map_us(lib, x: torch.Tensor, reps: int = 10_000) -> float:
    """The host's microseconds per encode of the float32 d = 128 kernel's
    tensor map for x (the clocked library's uoc_assign_map_us)."""
    import ctypes
    fn = lib.uoc_assign_map_us
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_double
    us = fn(x.data_ptr(), x.shape[0], reps)
    assert us >= 0, "a tensor-map encode failed"
    return us


def time_trees(parent_dir: str | None, clocks: bool,
               out_file: str | None) -> None:
    import chip_smoke as cs
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import _build
    from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
    if not torch.cuda.is_available():
        sys.exit("assign_study: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {"card": cs.card_line(), "cases": {}}
    print(res["card"])
    _build.library()
    src = os.path.join(_build.CSRC, "mean_shift.cu")
    ours, log = assign_lib(src, "libassign_this.so")
    res["ptxas"] = ptxas_notes(log)
    print("\n".join(res["ptxas"]))
    parent = None
    if parent_dir is not None:
        parent, plog = assign_lib(os.path.join(
            parent_dir, "unseenobjectclustering_torch", "csrc",
            "mean_shift.cu"), "libassign_parent.so")
        res["parent_ptxas"] = ptxas_notes(plog)
        print("\n".join("parent " + line for line in res["parent_ptxas"]))
    clocked = None if not clocks else assign_lib(
        src, "libassign_clocks.so", "-DASSIGN_CLOCKS")[0]
    ok = True
    for name, x, z, slab, mask in cases():
        n, d = x.shape
        r = {"plan": cms.assign_labels_config(x, cs.M)}
        want = cms.assign_labels_reference(x, z, slab, z_valid=mask)
        trees = {"this": ours} if parent is None else {"this": ours,
                                                       "parent": parent}
        got = {}
        for who, lib in trees.items():
            got[who] = call(lib, x, z, slab, mask)
            r[f"{who}_equal_plain"] = all(
                torch.equal(g, w) for g, w in zip(got[who][:3], want))
            r[f"{who}_rechecked"] = int(got[who][3])
        ok &= r["this_equal_plain"]
        if parent is not None:
            r["same_as_parent"] = all(torch.equal(a, b) for a, b in
                                      zip(got["this"][:3], got["parent"][:3]))
            ok &= r["same_as_parent"]
        runs = [("this", ours)]
        if parent is not None:
            runs = [("parent", parent), ("this", ours), ("this", ours),
                    ("parent", parent)]
        for who, lib in runs:
            fn = functools.partial(call, lib, x, z, slab, mask)
            r.setdefault(who, []).append(
                {**ks.timed(fn, "assign_"), **host_cost(fn)})
        if clocked is not None and d == WIDE:
            gc = call(clocked, x, z, slab, mask)
            r["same_as_clocked"] = all(torch.equal(a, b) for a, b in
                                       zip(gc[:3], got["this"][:3]))
            r["clocks"] = clock_split(clocked, r["plan"])
            if x.dtype == F32:
                r["map_us"] = map_us(clocked, x)
        res["cases"][name] = r
        print(f"[{name}] n {n}: {json.dumps(r)}", flush=True)
    if out_file:
        with open(out_file, "w") as f:
            json.dump(res, f, indent=1)
    if not ok:
        raise SystemExit("a kernel's labels or histograms differ from the "
                         "plain version's or the parent's")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    tm = sub.add_parser("time")
    tm.add_argument("--parent", default=None)
    tm.add_argument("--clocks", action="store_true")
    tm.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    time_trees(args.parent, args.clocks, args.out)


if __name__ == "__main__":
    main()
