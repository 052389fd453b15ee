#!/usr/bin/env python3
"""How fast the connected-components kernels are, and where their time goes.

    python3 cc_study.py time [--parent DIR] [--clusters 2,4] [--clocks]
                             [--out FILE]            # on one NVIDIA GPU
    python3 cc_study.py clocks [--designs one_block,cluster] [--out FILE]

Inputs: at widths 64 and 128, the converged seeds (m = 100) of
assign_study.cases() (chip_smoke.py's clustered inputs and random unit
vectors at the 480x640 frame and both crop sides, parity and fast mode:
the port's own seeding and hill climb), and 100 pairwise-far seeds
(chip_smoke.pairwise_far_seeds: every seed its own cluster, a merge step
per seed, the most).

`time` builds the port's kernels (printing ptxas's registers and spills
for every connected-components kernel) and, with --parent, the
csrc/mean_shift.cu of another checkout (say the parent commit, unpacked
with ``git archive``) into a library of its own, called through the same C
entry point.  For each input it prints each tree's labels against the
plain version, its merge steps, whether labels and steps are bitwise the
parent's, and times in turns (parent, this tree, this tree, parent):
chip_smoke.queued_ms (CUDA events around 10 queued calls) and
chip_smoke.device_ms (torch.profiler).  --clusters builds copies of this
tree's source with kCCCluster set to each count and times them at width
128 beside this tree.

`clocks` (also `time --clocks`) builds mean_shift.cu with -DCC_CLOCKS and
splits each launch's time by part, in microseconds at the card's largest
SM clock: `one_block` is cc_kernel (one block of 16 warps, the design
that width 64 keeps and width 128 had before cc_cluster_kernel) at both
widths; `cluster` is cc_cluster_kernel at width 128, per CTA.  Parts: Z
staged; warp 0's items; the latest warp's items; the wait at the block
barrier (or the cluster's barriers: the first wait, the writes into the
leader, the second barrier); the merge and its steps, a step's mean; the
output; and, from %globaltimer, how far apart the CTAs start.  From these
it states the kernel's latency floor: one dependent read of Z (the
fastest CTA's staging), one 128- (or 64-) long chain of dependent FMAs at
4 cycles each, the merge's steps at the measured step, and the output.
--out writes every reading as JSON.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import sys

import numpy as np
import torch

F32 = torch.float32
FMA_CYCLES = 4  # the latency of a dependent fp32 FMA on the H100's SMs
MARKS = 12      # kCCMarks in csrc/mean_shift.cu
CTAS = 8        # kCCClockCtas


def cc_lib(src: str, name: str, *defines: str):
    """csrc/mean_shift.cu of a checkout (src) built with `defines` as a
    ctypes library with its connected-components entry bound; and the
    build's ptxas report."""
    import ctypes

    import kernel_study as ks
    from unseenobjectclustering_torch.ops import _build
    lib, log = ks.shared_lib(src, name, *defines)
    lib.uoc_connected_components.argtypes = _build._SIGNATURES[
        "uoc_connected_components"]
    if "-DCC_CLOCKS" in defines:
        lib.uoc_cc_one_block.argtypes = _build._SIGNATURES[
            "uoc_connected_components"]
        lib.uoc_cc_clocks.argtypes = [ctypes.c_void_p]
    return lib, log


def call(lib, z, eps, entry="uoc_connected_components"):
    """(labels [m] int32, merge steps [1] int32) of `lib`'s entry."""
    from unseenobjectclustering_torch.ops import _build
    m, d = z.shape
    out = torch.empty(m + 1, dtype=torch.int32, device=z.device)
    err = getattr(lib, entry)(z.data_ptr(), m, d, float(eps),
                              out.data_ptr(), out.data_ptr() + 4 * m,
                              _build.stream(z))
    _build.check(err, f"{entry} (study)")
    return out.split((m, 1))


def cases() -> list:
    """(name, z [100, d] float32) at both widths: the converged seeds of
    assign_study.cases(), and pairwise-far seeds."""
    import assign_study
    import chip_smoke as cs
    out = [(name, z.contiguous()) for name, _, z, _, _ in assign_study.cases()]
    for d in (cs.D, cs.CAT_D):
        out.append((f"pairwise-far d{d}",
                    cs.pairwise_far_seeds(d=d).contiguous()))
    return out


def clock_split(lib, z, eps, design: str) -> dict:
    """Microseconds by part of one launch of the clocked library's `design`
    (one_block: uoc_cc_one_block; cluster: uoc_connected_components at
    width 128), after a warm-up launch."""
    import kernel_study as ks
    entry = ("uoc_cc_one_block" if design == "one_block"
             else "uoc_connected_components")
    call(lib, z, eps, entry)
    assert lib.uoc_cc_clocks_reset() == 0
    labels, steps = call(lib, z, eps, entry)
    c = ks.clocks(lib, "uoc_cc_clocks", (CTAS, MARKS)).astype(np.float64)
    ctas = 1 if design == "one_block" else CTAS
    c = c[:ctas]
    lead = c[0]
    spans = {"stage_z": c[:, 1] - c[:, 0],
             "items_warp0": c[:, 2] - c[:, 1],
             "items_latest": c[:, 11] - c[:, 1],
             "adjacency_done": c[:, 3] - c[:, 0]}
    if design == "one_block":
        spans["block_barrier"] = c[:, 3] - c[:, 2]
    else:
        spans["first_wait"] = c[:, 9] - c[:, 1]
        spans["writes"] = c[:, 10] - c[:, 9]
        spans["second_barrier"] = c[:, 3] - c[:, 2]
    out = ks.span_us({k: v[:, None] for k, v in spans.items()})
    mhz = out["sm_mhz"]
    n_steps = int(lead[6])
    out.update(
        merge_us=float((lead[4] - lead[3]) / mhz),
        output_us=float((lead[5] - lead[4]) / mhz),
        leader_total_us=float((lead[5] - lead[0]) / mhz),
        merge_steps=n_steps,
        step_us=float((lead[4] - lead[3]) / mhz / max(n_steps, 1)),
        start_spread_ns=float(c[:, 7].max() - c[:, 7].min()),
        adjacency_spread_ns=float(c[:, 8].max() - c[:, 8].min()),
        labels=labels.tolist(), steps_reported=int(steps))
    d = z.shape[1]
    chain_us = d * FMA_CYCLES / mhz
    z_read_us = float((c[:, 1] - c[:, 0]).min() / mhz)
    out["floor"] = dict(z_read_us=z_read_us, chain_us=chain_us,
                        merge_us=out["merge_us"], output_us=out["output_us"],
                        total_us=z_read_us + chain_us + out["merge_us"]
                        + out["output_us"])
    return out


def variant_source(src: str, clusters: int, out_dir: str) -> str:
    """A copy of `src` with kCCCluster = clusters, in out_dir."""
    text = open(src).read()
    new, count = re.subn(r"constexpr int kCCCluster = \d+;",
                         f"constexpr int kCCCluster = {clusters};", text)
    assert count == 1, "kCCCluster not found"
    path = os.path.join(out_dir, f"mean_shift_cc{clusters}.cu")
    with open(path, "w") as f:
        f.write(new)
    return path


def run_clocks(designs: list[str], res: dict) -> None:
    import chip_smoke as cs
    from unseenobjectclustering_torch.ops import _build
    src = os.path.join(_build.CSRC, "mean_shift.cu")
    lib, log = cc_lib(src, "libcc_clocks.so", "-DCC_CLOCKS")
    res["clocked_ptxas"] = ptxas_cc(log)
    for name, z in cases():
        d = z.shape[1]
        plain = cs.cms.connected_components_reference(z, cs.EPS).tolist()
        for design in designs:
            if design == "cluster" and d != cs.CAT_D:
                continue
            r = clock_split(lib, z, cs.EPS, design)
            r["equal_plain"] = r.pop("labels") == plain
            res.setdefault("clocks", {})[f"{name} {design}"] = r
            print(f"[{name}, {design}] {json.dumps(r)}", flush=True)
            if not r["equal_plain"]:
                raise SystemExit(f"{name} {design}: labels differ from the "
                                 "plain version's")


def ptxas_cc(log: str) -> list[str]:
    import kernel_study as ks
    return ks.ptxas_lines(log, "cc_")


def time_trees(parent_dir: str | None, clusters: list[int], clocks: bool,
               out_file: str | None) -> None:
    import chip_smoke as cs
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import _build
    res: dict = {"card": cs.card_line(), "cases": {}}
    print(res["card"])
    _build.library()
    src = os.path.join(_build.CSRC, "mean_shift.cu")
    trees = {"this": cc_lib(src, "libcc_this.so")}
    for c in clusters:  # the copy includes common.cuh from the sources
        trees[f"cluster{c}"] = cc_lib(
            variant_source(src, c, _build.BUILD_DIR), f"libcc_{c}.so",
            f"-I{_build.CSRC}")
    if parent_dir is not None:
        trees["parent"] = cc_lib(os.path.join(
            parent_dir, "unseenobjectclustering_torch", "csrc",
            "mean_shift.cu"), "libcc_parent.so")
    res["ptxas"] = {who: ptxas_cc(log) for who, (_, log) in trees.items()}
    print(json.dumps(res["ptxas"]))
    ok = True
    for name, z in cases():
        d = z.shape[1]
        want = cs.cms.connected_components_reference(z, cs.EPS)
        r = {"plan": cs.cms.connected_components_config(z)}
        got = {}
        for who, (lib, _) in trees.items():
            if who.startswith("cluster") and d != cs.CAT_D:
                continue
            got[who] = call(lib, z, cs.EPS)
            r[f"{who}_equal_plain"] = bool(torch.equal(got[who][0], want))
            r[f"{who}_steps"] = int(got[who][1])
            ok &= r[f"{who}_equal_plain"]
        if "parent" in got:
            r["same_as_parent"] = all(torch.equal(a, b) for a, b in
                                      zip(got["this"], got["parent"]))
            ok &= r["same_as_parent"]
        runs = [("this", trees["this"][0])]
        if "parent" in trees:
            runs = [("parent", trees["parent"][0])] + runs * 2 + [
                ("parent", trees["parent"][0])]
        runs += [(who, trees[who][0]) for who in got
                 if who.startswith("cluster")]
        for who, lib in runs:
            fn = functools.partial(call, lib, z, cs.EPS)
            r.setdefault(who, []).append(ks.timed(fn, "cc_"))
        res["cases"][name] = r
        print(f"[{name}] {json.dumps(r)}", flush=True)
    if clocks:
        run_clocks(["one_block", "cluster"], res)
    if out_file:
        with open(out_file, "w") as f:
            json.dump(res, f, indent=1)
    if not ok:
        raise SystemExit("a kernel's labels differ from the plain version's "
                         "or its labels or steps from the parent's")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    tm = sub.add_parser("time")
    tm.add_argument("--parent", default=None)
    tm.add_argument("--clusters", default="")
    tm.add_argument("--clocks", action="store_true")
    tm.add_argument("--out", default=None)
    ck = sub.add_parser("clocks")
    ck.add_argument("--designs", default="one_block,cluster")
    ck.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("cc_study: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cmd == "time":
        time_trees(args.parent, [int(c) for c in args.clusters.split(",")
                                 if c], args.clocks, args.out)
    else:
        import chip_smoke as cs
        res: dict = {"card": cs.card_line()}
        print(res["card"])
        run_clocks(args.designs.split(","), res)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
