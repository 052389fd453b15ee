#!/usr/bin/env python3
"""How accurate and how fast the hill-climb kernels are.

    python3 hill_climb_study.py survey [--out DIR]     # on one NVIDIA GPU
    python3 hill_climb_study.py time [--parent DIR] [--clocks] [--out FILE]
        [--crops DIR]                                  # on one NVIDIA GPU
    python3 hill_climb_study.py variants EDITS.json [--out FILE]
                                                       # on one NVIDIA GPU
    python3 hill_climb_study.py emulate FILE.npz [--model al2 ...]  # CPU

`time` builds the port's kernels (and prints what ``nvcc -Xptxas -v``
reports for every hill-climb kernel: registers, spills) and, with
--parent, the csrc/mean_shift.cu of another checkout (say the parent
commit, unpacked with ``git archive``) into a library of its own, called
through the same C entry point.  At every shape the port hill-climbs
(widths 64 and 128; the 480x640 frame and both crop sides; parity,
float32, and fast mode, bfloat16), on chip_smoke.py's clustered input and
on random unit vectors, with m = 100 seeds picked as the port picks them,
it prints each tree's Z against the float64 replay
(chip_smoke.hill_climb_exact; in fast mode against the plain version),
whether this tree's Z is bitwise the same in two runs and as the
parent's, and device ms in turns (parent, this tree, this tree, parent):
chip_smoke.queued_ms (CUDA events around 10 queued calls) and
chip_smoke.device_ms (torch.profiler).  On the clustered parity inputs
it times the same turns again, each right after the hill climb's
yardstick (chip_smoke.sdpa_yardstick, as chip_smoke.py's check_kernels
runs it before the kernels' device times), and prints the yardstick's
ms, backend and Z against the plain version.  --clocks builds
mean_shift.cu again with -DHILL_CLOCKS and, on each case at width 128,
splits the launch's time (the clock64 of each block's first consumer
thread, in microseconds at the card's largest SM clock, summed over the
10 iterations, the mean over the blocks and the slowest block's): the
tiles (float32: the wait for the producer's split copies, S, W's exp and
split, W X, the stage's release; bfloat16: the wait for a tile to land,
the next tile's S from its issue, W's exp, the wait for W X, the stage's
release), the producer's (float32: the wait for a tile's loads, for a
free stage, the split, the release and the next load; bfloat16, where
tiles stream: the wait for a free stage, the loads' issue) and the fixed
cost of an iteration (Z's staging, the partial's store, the first grid
barrier, the reduction, the second barrier).  --out writes every reading
as JSON; --crops saves the width-128 cases at 128^2 (X, Z0, this tree's
Z, the plan's grid; float32 with the float64 result, bfloat16 with the
plain version's) for `emulate`, and holds the emulation, run on the card,
to this tree's kernel: in float32 after one iteration under each
accumulator model (rn, rz, al0-al4) and after 10 under al2, in bfloat16
(emulate_bf16) after 10 under rn, rz and al2.

`variants` builds edited copies of csrc/mean_shift.cu (EDITS.json maps a
name to a list of [old, new] text replacements) and times the bf16 hill
climb at width 128 of each against this tree's in turns (tree, each copy,
then the same in reverse) at the frame and both crops on chip_smoke's
clustered inputs, with each copy's Z against the plain version and what
ptxas reports of its kernel (registers, spills, serialized wgmmas).

`survey` builds csrc/mean_shift.cu once per grouping of the float32 hill
climb's wgmma steps (-DHILL_BIG_PER_GROUP: 8 = every big step in one
accumulator, 2 = the kernel's choice, 1 = each big step alone), times each
on chip_smoke's clustered input at n = 480*640, 224*224 and 128*128, then
trains chip_smoke's phase 8b stage 1 and both phase 8c crop networks
(snapshots at 10, 15 and 20 epochs), reads refined Objects F per network,
epoch count and mode through tools.test_net, and surveys every valid crop
of the held-out frames: in parity each variant's and the plain float32
version's distance from the float64 result (chip_smoke.hill_climb_exact);
in fast mode the bf16 kernel's and its plain version's distance from each
other, from the float64 replay with the same bf16 roundings and from the
float64 result without them.  The 128^2 crops where the one-accumulator
variant strays furthest are saved (X, Z0, the float64 result and each
variant's Z) to DIR.

`emulate` replays the float32 kernels' arithmetic on the CPU (`emulate`
below: at d = 64 or 128, split TF32 operands, wgmma steps in the kernel's
order and groups, the CUDA cores' adds, the block and row reductions)
with a model of the tensor cores' accumulator, and prints its distance
from the saved kernel results (the survey's d = 64 crops by grouping, or
`time --crops`'s crops at both widths) and from the float64 result; on a
bfloat16 crop it replays hill_bf16_wide_kernel (`emulate_bf16`: its tile
schedule, bf16 roundings and steps) and prints its distance from the
kernel's Z and from the plain version's.
Models: `rn` and `rz` round each step's exact sum once (nearest, toward
zero); `alG` aligns each step's terms (the accumulator and eight
products) to the largest, truncates each one G bits below the largest's
last bit and rounds their sum toward zero.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import functools
import io
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

GROUPINGS = {"one": 8, "pairs": 2, "single": 1}  # big steps per group
EPOCHS = (10, 15, 20)


# ---------------------------------------------------------------------------
# survey (card)
# ---------------------------------------------------------------------------

def build_variants(out: dict) -> dict:
    """ctypes libraries of the kernels built with each grouping; prints
    the float32 hill climb's registers and spills."""
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import _build
    libs = {}
    for name, big in GROUPINGS.items():
        libs[name], log = hill_lib(os.path.join(_build.CSRC, "mean_shift.cu"),
                                   f"libstudy_{name}.so",
                                   f"-DHILL_BIG_PER_GROUP={big}")
        regs = " ".join(ks.ptxas_lines(log, "hill_tf32_kernel"))
        print(f"[{name}] {regs}")
        out.setdefault("ptxas", {})[name] = regs
    return libs


def replay_bf16(x, z0, rounding: bool):
    """float64 hill climb on bf16 X; with `rounding`, Z and W rounded to
    bf16 where the bf16 kernel rounds them."""
    import torch
    import chip_smoke as cs
    x, z = x.double(), z0.double()
    for _ in range(cs.ITERS):
        zc = z.to(torch.bfloat16).double() if rounding else z
        w = torch.exp(cs.KAPPA * (zc @ x.T))
        if rounding:
            w = w.to(torch.bfloat16).double()
        v = w @ x
        z = v / v.norm(dim=1, keepdim=True)
    return z


def survey(out_dir: str) -> None:
    import torch
    import yaml
    import chip_smoke as cs
    from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
    from unseenobjectclustering_torch.ops import cuda_seeding
    if not torch.cuda.is_available():
        sys.exit("hill_climb_study: no CUDA device is available")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(out_dir, exist_ok=True)
    print(cs.card_line())
    res: dict = {}
    libs = build_variants(res)

    res["speed"] = {}
    for n in (cs.N, cs.CROP * cs.CROP, 128 * 128):
        x, _ = cs.clustered_embeddings(n=n)
        z0, _ = cuda_seeding.select_seeds_reference(x, cs.M, 12345 % n)
        exact = cs.hill_climb_exact(x, z0)
        res["speed"][n] = row = {}
        for name, lib in libs.items():
            z = call(lib, x, z0)
            row[name] = dict(
                ms=cs.time_ms(lambda: call(lib, x, z0), 30),
                exact_err=float((z.double() - exact).abs().max()))
        print(f"clustered input, n = {n}: " + json.dumps(row))

    tmp = tempfile.mkdtemp()
    cache = os.path.join(tmp, "cache")
    stage1 = os.path.join(tmp, "snapshots")
    cs.render_splits(cache, {"train": cs.TRAINED_SCENES,
                             "test": cs.HELD_OUT}, (cs.TH, cs.TW))
    cs.train_recipe("stage 1", cs.RECIPE_YML, cs.NET, cs.TRAINED_EPOCHS,
                    cache, stage1)
    res["f"], segs = {}, {}
    for name, (yml, net) in cs.CROP_NETS.items():
        with open(os.path.join(cs.REPO, yml)) as f:
            tree = yaml.safe_load(f)
        tree["TRAIN"]["SNAPSHOT_EPOCHS"] = EPOCHS[1] - EPOCHS[0]
        crop = os.path.join(tmp, name)
        with open(crop + ".yml", "w") as f:
            yaml.safe_dump(tree, f)
        cs.run_train_net(name, cs.train_args(
            cache, crop, "--epochs", str(EPOCHS[-1]), "--bf16",
            yml=crop + ".yml", scenes=cs.TRAINED_SCENES, net=net))
        for e in EPOCHS:  # a directory that holds one snapshot
            os.makedirs(f"{crop}_e{e}")
            os.symlink(os.path.join(crop, str(e)),
                       os.path.join(f"{crop}_e{e}", str(e)))
            for mode in ("parity", "fast"):
                with contextlib.redirect_stdout(io.StringIO()):
                    r, rec = cs.two_stage_test_net(
                        f"{name} {e} {mode}", stage1, f"{crop}_e{e}", net,
                        cs.CROP_SIDES[name], cache,
                        os.path.join(tmp, "tn", name, str(e), mode),
                        mode == "fast")
                res["f"][f"{name}/{e}/{mode}"] = dict(
                    stage1=r["stage1_metrics"]["Objects F-measure"],
                    refined=r["refined_metrics"]["Objects F-measure"])
                segs[(name, e, mode)] = rec.seg
        print(f"[{name}] refined Objects F by epochs and mode (stage 1 "
              f"{res['f'][f'{name}/{EPOCHS[0]}/parity']['stage1']:.4f}): "
              + json.dumps({k: round(v["refined"], 4)
                            for k, v in res["f"].items()
                            if k.startswith(name)}))

    img, xyz = cs.held_out_frames(cache, cs.HELD_OUT, cs.DEV)
    res["survey"], saved = {}, 0
    for name in cs.CROP_NETS:
        for mode in ("parity", "fast"):
            seg = segs[(name, cs.CROP_EPOCHS, mode)]
            rows = []
            for fr in range(cs.HELD_OUT):
                feats, valid = cs.crop_embeddings(seg, img[fr:fr + 1],
                                                  xyz[fr:fr + 1])
                n = feats.shape[1] * feats.shape[2]
                for i in (i for i, v in enumerate(valid) if v):
                    row = dict(frame=fr, crop=i)
                    if mode == "parity":
                        x = feats[i].reshape(n, cs.D)
                        z0 = cuda_seeding.select_seeds_reference(
                            x, cs.M, 12345 % n)[0].float()
                        exact = cs.hill_climb_exact(x, z0)
                        zs = {k: call(lib, x, z0) for k, lib in libs.items()}
                        zs["plain"] = cms.hill_climb_reference(x, z0)
                        row.update({k: float((z.double() - exact).abs().max())
                                    for k, z in zs.items()})
                        if (n == 128 * 128 and saved < 3
                                and row["one"] > 8e-6):
                            np.savez(os.path.join(
                                out_dir, f"{name}_frame{fr}_crop{i}.npz"),
                                x=x.cpu().numpy(), z0=z0.cpu().numpy(),
                                z64=exact.cpu().numpy(),
                                **{k: z.cpu().numpy() for k, z in zs.items()})
                            saved += 1
                    else:
                        x = feats[i].reshape(n, cs.D).to(torch.bfloat16)
                        xs = x[::int(cs.FAST_CLUSTER["SEED_SUBSAMPLE"])]
                        z0 = cuda_seeding.select_seeds_reference(
                            xs, cs.M, 12345 % xs.shape[0])[0].float()
                        zk = cms.hill_climb(x, z0)
                        zp = cms.hill_climb_reference(x, z0)
                        rounded = replay_bf16(x, z0, True)
                        exact = replay_bf16(x, z0, False)
                        row.update(
                            kernel_plain=float((zk - zp).abs().max()),
                            kernel_rounded=float(
                                (zk.double() - rounded).abs().max()),
                            plain_rounded=float(
                                (zp.double() - rounded).abs().max()),
                            kernel_exact=float(
                                (zk.double() - exact).abs().max()),
                            plain_exact=float(
                                (zp.double() - exact).abs().max()))
                    rows.append(row)
            key = f"{name}/{mode}"
            res["survey"][key] = rows
            cols = [k for k in rows[0] if k not in ("frame", "crop")]
            print(f"[{key}] {len(rows)} valid crops, largest: " + json.dumps(
                {k: float(f"{max(r[k] for r in rows):.3e}") for k in cols}))
            for k in cols:
                r = max(rows, key=lambda r: r[k])
                print(f"    largest {k}: frame {r['frame']} crop {r['crop']}: "
                      + json.dumps({c: float(f"{r[c]:.3e}") for c in cols}))
    with open(os.path.join(out_dir, "survey.json"), "w") as f:
        json.dump(res, f)
    print(f"wrote {out_dir}/survey.json and {saved} crops")


# ---------------------------------------------------------------------------
# time (card)
# ---------------------------------------------------------------------------

CLOCK_SHAPE = (160, 16, 16)  # hill_clocks in csrc/mean_shift.cu


def hill_lib(src: str, name: str, *defines: str):
    """csrc/mean_shift.cu of a checkout (src) built with `defines` as a
    ctypes library with its hill-climb entry points bound; and the build's
    ptxas report."""
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import _build
    lib, log = ks.shared_lib(src, name, *defines)
    for entry in ("uoc_hill_climb", "uoc_hill_climb_plan"):
        getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
    return lib, log


def call(lib, x, z0, iters=None):
    """The hill climb of `lib` on x [n, d] (float32 or bfloat16), z0 [m,
    d], as the port's wrapper calls it (chip_smoke's kappa; its iterations
    unless `iters`)."""
    import torch
    import chip_smoke as cs
    from unseenobjectclustering_torch.ops import _build
    (n, d), m = x.shape, z0.shape[0]
    code = _build.dtype_code(x, "study")
    z0 = z0.float().contiguous()
    plan = (ctypes.c_longlong * 6)()  # a parent's plan may fill only 5
    assert lib.uoc_hill_climb_plan(code, n, m, d,
                                   ctypes.addressof(plan)) == 0
    partial = torch.empty((int(plan[0]), m, d), device=x.device)
    arrived = torch.empty(1, dtype=torch.int32, device=x.device)
    z = torch.empty((m, d), device=x.device)
    err = lib.uoc_hill_climb(x.data_ptr(), code, n, d, z0.data_ptr(), m,
                             cs.KAPPA, iters or cs.ITERS, partial.data_ptr(),
                             arrived.data_ptr(), z.data_ptr(),
                             _build.stream(x))
    _build.check(err, "hill_climb (study)")
    return z


def time_cases() -> list:
    """(name, x in its working type, z0) at the port's shapes: chip_smoke's
    clustered inputs of phases 2 (d = 64) and 2c (d = 128), and random
    unit vectors; the seeds picked as the port picks them (fast mode from
    every SEED_SUBSAMPLE-th pixel)."""
    import chip_smoke as cs
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import cuda_seeding
    sub = int(cs.FAST_CLUSTER["SEED_SUBSAMPLE"])
    out = []
    for where, d, seed, clustered in ks.clustered_inputs():
        n = clustered.shape[0]
        for kind, x32 in (("clustered", clustered),
                          ("uniform", ks.units(n, d, 40 + seed))):
            for mode, x in (("parity", x32), ("fast", x32.bfloat16())):
                xs = x[::1 if mode == "parity" else sub]
                z0 = cuda_seeding.select_seeds_reference(
                    xs, cs.M, 12345 % xs.shape[0])[0].float()
                out.append((f"{where} d{d} {mode} {kind}", x,
                            z0.contiguous()))
    return out


def clock_split(lib, grid: int, bf16: bool = False,
                streams: bool = True) -> dict:
    """Microseconds by part of the last launch at d = 128 of the clocked
    library (the float32 kernel, or with `bf16` hill_bf16_wide_kernel,
    whose producer is read only where some tiles stream), summed over the
    iterations: mean over the blocks, slowest block."""
    import chip_smoke as cs
    import kernel_study as ks
    c = ks.clocks(lib, "uoc_hill_clocks", CLOCK_SHAPE)[:grid, :cs.ITERS]
    c = c.astype(np.float64)
    if bf16:
        tiles = {"tile_wait": c[..., 7], "tile_s": c[..., 8],
                 "tile_exp_w": c[..., 9], "tile_wx_wait": c[..., 10],
                 "tile_release": c[..., 11]}
        if streams:
            tiles.update(producer_wait_stage=c[..., 12],
                         producer_issue=c[..., 13])
    else:
        tiles = {"tile_s": c[..., 7], "tile_wait_split": c[..., 8],
                 "tile_exp_w": c[..., 9], "tile_wx": c[..., 10],
                 "tile_release": c[..., 11], "producer_wait_load": c[..., 12],
                 "producer_wait_stage": c[..., 13],
                 "producer_split": c[..., 14],
                 "producer_release_load": c[..., 15]}
    out = ks.span_us({
        "stage_z": c[..., 1] - c[..., 0], "tiles": c[..., 2] - c[..., 1],
        **tiles,
        "store_partial": c[..., 3] - c[..., 2],
        "grid_barrier_1": c[..., 4] - c[..., 3],
        "reduce": c[..., 5] - c[..., 4],
        "grid_barrier_2": c[..., 6] - c[..., 5]})
    out["fixed_per_iteration_us"] = sum(out[k]["mean_us"] for k in (
        "stage_z", "store_partial", "grid_barrier_1", "reduce",
        "grid_barrier_2")) / cs.ITERS
    return out


def emulation_err(lib, x, z0, grid: int) -> dict:
    """`emulate` run on the card against the kernel of `lib`: after one
    iteration under each accumulator model, and after ITERS under al2;
    the largest difference in Z and how many of Z's values differ."""
    out = {}
    for iters, models in ((1, ("rn", "rz", "al0", "al1", "al2", "al3",
                               "al4")), (ITERS, ("al2",))):
        z = call(lib, x, z0, iters)
        for model in models:
            ze, s_err = emulate(x, z0, grid, model, iters=iters)
            out[f"{model}_iters_{iters}"] = dict(
                max_diff=float((ze - z).abs().max()),
                values_differ=int((ze != z).sum()), of=z.numel(),
                s_err=s_err)
    return out


def time_trees(parent_dir: str | None, clocks: bool, out_file: str | None,
               crops: str | None) -> None:
    import torch
    import chip_smoke as cs
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import _build
    from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
    if not torch.cuda.is_available():
        sys.exit("hill_climb_study: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict = {"card": cs.card_line(), "cases": {}}
    print(res["card"])
    ours = _build.library()
    src = os.path.join(_build.CSRC, "mean_shift.cu")
    res["ptxas"] = ks.ptxas(src, "hill_")
    print("\n".join(res["ptxas"]))
    parent = None if parent_dir is None else hill_lib(
        os.path.join(parent_dir, "unseenobjectclustering_torch", "csrc",
                     "mean_shift.cu"), "libparent_hill.so")[0]
    clocked = None if not clocks else hill_lib(
        src, "libhill_clocks.so", "-DHILL_CLOCKS")[0]
    if crops:
        os.makedirs(crops, exist_ok=True)
    ok = True
    for name, x, z0 in time_cases():
        n, d = x.shape
        r = {"plan": cms.hill_climb_config(x, cs.M)}
        z = call(ours, x, z0)
        r["deterministic"] = bool(torch.equal(z, call(ours, x, z0)))
        ok &= r["deterministic"]
        trees = {"this": z}
        if parent is not None:
            trees["parent"] = call(parent, x, z0)
            r["same_as_parent"] = bool(torch.equal(z, trees["parent"]))
        plain = cms.hill_climb_reference(x, z0)
        if x.dtype == torch.float32:
            exact = cs.hill_climb_exact(x, z0)
            for who, zt in trees.items():
                r[f"{who}_exact_err"] = float((zt.double() - exact)
                                              .abs().max())
            r["plain_exact_err"] = float((plain.double() - exact)
                                         .abs().max())
            ok &= r["this_exact_err"] <= cs.Z_TOL["parity"]
            if crops and n == 128 * 128:
                np.savez(os.path.join(crops, name.replace(" ", "_")),
                         x=x.cpu().numpy(), z0=z0.cpu().numpy(),
                         z64=exact.cpu().numpy(), this=z.cpu().numpy(),
                         grid=r["plan"]["grid"])
                r["emulation"] = emulation_err(ours, x, z0,
                                               r["plan"]["grid"])
        else:
            for who, zt in trees.items():
                r[f"{who}_plain_err"] = float((zt - plain).abs().max())
            ok &= r["this_plain_err"] <= cs.Z_TOL["fast"]
            if crops and n == 128 * 128 and d == cs.CAT_D:
                np.savez(os.path.join(crops, name.replace(" ", "_")),
                         x=x.float().cpu().numpy(), z0=z0.cpu().numpy(),
                         plain=plain.cpu().numpy(), this=z.cpu().numpy(),
                         grid=r["plan"]["grid"], bf16=True)
                r["emulation"] = {}
                for model in ("rn", "rz", "al2"):
                    ze = emulate_bf16(x, z0, r["plan"]["grid"], model)
                    r["emulation"][model] = dict(
                        max_diff=float((ze - z).abs().max()),
                        values_differ=int((ze != z).sum()), of=z.numel(),
                        plain_diff=float((ze - plain).abs().max()))
        runs = [("this", ours)]
        if parent is not None:
            runs = [("parent", parent), ("this", ours), ("this", ours),
                    ("parent", parent)]
        for who, lib in runs:
            r.setdefault(who, []).append(
                ks.timed(functools.partial(call, lib, x, z0), "hill_"))
        if name.endswith("parity clustered"):
            # the same turns, each after the yardstick as chip_smoke's
            # check_kernels runs it before the kernels' device_ms
            for who, lib in runs:
                lib_ms, backend, lib_z = cs.sdpa_yardstick(x, z0)
                r.setdefault(f"{who}_after_yardstick", []).append(
                    ks.timed(functools.partial(call, lib, x, z0), "hill_"))
            r["yardstick"] = dict(ms=lib_ms, backend=backend, plain_err=float(
                (lib_z - plain).abs().max()))
        if clocked is not None and d == cs.CAT_D:
            zc = call(clocked, x, z0)
            r["same_as_clocked"] = bool(torch.equal(zc, z))
            bf16 = x.dtype == torch.bfloat16
            r["clocks"] = clock_split(
                clocked, r["plan"]["grid"], bf16,
                r["plan"]["x_resident_bytes"] < x.numel() * x.element_size())
        res["cases"][name] = r
        print(f"[{name}] n {n}: {json.dumps(r)}", flush=True)
    if out_file:
        with open(out_file, "w") as f:
            json.dump(res, f, indent=1)
    if not ok:
        raise SystemExit("a kernel's Z is not deterministic or strays past "
                         "chip_smoke.Z_TOL")


def time_variants(edits_file: str, out_file: str | None) -> None:
    """Edited copies of this tree's csrc/mean_shift.cu against the tree, in
    turns: the bf16 hill climb at width 128 on chip_smoke's clustered
    inputs at the frame and both crops (device ms, Z against the plain
    version), and what ptxas says of each copy's hill_bf16_wide_kernel
    (registers, spills, its Potential Performance Loss notes)."""
    import torch
    import chip_smoke as cs
    import kernel_study as ks
    from unseenobjectclustering_torch.ops import _build
    from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
    from unseenobjectclustering_torch.ops import cuda_seeding
    if not torch.cuda.is_available():
        sys.exit("hill_climb_study: no CUDA device is available")
    with open(edits_file) as f:
        variants = json.load(f)  # {name: [[old, new], ...]}
    src = os.path.join(_build.CSRC, "mean_shift.cu")
    with open(src) as f:
        text = f.read()
    res: dict = {"card": cs.card_line(), "ptxas": {}, "cases": {}}
    print(res["card"])
    libs = {"tree": _build.library()}
    work = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(work, exist_ok=True)
    for name, edits in variants.items():
        t = text
        for old, new in edits:
            if old not in t:
                raise SystemExit(f"variant {name}: no {old[:60]!r}")
            t = t.replace(old, new)
        path = os.path.join(work, f"{name}.cu")
        with open(path, "w") as f:
            f.write(t)
        libs[name], log = hill_lib(path, f"libvariant_{name}.so",
                                   f"-I{_build.CSRC}")
        res["ptxas"][name] = ks.ptxas_lines(log, "hill_bf16_wide") + sorted(
            {line.split("Loss: ")[-1][:100] for line in log.splitlines()
             if "Potential Performance Loss" in line
             and "hill_bf16_wide" in line})
        print(name, json.dumps(res["ptxas"][name]), flush=True)
    sub = int(cs.FAST_CLUSTER["SEED_SUBSAMPLE"])
    for where, d, _, x32 in ks.clustered_inputs():
        if d != cs.CAT_D:
            continue
        x = x32.bfloat16()
        xs = x[::sub]
        z0 = cuda_seeding.select_seeds_reference(
            xs, cs.M, 12345 % xs.shape[0])[0].float().contiguous()
        plain = cms.hill_climb_reference(x, z0)
        row = {name: {"plain_err": float((call(lib, x, z0) - plain)
                                         .abs().max()), "device_ms": []}
               for name, lib in libs.items()}
        for name in list(libs) + list(libs)[::-1]:
            row[name]["device_ms"].append(cs.device_ms(
                functools.partial(call, libs[name], x, z0), "hill_", ks.REPS))
        res["cases"][where] = row
        print(where, json.dumps(row), flush=True)
    if out_file:
        with open(out_file, "w") as f:
            json.dump(res, f, indent=1)


# ---------------------------------------------------------------------------
# emulate (CPU; tests/test_torch_hill_wide.py holds it to the float64 result)
# ---------------------------------------------------------------------------

F32, F64 = torch.float32, torch.float64
KAPPA, ITERS = 20.0, 10
SMS = 132  # the H100's SMs: the plan's blocks, one an SM
# per width: pixels per tile, pixels per W X product (a half tile at d =
# 64), the reducing threads per group of blocks, and the big steps per
# group of S and of W X
WIDTHS = {64: dict(tile=128, product=64, per_group=64, s_big=2, w_big=2),
          128: dict(tile=32, product=32, per_group=32, s_big=4, w_big=2)}
# |S - S_exact| at d = 128, as the kernel's note bounds it
S_BOUND_128 = (36 * 2.0 ** -25 + 4 * 2.0 ** -23 + 3 * 2.0 ** -24
               + 3 * 2.0 ** -22 + 2.0 ** -26 + 2.0 ** -29)


def rn32(v):
    return v.to(F32)


def rz32(v):
    """v (float64) rounded to float32 toward zero."""
    r = v.to(F32)
    up = r.to(F64).abs() > v.abs()
    return torch.where(up, torch.nextafter(r, torch.zeros_like(r)), r)


def split(a):
    """split_tf32_rn: big = tf32(a) by Veltkamp's split (float32 ops),
    small = a - big rounded to tf32 (nearest, ties away); both as
    float64."""
    a = a.to(F32)
    t = a * 8193.0
    big = t - (t - a)
    u = (a - big).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    mag = ((u & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000
    small = ((u & 0x80000000) | mag)
    small = (small - ((small >> 31) << 32)).to(torch.int32).view(F32)
    return big.to(F64), small.to(F64)


def step(acc, terms, model: str):
    """One wgmma step: acc (float32) plus its 8 exact products terms
    [..., 8] (float64) under `model`."""
    if model in ("rn", "rz"):
        total = acc.to(F64) + terms.sum(-1)
        return rn32(total) if model == "rn" else rz32(total)
    every = torch.cat([acc.to(F64)[..., None], terms], -1)
    top = every.abs().amax(-1, keepdim=True)
    _, e = torch.frexp(torch.where(top > 0, top, torch.ones_like(top)))
    quantum = torch.ldexp(torch.ones_like(top),
                          (e - 1 - 23 - int(model[2:])).to(F64))
    return rz32((torch.trunc(every / quantum) * quantum).sum(-1))


def grouped(chunks, big, products, shape, model, out=None, device="cpu"):
    """A product of `chunks` k-chunks of 8 in the kernel's order: the small
    steps and the first `big` big ones in one accumulator, each later group
    the next `big` big ones in a fresh one; the groups added in order on
    the CUDA cores (float32, nearest), to `out` where given (a block's W X
    sum) or to each other.  products(kind, k) -> the exact terms [..., 8]
    of step k; kind 'sb' (small Z or W times big X), 'bs' or 'bb'."""
    big = min(big, chunks)
    for g in range(chunks // big):
        acc = torch.zeros(shape, dtype=F32, device=device)
        if g == 0:
            for k in range(chunks):
                acc = step(acc, products("sb", k), model)
                acc = step(acc, products("bs", k), model)
        for k in range(g * big, (g + 1) * big):
            acc = step(acc, products("bb", k), model)
        out = acc if out is None else rn32(out.to(F64) + acc.to(F64))
    return out


def emulate(x, z0, grid=None, model="al2", big=None, iters=ITERS):
    """The split TF32 hill climb's float32 arithmetic at d = 64
    (hill_tf32_kernel) or 128 (hill_tf32_wide_kernel), `iters` iterations
    from z0: each operand split as big + small, S = Z X^T and W X per
    product of 64 or 32 pixels in wgmma steps in the kernel's order and
    groups, W = exp(kappa S), each block's sum over its tiles (b, b +
    grid, ...) in order, the blocks' partials in groups of blocks, the
    row norm as the reducing warp computes it.  `model` is the tensor
    cores' accumulator: `rn` and `rz` round each step's exact sum once
    (nearest, toward zero); `alG` aligns each step's 9 terms (the
    accumulator and 8 products) to the largest, truncates each one G bits
    below the largest's last bit and rounds their sum toward zero.  `grid`
    is the plan's blocks (one an SM by default), `big` the big steps per
    group of both products in place of the kernel's (the d = 64 survey's
    builds).  x [n, d], z0 [m, d] float32, on the CPU or the card: there W
    is torch's float32 exp, which is CUDA's expf as in the kernel, on the
    CPU the float64 exp rounded to nearest (expf is not correctly
    rounded).  Returns Z and the largest |S - S_exact| over the
    iterations."""
    x = torch.as_tensor(x, dtype=F32)
    z = torch.as_tensor(z0, dtype=F32, device=x.device)
    (n, d), m, dev = x.shape, z.shape[0], x.device
    lay = WIDTHS[d]
    tile, prod = lay["tile"], lay["product"]
    tiles = -(-n // tile)
    grid = grid or min(SMS, tiles)
    groups = 128 * -(-m // 64) // lay["per_group"]
    xp = torch.zeros(tiles * tile, d, dtype=F32, device=dev)
    xp[:n] = x
    xparts = dict(zip("bs", split(xp)))
    s_err = 0.0
    for _ in range(iters):
        zparts = dict(zip("bs", split(z)))
        s = grouped(d // 8, big or lay["s_big"], lambda kind, k: (
            zparts[kind[0]][:, None, 8 * k:8 * k + 8]
            * xparts[kind[1]][None, :, 8 * k:8 * k + 8]),
            (m, tiles * tile), model, device=dev)
        exact = z.to(F64) @ x.to(F64).T
        s_err = max(s_err, float((s[:, :n].to(F64) - exact).abs().max()))
        w = rn32(KAPPA * s.to(F64))
        w = torch.exp(w) if w.is_cuda else rn32(torch.exp(w.to(F64)))
        wparts = dict(zip("bs", split(w)))
        part = torch.zeros(grid, m, d, dtype=F32, device=dev)
        for t0 in range(0, tiles, grid):  # the blocks' next tiles
            blocks = min(grid, tiles - t0)
            span = slice(t0 * tile, (t0 + blocks) * tile)
            for p0 in range(0, tile, prod):
                wt = {k: v[:, span].reshape(m, blocks, tile)
                      [:, :, p0:p0 + prod].permute(1, 0, 2)
                      for k, v in wparts.items()}    # [blocks, m, pixels]
                xt = {k: v[span].reshape(blocks, tile, d)
                      [:, p0:p0 + prod].transpose(1, 2)
                      for k, v in xparts.items()}    # [blocks, d, pixels]
                part[:blocks] = grouped(
                    prod // 8, big or lay["w_big"], lambda kind, k: (
                        wt[kind[0]][:, :, None, 8 * k:8 * k + 8]
                        * xt[kind[1]][:, None, :, 8 * k:8 * k + 8]),
                    (blocks, m, d), model, out=part[:blocks], device=dev)
        z = next_seeds(part, groups)
    return z, s_err


def next_seeds(part, groups):
    """The blocks' partials part [grid, m, d] (float32) summed as the
    reducing threads sum them (group q adds blocks q, q + groups, ... in
    order, then the groups are added in order) and each row normalized as
    the reducing warp does it."""
    grid, m, d = part.shape
    dev = part.device
    v = torch.zeros(m, d, dtype=F32, device=dev)
    for q in range(groups):  # blocks q, q + groups, ..., then in order
        a = torch.zeros(m, d, dtype=F32, device=dev)
        for b in range(q, grid, groups):
            a = rn32(a.to(F64) + part[b].to(F64))
        v = rn32(v.to(F64) + a.to(F64))
    # a reducing lane's dims: l and l + 32 at d = 64, a float4 at 128
    lanes = (v.reshape(m, 32, 4) if d == 128
             else v.reshape(m, 2, 32).transpose(1, 2)).to(F64)
    ss = rn32(lanes[..., 0] ** 2)
    for c in range(1, lanes.shape[-1]):  # fmaf: one rounding each
        ss = rn32(lanes[..., c] ** 2 + ss.to(F64))
    for off in (16, 8, 4, 2, 1):
        ss = rn32(ss.to(F64)
                  + ss[:, torch.arange(32, device=dev) ^ off].to(F64))
    den = torch.clamp(rn32(torch.sqrt(ss[:, :1].to(F64))), min=1e-12)
    return rn32(v.to(F64) / den.to(F64))


# hill_bf16_wide_kernel (bfloat16 at d = 128, csrc/mean_shift.cu): pixels
# per tile, tiles a block keeps in shared memory for the whole launch,
# stages of the ring that the other tiles stream through
BW_TILE, BW_RESIDENT, BW_STAGES = 64, 8, 5
# its exponent's factor, kappa log2(e) rounded to float32 once
K2 = float(torch.tensor(KAPPA, dtype=torch.float32)
           * torch.tensor(1.44269504088896341, dtype=torch.float32))


def bw_tile(it: int, k: int, resident: int, streamed: int) -> int:
    """bw_tile of the kernel: the block's own index of the k-th tile it
    sums in iteration `it` (its kept tiles first, then its streamed ones,
    ascending on even iterations and descending on odd ones)."""
    if k < resident:
        return k
    j = k - resident
    return resident + (streamed - 1 - j if it & 1 else j)


def bf16_wide_schedule(n: int, grid: int, it: int) -> list:
    """The tiles that each of the kernel's `grid` blocks sums in iteration
    `it`, in its order: per block a list of (tile, place), tile t holding
    pixels [64 t, 64 t + 64) and place ("kept", k) for the block's k-th
    resident slot or ("stage", s) for the ring stage that the producer
    loads it into (the q-th streamed tile of the launch, q = it * streamed
    + j, goes to stage q % BW_STAGES)."""
    tiles = -(-n // BW_TILE)
    out = []
    for b in range(grid):
        mine = (tiles - b + grid - 1) // grid
        res = min(mine, BW_RESIDENT)
        streamed = mine - res
        out.append([(b + bw_tile(it, k, res, streamed) * grid,
                     ("kept", k) if k < res else
                     ("stage", (it * streamed + k - res) % BW_STAGES))
                    for k in range(mine)])
    return out


def bf16_wide_resident_bytes(n: int, grid: int) -> int:
    """wide_bf16_resident_bytes of the kernel: the bytes of X that the
    blocks keep in shared memory for the whole launch."""
    return sum(2 * 128 * min(BW_TILE, n - BW_TILE * t)
               for block in bf16_wide_schedule(n, grid, 0)
               for t, (kind, _) in block if kind == "kept")


def bf16(v):
    """v rounded to bfloat16 (nearest even), as float64."""
    return v.to(torch.bfloat16).to(F64)


def emulate_bf16(x, z0, grid=None, model="al2", iters=ITERS, chunk=16):
    """hill_bf16_wide_kernel's arithmetic (bfloat16 X at d = 128), `iters`
    iterations from z0: S = bf16(Z) X^T in wgmma steps of 16 dims (exact
    products of bf16 values, each step added to the accumulator under
    `model`, as in `emulate`), W = bf16(2^(K2 S)) with K2 S rounded to
    float32 (the kernel's ex2.approx, at most 2 ulp off, taken as exact:
    2^y rounded to float32 on the CPU, torch's exp2 on the card), each
    block's W X over its tiles in the kernel's schedule
    (bf16_wide_schedule: a tile's four steps of 16 pixels in order, the
    block's tiles in its order for the iteration), the partials summed and
    the rows normalized as the kernel's consumers do (next_seeds, 4 groups
    of blocks a consumer warpgroup).  `grid` is the plan's blocks (one an
    SM by default); `chunk` the blocks emulated at once.  x [n, 128]
    (bfloat16 values, any float dtype), z0 [m, 128]; W's exp as in
    `emulate`.  Returns Z (float32)."""
    x = torch.as_tensor(x).to(F64)
    z = torch.as_tensor(z0, dtype=F32, device=x.device)
    (n, d), m, dev = x.shape, z.shape[0], x.device
    tiles = -(-n // BW_TILE)
    grid = grid or min(SMS, tiles)
    groups = 4 * -(-m // 64)
    xp = torch.zeros(tiles * BW_TILE, d, dtype=F64, device=dev)
    xp[:n] = bf16(x)
    xt = xp.reshape(tiles, BW_TILE, d)
    for it in range(iters):
        zb = bf16(z.to(F64))
        s = torch.zeros(m, tiles * BW_TILE, dtype=F32, device=dev)
        for p0 in range(0, tiles * BW_TILE, 4096):
            cols = slice(p0, p0 + 4096)
            acc = torch.zeros(m, xp[cols].shape[0], dtype=F32, device=dev)
            for kk in range(d // 16):
                dims = slice(16 * kk, 16 * kk + 16)
                acc = step(acc, zb[:, None, dims] * xp[None, cols, dims],
                           model)
            s[:, cols] = acc
        y = rn32(K2 * s.to(F64))
        w = torch.exp2(y) if y.is_cuda else rn32(torch.exp2(y.to(F64)))
        wt = bf16(w.to(F64)).reshape(m, tiles, BW_TILE)
        sched = bf16_wide_schedule(n, grid, it)
        part = torch.zeros(grid, m, d, dtype=F32, device=dev)
        for b0 in range(0, grid, chunk):
            blocks = sched[b0:b0 + chunk]
            acc = torch.zeros(len(blocks), m, d, dtype=F32, device=dev)
            for k in range(max(len(bl) for bl in blocks)):
                has = torch.tensor([k < len(bl) for bl in blocks],
                                   device=dev)
                tl = torch.tensor([bl[min(k, len(bl) - 1)][0]
                                   for bl in blocks], device=dev)
                for kc in range(BW_TILE // 16):
                    px = slice(16 * kc, 16 * kc + 16)
                    ws = wt[:, tl, px].permute(1, 0, 2)       # [B, m, 16]
                    xs = xt[tl, px].transpose(1, 2)           # [B, d, 16]
                    new = step(acc, ws[:, :, None, :] * xs[:, None], model)
                    acc = torch.where(has[:, None, None], new, acc)
            part[b0:b0 + len(blocks)] = acc
        z = next_seeds(part, groups)
    return z


def emulate_file(path: str, models: list[str]) -> None:
    """The emulation against the kernel results saved in `path`: the d =
    64 survey's builds by grouping, or this tree's kernel (`time --crops`,
    with the plan's grid; float32, or bfloat16 at d = 128, held to the
    plain version)."""
    saved = np.load(path)
    x, z0 = torch.from_numpy(saved["x"]), torch.from_numpy(saved["z0"])
    if "bf16" in saved:
        kernel = torch.from_numpy(saved["this"])
        plain = torch.from_numpy(saved["plain"])
        for model in models:
            t = time.perf_counter()
            z = emulate_bf16(x, z0, int(saved["grid"]), model)
            print(f"{os.path.basename(path)} (bfloat16, d = 128), model "
                  f"{model}: emulation - kernel "
                  f"{(z - kernel).abs().max():.3e} "
                  f"({int((z != kernel).sum())} of {z.numel()} values "
                  f"differ), emulation - plain {(z - plain).abs().max():.3e}"
                  f", kernel - plain {(kernel - plain).abs().max():.3e} "
                  f"({time.perf_counter() - t:.0f} s)", flush=True)
        return
    z64 = torch.from_numpy(saved["z64"]).to(F64)
    d = x.shape[1]
    grid = int(saved["grid"]) if "grid" in saved else None
    runs = {name: big for name, big in GROUPINGS.items() if name in saved}
    if "this" in saved:
        runs["this"] = None
    for name, big in runs.items():
        kernel = torch.from_numpy(saved[name]).to(F64)
        for model in models:
            t = time.perf_counter()
            z, s_err = emulate(x, z0, grid, model, big)
            z = z.to(F64)
            print(f"{os.path.basename(path)} {name} (d = {d}, "
                  f"{big or 'the kernel' + chr(39) + 's'} big steps per "
                  f"group), model {model}: emulation - kernel "
                  f"{(z - kernel).abs().max():.3e} "
                  f"({int((z != kernel).sum())} of {z.numel()} values "
                  f"differ), emulation - float64 "
                  f"{(z - z64).abs().max():.3e}, kernel - float64 "
                  f"{(kernel - z64).abs().max():.3e}, largest |S - "
                  f"S_exact| {s_err:.3e}"
                  + (f" (bound {S_BOUND_128:.3e})" if d == 128 else "")
                  + f" ({time.perf_counter() - t:.0f} s)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("survey")
    sv.add_argument("--out", default="chiprun_out/hill_climb_study")
    tm = sub.add_parser("time")
    tm.add_argument("--parent", default=None)
    tm.add_argument("--clocks", action="store_true")
    tm.add_argument("--out", default=None)
    tm.add_argument("--crops", default=None,
                    help="a directory for the 128^2 float32 crops")
    va = sub.add_parser("variants")
    va.add_argument("edits", help="JSON: {name: [[old, new], ...]}")
    va.add_argument("--out", default=None)
    em = sub.add_parser("emulate")
    em.add_argument("file")
    em.add_argument("--model", nargs="+", default=["al2"])
    args = ap.parse_args(argv)
    if args.cmd == "survey":
        survey(args.out)
    elif args.cmd == "time":
        time_trees(args.parent, args.clocks, args.out, args.crops)
    elif args.cmd == "variants":
        time_variants(args.edits, args.out)
    else:
        emulate_file(args.file, args.model)


if __name__ == "__main__":
    main()
