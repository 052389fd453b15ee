#!/usr/bin/env python3
"""How accurate the float32 hill-climb kernel is on trained crop embeddings.

    python3 hill_climb_study.py survey [--out DIR]     # on one NVIDIA GPU
    python3 hill_climb_study.py emulate FILE.npz [--model al2 ...]  # CPU

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

`emulate` replays the kernel's float32 arithmetic on the CPU (split TF32
operands, wgmma steps in the kernel's order and groups, the CUDA cores'
adds, the block and row reductions) with a model of the tensor cores'
accumulator, and prints its distance from the saved kernel results and
from the float64 result.  Models: `rn` and `rz` round each step's exact
sum once (nearest, toward zero); `alG` aligns each step's terms (the
accumulator and eight products) to the largest and truncates each one G
bits below the largest's last bit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GROUPINGS = {"one": 8, "pairs": 2, "single": 1}  # big steps per group
EPOCHS = (10, 15, 20)


# ---------------------------------------------------------------------------
# survey (card)
# ---------------------------------------------------------------------------

def build_variants(out: dict) -> dict:
    """ctypes libraries of the kernels built with each grouping; prints
    the float32 hill climb's registers and spills."""
    from unseenobjectclustering_torch.ops import _build
    nvcc = _build._nvcc()
    procs = {}
    for name, big in GROUPINGS.items():
        bdir = os.path.join(_build.BUILD_DIR, f"study_{name}")
        os.makedirs(bdir, exist_ok=True)
        procs[name] = (bdir, [subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, f"-DHILL_BIG_PER_GROUP={big}",
             "-Xptxas", "-v", "-c", os.path.join(_build.CSRC, src), "-o",
             os.path.join(bdir, src + ".o")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for src in _build.SOURCES])
    libs = {}
    for name, (bdir, ps) in procs.items():
        logs = [p.communicate()[0] for p in ps]
        if any(p.returncode for p in ps):
            raise RuntimeError("\n".join(logs))
        lines = logs[_build.SOURCES.index("mean_shift.cu")].splitlines()
        at = next(i for i, line in enumerate(lines) if "hill_tf32" in line
                  and "Compiling" in line)
        regs = " ".join(line.split(":", 1)[-1].strip()
                        for line in lines[at + 2:at + 4])
        print(f"[{name}] hill_tf32_kernel: {regs}")
        out.setdefault("ptxas", {})[name] = regs
        so = os.path.join(bdir, "libstudy.so")
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", so]
                       + [os.path.join(bdir, s + ".o")
                          for s in _build.SOURCES], check=True)
        lib = ctypes.CDLL(so)
        for entry in ("uoc_hill_climb", "uoc_hill_climb_plan"):
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
        libs[name] = lib
    return libs


def hill(lib, x, z0):
    """The float32 kernel of `lib` on x [n, 64], z0 [m, 64] (chip_smoke's
    kappa and iterations)."""
    import torch
    import chip_smoke as cs
    from unseenobjectclustering_torch.ops import _build
    n, m = x.shape[0], z0.shape[0]
    plan = (ctypes.c_longlong * 5)()
    assert lib.uoc_hill_climb_plan(0, n, m, ctypes.addressof(plan)) == 0
    partial = torch.empty((int(plan[0]), m, cs.D), device=x.device)
    arrived = torch.empty(1, dtype=torch.int32, device=x.device)
    z = torch.empty((m, cs.D), device=x.device)
    z0 = z0.float().contiguous()
    err = lib.uoc_hill_climb(x.data_ptr(), 0, n, z0.data_ptr(), m, cs.KAPPA,
                             cs.ITERS, partial.data_ptr(), arrived.data_ptr(),
                             z.data_ptr(), _build.stream(x))
    _build.check(err, "hill_climb (study)")
    return z


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
            z = hill(lib, x, z0)
            row[name] = dict(
                ms=cs.time_ms(lambda: hill(lib, x, z0), 30),
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
                        zs = {k: hill(lib, x, z0) for k, lib in libs.items()}
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
# emulate (CPU)
# ---------------------------------------------------------------------------

F32, F64 = np.float32, np.float64
KAPPA, ITERS = 20.0, 10


def rn32(v):
    return v.astype(F32)


def rz32(v):
    r = v.astype(F32)
    up = np.abs(r.astype(F64)) > np.abs(v)
    r[up] = np.nextafter(r[up], F32(0))
    return r


def split_rn(a):
    """split_tf32_rn: big = tf32(a) by Veltkamp's split, small = a - big
    rounded to tf32 (nearest, ties away)."""
    a = a.astype(F32)
    with np.errstate(over="ignore"):
        t = a * F32(8193.0)
        big = t - (t - a)
    u = (a - big).astype(F32).view(np.uint32)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(
        0xFFFFE000)
    return big.astype(F32), ((u & np.uint32(0x80000000)) | mag).view(F32)


def step(acc, terms, model: str):
    """One wgmma step: acc (float32) plus the step's exact products terms
    [..., 8] under `model`."""
    if model == "rn":
        return rn32(acc.astype(F64) + terms.sum(-1))
    if model == "rz":
        return rz32(acc.astype(F64) + terms.sum(-1))
    bits = int(model[2:])
    every = np.concatenate([acc.astype(F64)[..., None], terms], -1)
    top = np.abs(every).max(-1, keepdims=True)
    quantum = np.exp2(np.floor(np.log2(np.where(top > 0, top, 1.0)))
                      - 23 - bits)
    return rz32((np.trunc(every / quantum) * quantum).sum(-1))


def grouped(big_per_group: int, products, model: str, shape):
    """The kernel's order: the 16 small steps and the first big ones in one
    accumulator, the other big steps in groups, the groups added in
    float32.  products(kind, k) -> exact terms [..., 8] of step k, kind
    'sb' (small Z or W x big X), 'bs' or 'bb'."""
    out = None
    for g in range(8 // big_per_group):
        acc = np.zeros(shape, F32)
        if g == 0:
            for k in range(8):
                acc = step(acc, products("sb", k), model)
                acc = step(acc, products("bs", k), model)
        for k in range(g * big_per_group, (g + 1) * big_per_group):
            acc = step(acc, products("bb", k), model)
        out = acc if out is None else rn32(out.astype(F64) + acc.astype(F64))
    return out


def emulate(x, z0, big_per_group: int, model: str):
    n, d = x.shape
    m = z0.shape[0]
    tiles = -(-n // 128)
    grid = min(132, tiles)  # one block per SM of the H100, as the plan
    xp = np.zeros((tiles * 128, d), F32)
    xp[:n] = x
    halves = tiles * 2
    xparts = dict(zip("bs", (p.astype(F64) for p in split_rn(xp))))
    z = z0.astype(F32)
    for _ in range(ITERS):
        zparts = dict(zip("bs", (p.astype(F64) for p in split_rn(z))))
        s = grouped(big_per_group, lambda kind, k: (
            zparts[kind[0]][:, None, 8 * k:8 * k + 8]
            * xparts[kind[1]][None, :, 8 * k:8 * k + 8]), model,
            (m, xp.shape[0]))
        w = rn32(np.exp(rn32(KAPPA * s.astype(F64)).astype(F64)))
        wparts = {k: p.astype(F64).reshape(m, halves, 64).transpose(1, 0, 2)
                  for k, p in zip("bs", split_rn(w))}
        xh = {k: p.reshape(halves, 64, d) for k, p in xparts.items()}
        sums = grouped(big_per_group, lambda kind, k: np.moveaxis(
            wparts[kind[0]][:, :, 8 * k:8 * k + 8, None]
            * xh[kind[1]][:, None, 8 * k:8 * k + 8, :], 2, -1), model,
            (halves, m, d))
        part = np.zeros((grid, m, d), F32)
        for b in range(grid):  # each block's tiles, in order
            for t in range(b, tiles, grid):
                for h in range(2):
                    part[b] = rn32(part[b].astype(F64)
                                   + sums[2 * t + h].astype(F64))
        v = np.zeros((m, d), F32)
        for q in range(4):  # reduce_row: 4 groups of blocks, then in order
            a = np.zeros((m, d), F32)
            for b in range(q, grid, 4):
                a = rn32(a.astype(F64) + part[b].astype(F64))
            v = rn32(v.astype(F64) + a.astype(F64))
        ss = rn32(v[:, :32].astype(F64) ** 2)
        ss = rn32(v[:, 32:].astype(F64) ** 2 + ss.astype(F64))
        for off in (16, 8, 4, 2, 1):
            ss = rn32(ss.astype(F64) + ss[:, np.arange(32) ^ off].astype(F64))
        den = np.maximum(np.sqrt(ss[:, :1].astype(F64)).astype(F32),
                         F32(1e-12))
        z = rn32(v.astype(F64) / den.astype(F64))
    return z


def emulate_file(path: str, models: list[str]) -> None:
    saved = np.load(path)
    x, z0, z64 = saved["x"], saved["z0"], saved["z64"]
    for name, big in GROUPINGS.items():
        if name not in saved:
            continue
        kernel = saved[name].astype(F64)
        for model in models:
            t = time.perf_counter()
            z = emulate(x, z0, big, model).astype(F64)
            print(f"{os.path.basename(path)} {name} ({big} big steps per "
                  f"group), model {model}: emulation - kernel "
                  f"{np.abs(z - kernel).max():.3e}, emulation - float64 "
                  f"{np.abs(z - z64).max():.3e}, kernel - float64 "
                  f"{np.abs(kernel - z64).max():.3e} "
                  f"({time.perf_counter() - t:.0f} s)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    sv = sub.add_parser("survey")
    sv.add_argument("--out", default="chiprun_out/hill_climb_study")
    em = sub.add_parser("emulate")
    em.add_argument("file")
    em.add_argument("--model", nargs="+", default=["al2"])
    args = ap.parse_args(argv)
    if args.cmd == "survey":
        survey(args.out)
    else:
        emulate_file(args.file, args.model)


if __name__ == "__main__":
    main()
