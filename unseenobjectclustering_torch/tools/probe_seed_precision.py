"""Audit every farthest-point seeding route against a float64 replay (the
port of the JAX package's tools/probe_seed_precision.py).

Each route's seed picks are walked through an exact float64 numpy replay of
the reference selection rule (lib/utils/mean_shift.py:128-189).  The
port's routes:

  plain   ops/mean_shift.select_smart_seeds  (torch ops; on the card,
                                              cuBLAS matvecs), always
  kernel  ops/cuda_seeding.select_seeds      (csrc/seeding.cu
                                              select_seeds_kernel), on a
                                              CUDA device only

The JAX tool's `lazy` route (select_smart_seeds_lazy: stale per-block
bounds for an X that does not fit on chip) has its counterpart in the
kernel route: at d = 128, where a block's pixels do not all fit on chip
(the 480x640 frame), the kernel keeps them in lazy tiles with stale
bounds; the output names the kernel's path for the input.  The JAX tool's
`pallas` route is the kernel route's TPU counterpart, and its VMEM-fit
check belongs to the TPU.  A route PASSES if every divergence from the
float64 replay is an fp32 near-tie (exact-distance gap < TIE_GAP); a
larger gap means the route's distances are wrong, not merely rounded.
The exit code is 1 if a route fails.

Runs on cuda:<--gpu> unless given --device cpu.

Usage:
  python -m unseenobjectclustering_torch.tools.probe_seed_precision \\
      [--n 50176] [--m 100] [--d 64] [--seed 0] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from unseenobjectclustering_torch.engine.pipeline import (_full_fp32,
                                                          resolve_device)
from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_torch.ops.mean_shift import select_smart_seeds

TIE_GAP = 1e-5
FIRST = 5


def replay_audit(x: np.ndarray, idx: np.ndarray, first: int, m: int
                 ) -> tuple[int, float]:
    """Walk the route's picks through an exact float64 replay.

    At each step the replay takes the ROUTE's pick (so one near-tie does
    not cascade into meaningless comparisons) but records the exact-
    distance gap between the route's pick and the true argmax."""
    x64 = x.astype(np.float64)
    md = 0.5 * (1.0 - x64 @ x64[first])
    worst = 0.0
    n_div = 0
    for k in range(1, m):
        best = int(np.argmax(md))
        got = int(idx[k])
        if got != best:
            n_div += 1
            worst = max(worst, float(md[best] - md[got]))
        md = np.minimum(md, 0.5 * (1.0 - x64 @ x64[got]))
    return n_div, worst


def routes(device: torch.device) -> dict[str, Callable]:
    """The seeding routes on `device`: name -> fn(x, m, first) -> seed
    indices."""
    out = {"plain": lambda x, m, first: select_smart_seeds(
        x, m, metric="cosine", first_index=first)[1]}
    if device.type == "cuda":
        out["kernel"] = lambda x, m, first: cuda_seeding.select_seeds(
            x, m, first)[1]
    return out


def main(argv: Optional[Sequence[str]] = None,
         x: Optional[np.ndarray] = None) -> dict:
    """Run the audit; returns {"n", "d", "m", "routes": {name:
    {"divergences", "worst_gap", "pass"}}, "ok"} (on the card also
    "kernel_path", eager or lazy).  `x` ([n, d] unit
    vectors, e.g. a trained network's embeddings) replaces the random
    vectors of --n/--d/--seed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=50176)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gpu", dest="gpu_id", type=int, default=0,
                    help="run on cuda:<gpu>")
    ap.add_argument("--device", type=str, default=None,
                    help="another device than cuda:<gpu> (cpu for the "
                         "tests)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device or f"cuda:{args.gpu_id}")

    if x is None:
        rng = np.random.default_rng(args.seed)
        x = rng.normal(size=(args.n, args.d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    xd = torch.from_numpy(x).to(device)
    print(f"# device={device} n={n} d={d} m={args.m} tie-gap<{TIE_GAP}",
          flush=True)

    out = {"n": n, "d": d, "m": args.m, "routes": {}}
    if device.type == "cuda":
        out["kernel_path"] = ("lazy" if cuda_seeding.launch_config(xd)["lazy"]
                              else "eager")
        print(f"# kernel path: {out['kernel_path']}", flush=True)
    ok = True
    for name, fn in routes(device).items():
        with torch.inference_mode(), _full_fp32():
            idx = fn(xd, args.m, FIRST).cpu().numpy()
        n_div, worst = replay_audit(x, idx, FIRST, args.m)
        passed = worst < TIE_GAP
        ok &= passed
        out["routes"][name] = {"divergences": n_div, "worst_gap": worst,
                               "pass": passed}
        print(f"{name:7s} {'PASS' if passed else 'FAIL'}: {n_div} "
              f"divergences from f64 replay, worst exact-distance gap "
              f"{worst:.3e}", flush=True)
    out["ok"] = ok
    return out


if __name__ == "__main__":
    raise SystemExit(0 if main()["ok"] else 1)
