"""Pre-render procedural synthetic scenes to an on-disk cache (the port's
copy of the JAX package's tools/render_dataset.py, with a process pool).

Each scene is a pure function of its index: render it once, and every
training run loads it from disk (--render-cache) instead of ray casting
again.  numpy only (no torch is imported); the scenes not yet cached are
rendered on one spawned process per CPU core.

Usage:
  python -m unseenobjectclustering_torch.tools.render_dataset \\
      --cache-dir output/render_cache --height 480 --width 640 --num 6000
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Sequence

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)


def _dataset(split: str, height: int, width: int, num: int,
             cache_dir: str) -> SyntheticTabletopDataset:
    ds = SyntheticTabletopDataset(
        split, Config.from_dict({"INPUT": "RGBD", "MODE": "TRAIN"}),
        height=height, width=width, size=num, cache_dir=cache_dir)
    ds._cache_cap_bytes = 0  # disk only; keep the process small
    return ds


def _render(spec: tuple, idx: int) -> float:
    """Render scene idx into the cache; the seconds it took."""
    ds = _dataset(*spec)
    t0 = time.perf_counter()
    ds.get_scene(idx)
    return time.perf_counter() - t0


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Render the scenes not yet cached; returns the count rendered, the
    wall seconds and each scene's seconds."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cache-dir", default="output/render_cache")
    p.add_argument("--split", default="train", choices=["train", "test"])
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--num", type=int, default=6000)
    p.add_argument("--start", type=int, default=0)
    args = p.parse_args(argv)

    spec = (args.split, args.height, args.width, args.num, args.cache_dir)
    ds = _dataset(*spec)
    ds.check_cache_manifest()
    todo = [i for i in range(args.start, args.num)
            if not os.path.exists(ds._scene_path(i))]
    render = functools.partial(_render, spec)
    workers = max(min(os.cpu_count() or 1, len(todo)), 1)
    t0 = time.time()
    seconds: list[float] = []
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        for i, s in zip(todo, pool.map(render, todo)):
            seconds.append(s)
            if len(seconds) % 50 == 0:
                rate = len(seconds) / (time.time() - t0)
                eta = (len(todo) - len(seconds)) / max(rate, 1e-9)
                print(f"[{i + 1}/{args.num}] {rate:.2f} scenes/s, "
                      f"eta {eta / 60:.1f} min", flush=True)
    wall = time.time() - t0
    mean = sum(seconds) / max(len(seconds), 1)
    print(f"done: {len(todo)} rendered, "
          f"{args.num - args.start - len(todo)} already cached, "
          f"{wall:.2f} s on {workers} processes, {mean:.3f} s/scene in "
          "one process")
    return {"rendered": len(todo), "wall_s": wall, "scene_s": seconds,
            "processes": workers}


if __name__ == "__main__":
    main()
