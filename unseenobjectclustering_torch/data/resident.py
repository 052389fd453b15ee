"""Device-resident dataset: read the whole render cache onto the training
device once.

Port of ``unseenobjectclustering_tpu/data/resident.py``.  The cached
scenes (uint8 BGR + uint16 depth in mm + uint8 labels, 1.84 MB a scene at
480x640) go to the device once; each training step then sends only an
index vector, and the gather, augmentation, forward, backward and update
run on the device (engine.train.make_train_step_resident).  The streaming
loader (data.loader.DataLoader) stays the path for caches larger than the
device's memory.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Optional

import numpy as np
import torch

from unseenobjectclustering_torch.engine.pipeline import resolve_device


def load_resident_scenes(cache_dir: str, limit: Optional[int] = None,
                         device: Any = None, mesh=None
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Read every cached scene into three tensors on `device` (default:
    the CUDA device; raises without one), or on the device of each rank of
    a parallel.Mesh: every rank holds all the scenes, as the JAX package
    replicates them over its mesh.

    With `limit`, scenes are addressed by index (`000000.npz` ..
    `{limit-1:06d}.npz`) and every file must exist: a partly rendered
    cache raises instead of shrinking the dataset and re-mapping
    index -> scene (the streaming and resident paths shuffle the same
    indices with RandomState(seed + epoch)).  Without it the cache must be
    contiguous from 000000.

    Returns (bgr [N,H,W,3] uint8, depth_mm [N,H,W] int32, label [N,H,W]
    uint8).  Depth is widened to int32 (torch has no uint16 arithmetic on
    every device); its values are the cache's.
    """
    device = mesh.device if mesh is not None else resolve_device(device)
    if limit is not None:
        files = [os.path.join(cache_dir, f"{i:06d}.npz")
                 for i in range(limit)]
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            raise FileNotFoundError(
                f"render cache {cache_dir} holds only "
                f"{limit - len(missing)} of the {limit} requested scenes "
                f"(first missing: {os.path.basename(missing[0])}); "
                "re-render with tools.render_dataset or lower "
                "--resident-limit")
    else:
        files = sorted(glob.glob(os.path.join(cache_dir, "*.npz")))
        for i, f in enumerate(files):
            if os.path.basename(f) != f"{i:06d}.npz":
                raise FileNotFoundError(
                    f"render cache {cache_dir} is not contiguous: expected "
                    f"{i:06d}.npz at position {i}, found "
                    f"{os.path.basename(f)}; re-render or pass an explicit "
                    "limit")
    if not files:
        raise FileNotFoundError(f"no cached scenes in {cache_dir}")
    with np.load(files[0]) as first:
        h, w = first["depth_mm"].shape
    n = len(files)
    bgr = np.empty((n, h, w, 3), np.uint8)
    depth = np.empty((n, h, w), np.uint16)
    label = np.empty((n, h, w), np.uint8)
    for i, f in enumerate(files):
        with np.load(f) as z:
            bgr[i] = z["bgr"]
            depth[i] = z["depth_mm"]
            label[i] = z["label"]
    return (torch.from_numpy(bgr).to(device),
            torch.from_numpy(depth.astype(np.int32)).to(device),
            torch.from_numpy(label).to(device))
