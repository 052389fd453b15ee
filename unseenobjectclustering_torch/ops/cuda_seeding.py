"""Farthest-point seeding: the CUDA kernel's wrapper and its plain version.

Counterpart of ``unseenobjectclustering_tpu/ops/pallas_seeding.py`` and,
where X is re-read, of the JAX package's ``select_smart_seeds_lazy``.  The
kernel is ``csrc/seeding.cu``: one persistent cooperative launch that holds
each block's slice of X on chip for all steps, exact fp32 dots, a packed
64-bit atomicMax argmax with the lowest index on a tie and one grid-wide
barrier per step.  At width 128, where a block's pixels do not all fit on
chip, the pixels past those are kept in lazy tiles with stale bounds and
only the tiles that could hold the next argmax are brought up to date
(``select_seeds_lazy_reference`` models that schedule in torch).  It takes
widths 64 and 128 (NUM_UNITS, 64 in every recipe, and twice that under the
RGB-D cat fusion) and raises on another on a CUDA tensor; the plain version
takes any width.
"""

from __future__ import annotations

from typing import Optional

import torch

from unseenobjectclustering_torch.ops import _build
from unseenobjectclustering_torch.ops.mean_shift import (
    _cosine_dist_to_point, select_smart_seeds)

launches = 0  # calls that launched the kernel
# [num_seeds - 1] int32 on the card: the lazy tiles the last launch
# refreshed at each step (every tile at step 0); None after an eager launch
refreshed: Optional[torch.Tensor] = None


def select_seeds_reference(x: torch.Tensor, num_seeds: int,
                           first_index: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: cosine farthest-point seeding in torch ops."""
    return select_smart_seeds(x, num_seeds, metric="cosine",
                              first_index=first_index)


def _keys(md: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """The kernel's packed argmax keys as int64: a larger key is a larger
    float32 value, then a lower index."""
    bits = md.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return ordered * 2 ** 32 + (2 ** 32 - 1 - index)


def select_seeds_lazy_reference(x: torch.Tensor, num_seeds: int,
                                first_index: int, tile: int, blocks: int,
                                on_chip: int = 0, ring: int = 64
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """Torch model of the kernel's lazy schedule, for the tests.

    Block b owns the pixels [b*len, b*len + len), len = ceil(n / blocks);
    its first `on_chip` pixels are brought up to date at every step, the
    rest are cut into tiles of `tile` pixels, each with a stale bound (the
    packed key of its max min-distance and its lowest index, at its last
    refresh) and the count of seeds applied then.  At each step a block's
    threshold is the best of its on-chip keys and of the previous step's
    block bests brought up to this step; every tile whose bound is not
    below it, or that has missed `ring` seeds (the kernel keeps the `ring`
    newest on chip), catches up on the seeds it missed, in seed order.  A
    block's best is that of its on-chip pixels and refreshed tiles, and the
    next seed the best of the block bests.  Skipped tiles keep stale
    min-distances, which no pick reads.  Each distance is the plain
    version's (one vector per seed, over x).

    Returns (seeds [m, d] in x.dtype, seed_indices [m] int32, refreshed
    [m - 1] int64: the tiles refreshed at each step, all of them at step 0).
    """
    n = x.shape[0]
    length = -(-n // blocks)
    chip = min(on_chip, length)
    tiles = -(-(length - chip) // tile)
    width = chip + tiles * tile
    dev = x.device
    slot = torch.arange(width, device=dev)
    index = torch.arange(blocks, device=dev)[:, None] * length + slot[None, :]
    real = (slot < length)[None, :] & (index < n)
    gather = index.clamp(max=n - 1)
    low = torch.iinfo(torch.int64).min
    tile_index = index[:, chip::tile] if tiles else index[:, :0]
    tile_real = real[:, chip:].reshape(blocks, tiles, tile).any(2)

    idxs = [int(first_index)]
    dists: list[torch.Tensor] = []  # [n] per seed

    def dist(k: int) -> torch.Tensor:
        while len(dists) <= k:
            dists.append(_cosine_dist_to_point(x, x[idxs[len(dists)]]))
        return dists[k]

    md = torch.zeros(blocks, width, device=dev)
    bound = torch.full((blocks, tiles), torch.iinfo(torch.int64).max,
                       device=dev)
    applied = torch.zeros(blocks, tiles, dtype=torch.int64, device=dev)
    cand_idx = cand_md = None  # the previous step's block bests
    counts = []
    for step in range(num_seeds - 1):
        d = dist(step)[gather[:, :chip]]
        md[:, :chip] = d if step == 0 else torch.minimum(md[:, :chip], d)
        on_keys = torch.where(real[:, :chip],
                              _keys(md[:, :chip], index[:, :chip]), low)
        on_best = (on_keys.max(1).values if chip
                   else torch.full((blocks,), low, device=dev))
        thresh = on_best
        if cand_idx is not None:
            now = torch.minimum(cand_md, dist(step)[cand_idx])
            thresh = torch.maximum(thresh, _keys(now, cand_idx).max())
        refresh = ((bound >= thresh[:, None]) | (step + 1 - applied >= ring)
                   ) & tile_real
        counts.append(int(refresh.sum()))
        if refresh.any():
            mdt = md[:, chip:].reshape(blocks, tiles, tile)
            oldest = int(applied[refresh].min())
            assert step + 1 - oldest <= ring  # every seed it needs is kept
            for k in range(oldest, step + 1):
                take = (refresh & (applied <= k))[..., None]
                dk = dist(k)[gather[:, chip:]].reshape(blocks, tiles, tile)
                mdt = torch.where(take, dk if k == 0
                                  else torch.minimum(mdt, dk), mdt)
            md[:, chip:] = mdt.reshape(blocks, -1)
        applied = torch.where(refresh, step + 1, applied)
        tile_keys = torch.where(
            real[:, chip:], _keys(md[:, chip:], index[:, chip:]),
            low).reshape(blocks, tiles, tile).max(2).values
        bound = torch.where(
            refresh, (tile_keys >> 32 << 32) + (2 ** 32 - 1 - tile_index),
            bound)
        block_best = torch.cat([on_best[:, None], torch.where(
            refresh, tile_keys, low)], 1).max(1).values
        has = block_best != low
        cand_idx = (2 ** 32 - 1 - (block_best[has] & 0xFFFFFFFF))
        cand_md = md.reshape(-1)[(cand_idx // length) * width
                                 + cand_idx % length]
        idxs.append(int(cand_idx[block_best[has].argmax()]))
    idx = torch.tensor(idxs, dtype=torch.int64, device=dev)
    return (x[idx], idx.to(torch.int32),
            torch.tensor(counts, dtype=torch.int64))


def refresh_shares(counts: torch.Tensor) -> tuple[float, float]:
    """Mean and largest share of the lazy tiles refreshed at a step, over
    steps 1 on (step 0 refreshes every tile), from the kernel's
    ``refreshed`` or the model's counts."""
    counts = counts.double().cpu()
    if counts.numel() < 2 or counts[0] == 0:
        return 0.0, 0.0
    share = counts[1:] / counts[0]
    return float(share.mean()), float(share.max())


def select_seeds(x: torch.Tensor, num_seeds: int, first_index: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Farthest-point seeding (cosine metric).

    Args:
      x: [n, d] unit vectors, float32 or bfloat16; a strided view such as
        x[::8] is welcome.  On a CPU tensor the plain version runs; on a CUDA
        tensor the kernel launches (or this raises).
      first_index: index of the first seed, 0 <= first_index < n.
    Returns:
      (seeds [m, d] in x.dtype, seed_indices [m] int32).
    """
    if not x.is_cuda:
        return select_seeds_reference(x, num_seeds, first_index)
    global launches, refreshed
    _build.on_device("select_seeds", x)
    code = _build.dtype_code(x, "select_seeds")
    n, d = x.shape
    _build.check_width("select_seeds", d)
    if not 0 <= int(first_index) < n:
        raise ValueError(f"first_index {first_index} out of range [0, {n})")
    if num_seeds < 1:
        raise ValueError("num_seeds must be >= 1")
    lib = _build.library()
    xr = x if x.stride(1) == 1 else x.contiguous()
    plan = launch_config(xr)
    lazy = bool(plan["lazy"])
    # the argmax keys, the grid barrier's counter and, on the lazy path,
    # the int32 count of tiles refreshed at each step and the blocks' best
    # keys at the last two steps
    scratch = torch.empty(num_seeds + 1 + num_seeds // 2 + 2 * plan["grid"],
                          dtype=torch.int64, device=x.device)
    idx = torch.empty(num_seeds, dtype=torch.int32, device=x.device)
    # the off-chip pixels of each block, transposed
    xs_t = torch.empty(max(1, plan["scratch_elements"]), dtype=x.dtype,
                       device=x.device)
    err = lib.uoc_select_seeds(xr.data_ptr(), code, n, d, xr.stride(0),
                               num_seeds, int(first_index), scratch.data_ptr(),
                               idx.data_ptr(), xs_t.data_ptr(),
                               _build.stream(x))
    _build.check(err, "select_seeds")
    launches += 1
    refreshed = (scratch[num_seeds + 1:num_seeds + 1 + num_seeds // 2].view(
        torch.int32)[:num_seeds - 1] if lazy else None)
    return x[idx.long()], idx


def launch_config(x: torch.Tensor) -> dict[str, int]:
    """The kernel's launch shape for x ([n, d] on the card, d = 64 or
    128): grid, blocks per SM, threads per block, dynamic shared-memory
    bytes, bytes of X held on chip by the fullest block (registers and
    shared memory), pixels per block, pixels per block past those (read
    from device memory), 1 where those are kept in lazy tiles (d = 128 with
    such pixels; else 0), the pixels of a lazy tile (0 off that path), and
    the elements of the scratch that holds those pixels."""
    _build.check_width("select_seeds", x.shape[1])
    return _build.plan(x.device, "uoc_select_seeds_plan",
                       _build.dtype_code(x, "select_seeds"), x.shape[0],
                       x.shape[1],
                       names=("grid", "blocks_per_sm", "threads",
                              "smem_bytes", "x_on_chip_bytes",
                              "pixels_per_block", "reread_pixels_per_block",
                              "lazy", "tile_pixels", "scratch_elements"))
