"""Farthest-point seeding: the CUDA kernel's wrapper and its plain version.

Counterpart of ``unseenobjectclustering_tpu/ops/pallas_seeding.py``.  The
kernel is ``csrc/seeding.cu``: one persistent cooperative launch that holds
each block's slice of X on chip for all steps, exact fp32 dots, a packed
64-bit atomicMax argmax with the lowest index on a tie and one grid-wide
barrier per step.  It takes widths 64 and 128 (NUM_UNITS, 64 in every
recipe, and twice that under the RGB-D cat fusion) and raises on another
on a CUDA tensor; the plain version takes any width.
"""

from __future__ import annotations

import torch

from unseenobjectclustering_torch.ops import _build
from unseenobjectclustering_torch.ops.mean_shift import select_smart_seeds

launches = 0  # calls that launched the kernel


def select_seeds_reference(x: torch.Tensor, num_seeds: int,
                           first_index: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: cosine farthest-point seeding in torch ops."""
    return select_smart_seeds(x, num_seeds, metric="cosine",
                              first_index=first_index)


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
    global launches
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
    # the argmax keys and, after them, the grid barrier's counter
    scratch = torch.empty(num_seeds + 1, dtype=torch.int64, device=x.device)
    idx = torch.empty(num_seeds, dtype=torch.int32, device=x.device)
    # the pixels each block re-reads every step, transposed to [d, *]
    xs_t = torch.empty(
        max(1, d * plan["grid"] * plan["reread_pixels_per_block"]),
        dtype=x.dtype, device=x.device)
    err = lib.uoc_select_seeds(xr.data_ptr(), code, n, d, xr.stride(0),
                               num_seeds, int(first_index), scratch.data_ptr(),
                               idx.data_ptr(), xs_t.data_ptr(),
                               _build.stream(x))
    _build.check(err, "select_seeds")
    launches += 1
    return x[idx.long()], idx


def launch_config(x: torch.Tensor) -> dict[str, int]:
    """The kernel's launch shape for x ([n, d] on the card, d = 64 or
    128): grid, blocks per SM, threads per block, dynamic shared-memory
    bytes, bytes of X held on chip by the fullest block (registers and
    shared memory), pixels per block, and pixels per block re-read every
    step."""
    _build.check_width("select_seeds", x.shape[1])
    return _build.plan(x.device, "uoc_select_seeds_plan",
                       _build.dtype_code(x, "select_seeds"), x.shape[0],
                       x.shape[1],
                       names=("grid", "blocks_per_sm", "threads",
                              "smem_bytes", "x_on_chip_bytes",
                              "pixels_per_block", "reread_pixels_per_block"))
