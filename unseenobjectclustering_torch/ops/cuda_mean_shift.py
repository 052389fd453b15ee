"""vMF mean-shift phases 2-4: the CUDA kernels' wrappers and plain versions.

Counterpart of ``unseenobjectclustering_tpu/ops/pallas_mean_shift.py``.  The
kernels are in ``csrc/mean_shift.cu``:

  * hill_climb: one persistent cooperative launch for all iterations;
    one block per SM sums exp(kappa Z X^T) X over its pixel tiles
    (loaded into a ring, products on the tensor cores: split TF32 on
    wgmma for float32, bf16 on mma.sync for bfloat16 at d = 64; at d =
    128 in float32 a producer warpgroup splits the tiles for the consumer
    warpgroups over mbarriers, and in bfloat16 a producer warpgroup loads
    them by TMA for consumer warpgroups that run both products on wgmma
    from the one tile, each block keeping its first tiles in shared memory
    for the whole launch), then a fixed-order reduction of the blocks'
    partials + row normalization behind a grid-wide barrier; the [m, n]
    weights never reach device memory.
  * connected_components: the epsilon-ball adjacency as bitmasks (each
    pair's exact fp32 FMA chain once, a ballot per row; one block at d =
    64, a thread-block cluster at d = 128 whose CTAs write their words into
    the leader's shared memory), then one warp merges with the labels as
    membership bitmasks in registers, stepping only through the seeds
    still unlabeled when their turn comes.
  * assign_labels: one persistent launch; each block streams its 128-pixel
    tiles through a cp.async ring (at d = 128 a producer loads 64-pixel
    tiles by TMA: for two consumer warpgroups in turns in float32, for
    three that claim them in order in bfloat16, whose wgmma reads each
    tile straight from shared memory), S = X Z^T on wgmma (split TF32 for
    float32, bf16 for bfloat16) stays in registers for the argmax, pixels
    whose best two labels are within ASSIGN_RECHECK_MARGIN[d] are re-checked
    with the exact fp32 FMA chain, and per-label pixel / valid-depth
    histograms come out of the same X sweep.

Each wrapper runs its plain version on a CPU tensor and launches its kernel
on a CUDA tensor (or raises).  The kernels are instantiated at widths d =
64, 128 and 256 (NUM_UNITS is 64 in every recipe in experiments/cfgs, the
RGB-D cat fusion concatenates two towers' embeddings into 2 * NUM_UNITS,
and two 128-unit heads give 256); a narrower X and Z run on the next of
them with zero columns appended (``_build.pad_columns``), which leave every
score, norm and Z as they were.  Up to 128 seeds at d <= 128, the recipes'
shapes, each kernel launches once; past 128, up to MAX_SEEDS:

  * hill_climb launches once per group of at most GROUP_SEEDS seeds (a
    row's update reads only X and the row itself; every group has the same
    number of rows, so each launch has the same plan);
  * connected_components launches cc_kernel<d, 256> (8-word rows and
    masks) up to 256 seeds, cc_wide_kernel<d> past them (16-word rows,
    label masks in shared memory, a 16-bit label in the mode's key);
  * assign_labels launches its kernel once per 128 seeds over X
    (assign_passes), each pass against at most GROUP_SEEDS seeds on the
    tensor cores: the first stores each pixel's best two scores (and the
    label of the best) in a scratch of 16 bytes a pixel, a middle one
    merges them with its own and stores the result, the last merges and
    finishes (re-check against all m seeds, labels, histograms).

At d = 256, at any seed count up to MAX_SEEDS, simple kernels on the CUDA
cores run where the tensor-core kernels' shared memory does not reach:

  * hill_climb launches hill_simt_kernel once per group of at most
    SIMT_GROUP_SEEDS seeds (fp32 FMA; S as chains of 32 dims);
  * connected_components launches cc_wide_kernel<256>;
  * assign_labels launches assign_exact_kernel<T, 256> once: every score
    is the exact fp32 FMA chain, so no pixel needs a re-check (all are
    counted as re-checked).

Widths past 256 and more than MAX_SEEDS seeds raise on a CUDA tensor,
before any launch; the plain versions take any shape.
"""

from __future__ import annotations

from typing import Optional

import torch

from unseenobjectclustering_torch.ops import _build
from unseenobjectclustering_torch.ops.mean_shift import (
    connected_components as _connected_components_plain)

MAX_SEEDS = 512
# the seed rows of one hill-climb launch and of one assignment pass
# (kMaxSeeds in csrc/mean_shift.cu)
GROUP_SEEDS = 128
# the seed rows of one hill-climb launch at d = 256 (kSimtRows)
SIMT_GROUP_SEEDS = 64
# the wgmma assignment kernels re-check a pixel exactly where its best score
# beats every seed of another label by less than this, per kernel width
# (kRecheckMargin<d> in csrc/mean_shift.cu, where it is derived; a narrower
# embedding's zero columns add exact zeros, so its kernel width's margin
# holds)
ASSIGN_RECHECK_MARGIN = {64: 2.0 ** -15, 128: 2.0 ** -14}

# calls that launched each kernel
hill_climb_launches = 0
connected_components_launches = 0
assign_labels_launches = 0
# [1] int32 on the card: merge steps of the last connected_components
# launch (the seeds still unlabeled when their turn came)
connected_components_steps: Optional[torch.Tensor] = None
# [1] float32 on the card: pixels the last assign_labels launch re-checked
assign_labels_rechecked: Optional[torch.Tensor] = None


def check_shapes(what: str, m: int, d: int) -> int:
    """Raise unless the kernels take m seeds of width d; return the kernel
    width that serves d."""
    width = _build.kernel_width(what, d)
    if not 1 <= m <= MAX_SEEDS:
        raise ValueError(f"{what}: the kernel takes 1..{MAX_SEEDS} seeds, "
                         f"got m={m}")
    return width


def prepare(x: torch.Tensor, m: int) -> torch.Tensor:
    """x ([n, d] on the card) for m seeds through all four kernels: raise
    unless they take the shape (before any launch), and pad x once to the
    kernel width that serves d (each wrapper's own padding is then a
    no-op)."""
    return _build.pad_columns(x, check_shapes("mean_shift_smart_init", m,
                                              x.shape[1]))


def assign_passes(m: int, d: int = 64) -> int:
    """The assignment's launches for m seeds of width d: one per
    GROUP_SEEDS seeds, and one at the kernel width 256
    (assign_exact_kernel)."""
    if _build.kernel_width("assign_labels", d) == 256:
        return 1
    return -(-m // GROUP_SEEDS)


def hill_climb_groups(m: int, d: int = 64) -> tuple[int, int]:
    """(launches, rows per launch) of the hill climb for m seeds of width
    d: one launch up to the rows a launch takes (GROUP_SEEDS; at the kernel
    width 256 SIMT_GROUP_SEEDS), else as few launches of equal rows as
    hold them (the last group padded with copies of its last seed)."""
    cap = (SIMT_GROUP_SEEDS if _build.kernel_width("hill_climb", d) == 256
           else GROUP_SEEDS)
    groups = -(-m // cap)
    return groups, -(-m // groups)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as contiguous rows on a 16-byte boundary (the hill climb and the
    assignment load X, and the assignment Z, 16 bytes at a time)."""
    xc = x.contiguous()
    return xc if xc.data_ptr() % 16 == 0 else xc.clone()


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t as a contiguous tensor of dtype, itself when it already is one
    (no dispatch: each tensor op costs microseconds of host time)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


# -- hill climbing ----------------------------------------------------------

def hill_climb_reference(x: torch.Tensor, z0: torch.Tensor, *,
                         kappa: float = 20.0,
                         max_iters: int = 10) -> torch.Tensor:
    """Plain version of the kernel: Z <- normalize_rows(exp(kappa Z X^T) X).
    Z stays float32; with bf16 X, Z is rounded to bf16 for the first
    product and W before the second, both summed in float32."""
    xf = x.to(torch.float32)
    low = x.dtype != torch.float32
    z = z0.to(torch.float32)
    for _ in range(max_iters):
        zc = z.to(x.dtype).to(torch.float32) if low else z
        w = torch.exp(kappa * (zc @ xf.T))
        if low:
            w = w.to(x.dtype).to(torch.float32)
        v = w @ xf
        z = v / torch.clamp(torch.sqrt((v * v).sum(dim=1, keepdim=True)),
                            min=1e-12)
    return z


def hill_climb(x: torch.Tensor, z0: torch.Tensor, *, kappa: float = 20.0,
               max_iters: int = 10) -> torch.Tensor:
    """Run max_iters cosine vMF mean-shift updates of seeds z0 over x.

    Args:
      x: [n, d] unit vectors (float32 or bfloat16).
      z0: [m, d] initial seeds.
    Returns:
      [m, d] float32 converged seeds.
    """
    if not x.is_cuda:
        return hill_climb_reference(x, z0, kappa=kappa, max_iters=max_iters)
    global hill_climb_launches
    _build.on_device("hill_climb", x, z0)
    code = _build.dtype_code(x, "hill_climb")
    n, d = x.shape
    m = z0.shape[0]
    width = check_shapes("hill_climb", m, d)
    lib = _build.library()
    xc = _build.pad_columns(_rows(x), width)
    z0c = _build.pad_columns(z0.to(torch.float32).contiguous(), width)
    groups, rows = hill_climb_groups(m, width)
    if groups > 1:
        z0c = torch.cat([z0c, z0c[-1:].expand(groups * rows - m, width)])
    grid = hill_climb_config(xc, rows)["grid"]
    partial = torch.empty((grid, rows, width), dtype=torch.float32,
                          device=x.device)
    arrived = torch.empty(1, dtype=torch.int32, device=x.device)
    z = torch.empty((groups * rows, width), dtype=torch.float32,
                    device=x.device)
    for g in range(groups):
        err = lib.uoc_hill_climb(
            xc.data_ptr(), code, n, width, z0c[g * rows].data_ptr(), rows,
            float(kappa), int(max_iters), partial.data_ptr(),
            arrived.data_ptr(), z[g * rows].data_ptr(), _build.stream(x))
        _build.check(err, "hill_climb")
        hill_climb_launches += 1
    return z if groups == 1 and width == d else z[:m, :d].contiguous()


def hill_climb_config(x: torch.Tensor, m: int) -> dict[str, int]:
    """The hill-climb kernel's launches for x ([n, d] on the card, d <=
    256: the plan of the width that serves d) and m seeds: the launches and
    the seed rows of each (hill_climb_groups), then each launch's grid,
    blocks per SM, threads per block, dynamic shared-memory bytes, bytes of
    X held on chip per block (its ring of tiles; for float32 the split-TF32
    copies: the current tile's at d = 64, two stages of them at d = 128;
    for bfloat16 at d = 128 also its resident tiles; at d = 256 its staged
    tile), and the bytes of X that the grid keeps on chip for the whole
    launch (bfloat16 at d = 128, else 0: X is read from L2 or device memory
    every iteration but for these)."""
    width = check_shapes("hill_climb", m, x.shape[1])
    groups, rows = hill_climb_groups(m, width)
    return {"launches": groups, "group_rows": rows,
            **_build.plan(x.device, "uoc_hill_climb_plan",
                          _build.dtype_code(x, "hill_climb"), x.shape[0],
                          rows, width,
                          names=("grid", "blocks_per_sm", "threads",
                                 "smem_bytes", "x_on_chip_bytes",
                                 "x_resident_bytes"))}


# -- connected components ---------------------------------------------------

def connected_components_reference(z: torch.Tensor,
                                   epsilon: float) -> torch.Tensor:
    """Plain version: cosine connected components in torch ops."""
    return _connected_components_plain(z, epsilon, "cosine")


def connected_components(z: torch.Tensor, epsilon: float) -> torch.Tensor:
    """Seed merging over the converged seeds (cosine metric).
    Returns [m] int32 labels."""
    if not z.is_cuda:
        return connected_components_reference(z, epsilon)
    global connected_components_launches, connected_components_steps
    _build.on_device("connected_components", z)
    m, d = z.shape
    width = check_shapes("connected_components", m, d)
    lib = _build.library()
    zc = _build.pad_columns(_rows(_as(z, torch.float32)), width)
    # the labels, then the count of merge steps
    out = torch.empty(m + 1, dtype=torch.int32, device=z.device)
    ptr = out.data_ptr()
    err = lib.uoc_connected_components(zc.data_ptr(), m, width,
                                       float(epsilon),
                                       ptr, ptr + 4 * m, _build.stream(z))
    _build.check(err, "connected_components")
    connected_components_launches += 1
    labels, connected_components_steps = out.split((m, 1))
    return labels


def connected_components_config(z: torch.Tensor) -> dict[str, int | str]:
    """The connected-components kernel's launch for z ([m, d] on the card,
    d <= 256: the launch at the width that serves d): the kernel's name,
    its CTAs (one at d = 64, past 128 seeds and at d = 256; the
    thread-block cluster's at d = 128), threads per CTA, dynamic
    shared-memory bytes, the adjacency's work items, and the most Z rows a
    CTA stages (0 for cc_wide_kernel, which reads Z in place)."""
    m, d = z.shape
    width = check_shapes("connected_components", m, d)
    return {"kernel": _build.kernel_name(
                z.device, "uoc_connected_components_kernel", m, width),
            **_build.plan(z.device, "uoc_connected_components_plan", m,
                          width,
                          names=("ctas", "threads", "smem_bytes", "items",
                                 "rows_staged"))}


# -- assignment + histograms ------------------------------------------------

def assign_labels_reference(x: torch.Tensor, seeds: torch.Tensor,
                            seed_labels: torch.Tensor,
                            z_valid: Optional[torch.Tensor] = None
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version of the kernel; see assign_labels."""
    m = seeds.shape[0]
    sim = (x.to(torch.float32)
           @ seeds.to(x.dtype).to(torch.float32).T)          # [n, m]
    closest = torch.argmax(sim, dim=1)
    labels = seed_labels.to(torch.int32)[closest]
    lab = labels.long()
    counts = torch.bincount(lab, minlength=m)[:m].to(torch.float32)
    if z_valid is None:
        valid_counts = counts.clone()
    else:
        valid_counts = torch.bincount(lab[z_valid.bool()], minlength=m)[:m]
        valid_counts = valid_counts.to(torch.float32)
    return labels, counts, valid_counts


def assign_labels(x: torch.Tensor, seeds: torch.Tensor,
                  seed_labels: torch.Tensor,
                  z_valid: Optional[torch.Tensor] = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Nearest-seed assignment fused with the cluster histograms (cosine).

    Args:
      x: [n, d] unit vectors (float32 or bfloat16).
      seeds: [m, d] converged seeds (rounded to x's dtype for the product).
      seed_labels: [m] int32 cluster ids from connected components (< m).
      z_valid: optional [n] bool validity mask (depth z > 0); its
        per-cluster count comes out of the same X sweep.
    Returns:
      (labels [n] int32 cluster ids before the background swap,
       counts [m] float32 pixels per cluster id,
       valid_counts [m] float32 valid pixels per cluster id; == counts when
       z_valid is None).
    """
    if not x.is_cuda:
        return assign_labels_reference(x, seeds, seed_labels, z_valid)
    global assign_labels_launches, assign_labels_rechecked
    _build.on_device("assign_labels", x, seeds, seed_labels, z_valid)
    code = _build.dtype_code(x, "assign_labels")
    n, d = x.shape
    m = seeds.shape[0]
    width = check_shapes("assign_labels", m, d)
    if n >= 2 ** 24:
        raise ValueError(f"assign_labels: the kernel's float32 counts are "
                         f"exact below 2^24 pixels, got n={n}")
    lib = _build.library()
    xc = _build.pad_columns(_rows(x), width)
    zc = _build.pad_columns(_rows(_as(seeds, torch.float32)), width)
    slab = _as(seed_labels, torch.int32)
    # a bool tensor's bytes are 0 or 1, as the kernel reads them
    zv = None if z_valid is None else _as(z_valid, torch.bool)
    labels = torch.empty(n, dtype=torch.int32, device=x.device)
    # pixels per label, valid pixels per label, re-checked pixels
    out = torch.empty(2 * m + 1, dtype=torch.float32, device=x.device)
    args = (xc.data_ptr(), code, n, width, zc.data_ptr(), slab.data_ptr(), m,
            None if zv is None else zv.data_ptr(), labels.data_ptr(),
            out.data_ptr())
    passes = assign_passes(m, width)
    if passes == 1:
        err = lib.uoc_assign_labels(*args, _build.stream(x))
    else:
        # each pass's best two scores and best label for the next, a
        # float4 a pixel
        part = torch.empty((n, 4), dtype=torch.float32, device=x.device)
        err = lib.uoc_assign_labels_passes(*args, part.data_ptr(),
                                           _build.stream(x))
    _build.check(err, "assign_labels")
    assign_labels_launches += passes
    counts, valid_counts, assign_labels_rechecked = out.split((m, m, 1))
    return labels, counts, valid_counts


def assign_labels_config(x: torch.Tensor, m: int) -> dict[str, int | str]:
    """The assignment kernel's launch for x ([n, d] on the card, d <= 256:
    the launch at the width that serves d) and m seeds: the kernel's name
    (in passes every pass kind's), its launches (assign_passes), grid,
    blocks per SM, threads per block, dynamic shared-memory bytes, bytes
    of X held on chip per block (its ring of tiles), the ring's stages and
    the pixels of a tile (past GROUP_SEEDS the last pass's)."""
    width = check_shapes("assign_labels", m, x.shape[1])
    args = (_build.dtype_code(x, "assign_labels"), x.shape[0], m, width)
    return {"kernel": _build.kernel_name(x.device, "uoc_assign_labels_kernel",
                                         *args),
            "launches": assign_passes(m, width),
            **_build.plan(x.device, "uoc_assign_labels_plan", *args,
                          names=("grid", "blocks_per_sm", "threads",
                                 "smem_bytes", "x_on_chip_bytes", "stages",
                                 "tile_pixels"))}
