"""von Mises-Fisher mean-shift clustering over unit-norm pixel embeddings.

Port of ``unseenobjectclustering_tpu/ops/mean_shift.py`` (reference
lib/utils/mean_shift.py).  This module holds the plain PyTorch version of
every phase and the dispatch:

  phase 1 — farthest-point seeding (select_smart_seeds, :128-189), with a
            running min-distance vector instead of an [n x m] matrix.
  phase 2 — vMF hill climbing (hill_climb, :79-109).
  phase 3 — order-dependent connected components over the converged seeds
            with mode tie-breaking (connected_components, :41-76).
  phase 4 — pixel-to-seed assignment + largest-cluster-to-background swap
            (assign_and_swap_background, :206-227).

With ``use_pallas=True`` (cfg.CLUSTER.USE_PALLAS) and the cosine metric,
the four phases go through the wrappers of the hand-written CUDA kernels
(ops/cuda_seeding.py, ops/cuda_mean_shift.py), which launch the kernel for a
CUDA tensor and run their plain version for a CPU tensor.  The euclidean
branches always run the plain versions here, as in the JAX package.

Argmax/argmin ties resolve to the first index everywhere (torch.argmax and
torch.argmin return the first occurrence), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class MeanShiftResult(NamedTuple):
    labels: torch.Tensor         # [n] int32 cluster ids (0 = background)
    seed_indices: torch.Tensor   # [m] int32 pixel indices chosen as seeds
    seeds: torch.Tensor          # [m, d] converged seeds (float32)
    seed_labels: torch.Tensor    # [m] int32 per-seed cluster ids


def _cosine_dist_to_point(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """0.5 * (1 - X . v), float32 [n].  bf16 inputs are widened first, so
    the products are exact and only the float32 sum rounds."""
    return 0.5 * (1.0 - x.to(torch.float32) @ v.to(torch.float32))


def _euclidean_dist_to_point(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    diff = (x - v[None, :]).to(torch.float32)
    return torch.sqrt((diff * diff).sum(dim=1))


def random_first_index(n: int, generator: Optional[torch.Generator]) -> int:
    """The random first seed (reference: np.random.randint,
    mean_shift.py:155), drawn from a CPU generator."""
    return int(torch.randint(n, (1,), generator=generator).item())


def select_smart_seeds(x: torch.Tensor, num_seeds: int,
                       generator: Optional[torch.Generator] = None,
                       metric: str = "cosine",
                       first_index: Optional[int] = None,
                       subsample: int = 1
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Farthest-point seed selection (mean_shift.py:128-189).

    Args:
      x: [n, d] unit vectors.
      generator: draws the first seed when first_index is None.
      first_index: optional override of the first seed index, in the
        subsampled indexing.
      subsample: pixel stride for the seeding phase only (1 = parity with
        the reference).  Returned indices are in the original indexing.
    Returns:
      (seeds [m, d] in x.dtype, seed_indices [m] int32).
    """
    if subsample > 1:
        seeds, idxs = select_smart_seeds(x[::subsample], num_seeds, generator,
                                         metric, first_index)
        return seeds, idxs * subsample
    n = x.shape[0]
    dist_fn = (_cosine_dist_to_point if metric == "cosine"
               else _euclidean_dist_to_point)
    if first_index is None:
        first_index = random_first_index(n, generator)
    idxs = torch.empty(num_seeds, dtype=torch.long, device=x.device)
    idxs[0] = int(first_index)
    min_dist = dist_fn(x, x[int(first_index)])
    for i in range(1, num_seeds):
        sel = torch.argmax(min_dist).reshape(1)
        idxs[i] = sel[0]
        min_dist = torch.minimum(min_dist, dist_fn(x, x[sel][0]))
    return x[idxs], idxs.to(torch.int32)


def hill_climb(x: torch.Tensor, z: torch.Tensor, kappa: float,
               max_iters: int, metric: str = "cosine") -> torch.Tensor:
    """Plain mean-shift hill climbing in float32 (mean_shift.py:79-109;
    ``hill_climb_xla`` in the JAX package).  Returns [m, d] float32."""
    xf = x.to(torch.float32)
    z = z.to(torch.float32)
    for _ in range(max_iters):
        if metric == "cosine":
            w = torch.exp(kappa * (z @ xf.T))            # [m, n]
            z_new = w @ xf                               # [m, d]
            norm = torch.linalg.norm(z_new, dim=1, keepdim=True)
            z = z_new / torch.clamp(norm, min=1e-12)
        else:
            # |z - x|^2 = |z|^2 + |x|^2 - 2 z.x  (never an [m, n, d] tensor)
            sq = ((z * z).sum(dim=1, keepdim=True)
                  + (xf * xf).sum(dim=1)[None, :] - 2.0 * (z @ xf.T))
            w = torch.exp(-kappa * torch.clamp(sq, min=0.0))
            z = (w @ xf) / torch.clamp(w.sum(dim=1, keepdim=True), min=1.0)
    return z


def connected_components(z: torch.Tensor, epsilon: float,
                         metric: str = "cosine") -> torch.Tensor:
    """Order-dependent seed merging with mode tie-breaking
    (mean_shift.py:41-76).  In seed order, an unlabeled seed takes the mode
    of its labeled epsilon-neighbours' labels (smallest label on a tie), or
    opens a new label; every one of its neighbours then takes that label.

    Args:
      z: [m, d] converged seeds.
    Returns:
      [m] int32 cluster labels.
    """
    m = z.shape[0]
    z = z.to(torch.float32)
    if metric == "cosine":
        dist = 0.5 * (1.0 - z @ z.T)
    else:
        dist = torch.linalg.norm(z[:, None, :] - z[None, :, :], dim=2)
    # [m, m]; row i = i's epsilon-ball.  The merge is m sequential steps of
    # integer logic: on the host, one step costs no device launches.
    adj = (dist <= epsilon).cpu().numpy()

    labels = np.full(m, -1, dtype=np.int64)
    k = 0
    for i in range(m):
        if labels[i] != -1:
            continue
        neigh = adj[i]
        labeled = labels[neigh & (labels >= 0)]
        if labeled.size:
            # mode of the labeled neighbours' labels; ties -> smallest label
            new_label = int(np.argmax(np.bincount(labeled, minlength=m)))
        else:
            new_label = k
            k += 1
        labels[neigh] = new_label
    return torch.from_numpy(labels.astype(np.int32)).to(z.device)


def swap_background(labels: torch.Tensor, counts: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Relabel so the largest cluster is background 0 (mean_shift.py:
    217-227).  Returns (labels, label_max); label_max lets callers permute
    per-cluster side data (the depth filter's keep mask) the same way."""
    label_max = torch.argmax(counts).to(labels.dtype)
    swapped = torch.where(labels == 0, label_max,
                          torch.where(labels == label_max,
                                      torch.zeros_like(labels), labels))
    return torch.where(label_max != 0, swapped, labels), label_max


def assign_and_swap_background(x: torch.Tensor, seeds: torch.Tensor,
                               seed_labels: torch.Tensor,
                               metric: str = "cosine") -> torch.Tensor:
    """Assign each pixel to its nearest converged seed, then relabel so the
    largest cluster is background 0 (mean_shift.py:206-227)."""
    m = seeds.shape[0]
    if metric == "cosine":
        # the similarity runs on seeds rounded to x's dtype, summed in fp32
        sim = x.to(torch.float32) @ seeds.to(x.dtype).to(torch.float32).T
        dist = 0.5 * (1.0 - sim)                         # [n, m]
    else:
        xf = x.to(torch.float32)
        sq = ((xf * xf).sum(dim=1, keepdim=True)
              + (seeds * seeds).sum(dim=1)[None, :] - 2.0 * (xf @ seeds.T))
        dist = torch.sqrt(torch.clamp(sq, min=0.0))
    closest = torch.argmin(dist, dim=1)
    labels = seed_labels.to(torch.int32)[closest]
    counts = torch.bincount(labels.long(), minlength=m)
    labels, _ = swap_background(labels, counts)
    return labels


def filter_labels_depth(labels: torch.Tensor, z_valid: torch.Tensor,
                        threshold: float, max_labels: int) -> torch.Tensor:
    """Zero out clusters whose fraction of valid-depth pixels is below
    threshold (test_dataset.py:183-198; ``ops/roi.filter_labels_depth`` in
    the JAX package, on flat [n] labels and an [n] bool mask)."""
    lab = labels.long()
    counts = torch.bincount(lab, minlength=max_labels)
    valid = torch.bincount(lab, weights=z_valid.to(torch.float32),
                           minlength=max_labels)
    frac = valid / torch.clamp(counts.to(torch.float32), min=1.0)
    ids = torch.arange(frac.shape[0], device=frac.device)
    # ids >= max_labels are dropped, as the reference's one-hot drops them
    keep = ((frac >= threshold) | (ids == 0)) & (ids < max_labels)
    return torch.where(keep[lab], labels, torch.zeros_like(labels))


def select_seeds_dispatch(xc: torch.Tensor, num_seeds: int,
                          generator: Optional[torch.Generator] = None, *,
                          metric: str = "cosine", use_pallas: bool = True,
                          first_index: Optional[int] = None,
                          seed_subsample: int = 1
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Route farthest-point seeding: cosine with the kernels on -> the
    seeding kernel's wrapper (the kernel on a CUDA tensor, its plain version
    on a CPU one); otherwise -> plain select_smart_seeds.  Both pick the
    same seeds: float32 distances, lowest index on a tie."""
    if metric == "cosine" and use_pallas:
        from unseenobjectclustering_torch.ops import cuda_seeding
        x_seed = xc[::seed_subsample] if seed_subsample > 1 else xc
        if first_index is None:
            first_index = random_first_index(x_seed.shape[0], generator)
        seeds, seed_indices = cuda_seeding.select_seeds(
            x_seed, num_seeds, int(first_index))
        return seeds, seed_indices * seed_subsample
    return select_smart_seeds(xc, num_seeds, generator, metric, first_index,
                              seed_subsample)


def mean_shift_smart_init(x: torch.Tensor,
                          generator: Optional[torch.Generator] = None, *,
                          kappa: float = 20.0, num_seeds: int = 100,
                          max_iters: int = 10, epsilon: float = 0.04,
                          metric: str = "cosine", use_pallas: bool = True,
                          first_index: Optional[int] = None,
                          seed_subsample: int = 1,
                          compute_dtype: str = "float32",
                          z_valid: Optional[torch.Tensor] = None,
                          filter_threshold: float = 0.0
                          ) -> MeanShiftResult:
    """Full mean-shift pipeline (mean_shift.py:192-229).

    Args:
      x: [n, d] unit-norm pixel embeddings (on the device to run on).
      generator: CPU generator for the first seed (unless first_index).
      epsilon: seed-merge radius (2 * EMBEDDING_ALPHA in the reference).
      use_pallas: cosine phases through the CUDA kernels' wrappers.
      seed_subsample: pixel stride for farthest-point seeding.
      compute_dtype: 'float32' or 'bfloat16' for the similarity products;
        seed state, merging and normalization stay float32.
      z_valid + filter_threshold: fused depth-validity filter: drop
        clusters whose fraction of z_valid pixels is below the threshold
        (test_dataset.py:183-198).  z_valid is an [n] bool mask.
    """
    xc = x.to(torch.bfloat16) if compute_dtype == "bfloat16" else x
    seeds, seed_indices = select_seeds_dispatch(
        xc, num_seeds, generator, metric=metric, use_pallas=use_pallas,
        first_index=first_index, seed_subsample=seed_subsample)
    if metric == "cosine" and use_pallas:
        from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
        z = cms.hill_climb(xc, seeds, kappa=kappa, max_iters=max_iters)
        seed_labels = cms.connected_components(z, epsilon)
        # assignment + both histograms in one X sweep, then the
        # largest-cluster -> background relabel
        labels, counts, valid_counts = cms.assign_labels(xc, z, seed_labels,
                                                         z_valid=z_valid)
        labels, label_max = swap_background(labels, counts)
        if z_valid is not None and filter_threshold > 0:
            # the per-cluster validity fraction is relabel-invariant:
            # permute the keep mask through the background swap
            keep = (valid_counts / torch.clamp(counts, min=1.0)
                    >= filter_threshold)
            ids = torch.arange(keep.shape[0], device=keep.device)
            keep = torch.where(ids == label_max, keep[0], keep)
            keep = keep | (ids == 0)  # background always kept
            labels = torch.where(keep[labels.long()], labels,
                                 torch.zeros_like(labels))
    else:
        z = hill_climb(xc, seeds, kappa, max_iters, metric)
        seed_labels = connected_components(z, epsilon, metric)
        labels = assign_and_swap_background(xc, z, seed_labels, metric)
        if z_valid is not None and filter_threshold > 0:
            labels = filter_labels_depth(labels, z_valid, filter_threshold,
                                         max_labels=num_seeds + 1)
    return MeanShiftResult(labels=labels, seed_indices=seed_indices, seeds=z,
                           seed_labels=seed_labels)
