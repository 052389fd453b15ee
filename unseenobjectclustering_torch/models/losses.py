"""Metric-learning embedding loss and the embedding normalization.

Port of ``unseenobjectclustering_tpu/models/losses.py`` (reference
EmbeddingLoss, lib/networks/embedding.py:57-133):

  * spherical cluster means: masked sum / count (+1e-10), L2-normalized
    (embedding.py:23-54)
  * intra loss: distance of each labeled pixel to its own cluster mean
    (cosine 0.5*(1 - x . mu) or euclidean), with the hard-negative weights
    max(N_k, 50) * K, squared, summed, / batch (embedding.py:93-117)
  * inter loss: hinge max(0, delta - d)^2 between distinct cluster means,
    / (K(K-1)/2 * B) (embedding.py:120-128)
  * label -1 is ignored (embedding.py:90); labels >= max_k are treated as
    -1.

The per-pixel gathers are one-hot products over a fixed max_k, as in the
JAX package: their backward is a product too, so it needs no scatter-add
(CUDA's float atomics would make a step non-deterministic).  The dynamic
K = max(label) + 1 enters only the weights and the normalizations.

Everything computes in float32, or in float64 for float64 embeddings
(_wide).

The loss couples the frames of a batch only through three scalars: the
dynamic K (the batch's largest label + 1), whether any pixel of the batch
is hard, and the batch size B in both divisions.  Under data parallelism
(a process group of more than one rank) these are the global batch's
(an all-reduce MAX and two SUMs), and each rank returns its share of the
global loss: the shares of the ranks sum to the loss of one process on
the whole batch.  The cluster means and hard-pixel weights are per frame
and stay local.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from unseenobjectclustering_torch.parallel.distributed import (
    data_parallel_group)


class EmbeddingLossOut(NamedTuple):
    loss: torch.Tensor
    intra: torch.Tensor
    inter: torch.Tensor


def _wide(dtype: torch.dtype) -> torch.dtype:
    """float32, or float64 for float64 input."""
    return torch.promote_types(dtype, torch.float32)


def _safe_norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False,
               eps: float = 1e-24) -> torch.Tensor:
    """L2 norm with a finite gradient at 0."""
    return torch.sqrt(torch.clamp((v * v).sum(dim=dim, keepdim=keepdim),
                                  min=eps))


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize with (at least) float32 accumulation; zero vectors stay
    zero (torch F.normalize semantics, SEG.py:112-114).  Returns x.dtype."""
    xf = x.to(_wide(x.dtype))
    norm = _safe_norm(xf, dim=dim, keepdim=True)
    return (x / torch.clamp(norm, min=eps)).to(x.dtype)


def _onehot(labels: torch.Tensor, max_k: int,
            dtype: torch.dtype) -> torch.Tensor:
    """[B, P] ids in {-1, 0..max_k-1} -> [B, P, max_k] dtype; -1 gives an
    all-zero row."""
    ks = torch.arange(max_k, device=labels.device)
    return (labels[..., None] == ks).to(dtype)


def compute_cluster_means(x: torch.Tensor, labels: torch.Tensor, max_k: int,
                          normalize: bool = True
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical means of pixel embeddings per cluster.

    x [B, H, W, C] (NHWC), labels [B, H, W] in {-1, 0..K-1}, -1 ignored.
    Returns (means [B, max_k, C], counts [B, max_k]).
    """
    b, h, w, c = x.shape
    xf = x.reshape(b, h * w, c).to(_wide(x.dtype))
    onehot = _onehot(labels.reshape(b, h * w), max_k, xf.dtype)
    sums = torch.einsum("bpk,bpc->bkc", onehot, xf)
    counts = onehot.sum(dim=1)
    means = sums / (counts[..., None] + 1e-10)
    if normalize:
        means = l2_normalize(means, dim=-1)
    return means, counts


def embedding_loss(x: torch.Tensor, labels: torch.Tensor, *, alpha: float,
                   delta: float, lambda_intra: float, lambda_inter: float,
                   max_k: int = 32, metric: str = "cosine",
                   normalize: bool = True) -> EmbeddingLossOut:
    """Total = intra + inter loss of embeddings x [B, H, W, C] (unit-norm
    when normalize=True upstream) against labels [B, H, W].  Under a
    process group of more than one rank, this rank's share of the global
    batch's loss (see the module docstring)."""
    b, h, w, c = x.shape
    ft = _wide(x.dtype)
    xf = x.to(ft)
    lab = labels.to(torch.int64)
    lab = torch.where(lab >= max_k, torch.full_like(lab, -1), lab)
    group = data_parallel_group()

    k_dyn = lab.max() + 1                      # dynamic K (embedding.py:76)
    if group is not None:
        dist.all_reduce(k_dyn, op=dist.ReduceOp.MAX, group=group)
    k_f = k_dyn.to(ft)
    means, _ = compute_cluster_means(xf, lab, max_k, normalize)

    # intra loss
    labeled = (lab >= 0).to(ft)
    onehot = _onehot(lab.reshape(b, h * w), max_k, ft)
    mean_per_pixel = torch.einsum("bpk,bkc->bpc", onehot, means).reshape(
        b, h, w, c)
    if metric == "cosine":
        d_intra = labeled * (0.5 * (1.0 - (xf * mean_per_pixel).sum(-1)))
    else:
        d_intra = labeled * _safe_norm(xf - mean_per_pixel, dim=-1)
    d_flat = d_intra.reshape(b, h * w)
    with torch.no_grad():
        hard = d_intra - alpha > 0
        if group is None:
            any_hard, b_all = hard.any(), b
        else:  # the global batch's hard-pixel count and size
            counts = torch.stack([hard.sum(),
                                  torch.tensor(b, device=x.device)])
            dist.all_reduce(counts, group=group)
            any_hard, b_all = counts[0] > 0, counts[1].to(ft)
        over = (d_intra > alpha).to(ft) * labeled
        n_k = torch.einsum("bpk,bp->bk", onehot, over.reshape(b, h * w))
        w_pix = torch.einsum("bpk,bk->bp", onehot, n_k)
        w_pix = torch.clamp(w_pix * labeled.reshape(b, h * w), min=50.0) * k_f
    # w_pix is 0 only when the batch holds no label (k_f = 0): 0 / eps keeps
    # the gradient finite there
    intra_sum = ((d_flat ** 2)
                 / torch.clamp(w_pix, min=1e-12)).sum() / b_all
    intra = torch.where(any_hard, intra_sum, torch.zeros_like(intra_sum))
    intra = intra * lambda_intra

    # inter loss
    if metric == "cosine":
        d_inter = 0.5 * (1.0 - torch.einsum("bkc,blc->bkl", means, means))
    else:
        d_inter = _safe_norm(means[:, :, None, :] - means[:, None, :, :],
                             dim=-1)
    ks = torch.arange(max_k, device=x.device)
    valid_pair = ((ks[:, None] < k_dyn) & (ks[None, :] < k_dyn)
                  & (ks[:, None] != ks[None, :]))[None]
    hinge = torch.clamp(delta - d_inter, min=0.0) * valid_pair.to(ft)
    inter_sum = (hinge ** 2).sum() / torch.clamp(
        k_f * (k_f - 1.0) / 2.0 * b_all, min=1.0)
    inter = torch.where(k_dyn > 1, inter_sum, torch.zeros_like(inter_sum))
    inter = inter * lambda_inter
    return EmbeddingLossOut(loss=intra + inter, intra=intra, inter=inter)
