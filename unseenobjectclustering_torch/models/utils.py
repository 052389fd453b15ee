"""Small network utilities (parity with lib/networks/utils.py and the JAX
package's models/utils.py): a numerically stable softmax pair and the
CoordConv concat (broken in the reference, utils.py:46-50; working here as
in the JAX package)."""

from __future__ import annotations

import torch


def log_softmax_stable(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Numerically stable log-softmax (lib/networks/utils.py:7-20;
    torch's subtracts the max)."""
    return torch.log_softmax(x, dim=dim)


def softmax_stable(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.softmax(x, dim=dim)


def concatenate_spatial_coordinates(x: torch.Tensor,
                                    normalize: bool = True) -> torch.Tensor:
    """CoordConv: append (y, x) coordinate channels to an NHWC feature map
    (lib/networks/utils.py:38-55 intent)."""
    b, h, w, _ = x.shape
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    if normalize:
        ys = ys / max(h - 1, 1) * 2.0 - 1.0
        xs = xs / max(w - 1, 1) * 2.0 - 1.0
    coords = torch.stack([ys, xs], dim=-1)[None].expand(b, h, w, 2)
    return torch.cat([x, coords.to(x.dtype)], dim=-1)
