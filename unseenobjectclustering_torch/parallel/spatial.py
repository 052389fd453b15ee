"""Width-sharded stage 1: one frame split by columns over the ranks of a
parallel.Mesh, each layer exchanging its own halo with the neighbours.

The JAX package shards the frame's width over its device mesh and lets
XLA's SPMD partitioner insert the halo exchanges and collectives
(Segmentor.make_spatial_stage1).  Torch has no such partitioner, and its
DTensor convolution refuses dilation and strided padding, which the
dilated ResNet-8s has.  So here the network's own modules consult the
shard that ``SpatialShard.active()`` installs for the length of a call
and compute their band of columns exactly, in their own arithmetic:

  * a convolution (any kernel, stride, dilation, padding) takes
    ``halo_exchange``'s columns from its neighbours, dilation*(k-1) in
    all: ``padding`` on the left and dilation*(k-1) - padding - stride + 1
    on the right (3 and 2 for the 7x7/2 stem, 1 and 0 for a 3x3/2, none
    for a 1x1/2), and runs with no width padding; at the frame's own
    edges the halo is the padding value (0);
  * max_pool2d likewise, with -inf at the frame's edges;
  * the align_corners=True head upsample takes its rows of the GLOBAL
    interpolation matrix over the low-resolution band and a 1-column
    halo, and the U-Net's align_corners=False 2x upsample and VGG's 4x4/2
    transposed convolution a 1-column halo (none at the frame's edges,
    where the global op clamps or sees nothing);
  * GroupNorm reduces over all of H x W: each rank's per-(frame, group)
    sums are all-reduced in float64.
  Eval BatchNorm, ReLU, the add / cat fusion and the L2 normalisation are
  per pixel and need nothing.

The width rule: W splits into `world` bands whose width is a multiple of
the network's total stride (8 for ResNet-8s, 16 for the U-Net, 32 for
VGG), so every stride-2 layer samples the same global columns on every
rank, and at the lowest resolution a band is at least as wide as the
widest halo there (4 columns for ResNet-8s, layer4's dilation), so a halo
never reaches past the next rank.  ``plan_network`` names the network's
numbers, ``SpatialShard`` refuses a width that breaks the rule.  A module
the route does not cover raises with its name; nothing runs unsharded.

The collectives: every halo and the final gather are all_gathers of equal
slabs, which NCCL runs on the card.  gloo's all_gather takes host memory
only (on CUDA tensors it writes device pointers to its socket and aborts
the process), so under gloo a CUDA slab is staged through the host
explicitly; GroupNorm's all_reduce runs on the card under both.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from unseenobjectclustering_torch.ops import resize

_SHARD: contextvars.ContextVar[Optional["SpatialShard"]] = (
    contextvars.ContextVar("spatial_shard", default=None))

RULE = ("the width must split into one band per rank whose width is a "
        "multiple of the network's total stride and, at the lowest "
        "resolution, at least its widest halo")


class NetworkPlan(NamedTuple):
    """What the width rule and the first layer need of a network."""
    name: str
    stride: int        # total stride: a band is a multiple of it
    halo: int          # widest halo at the lowest resolution, in columns
    input_halo: tuple  # the first convolution's (left, right) halo


def current() -> Optional["SpatialShard"]:
    """The shard of the enclosing SpatialShard.active() block, or None."""
    return _SHARD.get()


def _conv_halo(kernel: int, stride: int, padding: int, dilation: int
               ) -> tuple[int, int]:
    """The (left, right) input columns beyond a band of a convolution or
    pooling window; a negative right means the band's last columns are not
    read."""
    return padding, dilation * (kernel - 1) - padding - stride + 1


def plan_network(model: torch.nn.Module) -> NetworkPlan:
    """The width rule's numbers of a models.SEGNET, after checking that the
    route covers every module in it (raises with the first one it does
    not cover)."""
    from torch import nn

    from unseenobjectclustering_torch.models import resnet, segnet, unets

    covered = (segnet.SEGNET, segnet._Tower, resnet.ResNetFCN,
               resnet.BasicBlock, resnet.Bottleneck, resnet.Conv2d,
               resnet.BatchNorm2d, nn.Sequential, unets.UNetEmbedding,
               unets.UNetEncoder, unets.UNetDecoder, unets.ConvGNReLU,
               unets.ConvGNReLUx2, unets.UpsampleConcatConv,
               unets.GroupNorm, unets.VGGEmbedding, unets.ConvTranspose2d)
    for name, mod in model.named_modules():
        if type(mod) not in covered:
            raise NotImplementedError(
                f"the spatial route does not cover {name or 'the model'} "
                f"({type(mod).__name__})")
        if isinstance(mod, nn.Conv2d) and mod.padding_mode != "zeros":
            raise NotImplementedError(f"the spatial route pads with zeros; "
                                      f"{name} pads {mod.padding_mode}")
    if not isinstance(model, segnet.SEGNET):
        raise NotImplementedError(f"the spatial route takes a SEGNET, not "
                                  f"{type(model).__name__}")
    arch = model.network_name
    tower = getattr(model.fcn, arch)
    if arch == "unet":
        stride, halo = 16, 1
    elif arch == "vgg":
        stride, halo = 32, 1
    else:  # the ResNet-8s family: layer3/4 dilated at 1/8
        stride = 8
        halo = max(m.dilation[1] * (m.kernel_size[1] - 1) // 2
                   for m in tower.layer4.modules()
                   if isinstance(m, nn.Conv2d))
    first = next(m for m in tower.modules() if isinstance(m, nn.Conv2d))
    left, right = _conv_halo(first.kernel_size[1], first.stride[1],
                             first.padding[1], first.dilation[1])
    return NetworkPlan(arch, stride, halo, (left, max(right, 0)))


class SpatialShard:
    """This rank's band of a frame's columns: rank r of `world` holds
    columns [r * W / world, (r + 1) * W / world) of the frame, and at every
    resolution the same share of them.  Built from a parallel.Mesh (the
    default process group) and the frame's width W; raises unless W meets
    the width rule of `plan`."""

    def __init__(self, mesh: Any, width: int, plan: NetworkPlan):
        self.rank, self.world = int(mesh.rank), int(mesh.world)
        self.width, self.plan = int(width), plan
        band = self.width // self.world
        if (self.width % self.world or band % plan.stride
                or band // plan.stride < plan.halo):
            raise ValueError(
                f"{RULE}: {plan.name} (stride {plan.stride}, halo "
                f"{plan.halo}) cannot split W={self.width} over "
                f"{self.world} ranks (bands of {self.width / self.world:g} "
                f"columns; need a multiple of {plan.stride} of at least "
                f"{plan.stride * plan.halo})")
        self.band = band
        self.c0, self.c1 = self.rank * band, (self.rank + 1) * band

    @property
    def input_width(self) -> int:
        """The width of the uploaded input: the band and the first
        layer's halo."""
        return self.band + sum(self.plan.input_halo)

    @contextlib.contextmanager
    def active(self):
        """Route the network's layers through this shard inside."""
        token = _SHARD.set(self)
        try:
            yield self
        finally:
            _SHARD.reset(token)

    # -- collectives ----------------------------------------------------------

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's `t` (same shape on every rank), in rank order."""
        if self.world == 1:
            return [t]
        staged = t.is_cuda and dist.get_backend() == "gloo"
        src = t.contiguous().cpu() if staged else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return [p.to(t.device) for p in parts] if staged else parts

    def halo_exchange(self, x: torch.Tensor, left: int, right: int,
                      fill: Optional[float] = 0.0, dim: int = -1
                      ) -> torch.Tensor:
        """x with `left` columns of the left neighbour's band before it and
        `right` of the right neighbour's after it (along `dim`).  At the
        frame's own edges the columns are `fill`, or absent when fill is
        None."""
        dim = dim % x.dim()
        bw = x.shape[dim]
        if left > bw or right > bw:
            raise ValueError(f"{RULE}: a halo of {left}/{right} columns "
                             f"reaches past a band of {bw}")
        if left == right == 0:
            return x
        parts = self.all_gather(torch.cat(
            [x.narrow(dim, 0, right), x.narrow(dim, bw - left, left)], dim))
        pieces = [x]
        if self.rank > 0:
            pieces.insert(0, parts[self.rank - 1].narrow(dim, right, left))
        elif fill is not None and left:
            shape = list(x.shape)
            shape[dim] = left
            pieces.insert(0, x.new_full(shape, fill))
        if self.rank < self.world - 1:
            pieces.append(parts[self.rank + 1].narrow(dim, 0, right))
        elif fill is not None and right:
            shape = list(x.shape)
            shape[dim] = right
            pieces.append(x.new_full(shape, fill))
        return torch.cat(pieces, dim)

    def gather_columns(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The whole frame from every rank's band (NHWC: dim 2)."""
        return torch.cat(self.all_gather(x), dim)

    def upload(self, a: Any, device: Any) -> Optional[torch.Tensor]:
        """This rank's band of a [B, H, W, C] frame (numpy or tensor, on
        any device) with the first layer's halo, zeros beyond the frame,
        as float32 on `device`."""
        if a is None:
            return None
        left, right = self.plan.input_halo
        lo, hi = max(self.c0 - left, 0), min(self.c1 + right, self.width)
        t = torch.as_tensor(a[:, :, lo:hi], dtype=torch.float32).to(device)
        pad = (lo - (self.c0 - left), (self.c1 + right) - hi)
        return F.pad(t, (0, 0) + pad) if any(pad) else t

    # -- layers ---------------------------------------------------------------

    def conv2d(self, x, weight, bias, stride, padding, dilation, groups):
        left, right = _conv_halo(weight.shape[-1], stride[1], padding[1],
                                 dilation[1])
        if x.shape[-1] == self.input_width:  # the uploaded input
            if (left, max(right, 0)) != self.plan.input_halo:
                raise ValueError("the frame's input reached a convolution "
                                 "that is not the network's first")
        else:
            x = self.halo_exchange(x, left, max(right, 0))
        if right < 0:
            x = x[..., :right]
        return F.conv2d(x, weight, bias, stride, (padding[0], 0), dilation,
                        groups)

    def conv_transpose2d(self, x, weight, bias, stride, padding,
                         output_padding, groups, dilation):
        s, p, d = stride[1], padding[1], dilation[1]
        k = weight.shape[-1]
        w_in = x.shape[-1] * self.world
        w_out = (w_in - 1) * s - 2 * p + d * (k - 1) + output_padding[1] + 1
        if w_out != s * w_in:
            raise NotImplementedError(
                f"the spatial route takes a transposed convolution that "
                f"scales the width by its stride ({w_in} -> {w_out})")
        left, right = -(-(d * (k - 1) - p) // s), (p - 1) // s + 1
        bw = x.shape[-1]
        y = F.conv_transpose2d(self.halo_exchange(x, left, right), weight,
                               bias, stride, (padding[0], 0),
                               (output_padding[0], 0), groups, dilation)
        return y[..., s * left + p:s * left + p + s * bw]

    def max_pool2d(self, x, kernel: int, stride: int, padding: int = 0):
        left, right = _conv_halo(kernel, stride, padding, 1)
        x = self.halo_exchange(x, left, max(right, 0), fill=-math.inf)
        if right < 0:
            x = x[..., :right]
        return F.max_pool2d(x, kernel, stride, (padding, 0))

    def group_norm(self, x, num_groups, weight, bias, eps):
        """F.group_norm over the whole frame: each (frame, group)'s mean
        and biased variance from every rank's float64 sums, applied as
        torch's kernels apply them (x * scale + shift per channel)."""
        b, c = x.shape[:2]
        v, m = torch.var_mean(x.reshape(b, num_groups, -1).double(), dim=-1,
                              unbiased=False)
        n = x[0, :c // num_groups].numel()
        stats = torch.stack([m * n, (v + m * m) * n])
        if self.world > 1:
            dist.all_reduce(stats)
        total = n * self.world
        mean64 = stats[0] / total
        var = torch.clamp(stats[1] / total - mean64 * mean64, min=0.0)
        rstd = torch.rsqrt(var + eps).to(x.dtype).repeat_interleave(
            c // num_groups, dim=1)
        mean = mean64.to(x.dtype).repeat_interleave(c // num_groups, dim=1)
        scale = rstd * weight
        shift = bias - mean * scale
        return x * scale[..., None, None] + shift[..., None, None]

    def upsample_bilinear(self, x: torch.Tensor, out_h: int
                          ) -> torch.Tensor:
        """ops.resize.upsample_bilinear of NHWC x [B, h, band, C] to the
        frame's (out_h, W): the global height matrix, and this rank's rows
        of the global width matrix over its band and a 1-column halo."""
        h_in, bw = x.shape[-3], x.shape[-2]
        w_in = bw * self.world
        ft = torch.promote_types(x.dtype, torch.float32)
        wh = torch.from_numpy(resize._bilinear_matrix_align_corners(
            h_in, out_h))
        rows = resize._bilinear_matrix_align_corners(w_in, self.width)[
            self.c0:self.c1]
        c0 = self.rank * bw
        lo, hi = max(c0 - 1, 0), min(c0 + bw + 1, w_in)
        if np.any(rows[:, :lo]) or np.any(rows[:, hi:]):
            raise ValueError(f"{RULE}: the head's upsample reads beyond a "
                             "1-column halo")
        ww = torch.from_numpy(np.ascontiguousarray(rows[:, lo:hi]))
        slab = self.halo_exchange(x, 1, 1, fill=None, dim=-2)
        y = torch.einsum("oh,...hwc->...owc", wh.to(x.device, ft),
                         slab.to(ft))
        y = torch.einsum("pw,...owc->...opc", ww.to(x.device, ft), y)
        return y.to(x.dtype)

    def upsample2x(self, x: torch.Tensor) -> torch.Tensor:
        """F.interpolate(x, scale_factor=2, bilinear, align_corners=False)
        of this rank's band of NCHW x: the same op on the band and a
        1-column halo, whose outputs over the band are the global ones
        (clamped at the frame's edges only)."""
        bw = x.shape[-1]
        y = F.interpolate(self.halo_exchange(x, 1, 1, fill=None),
                          scale_factor=2, mode="bilinear",
                          align_corners=False)
        start = 2 if self.rank > 0 else 0
        return y[..., start:start + 2 * bw]


# -- what the models call: the plain op outside a shard -----------------------

def max_pool2d(x: torch.Tensor, kernel: int, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    shard = current()
    stride = kernel if stride is None else stride
    if shard is None:
        return F.max_pool2d(x, kernel, stride, padding)
    return shard.max_pool2d(x, kernel, stride, padding)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    shard = current()
    if shard is None:
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)
    return shard.upsample2x(x)


def frame_hw(x: torch.Tensor) -> tuple[int, int]:
    """The (H, W) of the frame an NCHW network input belongs to."""
    shard = current()
    return (x.shape[-2], x.shape[-1] if shard is None else shard.width)


def upsample_bilinear(x: torch.Tensor, out_hw: tuple[int, int]
                      ) -> torch.Tensor:
    shard = current()
    if shard is None:
        return resize.upsample_bilinear(x, out_hw)
    return shard.upsample_bilinear(x, out_hw[0])
