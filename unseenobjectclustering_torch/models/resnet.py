"""Dilated ResNet fully-convolutional backbones (PyTorch, NCHW inside).

Port of ``unseenobjectclustering_tpu/models/resnet.py``, itself a
re-implementation of the reference's modified torchvision ResNet
(lib/networks/resnet.py:116-270) and the output-stride-8 FCN wrappers
(lib/networks/resnet_dilated.py:287-327, :433-468):

  * stride->dilation conversion once the running stride reaches the
    requested output stride (lib/networks/resnet.py:200-211): for
    output_stride=8, layer3 becomes dilation 2 and layer4 dilation 4, both
    stride 1.
  * "full padding" for dilated 3x3 convs, padding == dilation, symmetric as
    in torch (lib/networks/resnet.py:24-41).
  * 1x1 scoring conv with a bias (the reference's replaced ``fc``), then
    bilinear align_corners=True upsampling back to the input resolution.

Submodule names follow the reference key layout (``conv1``, ``bn1``,
``layer2.1.conv1``, ``layer2.0.downsample.0``/``.1``, ``fc``), so a
reference-layout state_dict loads with ``strict=True``.

In train mode BatchNorm updates its running statistics as flax's
``nn.BatchNorm(momentum=0.9)`` does, with the biased batch variance
(``BatchNorm2d``), and a convolution may compute in bfloat16 over float32
parameters (``Conv2d.compute_dtype``, the JAX package's
``dtype=bfloat16, param_dtype=float32``).  Under data parallelism
(a ``parallel.data_parallel`` block of more than one rank) train-mode
BatchNorm normalizes with the statistics of the global batch, as flax's
does over a sharded batch (``_GlobalBatchNorm``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
import torch.nn.functional as F

from unseenobjectclustering_torch.parallel import spatial
from unseenobjectclustering_torch.parallel.distributed import (
    data_parallel_group)


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in `compute_dtype` when it is set: input,
    weight and bias are cast for the product, the parameters (and so the
    gradients and the optimizer state) keep their own dtype.  Inside a
    parallel.spatial shard it computes its band of columns."""

    compute_dtype: Optional[torch.dtype] = None

    def _conv_forward(self, x, weight, bias):
        shard = spatial.current()
        if shard is None:
            return super()._conv_forward(x, weight, bias)
        return shard.conv2d(x, weight, bias, self.stride, self.padding,
                            self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None or dt == self.weight.dtype:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch normalization over the global batch of a process
    group: each rank holds [N_r, C, H, W] of it.

    Forward: each rank's per-channel mean and biased variance (in float32,
    or float64 for float64 input) become sums n_r * mean_r and n_r *
    (var_r + mean_r^2) in float64, all-reduced with the counts in one
    call; the global variance is S2 / n - mean^2 in float64, so the
    cancellation loses no float32 digits.  Backward: the per-channel sums
    of dy and of dy * x_hat are all-reduced (the global batch's terms of
    dx); the weight and bias gradients stay this rank's share, summed with
    the other ranks' by the train step's gradient all-reduce.  Returns
    (y, mean, var) with mean and var (biased) for the running update.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        ft = torch.promote_types(x.dtype, torch.float32)
        var_r, mean_r = torch.var_mean(x.to(ft), dim=(0, 2, 3),
                                       unbiased=False)
        n_r = x.numel() // c
        m64 = mean_r.double()
        stats = torch.cat([m64 * n_r, (var_r.double() + m64 * m64) * n_r,
                           m64.new_full((1,), float(n_r))])
        dist.all_reduce(stats, group=group)
        n = stats[2 * c:]
        mean = stats[:c] / n
        var = torch.clamp(stats[c:2 * c] / n - mean * mean, min=0.0)
        mean, var = mean.to(ft), var.to(ft)
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd, n.to(ft))
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        c = x.shape[1]

        def per_channel(v):
            return v[None, :, None, None]

        dyf = dy.to(mean.dtype)
        xhat = (x.to(mean.dtype) - per_channel(mean)) * per_channel(invstd)
        sum_dy = dyf.sum(dim=(0, 2, 3))
        sum_dy_xhat = (dyf * xhat).sum(dim=(0, 2, 3))
        sums = torch.cat([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        sums = sums / n
        dx = (dyf - per_channel(sums[:c]) - xhat * per_channel(sums[c:])
              ) * per_channel(weight * invstd)
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d whose train-mode update of the running statistics is
    flax's: running = 0.9 * running + 0.1 * batch statistic, with the
    BIASED batch variance (torch writes the unbiased one; the two differ by
    n/(n-1)).  Normalization, eval mode and the state_dict keys are
    torch's.  One pass over the activation: torch's own update, then its
    batch term rescaled by (n-1)/n.

    In train mode inside a parallel.data_parallel block of more than one
    rank (parallel.data_parallel_group), the batch statistics are the global
    batch's, forward and backward (_GlobalBatchNorm), and the running
    statistics take the global biased variance, as flax's BatchNorm under
    a sharded jit does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if spatial.current() is not None:
            raise NotImplementedError("the spatial route runs eval-mode "
                                      "BatchNorm only")
        m = self.momentum
        group = data_parallel_group()
        if group is not None:
            y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                                  self.eps, group)
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
                self.num_batches_tracked.add_(1)
            return y
        n = x.numel() // x.shape[1]
        # torch's update goes to a copy (the backward may read the tensor
        # it was given): var = kept + m * unbiased
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, m, self.eps)
        with torch.no_grad():
            kept = self.running_var.mul(1.0 - m)
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
            self.num_batches_tracked.add_(1)
        return y


def _conv(inplanes: int, planes: int, kernel: int, stride: int = 1,
          dilation: int = 1, padding: int | None = None,
          bias: bool = False) -> Conv2d:
    """Conv2d with torch-style symmetric padding (default: 'full padding'
    for the dilated kernel, i.e. pad = dilation for a 3x3)."""
    if padding is None:
        k_up = (kernel - 1) * (dilation - 1) + kernel
        padding = (k_up - 1) // 2
    return Conv2d(inplanes, planes, kernel, stride, padding,
                  dilation=dilation, bias=bias)


def _downsample(inplanes: int, planes: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(inplanes, planes, 1, stride, padding=0),
                         BatchNorm2d(planes))


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection residual (expansion 1)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (_downsample(inplanes, planes, stride)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck residual (expansion 4)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1, padding=0)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride, dilation)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1, padding=0)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (_downsample(inplanes, planes * 4, stride)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


def _plan_layers(block_expansion: int, layers: Sequence[int],
                 output_stride: int) -> list[list[dict]]:
    """The stride->dilation bookkeeping of lib/networks/resnet.py:188-234,
    returned as per-block specs."""
    current_stride = 4
    current_dilation = 1
    inplanes = 64
    plan: list[list[dict]] = []
    for layer_idx, (planes, blocks) in enumerate(
            zip((64, 128, 256, 512), layers)):
        stride = 1 if layer_idx == 0 else 2
        has_downsample = False
        if stride != 1 or inplanes != planes * block_expansion:
            if current_stride == output_stride:
                current_dilation *= stride
                stride = 1
            else:
                current_stride *= stride
            has_downsample = True
        specs = [dict(planes=planes, stride=stride,
                      dilation=current_dilation,
                      has_downsample=has_downsample)]
        inplanes = planes * block_expansion
        for _ in range(1, blocks):
            specs.append(dict(planes=planes, stride=1,
                              dilation=current_dilation,
                              has_downsample=False))
        plan.append(specs)
    return plan


class ResNetFCN(nn.Module):
    """Dilated ResNet trunk + 1x1 scoring conv + x(output_stride) bilinear
    upsample (Resnet34_8s / Resnet50_8s, resnet_dilated.py:287-327,
    :433-468).

    forward takes NCHW and returns NHWC float32 [B, H, W, num_classes]: the
    1x1 head's output is cast to float32 before the upsample, whatever the
    dtype of the conv stack (resnet.py:202 in the JAX package); a float64
    network stays float64.
    """

    def __init__(self, block: str, layers: Sequence[int],
                 num_classes: int = 64, output_stride: int = 8,
                 in_channels: int = 3):
        super().__init__()
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = _conv(in_channels, 64, 7, 2, padding=3)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        plan = _plan_layers(block_cls.expansion, layers, output_stride)
        for layer_idx, specs in enumerate(plan):
            blocks = []
            for spec in specs:
                blocks.append(block_cls(inplanes, **spec))
                inplanes = spec["planes"] * block_cls.expansion
            setattr(self, f"layer{layer_idx + 1}", nn.Sequential(*blocks))
        self.fc = _conv(inplanes, num_classes, 1, padding=0, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = spatial.frame_hw(x)
        x = x.to(self.conv1.compute_dtype or self.conv1.weight.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = spatial.max_pool2d(x, 3, 2, 1)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.fc(x)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        x = x.permute(0, 2, 3, 1)
        return spatial.upsample_bilinear(x, in_hw)
