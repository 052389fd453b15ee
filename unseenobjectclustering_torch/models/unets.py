"""U-Net and VGG-style alternate embedding backbones (PyTorch).

Port of ``unseenobjectclustering_tpu/models/unets.py`` (reference
lib/networks/unets.py): a GroupNorm U-Net encoder/decoder with skip fusion
(UNet_Encoder :141-174, UNet_Decoder :176-241) and the VGG string-DSL
encoder/decoder (make_encoder_layers :90-104, make_decoder_layers
:107-136).  Each takes NCHW and returns NHWC float32 [B, H, W, num_units],
as the port's ResNetFCN does.

Submodule names are the flax module names, so
``utils/checkpoint.state_dict_from_flax`` carries the JAX package's
parameters key for key (``fcn.unet.encoder.layer1.layer1.conv.weight``,
``fcn.vgg.dec_tconv0.weight``, ...).  Two conventions differ between the
frameworks and are handled there or here:

  * flax's ``nn.ConvTranspose`` applies its kernel unflipped
    (``transpose_kernel=False``) and torch's ``ConvTranspose2d`` flipped:
    the carried weight is w[i, o, a, b] = k[K-1-a, K-1-b, i, o];
    flax ``padding="SAME"`` at kernel 4, stride 2 is torch ``padding=1``
    (an exact 2x upsample).
  * ``jax.image.resize(..., "bilinear")`` by 2 is
    ``F.interpolate(scale_factor=2, mode="bilinear",
    align_corners=False)``, borders included.

BatchNorm is the port's flax-style ``BatchNorm2d`` (momentum 0.9 in flax
terms, biased variance); GroupNorm normalizes in float32 with eps 1e-5
whatever the convolutions' dtype.  VGG's Dropout(0.2) draws from the
module's ``dropout_generator`` (a torch.Generator on the input's device),
which must be set before a train-mode forward; under data parallelism
each rank draws the global batch's mask and keeps its own rows of it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from unseenobjectclustering_torch.models.resnet import BatchNorm2d, Conv2d
from unseenobjectclustering_torch.parallel.distributed import (
    data_parallel_group, local_batch_slice, process_count)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d that computes in `compute_dtype` when it is set,
    over parameters of their own dtype (as models.resnet.Conv2d)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None or dt == self.weight.dtype:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm(eps=1e-5) computed in float32 (flax's GroupNorm keeps
    its statistics in float32), returned in the input's dtype."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(x.dtype, torch.float32)
        return F.group_norm(x.to(dt), self.num_groups, self.weight.to(dt),
                            self.bias.to(dt), self.eps).to(x.dtype)


def _input_dtype(conv: nn.Module) -> torch.dtype:
    return conv.compute_dtype or conv.weight.dtype


def _nhwc_float(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    return x.permute(0, 2, 3, 1)


class ConvGNReLU(nn.Module):
    """conv (no bias) + GroupNorm + ReLU (unets.py:9-30)."""

    def __init__(self, in_channels: int, features: int, num_groups: int,
                 ksize: int = 3, stride: int = 1):
        super().__init__()
        pad = 0 if ksize < 2 else ksize // 2
        self.conv = Conv2d(in_channels, features, ksize, stride, pad,
                           bias=False)
        self.gn = GroupNorm(num_groups, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(x)))


class ConvGNReLUx2(nn.Module):
    def __init__(self, in_channels: int, features: int, num_groups: int):
        super().__init__()
        self.layer1 = ConvGNReLU(in_channels, features, num_groups)
        self.layer2 = ConvGNReLU(features, features, num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer2(self.layer1(x))


class UNetEncoder(nn.Module):
    """4-level GroupNorm U-Net encoder (unets.py:141-174)."""

    def __init__(self, in_channels: int, feature_dim: int = 64):
        super().__init__()
        fd = feature_dim
        self.layer1 = ConvGNReLUx2(in_channels, fd, fd)
        self.layer2 = ConvGNReLUx2(fd, fd * 2, fd)
        self.layer3 = ConvGNReLUx2(fd * 2, fd * 4, fd)
        self.layer4 = ConvGNReLUx2(fd * 4, fd * 8, fd)
        self.last_layer = ConvGNReLU(fd * 8, fd * 16, fd)

    def forward(self, x: torch.Tensor):
        x1 = self.layer1(x)
        x2 = self.layer2(F.max_pool2d(x1, 2))
        x3 = self.layer3(F.max_pool2d(x2, 2))
        x4 = self.layer4(F.max_pool2d(x3, 2))
        return self.last_layer(F.max_pool2d(x4, 2)), [x1, x2, x3, x4]


class UpsampleConcatConv(nn.Module):
    """Channel-reduce + 2x bilinear upsample + skip concat + conv
    (unets.py:54-82)."""

    def __init__(self, in_channels: int, skip_channels: int,
                 out_channels: int, num_groups: int):
        super().__init__()
        self.channel_reduction_layer = ConvGNReLU(
            in_channels, in_channels // 2, num_groups)
        self.conv_gn_relu = ConvGNReLU(in_channels // 2 + skip_channels,
                                       out_channels, num_groups)

    def forward(self, x: torch.Tensor, skips: list[torch.Tensor]
                ) -> torch.Tensor:
        x = self.channel_reduction_layer(x)
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=False)
        return self.conv_gn_relu(torch.cat([x] + skips, dim=1))


class UNetDecoder(nn.Module):
    """U-Net decoder with skip fusion (unets.py:176-241)."""

    def __init__(self, feature_dim: int = 64, num_encoders: int = 1):
        super().__init__()
        fd = feature_dim
        self.fuse_layer = ConvGNReLU(fd * 16 * num_encoders, fd * 16, fd,
                                     ksize=1)
        for i, mult_in, mult_out in ((1, 16, 8), (2, 8, 4), (3, 4, 2),
                                     (4, 2, 1)):
            setattr(self, f"layer{i}", UpsampleConcatConv(
                fd * mult_in, fd * mult_out * num_encoders, fd * mult_out,
                fd))
        self.layer5 = ConvGNReLU(fd, fd, fd)
        self.last_conv = Conv2d(fd, fd, 3, 1, 1, bias=True)

    def forward(self, encoder_outputs) -> torch.Tensor:
        out = self.fuse_layer(torch.cat([e[0] for e in encoder_outputs],
                                        dim=1))
        for i in range(1, 5):
            out = getattr(self, f"layer{i}")(
                out, [e[1][4 - i] for e in encoder_outputs])
        return self.last_conv(self.layer5(out))


class UNetEmbedding(nn.Module):
    """Single-encoder U-Net embedding net (SEG.py:62-67 'unet' branch)."""

    def __init__(self, num_units: int = 64, in_channels: int = 3):
        super().__init__()
        self.encoder = UNetEncoder(in_channels, num_units)
        self.decoder = UNetDecoder(num_units, num_encoders=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(_input_dtype(self.encoder.layer1.layer1.conv))
        return _nhwc_float(self.decoder([self.encoder(x)]))


# VGG string DSL (SEG.py:21-23,47-50; unets.py:90-136)
VGG_ENCODER_ARCH: tuple = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                           512, 512, 512, "M", 512, 512, 512, "M", 1024, 1024)


def vgg_decoder_arch(num_units: int) -> tuple:
    return (1024, "d512", 512, 512, "D", "d512", 512, 512, "D", "d256", 256,
            256, "d128", 128, 128, "d64", 64, num_units)


class VGGEmbedding(nn.Module):
    """VGG16-based encoder-decoder embedding net ('vgg' branch of SEGNET).

    Encoder: conv3x3 + LeakyReLU(0.2) stacks with 2x2 max pools at the 'M'
    tokens; decoder: transposed conv 4x4 stride 2 at the 'dN' tokens,
    Dropout(0.2) at 'D', and a final linear conv for the embedding.
    batch_norm puts a BatchNorm between each conv/tconv and its LeakyReLU;
    the final conv stays linear in both modes (the JAX package's deviation
    from unets.py:127-129, which would clamp the embedding to the positive
    orthant).
    """

    def __init__(self, num_units: int = 64, batch_norm: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.dropout_generator: Optional[torch.Generator] = None
        self._steps: list[tuple[str, Optional[str]]] = []
        c, nrm = in_channels, 0

        def add(kind: str, name: Optional[str] = None,
                module: Optional[nn.Module] = None):
            if module is not None:
                setattr(self, name, module)
            self._steps.append((kind, name))

        def norm(channels: int):
            nonlocal nrm
            if batch_norm:
                add("module", f"bn{nrm}", BatchNorm2d(channels))
                nrm += 1

        idx = 0
        for v in VGG_ENCODER_ARCH:
            if v == "M":
                add("pool")
                continue
            add("module", f"enc_conv{idx}", Conv2d(c, v, 3, 1, 1))
            norm(v)
            add("lrelu")
            c, idx = v, idx + 1
        arch = vgg_decoder_arch(num_units)
        idx = 0
        for i, v in enumerate(arch):
            if isinstance(v, str) and v[0] == "d":
                out = int(v[1:])
                add("module", f"dec_tconv{idx}",
                    ConvTranspose2d(c, out, 4, 2, 1))
                norm(out)
                add("lrelu")
            elif isinstance(v, str) and v[0] == "D":
                add("dropout")
                continue
            else:
                out = int(v)
                add("module", f"dec_conv{idx}", Conv2d(c, out, 3, 1, 1))
                if i != len(arch) - 1:
                    norm(out)
                    add("lrelu")
            c, idx = out, idx + 1

    def _dropout(self, x: torch.Tensor, rate: float = 0.2) -> torch.Tensor:
        if not self.training:
            return x
        if self.dropout_generator is None:
            raise ValueError("VGGEmbedding in train mode draws its dropout "
                             "from dropout_generator: set a torch.Generator "
                             f"on {x.device}")
        shape, rows = x.shape, slice(None)
        if data_parallel_group() is not None:
            # the global batch's draws, this rank's rows of them
            shape = (x.shape[0] * process_count(),) + tuple(x.shape[1:])
            rows = local_batch_slice(shape[0])
        keep = torch.rand(shape, generator=self.dropout_generator,
                          device=x.device)[rows] >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(_input_dtype(self.enc_conv0))
        for kind, name in self._steps:
            if kind == "module":
                x = getattr(self, name)(x)
            elif kind == "pool":
                x = F.max_pool2d(x, 2)
            elif kind == "lrelu":
                x = F.leaky_relu(x, 0.2)
            else:
                x = self._dropout(x)
        return _nhwc_float(x)
