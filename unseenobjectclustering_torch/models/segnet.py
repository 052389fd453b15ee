"""SEGNET: the embedding network with RGB-D modality fusion (PyTorch).

Port of ``unseenobjectclustering_tpu/models/segnet.py`` (reference
lib/networks/SEG.py:26-119):

  * backbone by network name (resnet18_8s / resnet34_8s / resnet50_8s,
    and the alternates unet / vgg of models/unets.py; vgg with the
    ``batch_norm`` flag of the reference's DSL, SEG.py:28),
  * input modality (COLOR / DEPTH / RGBD) and fusion type:
      - 'early': channel-concat RGB+XYZ into one 6-channel tower
      - 'add':   two towers, features summed
      - 'cat':   two towers, features channel-concatenated (2*num_units)
  * L2 feature normalization (SEG.py:112-114).

Public layout is NHWC, as in the JAX package: inputs [B, H, W, 3], output
[B, H, W, E] float32.  The towers run NCHW inside.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unseenobjectclustering_torch.models.losses import l2_normalize
from unseenobjectclustering_torch.models.resnet import ResNetFCN
from unseenobjectclustering_torch.models.unets import (UNetEmbedding,
                                                       VGGEmbedding)

_RESNETS = {
    "resnet18_8s": ("basic", (2, 2, 2, 2)),
    "resnet34_8s": ("basic", (3, 4, 6, 3)),
    "resnet50_8s": ("bottleneck", (3, 4, 6, 3)),
}
_BACKBONES = tuple(_RESNETS) + ("unet", "vgg")


class _Tower(nn.Module):
    """One backbone under its reference attribute name, so state_dict keys
    read ``fcn.resnet34_8s.layer2.1.conv1.weight`` (resnet_dilated.py) or
    ``fcn.vgg.enc_conv0.weight``."""

    def __init__(self, network_name: str, num_units: int, in_channels: int,
                 batch_norm: bool = False):
        super().__init__()
        self.arch = network_name
        if network_name == "unet":
            net = UNetEmbedding(num_units, in_channels)
        elif network_name == "vgg":
            net = VGGEmbedding(num_units, batch_norm, in_channels)
        else:
            block, layers = _RESNETS[network_name]
            net = ResNetFCN(block, layers, num_classes=num_units,
                            output_stride=8, in_channels=in_channels)
        setattr(self, network_name, net)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.arch)(x)


class SEGNET(nn.Module):
    """Pixel-embedding segmentation network.

    forward(img, depth): img [B, H, W, 3] normalized BGR (None for DEPTH),
    depth [B, H, W, 3] XYZ (None for COLOR).  Returns [B, H, W, E] float32
    unit-norm embeddings (E = num_units, or 2*num_units for fusion 'cat').
    """

    def __init__(self, network_name: str = "resnet34_8s",
                 input_type: str = "RGBD", fusion_type: str = "add",
                 num_units: int = 64, normalize: bool = True,
                 batch_norm: bool = False):
        super().__init__()
        if network_name not in _BACKBONES:
            raise ValueError(f"unknown network_name: {network_name}")
        self.network_name = network_name
        self.input_type = input_type
        self.fusion_type = fusion_type
        self.num_units = num_units
        self.normalize = normalize
        early = input_type == "RGBD" and fusion_type == "early"
        self.fcn = _Tower(network_name, num_units, 6 if early else 3,
                          batch_norm)
        if input_type == "RGBD" and not early:
            self.fcn_depth = _Tower(network_name, num_units, 3, batch_norm)

    @property
    def embedding_dim(self) -> int:
        if self.input_type == "RGBD" and self.fusion_type == "cat":
            return 2 * self.num_units
        return self.num_units

    def forward(self, img: Optional[torch.Tensor],
                depth: Optional[torch.Tensor] = None) -> torch.Tensor:
        def nchw(t):
            return t.permute(0, 3, 1, 2)

        if self.input_type == "DEPTH":
            features = self.fcn(nchw(depth))
        elif self.input_type == "COLOR":
            features = self.fcn(nchw(img))
        elif self.fusion_type == "early":
            features = self.fcn(nchw(torch.cat([img, depth], dim=-1)))
        else:
            f_rgb = self.fcn(nchw(img))
            f_d = self.fcn_depth(nchw(depth))
            if self.fusion_type == "add":
                features = f_rgb + f_d
            else:  # 'cat' -> 2*num_units channels
                features = torch.cat([f_rgb, f_d], dim=-1)
        if self.normalize:
            features = l2_normalize(features, dim=-1)
        return features
