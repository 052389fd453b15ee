"""Model factory registry (PyTorch).

Port of ``unseenobjectclustering_tpu/models/__init__.py``: the
reference's ``networks.__dict__[name](num_classes, num_units, data)``
surface (lib/networks/SEG.py:163-186), ResNet names and the vgg/unet
alternates (models/unets.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.models.resnet import Conv2d, ResNetFCN
from unseenobjectclustering_torch.models.segnet import SEGNET
from unseenobjectclustering_torch.models.unets import ConvTranspose2d

__all__ = ["SEGNET", "ResNetFCN", "cast_convs", "compute_convs_in",
           "get_network", "NETWORK_FACTORIES"]


def _segnet(network_name: str, cfg: Config, num_units: int,
            fusion_override: Optional[str] = None) -> SEGNET:
    return SEGNET(network_name=network_name, input_type=cfg.INPUT,
                  fusion_type=fusion_override or cfg.TRAIN.FUSION_TYPE,
                  num_units=num_units,
                  normalize=bool(cfg.TRAIN.EMBEDDING_NORMALIZATION),
                  batch_norm=bool(cfg.TRAIN.VGG_BATCH_NORM))


def seg_resnet18_8s_embedding(cfg: Config, num_units: int = 64) -> SEGNET:
    """Resnet18_8s (resnet_dilated.py:90-107) through a SEG factory."""
    return _segnet("resnet18_8s", cfg, num_units)


def seg_resnet34_8s_embedding(cfg: Config, num_units: int = 64) -> SEGNET:
    """SEG.py:173-176 (3-channel towers)."""
    return _segnet("resnet34_8s", cfg, num_units)


def seg_resnet34_8s_embedding_early(cfg: Config, num_units: int = 64
                                    ) -> SEGNET:
    """SEG.py:178-181 (6-channel early-fusion tower)."""
    return _segnet("resnet34_8s", cfg, num_units, fusion_override="early")


def seg_resnet50_8s_embedding(cfg: Config, num_units: int = 64) -> SEGNET:
    """SEG.py:183-186."""
    return _segnet("resnet50_8s", cfg, num_units)


def seg_vgg_embedding(cfg: Config, num_units: int = 64) -> SEGNET:
    """SEG.py:163-166 (cfg.TRAIN.VGG_BATCH_NORM: BatchNorm after each
    hidden conv)."""
    return _segnet("vgg", cfg, num_units)


def seg_unet_embedding(cfg: Config, num_units: int = 64) -> SEGNET:
    """SEG.py:168-171."""
    return _segnet("unet", cfg, num_units)


NETWORK_FACTORIES = {
    "seg_resnet18_8s_embedding": seg_resnet18_8s_embedding,
    "seg_resnet34_8s_embedding": seg_resnet34_8s_embedding,
    "seg_resnet34_8s_embedding_early": seg_resnet34_8s_embedding_early,
    "seg_resnet50_8s_embedding": seg_resnet50_8s_embedding,
    "seg_vgg_embedding": seg_vgg_embedding,
    "seg_unet_embedding": seg_unet_embedding,
}


def get_network(name: str, cfg: Config,
                num_units: Optional[int] = None) -> SEGNET:
    """Build a network by its reference-compatible factory name."""
    if name not in NETWORK_FACTORIES:
        raise KeyError(f"unknown network {name!r}; available: "
                       f"{sorted(NETWORK_FACTORIES)}")
    units = num_units if num_units is not None else int(cfg.TRAIN.NUM_UNITS)
    return NETWORK_FACTORIES[name](cfg, units)


def cast_convs(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run the model's convolutions in dtype, in place.  BatchNorm's
    parameters and statistics stay float32 and normalize in float32, as the
    JAX package's flax BatchNorm does (param_dtype=float32): rounding them
    to bfloat16 as well moves the embeddings about twice as far from the
    JAX bf16 network's."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            mod.to(dtype)
    return model


def compute_convs_in(model: nn.Module, dtype: Optional[torch.dtype]
                     ) -> nn.Module:
    """Mixed precision for training, in place: the convolutions compute in
    dtype while their parameters stay float32 (the JAX package's
    ``model_dtype=bfloat16`` under ``param_dtype=float32``).  BatchNorm,
    the upsample and the normalize stay float32.  None undoes it."""
    for mod in model.modules():
        if isinstance(mod, (Conv2d, ConvTranspose2d)):
            mod.compute_dtype = dtype
    return model
