"""High-level constructors wiring config + networks + checkpoints together.

Port of ``unseenobjectclustering_tpu/engine/builder.py``: the layer the
port's entry points (``unseenobjectclustering_torch/tools``) and serving
wrappers call, equivalent to the model-preparation blocks of the
reference's entry points (tools/test_net.py:109-128,
tools/test_images.py:189-209).

A checkpoint is a reference-layout ``.pth`` file or a raw torchvision
ImageNet resnet ``.pth`` (``utils/checkpoint.load_state_dict_file``), or a
training snapshot of the port's trainer: a snapshots' directory (its
newest snapshot) or one snapshot ``<dir>/<epoch>``
(``utils/checkpoint.load_snapshot_model``).
"""

from __future__ import annotations

import os
import sys
from typing import Any, Optional

import torch

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.engine.pipeline import (Segmentor,
                                                          resolve_device)
from unseenobjectclustering_torch.models import get_network
from unseenobjectclustering_torch.utils.checkpoint import (
    load_snapshot_model, load_state_dict_file)


def init_state_dict(cfg: Config, network_name: str, seed: int = 3
                    ) -> dict[str, torch.Tensor]:
    """A network's initial state_dict (on the CPU), deterministic in seed.

    torch's own initializers draw from the default generator, seeded with
    `seed` inside ``torch.random.fork_rng``, so the caller's random state is
    left as it was.  These values cannot equal flax's initial values for the
    same seed (other initializers, other generator); weights shared with the
    JAX package come from a file or from ``state_dict_from_flax``.
    """
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return get_network(network_name, cfg).state_dict()


def load_network_state(cfg: Config, network_name: str,
                       pretrained: Optional[str], seed: int = 3
                       ) -> dict[str, torch.Tensor]:
    """The init state_dict with a checkpoint put over it when one is
    given: a training snapshot directory or a `.pth` file."""
    state = init_state_dict(cfg, network_name, seed)
    if not pretrained:
        return state
    if os.path.isdir(pretrained):
        state, step = load_snapshot_model(pretrained, state)
        print(f"=> restored training snapshot {step} from {pretrained}",
              file=sys.stderr)
        return state
    state = load_state_dict_file(pretrained, state)
    print(f"=> loaded torch checkpoint {pretrained}", file=sys.stderr)
    return state


def build_segmentor(cfg: Config, network_name: str,
                    pretrained: Optional[str] = None,
                    pretrained_crop: Optional[str] = None,
                    depth_threshold: Optional[float] = 0.8,
                    model_dtype: Optional[torch.dtype] = None,
                    crop_network_name: Optional[str] = None,
                    device: Any = None) -> Segmentor:
    """Build the two-stage Segmentor from checkpoint paths (the reference's
    main+crop network pair, tools/test_net.py:109-128).

    The crop network is built only when `pretrained_crop` is given;
    crop_network_name lets the zoom-in stage use a lighter backbone than the
    main stage (e.g. seg_resnet18_8s_embedding).  The device defaults to
    the CUDA device and raises without one (pipeline.resolve_device).
    """
    device = resolve_device(device)
    state = load_network_state(cfg, network_name, pretrained)
    state_crop = (load_network_state(cfg, crop_network_name or network_name,
                                     pretrained_crop)
                  if pretrained_crop else None)
    return Segmentor(cfg, state, state_crop, network_name=network_name,
                     crop_network_name=crop_network_name,
                     depth_threshold=depth_threshold,
                     model_dtype=model_dtype, device=device)
