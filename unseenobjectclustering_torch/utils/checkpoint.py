"""Checkpoints: reference-layout ``.pth`` files, torchvision ImageNet
weights, full-state training snapshots, and the weight carry from flax
variables.

``load_state_dict_file`` reads a reference ``.pth`` (a raw state_dict, a
``{'model': ...}`` wrapper, DataParallel ``module.`` prefixes, legacy
``decoder.features.`` keys) onto a model's init state_dict with the
reference's lenient partial load (SEG.py:130-159, the JAX package's
``_validate_against``): a key the model expects and the file lacks raises,
a shape mismatch keeps the init value with a warning, keys of other modules
are ignored.  The port's SEGNET uses the reference key layout, so no
transpose is needed.  A ``num_batches_tracked`` counter the file lacks (the
JAX package's ``export_torch_state_dict`` writes none) keeps its init value:
evaluation never reads it.

``state_dict_from_flax`` is the weight carry, flax variables -> the port's
state_dict: a port-side copy of the mapping in ``export_torch_state_dict``
(``unseenobjectclustering_tpu/utils/checkpoint.py``), so weights trained or
initialized in the JAX package load into the port without importing it:

  params/<tower>/layer<L>_<i>/conv1/kernel  [kh,kw,in,out]
      -> <tower>.<arch>.layer<L>.<i>.conv1.weight  [out,in,kh,kw]
  .../bn1/{scale,bias}                  -> .bn1.{weight,bias}
  batch_stats/.../bn1/{mean,var}        -> .bn1.{running_mean,running_var}
  .../downsample_conv, downsample_bn    -> .downsample.0, .downsample.1

plus a zero ``num_batches_tracked`` per BatchNorm, so the result loads with
``strict=True``.  Flax BatchNorm(momentum=0.9, epsilon=1e-5) is torch's
BatchNorm2d(momentum=0.1, eps=1e-5), the port's default.  The alternate
backbones carry the same way under ``<tower>.unet.`` / ``<tower>.vgg.``
with their flax module names; VGG's transposed convolutions
(``dec_tconv*``) flip their kernel, since flax applies it unflipped and
torch flipped: w[i,o,a,b] = k[K-1-a,K-1-b,i,o].

``convert_imagenet_checkpoint`` is the EMBEDDING_PRETRAIN partial load
(the reference's lib/networks/resnet.py:293-317): a raw torchvision
resnet state_dict (``conv1.weight``, ``layer1.0.conv1.weight``, ...) goes
into every backbone tower, key by key where name and shape match.

Training snapshots are the port's counterpart of the JAX package's orbax
snapshots (``save_checkpoint``/``restore_checkpoint``/``resolve_step_dir``):
one directory per epoch, ``<dir>/<epoch>/state.pt`` (a ``torch.save`` of
the optimizer step, the model's state_dict -- parameters and BatchNorm
buffers -- and the optimizer's state_dict), committed by a
``_CHECKPOINT_METADATA`` marker written last, with the newest ``keep``
committed directories kept.  ``<dir>/<epoch>`` addresses one snapshot,
``<dir>`` the newest.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import warnings
from typing import Any, Mapping, Optional

import numpy as np
import torch

_TOWER_RE = re.compile(r"^(fcn|fcn_depth)\.resnet\d+_8s\.")


def _flatten(tree: Any, prefix: tuple = ()) -> dict[tuple, Any]:
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def state_dict_from_flax(variables: Mapping[str, Any],
                         arch: str = "resnet34_8s") -> dict[str, torch.Tensor]:
    """Turn SEGNET flax variables ({'params', 'batch_stats'} of array-likes)
    into a state_dict for the port's SEGNET built with backbone `arch`."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables).items():
        coll, tower, rest = path[0], path[1], list(path[2:])
        arr = np.asarray(leaf, dtype=np.float32)
        m = re.match(r"^layer(\d)_(\d+)$", rest[0]) if rest else None
        if m:
            mod = f"layer{m.group(1)}.{m.group(2)}"
            rest = rest[1:]
        else:
            mod = ""
        sub = [s.replace("downsample_conv", "downsample.0")
               .replace("downsample_bn", "downsample.1") for s in rest[:-1]]
        leaf_name = rest[-1]
        prefix = ".".join(p for p in ([tower, arch, mod] + sub) if p)
        if coll == "batch_stats":
            name = {"mean": "running_mean", "var": "running_var"}[leaf_name]
            out[f"{prefix}.{name}"] = torch.from_numpy(arr.copy())
            out[f"{prefix}.num_batches_tracked"] = torch.zeros(
                (), dtype=torch.long)
        elif leaf_name == "scale":
            out[f"{prefix}.weight"] = torch.from_numpy(arr.copy())
        elif (leaf_name == "kernel" and sub
              and sub[-1].startswith("dec_tconv")):
            # flax ConvTranspose [kh,kw,in,out], applied unflipped ->
            # torch ConvTranspose2d [in,out,kh,kw], applied flipped
            w = arr[::-1, ::-1].transpose(2, 3, 0, 1)
            out[f"{prefix}.weight"] = torch.from_numpy(
                np.ascontiguousarray(w))
        elif leaf_name == "kernel":
            # [kh,kw,in,out] -> [out,in,kh,kw]
            w = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            out[f"{prefix}.weight"] = torch.from_numpy(
                np.ascontiguousarray(w))
        else:  # bias
            out[f"{prefix}.{leaf_name}"] = torch.from_numpy(arr.copy())
    return out


def normalize_torch_keys(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """Strip DataParallel 'module.' prefixes and re-root legacy
    'decoder.features.' keys (SEG.py:141-152); unwrap {'model': ...}
    (tools/train_net.py:115-117)."""
    if "model" in state_dict and isinstance(state_dict["model"], Mapping):
        state_dict = state_dict["model"]
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[7:]
        if "decoder.features." in k:
            k = "decoder." + k.split("decoder.features.", 1)[1]
        out[k] = v
    return out


def _looks_like_torchvision(state_dict: Mapping[str, Any]) -> bool:
    """A raw torchvision resnet dict has a bare trunk and no tower prefix."""
    return ("conv1.weight" in state_dict
            and not any(_TOWER_RE.match(k) for k in state_dict))


def convert_imagenet_checkpoint(state_dict: Mapping[str, Any],
                                expected: Mapping[str, torch.Tensor]
                                ) -> dict[str, torch.Tensor]:
    """`expected` (a SEGNET's init state_dict) with a raw torchvision
    resnet18/34/50 ImageNet state_dict put into every backbone tower,
    where name and shape match: the trunk (conv1, bn1, layer1..4) loads,
    the torchvision `fc` (a Linear) never matches the 1x1 scoring conv,
    and the 6-channel conv1 of early fusion is skipped by its shape.
    BatchNorm's `num_batches_tracked` keeps its init value.  Raises when
    nothing matched."""
    state_dict = normalize_torch_keys(state_dict)
    towers = sorted({m.group(0) for m in map(_TOWER_RE.match, expected)
                     if m})
    if not towers:
        raise KeyError("expected state_dict holds no backbone towers")
    out = dict(expected)
    loaded, skipped = 0, []
    for key, value in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        value = torch.as_tensor(value)
        for tower in towers:
            full = tower + key
            init = expected.get(full)
            if init is None or tuple(init.shape) != tuple(value.shape):
                skipped.append(full)
                continue
            out[full] = value.to(init.dtype).clone()
            loaded += 1
    if loaded == 0:
        raise KeyError("no ImageNet parameters matched the model "
                       f"(first skips: {skipped[:5]})")
    return out


def _overlay(given: Mapping[str, torch.Tensor],
             expected: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """`expected` with `given`'s tensors put over it, by the lenient partial
    load of the module docstring."""
    out: dict[str, torch.Tensor] = {}
    missing = []
    for key, init in expected.items():
        got = given.get(key)
        if got is None:
            if not key.endswith("num_batches_tracked"):
                missing.append(key)
            out[key] = init
        elif tuple(got.shape) != tuple(init.shape):
            warnings.warn(f"checkpoint shape mismatch at {key}: "
                          f"{tuple(got.shape)} vs expected "
                          f"{tuple(init.shape)}; keeping init")
            out[key] = init
        else:
            out[key] = got.to(init.dtype)
    if missing:
        raise KeyError(f"checkpoint is missing {len(missing)} expected "
                       f"parameters, e.g. {missing[:5]}")
    extra = [k for k in given if k not in expected and _TOWER_RE.match(k)]
    if extra:
        warnings.warn(f"checkpoint has {len(extra)} unused backbone keys, "
                      f"e.g. {extra[:3]}")
    return out


def load_state_dict_file(path: str | os.PathLike,
                         expected: Mapping[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
    """`expected` (a model's init state_dict) with the tensors of a `.pth`
    file put over it: a reference-layout file by the lenient partial load
    of the module docstring, a raw torchvision ImageNet resnet by
    convert_imagenet_checkpoint.  The file is read on the CPU."""
    given = normalize_torch_keys(
        torch.load(path, map_location="cpu", weights_only=True))
    if _looks_like_torchvision(given):
        return convert_imagenet_checkpoint(given, expected)
    return _overlay(given, expected)


# ---------------------------------------------------------------------------
# training snapshots
# ---------------------------------------------------------------------------

_MARKER = "_CHECKPOINT_METADATA"
_STATE_FILE = "state.pt"


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit() and os.path.exists(
                      os.path.join(directory, d, _MARKER)))


def save_checkpoint(directory: str | os.PathLike, step: int,
                    payload: Mapping[str, Any], keep: int = 16) -> str:
    """Write `payload` (engine.train.TrainState.state_dict(): optimizer
    step, model state_dict, optimizer state_dict) as ``<dir>/<step>``,
    then keep the newest `keep` snapshots.
    Returns the snapshot's directory."""
    directory = os.path.abspath(os.fspath(directory))
    final = os.path.join(directory, str(int(step)))
    tmp = final + f".tmp{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(dict(payload), os.path.join(tmp, _STATE_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    with open(os.path.join(final, _MARKER), "w") as fh:
        json.dump({"step": int(step)}, fh)
    for old in _committed_steps(directory)[:-max(int(keep), 1)]:
        shutil.rmtree(os.path.join(directory, str(old)), ignore_errors=True)
    return final


def resolve_step_dir(directory: str | os.PathLike
                     ) -> tuple[str, Optional[int]]:
    """Split a snapshot directory ``<dir>/N`` into (<dir>, N).  A
    digit-named directory is a snapshot only when it carries the commit
    marker; otherwise (a run named "16", or one with no snapshot yet) it
    stays the snapshots' directory."""
    directory = os.path.abspath(os.fspath(directory))
    base = os.path.basename(os.path.normpath(directory))
    if base.isdigit() and os.path.exists(os.path.join(directory, _MARKER)):
        return os.path.dirname(os.path.normpath(directory)), int(base)
    return directory, None


def restore_checkpoint(directory: str | os.PathLike,
                       step: Optional[int] = None
                       ) -> tuple[dict[str, Any], int]:
    """(payload, step) of the newest snapshot under `directory`, or of
    `step`; `directory` may itself be a snapshot ``<dir>/N``.  Tensors are
    read onto the CPU."""
    directory = os.path.abspath(os.fspath(directory))
    if step is None:
        directory, step = resolve_step_dir(directory)
    steps = _committed_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {directory}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(f"no checkpoint {step} under {directory} "
                                f"(found {steps})")
    payload = torch.load(os.path.join(directory, str(step), _STATE_FILE),
                         map_location="cpu", weights_only=True)
    return payload, int(step)


def load_snapshot_model(directory: str | os.PathLike,
                        expected: Mapping[str, torch.Tensor]
                        ) -> tuple[dict[str, torch.Tensor], int]:
    """The model tensors of a training snapshot put over `expected` (the
    network's init state_dict), and the snapshot's step."""
    payload, step = restore_checkpoint(directory)
    return _overlay(payload["model"], expected), step
