"""Checkpoints: reference-layout ``.pth`` files, and the weight carry from
flax variables.

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
BatchNorm2d(momentum=0.1, eps=1e-5), the port's default.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Mapping

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


def load_state_dict_file(path: str | os.PathLike,
                         expected: Mapping[str, torch.Tensor]
                         ) -> dict[str, torch.Tensor]:
    """`expected` (a model's init state_dict) with the tensors of a
    reference-layout `.pth` file put over it, by the lenient partial load
    of the module docstring.  The file is read on the CPU."""
    given = normalize_torch_keys(
        torch.load(path, map_location="cpu", weights_only=True))
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
