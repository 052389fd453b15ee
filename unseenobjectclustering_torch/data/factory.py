"""Dataset registry (parity with lib/datasets/factory.py:14-39 and the JAX
package's data/factory.py): the TableTop splits, OSD and OCID test sets and
the procedural synthetic_tabletop_{train,test}."""

from __future__ import annotations

from typing import Callable, Optional

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data.datasets import (OCIDObject, OSDObject,
                                                        TableTopObject)
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)

DATASETS: dict[str, Callable] = {}


def _register(name: str, ctor: Callable, image_set: str) -> None:
    DATASETS[name] = lambda cfg, path=None: ctor(image_set, cfg, path=path)


for _split in ("train", "test", "all"):
    _register(f"tabletop_object_{_split}", TableTopObject, _split)
_register("osd_object_test", OSDObject, "test")
_register("ocid_object_test", OCIDObject, "test")
for _split in ("train", "test"):
    _register(f"synthetic_tabletop_{_split}", SyntheticTabletopDataset,
              _split)


def get_dataset(name: str, cfg: Config, path: Optional[str] = None):
    """Build a dataset by its reference-compatible registry name."""
    if name not in DATASETS:
        raise KeyError(
            f"unknown dataset {name!r}; available: {sorted(DATASETS)}")
    return DATASETS[name](cfg, path=path)
