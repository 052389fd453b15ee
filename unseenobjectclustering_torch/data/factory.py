"""Dataset registry (parity with lib/datasets/factory.py:14-39).

The port registers the procedural ``synthetic_tabletop_{train,test}``
datasets.  The reference's TableTop, OCID and OSD names are known but
raise: their loaders wait for the data slice.
"""

from __future__ import annotations

from typing import Callable, Optional

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data.synthetic import (
    SyntheticTabletopDataset)

DATASETS: dict[str, Callable] = {
    f"synthetic_tabletop_{split}":
        (lambda cfg, path=None, _s=split:
         SyntheticTabletopDataset(_s, cfg, path=path))
    for split in ("train", "test")}

NOT_PORTED = tuple([f"tabletop_object_{s}" for s in ("train", "test", "all")]
                   + ["osd_object_test", "ocid_object_test"])


def get_dataset(name: str, cfg: Config, path: Optional[str] = None):
    """Build a dataset by its reference-compatible registry name."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"{name!r} is not in the port yet: the TableTop/OCID/OSD "
            "loaders wait for the data slice; the port trains on "
            "synthetic_tabletop_train")
    if name not in DATASETS:
        raise KeyError(
            f"unknown dataset {name!r}; available: {sorted(DATASETS)}")
    return DATASETS[name](cfg, path=path)
