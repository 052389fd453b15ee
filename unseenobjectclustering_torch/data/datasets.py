"""What the port's datasets share: ``process_label`` and the dataset base.

A copy of the parts of ``unseenobjectclustering_tpu/data/datasets.py``
that the synthetic renderer uses (reference
lib/datasets/tabletop_object.py, imdb.py).  TableTopObject, OCID and OSD
wait for the data slice.
"""

from __future__ import annotations

import numpy as np

from unseenobjectclustering_torch.config import Config


def process_label(foreground_labels: np.ndarray) -> np.ndarray:
    """Remap arbitrary ids to {0..K-1} preserving order
    (tabletop_object.py:158-172)."""
    unique = np.unique(foreground_labels)
    mapped = np.searchsorted(unique, foreground_labels)
    return mapped.astype(foreground_labels.dtype)


class _DatasetBase:
    """Common surface: len(), name, the loader's epoch (imdb.py)."""

    _name = "dataset"

    def __init__(self, cfg: Config, base_seed: int = 3):
        self.cfg = cfg
        self.base_seed = base_seed
        self._epoch = 0

    @property
    def name(self) -> str:
        return self._name

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch (the loader calls this; raw scenes do not depend
        on it)."""
        self._epoch = int(epoch)

    def __len__(self) -> int:
        return self._size
