"""Print object-count statistics for a dataset (the port of the JAX
package's tools/dataset_statistics.py, parity with the reference
tools/dataset_statistics.py).

Reads labels only (INPUT COLOR) through data.get_dataset; the OCID and OSD
readers need numpy, zlib and g++ only.  No device is used.

Example:
  python -m unseenobjectclustering_torch.tools.dataset_statistics \\
      --dataset ocid_object_test --dataset_root data/OCID
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from unseenobjectclustering_torch.config import Config
from unseenobjectclustering_torch.data.factory import get_dataset


def main(argv: Optional[Sequence[str]] = None) -> np.ndarray:
    """Print the statistics; returns the per-image object counts."""
    parser = argparse.ArgumentParser(description="Dataset statistics")
    parser.add_argument("--dataset", dest="dataset_name", type=str,
                        default="tabletop_object_train")
    parser.add_argument("--dataset_root", type=str, default=None)
    parser.add_argument("--cfg", dest="cfg_file", type=str, default=None)
    parser.add_argument("--max_images", type=int, default=None)
    args = parser.parse_args(argv)

    cfg = (Config.from_yaml(args.cfg_file) if args.cfg_file
           else Config.default())
    cfg = cfg.replace(MODE="TEST", INPUT="COLOR")  # labels only
    dataset = get_dataset(args.dataset_name, cfg, path=args.dataset_root)

    n = len(dataset) if args.max_images is None else min(len(dataset),
                                                         args.max_images)
    counts = np.array([int(dataset[i]["label"].max()) for i in range(n)])
    print(f"{dataset.name}: {n} images")
    print(f"objects/image: mean {counts.mean():.2f}, median "
          f"{np.median(counts):.1f}, min {counts.min()}, max {counts.max()}")
    for k, c in enumerate(np.bincount(counts)):
        if c:
            print(f"  {k} objects: {c} images")
    return counts


if __name__ == "__main__":
    main()
