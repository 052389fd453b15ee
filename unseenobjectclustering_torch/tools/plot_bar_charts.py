"""Bar charts comparing methods on OSD / OCID (the port of the JAX
package's tools/plot_bar_charts.py, parity with the reference
tools/plot_bar_charts.py:8-56).

The baselines are the published comparison set; --ours F_overlap
F_boundary pct75 appends the port's measured results.  matplotlib is
imported only to draw (the GPU machine has none).

Example:
  python -m unseenobjectclustering_torch.tools.plot_bar_charts \\
      --dataset ocid --ours 85.1 74.0 80.2 --out bars.png
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

# Published OSD comparison (reference tools/plot_bar_charts.py:28-30):
# method -> (F-overlap, F-boundary, %75)
OSD_BASELINES = {
    "MRCNN-Depth": (80.6, 66.0, 71.0),
    "UOIS-2D": (79.9, 65.6, 70.9),
    "UOIS-3D": (83.3, 67.3, 73.8),
    "UCN (ref)": (87.4, 69.4, 83.2),
}
# OCID comparison (reference tools/plot_bar_charts.py:11-26, commented set)
OCID_BASELINES = {
    "MRCNN": (84.7, 55.6, 72.9),
    "UCN (ref)": (88.5, 78.8, 82.2),
    "UCN refined (ref)": (87.8, 82.3, 85.6),
}
OURS = "UCN-torch (ours)"
METRICS = ("F-overlap", "F-boundary", "%75")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Method comparison charts")
    parser.add_argument("--dataset", choices=("osd", "ocid"), default="osd")
    parser.add_argument("--ours", type=float, nargs=3, default=None,
                        metavar=("F", "FB", "PCT75"))
    parser.add_argument("--out", type=str, default="bars.png")
    return parser.parse_args(argv)


def chart_data(dataset: str, ours: Optional[Sequence[float]] = None
               ) -> dict[str, tuple]:
    """method -> (F-overlap, F-boundary, %75): the dataset's baselines,
    then ours when given."""
    data = dict(OSD_BASELINES if dataset == "osd" else OCID_BASELINES)
    if ours:
        data[OURS] = tuple(ours)
    return data


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Draw the chart; returns the path written."""
    args = parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = chart_data(args.dataset, args.ours)
    methods = list(data)
    x = np.arange(len(METRICS))
    width = 0.8 / len(methods)

    fig, ax = plt.subplots(figsize=(9, 5))
    for i, m in enumerate(methods):
        ax.bar(x + i * width, data[m], width, label=m)
    ax.set_xticks(x + width * (len(methods) - 1) / 2)
    ax.set_xticklabels(METRICS)
    ax.set_ylim(0, 100)
    ax.legend()
    ax.set_title(f"{args.dataset.upper()} comparison")
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
