"""Per-epoch OCID evaluation curves for the five input recipes (the port
of the JAX package's tools/plot_epochs.py, parity with the reference
tools/plot_epochs.py:13-76).

The published epoch-16 values are drawn as reference lines; --results
overlays per-epoch numbers from a JSON file, either dense
{"<variant>": [[F, F_boundary, pct75], ...one row per epoch]} or sparse
{"<variant>": {"epochs": [...], "values": [[F, F_boundary, pct75], ...]}},
as tools/test_net runs give them.  matplotlib is imported only to draw
(the GPU machine has none).

Example:
  python -m unseenobjectclustering_torch.tools.plot_epochs \\
      --results curves.json --out epochs.png
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

# Published OCID values at epoch 16 per variant: (Objects-F, Boundary-F,
# %75) (reference tools/plot_epochs.py:13-64 / SURVEY §6).
PUBLISHED_EPOCH16 = {
    "rgb": (0.594, 0.365, 0.480),
    "depth": (0.864, 0.756, 0.754),
    "rgbd_early": (0.828, 0.672, 0.735),
    "rgbd_add": (0.885, 0.788, 0.822),
    "rgbd_cat": (0.829, 0.685, 0.683),
}

METRICS = ("Objects F-measure", "Boundary F-measure",
           "obj_detected_075_percentage")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Plot per-epoch curves")
    parser.add_argument("--results", type=str, default=None,
                        help="JSON: {variant: [[F, Fb, pct75] per epoch]}")
    parser.add_argument("--out", type=str, default="epochs.png")
    return parser.parse_args(argv)


def curves(results: dict) -> dict[str, tuple[list, list]]:
    """variant -> (epochs, rows of [F, Fb, pct75]) from the dense or the
    sparse layout."""
    out = {}
    for variant, curve in results.items():
        if isinstance(curve, dict):
            out[variant] = (list(curve["epochs"]), curve["values"])
        else:
            out[variant] = (list(range(1, len(curve) + 1)), curve)
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Draw the curves; returns the path written."""
    args = parse_args(argv)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    results = {}
    if args.results:
        with open(args.results) as f:
            results = json.load(f)

    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    for mi, metric in enumerate(METRICS):
        ax = axes[mi]
        for variant, (xs, rows) in curves(results).items():
            ax.plot(xs, [row[mi] for row in rows], marker="o",
                    label=f"{variant} (ours)")
        for variant, vals in PUBLISHED_EPOCH16.items():
            ax.axhline(vals[mi], linestyle="--", alpha=0.4)
            ax.annotate(f"{variant} ref", (1, vals[mi]), fontsize=7,
                        alpha=0.6)
        ax.set_title(metric)
        ax.set_xlabel("epoch")
        ax.grid(alpha=0.3)
        if mi == 0:
            ax.legend(fontsize=8)
    fig.suptitle("OCID evaluation per training epoch")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    plt.close(fig)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
