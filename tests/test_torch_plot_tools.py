"""The port's plot and dataset-viewing tools against the JAX repo's
tools/plot_bar_charts.py, tools/plot_epochs.py and
tools/view_tabletop_data.py on the CPU.

Each JAX tool is loaded from tools/ and run through its main() with
sys.argv set; argparse's parse_args is spied on for its flags.  The
published tables and the parsed flags must be equal, and both tools must
write their figures.  view_tabletop_data's grids are held on the arrays
handed to segmentation_grid (image, depth and labels, equal exactly) on
the committed TableTop fixture tree.
"""

import argparse
import json
import os
import sys

import numpy as np
import pytest

from unseenobjectclustering_torch.tools import (plot_bar_charts,
                                                plot_epochs,
                                                view_tabletop_data)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLETOP = os.path.join(REPO, "tests", "torch_fixtures", "tabletop")
PNG = b"\x89PNG\r\n\x1a\n"


def jax_tool(monkeypatch, name):
    """The JAX repo's tools/<name>.py as a module."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    monkeypatch.delitem(sys.modules, name, raising=False)
    return __import__(name)


def run_jax_tool(monkeypatch, module, argv):
    """module.main() with sys.argv set; returns the parsed flags."""
    seen = []
    parse = argparse.ArgumentParser.parse_args

    def spy(self, *a, **k):
        seen.append(parse(self, *a, **k))
        return seen[-1]

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", spy)
        m.setattr(sys, "argv", [module.__file__] + argv)
        module.main()
    return vars(seen[0])


def is_png(path):
    with open(path, "rb") as f:
        return f.read(8) == PNG


@pytest.mark.parametrize("argv", [[], ["--dataset", "ocid"],
                                  ["--dataset", "osd", "--ours", "85.1",
                                   "70.2", "80.3"]])
def test_bar_charts_match_the_jax_tool(monkeypatch, tmp_path, argv):
    jtool = jax_tool(monkeypatch, "plot_bar_charts")
    assert plot_bar_charts.OSD_BASELINES == jtool.OSD_BASELINES
    assert plot_bar_charts.OCID_BASELINES == jtool.OCID_BASELINES
    want = run_jax_tool(monkeypatch, jtool,
                        argv + ["--out", str(tmp_path / "jax.png")])
    got = vars(plot_bar_charts.parse_args(
        argv + ["--out", str(tmp_path / "jax.png")]))
    assert got == want
    out = plot_bar_charts.main(argv + ["--out", str(tmp_path / "port.png")])
    assert is_png(tmp_path / "jax.png") and is_png(out)
    data = plot_bar_charts.chart_data(got["dataset"], got["ours"])
    base = (jtool.OSD_BASELINES if got["dataset"] == "osd"
            else jtool.OCID_BASELINES)
    assert list(data)[:len(base)] == list(base)
    if got["ours"]:
        assert data[plot_bar_charts.OURS] == tuple(got["ours"])


@pytest.mark.parametrize("layout", ["none", "dense", "sparse"])
def test_epoch_curves_match_the_jax_tool(monkeypatch, tmp_path, layout):
    jtool = jax_tool(monkeypatch, "plot_epochs")
    assert plot_epochs.PUBLISHED_EPOCH16 == jtool.PUBLISHED_EPOCH16
    assert plot_epochs.METRICS == jtool.METRICS
    argv = []
    if layout != "none":
        rows = [[0.5 + 0.01 * e, 0.4, 0.6] for e in range(4)]
        results = {"rgbd_add": rows if layout == "dense" else
                   {"epochs": [2, 4, 8, 16], "values": rows}}
        path = tmp_path / "curves.json"
        path.write_text(json.dumps(results))
        argv = ["--results", str(path)]
        xs, got_rows = plot_epochs.curves(results)["rgbd_add"]
        assert got_rows == rows
        assert xs == ([1, 2, 3, 4] if layout == "dense" else [2, 4, 8, 16])
    want = run_jax_tool(monkeypatch, jtool,
                        argv + ["--out", str(tmp_path / "jax.png")])
    assert vars(plot_epochs.parse_args(
        argv + ["--out", str(tmp_path / "jax.png")])) == want
    out = plot_epochs.main(argv + ["--out", str(tmp_path / "port.png")])
    assert is_png(tmp_path / "jax.png") and is_png(out)


def test_view_tabletop_data_matches_the_jax_tool(monkeypatch, tmp_path):
    """Both tools on the fixture tree's training split: the arrays each
    hands to segmentation_grid are equal, and each sample's grid is
    written as sample_%05d.png."""
    from unseenobjectclustering_torch.utils import visualization as tvis
    from unseenobjectclustering_tpu.utils import visualization as jvis

    def spying(module, calls):
        real = module.segmentation_grid

        def grid(*args):
            calls.append(args)
            return real(*args)

        monkeypatch.setattr(module, "segmentation_grid", grid)

    jtool = jax_tool(monkeypatch, "view_tabletop_data")
    jcalls, tcalls = [], []
    spying(jvis, jcalls)
    spying(tvis, tcalls)
    argv = ["--dataset_root", TABLETOP, "--num", "2"]
    want = run_jax_tool(monkeypatch, jtool,
                        argv + ["--outdir", str(tmp_path / "jax")])
    assert vars(view_tabletop_data.parse_args(
        argv + ["--outdir", str(tmp_path / "jax")])) == want
    written = view_tabletop_data.main(argv + ["--outdir",
                                              str(tmp_path / "port")])
    assert written == [str(tmp_path / "port" / f"sample_{i:05d}.png")
                       for i in range(2)]
    assert all(is_png(p) for p in written)
    assert len(jcalls) == len(tcalls) == 2
    for (jim, jxyz, jfeat, jlab), (tim, txyz, tfeat, tlab) in zip(jcalls,
                                                                  tcalls):
        assert jfeat is None and tfeat is None
        assert tim.dtype == jim.dtype == np.uint8
        np.testing.assert_array_equal(tim, jim)
        np.testing.assert_array_equal(txyz, jxyz)
        np.testing.assert_array_equal(tlab, jlab)
        assert tlab.min() >= 0 and tlab.max() > 0
