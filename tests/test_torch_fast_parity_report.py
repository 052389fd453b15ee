"""The port's fast-vs-parity report (python -m unseenobjectclustering_torch.
tools.fast_parity_report) on the CPU against the JAX package's
tools/fast_parity_report.py.

Both tools build their two Segmentors from the .pth file of
tests/test_torch_serving.py (ResNet-18, flax init carried by
export_torch_state_dict, ``first_index`` pinned on both packages'
Segmentors) and segment the same three held-out rendered scenes at 60x80.
The JAX side clusters through its plain XLA reference (USE_PALLAS off), the
port through its kernel wrappers' plain versions.

Tolerance: none for parity -- the averaged metric dicts are equal.  The
fast mode runs bfloat16, another float type on each side, so its averages
and the agreement are only held to be finite and in [0, 1].
"""

import os
import sys

import numpy as np
import pytest
import torch

from test_torch_serving import NET, REPO, files, pinned  # noqa: F401
from unseenobjectclustering_torch.engine import builder as tbuilder
from unseenobjectclustering_torch.tools import fast_parity_report
from unseenobjectclustering_tpu.engine import builder as jbuilder
from unseenobjectclustering_tpu.engine import evaluate as jevaluate

torch.set_num_threads(1)

H, W, SCENES = 60, 80, 3


def report_args(files, cfg_file, out):
    return ["--pretrained", files.main, "--cfg", cfg_file, "--network", NET,
            "--scenes", str(SCENES), "--height", str(H), "--width", str(W),
            "--out", str(out)]


@pytest.fixture(scope="module")
def reports(files, tmp_path_factory):
    """(the port's returned report, the JAX tool's averaged metrics per
    mode, both Markdown files)."""
    out = tmp_path_factory.mktemp("reports")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbuilder, "build_segmentor",
                   pinned(tbuilder.build_segmentor))
        port = fast_parity_report.main(
            report_args(files, files.port_cfg, out / "port.md")
            + ["--device", "cpu"])

        mp.setattr(jbuilder, "build_segmentor",
                   pinned(jbuilder.build_segmentor))
        averaged = []
        real = jevaluate.average_metrics

        def record(rows):
            averaged.append(real(rows))
            return averaged[-1]

        mp.setattr(jevaluate, "average_metrics", record)
        mp.syspath_prepend(os.path.join(REPO, "tools"))
        mp.delitem(sys.modules, "fast_parity_report", raising=False)
        import fast_parity_report as jax_report

        mp.setattr(sys, "argv", ["fast_parity_report.py"] + report_args(
            files, files.jax_cfg, out / "jax.md"))
        jax_report.main()
    return port, dict(zip(("parity", "fast"), averaged)), out


def test_parity_equals_the_jax_report(reports):
    port, jax_avg, _ = reports
    assert port["average"]["parity"] == jax_avg["parity"]
    assert port["average"]["parity"]["obj_detected"] > 0
    assert len(port["frames"]["parity"]) == SCENES
    assert all(row["obj_detected"] >= 1 for row in port["frames"]["parity"])


def test_fast_and_agreement_are_scores(reports):
    port, _, _ = reports
    assert len(port["agreement"]) == SCENES
    for v in list(port["agreement"]) + [
            port["average"]["fast"][k] for k in fast_parity_report.KEYS]:
        assert np.isfinite(v) and 0.0 <= v <= 1.0


def test_markdown_table_matches_the_jax_layout(reports):
    _, _, out = reports
    got = (out / "port.md").read_text().splitlines()
    want = (out / "jax.md").read_text().splitlines()
    # the same header and rows; the checkpoint line names the same file
    assert len(got) == len(want)
    assert got[4:6] == want[4:6]
    for g, w in zip(got[6:9], want[6:9]):
        assert g.split("|")[1:3] == w.split("|")[1:3]


def test_default_out_lies_outside_docs():
    args = fast_parity_report.parse_args(["--pretrained", "x"])
    assert not os.path.abspath(args.out).startswith(
        os.path.join(os.path.abspath(os.curdir), "docs"))
    assert args.out.split(os.sep)[0] == "output"


def test_report_without_device_needs_a_card(files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fast_parity_report.main(report_args(files, files.port_cfg,
                                            tmp_path / "r.md"))
