"""The port's repo tools on the CPU against the JAX package's:
tools.probe_seed_precision (the float64 audit of the seeding routes) and
tools.dataset_statistics.

The probe's replay is held to the JAX tool's replay_audit on the same
seeds and picks (tolerance 0: the same divergence count and the same
float64 gap), its plain route must PASS, and a planted wrong route (the
plain route's picks on inputs rounded to bfloat16) must FAIL with exit
code 1.  dataset_statistics must print the JAX tool's lines on a 4-scene
60x80 OCID tree written by the port's tools/make_real_fixtures.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch.data import datasets as tdatasets
from unseenobjectclustering_torch.ops.mean_shift import select_smart_seeds
from unseenobjectclustering_torch.tools import (dataset_statistics,
                                                make_real_fixtures,
                                                probe_seed_precision as probe)
from unseenobjectclustering_tpu.data import datasets as jdatasets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 60, 80


def jax_tool(monkeypatch, name):
    """The JAX package's tools/<name>.py as a module (its import-time
    compile-cache settings are not applied to this process)."""
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.delitem(sys.modules, name, raising=False)
    module = __import__(name)
    monkeypatch.undo()
    return module


def unit_vectors(n, d=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def plain_picks(x, m, first=probe.FIRST):
    return select_smart_seeds(torch.from_numpy(x), m, metric="cosine",
                              first_index=first)[1].numpy()


def bf16_picks(x, m, first):
    return select_smart_seeds(x.bfloat16().float(), m, metric="cosine",
                              first_index=first)[1]


@pytest.mark.parametrize("swaps", [(), (7, 30, 61)])
def test_replay_audit_equals_the_jax_tool(monkeypatch, swaps):
    jax_probe = jax_tool(monkeypatch, "probe_seed_precision")
    assert jax_probe.TIE_GAP == probe.TIE_GAP
    x = unit_vectors(2048, seed=3)
    m = 64
    idx = plain_picks(x, m)
    for k in swaps:  # a pick no near-tie explains: another route's error
        idx[k] = (idx[k] + 977) % len(x)
    got = probe.replay_audit(x, idx, probe.FIRST, m)
    want = jax_probe.replay_audit(x, idx, probe.FIRST, m)
    assert got == want
    if swaps:
        assert got[0] >= len(swaps) and got[1] >= probe.TIE_GAP
    else:
        assert got[1] < probe.TIE_GAP


def test_plain_route_passes_and_main_exits_0():
    res = probe.main(["--n", "4096", "--device", "cpu"])
    assert res["ok"] and list(res["routes"]) == ["plain"]
    assert res["routes"]["plain"]["pass"]
    assert (res["n"], res["d"], res["m"]) == (4096, 64, 100)
    out = subprocess.run(
        [sys.executable, "-m",
         "unseenobjectclustering_torch.tools.probe_seed_precision", "--n",
         "4096", "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "plain   PASS" in out.stdout


def test_main_audits_a_callers_embeddings():
    x = unit_vectors(3000, seed=9)
    res = probe.main(["--device", "cpu", "--m", "40"], x=x)
    assert (res["n"], res["d"], res["m"]) == (3000, 64, 40)
    n_div, worst = probe.replay_audit(x, plain_picks(x, 40), probe.FIRST, 40)
    assert res["routes"]["plain"] == {"divergences": n_div,
                                      "worst_gap": worst, "pass": True}


def test_wrong_route_fails(monkeypatch, capsys):
    real = probe.routes
    monkeypatch.setattr(probe, "routes", lambda device: dict(
        real(device), bf16=bf16_picks))
    res = probe.main(["--n", "4096", "--device", "cpu"])
    assert not res["ok"] and res["routes"]["plain"]["pass"]
    assert res["routes"]["bf16"]["worst_gap"] >= probe.TIE_GAP
    assert "bf16    FAIL" in capsys.readouterr().out


def test_wrong_route_exits_1():
    """The module run as a program, with its plain route's seeding fed
    bfloat16-rounded inputs: FAIL and exit code 1."""
    code = """
import runpy, sys
from unseenobjectclustering_torch.ops import mean_shift
real = mean_shift.select_smart_seeds
mean_shift.select_smart_seeds = lambda x, *a, **k: real(
    x.bfloat16().float(), *a, **k)
sys.argv = ["probe", "--n", "4096", "--device", "cpu"]
runpy.run_module("unseenobjectclustering_torch.tools.probe_seed_precision",
                 run_name="__main__")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 1, (out.stdout, out.stderr)
    assert "plain   FAIL" in out.stdout


def test_probe_without_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.main(["--n", "256"])


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixtures")
    make_real_fixtures.main(["--root", str(root), "--num", "4", "--height",
                             str(H), "--width", str(W), "--dataset", "ocid"])
    return root


def test_dataset_statistics_prints_the_jax_lines(tree, monkeypatch, capsys):
    for cls in (tdatasets.OCIDObject, jdatasets.OCIDObject):
        monkeypatch.setattr(cls, "_height", H)
        monkeypatch.setattr(cls, "_width", W)
    monkeypatch.chdir(tree)
    args = ["--dataset", "ocid_object_test", "--dataset_root", "OCID"]
    counts = dataset_statistics.main(args)
    got = capsys.readouterr().out.splitlines()
    monkeypatch.syspath_prepend(os.path.join(REPO, "tools"))
    monkeypatch.delitem(sys.modules, "dataset_statistics", raising=False)
    import dataset_statistics as jax_statistics

    monkeypatch.setattr(sys, "argv", ["dataset_statistics.py"] + args)
    jax_statistics.main()
    want = capsys.readouterr().out.splitlines()
    assert got == want
    assert got[0] == "ocid_object_test: 4 images"
    assert len(counts) == 4 and counts.min() >= 1


def test_recipe_is_the_documented_one():
    """The stage-1 recipe's config (docs/synthetic_experiment.md: Adam 2e-4
    from scratch, batch 16, 240x320, 6000 scenes) and its script parse."""
    from unseenobjectclustering_torch.config import Config

    cfg = Config.from_yaml(os.path.join(
        REPO, "unseenobjectclustering_torch", "cfgs",
        "synthetic_240x320_rgbd_add.yml"))
    train = cfg.TRAIN
    assert (cfg.INPUT, train.FUSION_TYPE, train.EMBEDDING_METRIC) == (
        "RGBD", "add", "cosine")
    assert (train.LEARNING_RATE, train.IMS_PER_BATCH, train.SYN_HEIGHT,
            train.SYN_WIDTH, train.SYNNUM) == (2e-4, 16, 240, 320, 6000)
    assert not train.EMBEDDING_PRETRAIN
    script = os.path.join(REPO, "unseenobjectclustering_torch", "tools",
                          "synthetic_recipe.sh")
    out = subprocess.run(["bash", "-n", script], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    text = open(script).read()
    for flag in ("--bf16", "--device-resident", "--solver adam",
                 "synthetic_240x320_rgbd_add.yml", "fast_parity_report"):
        assert flag in text
