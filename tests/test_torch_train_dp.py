"""Data-parallel training of the port on the CPU, two gloo processes
(tests/torch_ranks.py): the global-batch BatchNorm, the global-batch
embedding loss, the train step and tools.train_net, each held against one
process on the whole batch and against the JAX package.

Each check also runs with a planted fault, which must fail it:
per-replica BatchNorm statistics, per-rank loss scalars, and each rank
drawing the augmentation of its own rows only.

Tolerances are tests/test_torch_train.py's: parameters after SGD steps
within atol 1e-6 + 2e-2 of the lr, BatchNorm running statistics within
atol 1e-4 + rtol 1e-4; losses within rtol 1e-5 of one process (2e-4 of
JAX, whose convolutions sum in another order); the BatchNorm output and
input gradient within 1e-5 of their scale, the loss gradient within 1e-4.
The BatchNorm's parameter gradients sum dy * x_hat over the batch: within
1e-5 of their scale, and 1e-3 for inputs whose mean is 200 times their
spread, where float32 x_hat itself carries 1.2e-5 of relative rounding.
In float64 the two-process step equals one process's within 1e-10.
Through tools.train_net (48x64 scenes, depth tower on the backprojected
depth) the float32 gradient itself moves by up to 1e-2 between summation
orders (tests/test_torch_train.py holds the float32 step's gradients to
float64 at 4e-2), so there the parameter updates of the two runs agree
within 4e-2 relative L2, as chip_smoke.py's STEP_TOL holds the card to the
CPU, and the statistics within atol 1e-4 + rtol 1e-4.
"""

import os
import shutil
import subprocess
import sys
import types

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (ADAM_LR, LR, NET, assert_states_close, batches,
                              configs, cfg_dict, jax_state, port_state)
from test_torch_train_net import YML
from torch_ranks import run_ranks
from unseenobjectclustering_torch.engine import train as ttrain
from unseenobjectclustering_torch.models import losses as tl
from unseenobjectclustering_torch.models import resnet as tresnet
from unseenobjectclustering_torch.models import unets as tunets
from unseenobjectclustering_torch.parallel import Mesh
from unseenobjectclustering_torch.tools import render_dataset, train_net
from unseenobjectclustering_torch.utils import checkpoint as tck
from unseenobjectclustering_tpu.engine import train as jtrain
from unseenobjectclustering_tpu.models import losses as jl
from unseenobjectclustering_tpu.parallel import (make_mesh, replicate,
                                                 shard_batch)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_TOL = dict(atol=1e-4, rtol=1e-4)
BN_SHAPE = (4, 6, 5, 7)  # 2 + 2 frames
BN_OFFSETS = (0.5, 100.0)  # the second: mean 200x the spread
BN_GRAD_TOL = {0.5: 1e-5, 100.0: 1e-3}
LOSS_KW = dict(alpha=0.02, delta=0.5, lambda_intra=10.0, lambda_inter=10.0,
               max_k=8)


def bn_case(offset, seed=7):
    b, c, h, w = BN_SHAPE
    rng = np.random.RandomState(seed)
    x = (0.5 * rng.randn(b, c, h, w) + offset).astype(np.float32)
    g = rng.randn(b, c, h, w).astype(np.float32)
    bn = tresnet.BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(0.5 + rng.rand(c)))
        bn.bias.copy_(torch.from_numpy(0.1 * rng.randn(c)))
        bn.running_mean.copy_(torch.from_numpy(offset + rng.randn(c)))
        bn.running_var.copy_(torch.from_numpy(0.5 + rng.rand(c)))
    return {"x": torch.from_numpy(x), "g": torch.from_numpy(g),
            "state": bn.state_dict()}


def one_process_bn(case):
    bn = tresnet.BatchNorm2d(case["x"].shape[1])
    bn.load_state_dict(case["state"])
    bn.train()
    x = case["x"].clone().requires_grad_(True)
    y = bn(x)
    (y * case["g"]).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dweight=bn.weight.grad,
                dbias=bn.bias.grad, running_mean=bn.running_mean,
                running_var=bn.running_var)


def loss_case():
    """Rank 0: random unit embeddings, labels -1..3 (hard pixels).  Rank 1:
    every pixel at its cluster's centre (no hard pixel), labels 0..1.  So
    K = 4 and any_hard come from rank 0 alone."""
    rng = np.random.RandomState(11)
    e0 = rng.randn(2, 12, 16, 8).astype(np.float32)
    e0 /= np.linalg.norm(e0, axis=-1, keepdims=True)
    l0 = rng.randint(-1, 4, (2, 12, 16)).astype(np.int32)
    centres = rng.randn(2, 8).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=-1, keepdims=True)
    l1 = rng.randint(0, 2, (2, 12, 16)).astype(np.int32)
    e1 = centres[l1]
    return {"emb": [torch.from_numpy(e0), torch.from_numpy(e1)],
            "labels": [torch.from_numpy(l0), torch.from_numpy(l1)],
            "kw": LOSS_KW}


@pytest.fixture(scope="module")
def bn_loss(tmp_path_factory):
    cases = [bn_case(o) for o in BN_OFFSETS]
    loss = loss_case()
    ranks = run_ranks("batchnorm_and_loss", {"bn": cases, "loss": loss},
                      tmp_path_factory.mktemp("bn_loss"))
    return cases, loss, ranks


def gathered(ranks, run, key, i=None):
    """The ranks' rows of result `key` (of `run`, case `i`) put together."""
    parts = [r if run is None else r[run] if i is None else r[run][i]
             for r in ranks]
    return torch.cat([p[key] for p in parts])


def assert_bn_close(got, want, grad_tol=1e-5):
    for key in ("y", "dx", "dweight", "dbias"):
        scale = float(want[key].abs().max())
        tol = grad_tol if key in ("dweight", "dbias") else 1e-5
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   atol=tol * scale, err_msg=key)
    for key in ("running_mean", "running_var"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   err_msg=key, **STAT_TOL)


def rank_bn(ranks, run, i):
    """The ranks' BatchNorm results put together: rows concatenated,
    parameter gradients summed (the step's all-reduce), statistics from
    rank 0 (checked equal on rank 1)."""
    r0, r1 = (r[run][i] for r in ranks)
    for key in ("running_mean", "running_var"):
        assert torch.equal(r0[key], r1[key]), key
    return dict(y=gathered(ranks, run, "y", i),
                dx=gathered(ranks, run, "dx", i),
                dweight=r0["dweight"] + r1["dweight"],
                dbias=r0["dbias"] + r1["dbias"],
                running_mean=r0["running_mean"],
                running_var=r0["running_var"])


@pytest.mark.parametrize("i", range(len(BN_OFFSETS)),
                         ids=[f"offset{o:g}" for o in BN_OFFSETS])
def test_global_batchnorm_matches_one_process(bn_loss, i):
    """Forward, backward (input, weight and bias gradients) and the
    running statistics of 2 + 2 frames equal one process's on 4; with the
    mean 200 times the spread the float64 sums keep the variance."""
    cases, _, ranks = bn_loss
    assert_bn_close(rank_bn(ranks, "bn", i), one_process_bn(cases[i]),
                    BN_GRAD_TOL[BN_OFFSETS[i]])


def test_global_batchnorm_matches_flax(bn_loss):
    """Output and running statistics against flax's train-mode BatchNorm
    on the whole batch (momentum 0.9, biased variance)."""
    cases, _, ranks = bn_loss
    case = cases[0]
    state = case["state"]
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": state["weight"].numpy(),
                            "bias": state["bias"].numpy()},
                 "batch_stats": {"mean": state["running_mean"].numpy(),
                                 "var": state["running_var"].numpy()}}
    x_nhwc = jnp.asarray(case["x"].numpy().transpose(0, 2, 3, 1))
    jy, mutated = bn.apply(variables, x_nhwc, mutable=["batch_stats"])
    got = rank_bn(ranks, "bn", 0)
    np.testing.assert_allclose(got["y"].numpy().transpose(0, 2, 3, 1),
                               np.asarray(jy), atol=1e-5)
    for key, jkey in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(mutated["batch_stats"][jkey]),
            **STAT_TOL)


def test_per_replica_batchnorm_fails_the_check(bn_loss):
    """Planted fault: each rank's own statistics (no all-reduce)."""
    cases, _, ranks = bn_loss
    with pytest.raises(AssertionError):
        assert_bn_close(rank_bn(ranks, "bn_local", 0),
                        one_process_bn(cases[0]))


def test_batchnorm_outside_the_data_parallel_block_is_per_rank(bn_loss):
    """The mesh the train step passes is the one source of the rank and
    world: under the same process group but outside a data_parallel
    block, train-mode BatchNorm normalizes each rank's own rows (what the
    spatial route's ranks, which hold one frame's columns, must never
    reduce over), equal to one process on those rows alone."""
    cases, _, ranks = bn_loss
    for rank, r in enumerate(ranks):
        case = dict(cases[0], x=cases[0]["x"][2 * rank:2 * rank + 2],
                    g=cases[0]["g"][2 * rank:2 * rank + 2])
        want = one_process_bn(case)
        got = r["bn_outside"]
        for key in ("y", "dx", "running_mean", "running_var"):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       atol=1e-5, rtol=1e-5, err_msg=key)


def one_process_loss(case):
    e = torch.cat(case["emb"]).requires_grad_(True)
    out = tl.embedding_loss(e, torch.cat(case["labels"]), **case["kw"])
    out.loss.backward()
    return out, e.grad


def test_loss_shares_sum_to_the_global_batch_loss(bn_loss):
    """Ranks with different largest labels (3 and 1) and one rank without a
    hard pixel: the shares' sum is one process's loss on the whole batch
    and the JAX package's, each term too; each rank's gradient is its rows
    of the whole batch's."""
    _, case, ranks = bn_loss
    want, grad = one_process_loss(case)
    for key in ("loss", "intra", "inter"):
        total = sum(float(r["loss"][key]) for r in ranks)
        np.testing.assert_allclose(total, float(getattr(want, key).detach()),
                                   rtol=1e-5, err_msg=key)
    assert float(ranks[1]["loss"]["intra"]) > 0  # K and B are global
    got = gathered(ranks, "loss", "grad")
    scale = float(grad.abs().max())
    np.testing.assert_allclose(got.numpy(), grad.numpy(), atol=1e-4 * scale)
    jout = jl.embedding_loss(jnp.asarray(torch.cat(case["emb"]).numpy()),
                             jnp.asarray(torch.cat(case["labels"]).numpy()),
                             **case["kw"])
    total = sum(float(r["loss"]["loss"]) for r in ranks)
    np.testing.assert_allclose(total, float(jout.loss), rtol=1e-5)


def test_per_rank_loss_scalars_fail_the_check(bn_loss):
    """Planted fault: each rank's own K, hard-pixel test and batch size,
    summed or averaged over the ranks, is not the global batch's loss."""
    _, case, ranks = bn_loss
    want = float(one_process_loss(case)[0].loss.detach())
    local = [float(r["loss_local"]["loss"]) for r in ranks]
    for combined in (sum(local), sum(local) / len(local)):
        assert abs(combined - want) > 1e-3 * abs(want)


def test_vgg_dropout_draws_the_global_batch(bn_loss):
    """VGG's train-mode dropout: each rank keeps its rows of the global
    batch's mask, so the ranks' outputs are one process's; drawing a mask
    for its own rows only (a planted fault) gives rank 1 another."""
    cases, _, ranks = bn_loss
    vgg = types.SimpleNamespace(
        training=True, dropout_generator=torch.Generator().manual_seed(5))
    want = tunets.VGGEmbedding._dropout(vgg, cases[0]["x"])
    assert torch.equal(gathered(ranks, None, "dropout"), want)
    local = torch.cat([r["dropout_local"] for r in ranks])
    assert not torch.equal(local, want)


# -- the train step ----------------------------------------------------------

STEP_BATCHES = 2  # SGD steps on global batches of 8 (4 + 4)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    jc, tc = configs()
    js = jax_state(jc, "sgd", steps_per_epoch=1)
    ts = port_state(tc, js, "sgd", steps_per_epoch=1)
    data = batches(STEP_BATCHES, b=8, seed=3)
    payload = {"cfg": cfg_dict(), "net": NET, "solver": "sgd",
               "state_dict": {k: v.clone() for k, v in
                              ts.model.state_dict().items()},
               "batches": data}
    ranks = run_ranks("dp_steps", payload, tmp_path_factory.mktemp("dp"))
    step = ttrain.make_train_step(tc, max_k=8)
    metrics = []
    for img, xyz, label in data:
        ts, m = step(ts, torch.from_numpy(img), torch.from_numpy(xyz),
                     torch.from_numpy(label))
        metrics.append({k: float(v) for k, v in m.items()})
    ts64 = port_state(tc, js, "sgd", steps_per_epoch=1)
    ts64.model.double()
    for img, xyz, label in data:
        ts64, _ = step(ts64, torch.from_numpy(img).double(),
                       torch.from_numpy(xyz).double(),
                       torch.from_numpy(label))
    return js, ts, metrics, data, ranks, ts64


def assert_state_dicts_close(got, want, lr):
    tol = 1e-6 + 2e-2 * lr
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], w), key
        elif "running_" in key:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                       err_msg=key, **STAT_TOL)
        else:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                       atol=tol, err_msg=key)


def test_dp_step_matches_one_process(dp):
    """Two SGD steps, 4 + 4 frames per step: the global loss, intra and
    inter on both ranks, the parameters and BatchNorm statistics equal one
    process's on the 8 frames."""
    _, ts, metrics, _, ranks, _ = dp
    for r in ranks:
        assert r["dp"]["step"] == STEP_BATCHES
        for got, want in zip(r["dp"]["metrics"], metrics):
            for key in ("loss", "intra", "inter"):
                np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                           atol=1e-9, err_msg=key)
    assert_state_dicts_close(ranks[0]["dp"]["state"], ts.model.state_dict(),
                             LR)


def test_dp_step_in_float64_equals_one_process(dp):
    """In float64 the rounding of the summation orders drops out: the two
    processes' parameters and statistics equal one process's within
    1e-10."""
    ranks, ts64 = dp[4], dp[5]
    want = ts64.model.state_dict()
    for key, value in ranks[0]["dp64"]["state"].items():
        assert value.dtype == want[key].dtype, key
        np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                   rtol=1e-10, atol=1e-10, err_msg=key)


def test_dp_ranks_hold_the_same_state(dp):
    a, b = (r["dp"]["state"] for r in dp[4])
    for key, value in a.items():
        assert torch.equal(value, b[key]), key


def test_dp_step_matches_the_jax_mesh_step(dp):
    """The JAX package's step on its 8-device CPU mesh (batch sharded,
    state replicated; tests/test_train.py) against the port's two-process
    step: losses within rtol 2e-4, parameters and statistics within
    test_torch_train's tolerances."""
    js, _, _, data, ranks, _ = dp
    jc, _ = configs()
    mesh = make_mesh()
    js = replicate(js, mesh)
    step = jtrain.make_train_step(jc, max_k=8)
    for (img, xyz, label), got in zip(data, ranks[0]["dp"]["metrics"]):
        js, m = step(js, *shard_batch((img, xyz, label), mesh))
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=2e-4)
    ts = port_state(configs()[1], js, "sgd", steps_per_epoch=1)
    ts.model.load_state_dict(ranks[0]["dp"]["state"])
    assert_states_close(js, ts, LR, steps=STEP_BATCHES)


@pytest.mark.parametrize("fault", ["bn_local", "loss_local"])
def test_dp_planted_faults_fail_the_check(dp, fault):
    """Per-replica BatchNorm statistics, or per-rank loss scalars, give
    another training run: the one-process check fails."""
    _, ts, metrics, _, ranks, _ = dp
    run = ranks[0][fault]
    with pytest.raises(AssertionError):
        for got, want in zip(run["metrics"], metrics):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        assert_state_dicts_close(run["state"], ts.model.state_dict(), LR)


def test_world_one_mesh_is_the_one_device_step():
    """A mesh of world size 1 changes nothing: bitwise the step without
    one (Adam, pre-augmented batch)."""
    jc, tc = configs(LEARNING_RATE=ADAM_LR)
    js = jax_state(jc, "adam")
    img, xyz, label = (torch.from_numpy(a) for a in batches(1)[0])
    step = ttrain.make_train_step(tc, max_k=8)
    a = step(port_state(tc, js, "adam"), img, xyz, label)[0]
    b = step(port_state(tc, js, "adam"), img, xyz, label,
             mesh=Mesh(0, 1, torch.device("cpu")))[0]
    for key, value in a.model.state_dict().items():
        assert torch.equal(value, b.model.state_dict()[key]), key


@pytest.mark.parametrize("mesh", [(0, 2), (1, 1)], ids=["world", "rank"])
def test_a_mesh_that_is_not_the_groups_is_refused(mesh):
    """BatchNorm and the loss reduce over the process group, the step over
    its mesh: a mesh whose rank or world is not the group's (here: no
    group, one process) raises before the step runs."""
    jc, tc = configs()
    img, xyz, label = (torch.from_numpy(a) for a in batches(1)[0])
    state = port_state(tc, jax_state(jc, "sgd"), "sgd")
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    with pytest.raises(ValueError, match="not the process group's"):
        ttrain.make_train_step(tc, max_k=8)(
            state, img, xyz, label, mesh=Mesh(*mesh, torch.device("cpu")))
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, before[key]), key


# -- tools.train_net ---------------------------------------------------------

H, W = 48, 64


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """tools.train_net on 4 scenes, 2 epochs of one step of 4 scenes:
    resident and streaming (--device-augment), in two processes with
    --batch_size 3 (rounded to 4) and in one with --batch_size 4."""
    root = tmp_path_factory.mktemp("dp_train_net")
    yml = root / "small.yml"
    yml.write_text(YML)
    cache = str(root / "cache")
    render_dataset.main(["--cache-dir", cache, "--height", str(H),
                         "--width", str(W), "--num", "4"])

    def args(out, route, batch):
        return ["--cfg", str(yml), "--network", NET, "--solver", "sgd",
                "--render-cache", cache, "--device", "cpu", "--workers", "0",
                "--keep", "1", "--epochs", "2", route, "--batch_size",
                str(batch), "--output-dir", str(root / out)]

    routes = {"resident": "--device-resident",
              "streaming": "--device-augment"}
    payload = {"runs": {name: args(f"dp_{name}", route, 3)
                        for name, route in routes.items()},
               "fault_run": ("own_rows", args("dp_own_rows", "--device-"
                                              "resident", 4))}
    ranks = run_ranks("train_net_runs", payload, root)
    one = {name: train_net.main(args(f"one_{name}", route, 4))
           for name, route in routes.items()}
    init = train_net.main(args("init", "--device-resident", 4)
                          + ["--epochs", "0"]).model.state_dict()
    snapshots = {route: sorted(os.listdir(root / f"dp_{route}"))
                 for route in routes}
    for out in ("dp_resident", "dp_streaming", "dp_own_rows", "one_resident",
                "one_streaming"):
        shutil.rmtree(root / out)  # ~0.2 GB a run
    return dict(root=root, ranks=ranks, one=one, init=init, args=args,
                snapshots=snapshots)


UPDATE_TOL = 4e-2  # chip_smoke.py's STEP_TOL["grad_rel_l2"]


def assert_runs_agree(got, want, init):
    """The parameter updates (from `init`) as one vector within UPDATE_TOL
    relative L2; the BatchNorm statistics within STAT_TOL."""
    diff, norm = 0.0, 0.0
    for key, w in want.items():
        if "running_" in key:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(),
                                       err_msg=key, **STAT_TOL)
        elif not key.endswith("num_batches_tracked"):
            diff += float(((got[key] - w).double() ** 2).sum())
            norm += float(((w - init[key]).double() ** 2).sum())
    rel = (diff / norm) ** 0.5
    assert norm > 0 and rel <= UPDATE_TOL, rel


@pytest.mark.parametrize("route", ["resident", "streaming"])
def test_train_net_two_processes_match_one(cli, route):
    """The resident epoch (each rank gathers its rows of the shuffled
    indices) and the streaming loader (each rank reads its rows): two
    processes end where one does."""
    ranks, one, init = cli["ranks"], cli["one"], cli["init"]
    for r in ranks:
        assert r[route]["step"] == one[route].step == 2
        assert_runs_agree(r[route]["state"], one[route].model.state_dict(),
                          init)


def test_train_net_rank_zero_alone_writes_and_prints(cli):
    """Rank 0 writes each epoch's snapshot (keep 1 leaves the last) and
    prints the batch rounding and the step lines; rank 1 neither writes
    nor prints."""
    r0, r1 = cli["ranks"]
    for route in ("resident", "streaming"):
        assert r0[route]["saves"] == [1, 2]
        assert r1[route]["saves"] == []
        assert r1[route]["printed"] == ""
        printed = r0[route]["printed"]
        assert "rounded batch to 4 for 2 processes" in printed
        assert printed.count("loss intra") == 2
        assert cli["snapshots"][route] == ["2"]


def test_train_net_under_torchrun(cli):
    """python -m torch.distributed.run --standalone --nproc_per_node 2:
    the processes form their group from torchrun's environment (env://,
    gloo on the CPU) and train the one-process resident run; rank 0's
    last snapshot holds it."""
    root, one, init = cli["root"], cli["one"], cli["init"]
    args = cli["args"]("torchrun", "--device-resident", 3)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m",
         "unseenobjectclustering_torch.tools.train_net"] + args,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert out.stdout.count("loss intra") == 2
    assert "rounded batch to 4 for 2 processes" in out.stdout
    assert sorted(os.listdir(root / "torchrun")) == ["2"]
    payload, step = tck.restore_checkpoint(str(root / "torchrun"))
    shutil.rmtree(root / "torchrun")
    assert step == 2 and payload["step"] == 2
    assert_runs_agree(payload["model"], one["resident"].model.state_dict(),
                      init)


def test_train_net_own_rows_draws_fail_the_check(cli):
    """Planted fault: each rank draws the augmentation of its own rows
    only (not the global batch's) and trains another run."""
    ranks, one, init = cli["ranks"], cli["one"], cli["init"]
    with pytest.raises(AssertionError):
        assert_runs_agree(ranks[0]["own_rows"]["state"],
                          one["resident"].model.state_dict(), init)
