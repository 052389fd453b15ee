"""Multi-process harness for the port's data-parallel tests: run a function
in `world` spawned processes joined in a gloo process group on the CPU.

    results = run_ranks("fn_name", payload, tmp_path, world=2)

Each process sets torch.set_num_threads(1), forms the group through a
file:// rendezvous in tmp_path (no TCP port, so the tests can run under
pytest-xdist), calls fn_name(mesh, payload) from this module and saves its
return value; run_ranks returns the ranks' values in rank order.  A rank
that fails or outlives `timeout` fails the test.  The functions here import
only torch and the port: the JAX comparisons happen in the test process.
"""

from __future__ import annotations

import contextlib
import io
import multiprocessing
import os
import types
from unittest import mock

import numpy as np
import torch


def run_ranks(fn_name: str, payload, tmp_path, world: int = 2,
              init: str = "args", timeout: float = 300.0) -> list:
    tmp = str(tmp_path)
    torch.save(payload, os.path.join(tmp, "payload.pt"))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(rank, world, tmp, fn_name, init))
             for rank in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
        alive = [p.pid for p in procs if p.is_alive()]
        assert not alive, f"ranks still running after {timeout} s: {alive}"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
        results = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pt")
            results.append(torch.load(path, weights_only=False))
            os.remove(path)  # state dicts: keep the test's disk use small
        return results
    finally:
        os.remove(os.path.join(tmp, "payload.pt"))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)


def _entry(rank, world, tmp, fn_name, init):
    torch.set_num_threads(1)
    from unseenobjectclustering_torch import parallel

    address = "file://" + os.path.join(tmp, "rdzv")
    if init == "env":
        os.environ.update(COORDINATOR_ADDRESS=address,
                          NUM_PROCESSES=str(world), PROCESS_ID=str(rank))
        parallel.initialize(backend="gloo")
    else:
        parallel.initialize(address, world, rank, backend="gloo")
    payload = torch.load(os.path.join(tmp, "payload.pt"), weights_only=False)
    out = globals()[fn_name](parallel.make_mesh("cpu"), payload)
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# rank functions: fn(mesh, payload) -> a picklable result
# ---------------------------------------------------------------------------

def group_facts(mesh, payload):
    from unseenobjectclustering_torch import parallel

    def rows(b):
        try:
            return parallel.local_batch_slice(b)
        except ValueError:
            return "uneven"

    return dict(mesh=tuple(mesh), group=parallel.data_parallel_group()
                is not None, slices=[rows(b) for b in payload["batches"]])


def replicated_state(mesh, payload):
    """A train state that differs per rank (init seed, one step on the
    rank's own data, its step count) before replicate(state, mesh)."""
    from unseenobjectclustering_torch import Config, parallel
    from unseenobjectclustering_torch.engine import train

    cfg = Config.from_dict(payload["cfg"])
    state = train.create_train_state(cfg, network_name=payload["net"],
                                     solver="adam", seed=mesh.rank,
                                     device="cpu")
    rng = np.random.RandomState(mesh.rank)
    img, xyz = (torch.from_numpy(rng.randn(1, 32, 32, 3).astype(np.float32))
                for _ in range(2))
    label = torch.from_numpy(rng.randint(0, 3, (1, 32, 32)))
    with mock.patch.object(train, "_data_parallel", lambda mesh: False):
        train.make_train_step(cfg, max_k=8)(state, img, xyz, label)
    state.step = 10 + mesh.rank
    parallel.replicate(state, mesh)
    params = parallel.replicate({"w": torch.full((3,), float(mesh.rank))},
                                mesh)
    return dict(model=state.model.state_dict(),
                optimizer=state.optimizer.state_dict()["state"],
                step=state.step, tree=params)


def _segmentor(payload, first_index=None):
    from unseenobjectclustering_torch import Config
    from unseenobjectclustering_torch.engine.pipeline import Segmentor

    seg = Segmentor(Config.inference_default(**payload["overrides"]),
                    payload["state_dict"], network_name=payload["net"],
                    seed=payload["seed"], device="cpu")
    if first_index is not None:
        seg._ms_kw = dict(seg._ms_kw, first_index=first_index)
    return seg


def sharded_stage1(mesh, payload):
    """segment_sharded on each batch of payload["batches"] in turn (one
    Segmentor), again with each rank drawing generators for its own
    frames only (a planted fault), and on payload["pinned_batches"] with
    the first seed pinned; then evaluate_dataset_sharded over
    payload["dataset"] with a fresh Segmentor (rank 0 prints its table)."""
    from unseenobjectclustering_torch.engine.evaluate import (
        evaluate_dataset_sharded)

    seg = _segmentor(payload)
    out = dict(labels=[seg.segment_sharded(mesh, img, xyz)
                       for img, xyz in payload["batches"]])

    def own_frames_only(seg, img, xyz):
        b = img.shape[0]
        per = -(-b // mesh.world)
        lo, hi = min(b, mesh.rank * per), min(b, (mesh.rank + 1) * per)
        gens = ([None] * lo + [seg.next_key() for _ in range(hi - lo)]
                + [None] * (b - hi))
        return seg.make_sharded_stage1(mesh)(img, xyz, gens).numpy()

    seg = _segmentor(payload)
    out["own_frames"] = [own_frames_only(seg, img, xyz)
                         for img, xyz in payload["batches"]]
    seg = _segmentor(payload, payload["first_index"])
    out["pinned"] = [seg.segment_sharded(mesh, img, xyz)
                     for img, xyz in payload["pinned_batches"]]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["metrics"] = evaluate_dataset_sharded(
            payload["dataset"], _segmentor(payload), mesh,
            batch_size=payload["eval_batch"], num_workers=0)
    out["printed"] = buf.getvalue()
    return out


def batchnorm_and_loss(mesh, payload):
    """This rank's rows of each payload["bn"] case through a train-mode
    BatchNorm2d (its output, the input and parameter gradients of
    sum(y * g), the running statistics) and its part of payload["loss"]
    through embedding_loss (its share, the gradient of the share), and
    VGG's train-mode dropout on its rows of the first case's input, each
    also with the group left out (per-replica statistics, per-rank loss
    scalars, per-rank dropout draws) for the tests' planted faults."""
    from unseenobjectclustering_torch.models import losses, resnet, unets

    def bn_run(case):
        rows = mesh.batch_slice(case["x"].shape[0])
        bn = resnet.BatchNorm2d(case["x"].shape[1])
        bn.load_state_dict(case["state"])
        bn.train()
        x = case["x"][rows].clone().requires_grad_(True)
        y = bn(x)
        (y * case["g"][rows]).sum().backward()
        return dict(y=y.detach(), dx=x.grad, dweight=bn.weight.grad,
                    dbias=bn.bias.grad, running_mean=bn.running_mean,
                    running_var=bn.running_var)

    def loss_run(case):
        e = case["emb"][mesh.rank].clone().requires_grad_(True)
        out = losses.embedding_loss(e, case["labels"][mesh.rank],
                                    **case["kw"])
        out.loss.backward()
        return dict(loss=out.loss.detach(), intra=out.intra.detach(),
                    inter=out.inter.detach(), grad=e.grad)

    def dropout_run():
        x = payload["bn"][0]["x"]
        vgg = types.SimpleNamespace(
            training=True, dropout_generator=torch.Generator().manual_seed(5))
        return unets.VGGEmbedding._dropout(vgg, x[mesh.batch_slice(len(x))])

    res = dict(bn=[bn_run(c) for c in payload["bn"]],
               loss=loss_run(payload["loss"]), dropout=dropout_run())
    with mock.patch.object(resnet, "data_parallel_group", lambda: None):
        res["bn_local"] = [bn_run(c) for c in payload["bn"]]
    with mock.patch.object(losses, "data_parallel_group", lambda: None):
        res["loss_local"] = loss_run(payload["loss"])
    with mock.patch.object(unets, "data_parallel_group", lambda: None):
        res["dropout_local"] = dropout_run()
    return res


def dp_steps(mesh, payload):
    """A train step of one state on this rank's rows of each global batch
    of payload["batches"], in float32 and in float64; again in float32
    with per-replica BatchNorm statistics and with per-rank loss scalars
    (planted faults).  Returns each run's state_dict and per-step
    metrics (rank 1: the first run's only)."""
    from unseenobjectclustering_torch import Config
    from unseenobjectclustering_torch.engine import train
    from unseenobjectclustering_torch.models import losses, resnet

    cfg = Config.from_dict(payload["cfg"])

    def run(dtype=torch.float32):
        state = train.create_train_state(
            cfg, network_name=payload["net"], solver=payload["solver"],
            steps_per_epoch=1, state_dict=payload["state_dict"],
            device="cpu")
        state.model.to(dtype)
        step = train.make_train_step(cfg, max_k=8)
        metrics = []
        for img, xyz, label in payload["batches"]:
            rows = mesh.batch_slice(img.shape[0])
            state, m = step(state, torch.from_numpy(img[rows]).to(dtype),
                            torch.from_numpy(xyz[rows]).to(dtype),
                            torch.from_numpy(label[rows]), mesh=mesh)
            metrics.append({k: float(v) for k, v in m.items()})
        return dict(state=state.model.state_dict(), metrics=metrics,
                    step=state.step)

    out = dict(dp=run(), dp64=run(torch.float64))
    with mock.patch.object(resnet, "data_parallel_group", lambda: None):
        out["bn_local"] = run()
    with mock.patch.object(losses, "data_parallel_group", lambda: None):
        out["loss_local"] = run()
    return out if mesh.rank == 0 else {"dp": out["dp"]}


def train_net_runs(mesh, payload):
    """tools.train_net.main for each argument list of payload["runs"]
    under the group, counting each rank's snapshot writes and log lines;
    again with each rank drawing only its own rows' augmentation (a
    planted fault) for payload["fault_run"]."""
    from unseenobjectclustering_torch.engine import train
    from unseenobjectclustering_torch.tools import train_net

    out = {}
    for name, args in payload["runs"].items():
        saves = []
        real_save = train.save_checkpoint

        def save(*a, **k):
            saves.append(a[1])
            return real_save(*a, **k)

        buf = io.StringIO()
        with mock.patch.object(train, "save_checkpoint", save), \
                contextlib.redirect_stdout(buf):
            state = train_net.main(args)
        out[name] = dict(state=state.model.state_dict(), step=state.step,
                         saves=saves, printed=buf.getvalue())
    name, args = payload["fault_run"]

    def own_rows_only(draw, gen, bgr, draws, mesh):
        return draw(gen, bgr)

    with mock.patch.object(train, "_rank_draws", own_rows_only), \
            contextlib.redirect_stdout(io.StringIO()):
        out[name] = dict(state=train_net.main(args).model.state_dict())
    return out
