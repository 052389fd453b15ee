"""The port's process-group layer (unseenobjectclustering_torch.parallel)
on the CPU: initialize (arguments, the JAX package's environment
variables, the no-op without configuration, the refusals), the mesh,
local_batch_slice against the JAX package's arithmetic, shard_batch, the
sharded loader and replicate.

Multi-process cases run two gloo processes through tests/torch_ranks.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_ranks import run_ranks
from unseenobjectclustering_torch import parallel
from unseenobjectclustering_torch.data.loader import DataLoader
from unseenobjectclustering_torch.parallel import Mesh, shard_batch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_KEYS = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for key in ENV_KEYS:
        monkeypatch.delenv(key, raising=False)


def test_initialize_without_configuration_is_one_process(clean_env):
    parallel.initialize()
    assert not dist.is_initialized()
    assert parallel.data_parallel_group() is None
    assert parallel.local_batch_slice(7) == slice(0, 7)
    assert parallel.local_rank() == 0
    mesh = parallel.make_mesh("cpu")
    assert mesh == Mesh(0, 1, torch.device("cpu"))
    assert mesh.batch_slice(5) == slice(0, 5)


@pytest.mark.parametrize("env", [
    {"NUM_PROCESSES": "2"},
    {"COORDINATOR_ADDRESS": "localhost:1"},
    {"MASTER_ADDR": "localhost", "WORLD_SIZE": "2"},
])
def test_initialize_refuses_a_partial_configuration(clean_env, monkeypatch,
                                                    env):
    """A process count without an address, or an address without a count
    or this process's id, raises instead of running alone."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="process group needs"):
        parallel.initialize()
    assert not dist.is_initialized()


def test_initialize_raises_when_the_group_cannot_form(tmp_path):
    """A group of two that only one process joins raises after the
    timeout (cut to 2 s); nothing goes on at world size 1."""
    code = f"""
import datetime, sys
from unseenobjectclustering_torch import parallel
from unseenobjectclustering_torch.parallel import distributed
distributed._TIMEOUT = datetime.timedelta(seconds=2)
try:
    parallel.initialize("file://{tmp_path}/rdzv", 2, 0, backend="gloo")
except Exception as e:
    print("raised", type(e).__name__)
    sys.exit(0)
sys.exit("formed a group alone")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("raised")


@pytest.mark.parametrize("init", ["args", "env"])
def test_two_processes_form_the_group(tmp_path, init):
    """From arguments or from COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID: each rank's mesh and its local_batch_slice, which keeps
    the JAX package's arithmetic (B // world rows from rank * B // world)
    and, like Mesh.batch_slice, refuses a batch that does not divide
    rather than drop its last row.
    """
    batches = [8, 6, 7]
    res = run_ranks("group_facts", {"batches": batches}, tmp_path, init=init)
    for rank, r in enumerate(res):
        assert r["mesh"] == (rank, 2, torch.device("cpu"))
        assert r["group"]
        assert r["slices"] == [slice(rank * 4, rank * 4 + 4),
                               slice(rank * 3, rank * 3 + 3), "uneven"]


def test_shard_batch_cuts_each_leaf_and_refuses_an_uneven_batch():
    mesh = Mesh(1, 2, torch.device("cpu"))
    batch = {"img": np.arange(12.0).reshape(6, 2), "depth": None,
             "pair": (torch.arange(6), np.arange(6))}
    out = shard_batch(batch, mesh)
    np.testing.assert_array_equal(out["img"].numpy(),
                                  np.arange(6.0, 12.0).reshape(3, 2))
    assert out["depth"] is None
    assert [t.tolist() for t in out["pair"]] == [[3, 4, 5]] * 2
    with pytest.raises(ValueError, match="does not divide"):
        shard_batch(np.zeros((5, 2)), mesh)


class _Indexed:
    """Samples that are their own index."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


def test_sharded_loader_reads_its_rows_in_the_one_process_order():
    """The ranks' rows of each batch, put together, are the one-process
    loader's batch (RandomState(seed + epoch) order), epoch by epoch."""
    whole = DataLoader(_Indexed(), batch_size=4, num_workers=0, seed=5)
    ranks = [DataLoader(_Indexed(), batch_size=4, num_workers=0, seed=5,
                        mesh=Mesh(r, 2, torch.device("cpu")))
             for r in range(2)]
    for epoch in (0, 3):
        for loader in [whole] + ranks:
            loader.set_epoch(epoch)
        want = [b["i"].tolist() for b in whole]
        got = [sum((b["i"].tolist() for b in batches), [])
               for batches in zip(*ranks)]
        assert got == want and len(want) == 2
    with pytest.raises(ValueError, match="does not divide"):
        DataLoader(_Indexed(), batch_size=3,
                   mesh=Mesh(0, 2, torch.device("cpu")))


def test_replicate_gives_every_rank_rank_zeros_state(tmp_path):
    """Ranks that built different states (init seed, an Adam step on their
    own data, their step count) hold rank 0's after replicate: parameters,
    BatchNorm buffers, Adam moments and step counts, the train step; a
    tensor tree too."""
    cfg = {"INPUT": "RGBD", "MODE": "TRAIN", "TRAIN": {"NUM_UNITS": 4}}
    a, b = run_ranks("replicated_state",
                     {"cfg": cfg, "net": "seg_resnet18_8s_embedding"},
                     tmp_path)
    assert a["step"] == b["step"] == 10
    assert a["model"].keys() == b["model"].keys()
    for key, value in a["model"].items():
        assert torch.equal(value, b["model"][key]), key
    assert a["optimizer"] and a["optimizer"].keys() == b["optimizer"].keys()
    for i, per in a["optimizer"].items():
        for name, value in per.items():
            assert torch.equal(value, b["optimizer"][i][name]), (i, name)
    assert a["tree"]["w"].tolist() == b["tree"]["w"].tolist() == [0.0] * 3


def test_package_exports_the_parallel_names_and_stays_numpy_only():
    """The package root exports the parallel names, and importing it (or
    the renderer, whose worker processes import it) imports no torch."""
    import unseenobjectclustering_torch as pkg

    assert pkg.make_mesh is parallel.make_mesh
    assert pkg.shard_batch is shard_batch
    code = ("import sys, unseenobjectclustering_torch, "
            "unseenobjectclustering_torch.tools.render_dataset; "
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_mesh_without_a_device_needs_a_card(clean_env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.make_mesh()
