"""Data-parallel stage 1 of the port on the CPU: Segmentor.segment_sharded
and evaluate_dataset_sharded over two gloo processes
(tests/torch_ranks.py), held against one process's segment(refine=False)
and against the JAX package's segment_sharded on its 8-device CPU mesh.

The weights are test_torch_stage2's (flax init with random BatchNorm
statistics, carried with state_dict_from_flax; ResNet-18, 8-D embeddings,
16 seeds, kappa 30, epsilon 0.02: stage 1 finds instances on the scenes).
Against one process the first seeds come from the Segmentors' seeded
generators, so the labels are equal only if every frame gets the
generator that segment gives it; against JAX the first seed is pinned on
both (the JAX PRNG has no torch replay), as in test_torch_pipeline.

Tolerances: labels equal, metric dicts equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import scene
from test_torch_stage2 import FIRST, NET, segmentors
from torch_ranks import run_ranks
from unseenobjectclustering_torch.engine.evaluate import (
    evaluate_dataset_sharded)
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.parallel import Mesh
from unseenobjectclustering_torch.utils.evaluation import multilabel_metrics
from unseenobjectclustering_tpu.ops import preprocess as jpre
from unseenobjectclustering_tpu.parallel import make_mesh

torch.set_num_threads(1)

SEED = 5
BATCHES = (3, 4)  # odd and even over two ranks, 30x44 (padded to 32x48)
EVAL_FRAMES, EVAL_BATCH = 5, 2  # the trailing batch of 1 is padded to 2


def frames(n, h, w, first=0, means=None):
    """n preprocessed test scenes (JAX preprocessing): image, XYZ
    [n, h, w, 3] numpy, and the boxes' ids as ground truth."""
    img, xyz, gt = [], [], []
    for i in range(first, first + n):
        bgr, depth = scene(i, h=h, w=w)
        a, b = jpre.preprocess_rgbd(jnp.asarray(bgr), jnp.asarray(depth),
                                    jnp.asarray(means), 40.0, 40.0, w / 2.0,
                                    h / 2.0, height=h, width=w)
        img.append(np.array(a))
        xyz.append(np.array(b))
        box = (depth > 0) & (depth < 1.0)
        gt.append(np.where(box, np.rint((depth - 0.6) * 10),
                           0).astype(np.int32))
    return np.stack(img), np.stack(xyz), np.stack(gt)


class Frames:
    def __init__(self, img, xyz, gt):
        self.img, self.xyz, self.gt = img, xyz, gt

    def __len__(self):
        return len(self.gt)

    def __getitem__(self, i):
        return {"image_color": self.img[i], "depth": self.xyz[i],
                "label": self.gt[i]}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jseg, tseg, _ = segmentors()
    means = tseg.cfg.pixel_means
    overrides = dict(INPUT="RGBD", TRAIN={"NUM_UNITS": 8,
                                          "SYN_CROP_SIZE": 32},
                     CLUSTER={"NUM_SEEDS": 16, "MAX_INSTANCES": 4,
                              "KAPPA": 30.0, "EPSILON": 0.02})
    state_dict = {k: v.clone() for k, v in tseg.model.state_dict().items()}
    batches = [frames(b, 30, 44, first=10 * b, means=means)[:2]
               for b in BATCHES]
    pinned = frames(8, 32, 48, means=means)[:2]
    dataset = Frames(*frames(EVAL_FRAMES, 30, 44, first=40, means=means))
    payload = {"overrides": overrides, "state_dict": state_dict, "net": NET,
               "seed": SEED, "batches": batches, "first_index": FIRST,
               "pinned_batches": [pinned], "dataset": dataset,
               "eval_batch": EVAL_BATCH}
    ranks = run_ranks("sharded_stage1", payload,
                      tmp_path_factory.mktemp("sharded"))

    def one_process():
        return Segmentor(tseg.cfg, state_dict, network_name=NET, seed=SEED,
                         device="cpu")

    return dict(jseg=jseg, one_process=one_process, batches=batches,
                pinned=pinned, dataset=dataset, ranks=ranks)


@pytest.mark.parametrize("i", range(len(BATCHES)),
                         ids=[f"B{b}" for b in BATCHES])
def test_segment_sharded_equals_one_process(setup, i):
    """Each frame's labels from two processes (2 + 1 and 2 + 2 frames)
    equal one process's segment(refine=False) on the whole batch, from a
    Segmentor with the same seed after the same earlier calls."""
    seg = setup["one_process"]()
    want = [seg.segment(img, xyz, refine=False).labels
            for img, xyz in setup["batches"]]
    for r in setup["ranks"]:
        got = r["labels"][i]
        assert got.shape == want[i].shape and got.dtype == np.int32
        np.testing.assert_array_equal(got, want[i])
    assert len(np.unique(want[i])) > 2  # instances were found


def test_drawing_only_the_own_frames_generators_fails(setup):
    """Planted fault: each rank draws generators for its own frames only
    (rank 1 then takes the first frames' generators): the labels differ
    from one process's."""
    seg = setup["one_process"]()
    want = [seg.segment(img, xyz, refine=False).labels
            for img, xyz in setup["batches"]]
    got = setup["ranks"][0]["own_frames"]
    assert any(not np.array_equal(g, w) for g, w in zip(got, want))


def test_segment_sharded_matches_the_jax_mesh(setup):
    """8 frames at 32x48 with the first seed pinned on both: the port's
    two processes give the labels of the JAX package's segment_sharded
    over its 8-device CPU mesh."""
    img, xyz = setup["pinned"]
    want = setup["jseg"].segment_sharded(make_mesh(), img, xyz)
    for r in setup["ranks"]:
        np.testing.assert_array_equal(r["pinned"][0], want)
    assert len(np.unique(want)) > 2


def test_evaluate_dataset_sharded_pads_the_trailing_batch(setup):
    """5 frames in batches of 2 (the last padded with its frame): the
    averaged metrics are those of each frame's segment(refine=False)
    labels on the same padded batches; every rank returns them and rank 0
    alone prints the table."""
    ds = setup["dataset"]
    seg = setup["one_process"]()
    metrics = []
    for lo in range(0, len(ds), EVAL_BATCH):
        idx = list(range(lo, min(lo + EVAL_BATCH, len(ds))))
        padded = idx + [idx[-1]] * (EVAL_BATCH - len(idx))
        labels = seg.segment(ds.img[padded], ds.xyz[padded],
                             refine=False).labels
        metrics += [multilabel_metrics(labels[k], ds.gt[i])
                    for k, i in enumerate(idx)]
    want = {k: sum(m[k] for m in metrics) / len(metrics) for k in metrics[0]}
    r0, r1 = setup["ranks"]
    assert r0["metrics"] == r1["metrics"] == want
    assert "(sharded stage-1)" in r0["printed"] and r1["printed"] == ""
    with pytest.raises(ValueError, match="multiple of the world size"):
        evaluate_dataset_sharded(ds, seg, Mesh(0, 2, torch.device("cpu")),
                                 batch_size=3)


def test_world_one_segment_sharded_is_segment(setup):
    """In one process (world size 1) segment_sharded is segment's stage 1,
    frame for frame."""
    img, xyz = setup["batches"][0]
    a, b = setup["one_process"](), setup["one_process"]()
    mesh = Mesh(0, 1, torch.device("cpu"))
    np.testing.assert_array_equal(a.segment_sharded(mesh, img, xyz),
                                  b.segment(img, xyz, refine=False).labels)
