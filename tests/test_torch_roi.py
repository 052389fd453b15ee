"""The port's stage-2 ops (unseenobjectclustering_torch/ops/roi.py) against
the JAX package's on the same numpy inputs.

Tolerances: boxes, validity, mask crops, vetoed labels and their dtype,
pasted labels and dense ids equal; RGB and XYZ crops within 1e-6 (the
blend of four taps sums in another order); order keys equal or within 1e-6
relative (the mean depth sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch.ops import roi as troi
from unseenobjectclustering_torch.ops import resize as tresize
from unseenobjectclustering_tpu.ops import resize as jresize
from unseenobjectclustering_tpu.ops import roi as jroi
from unseenobjectclustering_tpu.ops.train_pipeline import (
    _dense_relabel as jax_dense_relabel)

torch.set_num_threads(1)

H, W, M = 37, 50, 6


def edge_cases():
    """Ids 1..5 and 7 on a 37x50 map: id 1's x extent is 6 (pad 1.5 rounds
    to 2) and its y extent 10 (pad 2.5 rounds to 2); id 2 touches the top
    and right edges; id 3 is absent; id 4 is one pixel; id 5 is an L along
    the bottom and left edges; id 7 is beyond max_instances."""
    lab = np.zeros((H, W), np.int32)
    lab[3:14, 4:11] = 1
    lab[0:9, 40:50] = 2
    lab[30, 20] = 4
    lab[20:37, 0:6] = 5
    lab[34:37, 0:26] = 5
    lab[15:18, 30:35] = 7
    return lab


def random_labels(seed, h=H, w=W, k=6):
    rng = np.random.RandomState(seed)
    lab = np.zeros((h, w), np.int32)
    for i in range(1, k + 1):
        y0, x0 = rng.randint(0, h), rng.randint(0, w)
        lab[y0:y0 + rng.randint(1, h // 2 + 2),
            x0:x0 + rng.randint(1, w // 2 + 2)] = i
    return lab


def images(seed, h=H, w=W):
    rng = np.random.RandomState(seed)
    return (rng.randn(h, w, 3).astype(np.float32),
            (0.5 + rng.rand(h, w, 3)).astype(np.float32))


@pytest.mark.parametrize("case", ["edges", 0, 1, 2])
@pytest.mark.parametrize("with_depth", [True, False])
@pytest.mark.parametrize("size", [32, 224])
def test_crop_rois_matches_jax(case, with_depth, size):
    lab = edge_cases() if case == "edges" else random_labels(case)
    rgb, xyz = images(3 if case == "edges" else case)
    want = jroi.crop_rois(jnp.asarray(rgb), jnp.asarray(lab),
                          jnp.asarray(xyz) if with_depth else None,
                          max_instances=M, crop_size=size)
    got = troi.crop_rois(torch.from_numpy(rgb), torch.from_numpy(lab),
                         torch.from_numpy(xyz) if with_depth else None,
                         max_instances=M, crop_size=size)
    np.testing.assert_array_equal(got.rois.numpy(), np.asarray(want.rois))
    assert got.rois.dtype == torch.int32
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.mask_crops.numpy(),
                                  np.asarray(want.mask_crops))
    np.testing.assert_allclose(got.rgb_crops.numpy(),
                               np.asarray(want.rgb_crops), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.depth_crops.numpy(),
                               np.asarray(want.depth_crops), rtol=0,
                               atol=1e-6)
    if case == "edges":
        assert got.valid.tolist() == [True, True, False, True, True, False]
        assert not got.rgb_crops[2].any() and not got.mask_crops[5].any()
        assert got.rois[3].tolist() == [20, 30, 20, 30]  # one pixel: no pad
    if not with_depth:
        assert not got.depth_crops.any()


def test_instance_and_padded_boxes_match_jax():
    lab = edge_cases()
    want_b, want_p = jroi._instance_boxes(jnp.asarray(lab), M)
    got_b, got_p = troi._instance_boxes(torch.from_numpy(lab), M)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    assert got_b[0].tolist() == [4, 3, 10, 13]
    assert got_b[2].tolist() == [0, 0, 0, 0]  # absent id 3
    padded = troi._pad_boxes(got_b, H, W)
    np.testing.assert_array_equal(
        padded.numpy(), np.asarray(jroi._pad_boxes(want_b, H, W)))
    # extent 6 -> pad round(1.5) = 2, extent 10 -> round(2.5) = 2
    assert padded[0].tolist() == [2, 1, 12, 15]
    # extent 14 -> pad round(3.5) = 4; clamped at the frame's edges
    boxes = torch.tensor([[0, 20, 14, 36]], dtype=torch.int32)
    assert troi._pad_boxes(boxes, H, W).tolist() == [[0, 16, 18, 36]]


def veto_case(seed, m=4, s=16, label_max=5, with_depth=True):
    rng = np.random.RandomState(seed)
    labels_crop = rng.randint(0, label_max, size=(m, s, s)).astype(np.int32)
    mask_crops = (rng.rand(m, s, s) > 0.4).astype(np.float32)
    depth = np.zeros((m, s, s), np.float32)
    depth[:] = np.where(rng.rand(m, s, s) > 0.2, 0.5 + rng.rand(m, s, s), 0)
    depth += rng.permutation(m)[:, None, None] * 0.7 * (depth > 0)
    valid = np.array([True] * (m - 1) + [False])
    return labels_crop, mask_crops, (depth if with_depth else None), valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_depth", [True, False])
def test_veto_and_order_matches_jax(seed, with_depth):
    labels_crop, mask_crops, depth, valid = veto_case(seed,
                                                      with_depth=with_depth)
    # crop 1: no cluster survives (the key falls back to the whole crop);
    # crop 2: no valid depth (key +inf)
    mask_crops[1] = 0.0
    if depth is not None:
        depth[2] = 0.0
    want_l, want_k = jroi.veto_and_order(
        jnp.asarray(labels_crop), jnp.asarray(mask_crops),
        None if depth is None else jnp.asarray(depth), jnp.asarray(valid),
        max_labels=8)
    got_l, got_k = troi.veto_and_order(
        torch.from_numpy(labels_crop), torch.from_numpy(mask_crops),
        None if depth is None else torch.from_numpy(depth),
        torch.from_numpy(valid), max_labels=8)
    assert got_l.dtype == torch.int8 and np.asarray(want_l).dtype == np.int8
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert (got_l[1] == -1).all()
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), rtol=1e-6)
    assert got_k[3] == -np.inf
    if depth is not None:
        assert got_k[2] == np.inf and np.isfinite(float(got_k[1]))


@pytest.mark.parametrize("max_labels", [101, 200])
def test_veto_and_order_label_width_matches_jax(max_labels):
    """int8 up to 128 labels, int16 above: id 150 is kept, not wrapped."""
    labels_crop = np.zeros((1, 8, 8), np.int32)
    labels_crop[0, 2:6, 2:6] = 150 if max_labels > 128 else 100
    labels_crop[0, 0, :] = 3
    mask = np.zeros((1, 8, 8), np.float32)
    mask[0, 2:6, 2:6] = 1.0
    args = (labels_crop, mask, None, np.array([True]))
    want_l, want_k = jroi.veto_and_order(*(None if a is None else
                                           jnp.asarray(a) for a in args),
                                         max_labels=max_labels)
    got_l, got_k = troi.veto_and_order(*(None if a is None else
                                         torch.from_numpy(a) for a in args),
                                       max_labels=max_labels)
    want_l = np.asarray(want_l)
    assert str(got_l.dtype).split(".")[-1] == want_l.dtype.name
    assert want_l.dtype == (np.int16 if max_labels > 128 else np.int8)
    np.testing.assert_array_equal(got_l.numpy(), want_l)
    assert (got_l[0, 0, :] == -1).all()
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))


def paste_case(seed, with_depth):
    labels_crop, mask_crops, depth, valid = veto_case(seed,
                                                      with_depth=with_depth)
    rng = np.random.RandomState(100 + seed)
    m, h, w = len(valid), 48, 64
    rois = np.zeros((m, 4), np.int32)
    for i in range(m):
        x0, y0 = rng.randint(0, w - 20), rng.randint(0, h - 20)
        rois[i] = (x0, y0, x0 + rng.randint(10, 19), y0 + rng.randint(10, 19))
    dense = np.zeros((h, w), np.int32)
    for i in range(m):
        x0, y0, x1, y1 = rois[i]
        dense[y0 + 2:y1 - 1, x0 + 2:x1 - 1] = i + 1
    depth_crops = None
    if depth is not None:
        depth_crops = np.zeros(depth.shape + (3,), np.float32)
        depth_crops[..., 2] = depth
    return labels_crop, mask_crops, depth_crops, rois, valid, dense


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_depth", [True, False])
def test_paste_back_and_match_label_crop_match_jax(seed, with_depth):
    labels_crop, mask_crops, depth_crops, rois, valid, dense = paste_case(
        seed, with_depth)
    initial = np.zeros_like(dense)
    want, want_veto = jroi.match_label_crop(initial, labels_crop, mask_crops,
                                            rois, depth_crops, valid)
    got, got_veto = troi.match_label_crop(initial, labels_crop, mask_crops,
                                          rois, depth_crops, valid)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_veto, want_veto)
    assert len(np.unique(got)) > 2

    # the device veto + host paste gives the host oracle's labels
    lv, key = troi.veto_and_order(
        torch.from_numpy(labels_crop), torch.from_numpy(mask_crops),
        None if depth_crops is None else torch.from_numpy(
            depth_crops[..., 2]), torch.from_numpy(valid), max_labels=8)
    key = key.numpy()
    if depth_crops is None:
        x0, y0, x1, y1 = rois.T
        key = np.where(valid, ((y1 - y0 + 1) * (x1 - x0 + 1)).astype(
            np.float32), -np.inf)
    np.testing.assert_array_equal(
        troi.paste_back(initial, lv.numpy(), key, rois, valid), want)

    # REFINE_FALLBACK: every cluster of crop 0 vetoed
    lv = lv.numpy().copy()
    lv[0] = -1
    for fallback in (None, dense):
        np.testing.assert_array_equal(
            troi.paste_back(initial, lv, key, rois, valid,
                            fallback_labels=fallback),
            jroi.paste_back(initial, lv, key, rois, valid,
                            fallback_labels=fallback))
    fb = troi.paste_back(initial, lv, key, rois, valid, fallback_labels=dense)
    assert (fb[dense == 1] > 0).all()


@pytest.mark.parametrize("in_size,out_size", [(224, 37), (224, 480),
                                              (32, 9), (5, 224)])
def test_nearest_index_legacy_matches_jax(in_size, out_size):
    np.testing.assert_array_equal(
        tresize._nearest_index_legacy(in_size, out_size),
        jresize._nearest_index_legacy(in_size, out_size))


@pytest.mark.parametrize("case", ["sparse", "no_zero", "beyond_max_id"])
def test_dense_relabel_matches_jax(case):
    rng = np.random.RandomState(4)
    if case == "sparse":
        lab = rng.choice([0, 2, 11, 19], size=(24, 30)).astype(np.int32)
    elif case == "no_zero":
        # id 0 absent: the smallest present id (3) becomes 0
        lab = rng.choice([3, 7, 8], size=(24, 30)).astype(np.int32)
    else:
        lab = rng.choice([0, 4, 20, 25], size=(24, 30)).astype(np.int32)
    want = np.asarray(jax_dense_relabel(jnp.asarray(lab), max_id=20))
    got = troi._dense_relabel(torch.from_numpy(lab), max_id=20)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "no_zero":
        assert sorted(np.unique(want)) == [0, 1, 2]
        np.testing.assert_array_equal(got.numpy() == 0, lab == 3)


def test_filter_labels_boxes_matches_jax():
    lab = random_labels(5, k=8)
    boxes = np.array([[3.7, 2.2, 30.9, 20.0], [0, 0, 0, 0],
                      [25, 10, 60, 40]], np.float32)
    want = np.asarray(jroi.filter_labels_boxes(jnp.asarray(lab),
                                               jnp.asarray(boxes), 0.5,
                                               max_labels=16))
    got = troi.filter_labels_boxes(torch.from_numpy(lab),
                                   torch.from_numpy(boxes), 0.5,
                                   max_labels=16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) < len(np.unique(lab))
