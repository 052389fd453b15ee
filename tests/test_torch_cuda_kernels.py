"""The port's CUDA kernels against their plain versions on the card.

chip_smoke.py holds each kernel to its plain version at the stage-1 shapes
(n = 480*640, d = 64, m = 100; phase 2c at d = 128).  These tests cover
the other shapes each kernel takes: m from 1 to 128 (ragged against the
hill climb's 16-row groups and the assignment's two 64-seed products), a
ragged last pixel tile, fewer pixels than one tile or one block's threads
and more than the blocks hold on chip, a strided seeding view, rows that
do not start on a 16-byte boundary, the assignment's exact re-check of
near-ties between labels, and hand-built seeds for the connected
components (every seed its own cluster, one ball, an overwrite of labeled
neighbours, a mode tie, pairs just inside and outside epsilon), and the
four kernels at width 128 (the RGB-D cat fusion's embeddings: each
kernel's second instantiation) across m, ragged and many tiles, a strided
seeding view, misaligned rows and the crop shape, the seeding kernel's
lazy tiles at width 128 (the frame's clustered and random inputs, random
inputs certified free of near-ties on which the picks must be exact, an
exact tie planted across two tiles, 1 and 128 seeds, a strided view, n
either side of the plan's switch to them, and a 1920x1080 frame, past
the lazy tiles' limit in float32), and the assignment and
the whole clustering route with no depth mask at the frame's 480*640
pixels (a COLOR frame's stage 1).  The connected components run each
case at both widths (cc_kernel<64>, and cc_cluster_kernel at d = 128; the
merge steps held to the plain merge's; the d = 128 kernel also against
the d = 64 one on zero-padded seeds), and the width-128 assignment's
cases run in both types (assign_tf32_wide_kernel and
assign_bf16_wide_kernel).  One 480x640 frame goes through stage 1 of the
full-depth ResNet-50-8s network in each mode, every kernel launched.
They need a CUDA device and skip without one.  On the machine with the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q

(``--noconftest``: tests/conftest.py imports JAX, which the port does not
need.)  Inputs are clustered unit embeddings made with numpy from a seed.

Tolerances: seed indices (up to a near-tie at the crop shape:
assert_same_seeds), seed labels, pixel labels and counts equal;
converged seeds Z within 1e-5 at float32 and 1e-3 at bfloat16 (summation
order; at bf16 a sum that lands on the other side of a bf16 rounding
boundary moves one weight by one bf16 step).
"""

import numpy as np
import pytest
import torch

from unseenobjectclustering_torch.config import FAST_CLUSTER, Config
from unseenobjectclustering_torch.engine.pipeline import Segmentor
from unseenobjectclustering_torch.models import get_network
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_torch.ops.mean_shift import mean_shift_smart_init
from unseenobjectclustering_torch.ops.preprocess import preprocess_rgbd

pytestmark = pytest.mark.cuda

Z_ATOL = {torch.float32: 1e-5, torch.bfloat16: 1e-3}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def clustered(n, d, seed=0, k=7):
    """[n, d] float32 unit embeddings around k centers, and an [n] validity
    mask under which cluster 1 is mostly invalid (numpy)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    prob = np.full(k, 1.0)
    prob[0] = 4.0
    assign = rng.choice(k, size=n, p=prob / prob.sum())
    x = centers[assign] + 0.2 * rng.randn(n, d) / np.sqrt(d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    z_valid = rng.rand(n) > 0.05
    z_valid[assign == 1] = rng.rand(int((assign == 1).sum())) > 0.7
    return x.astype(np.float32), z_valid


def on_card(card, x, dtype, misaligned=False):
    """x on the card; misaligned: a view whose rows start 2 elements past a
    16-byte boundary."""
    t = torch.from_numpy(x).to(card).to(dtype)
    if not misaligned:
        return t
    flat = torch.empty(t.numel() + 2, dtype=dtype, device=card)
    view = flat[2:].view(t.shape)
    view.copy_(t)
    return view


def converged(card, x, m, seed=1):
    """m float32 seeds, hill-climbed by the plain version."""
    pick = np.random.RandomState(seed).choice(x.shape[0], m, replace=False)
    return cms.hill_climb_reference(x, x[torch.from_numpy(pick).to(card)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,stride", [
    (100, 1),      # fewer pixels than one block's threads
    (1000, 1),
    (4099, 1),
    (6001, 3),     # a strided view
    (2000, 1),
    (400000, 1),   # more than the blocks hold on chip: part re-read from L2
])
def test_seeding_kernel_matches_plain(card, dtype, n, stride):
    x = on_card(card, clustered(n * stride, 64)[0], dtype)[::stride]
    before = cuda_seeding.launches
    seeds, idx = cuda_seeding.select_seeds(x, 40, 5)
    want_seeds, want_idx = cuda_seeding.select_seeds_reference(x, 40, 5)
    assert cuda_seeding.launches == before + 1
    assert idx.dtype == torch.int32 and seeds.dtype == dtype
    assert torch.equal(idx, want_idx)
    assert torch.equal(seeds, want_seeds)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("num_seeds", [1, 128])
def test_seeding_kernel_seed_counts(card, dtype, num_seeds):
    x = on_card(card, clustered(30000, 64, seed=7)[0], dtype)
    _, idx = cuda_seeding.select_seeds(x, num_seeds, 29999)
    _, want_idx = cuda_seeding.select_seeds_reference(x, num_seeds, 29999)
    assert idx.shape == (num_seeds,) and torch.equal(idx, want_idx)


def test_launch_configs_fit_the_card(card):
    """Both cooperative kernels: every block resident at once, and the
    seeding blocks hold their X on chip up to the shared-memory limit.  The
    assignment: two warpgroups per block, every block resident at once."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    x = torch.zeros(480 * 640, 64, device=card)
    seed = cuda_seeding.launch_config(x)
    assert seed["grid"] == sms and seed["blocks_per_sm"] >= 1
    assert 0 < seed["x_on_chip_bytes"] < seed["pixels_per_block"] * 64 * 4
    # float32: two warpgroups of 64 rows; bfloat16: two halves of 7 groups
    # of 16 rows each, not 8
    for dtype, threads in zip(DTYPES, (2 * 128, 2 * 7 * 32)):
        hill = cms.hill_climb_config(x.to(dtype), 100)
        assert hill["threads"] == threads
        assert 1 <= hill["grid"] <= hill["blocks_per_sm"] * sms
        assign = cms.assign_labels_config(x.to(dtype), 100)
        assert assign["threads"] == 256 and assign["blocks_per_sm"] >= 1
        assert assign["grid"] == assign["blocks_per_sm"] * sms
        assert assign["x_on_chip_bytes"] < assign["smem_bytes"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 20, 100, 113, 128])
@pytest.mark.parametrize("misaligned", [False, True])
def test_hill_climb_kernel_matches_plain(card, dtype, m, misaligned):
    d = 64
    x = on_card(card, clustered(3000, d, seed=2)[0], dtype, misaligned)
    pick = np.random.RandomState(3).choice(3000, m, replace=False)
    z0 = x[torch.from_numpy(pick).to(card)].float()
    before = cms.hill_climb_launches
    got = cms.hill_climb(x, z0, kappa=20.0, max_iters=10)
    want = cms.hill_climb_reference(x, z0, kappa=20.0, max_iters=10)
    assert cms.hill_climb_launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, d)
    assert float((got - want).abs().max()) <= Z_ATOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_hill_climb_kernel_many_tiles(card, dtype):
    """Many 128-pixel tiles per block and a ragged last one (n = 70001)."""
    x = on_card(card, clustered(70001, 64, seed=8)[0], dtype)
    pick = np.random.RandomState(9).choice(70001, 100, replace=False)
    z0 = x[torch.from_numpy(pick).to(card)].float()
    got = cms.hill_climb(x, z0, kappa=20.0, max_iters=10)
    want = cms.hill_climb_reference(x, z0, kappa=20.0, max_iters=10)
    assert float((got - want).abs().max()) <= Z_ATOL[dtype]


def plain_merge_steps(z, eps):
    """The plain merge's steps: the seeds still unlabeled when their turn
    comes (the order-dependent loop of ops/mean_shift.connected_components
    on the same adjacency)."""
    zz = z.float()
    adj = (0.5 * (1.0 - zz @ zz.T) <= eps).cpu().numpy()
    labeled = np.zeros(len(adj), bool)
    steps = 0
    for i in range(len(adj)):
        if not labeled[i]:
            steps += 1
            labeled |= adj[i]
    return steps


def cc_both(z, eps=0.04):
    """The kernel's labels and merge steps, held equal to the plain
    version's."""
    before = cms.connected_components_launches
    got = cms.connected_components(z, eps)
    assert cms.connected_components_launches == before + 1
    steps = int(cms.connected_components_steps)
    want = cms.connected_components_reference(z, eps)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert steps == plain_merge_steps(z, eps)
    return got.tolist(), steps


def unit(card, z):
    z = z / np.linalg.norm(z, axis=1, keepdims=True)
    return torch.from_numpy(z.astype(np.float32)).to(card)


def on_arc(degrees, d=64):
    """Points at these angles on the great circle through e0 and e1: two
    are in each other's 0.04-ball below 23.07 degrees apart."""
    t = np.radians(np.asarray(degrees, np.float64))
    z = np.zeros((len(t), d))
    z[:, 0], z[:, 1] = np.cos(t), np.sin(t)
    return z


def off_arc(count, seed, d=64):
    """Random directions orthogonal to e0 and e1, each far from the arc and
    from each other."""
    z = np.random.RandomState(seed).randn(count, d)
    z[:, :2] = 0.0
    return z


# Each case at both widths: cc_kernel<64> (one block), cc_cluster_kernel
# at d = 128 (a cluster of CTAs, each computing its share of the
# adjacency's items; at m = 100 the 28 items over 8 CTAs, 3 or 4 each).
WIDTHS = [pytest.param(64, id="d64"), pytest.param(128, id="d128")]


# m across the kernel's 32-seed words (1, 31/32/33, 64/65, 127/128) and
# across the cluster's share of items (m <= 32: at most 4 items, some CTAs
# without one; 33: 6 items; 64, 65: 12 and 15; 100, 128: 28 and 40 items,
# up to 5 a CTA)
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("m", [1, 20, 31, 32, 33, 64, 65, 100, 127, 128])
def test_connected_components_kernel_matches_plain(card, m, width):
    x = on_card(card, clustered(4000, width, seed=4)[0], torch.float32)
    labels, _ = cc_both(converged(card, x, m))
    if m >= 20:
        assert max(labels) > 0  # more than one cluster


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("m", [1, 33, 65, 100, 127, 128])
def test_connected_components_kernel_pairwise_far(card, m, width):
    """Every seed its own cluster: a merge step per seed, the most."""
    z = unit(card, np.random.RandomState(m).randn(m, width))
    labels, steps = cc_both(z)
    assert labels == list(range(m)) and steps == m


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("m", [1, 31, 33, 65, 100, 128])
def test_connected_components_kernel_one_ball(card, m, width):
    """Every pair in one epsilon-ball: every bit of the adjacency set, one
    step."""
    rng = np.random.RandomState(m)
    z = unit(card, rng.randn(width) + 0.05 * rng.randn(m, width) / 8.0)
    labels, steps = cc_both(z)
    assert labels == [0] * m and steps == 1


@pytest.mark.parametrize("width", WIDTHS)
def test_connected_components_kernel_overwrites_labeled_neighbours(card,
                                                                   width):
    """Seed 0 (0 deg) labels 15 deg with 0; seed 1 (60 deg) labels 40 and
    45 deg with 1; seed 2 (30 deg) is unlabeled, sees label 0 once and
    label 1 twice, and moves 15 deg to label 1.  34 far seeds follow."""
    z = unit(card, np.concatenate([on_arc([0, 60, 30, 15, 40, 45], width),
                                   off_arc(34, seed=3, d=width)]))
    labels, steps = cc_both(z)
    assert labels[:6] == [0, 1, 1, 1, 1, 1]
    assert labels[6:] == list(range(2, 36)) and steps == 3 + 34


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("degrees", [[0, 60, 30, 10, 50], [60, 0, 30, 50, 10]])
def test_connected_components_kernel_mode_tie_takes_smallest(card, degrees,
                                                             width):
    """Seed 2 (30 deg) sees labels 0 and 1 once each: it and all its
    neighbours take 0, the smaller, whichever side label 0 is on."""
    z = unit(card, np.concatenate([on_arc(degrees, width),
                                   off_arc(20, seed=5, d=width)]))
    labels, steps = cc_both(z)
    assert labels[:5] == [0, 1, 0, 0, 0] and steps == 3 + 20


@pytest.mark.parametrize("m", [1, 33, 100, 128])
def test_connected_components_width_128_is_width_64_padded(card, m):
    """The d = 128 cluster kernel on seeds whose last 64 dims are 0 has the
    d = 64 kernel's adjacency bit for bit (each chain's last 64 FMAs add
    0 exactly): the same labels and merge steps, on clustered seeds and
    on pairwise-far ones."""
    x = on_card(card, clustered(4000, 64, seed=8)[0], torch.float32)
    for z in (converged(card, x, m),
              unit(card, np.random.RandomState(m).randn(m, 64))):
        wide = torch.cat([z, torch.zeros_like(z)], dim=1)
        assert cc_both(wide) == cc_both(z)


def test_connected_components_launch_shape(card):
    """d = 64: cc_kernel<64>, one block; d = 128: cc_cluster_kernel, a
    cluster of 8 CTAs (the portable most) of 512 threads; the adjacency's
    items (cc_kernel's: 32 x 32 tiles on or above the diagonal, 8 rows an
    item) and no CTA staging more rows of Z than there are seeds."""
    for m, items in ((1, 1), (33, 6), (65, 15), (100, 28), (128, 40)):
        for d, name, ctas in ((64, "cc_kernel<64>", 1),
                              (128, "cc_cluster_kernel", 8)):
            plan = cms.connected_components_config(
                torch.zeros(m, d, device=card))
            assert plan["kernel"] == name and plan["ctas"] == ctas
            assert plan["threads"] == 512 and plan["items"] == items
            assert plan["smem_bytes"] == 4 * 128 * (d + 4)
            assert 1 <= plan["rows_staged"] <= m


@pytest.mark.parametrize("width", WIDTHS)
def test_connected_components_kernel_at_epsilon(card, width):
    """16 pairs, each in a plane of its own, at a distance eps (1 -/+
    2.5e-4): within their ball (one label) or just outside it (two).  A
    random rotation makes every dot a full-width chain; its rounding
    (about 1e-7) is far below the 1e-5 margin."""
    eps, d = 0.04, width
    pairs = []
    for k in range(16):
        dist = eps * (1.0 + (-2.5e-4 if k % 2 == 0 else 2.5e-4))
        c = 1.0 - 2.0 * dist
        a, b = np.zeros(d), np.zeros(d)
        a[2 * k] = 1.0
        b[2 * k], b[2 * k + 1] = c, np.sqrt(1.0 - c * c)
        pairs += [a, b]
    rot, _ = np.linalg.qr(np.random.RandomState(6).randn(d, d))
    labels, steps = cc_both(unit(card, np.stack(pairs) @ rot), eps)
    for k in range(16):
        same = labels[2 * k] == labels[2 * k + 1]
        assert same == (k % 2 == 0), k
    assert steps == 8 * 1 + 8 * 2


def assign_both(x, z, slab, zv=None):
    """The kernel's and the plain version's (labels, counts, valid_counts),
    and the kernel's count of re-checked pixels."""
    before = cms.assign_labels_launches
    got = cms.assign_labels(x, z, slab, z_valid=zv)
    assert cms.assign_labels_launches == before + 1
    rechecked = int(cms.assign_labels_rechecked)
    want = cms.assign_labels_reference(x, z, slab, z_valid=zv)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return got, rechecked


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 20, 64, 65, 100, 113, 128])
@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("misaligned", [False, True])
def test_assign_kernel_matches_plain(card, dtype, m, with_valid, misaligned):
    xf, z_valid = clustered(5000, 64, seed=5)
    x = on_card(card, xf, dtype, misaligned)
    z = converged(card, x.float(), m)
    slab = cms.connected_components_reference(z, 0.04)
    zv = torch.from_numpy(z_valid).to(card) if with_valid else None
    assign_both(x, z, slab, zv)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [
    100,       # below one 128-pixel tile
    5001,      # ragged against the tile
    300001,    # many tiles per block, ragged
])
def test_assign_kernel_pixel_counts(card, dtype, n):
    xf, z_valid = clustered(n, 64, seed=10)
    x = on_card(card, xf, dtype)
    z = converged(card, x.float(), 100)
    slab = cms.connected_components_reference(z, 0.04)
    assign_both(x, z, slab, torch.from_numpy(z_valid).to(card))


def assert_same_seeds(x, got, want, gap=1e-6):
    """The kernel's seed indices equal the plain version's up to a near-tie.
    The kernel sums each dot product as one sequential float32 FMA chain,
    the plain version on the card through cuBLAS, so two pixels whose
    min-distances lie within a float32 rounding of a 64-term sum may come
    out in either order: at the first step where the two differ (if any),
    their picks' min-distances to the seeds before them (in float64) are
    within `gap`, and every earlier step is equal."""
    diff = (got != want).nonzero()
    if diff.numel() == 0:
        return
    k = int(diff[0, 0])
    xd = x.double()
    md = torch.full((x.shape[0],), float("inf"), dtype=torch.float64,
                    device=x.device)
    for j in want[:k].long():
        md = torch.minimum(md, 0.5 * (1.0 - xd @ xd[j]))
    assert abs(float(md[want[k].long()] - md[got[k].long()])) <= gap, k


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 8])
def test_kernels_at_the_crop_shape(card, dtype, stride):
    """Stage 2 runs all four kernels once per valid 224x224 crop: n =
    50,176 pixels, seeded at stride 1 (6,272 pixels at stride 8), m = 100;
    each kernel against its plain version on the plain version's inputs
    (the seeds up to a near-tie, which this input has at stride 1)."""
    x = on_card(card, clustered(224 * 224, 64, seed=14)[0], dtype)
    x_seed = x[::stride]
    _, idx = cuda_seeding.select_seeds(x_seed, 100, 17)
    want_seeds, want_idx = cuda_seeding.select_seeds_reference(x_seed, 100,
                                                               17)
    assert_same_seeds(x_seed, idx, want_idx)
    z0 = want_seeds.float()
    got_z = cms.hill_climb(x, z0, kappa=20.0, max_iters=10)
    want_z = cms.hill_climb_reference(x, z0, kappa=20.0, max_iters=10)
    assert float((got_z - want_z).abs().max()) <= Z_ATOL[dtype]
    labels, _ = cc_both(want_z)
    assert max(labels) > 0
    slab = torch.tensor(labels, dtype=torch.int32, device=card)
    assign_both(x, want_z, slab)


@pytest.mark.parametrize("dtype", DTYPES)
def test_assign_kernel_exact_tie_between_labels(card, dtype):
    """Seed 5 is an exact copy of seed 2 under another label: the pixels
    nearest to them tie exactly, are re-checked, and take seed 2's label
    (the lower index), as the plain version's argmax does."""
    xf, _ = clustered(5000, 64, seed=11)
    x = on_card(card, xf, dtype)
    pick = np.random.RandomState(13).choice(5000, 20, replace=False)
    z = x[torch.from_numpy(pick).to(card)].float()
    z[5] = z[2]
    slab = torch.arange(20, dtype=torch.int32, device=card)
    (labels, _, _), rechecked = assign_both(x, z, slab)
    assert rechecked > 0
    assert int((labels == 2).sum()) > 0 and int((labels == 5).sum()) == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_assign_kernel_one_label_rechecks_nothing(card, dtype):
    xf, z_valid = clustered(5000, 64, seed=12)
    x = on_card(card, xf, dtype)
    z = converged(card, x.float(), 100)
    slab = torch.zeros(100, dtype=torch.int32, device=card)
    (labels, counts, _), rechecked = assign_both(
        x, z, slab, torch.from_numpy(z_valid).to(card))
    assert rechecked == 0
    assert int(labels.abs().sum()) == 0 and float(counts[0]) == 5000.0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("subsample", [1, 8])
def test_kernel_route_on_card_matches_it_on_cpu(card, compute_dtype,
                                                subsample):
    """mean_shift_smart_init with the fused 0.8 depth filter: the kernels on
    the card give the labels that the plain versions give on the CPU."""
    xf, z_valid = clustered(48 * 64, 64, seed=6)
    kw = dict(num_seeds=50, first_index=9, seed_subsample=subsample,
              compute_dtype=compute_dtype, filter_threshold=0.8)
    got = mean_shift_smart_init(torch.from_numpy(xf).to(card),
                                z_valid=torch.from_numpy(z_valid).to(card),
                                **kw)
    want = mean_shift_smart_init(torch.from_numpy(xf),
                                 z_valid=torch.from_numpy(z_valid), **kw)
    for name in ("seed_indices", "seed_labels", "labels"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))
    assert len(torch.unique(want.labels)) > 2


FRAME = 480 * 640


@pytest.mark.parametrize("dtype", DTYPES)
def test_assign_kernel_without_a_mask_at_the_frame(card, dtype):
    """The COLOR recipes cluster stage 1 without the depth filter, so the
    assignment takes no z_valid at the frame's n = 480*640 pixels: labels
    and counts equal the plain version's, and the valid counts are the
    counts."""
    x = on_card(card, clustered(FRAME, 64, seed=40, k=12)[0], dtype)
    z = converged(card, x.float(), 100)
    slab = cms.connected_components_reference(z, 0.04)
    assert int(slab.max()) > 0
    (labels, counts, valid), _ = assign_both(x, z, slab)
    assert torch.equal(valid, counts) and float(counts.sum()) == FRAME


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_unfiltered_route_at_the_frame_matches_plain(card, compute_dtype):
    """mean_shift_smart_init without z_valid and with filter_threshold 0 (a
    COLOR frame's stage 1) at n = 480*640, parity (stride-1 seeding) and
    fast (bf16, stride 8): the kernel route's seeds and labels equal the
    plain route's on the card."""
    x = torch.from_numpy(clustered(FRAME, 64, seed=41, k=12)[0]).to(card)
    sub = 1 if compute_dtype == "float32" else 8
    kw = dict(num_seeds=100, first_index=777 % -(-FRAME // sub),
              seed_subsample=sub, compute_dtype=compute_dtype,
              filter_threshold=0.0)
    before = cms.assign_labels_launches
    got = mean_shift_smart_init(x, use_pallas=True, **kw)
    assert cms.assign_labels_launches == before + 1
    want = mean_shift_smart_init(x, use_pallas=False, **kw)
    for name in ("seed_indices", "seed_labels", "labels"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert len(torch.unique(want.labels)) > 2


def test_wrappers_raise_on_what_the_kernels_do_not_take(card, monkeypatch):
    x = torch.randn(256, 64, device=card)
    slab = torch.zeros(4, dtype=torch.int32, device=card)
    with monkeypatch.context() as patch:
        # x as if it lay on a device other than the current one
        patch.setattr(torch.cuda, "current_device",
                      lambda: x.get_device() + 1)
        for call in (lambda: cuda_seeding.select_seeds(x, 4, 0),
                     lambda: cms.hill_climb(x, x[:4]),
                     lambda: cms.connected_components(x[:4], 0.04),
                     lambda: cms.assign_labels(x, x[:4], slab)):
            with pytest.raises(ValueError, match="current device"):
                call()
    with pytest.raises(TypeError):
        cuda_seeding.select_seeds(x.half(), 4, 0)
    with pytest.raises(ValueError):
        cuda_seeding.select_seeds(x, 4, 256)
    with pytest.raises(ValueError, match="width 64 or 128"):
        cuda_seeding.select_seeds(x[:, :32], 4, 0)
    with pytest.raises(ValueError):
        cms.hill_climb(x, torch.randn(129, 64, device=card))
    with pytest.raises(ValueError):
        cms.hill_climb(x[:, :32], x[:4, :32])
    with pytest.raises(ValueError, match="width 64 or 128"):
        cms.connected_components(torch.randn(8, 96, device=card), 0.04)
    with pytest.raises(ValueError):
        cms.assign_labels(x[:, :32], x[:4, :32],
                          torch.zeros(4, dtype=torch.int32, device=card))
    with pytest.raises(ValueError):
        cms.assign_labels(x, x[:4], torch.zeros(4, dtype=torch.int32))


# -- width 128: the RGB-D cat fusion's 2 * NUM_UNITS --------------------------

WIDE = 128


def test_launch_configs_at_width_128(card):
    """The width-128 instantiations at the frame: seeding 256 threads a
    block, every SM, X held on chip; the float32 hill climb's two consumer
    warpgroups and one producer warpgroup, one block an SM, with Z's small
    part (64 KB), two stages of a 32-pixel tile's four split copies, two
    raw tiles in flight and the stages' four mbarriers (230,432 bytes of
    shared memory), nothing kept on chip across iterations; the bf16 hill
    climb's two consumer warpgroups and one producer warpgroup, one block
    an SM, with a 1 KB alignment margin, a ring of five and eight resident
    64-pixel tiles of 16 KB, the reduction's 4 KB and 18 mbarriers
    (218,256 bytes), each block keeping 8 tiles for the whole launch
    (22% of X at the frame, all of it at both crops); the float32
    assignment (assign_tf32_wide_kernel) two consumer warpgroups and one
    producer warpgroup, one block an SM, a ring of three 64-pixel tiles of
    32 KB and Z's split copies (128 KB); the bf16 assignment
    (assign_bf16_wide_kernel) three consumer warpgroups that claim
    64-pixel tiles of a producer warp's ring of six (16 KB each), one block
    an SM, and bf16(Z) (32 KB); every block resident at once."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    x = torch.zeros(480 * 640, WIDE, device=card)
    seed = cuda_seeding.launch_config(x)
    assert seed["threads"] == 256 and seed["grid"] == sms
    assert 0 < seed["x_on_chip_bytes"] < seed["pixels_per_block"] * WIDE * 4
    for dtype in DTYPES:
        hill = cms.hill_climb_config(x.to(dtype), 100)
        assert hill["threads"] == 3 * 128
        assert cms.hill_climb_config(x.to(dtype), 64)["threads"] == 2 * 128
        assert hill["smem_bytes"] <= 232448
        assert hill["blocks_per_sm"] == 1 and hill["grid"] == sms
        if dtype == torch.float32:
            assert hill["smem_bytes"] == (4 * (128 * WIDE + 2 * 4 * 32 * WIDE
                                               + 2 * 32 * (WIDE + 4))
                                          + 8 * 4)
            assert hill["x_on_chip_bytes"] == 4 * (2 + 2 * 4) * 32 * WIDE
            assert hill["x_resident_bytes"] == 0
        else:
            tile = 64 * WIDE * 2
            assert hill["smem_bytes"] == (1024 + (5 + 8) * tile + 4 * 8 * WIDE
                                          + 8 * (2 * 5 + 8))
            assert hill["x_on_chip_bytes"] == (5 + 8) * tile
            # every block holds 36 or 37 tiles at the frame, 8 of them kept
            assert hill["x_resident_bytes"] == sms * 8 * tile
            for side in (224, 128):  # 6 or 2 tiles a block: all kept
                crop = x[:side * side].to(dtype)
                plan = cms.hill_climb_config(crop, 100)
                assert plan["grid"] == sms
                assert plan["x_resident_bytes"] == side * side * WIDE * 2
        assign = cms.assign_labels_config(x.to(dtype), 100)
        assert assign["threads"] == WIDE_THREADS[dtype]
        assert assign["blocks_per_sm"] == 1 and assign["grid"] == sms
        assert assign["x_on_chip_bytes"] < assign["smem_bytes"]
        assert assign["tile_pixels"] == 64
        if dtype == torch.float32:
            assert assign["stages"] == 3
            assert assign["x_on_chip_bytes"] == 3 * 64 * WIDE * 4
            assert assign["smem_bytes"] == (1024 + 3 * 64 * WIDE * 4
                                            + 2 * 4 * 128 * WIDE
                                            + 3 * 4 * 128 + 8 * 9)
        else:
            assert assign["stages"] == 6
            assert assign["x_on_chip_bytes"] == 6 * 64 * WIDE * 2
            assert assign["smem_bytes"] == (1024 + 6 * 64 * WIDE * 2
                                            + 2 * 128 * WIDE
                                            + 3 * 4 * 128 + 4 * 8 + 8 * 12)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,stride", [
    (100, 1),      # fewer pixels than one block's threads
    (6001, 3),     # a strided view
    (400000, 1),   # more than the blocks hold on chip
])
def test_seeding_kernel_at_width_128(card, dtype, n, stride):
    x = on_card(card, clustered(n * stride, WIDE, seed=31)[0],
                dtype)[::stride]
    seeds, idx = cuda_seeding.select_seeds(x, 40, 5)
    want_seeds, want_idx = cuda_seeding.select_seeds_reference(x, 40, 5)
    assert_same_seeds(x, idx, want_idx)
    assert seeds.shape == (40, WIDE) and seeds.dtype == dtype


def units(n, d, seed):
    """[n, d] random unit vectors (numpy float32)."""
    x = np.random.RandomState(seed).randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def shaped(card, n, dtype):
    """An [n, WIDE] view of one row on the card: the shape a plan reads."""
    return torch.zeros(1, WIDE, dtype=dtype, device=card).expand(n, WIDE)


def lazy_tiles(plan, n):
    """The lazy tiles of all blocks for n pixels under `plan`."""
    on_chip = plan["pixels_per_block"] - plan["reread_pixels_per_block"]
    length, tile = plan["pixels_per_block"], plan["tile_pixels"]
    return sum(-(-max(0, min(length, n - b * length) - on_chip) // tile)
               for b in range(plan["grid"]))


def seed_lazily(x, num_seeds, first):
    """The kernel on x (which must take the lazy path) against its plain
    version; returns the kernel's indices and its refresh counts."""
    plan = cuda_seeding.launch_config(x)
    assert plan["lazy"] == 1 and plan["tile_pixels"] == 32
    before = cuda_seeding.launches
    seeds, idx = cuda_seeding.select_seeds(x, num_seeds, first)
    want_seeds, want_idx = cuda_seeding.select_seeds_reference(
        x, num_seeds, first)
    assert cuda_seeding.launches == before + 1
    assert idx.shape == (num_seeds,) and seeds.dtype == x.dtype
    assert_same_seeds(x, idx, want_idx)
    counts = cuda_seeding.refreshed
    assert counts.shape == (num_seeds - 1,)
    if num_seeds > 1:  # every tile at step 0, no more later
        assert int(counts[0]) == lazy_tiles(plan, x.shape[0])
        assert int(counts.max()) == int(counts[0])
    return idx, counts


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["clustered", "uniform"])
def test_seeding_lazy_tiles_at_the_frame(card, dtype, kind):
    """The parity frame's shape at width 128 (n = 480*640, m = 100):
    clustered embeddings and random unit vectors; most tiles are skipped
    at most steps on both."""
    xf = (clustered(FRAME, WIDE, seed=42)[0] if kind == "clustered"
          else units(FRAME, WIDE, 43))
    _, counts = seed_lazily(on_card(card, xf, dtype), 100, 12345)
    mean, _ = cuda_seeding.refresh_shares(counts)
    assert 0.0 < mean < 0.5


def float64_picks(x, num_seeds, first):
    """The float64 replay of farthest-point seeding on x: its picks, and
    the least gap over its steps between the two largest min-distances."""
    x64 = x.double()
    md = 0.5 * (1.0 - x64 @ x64[first])
    picks, least = [first], float("inf")
    for _ in range(1, num_seeds):
        top = torch.topk(md, 2)
        least = min(least, float(top.values[0] - top.values[1]))
        picks.append(int(top.indices[0]))
        md = torch.minimum(md, 0.5 * (1.0 - x64 @ x64[picks[-1]]))
    return picks, least


@pytest.mark.parametrize("dtype", DTYPES)
def test_seeding_lazy_tiles_exact_without_near_ties(card, dtype):
    """Random unit vectors at the frame whose float64 replay keeps its two
    largest min-distances at least 1e-6 apart at every step (certified
    here): no float32 rounding of a dot can part two picks, so the lazy
    kernel's indices equal the plain version's and the replay's, with no
    slack; a stale bound or a skipped catch-up would show."""
    x = on_card(card, units(FRAME, WIDE, 51), dtype)
    picks, least = float64_picks(x, 100, 12345)
    assert least >= 1e-6
    idx, _ = seed_lazily(x, 100, 12345)
    want = cuda_seeding.select_seeds_reference(x, 100, 12345)[1]
    assert idx.tolist() == want.tolist() == picks


@pytest.mark.parametrize("dtype", DTYPES)
def test_seeding_lazy_planted_tie_across_tiles(card, dtype):
    """u, equally near four orthonormal centers, sits at i and j, the first
    pixels of block 0's and block 1's first lazy tiles (filled with copies
    of the first seed, in cluster 0): once every cluster has a seed, u at i
    and at j tie exactly and the lower index, i, must win."""
    k, n = 4, FRAME
    rng = np.random.RandomState(44)
    centers = np.linalg.qr(rng.randn(WIDE, k))[0].T
    x = centers[rng.choice(k, size=n)] + 0.3 * rng.randn(n, WIDE) / np.sqrt(
        WIDE)
    plan = cuda_seeding.launch_config(shaped(card, n, dtype))
    length = plan["pixels_per_block"]
    i = length - plan["reread_pixels_per_block"]
    j = length + i
    first = 7
    x[first] = centers[0] + 0.3 * rng.randn(WIDE) / np.sqrt(WIDE)
    for lo in (i, j):
        x[lo:lo + 32] = x[first]
    x[i] = x[j] = centers.sum(0)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    idx, _ = seed_lazily(on_card(card, x.astype(np.float32), dtype), 40,
                         first)
    assert int(idx[k]) == i and j not in idx.tolist()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("num_seeds", [1, 128])
def test_seeding_lazy_seed_counts(card, dtype, num_seeds):
    x = on_card(card, clustered(FRAME, WIDE, seed=45)[0], dtype)
    idx, _ = seed_lazily(x, num_seeds, FRAME - 1)
    assert int(idx[0]) == FRAME - 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_seeding_lazy_strided_view(card, dtype):
    x = on_card(card, clustered(2 * FRAME, WIDE, seed=46)[0], dtype)[::2]
    seed_lazily(x, 100, 5)


def lazy_switch(card, dtype):
    """The least n for which the width-128 plan takes the lazy path."""
    lo, hi = 132 * 256, FRAME  # eager at lo, lazy at hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lazy = cuda_seeding.launch_config(shaped(card, mid, dtype))["lazy"]
        lo, hi = (lo, mid) if lazy else (mid, hi)
    return hi


@pytest.mark.parametrize("dtype", DTYPES)
def test_seeding_either_side_of_the_lazy_switch(card, dtype):
    """One pixel below the switch every pixel is on chip (the eager
    kernel); at it a block has one or two pixels off chip, in one short
    lazy tile."""
    n = lazy_switch(card, dtype)
    x = on_card(card, clustered(n, WIDE, seed=47)[0], dtype)
    below = x[:n - 1]
    plan = cuda_seeding.launch_config(below)
    assert plan["lazy"] == 0 and plan["reread_pixels_per_block"] == 0
    _, idx = cuda_seeding.select_seeds(below, 100, 3)
    assert_same_seeds(below, idx,
                      cuda_seeding.select_seeds_reference(below, 100, 3)[1])
    assert cuda_seeding.refreshed is None
    seed_lazily(x, 100, 3)


@pytest.mark.parametrize("dtype", DTYPES)
def test_seeding_at_width_128_past_the_lazy_limit(card, dtype):
    """A 1920x1080 frame at width 128: in float32 a block's lazy tiles
    would not fit beside its min-distances in shared memory, so the plan
    takes the eager kernel, which re-reads its off-chip pixels; in
    bfloat16 the lazy one.  Both seed as the plain version does."""
    n = 1920 * 1080
    x = on_card(card, clustered(n, WIDE, seed=48)[0], dtype)
    plan = cuda_seeding.launch_config(x)
    assert plan["reread_pixels_per_block"] > 0
    assert plan["lazy"] == (dtype == torch.bfloat16)
    if plan["lazy"]:
        seed_lazily(x, 100, 5)
        return
    _, idx = cuda_seeding.select_seeds(x, 100, 5)
    assert_same_seeds(x, idx,
                      cuda_seeding.select_seeds_reference(x, 100, 5)[1])
    assert cuda_seeding.refreshed is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", [
    (100, 20), (3001, 1), (3001, 65), (70001, 100), (20000, 128),
    (1, 1),                 # one pixel: one block of one ragged tile
    (33, 33),               # two blocks, the second's tile of one pixel
    (32 * 132 + 17, 64),    # one tile a block but block 0's two, ragged
    (32 * 132 * 3, 100),    # three tiles a block: iterations start on
                            # either ring slot and stage
    (128 * 128, 65),        # the 128^2 crop: about 4 tiles a block
    (224 * 224 + 9, 100),   # about 12 tiles a block, ragged
    (480 * 640 - 3, 128),   # the frame: 73 tiles a block, ragged
    # against the bf16 kernel's 64-pixel tiles: 8 kept on chip a block,
    # the rest streamed through a ring of five stages
    (64 * 100 + 5, 100),          # fewer tiles than SMs, the last ragged
    (64 * 132 * 8, 64),           # 8 tiles a block, all kept, none streamed
    (64 * (132 * 8 + 5) + 3, 1),  # 6 blocks stream one tile, the rest none
    (64 * 132 * 11 + 17, 65),     # 3 or 4 streamed a block: iterations
    (64 * 132 * 10 + 192, 128),   # start on every stage (3 and 2 streamed)
])
@pytest.mark.parametrize("misaligned", [False, True])
def test_hill_climb_kernel_at_width_128(card, dtype, n, m, misaligned):
    """Ragged against the float32 kernel's 32-pixel tiles (loaded two ahead
    into a ring of two, split one ahead into two stages) and the bf16
    kernel's 64-pixel tiles (8 a block kept in shared memory for the whole
    launch, the rest streamed through a ring of five stages, in turn up
    and down); m = 1 to 128 (one and two warpgroups, 64 and 65 either
    side); a block with one tile, with a few and with many; blocks that
    keep every tile and blocks that stream some."""
    x = on_card(card, clustered(n, WIDE, seed=32)[0], dtype, misaligned)
    pick = np.random.RandomState(33).choice(n, m, replace=False)
    z0 = x[torch.from_numpy(pick).to(card)].float()
    before = cms.hill_climb_launches
    got = cms.hill_climb(x, z0, kappa=20.0, max_iters=10)
    want = cms.hill_climb_reference(x, z0, kappa=20.0, max_iters=10)
    assert cms.hill_climb_launches == before + 1
    assert got.shape == (m, WIDE)
    assert float((got - want).abs().max()) <= Z_ATOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_hill_climb_kernel_is_deterministic_at_width_128(card, dtype):
    """At the 224^2 crop the blocks' partials are summed in a fixed order:
    two runs on the same input give bitwise the same Z."""
    n, m = 224 * 224, 100
    x = on_card(card, clustered(n, WIDE, seed=35)[0], dtype)
    pick = np.random.RandomState(36).choice(n, m, replace=False)
    z0 = x[torch.from_numpy(pick).to(card)].float()
    first = cms.hill_climb(x, z0, kappa=20.0, max_iters=10)
    assert torch.equal(first, cms.hill_climb(x, z0, kappa=20.0,
                                             max_iters=10))
    want = cms.hill_climb_reference(x, z0, kappa=20.0, max_iters=10)
    assert float((first - want).abs().max()) <= Z_ATOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,m", [(100, 20), (5001, 64), (5001, 65),
                                 (300001, 100), (5001, 128)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_assign_kernel_at_width_128(card, dtype, n, m, misaligned):
    xf, z_valid = clustered(n, WIDE, seed=37)
    x = on_card(card, xf, dtype, misaligned)
    z = converged(card, x.float(), m)
    slab = cms.connected_components_reference(z, 0.04)
    (_, counts, _), _ = assign_both(x, z, slab,
                                    torch.from_numpy(z_valid).to(card))
    assert float(counts.sum()) == n


@pytest.mark.parametrize("dtype", DTYPES)
def test_assign_kernel_exact_tie_at_width_128(card, dtype):
    xf, _ = clustered(5000, WIDE, seed=38)
    x = on_card(card, xf, dtype)
    pick = np.random.RandomState(39).choice(5000, 20, replace=False)
    z = x[torch.from_numpy(pick).to(card)].float()
    z[5] = z[2]
    slab = torch.arange(20, dtype=torch.int32, device=card)
    (labels, _, _), rechecked = assign_both(x, z, slab)
    assert rechecked > 0
    assert int((labels == 2).sum()) > 0 and int((labels == 5).sum()) == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("stride", [1, 8])
def test_kernels_at_the_crop_shape_width_128(card, dtype, stride):
    """Stage 2 with a cat crop network: n = 224*224, m = 100, each kernel
    against its plain version on the plain version's inputs."""
    x = on_card(card, clustered(224 * 224, WIDE, seed=40)[0], dtype)
    x_seed = x[::stride]
    _, idx = cuda_seeding.select_seeds(x_seed, 100, 17)
    want_seeds, want_idx = cuda_seeding.select_seeds_reference(x_seed, 100,
                                                               17)
    assert_same_seeds(x_seed, idx, want_idx)
    z0 = want_seeds.float()
    got_z = cms.hill_climb(x, z0, kappa=20.0, max_iters=10)
    want_z = cms.hill_climb_reference(x, z0, kappa=20.0, max_iters=10)
    assert float((got_z - want_z).abs().max()) <= Z_ATOL[dtype]
    labels, _ = cc_both(want_z)
    assert max(labels) > 0
    slab = torch.tensor(labels, dtype=torch.int32, device=card)
    assign_both(x, want_z, slab)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("subsample", [1, 8])
def test_kernel_route_at_width_128_matches_it_on_cpu(card, compute_dtype,
                                                     subsample):
    xf, z_valid = clustered(48 * 64, WIDE, seed=41)
    kw = dict(num_seeds=50, first_index=9, seed_subsample=subsample,
              compute_dtype=compute_dtype, filter_threshold=0.8)
    got = mean_shift_smart_init(torch.from_numpy(xf).to(card),
                                z_valid=torch.from_numpy(z_valid).to(card),
                                **kw)
    want = mean_shift_smart_init(torch.from_numpy(xf),
                                 z_valid=torch.from_numpy(z_valid), **kw)
    for name in ("seed_indices", "seed_labels", "labels"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name))


# The assignment at width 128: assign_tf32_wide_kernel (float32) and
# assign_bf16_wide_kernel (bfloat16): 64-pixel tiles loaded by TMA into a
# ring by a producer, consumed by two warpgroups in turns (float32: three
# stages of 32 KB) or by three warpgroups that claim the block's tiles in
# order (bf16: six stages of 16 KB).
WIDE_KERNELS = {torch.float32: "assign_tf32_wide_kernel",
                torch.bfloat16: "assign_bf16_wide_kernel"}
# two consumer warpgroups and a producer warpgroup; three consumer
# warpgroups and a producer warp
WIDE_THREADS = {torch.float32: 3 * 128, torch.bfloat16: 3 * 128 + 32}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 64 * 132, 224 * 224, FRAME])
def test_assign_wide_kernel_launch_shape(card, n, dtype):
    """Threads, stages and shared bytes from assign_labels_config: 384
    threads (float32) or 416 (bf16), at least three stages, at most 227 KB
    of shared memory, one block an SM and at most one block a tile; the
    104-column kernel up to 104 seeds, the 128-column one above."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    x = torch.zeros(n, WIDE, device=card, dtype=dtype)
    plan = cms.assign_labels_config(x, 100)
    assert plan["threads"] == WIDE_THREADS[dtype] and plan["stages"] >= 3
    assert plan["smem_bytes"] <= 232448 and plan["blocks_per_sm"] == 1
    assert plan["grid"] == min(sms, -(-n // plan["tile_pixels"]))
    for m, cols in ((1, 104), (100, 104), (104, 104), (105, 128), (128, 128)):
        assert (cms.assign_labels_config(x, m)["kernel"]
                == f"{WIDE_KERNELS[dtype]}<{cols}>")


def wide_seeds(card, m, seed):
    """m float32 seeds hill-climbed from pixels of a 5000-pixel draw around
    the centers of clustered(., WIDE, seed), and their labels."""
    pool = torch.from_numpy(clustered(5000, WIDE, seed=seed)[0]).to(card)
    z = converged(card, pool, m)
    return z, cms.connected_components_reference(z, 0.04)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 63, 64, 65, 129, 5001, 224 * 224, FRAME])
@pytest.mark.parametrize("m", [1, 64, 65, 100, 104, 105, 128])
def test_assign_wide_kernel_shapes(card, n, m, dtype):
    """Pixels from one to the frame (n ragged against the 64-pixel tile)
    against 1 to 128 seeds (the 104- and the 128-column kernel either
    side of their switch), with a depth mask: labels and both histograms
    equal to the plain version's."""
    xf, z_valid = clustered(n, WIDE, seed=50)
    z, slab = wide_seeds(card, m, 50)
    (_, counts, _), _ = assign_both(
        torch.from_numpy(xf).to(card).to(dtype), z, slab,
        torch.from_numpy(z_valid).to(card))
    assert float(counts.sum()) == n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [129, 5001, FRAME])
@pytest.mark.parametrize("misaligned", [False, True])
def test_assign_wide_kernel_without_a_mask(card, n, misaligned, dtype):
    """No z_valid (a COLOR frame), rows on and off a 16-byte boundary (the
    wrapper copies rows off it, as the TMA map needs an aligned base): the
    valid counts are the counts."""
    xf, _ = clustered(n, WIDE, seed=51)
    x = on_card(card, xf, dtype, misaligned)
    z, slab = wide_seeds(card, 100, 51)
    (_, counts, valid), _ = assign_both(x, z, slab)
    assert torch.equal(valid, counts) and float(counts.sum()) == n


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [5001, 224 * 224])
def test_assign_wide_kernel_exact_tie(card, n, dtype):
    """Seed 5 an exact copy of seed 2 under another label: the pixels
    nearest to them are re-checked and take seed 2's label."""
    xf, _ = clustered(n, WIDE, seed=52)
    x = torch.from_numpy(xf).to(card).to(dtype)
    pick = np.random.RandomState(53).choice(n, 20, replace=False)
    z = x[torch.from_numpy(pick).to(card)].float()
    z[5] = z[2]
    slab = torch.arange(20, dtype=torch.int32, device=card)
    (labels, _, _), rechecked = assign_both(x, z, slab)
    assert rechecked > 0
    assert int((labels == 2).sum()) > 0 and int((labels == 5).sum()) == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [5001, 224 * 224, FRAME])
def test_assign_wide_kernel_rechecks_many_pixels(card, n, dtype):
    """Seeds in pairs under distinct labels, seed 2k + 1 seed 2k scaled by
    1 + 2e-5: a pixel's two best scores differ by 2e-5 times its score,
    inside the re-check margin and far above float32 rounding, so most
    pixels are re-checked, and the exact re-check gives the plain
    version's labels.  In bfloat16 seed 2k + 1 is a copy of seed 2k (a
    2e-5 scaling vanishes in bf16(Z) but where it crosses a rounding
    boundary, and there it moves a score by far more than the margin):
    every pixel's two best labels tie exactly, and the re-check gives the
    lower index, as the plain version's argmax does."""
    xf, z_valid = clustered(n, WIDE, seed=54)
    rng = np.random.RandomState(55)
    z = xf[rng.choice(n, 100, replace=n < 100)].astype(np.float64)
    z[1::2] = z[0::2] * (1.0 + (2e-5 if dtype == torch.float32 else 0.0))
    slab = torch.arange(100, dtype=torch.int32, device=card)
    _, rechecked = assign_both(
        torch.from_numpy(xf).to(card).to(dtype),
        torch.from_numpy(z.astype(np.float32)).to(card), slab,
        torch.from_numpy(z_valid).to(card))
    assert rechecked > n // 2


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_resnet50_frame_launches_every_kernel(card, mode):
    """Stage 1 of seg_resnet50_8s_embedding (two dilated ResNet-50 towers,
    RGB-D add, 64 units, a fixed-seed init) on one 480x640 frame made with
    numpy from a seed, through Segmentor.segment_sample: finite unit
    embeddings, labels of shape (1, 480, 640) within the seed ids, and
    each of the four kernels launched once."""
    h, w = 480, 640
    cfg = Config.inference_default(INPUT="RGBD")
    torch.manual_seed(50)
    state = get_network("seg_resnet50_8s_embedding", cfg).state_dict()
    fast = mode == "fast"
    seg = Segmentor(cfg.replace(CLUSTER=dict(FAST_CLUSTER)) if fast else cfg,
                    state, network_name="seg_resnet50_8s_embedding",
                    model_dtype=torch.bfloat16 if fast else None,
                    device=card)
    rng = np.random.RandomState(50)
    bgr = np.full((h, w, 3), 100, np.uint8)
    depth = np.tile(np.linspace(1.5, 0.9, h, dtype=np.float32)[:, None],
                    (1, w))
    for _ in range(6):
        y, x = rng.randint(40, h - 120), rng.randint(40, w - 160)
        bgr[y:y + 80, x:x + 120] = rng.randint(0, 256, size=3)
        depth[y:y + 80, x:x + 120] -= rng.uniform(0.05, 0.3)
    depth[rng.rand(h, w) < 0.02] = 0.0
    img, xyz = preprocess_rgbd(torch.from_numpy(bgr).to(card),
                               torch.from_numpy(depth).to(card),
                               cfg.pixel_means, 615.0, 615.0, w / 2.0,
                               h / 2.0)
    cuda_seeding.launches = cms.hill_climb_launches = 0
    cms.connected_components_launches = cms.assign_labels_launches = 0
    res = seg.segment_sample({"image_color": img, "depth": xyz},
                             return_features=True)
    assert (cuda_seeding.launches, cms.hill_climb_launches,
            cms.connected_components_launches,
            cms.assign_labels_launches) == (1, 1, 1, 1)
    f = res.features
    assert f.shape == (1, h, w, 64) and np.isfinite(f).all()
    np.testing.assert_allclose(np.linalg.norm(f, axis=-1), 1.0, atol=1e-3)
    assert res.labels.shape == (1, h, w) and res.labels.dtype == np.int32
    assert 0 <= res.labels.min() and res.labels.max() <= 100
