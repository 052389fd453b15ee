"""Widths below and between the kernels' instantiations and up to 256 seeds:
the shapes the JAX package's Pallas kernels take (they pad d to a multiple
of 8 and m to 8 or 128), against the port on the same numpy inputs (CPU).

On a CPU tensor every kernel wrapper runs its plain version, so these hold
the plain versions, the references the kernels are held against on the
card, to the JAX package's Pallas kernels in interpret mode, at widths 16,
32 and 96 (run on the card at 64, 64 and 128 with zero columns) and 10, 20,
200 and 256 seeds (past 128 the card runs the hill climb in groups, the
connected components on an instantiation of 8-word masks and the assignment
in two passes), phase by phase and as the whole clustering in both modes.
Then what the card relies on, exactly: the plain phases give the same bits
on zero-padded X and Z as on the unpadded ones, the plain hill climb of a
group of seeds gives the same rows as the climb of all of them, and the
assignment's per-pixel summary (best score, its label, best score of
another label) of two seed sets merges into that of their union.

Inputs: unit embeddings around k centres (k = 6 for 10 and 20 seeds; 200
for 200 and 256, so that the seeds land in well-separated clusters and the
runs with 256 seeds label more than 128 of them).

Tolerances: seed indices, seed labels, pixel labels and counts equal; Z
within 1e-5 at float32 and 2e-2 at bfloat16 (Z and W round to bf16 inside
every iteration); the exactness tests bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch.ops import _build
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_torch.ops import mean_shift as tms
from unseenobjectclustering_tpu.ops import mean_shift as jms
from unseenobjectclustering_tpu.ops import pallas_mean_shift as jpms
from unseenobjectclustering_tpu.ops.pallas_seeding import select_seeds_pallas

torch.set_num_threads(1)

N = 4096  # stride-8 seeding keeps 512 candidates for 256 seeds
WIDTHS = [16, 32, 96]
SEEDS = [10, 20, 200, 256]
DTYPES = ["float32", "bfloat16"]
Z_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def clustered(seed, d, m, n=N, noise=0.15):
    """[n, d] float32 unit embeddings around 6 centres (200 when m > 128)
    and an [n] validity mask under which cluster 1 is mostly invalid."""
    rng = np.random.RandomState(seed)
    k = 200 if m > 128 else 6
    centers = rng.randn(k, d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    prob = np.full(k, 1.0)
    prob[1] = 0.4
    assign = rng.choice(k, size=n, p=prob / prob.sum())
    x = centers[assign] + noise * rng.randn(n, d) / np.sqrt(d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    z_valid = rng.rand(n) > 0.05
    z_valid[assign == 1] = rng.rand(int((assign == 1).sum())) > 0.7
    return x.astype(np.float32), z_valid


def both(x, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        TORCH_DT[dtype])


def start(x, m, first):
    """m float32 start seeds, the farthest-point picks from pixel `first`
    (as the route picks them: one seed in each cluster before a second)."""
    seeds, _ = cuda_seeding.select_seeds_reference(torch.from_numpy(x), m,
                                                   first)
    return seeds.numpy()


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    yield
    assert cuda_seeding.launches == 0
    assert cms.hill_climb_launches == 0
    assert cms.connected_components_launches == 0
    assert cms.assign_labels_launches == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", SEEDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_seeding_matches_pallas(d, m, dtype):
    xj, xt = both(clustered(1, d, m)[0], dtype)
    _, want = select_seeds_pallas(xj, m, jnp.int32(7))
    seeds, got = cuda_seeding.select_seeds(xt, m, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert seeds.shape == (m, d)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", SEEDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_hill_climb_matches_pallas(d, m, dtype):
    x, _ = clustered(2, d, m)
    xj, xt = both(x, dtype)
    z0 = start(x, m, 3)
    want = jpms.hill_climb_pallas(xj, jnp.asarray(z0), kappa=20.0,
                                  max_iters=10)
    got = cms.hill_climb(xt, torch.from_numpy(z0), kappa=20.0, max_iters=10)
    assert got.dtype == torch.float32 and got.shape == (m, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=Z_ATOL[dtype])


@pytest.mark.parametrize("m", SEEDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_connected_components_matches_pallas(d, m):
    x, _ = clustered(4, d, m)
    z = np.array(jpms.hill_climb_pallas(jnp.asarray(x),
                                        jnp.asarray(start(x, m, 5))))
    want = np.asarray(jpms.connected_components_pallas(jnp.asarray(z), 0.04))
    got = cms.connected_components(torch.from_numpy(z), 0.04)
    np.testing.assert_array_equal(got.numpy(), want)
    if m > 128:
        # the labels above 128: the 8-word masks' upper half
        assert len(np.unique(want)) > 128


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", SEEDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_assign_labels_matches_pallas(d, m, dtype):
    x, z_valid = clustered(6, d, m)
    xj, xt = both(x, dtype)
    z = np.array(jpms.hill_climb_pallas(xj, jnp.asarray(start(x, m, 7))))
    slab = np.array(jpms.connected_components_pallas(jnp.asarray(z), 0.04))
    want = jpms.assign_labels_pallas(xj, jnp.asarray(z), jnp.asarray(slab),
                                     z_valid=jnp.asarray(z_valid))
    got = cms.assign_labels(xt, torch.from_numpy(z), torch.from_numpy(slab),
                            z_valid=torch.from_numpy(z_valid))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if m > 128:
        assert len(np.unique(got[0].numpy())) > 128


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", SEEDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_mean_shift_smart_init_matches_pallas_route(d, m, dtype):
    """The whole kernel route, float32 with stride-1 seeding or bf16 with
    stride-8 seeding, with the fused 0.8 depth filter: seeds, seed labels
    and labels equal to the JAX use_pallas=True route, Z within the
    tolerance."""
    x, z_valid = clustered(8, d, m)
    kw = dict(kappa=20.0, num_seeds=m, max_iters=10, epsilon=0.04,
              metric="cosine", use_pallas=True, first_index=3,
              seed_subsample=1 if dtype == "float32" else 8,
              compute_dtype=dtype, filter_threshold=0.8)
    want = jms.mean_shift_smart_init(jnp.asarray(x), jax.random.PRNGKey(0),
                                     z_valid=jnp.asarray(z_valid), **kw)
    got = tms.mean_shift_smart_init(torch.from_numpy(x),
                                    z_valid=torch.from_numpy(z_valid), **kw)
    for name in ("seed_indices", "seed_labels", "labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.seeds.numpy(), np.asarray(want.seeds),
                               atol=Z_ATOL[dtype])
    assert got.seeds.shape == (m, d)
    if m > 128:
        assert len(np.unique(got.seed_labels.numpy())) > 128


def pad(t, width):
    return _build.pad_columns(t, width)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [20, 256])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_phases_on_zero_padded_inputs_equal_unpadded(d, m, dtype):
    """What the card's padding relies on: each plain phase on X and Z with
    zero columns up to the kernel width gives bitwise the unpadded result
    (seeds, Z with its padded columns 0, seed labels, labels and
    counts)."""
    x, z_valid = clustered(10, d, m)
    xt = torch.from_numpy(x).to(TORCH_DT[dtype])
    width = _build.kernel_width("test", d)
    xp = pad(xt, width)
    assert xp.shape == (N, width) and torch.equal(xp[:, :d], xt)
    _, idx = cuda_seeding.select_seeds_reference(xt, m, 9)
    _, idx_p = cuda_seeding.select_seeds_reference(xp, m, 9)
    assert torch.equal(idx, idx_p)
    z0 = torch.from_numpy(start(x, m, 11))
    z = cms.hill_climb_reference(xt, z0)
    z_p = cms.hill_climb_reference(xp, pad(z0, width))
    assert torch.equal(z_p[:, :d], z) and not z_p[:, d:].any()
    slab = cms.connected_components_reference(z, 0.04)
    assert torch.equal(cms.connected_components_reference(z_p, 0.04), slab)
    zv = torch.from_numpy(z_valid)
    for g, w in zip(cms.assign_labels_reference(xp, z_p, slab, zv),
                    cms.assign_labels_reference(xt, z, slab, zv)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [129, 200, 256])
def test_plain_hill_climb_per_seed_group_equals_the_whole(m, dtype):
    """What the card's seed groups rely on: a row of Z depends only on X
    and its own start, so climbing each of the wrapper's groups alone
    gives bitwise the rows of climbing all m together."""
    x, _ = clustered(12, 32, m)
    xt = torch.from_numpy(x).to(TORCH_DT[dtype])
    z0 = torch.from_numpy(start(x, m, 13))
    whole = cms.hill_climb_reference(xt, z0)
    groups, rows = cms.hill_climb_groups(m)
    assert (groups, rows) == (2, -(-m // 2))
    parts = [cms.hill_climb_reference(xt, z0[g * rows:(g + 1) * rows])
             for g in range(groups)]
    assert torch.equal(torch.cat(parts), whole)


def test_hill_climb_groups():
    """One launch up to 128 seeds; past it groups of equal rows."""
    for m in (1, 64, 65, 100, 128):
        assert cms.hill_climb_groups(m) == (1, m)
    for m, rows in ((129, 65), (200, 100), (255, 128), (256, 128)):
        assert cms.hill_climb_groups(m) == (2, rows)


def test_pad_columns():
    """Zero columns appended as a new contiguous tensor; a tensor already
    at the width comes back as itself."""
    x = torch.randn(5, 3, dtype=torch.bfloat16)
    p = _build.pad_columns(x, 64)
    assert p.shape == (5, 64) and p.dtype == x.dtype and p.is_contiguous()
    assert torch.equal(p[:, :3], x) and not p[:, 3:].any()
    y = torch.randn(5, 64)
    assert _build.pad_columns(y, 64) is y


def best(scores, labels):
    """Per pixel (b1, l1, b2) over the seeds' scores [n, m]: the best score,
    the label of the first seed that attains it, and the best score among
    seeds of another label (-inf if none): the summary each assignment
    pass keeps."""
    b1, first = scores.max(dim=1)
    l1 = labels[first]
    other = torch.where(labels[None, :] != l1[:, None], scores,
                        torch.tensor(-float("inf")))
    return b1, l1, other.max(dim=1).values


def merge_best(r, o):
    """The kernels' merge_best: r and o over disjoint seed sets; the larger
    b1 wins (r's on a tie); b2 takes the loser's b2 where the labels agree,
    its b1 where they differ."""
    (b1, l1, b2), (ob1, ol1, ob2) = r, o
    other = ob1 > b1
    loser = torch.where(ol1 == l1, torch.where(other, b2, ob2),
                        torch.where(other, b1, ob1))
    return (torch.where(other, ob1, b1), torch.where(other, ol1, l1),
            torch.maximum(torch.where(other, ob2, b2), loser))


@pytest.mark.parametrize("m", [129, 200, 256])
@pytest.mark.parametrize("labelled", ["each_its_own", "few", "halves_share"])
def test_two_pass_best_merges_into_the_whole(m, labelled):
    """What the card's two-pass assignment relies on: pass 1's summary over
    seeds [0, 128) merged with pass 2's over [128, m) gives the one-pass
    summary over all m (b1 and b2 exactly, and l1 wherever b1 beats b2;
    where they tie the kernel re-checks the pixel against every seed),
    with scores rounded to a coarse grid so that ties within and across
    the passes are common."""
    rng = np.random.RandomState(m)
    n = 4000
    scores = torch.from_numpy(np.round(rng.rand(n, m) * 64) / 64)
    labels = torch.from_numpy({
        "each_its_own": np.arange(m),
        "few": rng.randint(0, 5, size=m),
        "halves_share": np.arange(m) % 128}[labelled])
    b1, l1, b2 = best(scores, labels)
    g1, gl1, g2 = merge_best(best(scores[:, :128], labels[:128]),
                             best(scores[:, 128:], labels[128:]))
    assert torch.equal(g1, b1) and torch.equal(g2, b2)
    apart = b1 > b2
    assert torch.equal(gl1[apart], l1[apart])
    assert (~apart).any() and apart.any()


def test_assign_passes_and_prepare():
    """One assignment launch up to 128 seeds, two past it (to 256); prepare
    pads X once to the kernel width and raises past 256 dims or 512 seeds
    (tests/test_torch_wide256.py takes the shapes between)."""
    assert [cms.assign_passes(m) for m in (1, 128, 129, 256)] == [1, 1, 2, 2]
    x = torch.randn(7, 32)
    p = cms.prepare(x, 256)
    assert p.shape == (7, 64) and torch.equal(p[:, :32], x)
    assert cms.prepare(p, 100) is p
    for shape, m in (((7, 257), 100), ((7, 32), 513)):
        with pytest.raises(ValueError):
            cms.prepare(torch.zeros(shape), m)
