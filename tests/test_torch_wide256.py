"""Widths 129..256 and up to 512 seeds: the shapes the JAX package's Pallas
kernels take past 128 dims and 256 seeds (they pad d to a multiple of 8 and
m to 8 or 128), against the port on the same numpy inputs (CPU).

On a CPU tensor every kernel wrapper runs its plain version, so these hold
the plain versions, the references the kernels are held against on the
card, to the JAX package's Pallas kernels in interpret mode, at widths 160
and 256 (run on the card at 256, 160 with zero columns) and 100, 300 and
512 seeds (at d = 256 the card climbs groups of at most 64 seeds and
assigns on the exact FMA chain; past 256 seeds, at every width, it runs
the connected components on 16-word masks, and below d = 256 the
assignment in a pass per 128 seeds), phase by phase and as the whole
clustering in both modes with the depth filter.  Then what the
card relies on, exactly: the kernels' sequential fp32 FMA chains (the
seeding's, the connected components' and the assignment's dots, and the
width-256 hill climb's chunked S) give the same bits on X and Z zero-padded
to 256 columns as on the unpadded ones, emulated (fmaf(0, 0, acc) = acc).
The plain versions on the CPU do not: torch's CPU matmul blocks its sums
by the shapes (at 160 and 256 columns, and at 64 and 300 rows, the same
rows round apart), so the card's kernels are held to the plain versions
on the unpadded inputs, within the tolerances below.

Inputs: unit embeddings around k centres (12 for 100 seeds; 400 past 256,
so that the seeds land in well-separated clusters and the runs with 512
seeds label more than 256 of them; the whole route past 256 seeds takes
600, so that every pick opens a cluster and none sits at a float32
near-tie, see the seeding's tolerance below).

Tolerances: seed indices, seed labels, pixel labels and counts equal; Z
within 1e-5 at float32 and 2e-2 at bfloat16 (Z and W round to bf16 inside
every iteration); the exactness tests bitwise.  The seeding alone is held
equal up to a float32 near-tie: past 400 clusters its last picks fall
between pixels whose min-distances differ by about 1e-8, where the JAX
kernel's sums and torch's round apart, so at the first step where the two
differ (if any) the picks' float64 min-distances must lie within
SEED_GAP = 1e-6 (chip_smoke.py's limit), and every earlier pick is equal.
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

N = 4096  # stride-8 seeding keeps 512 candidates for 512 seeds
WIDTHS = [160, 256]
SEEDS = [100, 300, 512]
DTYPES = ["float32", "bfloat16"]
Z_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEED_GAP = 1e-6


def clustered(seed, d, m, n=N, noise=0.15, k=None):
    """[n, d] float32 unit embeddings around k centres (by default 12, 400
    when m > 256) and an [n] validity mask under which cluster 1 is mostly
    invalid."""
    rng = np.random.RandomState(seed)
    k = k or (400 if m > 256 else 12)
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
    """m float32 start seeds, the farthest-point picks from pixel `first`."""
    seeds, _ = cuda_seeding.select_seeds_reference(torch.from_numpy(x), m,
                                                   first)
    return seeds.numpy()


def assert_same_picks(x, got, want):
    """Seed indices equal, up to a float32 near-tie: at the first step
    where they differ, the two picks' float64 min-distances to the seeds
    before it lie within SEED_GAP."""
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return
    k = int(diff[0])
    xd = x.double()
    md = torch.full((x.shape[0],), float("inf"), dtype=torch.float64)
    for j in want[:k]:
        md = torch.minimum(md, 0.5 * (1.0 - xd @ xd[int(j)]))
    assert k > 0 and abs(float(md[int(want[k])] - md[int(got[k])])) \
        < SEED_GAP, k


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
    assert_same_picks(xt, got.numpy(), np.asarray(want))
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
    if m > 256:
        # labels past 255: the 16-bit key of the mode
        assert len(np.unique(want)) > 256


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
    if m > 256:
        assert len(np.unique(got[0].numpy())) > 256


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", SEEDS)
@pytest.mark.parametrize("d", WIDTHS)
def test_mean_shift_smart_init_matches_pallas_route(d, m, dtype):
    """The whole kernel route, float32 with stride-1 seeding or bf16 with
    stride-8 seeding, with the fused 0.8 depth filter: seeds, seed labels
    and labels equal to the JAX use_pallas=True route, Z within the
    tolerance."""
    x, z_valid = clustered(8, d, m, k=600 if m > 256 else None)
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
    if m > 256:
        assert len(np.unique(got.seed_labels.numpy())) > 256


def fma32(a, b, c):
    """fmaf on float32 values held in float64 tensors (the product exact,
    the sum rounded to float32; see tests/test_torch_hill_wide.py)."""
    return (a * b + c).to(torch.float32).to(torch.float64)


def chain(x, z, chunk=None):
    """[n, m] dots of x's rows with z's as the kernels take them: one
    sequential fp32 FMA chain over the columns from 0 (the seeding, the
    connected components and the assignment), or (chunk) chains of
    `chunk` columns, each from 0, added in order in float32 (the width-256
    hill climb's S)."""
    xd, zd = x.double(), z.double()
    tot = torch.zeros(x.shape[0], z.shape[0], dtype=torch.float32)
    step = chunk or x.shape[1]
    for c in range(0, x.shape[1], step):
        part = torch.zeros(x.shape[0], z.shape[0], dtype=torch.float64)
        for j in range(c, min(c + step, x.shape[1])):
            part = fma32(xd[:, j:j + 1], zd[None, :, j], part)
        tot = tot + part.to(torch.float32)
    return tot


@pytest.mark.parametrize("d", [129, 160, 200])
def test_kernel_chains_on_zero_padded_inputs_equal_unpadded(d):
    """What the card's padding to 256 relies on: every dot the kernels take
    of X and Z comes out bitwise the same with zero columns appended up to
    256, as one chain and as the hill climb's chains of 32 (a chunk of
    zeros adds +0.0), so a kernel at 256 computes the unpadded d-wide
    clustering.  bf16 X widens exactly and is covered by the same chains."""
    x, _ = clustered(10, d, 100, n=512)
    xt = torch.from_numpy(x)
    z = xt[:64]
    width = _build.kernel_width("test", d)
    assert width == 256
    xp, zp = _build.pad_columns(xt, width), _build.pad_columns(z, width)
    assert torch.equal(chain(xp, zp), chain(xt, z))
    assert torch.equal(chain(xp, zp, 32), chain(xt, z, 32))


def test_launch_counts_at_the_new_shapes():
    """The launches a clustering makes past 128 dims or 256 seeds: the hill
    climb one per group of at most 64 seeds at d = 256 (of at most 128
    below), the assignment once at d = 256 (assign_exact_kernel) and once
    per 128 seeds below; prepare pads X to 256 and raises past 256 dims or
    512 seeds."""
    for m, d, groups in ((1, 256, 1), (64, 256, 1), (65, 256, 2),
                         (100, 160, 2), (512, 256, 8), (300, 64, 3),
                         (512, 128, 4)):
        assert cms.hill_climb_groups(m, d)[0] == groups
    assert [cms.assign_passes(m, 256) for m in (1, 129, 256, 512)] == [1] * 4
    assert [cms.assign_passes(m, 64) for m in (128, 129, 256, 257, 384, 385,
                                               512)] == [1, 2, 2, 3, 3, 4, 4]
    x = torch.randn(7, 160)
    p = cms.prepare(x, 512)
    assert p.shape == (7, 256) and torch.equal(p[:, :160], x)
    for shape, m in (((7, 257), 100), ((7, 160), 513)):
        with pytest.raises(ValueError):
            cms.prepare(torch.zeros(shape), m)


def best(scores, labels):
    """Per pixel (b1, l1, b2) over the seeds' scores [n, m]: the best score,
    the label of the first seed that attains it, and the best score among
    seeds of another label (-inf if none): the summary each assignment
    pass keeps."""
    b1, first = scores.max(dim=1)
    l1 = labels[first]
    other = torch.where(labels[None, :] != l1[:, None], scores,
                        torch.tensor(-float("inf"), dtype=scores.dtype))
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


@pytest.mark.parametrize("m", [257, 300, 384, 385, 512])
@pytest.mark.parametrize("labelled", ["each_its_own", "few", "groups_share"])
def test_passes_best_merges_into_the_whole(m, labelled):
    """What the assignment's 3 or 4 passes past 256 seeds rely on: the
    first pass's summary over seeds [0, 128), merged in turn with each
    middle pass's over the next 128 and the last pass's over the rest,
    gives the one-pass summary over all m (b1 and b2 exactly, and l1
    wherever b1 beats b2; where they tie the kernel re-checks the pixel
    against every seed), with scores rounded to a coarse grid so that ties
    within and across the passes are common."""
    rng = np.random.RandomState(m)
    n = 4000
    scores = torch.from_numpy(np.round(rng.rand(n, m) * 64) / 64)
    labels = torch.from_numpy({
        "each_its_own": np.arange(m),
        "few": rng.randint(0, 5, size=m),
        "groups_share": np.arange(m) % 128}[labelled])
    b1, l1, b2 = best(scores, labels)
    bounds = list(range(0, m, 128)) + [m]
    assert len(bounds) - 1 == cms.assign_passes(m, 64) >= 3
    got = best(scores[:, :128], labels[:128])
    for lo, hi in zip(bounds[1:-1], bounds[2:]):
        got = merge_best(got, best(scores[:, lo:hi], labels[lo:hi]))
    g1, gl1, g2 = got
    assert torch.equal(g1, b1) and torch.equal(g2, b2)
    apart = b1 > b2
    assert torch.equal(gl1[apart], l1[apart])
    assert (~apart).any() and apart.any()
