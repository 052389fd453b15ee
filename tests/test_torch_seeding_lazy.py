"""The seeding kernel's lazy schedule, modelled in torch, against the eager
plain version and the JAX package's seeding routes (CPU, small shapes).

At width 128, where a block's pixels do not all fit on chip, the kernel
(csrc/seeding.cu) keeps the pixels past the on-chip ones in tiles with
stale bounds and refreshes only the tiles that could hold the next argmax.
``cuda_seeding.select_seeds_lazy_reference`` replays that schedule (per-block
tiles, block-local thresholds, catch-up in seed order); here it runs at
widths 64 and 128, float32 and bfloat16, over several tile sizes, block
counts and on-chip counts.

Tolerances: seed indices equal, with no tolerance, to the eager plain
version, to ``select_seeds_pallas`` (interpret mode) and to JAX's
``select_smart_seeds_lazy``.  The inputs are certified free of float32
near-ties: at every step the float64 replay's two largest min-distances are
at least TIE_GAP apart (chip_smoke.py's SEED_GAP, below which the card's
checks certify a seed flip as a float32 near-tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch.ops import cuda_seeding
from unseenobjectclustering_tpu.ops.mean_shift import select_smart_seeds_lazy
from unseenobjectclustering_tpu.ops.pallas_seeding import select_seeds_pallas

torch.set_num_threads(1)

N, M, FIRST = 3072, 40, 7
TIE_GAP = 1e-6
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (pixels a tile, blocks, on-chip pixels a block, seeds kept on chip): the
# kernel's own tile and ring with few and many blocks, small and large
# tiles, no on-chip pixel, a block whose pixels are all on chip but for one
# short tile, and short rings (a tile that misses that many seeds is
# refreshed)
SCHEDULES = [(32, 4, 256, 64), (32, 11, 100, 32), (8, 7, 50, 5),
             (64, 3, 0, 64), (128, 2, 700, 2), (16, 1, 3060, 1)]


def clustered(seed, d, n=N, k=6):
    """[n, d] unit embeddings around k centers (numpy float32)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.choice(k, size=n)] + 0.2 * rng.randn(n, d) / np.sqrt(d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def uniform(seed, d, n=N):
    """[n, d] random unit vectors (numpy float32)."""
    x = np.random.RandomState(seed).randn(n, d)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def both(x, dtype):
    """The same values as a JAX array and a torch tensor of `dtype`."""
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        TORCH_DT[dtype])


def eager(xt):
    return cuda_seeding.select_seeds_reference(xt, M, FIRST)[1]


def assert_tie_free(xt, idx):
    """The float64 replay of the picks `idx` has its two largest
    min-distances at least TIE_GAP apart at every step, and picks the
    larger."""
    x64 = xt.double()
    md = 0.5 * (1.0 - x64 @ x64[int(idx[0])])
    for k in range(1, len(idx)):
        top = torch.topk(md, 2)
        assert int(top.indices[0]) == int(idx[k]), k
        assert float(top.values[0] - top.values[1]) >= TIE_GAP, k
        md = torch.minimum(md, 0.5 * (1.0 - x64 @ x64[int(idx[k])]))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile,blocks,on_chip,ring", SCHEDULES)
def test_lazy_schedule_matches_eager(d, dtype, tile, blocks, on_chip, ring):
    _, xt = both(clustered(d + 1, d), dtype)
    want = eager(xt)
    seeds, got, counts = cuda_seeding.select_seeds_lazy_reference(
        xt, M, FIRST, tile, blocks, on_chip, ring)
    assert torch.equal(got, want)
    assert got.dtype == torch.int32 and seeds.dtype == xt.dtype
    assert torch.equal(seeds, xt[want.long()])
    # step 0 refreshes every tile; later steps no more than that
    assert counts.shape == (M - 1,)
    assert int(counts.max()) == int(counts[0])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lazy_schedule_matches_pallas(d, dtype):
    xj, xt = both(clustered(d + 2, d), dtype)
    _, want = select_seeds_pallas(xj, M, jnp.int32(FIRST))
    _, got, _ = cuda_seeding.select_seeds_lazy_reference(xt, M, FIRST, 32,
                                                         4, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# clustered inputs free of near-ties at TIE_GAP (seeds d + 3 and d + 4
# have one below it at some widths and types), by width and type
TIE_FREE = {(64, "float32"): 67, (64, "bfloat16"): 69,
            (128, "float32"): 132, (128, "bfloat16"): 131}


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("make", ["clustered", "uniform"])
def test_lazy_schedule_matches_jax_lazy(d, dtype, make):
    """JAX's route for an X that does not fit on chip: blocks of 256
    pixels with stale bounds, refreshed one at a time against the global
    best, distances from blocked matrix products."""
    x = (clustered(TIE_FREE[d, dtype], d) if make == "clustered"
         else uniform(d + 3, d))
    xj, xt = both(x, dtype)
    _, want = select_smart_seeds_lazy(xj, M, jax.random.PRNGKey(0),
                                      first_index=jnp.int32(FIRST),
                                      block=256)
    _, got, _ = cuda_seeding.select_seeds_lazy_reference(xt, M, FIRST, 32,
                                                         7, 200)
    assert_tie_free(xt, got)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def planted_tie(d, tile, blocks, on_chip, k=4, n=N):
    """K orthonormal centers with noise, the first seed in cluster 0, and
    u (equally near every center, min-distance about 0.25 against 0.5 for
    an unseeded cluster) at i and j: the first pixel of block 0's and of
    block 1's first tile, whose other pixels are copies of the first seed.
    Returns (x, i, j, the step whose pick is i)."""
    rng = np.random.RandomState(d + k)
    basis, _ = np.linalg.qr(rng.randn(d, k))
    centers = basis.T
    x = centers[rng.choice(k, size=n)] + 0.3 * rng.randn(n, d) / np.sqrt(d)
    x = x[np.argsort(rng.rand(n))]
    length = -(-n // blocks)
    i, j = on_chip, length + on_chip
    x[FIRST] = centers[0] + 0.3 * rng.randn(d) / np.sqrt(d)
    for lo in (i, j):
        x[lo:lo + tile] = x[FIRST]
    u = centers.sum(0)
    x[i] = x[j] = u
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), i, j, k


@pytest.mark.parametrize("d", [64, 128])
def test_lazy_planted_tie_goes_to_the_stale_lower_index(d):
    """i's tile is skipped from step 1 until every cluster has a seed (its
    stale bound, u's min-distance after the first seed, is below block 0's
    on-chip pixels of unseeded clusters); then u at i and at j tie exactly
    and the stale tile, refreshed, wins by its lower index."""
    tile, blocks, on_chip = 32, 2, 200
    x, i, j, step = planted_tie(d, tile, blocks, on_chip)
    xt = torch.from_numpy(x)
    want = eager(xt)
    _, got, _ = cuda_seeding.select_seeds_lazy_reference(
        xt, M, FIRST, tile, blocks, on_chip)
    assert torch.equal(got, want)
    assert int(got[step]) == i and j not in got.tolist()
    # the tie is exact in the plain arithmetic, at every seed before it
    for s in got[:step].long():
        dist = 0.5 * (1.0 - xt @ xt[s])
        assert float(dist[i]) == float(dist[j])
    # and i's tile was skipped at steps 1 .. step - 2: its bound from step
    # 0 is below block 0's best on-chip min-distance there
    md = 0.5 * (1.0 - xt.double() @ xt.double()[FIRST])
    tile_bound = float(md[i:i + tile].max())
    for s in range(1, step - 1):
        md = torch.minimum(md, 0.5 * (1.0 - xt.double()
                                      @ xt.double()[int(got[s])]))
        assert float(md[:on_chip].max()) > tile_bound, s


def test_lazy_skips_refreshes_on_clustered_and_uniform_input():
    """Most tiles are skipped at most steps on clustered and on random
    unit vectors alike.  With one block and no pixel on chip the only
    lower bound is the previous pick's own min-distance, about 0 once it
    is a seed, so no tile can be skipped."""
    d, tile, blocks, on_chip = 128, 32, 4, 256
    for x in (clustered(5, d), uniform(6, d)):
        xt = torch.from_numpy(x)
        _, got, counts = cuda_seeding.select_seeds_lazy_reference(
            xt, M, FIRST, tile, blocks, on_chip)
        assert torch.equal(got, eager(xt))
        assert cuda_seeding.refresh_shares(counts)[0] < 0.5
    xt = torch.from_numpy(uniform(7, d))
    _, got, counts = cuda_seeding.select_seeds_lazy_reference(
        xt, M, FIRST, tile, 1, 0)
    assert torch.equal(got, eager(xt))
    assert cuda_seeding.refresh_shares(counts) == (1.0, 1.0)


def test_lazy_keys_order_values_then_lower_index():
    md = torch.tensor([-2.0, -0.5, -0.0, 0.0, 1e-30, 0.25, 0.25, 0.5])
    keys = cuda_seeding._keys(md, torch.tensor([0, 1, 2, 3, 4, 6, 5, 7]))
    assert torch.equal(torch.argsort(keys),
                       torch.tensor([0, 1, 2, 3, 4, 5, 6, 7]))


def test_refresh_shares_skip_step_0():
    assert cuda_seeding.refresh_shares(torch.tensor([8, 2, 4, 0])) == (
        0.25, 0.5)
    assert cuda_seeding.refresh_shares(torch.tensor([0, 0])) == (0.0, 0.0)
    assert cuda_seeding.refresh_shares(torch.tensor([5])) == (0.0, 0.0)
