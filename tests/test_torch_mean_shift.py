"""Each clustering phase of the port against the JAX function its CUDA
kernel replaces, on the same numpy inputs (CPU, small shapes).

On a CPU tensor every kernel wrapper runs its plain version, so these hold
the plain versions (the references the kernels are held against on the
card) to the JAX package's Pallas kernels in interpret mode, at width 16
and at width 128 (the RGB-D cat fusion's 2 * NUM_UNITS, the kernels' second
instantiation beside 64).  Two tests
emulate the float32 kernels' split-TF32 arithmetic in torch: the hill
climb's, held to the float32 plain version, and the assignment's, held to
the margin below which the assignment kernel re-checks a pixel exactly.
A torch model of the connected-components kernel's bitmask merge is held to
the plain version and to the reference loop.

Tolerances:
  * seed indices, seed labels, pixel labels and counts: equal;
  * converged seeds Z: atol 1e-5 at float32 (summation order), 2e-2 at
    bfloat16 (Z and W round to bf16 inside every iteration).
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
from unseenobjectclustering_tpu.ops.roi import \
    filter_labels_depth as jax_filter_labels_depth

torch.set_num_threads(1)

N, D, M = 1536, 16, 20  # a 32x48 frame, 16-D embeddings, 20 seeds
Z_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def clustered(seed=0, k=6, noise=0.15, n=N, d=D):
    """Unit embeddings around k well-separated centers, plus a validity
    mask under which cluster 1 is mostly invalid."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    # cluster 1 is small, so it is never the background cluster
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
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        TORCH_DT[dtype])
    return xj, xt


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors never reach a kernel: every launch counter stays 0."""
    yield
    assert cuda_seeding.launches == 0
    assert cms.hill_climb_launches == 0
    assert cms.connected_components_launches == 0
    assert cms.assign_labels_launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seeding_matches_pallas(dtype):
    x, _ = clustered(1)
    xj, xt = both(x, dtype)
    _, want = select_seeds_pallas(xj, M, jnp.int32(7))
    seeds, got = cuda_seeding.select_seeds(xt, M, 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and seeds.dtype == xt.dtype
    np.testing.assert_array_equal(seeds.float().numpy(),
                                  xt[got.long()].float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hill_climb_matches_pallas(dtype):
    x, _ = clustered(2)
    xj, xt = both(x, dtype)
    z0 = x[np.random.RandomState(3).choice(N, M, replace=False)]
    want = jpms.hill_climb_pallas(xj, jnp.asarray(z0), kappa=20.0,
                                  max_iters=10)
    got = cms.hill_climb(xt, torch.from_numpy(z0), kappa=20.0, max_iters=10)
    assert got.dtype == torch.float32 and got.shape == (M, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=Z_ATOL[dtype])


def test_connected_components_matches_pallas():
    x, _ = clustered(4)
    xj, _ = both(x, "float32")
    z0 = x[np.random.RandomState(5).choice(N, M, replace=False)]
    z = np.array(jpms.hill_climb_pallas(xj, jnp.asarray(z0)))
    want = jpms.connected_components_pallas(jnp.asarray(z), 0.04)
    got = cms.connected_components(torch.from_numpy(z), 0.04)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) > 1


def test_connected_components_overwrites_labeled_neighbours():
    """Seed 2 is unlabeled when reached; its ball holds seed 1 (label 1)
    and seed 3: both take the mode label, as in the reference."""
    e = np.eye(4, dtype=np.float32)
    z = np.stack([e[0], e[1], (e[1] + 0.05 * e[2]), e[1]])
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    want = np.asarray(jms.connected_components(jnp.asarray(z), 0.04))
    got = cms.connected_components(torch.from_numpy(z), 0.04)
    np.testing.assert_array_equal(got.numpy(), want)


# the kernels' seeds a row and a mask: 8 words of 32 (cc_kernel<d, 256>;
# the kernels of m <= 128 keep 4, whose upper words would be zero here),
# and 16 in cc_wide_kernel (up to 512 seeds)
WORDS = 8
SEEDS = 32 * WORDS
WIDE_WORDS = 16


def _words(bits):
    """[..., 32 k] bool -> [..., k] int64 holding uint32 words: bit b of
    word w is entry 32 w + b, as the connected-components kernels store a
    row."""
    shifts = torch.arange(32, dtype=torch.int64)
    return (bits.reshape(*bits.shape[:-1], bits.shape[-1] // 32, 32).long()
            << shifts).sum(-1)


def _popcount(v):
    """Set bits of each uint32 word held in an int64 tensor."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def _lowest(words):
    """The lowest entry whose bit is set, or -1 (__ffs over the words)."""
    for w in range(len(words)):
        v = int(words[w]) & 0xFFFFFFFF
        if v:
            return 32 * w + (v & -v).bit_length() - 1
    return -1


def bitmask_merge(adj, words=WORDS):
    """The connected-components kernel's merge, modelled in torch on the
    [m, m] bool adjacency: rows and per-label memberships as bitmasks of
    `words` words, a set of the seeds neither labeled nor visited whose
    lowest seed is the next step, each label's count among the neighbours
    by popcount, and the mode by the maximum of the keys (count << 8) |
    (255 - label) at 8 words (cc_kernel) or (count << 16) | (65535 - label)
    at 16 (cc_wide_kernel).  Returns (labels [m] int32, steps)."""
    m = adj.shape[0]
    seeds = 32 * words
    shift = 8 if words <= WORDS else 16
    top = (1 << shift) - 1
    bits = torch.zeros(m, seeds, dtype=torch.bool)
    bits[:, :m] = adj
    rows = _words(bits)                                  # [m, words]
    member = torch.zeros(seeds, words, dtype=torch.int64)  # label l's seeds
    pending = _words(torch.arange(seeds) < m)
    labeled = torch.zeros(words, dtype=torch.int64)
    tie = top - torch.arange(seeds)
    num_labels = steps = 0
    i = _lowest(pending)
    while i >= 0:
        a = rows[i]
        pending = pending & ~a & ~_words(torch.arange(seeds) == i)
        seen = bool((a & labeled).any())
        labeled = labeled | a
        key = int(((_popcount(member & a).sum(1) << shift) | tie).max())
        # the kernel's fast path: no labeled neighbour <=> every count is 0
        assert seen == bool(key >> shift)
        if seen:
            label = top - (key & top)
        else:
            label, num_labels = num_labels, num_labels + 1
        member = member & ~a
        member[label] |= a
        steps += 1
        i = _lowest(pending)
    # read out bit by bit of the label (the masks are disjoint, so a sum
    # over labels is their OR, and their union is `labeled`)
    assert torch.equal(member.sum(0), labeled)
    seed = torch.arange(m)

    def bit(words):
        return (words[seed // 32] >> (seed % 32)) & 1

    ids = torch.arange(seeds)
    label = sum(bit(member[(ids >> p) & 1 == 1].sum(0)) << p
                for p in range(seeds.bit_length() - 1))
    return torch.where(bit(labeled) == 1, label, -1).int(), steps


def reference_loop(adj):
    """A literal transcription of the reference loop (mean_shift.py:41-76,
    JAX ops.mean_shift.connected_components) over a bool adjacency (nested
    lists): (labels, the number of seeds unlabeled when their turn came)."""
    m = len(adj)
    labels = [-1] * m
    k = steps = 0
    for i in range(m):
        if labels[i] != -1:
            continue
        steps += 1
        neigh = [j for j in range(m) if adj[i][j]]
        counts = {}
        for j in neigh:
            if labels[j] >= 0:
                counts[labels[j]] = counts.get(labels[j], 0) + 1
        if counts:
            best = max(counts.values())
            label = min(lab for lab, c in counts.items() if c == best)
        else:
            label, k = k, k + 1
        for j in neigh:
            labels[j] = label
    return labels, steps


MERGE_SIZES = [1, 2, 7, 31, 32, 33, 63, 64, 65, 100, 127, 128, 129, 200,
               255, 256]


@pytest.mark.parametrize("m", MERGE_SIZES)
def test_bitmask_merge_matches_plain_on_converged_seeds(m):
    """Seeds spread around a few modes as after the hill climb, some balls
    chaining into others: the kernel's merge, modelled, gives the plain
    connected_components' labels."""
    rng = np.random.RandomState(100 + m)
    d, eps = 64, 0.04
    centers = rng.randn(rng.randint(1, 12), d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    spread = rng.uniform(0.15, 0.35)
    z = (centers[rng.randint(len(centers), size=m)]
         + spread * rng.randn(m, d) / np.sqrt(d))
    z = torch.from_numpy((z / np.linalg.norm(z, axis=1,
                                             keepdims=True)).astype(np.float32))
    adj = 0.5 * (1.0 - z @ z.T) <= eps      # the plain version's adjacency
    got, steps = bitmask_merge(adj)
    want = tms.connected_components(z, eps)
    assert torch.equal(got, want)
    assert steps == reference_loop(adj.tolist())[1]


@pytest.mark.parametrize("m", MERGE_SIZES)
def test_bitmask_merge_matches_reference_loop(m):
    """Random symmetric adjacencies, dense and sparse, with some seeds
    outside their own ball (a diagonal entry off, as for a seed of norm
    below 1): the modelled merge equals the reference loop, labels and
    steps."""
    rng = np.random.RandomState(m)
    for density in (0.03, 0.15, 0.5):
        a = rng.rand(m, m) < density
        a = np.triu(a, 1)
        a = a | a.T
        a[np.diag_indices(m)] = rng.rand(m) < 0.9
        got, steps = bitmask_merge(torch.from_numpy(a))
        want, want_steps = reference_loop(a.tolist())
        assert got.tolist() == want and steps == want_steps


WIDE_MERGE_SIZES = [1, 33, 100, 256, 257, 300, 400, 511, 512]


@pytest.mark.parametrize("m", WIDE_MERGE_SIZES)
def test_wide_bitmask_merge_matches_plain_on_converged_seeds(m):
    """cc_wide_kernel's merge (16-word rows and masks, the 16-bit key),
    modelled: seeds around up to 400 modes, so that past 256 seeds more
    than 256 labels occur; the plain connected_components' labels and the
    reference loop's steps."""
    rng = np.random.RandomState(300 + m)
    d, eps = 64, 0.04
    centers = rng.randn(min(400, max(1, m - m // 4)), d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    z = (centers[np.arange(m) % len(centers)]
         + 0.2 * rng.randn(m, d) / np.sqrt(d))
    z = torch.from_numpy((z / np.linalg.norm(z, axis=1,
                                             keepdims=True)).astype(np.float32))
    adj = 0.5 * (1.0 - z @ z.T) <= eps
    got, steps = bitmask_merge(adj, WIDE_WORDS)
    want = tms.connected_components(z, eps)
    assert torch.equal(got, want)
    assert steps == reference_loop(adj.tolist())[1]
    if m > 300:
        assert int(want.max()) + 1 > 256


@pytest.mark.parametrize("m", [257, 300, 400, 512])
def test_wide_bitmask_merge_matches_reference_loop(m):
    """Random symmetric adjacencies past 256 seeds, dense and sparse, some
    seeds outside their own ball: the 16-word merge equals the reference
    loop, labels and steps."""
    rng = np.random.RandomState(400 + m)
    for density in (0.002, 0.01, 0.1):
        a = rng.rand(m, m) < density
        a = np.triu(a, 1)
        a = a | a.T
        a[np.diag_indices(m)] = rng.rand(m) < 0.9
        got, steps = bitmask_merge(torch.from_numpy(a), WIDE_WORDS)
        want, want_steps = reference_loop(a.tolist())
        assert got.tolist() == want and steps == want_steps


def far_then(m_far, tail):
    """A bool adjacency of m_far seeds each its own ball (labels 0 ..
    m_far - 1), then the seeds of `tail` (pairs of tail indices that are
    neighbours; each tail seed in its own ball)."""
    m = m_far + 1 + max(max(p) for p in tail)
    a = np.eye(m, dtype=bool)
    for i, j in tail:
        a[m_far + i, m_far + j] = a[m_far + j, m_far + i] = True
    return torch.from_numpy(a)


@pytest.mark.parametrize("order", ["low_first", "high_first"])
def test_wide_bitmask_merge_mode_tie_above_255(order):
    """300 lone seeds, then seeds A and B (labels 300 and 301, each
    labelling its neighbour D or E), then C, whose ball holds D and E: the
    tie between labels 300 and 301 goes to 300 whichever of A and B comes
    first, and C, D and E take it; the 16-bit key holds both labels."""
    # tail seeds: 0 = A, 1 = B, 2 = C, 3 = D (near A), 4 = E (near B)
    tail = [(0, 3), (1, 4), (2, 3), (2, 4)]
    if order == "high_first":  # A and B swapped in seed order
        swap = {0: 1, 1: 0, 3: 4, 4: 3}
        tail = [(swap.get(i, i), swap.get(j, j)) for i, j in tail]
    adj = far_then(300, tail)
    got, steps = bitmask_merge(adj, WIDE_WORDS)
    want, want_steps = reference_loop(adj.tolist())
    assert got.tolist() == want and steps == want_steps
    assert got[300:].tolist() == [300, 301, 300, 300, 300]


def test_wide_bitmask_merge_overwrites_labeled_neighbours_above_255():
    """Past 256 labels an unlabeled seed that sees label 300 once and
    label 301 twice moves its neighbour labeled 300 to 301, as the
    reference loop does."""
    # tail: 0 = A (300), 1 = B (301), 2 = C; A-D, B-E, B-F; C sees D
    # (label 300) and E, F (label 301)
    tail = [(0, 3), (1, 4), (1, 5), (2, 3), (2, 4), (2, 5)]
    adj = far_then(300, tail)
    got, steps = bitmask_merge(adj, WIDE_WORDS)
    want, want_steps = reference_loop(adj.tolist())
    assert got.tolist() == want and steps == want_steps
    assert got[300:].tolist() == [300, 301, 301, 301, 301, 301]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_valid", [True, False])
def test_assign_labels_matches_pallas(dtype, with_valid):
    x, z_valid = clustered(6)
    xj, xt = both(x, dtype)
    z0 = x[np.random.RandomState(7).choice(N, M, replace=False)]
    z = np.array(jpms.hill_climb_pallas(xj, jnp.asarray(z0)))
    slab = np.array(jpms.connected_components_pallas(jnp.asarray(z), 0.04))
    want = jpms.assign_labels_pallas(
        xj, jnp.asarray(z), jnp.asarray(slab),
        z_valid=jnp.asarray(z_valid) if with_valid else None)
    got = cms.assign_labels(xt, torch.from_numpy(z), torch.from_numpy(slab),
                            z_valid=(torch.from_numpy(z_valid)
                                     if with_valid else None))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32


# The cat fusion's width, 2 * NUM_UNITS: the kernels' second instantiation.
WIDE = 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_seeding_matches_pallas_at_width_128(dtype):
    x, _ = clustered(21, d=WIDE)
    xj, xt = both(x, dtype)
    _, want = select_seeds_pallas(xj, M, jnp.int32(9))
    seeds, got = cuda_seeding.select_seeds(xt, M, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert seeds.shape == (M, WIDE) and seeds.dtype == xt.dtype


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hill_climb_matches_pallas_at_width_128(dtype):
    x, _ = clustered(22, d=WIDE)
    xj, xt = both(x, dtype)
    z0 = x[np.random.RandomState(23).choice(N, M, replace=False)]
    want = jpms.hill_climb_pallas(xj, jnp.asarray(z0), kappa=20.0,
                                  max_iters=10)
    got = cms.hill_climb(xt, torch.from_numpy(z0), kappa=20.0, max_iters=10)
    assert got.dtype == torch.float32 and got.shape == (M, WIDE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=Z_ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_connected_components_matches_pallas_at_width_128(dtype):
    """Seeds hill-climbed in `dtype` (the route's Z is float32 either
    way), merged by both packages."""
    x, _ = clustered(24, d=WIDE)
    xj, _ = both(x, dtype)
    z0 = x[np.random.RandomState(25).choice(N, M, replace=False)]
    z = np.array(jpms.hill_climb_pallas(xj, jnp.asarray(z0)))
    want = jpms.connected_components_pallas(jnp.asarray(z), 0.04)
    got = cms.connected_components(torch.from_numpy(z), 0.04)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) > 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_valid", [True, False])
def test_assign_labels_matches_pallas_at_width_128(dtype, with_valid):
    x, z_valid = clustered(26, d=WIDE)
    xj, xt = both(x, dtype)
    z0 = x[np.random.RandomState(27).choice(N, M, replace=False)]
    z = np.array(jpms.hill_climb_pallas(xj, jnp.asarray(z0)))
    slab = np.array(jpms.connected_components_pallas(jnp.asarray(z), 0.04))
    assert slab.max() > 0  # more than one label
    want = jpms.assign_labels_pallas(
        xj, jnp.asarray(z), jnp.asarray(slab),
        z_valid=jnp.asarray(z_valid) if with_valid else None)
    got = cms.assign_labels(xt, torch.from_numpy(z), torch.from_numpy(slab),
                            z_valid=(torch.from_numpy(z_valid)
                                     if with_valid else None))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m", [100, 300, 512])
def test_exact_assignment_chain_at_width_256(m):
    """assign_exact_kernel (d = 256, and past 256 seeds) re-checks nothing:
    every score is the sequential fp32 FMA chain over j = 0..d-1 (the
    wgmma kernels' re-check), the best seed the lowest index on a tie.
    Emulated (fmaf as one rounding of the float64 sum to float32), each
    chain is within d * 2^-24 of the float64 dot, so wherever the float64
    scores of a pixel's best seed and of every seed of another label are
    2 d * 2^-24 apart the emulation gives the plain version's label (the
    plain version's float32 sums are as close); on clustered embeddings
    that is all but a few pixels, and there the labels agree too."""
    n, d = 4096, 256
    x, _ = clustered(17, k=8, n=n, d=d)
    xt = torch.from_numpy(x)
    z0 = xt[torch.from_numpy(np.random.RandomState(18).choice(n, m,
                                                              replace=False))]
    z = cms.hill_climb_reference(xt, z0, kappa=20.0, max_iters=10)
    slab = cms.connected_components_reference(z, 0.04)
    xd, zd = xt.double(), z.double()
    acc = torch.zeros(n, m, dtype=torch.float64)
    for j in range(d):
        acc = (xd[:, j:j + 1] * zd[None, :, j] + acc).float().double()
    exact = xd @ zd.T
    bound = d * 2.0 ** -24
    assert float((acc - exact).abs().max()) <= bound
    got = slab[acc.argmax(dim=1)]        # the first (lowest) seed on a tie
    want, _, _ = cms.assign_labels_reference(xt, z, slab)
    b1, best = exact.max(dim=1)
    other = slab[None, :] != slab[best][:, None]
    b2 = torch.where(other, exact, torch.full_like(exact, -float("inf")))
    clear = b1 - b2.max(dim=1).values >= 2 * bound
    assert int(clear.sum()) > 0.99 * n
    assert torch.equal(got[clear], want[clear])
    assert torch.equal(got, want)


def test_kernel_shape_checks_take_widths_64_and_128():
    """The checks the wrappers make before a launch on a CUDA tensor (and
    the launch plans before they reach the library): widths 1..256, each
    served by the instantiation at 64 (d <= 64), 128 (d <= 128) or 256,
    and 1..512 seeds pass; width 257 and 513 seeds raise, naming the
    range."""
    for d in range(1, 257):
        width = 64 if d <= 64 else 128 if d <= 128 else 256
        assert _build.kernel_width("select_seeds", d) == width
        assert cms.check_shapes("hill_climb", M, d) == width
    for m in range(1, 513):
        assert cms.check_shapes("assign_labels", m, 16) == 64
    for check in (lambda: _build.kernel_width("select_seeds", 257),
                  lambda: cms.check_shapes("assign_labels", M, 257),
                  lambda: cuda_seeding.launch_config(torch.zeros(8, 257)),
                  lambda: cms.hill_climb_config(torch.zeros(8, 257), M),
                  lambda: cms.assign_labels_config(torch.zeros(8, 257), M),
                  lambda: cms.connected_components_config(
                      torch.zeros(M, 257))):
        with pytest.raises(ValueError, match="widths 1..256, got 257"):
            check()
    for check in (lambda: cms.check_shapes("hill_climb", 513, 64),
                  lambda: cms.hill_climb_config(torch.zeros(8, 64), 513),
                  lambda: cms.assign_labels_config(torch.zeros(8, 64), 513),
                  lambda: cms.connected_components_config(
                      torch.zeros(513, 64))):
        with pytest.raises(ValueError, match="1..512 seeds, got m=513"):
            check()
    with pytest.raises(ValueError, match="seeds"):
        cms.check_shapes("hill_climb", 0, 64)


@pytest.mark.parametrize("subsample", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mean_shift_smart_init_matches_pallas_route(subsample, dtype):
    """The whole kernel route with the fused 0.8 depth filter: labels equal
    to the JAX use_pallas=True route."""
    x, z_valid = clustered(8)
    kw = dict(kappa=20.0, num_seeds=M, max_iters=10, epsilon=0.04,
              metric="cosine", use_pallas=True, first_index=3,
              seed_subsample=subsample, compute_dtype=dtype,
              filter_threshold=0.8)
    want = jms.mean_shift_smart_init(jnp.asarray(x), jax.random.PRNGKey(0),
                                     z_valid=jnp.asarray(z_valid), **kw)
    got = tms.mean_shift_smart_init(torch.from_numpy(x),
                                    z_valid=torch.from_numpy(z_valid), **kw)
    np.testing.assert_array_equal(got.seed_indices.numpy(),
                                  np.asarray(want.seed_indices))
    np.testing.assert_array_equal(got.seed_labels.numpy(),
                                  np.asarray(want.seed_labels))
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    # the filter dropped the mostly-invalid cluster and kept others
    assert 0 < len(np.unique(got.labels.numpy())) < 6


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_plain_route_matches_xla_route(metric):
    """use_pallas=False: the plain phases against the JAX XLA route (the
    euclidean metric always takes it)."""
    x, z_valid = clustered(9)
    kw = dict(kappa=20.0, num_seeds=M, max_iters=10, epsilon=0.04,
              metric=metric, use_pallas=False, first_index=11,
              filter_threshold=0.8)
    want = jms.mean_shift_smart_init(jnp.asarray(x), jax.random.PRNGKey(0),
                                     z_valid=jnp.asarray(z_valid), **kw)
    got = tms.mean_shift_smart_init(torch.from_numpy(x),
                                    z_valid=torch.from_numpy(z_valid), **kw)
    np.testing.assert_array_equal(got.seed_indices.numpy(),
                                  np.asarray(want.seed_indices))
    np.testing.assert_allclose(got.seeds.numpy(), np.asarray(want.seeds),
                               atol=1e-5)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))


def test_swap_background_ties_and_depth_filter_match():
    labels = np.array([0, 1, 1, 2, 2, 0, 3], np.int32)
    counts = np.array([2, 2, 2, 1], np.float32)  # tie -> first (label 0)
    for c in (counts, np.array([1, 2, 3, 3], np.float32)):
        want, wmax = jms.swap_background(jnp.asarray(labels), jnp.asarray(c))
        got, gmax = tms.swap_background(torch.from_numpy(labels),
                                        torch.from_numpy(c))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert int(gmax) == int(wmax)
    z_valid = np.array([1, 1, 0, 0, 0, 1, 1], bool)
    xyz = np.zeros((7, 1, 3), np.float32)
    xyz[:, 0, 2] = z_valid
    want = jax_filter_labels_depth(jnp.asarray(labels[:, None]),
                                   jnp.asarray(xyz), 0.5, max_labels=5)
    got = tms.filter_labels_depth(torch.from_numpy(labels),
                                  torch.from_numpy(z_valid), 0.5,
                                  max_labels=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, 0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrappers_on_cpu_tensors_run_the_plain_versions(dtype):
    """On a CPU tensor each wrapper returns exactly its plain version's
    result and launches nothing."""
    x, z_valid = clustered(12)
    _, xt = both(x, dtype)
    seeds, idx = cuda_seeding.select_seeds(xt[::3], M, 2)
    want_seeds, want_idx = cuda_seeding.select_seeds_reference(xt[::3], M, 2)
    assert torch.equal(idx, want_idx) and torch.equal(seeds, want_seeds)
    z = cms.hill_climb(xt, seeds, kappa=20.0, max_iters=5)
    assert torch.equal(z, cms.hill_climb_reference(xt, seeds, kappa=20.0,
                                                   max_iters=5))
    slab = cms.connected_components(z, 0.04)
    assert torch.equal(slab, cms.connected_components_reference(z, 0.04))
    zv = torch.from_numpy(z_valid)
    for g, w in zip(cms.assign_labels(xt, z, slab, z_valid=zv),
                    cms.assign_labels_reference(xt, z, slab, z_valid=zv)):
        assert torch.equal(g, w)
    assert (cuda_seeding.launches, cms.hill_climb_launches,
            cms.connected_components_launches,
            cms.assign_labels_launches) == (0, 0, 0, 0)


def test_random_first_seed_comes_from_the_generator():
    x, _ = clustered(10)
    xt = torch.from_numpy(x)
    a = tms.select_seeds_dispatch(xt, 5, torch.Generator().manual_seed(3))
    b = tms.select_seeds_dispatch(xt, 5, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    first = int(torch.randint(N, (1,),
                              generator=torch.Generator().manual_seed(3)))
    assert int(a[1][0]) == first


def _tf32(a):
    """a (float32) rounded to TF32: the mantissa cut to 10 bits, nearest
    even."""
    u = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000
    return (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)


def _tf32_truncated(a):
    """a (float32) as the tensor cores read a TF32 operand: the low 13 bits
    dropped."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the hill-climb kernel computes it: each operand split as
    big + small, big = tf32(a), small = a - big as the tensor cores read
    it; the small terms, then big * big, summed in float32."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32_truncated(a - ab), _tf32_truncated(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def test_split_tf32_hill_climb_meets_the_float32_tolerance():
    """The float32 hill climb's arithmetic on the tensor cores, emulated:
    every operand of both products split into two TF32 parts. After 10
    iterations Z stays within 1e-5 of the float32 plain version and the
    connected components give the same labels."""
    n, m, d = 4096, 100, 64
    x, _ = clustered(13, k=8, n=n, d=d)
    xt = torch.from_numpy(x)
    z0 = xt[torch.from_numpy(np.random.RandomState(14).choice(n, m,
                                                              replace=False))]
    ab = _tf32(xt)
    assert torch.equal(ab, _tf32(ab))            # rounding is idempotent
    assert float(((xt - ab) / xt).abs().max()) <= 2.0 ** -11
    z = z0.clone()
    for _ in range(10):
        w = torch.exp(20.0 * _mm_3xtf32(z, xt.T))
        v = _mm_3xtf32(w, xt)
        z = v / torch.clamp(torch.sqrt((v * v).sum(dim=1, keepdim=True)),
                            min=1e-12)
    want = cms.hill_climb_reference(xt, z0, kappa=20.0, max_iters=10)
    assert float((z - want).abs().max()) <= 1e-5
    labels = cms.connected_components_reference(z, 0.04)
    assert torch.equal(labels, cms.connected_components_reference(want, 0.04))
    assert int(labels.max()) > 0  # more than one cluster


@pytest.mark.parametrize("m,d", [
    pytest.param(100, 64, id="100"), pytest.param(128, 64, id="128"),
    pytest.param(100, 128, id="100-d128"),
    pytest.param(128, 128, id="128-d128")])
def test_split_tf32_assignment_margin_holds(m, d):
    """The float32 assignment kernel's S, emulated: within half the re-check
    margin of width d of the float32 S, so every pixel whose best seed
    beats every seed of another label by at least the margin gets the plain
    version's label; the kernel re-checks the others exactly."""
    n = 4096
    delta = cms.ASSIGN_RECHECK_MARGIN[d]
    x, _ = clustered(15, k=8, n=n, d=d)
    xt = torch.from_numpy(x)
    z0 = xt[torch.from_numpy(np.random.RandomState(16).choice(n, m,
                                                              replace=False))]
    z = cms.hill_climb_reference(xt, z0, kappa=20.0, max_iters=10)
    slab = cms.connected_components_reference(z, 0.04)
    assert int(slab.max()) > 0  # more than one label
    s = _mm_3xtf32(xt, z.T)
    assert float((s - xt @ z.T).abs().max()) <= delta / 2
    b1, best = s.max(dim=1)
    lab = slab[best]
    other = slab[None, :] != lab[:, None]
    b2 = torch.where(other, s, torch.full_like(s, -float("inf"))).max(dim=1)
    clear = b1 - b2.values >= delta
    assert int(clear.sum()) > 0.99 * n
    want, _, _ = cms.assign_labels_reference(xt, z, slab)
    assert torch.equal(lab[clear], want[clear])
