"""The width-128 float32 assignment kernel's arithmetic, emulated on the CPU.

assign_tf32_wide_kernel (csrc/mean_shift.cu) assigns the RGB-D cat
fusion's 128-D embeddings in parity mode with S = X Z^T as split TF32 on
the tensor cores.  These tests replay its float32 arithmetic with
assign_study.emulate_assign at a small shape (n = 512 pixels, 8 tiles of
64; m = 100 seeds; d = 128): X and Z split as split_tf32 splits them, the
16 k-chunks of 8 dims in order as three wgmma steps each (small X * big
Z, big X * small Z, big X * big Z), every step under hill_climb_study's
`al2` accumulator model; then b1, its label and b2 per pixel, the exact
float32 FMA chain for the pixels whose b1 - b2 falls below
ASSIGN_RECHECK_MARGIN[128], and both histograms.

They hold the emulated S within the kernel note's bound of the float64
product (48 * (9 * 2^-25 + 2^-23) + 1.3 * 2^-20, below 2^-15), and the
labels and both histograms equal to the JAX package's
assign_labels_pallas (interpret mode on the CPU) and to the port's plain
version on the same numpy inputs: seeds hill-climbed from numpy picks,
seeds with an exact tie between two labels, and pairs of seeds under
distinct labels, one the other scaled by 1 + 2e-5, that force re-checks
at most pixels; with and without a depth mask.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from assign_study import S_BOUND_128, emulate_assign, emulate_s
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_tpu.ops import pallas_mean_shift as jpms

torch.set_num_threads(1)

N, D, M = 512, 128, 100
MARGIN = cms.ASSIGN_RECHECK_MARGIN[D]


def inputs(case):
    """x [N, D] float32 unit rows around 8 centers, a depth mask, seeds z
    [M, D] and their labels (numpy, from a seed)."""
    rng = np.random.RandomState(60)
    centers = rng.randn(8, D)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.choice(8, size=N)] + 0.15 * rng.randn(N, D) / np.sqrt(D)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x = x.astype(np.float32)
    z_valid = rng.rand(N) > 0.1
    z0 = torch.from_numpy(x[rng.choice(N, M, replace=False)])
    z = cms.hill_climb_reference(torch.from_numpy(x), z0).numpy()
    slab = cms.connected_components_reference(torch.from_numpy(z),
                                              0.04).numpy()
    if case == "tie":  # seed 5 an exact copy of seed 2, another label
        z = x[rng.choice(N, M, replace=False)]
        z[5] = z[2]
        slab = np.arange(M, dtype=np.int32)
    elif case == "near":  # seed 2k + 1 is seed 2k scaled by 1 + 2e-5
        z = x[rng.choice(N, M, replace=False)].astype(np.float64)
        z[1::2] = z[0::2] * (1.0 + 2e-5)
        z = z.astype(np.float32)
        slab = np.arange(M, dtype=np.int32)
    return x, z_valid, z, slab.astype(np.int32)


def test_the_bound_is_below_half_the_margin():
    assert S_BOUND_128 < 2.0 ** -15 == MARGIN / 2


@pytest.mark.parametrize("case", ["converged", "tie", "near"])
@pytest.mark.parametrize("with_valid", [True, False])
def test_emulated_kernel_matches_pallas_and_plain(case, with_valid):
    x, z_valid, z, slab = inputs(case)
    xt, zt, st = (torch.from_numpy(a) for a in (x, z, slab))
    vt = torch.from_numpy(z_valid) if with_valid else None
    s = emulate_s(xt, zt)
    exact = xt.double() @ zt.double().T
    assert float((s.double() - exact).abs().max()) < S_BOUND_128
    labels, counts, valid, rechecked = emulate_assign(xt, zt, st, vt, MARGIN)
    if case == "converged":
        assert len(np.unique(slab)) > 1
    else:
        assert rechecked > 0
    if case == "near":
        assert rechecked > N // 2
    want = jpms.assign_labels_pallas(
        jnp.asarray(x), jnp.asarray(z), jnp.asarray(slab),
        z_valid=jnp.asarray(z_valid) if with_valid else None)
    plain = cms.assign_labels_reference(xt, zt, st, vt)
    for got, w, p in zip((labels, counts, valid), want, plain):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert torch.equal(got, p)
