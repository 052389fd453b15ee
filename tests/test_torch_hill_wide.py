"""The width-128 float32 hill-climb kernel's arithmetic, emulated on the CPU.

hill_tf32_wide_kernel (csrc/mean_shift.cu) runs the hill climb of the RGB-D
cat fusion's 128-D embeddings as split TF32 on the tensor cores.  This test
replays its float32 arithmetic with hill_climb_study.emulate (the emulation
that `hill_climb_study.py emulate` also holds against the kernel's results
saved on the card) at a small shape (n = 1024 pixels, m = 100 seeds, d =
128): each operand split as big + small (big = tf32(a), nearest even;
small = a - big rounded to tf32, nearest, ties away), S = Z X^T over the
16 k-chunks of 8 dims as 32 small steps and the first 4 big ones in one
accumulator and the other big ones in groups of 4, W X per 32-pixel tile
and 32 dims as 8 small steps and 2 groups of 2 big ones, the groups added
on the CUDA cores (float32, nearest), each block's tiles in order, the
blocks' partials in 8 groups of blocks, then the row norm as the kernel's
warp computes it.  Each wgmma step is modelled as the tensor cores add
it: its 9 terms (the accumulator and 8 exact products) aligned to the
largest and truncated two bits below its last bit, the sum rounded toward
zero (`al2`: of the accumulator models tried on the card it comes nearest
both float32 kernels, within a few ulps of Z after one iteration but not
bitwise, so the kernel's own Z is held to the float64 result on the card,
by chip_smoke.py).

It holds the emulation to the float64 result: S within the bound that the
kernel's note proves, 36 * 2^-25 + 4 * 2^-23 + 3 * 2^-24 + 3 * 2^-22 +
2^-26 + 2^-29 (about 2.5e-6), at every iteration; Z after 10 iterations
within chip_smoke's Z_TOL (1e-5) of the float64 replay and of the JAX
package's hill climb; and the connected components of Z equal to those of
the float64 result.
"""

import jax.numpy as jnp
import numpy as np
import torch

from hill_climb_study import F64, ITERS, KAPPA, S_BOUND_128, emulate, split
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_tpu.ops import mean_shift as jms

torch.set_num_threads(1)

N, M, D = 1024, 100, 128
Z_TOL = 1e-5


def clustered(seed, k=8, n=N, d=D):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, d)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.choice(k, size=n)
    x = centers[assign] + 0.3 * rng.randn(n, d) / np.sqrt(d)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def exact_hill_climb(x, z0):
    x, z = x.to(F64), z0.to(F64)
    for _ in range(ITERS):
        v = torch.exp(KAPPA * (z @ x.T)) @ x
        z = v / v.norm(dim=1, keepdim=True)
    return z


def test_split_tf32_hill_climb_at_width_128_meets_its_bound():
    x = torch.from_numpy(clustered(17))
    z0 = x[torch.from_numpy(np.random.RandomState(18).choice(N, M,
                                                             replace=False))]
    big, small = split(x)
    assert float((big + small - x.to(F64)).abs().max()) <= 2.0 ** -22
    z, s_err = emulate(x, z0)
    assert s_err <= S_BOUND_128
    exact = exact_hill_climb(x, z0)
    assert float((z.to(F64) - exact).abs().max()) <= Z_TOL
    want = jms.hill_climb_xla(jnp.asarray(x.numpy()), jnp.asarray(z0.numpy()),
                              KAPPA, ITERS, "cosine")
    assert float((z - torch.from_numpy(np.array(want))).abs().max()) <= Z_TOL
    labels = cms.connected_components_reference(z, 0.04)
    assert torch.equal(labels,
                       cms.connected_components_reference(exact.float(), 0.04))
    assert int(labels.max()) > 0  # more than one cluster


def test_split_tf32_hill_climb_emulation_at_width_64():
    """The same emulation at the d = 64 kernel's layout (128-pixel tiles
    taken as two 64-pixel products, big steps in pairs in both products, 4
    groups of blocks, a lane's dims l and l + 32) stays within Z_TOL of
    the float64 replay and gives its connected components."""
    x = torch.from_numpy(clustered(19, d=64))
    z0 = x[torch.from_numpy(np.random.RandomState(20).choice(N, M,
                                                             replace=False))]
    z, _ = emulate(x, z0)
    exact = exact_hill_climb(x, z0)
    assert float((z.to(F64) - exact).abs().max()) <= Z_TOL
    labels = cms.connected_components_reference(z, 0.04)
    assert torch.equal(labels,
                       cms.connected_components_reference(exact.float(), 0.04))
