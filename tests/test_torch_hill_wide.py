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

The width-256 hill climb (hill_simt_kernel, fp32 FMA on the CUDA cores) is
emulated the same way (emulate_simt) and held to the bound of its own note,
39 * 2^-24, and to the same tolerances.
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


# hill_simt_kernel (d = 256): S as 8 FMA chains of 32 dims, each from 0,
# added in order to the dot's total; |S - S_exact| <= 39 * 2^-24
S_BOUND_256 = 39 * 2.0 ** -24
SIMT_TILE, SIMT_CHUNK = 64, 32


def fma32(a, b, c):
    """fmaf on float32 operands held in float64 tensors: the product is
    exact in float64, the sum rounded once to float64 and then to float32
    (a second rounding that can differ from fmaf's by one float32 ulp in
    rare halfway cases, far below the bound held here)."""
    return (a * b + c).to(torch.float32).to(F64)


def emulate_simt(x, z0, grid):
    """hill_simt_kernel's float32 arithmetic on the CPU: S per (seed, pixel)
    as the chains above, W = exp(kappa S) in float32, each 64-pixel tile's
    W X as an FMA chain over its pixels from 0 added to the block's running
    float32 sum (block b takes tiles b, b + grid, ...), the blocks' float32
    partials summed in block order in float64 and the row normalized in
    float64, then rounded to float32.  Returns (Z, the largest |S -
    S_exact| over the iterations)."""
    n, d = x.shape
    xd = x.to(F64)
    z = z0.to(torch.float32)
    s_err = 0.0
    tiles = -(-n // SIMT_TILE)
    for _ in range(ITERS):
        zd = z.to(F64)
        tot = torch.zeros(z.shape[0], n, dtype=torch.float32)
        for c in range(0, d, SIMT_CHUNK):
            part = torch.zeros(z.shape[0], n, dtype=F64)
            for j in range(c, c + SIMT_CHUNK):
                part = fma32(zd[:, j:j + 1], xd[None, :, j], part)
            tot = tot + part.to(torch.float32)
        s_err = max(s_err, float((tot.to(F64) - zd @ xd.T).abs().max()))
        w = torch.exp(KAPPA * tot).to(F64)
        partial = torch.zeros(grid, z.shape[0], d, dtype=torch.float32)
        for q in range(tiles):
            acc = torch.zeros(z.shape[0], d, dtype=F64)
            for p in range(q * SIMT_TILE, min(n, (q + 1) * SIMT_TILE)):
                acc = fma32(w[:, p:p + 1], xd[None, p], acc)
            partial[q % grid] += acc.to(torch.float32)
        v = torch.zeros(z.shape[0], d, dtype=F64)
        for b in range(grid):
            v = v + partial[b].to(F64)
        z = (v / v.norm(dim=1, keepdim=True).clamp_min(1e-12)).to(
            torch.float32)
    return z, s_err


def test_simt_hill_climb_at_width_256_meets_its_bound():
    """hill_simt_kernel's arithmetic, emulated at d = 256 (n = 1024 pixels
    over 4 blocks of 4 tiles, m = 100 seeds): S within 39 * 2^-24 of the
    float64 dot at every iteration (the kernel's note proves it; one
    256-long chain would allow 256 * 2^-24), Z after 10 iterations within
    chip_smoke's Z_TOL of the float64 replay and of the JAX package's hill
    climb, and the connected components of the float64 result."""
    x = torch.from_numpy(clustered(21, d=256))
    z0 = x[torch.from_numpy(np.random.RandomState(22).choice(N, M,
                                                             replace=False))]
    z, s_err = emulate_simt(x, z0, grid=4)
    assert s_err <= S_BOUND_256
    exact = exact_hill_climb(x, z0)
    assert float((z.to(F64) - exact).abs().max()) <= Z_TOL
    want = jms.hill_climb_xla(jnp.asarray(x.numpy()), jnp.asarray(z0.numpy()),
                              KAPPA, ITERS, "cosine")
    assert float((z - torch.from_numpy(np.array(want))).abs().max()) <= Z_TOL
    labels = cms.connected_components_reference(z, 0.04)
    assert torch.equal(labels,
                       cms.connected_components_reference(exact.float(), 0.04))
    assert int(labels.max()) > 0  # more than one cluster
