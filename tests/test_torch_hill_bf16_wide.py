"""The width-128 bfloat16 hill-climb kernel's schedule and arithmetic, on the CPU.

hill_bf16_wide_kernel (csrc/mean_shift.cu) runs the fast-mode hill climb of
the RGB-D cat fusion's 128-D embeddings.  Each of its blocks keeps its first
8 tiles of 64 pixels in shared memory for the whole launch and streams the
rest through a ring of 5 stages, ascending on even iterations and
descending on odd ones.  hill_climb_study.bf16_wide_schedule models that
schedule; these tests hold it to summing every pixel exactly once an
iteration at every n the card tests and chip_smoke.py hill-climb at width
128 (the plan's grid on an H100: one block an SM, at most one a tile), with
the tiles each block keeps the same in every iteration, each odd iteration
starting on the tile that the last one ended on, and the bytes kept on chip
as the plan reports them.

hill_climb_study.emulate_bf16 replays the kernel's arithmetic at n = 2,048,
m = 100, d = 128: S = bf16(Z) X^T in wgmma steps of 16 dims (exact bf16
products, float32 sums), W = bf16(2^(kappa log2(e) S)) as the kernel's
ex2.approx computes it, each block's W X over its tiles in the schedule's
order in steps of 16 pixels, the partials in 8 groups of blocks, the row
norm as the reducing warp computes it; at the plan's grid (32 blocks of one
tile) and at 3 blocks (8 kept tiles and 2 or 3 streamed ones each).  Z after 10 iterations must be within 1e-3 of the
plain version (cuda_mean_shift.hill_climb_reference, which rounds at the
same points; the bound the card tests hold the kernel to) and within 2e-2
of the JAX package's hill_climb_pallas (interpret mode), with the connected
components of Z equal to the plain version's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hill_climb_study import (BW_RESIDENT, BW_STAGES, BW_TILE, ITERS, KAPPA,
                              SMS, bf16_wide_resident_bytes,
                              bf16_wide_schedule, emulate_bf16)
from unseenobjectclustering_torch.ops import cuda_mean_shift as cms
from unseenobjectclustering_tpu.ops import pallas_mean_shift as jpms

torch.set_num_threads(1)

D = 128
# n of the card tests at width 128 (tests/test_torch_cuda_kernels.py) and
# of chip_smoke.py's phase 2c: the 480x640 frame and both crop sides
CARD_NS = [100, 3001, 70001, 20000, 1, 33, 32 * 132 + 17, 32 * 132 * 3,
           224 * 224 + 9, 480 * 640 - 3, 64 * 100 + 5, 64 * 132 * 8,
           64 * (132 * 8 + 5) + 3, 64 * 132 * 11 + 17, 64 * 132 * 10 + 192]
SHAPES = [480 * 640, 224 * 224, 128 * 128]


@pytest.mark.parametrize("n", CARD_NS + SHAPES)
def test_schedule_sums_every_pixel_once_an_iteration(n):
    tiles = -(-n // BW_TILE)
    grid = min(SMS, tiles)
    kept = None
    last = None
    for it in range(ITERS):
        sched = bf16_wide_schedule(n, grid, it)
        seen = sorted(t for block in sched for t, _ in block)
        assert seen == list(range(tiles))
        assert sum(min(BW_TILE, n - BW_TILE * t) for t in seen) == n
        for b, block in enumerate(sched):
            assert all(t % grid == b for t, _ in block)
        now = [[(t, place) for t, place in block if place[0] == "kept"]
               for block in sched]
        assert kept is None or now == kept  # kept tiles stay in their slots
        kept = now
        for b, block in enumerate(sched):
            assert len(now[b]) == min(len(block), BW_RESIDENT)
            streamed = [(t, place) for t, place in block
                        if place[0] == "stage"]
            # the producer's q-th streamed tile of the launch goes to stage
            # q % BW_STAGES
            assert [s for _, (_, s) in streamed] == [
                (it * len(streamed) + j) % BW_STAGES
                for j in range(len(streamed))]
            if it and streamed:  # an iteration starts where the last ended
                assert streamed[0][0] == last[b][-1][0]
        last = [[e for e in block if e[1][0] == "stage"] for block in sched]
    resident = bf16_wide_resident_bytes(n, grid)
    per_block = [min(-(-(tiles - b) // grid), BW_RESIDENT)
                 for b in range(grid)]
    assert resident <= 2 * D * n
    if max(per_block) * grid >= tiles:  # every tile kept
        assert resident == 2 * D * n
    if n == 480 * 640:  # 36 or 37 tiles a block, 8 kept: 22% of X
        assert resident == SMS * BW_RESIDENT * BW_TILE * 2 * D
    if n in (224 * 224, 128 * 128):
        assert resident == 2 * D * n


def clustered(seed, n, k=8):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, D)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    x = centers[rng.choice(k, size=n)] + 0.3 * rng.randn(n, D) / np.sqrt(D)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


@pytest.mark.parametrize("grid", [None, 3])
def test_bf16_wide_emulation_matches_the_plain_version_and_pallas(grid):
    n, m = 2048, 100
    x32 = clustered(41, n)
    z0 = x32[np.random.RandomState(42).choice(n, m, replace=False)]
    x = torch.from_numpy(x32).bfloat16()
    z = emulate_bf16(x, torch.from_numpy(z0), grid)
    plain = cms.hill_climb_reference(x, torch.from_numpy(z0), kappa=KAPPA,
                                     max_iters=ITERS)
    assert float((z - plain).abs().max()) <= 1e-3
    want = jpms.hill_climb_pallas(jnp.asarray(x32).astype(jnp.bfloat16),
                                  jnp.asarray(z0), kappa=KAPPA,
                                  max_iters=ITERS)
    assert float((z - torch.from_numpy(np.array(want))).abs().max()) <= 2e-2
    labels = cms.connected_components_reference(z, 0.04)
    assert torch.equal(labels, cms.connected_components_reference(plain,
                                                                  0.04))
    assert int(labels.max()) > 0  # more than one cluster
