"""The port's embedding loss against the JAX package's, on value and on
gradient (jax.grad against autograd), and the port's train-mode BatchNorm
against flax's.

The same seeded numpy embeddings and labels go through
unseenobjectclustering_tpu.models.losses.embedding_loss and
unseenobjectclustering_torch.models.losses.embedding_loss.

Tolerances: loss terms within rtol 1e-5 (float32 sums in another order);
gradients within atol 1e-7 + rtol 1e-4 of the largest entry; BatchNorm
running statistics within 1e-5 (flax computes the variance as
E[x^2] - E[x]^2, torch in two passes).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unseenobjectclustering_torch.models import losses as tl
from unseenobjectclustering_torch.models import resnet as tresnet
from unseenobjectclustering_tpu.models import losses as jl

torch.set_num_threads(1)

B, H, W, C = 2, 12, 16, 8
KW = dict(alpha=0.02, delta=0.5, lambda_intra=10.0, lambda_inter=10.0)


def embeddings(seed=0, unit=True):
    x = np.random.RandomState(seed).randn(B, H, W, C).astype(np.float32)
    if unit:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
    return x


def labels(seed=0, k=4, low=-1):
    return np.random.RandomState(seed + 100).randint(
        low, k, size=(B, H, W)).astype(np.int32)


def both(x, lab, max_k=8, metric="cosine", **kw):
    """(value, grad) of the total loss and the two terms, JAX and port."""
    kw = dict(KW, **kw)

    def jf(xx):
        out = jl.embedding_loss(xx, jnp.asarray(lab), max_k=max_k,
                                metric=metric, **kw)
        return out.loss, out

    (jv, jout), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    tout = tl.embedding_loss(xt, torch.from_numpy(lab), max_k=max_k,
                             metric=metric, **kw)
    tout.loss.backward()
    j = (np.asarray(jout.loss), np.asarray(jout.intra),
         np.asarray(jout.inter), np.asarray(jg))
    t = (tout.loss.detach().numpy(), tout.intra.detach().numpy(),
         tout.inter.detach().numpy(), xt.grad.numpy())
    return j, t


def assert_close(j, t):
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-8)
    scale = max(np.abs(j[3]).max(), 1e-30)
    np.testing.assert_allclose(t[3], j[3], atol=1e-7 + 1e-4 * scale)
    assert np.isfinite(t[3]).all()


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("case", ["plain", "ignore", "beyond_max_k"])
def test_loss_and_gradient_match_jax(metric, case):
    x = embeddings(1)
    if case == "plain":
        lab, max_k = labels(1, k=4, low=0), 8
    elif case == "ignore":
        lab, max_k = labels(2, k=5, low=-1), 8
    else:  # ids 4..6 lie beyond max_k = 4 and count as unlabeled
        lab, max_k = labels(3, k=7, low=-1), 4
    # euclidean distances between unit means are ~sqrt(2): a wider margin
    # keeps the hinge active
    delta = 0.5 if metric == "cosine" else 1.6
    j, t = both(x, lab, max_k=max_k, metric=metric, delta=delta)
    assert float(j[1]) > 0 and float(j[2]) > 0
    assert_close(j, t)


def test_loss_without_hard_negatives():
    """Every pixel at its cluster's mean: the intra term is 0 (any_hard is
    false) and only the inter term and its gradient remain."""
    rng = np.random.RandomState(4)
    centres = rng.randn(3, C).astype(np.float32)
    centres /= np.linalg.norm(centres, axis=-1, keepdims=True)
    lab = rng.randint(0, 3, size=(B, H, W)).astype(np.int32)
    x = centres[lab]
    j, t = both(x, lab)
    assert float(j[1]) == 0.0 and float(t[1]) == 0.0
    assert_close(j, t)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_loss_without_labels_has_a_finite_gradient(metric):
    lab = np.full((B, H, W), -1, np.int32)
    j, t = both(embeddings(5), lab, metric=metric)
    assert float(t[0]) == 0.0
    assert_close(j, t)
    np.testing.assert_array_equal(t[3], 0.0)


def test_cluster_means_match_jax():
    x, lab = embeddings(6, unit=False), labels(6, k=5)
    jm, jc = jl.compute_cluster_means(jnp.asarray(x), jnp.asarray(lab), 8)
    tm, tc = tl.compute_cluster_means(torch.from_numpy(x),
                                      torch.from_numpy(lab), 8)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("shape", [(2, 3, 2, 2), (4, 16, 6, 5)])
def test_batchnorm_train_statistics_match_flax(shape):
    """Train-mode BatchNorm: same output, and running statistics updated
    with the BIASED batch variance (torch's nn.BatchNorm2d writes the
    unbiased one, larger by n/(n-1))."""
    b, c, h, w = shape
    rng = np.random.RandomState(7)
    x = (2.0 * rng.randn(b, c, h, w) + 0.5).astype(np.float32)
    mean0 = (0.1 * rng.randn(c)).astype(np.float32)
    var0 = (0.5 + rng.rand(c)).astype(np.float32)
    scale = (0.5 + rng.rand(c)).astype(np.float32)
    bias = (0.1 * rng.randn(c)).astype(np.float32)

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9,
                      epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    jy, mutated = bn.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                           mutable=["batch_stats"])

    tbn = tresnet.BatchNorm2d(c)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(mean0))
        tbn.running_var.copy_(torch.from_numpy(var0))
    tbn.train()
    ty = tbn(torch.from_numpy(x))
    np.testing.assert_allclose(ty.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               atol=1e-5)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               atol=1e-5)
    # torch's own update would have written the unbiased variance
    plain = torch.nn.BatchNorm2d(c)
    with torch.no_grad():
        plain.running_var.copy_(torch.from_numpy(var0))
    plain.train()(torch.from_numpy(x))
    assert not np.allclose(plain.running_var.numpy(),
                           tbn.running_var.numpy(), atol=1e-5)
    # eval mode is torch's and uses the running statistics
    tbn.eval()
    jy_eval = nn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": mutated["batch_stats"]},
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(
        tbn(torch.from_numpy(x)).detach().numpy().transpose(0, 2, 3, 1),
        np.asarray(jy_eval), atol=1e-5)
