"""Weight sharing: the port's clustering against the reference's on the same
seeded numpy inputs, bitwise (labels with ties broken by the same
``np.random.default_rng(seed)`` jitter, centroids), and its tensor helpers
(eq. (10) and (9)) within 1e-6 (relative, 1e-6 absolute near zero) of the
reference's ``jnp`` ones: both sum in float32, in their own orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import weight_sharing as jws
from repro_torch.core import weight_sharing as tws

TOL = 1e-6


def _cols(seed, n=12, k=30, dup=True):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k))
    if dup:  # exact duplicates and an exact tie of distances
        w[:, 5] = w[:, 3]
        w[:, 9] = w[:, 3]
        w[:, 11] = 2.0 * w[:, 10] - w[:, 12]
    return w


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kw", [{}, {"damping": 0.9, "preference": -5.0},
                                {"seed": 3, "max_iter": 40}])
def test_affinity_propagation_bitwise(seed, kw):
    cols = _cols(seed).T
    d2 = np.sum(cols ** 2, axis=1, keepdims=True)
    sim = -(d2 + d2.T - 2.0 * cols @ cols.T)
    a = jws.affinity_propagation(sim, **kw)
    b = tws.affinity_propagation(sim, **kw)
    assert a.dtype == b.dtype and np.array_equal(a, b)
    # an all-equal similarity: every tie broken by the jitter alone
    flat = np.zeros((7, 7))
    assert np.array_equal(jws.affinity_propagation(flat, **kw),
                          tws.affinity_propagation(flat, **kw))
    assert np.array_equal(tws.affinity_propagation(np.zeros((1, 1))), [0])


@pytest.mark.parametrize("seed", [0, 2])
def test_cluster_columns_bitwise(seed):
    w = _cols(seed)
    for kw in ({}, {"damping": 0.8, "preference": -2.0}):
        (la, ca), (lb, cb) = jws.cluster_columns(w, **kw), tws.cluster_columns(w, **kw)
        assert np.array_equal(la, lb) and ca.tobytes() == cb.tobytes()
    for c in (1, 4, 9, 30, 50):
        (la, ca), (lb, cb) = (jws.cluster_columns_fixed(w, c),
                              tws.cluster_columns_fixed(w, c))
        assert la.dtype == lb.dtype and np.array_equal(la, lb)
        assert ca.tobytes() == cb.tobytes()


def test_shared_layer_accounting():
    w = _cols(4)
    labels, cents = tws.cluster_columns(w)
    a, b = jws.SharedLayer(cents, labels), tws.SharedLayer(cents, labels)
    assert b.pre_aggregation_adds() == a.pre_aggregation_adds()
    assert np.array_equal(b.expand(), a.expand())


@pytest.mark.parametrize("lead", [(), (3,), (2, 4)])
def test_tensor_helpers_match_jnp(lead):
    rng = np.random.default_rng(5)
    w = _cols(5)
    labels, cents = tws.cluster_columns(w)
    labels16 = labels.astype(np.uint16)  # the stored deployment width
    x = rng.standard_normal(lead + (w.shape[1],)).astype(np.float32)
    c32 = cents.astype(np.float32)
    want = jws.shared_matvec(jnp.asarray(c32), jnp.asarray(labels), jnp.asarray(x))
    got = tws.shared_matvec(torch.from_numpy(c32), labels16, torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        tws.expand_centroids(torch.from_numpy(c32), torch.from_numpy(labels)).numpy(),
        np.asarray(jws.expand_centroids(jnp.asarray(c32), jnp.asarray(labels))))
    g = rng.standard_normal(lead + w.shape).astype(np.float32)
    want_g = jws.centroid_grad_from_member_grads(g, labels, cents.shape[1])
    got_g = tws.centroid_grad_from_member_grads(torch.from_numpy(g), labels,
                                                cents.shape[1])
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=TOL,
                               atol=TOL)
    # eq. (10) equals the dense product with the expanded centroids
    dense = torch.from_numpy(x) @ tws.expand_centroids(torch.from_numpy(c32),
                                                       labels16).T
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=1e-5)
