"""Conv -> CMVM reshaping (FK and PK): the port's matrices and accounting
against the reference's, bitwise; its torch forwards and window extractions
within 1e-5 of the reference's ``jnp``/``lax`` ones on the same inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import conv_reshape as jcr
from repro_torch.core import conv_reshape as tcr

TOL = 1e-5
SHAPES = [(4, 3, 3, 8), (2, 5, 3, 6), (6, 2, 5, 9)]


def _inputs(n, k, o, z, seed=0):
    rng = np.random.default_rng(seed)
    kern = rng.standard_normal((n, k, o, o))
    x = rng.standard_normal((2, k, z, z)).astype(np.float32)
    return kern, x


@pytest.mark.parametrize("n,k,o,z", SHAPES)
def test_matrices_bitwise(n, k, o, z):
    kern, _ = _inputs(n, k, o, z)
    for fn in ("conv_fk_matrices", "conv_pk_matrices", "fk_group_matrix",
               "pk_group_matrix"):
        a, b = getattr(jcr, fn)(kern), getattr(tcr, fn)(kern)
        assert a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("n,k,o,z", SHAPES)
def test_forwards_match_jax(n, k, o, z):
    kern, x = _inputs(n, k, o, z, seed=1)
    k32 = kern.astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    ref_j = np.asarray(jcr.conv_forward_reference(xj, jnp.asarray(k32)))
    ref_t = tcr.conv_forward_reference(xt, torch.from_numpy(k32)).numpy()
    np.testing.assert_allclose(ref_t, ref_j, rtol=0, atol=TOL)
    fk = tcr.conv_fk_matrices(k32)
    np.testing.assert_allclose(
        tcr.conv_forward_fk(xt, torch.from_numpy(fk)).numpy(),
        np.asarray(jcr.conv_forward_fk(xj, jnp.asarray(fk))), rtol=0, atol=TOL)
    pk = tcr.conv_pk_matrices(k32)
    got = tcr.conv_forward_pk(xt, torch.from_numpy(pk), n).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jcr.conv_forward_pk(xj, jnp.asarray(pk), n)),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(got, ref_t, rtol=0, atol=TOL)


@pytest.mark.parametrize("o,stride", [(3, 1), (3, 2), (2, 3)])
def test_windows_equal(o, stride):
    _, x = _inputs(2, 3, o, 9, seed=2)
    for fn in ("extract_patches", "extract_vert_windows"):
        a = np.asarray(getattr(jcr, fn)(jnp.asarray(x), o, stride))
        b = getattr(tcr, fn)(torch.from_numpy(x), o, stride).numpy()
        assert a.shape == b.shape and np.array_equal(a, b)


def test_padding_and_adds_equal():
    for z in range(1, 12):
        for o in (1, 3, 5):
            for s in (1, 2, 3):
                assert tcr.same_pad_2d(z, o, s) == jcr.same_pad_2d(z, o, s)
    per = [17, 0, 33, 5]
    for method in ("fk", "pk"):
        for nz in (None, 2):
            assert tcr.conv_layer_adds(per, 8, 3, method, nz) == \
                jcr.conv_layer_adds(per, 8, 3, method, nz)
    with pytest.raises(ValueError):
        tcr.conv_layer_adds(per, 8, 3, "xx")
