"""Mamba2 (the hybrid family's SSD layer) on the port against
``repro.models.mamba2``, at reduced widths (d_model 64, d_inner 128,
d_state 16, 8 heads of 16, d_conv 4), parameters from the reference's
``init_mamba2`` (float32, with seeded non-trivial ``A_log``, ``D``,
``dt_bias``, ``conv_b`` and ``norm_w`` so each term shows) carried across by
``convert.params_from_numpy``.

The depthwise causal conv (the reference's ``conv_general_dilated``,
``F.conv1d(groups=Cd)`` here) from zeros and from a carried window; the
SSD prefill over five chunks, and at ``S < d_conv - 1`` (the conv tail
padded); decode steps from the prefill's state.  Outputs and states within
``1e-5 * max(1, max|ref|)``: both packages evaluate the chunk scan's
``exp`` of cumulative log decays and the softplus in float32 with their own
``exp``/``log1p`` (an ulp apart on some inputs, as ``tests/test_torch_mrope.py``
shows) and sum the chunk products in other orders; measured below 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jm

from repro_torch.convert import params_from_numpy
from repro_torch.models import mamba2 as tm

D, DI, DS, HD, DC = 64, 128, 16, 16, 4
DIMS = dict(d_inner=DI, d_state=DS, head_dim=HD, d_conv=DC)
TOL = 1e-5


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def params():
    p = jax.tree.map(np.array, jm.init_mamba2(
        jax.random.PRNGKey(0), D, dtype=jnp.float32, **DIMS))
    rng = np.random.default_rng(1)
    h = DI // HD
    p["A_log"] = rng.uniform(-1, 1, h).astype(np.float32)
    p["D"] = rng.uniform(0.5, 1.5, h).astype(np.float32)
    p["dt_bias"] = rng.uniform(-2, 1, h).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(np.float32)
    p["norm_w"] = rng.uniform(0.5, 1.5, DI).astype(np.float32)
    tp = params_from_numpy(p, None, "cpu", _dtype=torch.float32)
    return jax.tree.map(jnp.asarray, p), tp


def _x(seed, s, d=D, b=2):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv_matches_reference(params, carried):
    jp, tp = params
    cd = DI + 2 * DS
    xbc = _x(2, 7, cd)
    prev = (np.random.default_rng(3).standard_normal((2, cd, DC - 1))
            .astype(np.float32) if carried else None)
    want = jm._causal_conv(jnp.asarray(xbc), jp["conv_w"], jp["conv_b"],
                           None if prev is None else jnp.asarray(prev))
    got = tm._causal_conv(torch.from_numpy(xbc), tp["conv_w"], tp["conv_b"],
                          None if prev is None else torch.from_numpy(prev))
    assert got.shape == want.shape == (2, 7, cd)
    _close(got, want)


@pytest.mark.parametrize("s", [40, 2])
def test_prefill_matches_reference(params, s):
    """S = 40 at chunk 16 -> 8: five chunks; S = 2 < d_conv - 1: the conv
    tail is left-padded with zeros."""
    jp, tp = params
    x = _x(4, s)
    jy, jst = jm.mamba2_prefill(jp, jnp.asarray(x), chunk=16, **DIMS)
    ty, tst = tm.mamba2_prefill(tp, torch.from_numpy(x), chunk=16, **DIMS)
    _close(ty, jy)
    _close(tst.ssm, jst.ssm)
    _close(tst.conv, jst.conv)
    assert tst.conv.shape == (2, DI + 2 * DS, DC - 1)
    if s < DC - 1:
        assert not tst.conv[..., : DC - 1 - s].any()


def test_decode_matches_reference(params):
    jp, tp = params
    x = _x(5, 8)
    _, jst = jm.mamba2_prefill(jp, jnp.asarray(x[:, :5]), chunk=16, **DIMS)
    tst = tm.Mamba2State(ssm=torch.from_numpy(np.array(jst.ssm)),
                         conv=torch.from_numpy(np.array(jst.conv)))
    for t in range(5, 8):
        xt = x[:, t:t + 1]
        jy, jst = jm.mamba2_decode(jp, jnp.asarray(xt), jst, **DIMS)
        ty, tst = tm.mamba2_decode(tp, torch.from_numpy(xt), tst, **DIMS)
        _close(ty, jy)
        _close(tst.ssm, jst.ssm)
        _close(tst.conv, jst.conv)
    # decode == prefill over the same tokens
    ty_all, st_all = tm.mamba2_prefill(tp, torch.from_numpy(x), chunk=16,
                                       **DIMS)
    np.testing.assert_allclose(_np(ty), _np(ty_all[:, -1:]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tst.ssm), _np(st_all.ssm), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tst.conv), _np(st_all.conv), rtol=0,
                               atol=1e-5)
