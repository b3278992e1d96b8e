"""RWKV-6 (the ssm family's time-mix and channel-mix) on the port against
``repro.models.rwkv6``, at reduced widths (d 64, 4 heads of 16, d_ff 96),
parameters from the reference's ``init_rwkv6`` / ``init_rwkv6_channelmix``
(float32, with a seeded non-trivial ``mix_mu`` and ``w0`` so every mix and
decay differs) carried across by ``convert.params_from_numpy``.

The chunked prefill over five chunks from a zero and from a carried state,
the decode step (a few tokens from the prefill's state) and the channel
mix with and without a carried token shift: outputs and states within
``1e-5 * max(1, max|ref|)``.  Both packages evaluate the decay
``exp(-exp(.))`` and the chunk scan's ``exp(cumsum)`` in float32 with their
own ``exp`` (XLA's and ATen's differ by an ulp on some inputs, as
``tests/test_torch_mrope.py`` shows), and the chunk products sum in other
orders; measured at most 3e-7 of the outputs' scale.  The decode step's
grouped r/k/v/g input is four equally spaced slices of one stacked buffer,
the layout ``shared_matmul.region_layout`` takes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jr

from repro_torch.convert import params_from_numpy
from repro_torch.kernels.shared_matmul import region_layout
from repro_torch.models import rwkv6 as tr

D, HD, DFF = 64, 16, 96
TOL = 1e-5


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def params():
    tm = jax.tree.map(np.array, jr.init_rwkv6(jax.random.PRNGKey(0), D,
                                              head_dim=HD, dtype=jnp.float32))
    rng = np.random.default_rng(1)
    tm["mix_mu"] = rng.uniform(0, 1, tm["mix_mu"].shape).astype(np.float32)
    tm["w0"] = rng.uniform(-6, -1, tm["w0"].shape).astype(np.float32)
    tm["mix_A"] *= 30  # LoRA terms that move the mixes and the decay
    tm["wA"] *= 30
    cm = jax.tree.map(np.array, jr.init_rwkv6_channelmix(
        jax.random.PRNGKey(1), D, DFF, jnp.float32))
    cm["mix_mu_k"] = rng.uniform(0, 1, cm["mix_mu_k"].shape).astype(np.float32)
    conv = {"tm": tm, "cm": cm}
    tp = params_from_numpy(conv, None, "cpu", _dtype=torch.float32)
    return jax.tree.map(jnp.asarray, conv), tp


def _x(seed, s, b=2):
    return np.random.default_rng(seed).standard_normal((b, s, D)).astype(np.float32)


@pytest.mark.parametrize("carried", [False, True])
def test_timemix_prefill_matches_reference(params, carried):
    jp, tp = params
    x = _x(2, 40)  # chunk 16 -> 8: five chunks
    jstate = tstate = None
    if carried:
        rng = np.random.default_rng(3)
        wkv = rng.standard_normal((2, D // HD, HD, HD)).astype(np.float32)
        xp = rng.standard_normal((2, D)).astype(np.float32)
        jstate = jr.RWKV6State(wkv=jnp.asarray(wkv), x_prev=jnp.asarray(xp))
        tstate = tr.RWKV6State(wkv=torch.from_numpy(wkv),
                               x_prev=torch.from_numpy(xp))
    jy, jst = jr.rwkv6_timemix_prefill(jp["tm"], jnp.asarray(x), head_dim=HD,
                                       chunk=16, state=jstate)
    ty, tst = tr.rwkv6_timemix_prefill(tp["tm"], torch.from_numpy(x),
                                       head_dim=HD, chunk=16, state=tstate)
    _close(ty, jy)
    _close(tst.wkv, jst.wkv)
    _close(tst.x_prev, jst.x_prev)
    # one chunk covering the whole prompt gives the same function
    ty1, tst1 = tr.rwkv6_timemix_prefill(tp["tm"], torch.from_numpy(x),
                                         head_dim=HD, chunk=64, state=tstate)
    np.testing.assert_allclose(_np(ty1), _np(ty), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tst1.wkv), _np(tst.wkv), rtol=0, atol=1e-4)


class _StackedProbe:
    """An executor stand-in: every grouped region runs on the dense weights
    after checking its input layout (``region_layout``); single sites stay
    dense.  Records the member strides it saw."""

    def __init__(self, ps):
        self.ps = ps
        self.steps = []

    def matvec(self, name):
        return None

    def grouped(self, names):
        ws = [self.ps[n.split(".")[0]][n.split(".")[1]]["w"] for n in names]

        def run(xs):
            views, step = region_layout(xs, len(names))
            self.steps.append(step)
            return [w.T @ v for w, v in zip(ws, views)]
        return run


def test_timemix_decode_matches_reference(params):
    jp, tp = params
    x = _x(4, 6)
    jy, jst = jr.rwkv6_timemix_prefill(jp["tm"], jnp.asarray(x[:, :3]),
                                       head_dim=HD, chunk=16)
    tst = tr.RWKV6State(wkv=torch.from_numpy(np.array(jst.wkv)),
                        x_prev=torch.from_numpy(np.array(jst.x_prev)))
    probe = _StackedProbe(tp)
    pst = tst
    for t in range(3, 6):
        xt = x[:, t:t + 1]
        jy, jst = jr.rwkv6_timemix_decode(jp["tm"], jnp.asarray(xt), jst,
                                          head_dim=HD)
        ty, tst = tr.rwkv6_timemix_decode(tp["tm"], torch.from_numpy(xt), tst,
                                          head_dim=HD)
        _close(ty, jy)
        _close(tst.wkv, jst.wkv)
        _close(tst.x_prev, jst.x_prev)
        # the grouped route's stacked layout gives the dense route's outputs
        py, pst = tr.rwkv6_timemix_decode(tp["tm"], torch.from_numpy(xt), pst,
                                          head_dim=HD, executor=probe,
                                          site="tm.{}")
        np.testing.assert_allclose(_np(py), _np(ty), rtol=0, atol=1e-5)
    # r, k, v, g: one member stride apart in the [4, B, 1, d] stack
    assert probe.steps == [2 * D] * 3
    # decode == prefill over the same tokens
    ty_all, st_all = tr.rwkv6_timemix_prefill(tp["tm"], torch.from_numpy(x),
                                              head_dim=HD, chunk=16)
    np.testing.assert_allclose(_np(ty), _np(ty_all[:, -1:]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tst.wkv), _np(st_all.wkv), rtol=0, atol=1e-4)


@pytest.mark.parametrize("carried", [False, True])
def test_channelmix_matches_reference(params, carried):
    jp, tp = params
    x = _x(5, 9)
    last = _x(6, 1)[:, 0] if carried else None
    jy, jlast = jr.rwkv6_channelmix(
        jp["cm"], jnp.asarray(x), None if last is None else jnp.asarray(last))
    ty, tlast = tr.rwkv6_channelmix(
        tp["cm"], torch.from_numpy(x),
        None if last is None else torch.from_numpy(last))
    _close(ty, jy)
    np.testing.assert_array_equal(_np(tlast), np.asarray(jlast))
    # k and r share one input: a shared region, member stride 0
    probe = _StackedProbe(tp)
    py, _ = tr.rwkv6_channelmix(tp["cm"], torch.from_numpy(x),
                                None if last is None else torch.from_numpy(last),
                                executor=probe, site="cm.{}")
    assert probe.steps == [0]
    np.testing.assert_allclose(_np(py), _np(ty), rtol=0, atol=1e-5)


def test_group_norm_heads_matches_reference(params):
    jp, tp = params
    y = _x(7, 5) * 3 + 1
    got = tr._group_norm_heads(torch.from_numpy(y), tp["tm"]["ln_w"], D // HD)
    want = jr._group_norm_heads(jnp.asarray(y), jp["tm"]["ln_w"], D // HD)
    _close(got, want)
