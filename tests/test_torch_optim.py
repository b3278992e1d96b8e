"""The port's optimizers against ``repro.optim.optimizers``: the same numpy
parameters and gradients go through both packages for three updates
(sgd, adamw, prox_sgd in both forms, the clip), the group layouts and norms
of every kind, the prox on every kind (kernel route and XLA route; in place
and not), and the schedules.  float32: <= 1e-6 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jo

from repro_torch.optim import optimizers as to

TOL = 1e-6

KINDS = (("in_cols", (12, 7)), ("in_rows", (7, 12)),
         ("in_rows", (3, 7, 12)),  # stacked layer axis
         ("conv_in_channels", (6, 5, 3, 3)))


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"fc1": {"w": rng.standard_normal((12, 7)).astype(dtype),
                    "b": rng.standard_normal((12,)).astype(dtype)},
            "blocks": {"ffn": {"w": rng.standard_normal((3, 7, 12)).astype(dtype)}},
            "mats": [rng.standard_normal((5, 4)).astype(dtype)]}


def _to_torch(tree):
    return to.tree_map(lambda a: torch.from_numpy(a.copy()), tree)


def _close(t_tree, j_tree, tol=TOL):
    for tl, jl in zip(jax.tree.leaves(to.tree_map(lambda x: x.numpy(), t_tree)),
                      jax.tree.leaves(j_tree)):
        jl = np.asarray(jl)
        assert tl.dtype == jl.dtype and tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=tol, atol=tol * max(1.0, np.abs(jl).max()))


@pytest.mark.parametrize("kind,shape", KINDS, ids=[f"{k}-{len(s)}d" for k, s in KINDS])
def test_group_view_norms_and_prox_match_the_reference(kind, shape):
    leaf = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    view = to.spec_group_view(torch.from_numpy(leaf), kind)
    np.testing.assert_array_equal(view.numpy(),
                                  np.asarray(jo.spec_group_view(jnp.asarray(leaf), kind)))
    np.testing.assert_allclose(to.spec_group_norms(torch.from_numpy(leaf), kind).numpy(),
                               np.asarray(jo.spec_group_norms(jnp.asarray(leaf), kind)),
                               rtol=TOL)
    norms = np.sort(np.linalg.norm(view.numpy(), axis=1))
    t = float(norms[1] + norms[2]) / 2  # two groups die, none near the edge
    for use_kernel in (True, False):
        want = np.asarray(jo.apply_spec_prox(jnp.asarray(leaf), kind, t,
                                             use_kernel=use_kernel))
        assert (np.abs(want).reshape(-1) == 0).any()  # some groups die
        got = to.apply_spec_prox(torch.from_numpy(leaf), kind, t,
                                 use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        inplace = torch.from_numpy(leaf.copy())
        assert to.apply_spec_prox(inplace, kind, t, use_kernel=use_kernel,
                                  inplace=True) is inplace
        np.testing.assert_array_equal(inplace.numpy(), got.numpy())


def test_bf16_group_norms_take_no_float32_copy_and_match():
    leaf = np.random.default_rng(8).standard_normal((2, 6, 40)).astype(np.float32)
    tb = torch.from_numpy(leaf).to(torch.bfloat16)
    got = to.spec_group_norms(tb, "in_rows")
    assert got.dtype == torch.float32 and got.shape == (12,)
    want = np.asarray(jo.spec_group_norms(jnp.asarray(leaf, jnp.bfloat16), "in_rows"))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL)


def _run_both(make_j, make_t, steps=3, lrs=(0.1, 0.05, 0.02)):
    params = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    jopt, topt = make_j(), make_t()
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(steps):
        g = _tree(10 + i)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, lrs[i])
        tp2, ts2 = topt.update(_to_torch(g), ts, tp, lrs[i])
        assert tp2 is tp and ts2 is ts  # in place
    return jp, js, tp, ts


OPTIMIZERS = {
    "sgd": (lambda: jo.sgd(0.9), lambda: to.sgd(0.9)),
    "sgd-nomomentum": (lambda: jo.sgd(0.0), lambda: to.sgd(0.0)),
    "adamw": (lambda: jo.adamw(), lambda: to.adamw()),
    "adamw-wd": (lambda: jo.adamw(weight_decay=0.01),
                 lambda: to.adamw(weight_decay=0.01)),
    "prox_sgd-specs": (
        lambda: jo.prox_sgd(0.9, specs=(
            jo.GroupSpec("fc1/w", ("fc1", "w"), 20.0, "in_cols"),
            jo.GroupSpec("blocks/ffn/w", ("blocks", "ffn", "w"), 20.0, "in_rows"))),
        lambda: to.prox_sgd(0.9, specs=(
            to.GroupSpec("fc1/w", ("fc1", "w"), 20.0, "in_cols"),
            to.GroupSpec("blocks/ffn/w", ("blocks", "ffn", "w"), 20.0, "in_rows")))),
    "prox_sgd-legacy": (
        lambda: jo.prox_sgd(0.9, prox_spec={"fc1": (20.0, "columns"),
                                            "mats": (20.0, "rows")}),
        lambda: to.prox_sgd(0.9, prox_spec={"fc1": (20.0, "columns"),
                                            "mats": (20.0, "rows")})),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_three_updates_match_the_reference(name):
    jp, js, tp, ts = _run_both(*OPTIMIZERS[name])
    _close(tp, jp)
    for key in js:
        if key == "t":
            assert int(ts["t"]) == int(js["t"]) == 3 and ts["t"].dtype == torch.int32
        else:
            _close(ts[key], js[key])
            assert all(x.dtype == torch.float32 for x in to.tree_leaves(ts[key]))
    if name.startswith("prox"):
        dead = int((tp["fc1"]["w"].abs().sum(0) == 0).sum())
        assert dead == int((np.abs(np.asarray(jp["fc1"]["w"])).sum(0) == 0).sum())
        assert dead > 0


def test_bf16_parameters_keep_float32_state_and_match_within_one_ulp():
    params = _tree(0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    tp = to.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), params)
    jopt, topt = jo.sgd(0.9), to.sgd(0.9)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = _tree(10 + i)
        jp, js = jopt.update(jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g),
                             js, jp, 0.1)
        topt.update(to.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16), g),
                    ts, tp, 0.1)
    for tl, jl in zip(jax.tree.leaves(to.tree_map(lambda x: x.float().numpy(), tp)),
                      jax.tree.leaves(jp)):
        jl = np.asarray(jl, np.float32)
        np.testing.assert_allclose(tl, jl, rtol=2 ** -8, atol=0)
    assert all(x.dtype == torch.float32 for x in to.tree_leaves(ts["mu"]))
    assert all(x.dtype == torch.bfloat16 for x in to.tree_leaves(tp))


def test_clip_and_global_norm_match_the_reference():
    for max_norm in (0.5, 1e3):
        g = _tree(3)
        jg, jn = jo.clip_by_global_norm(jax.tree.map(jnp.asarray, g), max_norm)
        tg = _to_torch(g)
        tg2, tn = to.clip_by_global_norm(tg, max_norm)
        assert tg2 is tg
        np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
        np.testing.assert_allclose(float(to.global_norm(_to_torch(g))),
                                   float(jo.global_norm(jax.tree.map(jnp.asarray, g))),
                                   rtol=TOL)
        _close(tg, jg)


def test_schedules_match_the_reference():
    sd_j, sd_t = jo.step_decay(0.08, 0.95, 3), to.step_decay(0.08, 0.95, 3)
    for ep in range(12):
        assert sd_t(ep) == sd_j(ep)
    cw_j, cw_t = jo.cosine_warmup(3e-3, 10, 50), to.cosine_warmup(3e-3, 10, 50)
    for s in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80):
        got = cw_t(s)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(cw_j(s)), rtol=TOL)
