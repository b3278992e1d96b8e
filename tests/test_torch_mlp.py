"""The paper's MLP (Sec. IV-A) in the port against ``repro.models.mlp``: the
stroke-digit data and the epoch shuffler bit for bit, forward / loss /
accuracy on converted parameters, a few ProxSGD steps with the site-derived
``in_cols`` groups (<= 1e-5), and the ``--arch mlp`` launcher on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.data import mnist_like as jmn
from repro.data.synthetic import batches as jbatches
from repro.models import mlp as jmlp
from repro.optim import optimizers as jo
from repro.training import regularize as jreg

from repro_torch.convert import mlp_params_from_numpy
from repro_torch.data import mnist_like as tmn
from repro_torch.data.synthetic import batches as tbatches
from repro_torch.models import mlp as tmlp
from repro_torch.optim import optimizers as to
from repro_torch.training import regularize as treg

TOL = 1e-5


def test_data_is_bitwise_the_reference():
    for seed in (0, 3):
        (xa, ya), (xb, yb) = tmn.train_test(40, 12, seed=seed)
        (ja, jya), (jb, jyb) = jmn.train_test(40, 12, seed=seed)
        for got, want in ((xa, ja), (ya, jya), (xb, jb), (yb, jyb)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    x, y = tmn.mnist_like(30, seed=1)
    for (tx, ty), (jx, jy) in zip(tbatches(x, y, 8, seed=2), jbatches(x, y, 8, seed=2)):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
    assert len(list(tbatches(x, y, 8, seed=2))) == 3  # the partial batch is dropped


def test_forward_loss_accuracy_and_prox_steps_match_the_reference():
    hidden = 40
    jp = jmlp.init_mlp(jax.random.PRNGKey(0), hidden=hidden)
    tp = mlp_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["fc1"]["w"].shape == (hidden, 784) and tp["fc1"]["w"].dtype == torch.float32
    (xs, ys), (xt, yt) = tmn.train_test(96, 64, seed=0)
    np.testing.assert_allclose(
        tmlp.mlp_forward(tp, torch.from_numpy(xt)).numpy(),
        np.asarray(jmlp.mlp_forward(jp, jnp.asarray(xt))), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        float(tmlp.mlp_loss(tp, torch.from_numpy(xt), torch.from_numpy(yt))),
        float(jmlp.mlp_loss(jp, jnp.asarray(xt), jnp.asarray(yt))), rtol=TOL)

    cfg_j, cfg_t = jmlp.MLPConfig(hidden=hidden), tmlp.MLPConfig(hidden=hidden)
    jspecs = jreg.site_group_specs(jp, cfg_j, 1.5)
    tspecs = treg.site_group_specs(tp, cfg_t, 1.5)
    jopt, topt = jo.prox_sgd(0.9, specs=jspecs), to.prox_sgd(0.9, specs=tspecs)
    js, ts = jopt.init(jp), topt.init(tp)
    jgrad = jax.jit(jax.grad(jmlp.mlp_loss))
    leaves = to.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    for xb, yb in tbatches(xs, ys, 32, seed=0):
        jp, js = jopt.update(jgrad(jp, jnp.asarray(xb), jnp.asarray(yb)), js, jp, 0.08)
        loss = tmlp.mlp_loss(tp, torch.from_numpy(xb), torch.from_numpy(yb))
        it = iter(torch.autograd.grad(loss, leaves))
        topt.update(to.tree_map(lambda _: next(it), tp), ts, tp, 0.08)
    for path, jl in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp)):
        keys = [k.key for k in path]
        np.testing.assert_allclose(to.tree_get(tp, keys).detach().numpy(), jl,
                                   rtol=TOL, atol=TOL)
    trep, jrep = treg.sparsity_report(tp, tspecs), jreg.sparsity_report(jp, jspecs)
    assert treg.dead_group_fraction(trep) == jreg.dead_group_fraction(jrep) > 0
    with torch.no_grad():
        np.testing.assert_allclose(
            float(tmlp.mlp_accuracy(tp, torch.from_numpy(xt), torch.from_numpy(yt))),
            float(jmlp.mlp_accuracy(jp, jnp.asarray(xt), jnp.asarray(yt))), atol=1e-6)
    det = treg.detailed_group_report(tp, tspecs)
    for name, norms in jreg.detailed_group_report(jp, jspecs).items():
        np.testing.assert_allclose(det[name], norms, rtol=TOL, atol=TOL)


def test_mlp_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import train

    stats = train.main(["--arch", "mlp", "--device", "cpu", "--prox",
                        "--lambda", "0.1", "--epochs", "1", "--train-n", "512",
                        "--test-n", "128"])
    out = capsys.readouterr().out
    assert "epoch   0  dead groups" in out and "train: accuracy" in out
    assert stats["steps"] == 4 and 0.0 <= stats["accuracy"] <= 1.0
    assert 0.0 <= stats["dead_group_fraction"] <= 1.0
    assert stats["group_prox_launches"] == 0  # the plain version on the CPU
