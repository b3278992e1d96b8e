"""The port's sharded train step at 2 gloo ranks (one spawn,
``_torch_dist_workers.step_run``, killed after TIMEOUT s) on the reduced
olmo-1b under ProxSGD over every site: over 2 x 1 and 1 x 2 meshes two
steps within MESH_TOL of the unsharded port step (the batch halves' float32
gradient sums round differently) and each rank's stored bytes per leaf the
spec's share; over a 1 x 1 mesh bit for bit the unsharded step, with the
collectives the specs predict.  The compressed step at 2 pods against the
reference's recipe rebuilt in this process from its own functions (vmap of
``value_and_grad(api.train_loss)`` over the pod-split batch,
``compressed_psum`` under ``vmap(axis_name="pod")``, ``clip_by_global_norm``,
``optimizer.update``, as ``trainer.py``'s shard_map step does): the
momentum (the clipped mean gradient) and the residuals within one
quantization step of their row per element, where a rounding tie can flip
on gradients that differ in their last bits; at 1 pod the residuals go
from the reference default's 2 rows to 1, as in the reference."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.distributed import compress_grads as jcg
from repro.models import api as japi
from repro.optim import optimizers as jo
from repro.training import regularize as jreg
from repro.training import trainer as jtr

from repro_torch.convert import train_state_from_numpy
from repro_torch.data.synthetic import MarkovLM
from repro_torch.distributed.device_mesh import run_ranks
from repro_torch.training import trainer as ttr

TIMEOUT = 120.0
MESH_TOL = 1e-6  # |sharded - unsharded| <= MESH_TOL * max(1, |unsharded|)
LR = workers.LR


def _batches(n=2, b=4, s=16):
    return [MarkovLM(vocab=256, k=8, seed=0).batch(b, s, seed=i)
            for i in range(n)]


def _ref_state():
    jcfg = jreduced(jget_arch("olmo-1b"), vocab=256)
    specs = jreg.site_group_specs(japi.abstract_params(jcfg), jcfg, workers.LAM)
    jopt = jo.prox_sgd(momentum=0.9, specs=specs)
    js = jtr.init_train_state(jax.random.PRNGKey(0), jcfg, jopt,
                              grad_compression=True, prox_specs=specs)
    return jcfg, jopt, js


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    jcfg, _, js = _ref_state()
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js),
                                workers.reduced_olmo(), "cpu")
    inp = {"batches": _batches(), "efb_state": ts}
    return inp, run_ranks(workers.step_run, 2, inp, timeout=TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def unsharded(run):
    inp, _ = run
    cfg = workers.reduced_olmo()
    opt, specs = workers.prox_optimizer(cfg)
    state = ttr.init_train_state(0, cfg, opt, prox_specs=specs, device="cpu")
    step = ttr.make_train_step(cfg, opt, lr=LR, prox_specs=specs)
    metrics = []
    for b in inp["batches"]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return workers.flat_np(state), metrics


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_meshed_step_at_two_ranks_matches_the_unsharded_step(run, unsharded,
                                                             mesh):
    _, out = run
    want, want_m = unsharded
    sizes = dict(zip(("data", "model"), map(int, mesh.split("x"))))
    for r in range(2):
        got = out[r][mesh]
        assert sorted(got["state"]) == sorted(want)
        for k, v in want.items():
            tol = MESH_TOL * max(1.0, float(np.abs(v).max()))
            np.testing.assert_allclose(got["state"][k], v, rtol=0, atol=tol,
                                       err_msg=k)
        for gm, wm in zip(got["metrics"], want_m):
            for k, v in wm.items():
                assert abs(gm[k] - v) <= MESH_TOL * max(1.0, abs(v)), k
        # between steps a rank stores its chunk: the spec's share of a leaf
        split = 0
        for k, v in want.items():
            parts = math.prod(sizes[a] for e in got["specs"][k] if e
                              for a in ((e,) if isinstance(e, str) else e))
            split += parts > 1
            assert got["stored"][k] * parts == v.nbytes, k
        assert split > 0
    # both ranks hold the same whole state after gathering
    for k in want:
        assert out[0][mesh]["state"][k].tobytes() == out[1][mesh]["state"][k].tobytes()


def test_meshed_step_at_one_rank_is_the_unsharded_step_bit_for_bit(run,
                                                                    unsharded):
    """Rank 0's 1 x 1 mesh (rank 1 outside it): every leaf, loss and grad
    norm bitwise; the collectives are those the specs predict: a gather a
    named axis of every leaf, a float32 all-reduce a gradient leaf and one
    for the loss, each step."""
    _, out = run
    want, want_m = unsharded
    assert "1x1" not in out[1]
    got = out[0]["1x1"]
    for k, v in want.items():
        assert got["state"][k].tobytes() == v.tobytes(), k
    assert got["metrics"] == want_m
    gathers = sum(len([e for e in s if e]) for s in got["specs"].values())
    n_params = sum(k.startswith(".params/") for k in want)
    steps = len(want_m)
    assert got["counts"] == {"all_gather": gathers * steps,
                             "all_reduce": (n_params + 1) * steps}


def _ref_compressed_step(jcfg, jopt, js, batch, n_pods):
    """The reference's compressed step from its own functions (its
    ``make_train_step`` needs a device a pod)."""
    podded = {k: jnp.asarray(v).reshape(n_pods, -1, *v.shape[1:])
              for k, v in batch.items()}
    losses, grads = jax.vmap(jax.value_and_grad(
        lambda p, b: japi.train_loss(p, jcfg, b)), in_axes=(None, 0))(
        js.params, podded)
    lead = jax.tree.leaves(js.error_fb)[0].shape[0]
    rows = jax.tree.map(lambda e: e.reshape(n_pods, lead // n_pods,
                                            *e.shape[1:])[:, 0], js.error_fb)
    gh, eh = jax.vmap(lambda g, e: jcg.compressed_psum(g, e, "pod"),
                      axis_name="pod")(grads, rows)
    g_hat = jax.tree.map(lambda a: a[0], gh)
    clipped, gnorm = jo.clip_by_global_norm(g_hat, 1.0)
    params, opt_state = jopt.update(clipped, js.opt_state, js.params, LR)
    # the quantization step of each row: max over pods of the row amax / 127
    v = jax.tree.map(lambda g, e: g.astype(jnp.float32) + e, grads, rows)
    scale = jax.tree.map(lambda a: jnp.maximum(jnp.max(jnp.abs(
        a.reshape(n_pods, -1, a.shape[-1])), axis=(0, 2)), 1e-12) / 127.0, v)
    return dict(loss=float(losses.mean()), gnorm=float(gnorm), mu=opt_state["mu"],
                efb=eh, scale=scale)


def test_compressed_step_at_two_pods_matches_the_reference_recipe(run):
    inp, out = run
    jcfg, jopt, js = _ref_state()
    ref = _ref_compressed_step(jcfg, jopt, js, inp["batches"][0], 2)
    flat = jax.tree_util.tree_flatten_with_path
    for r in range(2):
        got = out[r]["pods2"]
        assert got["pod"] == r
        assert abs(got["metrics"][0]["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
        assert abs(got["metrics"][0]["grad_norm"] - ref["gnorm"]) <= 1e-4 * ref["gnorm"]
        scales = {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(s)
                  for p, s in flat(ref["scale"])[0]}
        for tag, tree in ((".opt_state/mu/", ref["mu"]), (".error_fb/", ref["efb"])):
            for path, want in flat(tree)[0]:
                name = "/".join(str(getattr(k, "key", k)) for k in path)
                want = np.asarray(want)
                have = got["state"][tag + name]
                assert have.shape == want.shape, name
                q = scales[name].reshape(-1, 1)  # one step a row
                diff = np.abs(have - want).reshape(-1, want.shape[-1]
                                                   ) if tag == ".opt_state/mu/" \
                    else np.abs(have - want).reshape(want.shape[0], -1,
                                                     want.shape[-1])
                assert np.all(diff <= q * (1 + 1e-5) + 1e-9), (tag, name)


def test_compressed_step_at_one_pod_keeps_one_residual_row(run):
    """The reference launcher never passes the mesh's pod count: the
    residuals start with its default 2 rows and, at one pod, leave the
    step with 1 (shard_map's block of both rows, its first row kept)."""
    from repro_torch.optim.optimizers import tree_leaves

    inp, out = run
    got = out[0]["pods1"]
    assert "pods1" not in out[1]
    assert {t.shape[0] for t in tree_leaves(inp["efb_state"].error_fb)} == {2}
    efb = {k: v for k, v in got["state"].items() if k.startswith(".error_fb/")}
    assert efb and all(v.shape[0] == 1 for v in efb.values())
    assert np.isfinite(got["metrics"][0]["loss"])
    assert all(np.all(np.isfinite(v)) for v in efb.values())
