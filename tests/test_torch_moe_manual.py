"""``moe_ffn_manual`` of the port against the reference's, and the reduced
mixtral with ``moe_manual`` served.

The reference's ``moe_ffn_manual`` runs unchanged in a JAX subprocess over
2 host devices (as ``tests/test_distributed.py`` runs its multi-device
cases); the port's at 2 gloo ranks (one spawn,
``_torch_dist_workers.moe_manual_run``, killed after TIMEOUT s) on the same
numpy inputs: expert parallelism (E = 4 over "model" 2), tensor
parallelism inside each expert (E = 3 does not divide), shared experts,
and the tokens split over "data" 2 with the local capacity (drops
occurring).  Every rank's output is within TOL of the reference's.  Without
a mesh it is ``moe_ffn`` (the reference's ``tests/test_models.py``
fallback test).  The reduced mixtral artifact with ``moe_manual`` serves
with the step plan refused (``"moe_manual"``), its experts off the
executor, and the reference engine's tokens — unsharded, and over the two
2 x 1 meshes (the experts split over "model", or the tokens over
"data")."""
import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models.moe import moe_ffn_manual as jmoe_ffn_manual
from repro.serving.engine import ServingEngine as JEngine

from repro_torch.convert import artifact_from_reference
from repro_torch.distributed.device_mesh import run_ranks
from repro_torch.kernels.moe_route import capacity
from repro_torch.models.moe import moe_ffn, moe_ffn_manual

TIMEOUT = 120.0
TOL = 1e-5
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
D, DFF, K = 32, 16, 2
# name -> (mesh dims over ("data", "model"), experts, shared, capacity factor)
CASES = {"ep": ((1, 2), 4, 0, 1.25), "tp": ((1, 2), 3, 0, 1.25),
         "shared": ((1, 2), 4, 1, 1.25), "tokens": ((2, 1), 4, 0, 1.0)}

_JAX_SIDE = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import compat
from repro.models.moe import moe_ffn_manual
assert jax.device_count() == 2
cases = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, c in cases.items():
    mesh = compat.make_mesh(c["dims"], ("data", "model"))
    y, _ = moe_ffn_manual(jax.tree.map(jnp.asarray, c["p"]),
                          jnp.asarray(c["x"]), n_experts=c["e"], top_k=2,
                          capacity_factor=c["cf"], mesh=mesh)
    out[name] = np.asarray(y)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _params(rng, e, n_shared):
    def tn(shape, fan_in):
        return (np.clip(rng.standard_normal(shape), -2, 2)
                * fan_in ** -0.5).astype(np.float32)
    p = {"router": tn((D, e), D), "gate": tn((e, D, DFF), D),
         "up": tn((e, D, DFF), D), "down": tn((e, DFF, D), DFF)}
    if n_shared:
        sf = n_shared * DFF
        p["shared"] = {"gate": {"w": tn((D, sf), D)},
                       "up": {"w": tn((D, sf), D)},
                       "down": {"w": tn((sf, D), sf)}}
    return p


def _cases():
    out = {}
    for i, (name, (dims, e, n_shared, cf)) in enumerate(CASES.items()):
        rng = np.random.default_rng(i)
        out[name] = dict(dims=dims, e=e, cf=cf, p=_params(rng, e, n_shared),
                         x=rng.standard_normal((2, 8, D)).astype(np.float32))
    return out


def _mixtral():
    cfg = jreduced(jget_arch("mixtral-8x22b"), d_model=32, n_heads=4,
                   n_kv_heads=2, head_dim=16, vocab=64, n_layers=2,
                   moe=jget_arch("mixtral-8x22b").moe.__class__(
                       n_experts=4, top_k=2, d_ff_expert=16,
                       capacity_factor=1.25))
    return dataclasses.replace(cfg, moe_manual=True)


@pytest.fixture(scope="module")
def mixtral():
    cfg = _mixtral()
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    jart = japi.compress_model(params, cfg, jcore.CompressionConfig(
        algorithm="fp", max_share_rel_err=0.06))
    jeng = JEngine(artifact=jart, n_slots=4, max_len=32, metrics=False)
    want = [r.tokens for r in jeng.generate(workers.SERVE_PROMPTS, 6)]
    return artifact_from_reference(jart, "cpu"), want, jeng.plan_stats()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_manual")
    src, dst = d / "in.pkl", d / "out.pkl"
    with open(src, "wb") as f:
        pickle.dump(_cases(), f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    run = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(src), str(dst)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with open(dst, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small products at one intra-op thread, restored for the worker's
    next file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(mixtral):
    art, _, _ = mixtral
    inp = {"cases": _cases(),
           "serve": dict(artifact=art, max_len=32)}
    return run_ranks(workers.moe_manual_run, 2, inp, timeout=TIMEOUT,
                     threads=1)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_manual_matches_the_reference(reference, port, case):
    want = reference[case]
    for rank in (0, 1):
        np.testing.assert_allclose(port[rank][case]["y"], want, rtol=0,
                                   atol=TOL * max(1.0, np.abs(want).max()))
    # one all-reduce over "model"; the token blocks gathered over "data"
    # (a group of one rank too)
    assert port[0][case]["counts"] == {"all_reduce": 1, "all_gather": 1}


def test_token_split_routes_with_the_local_capacity(reference):
    """Over "data" 2 each rank routes 8 of the 16 tokens at capacity
    max(4, round(8 * 2 * 1.0 / 4)) = 4, not the global 8: the reference's
    result is ``moe_ffn`` over each half (which routes 8 tokens at that
    capacity), and not ``moe_ffn`` over all 16."""
    c = _cases()["tokens"]
    assert capacity(8, K, c["cf"], c["e"]) == 4
    assert capacity(16, K, c["cf"], c["e"]) == 8
    p = workers._torch_tree(c["p"])
    x = torch.from_numpy(c["x"])
    kw = dict(n_experts=c["e"], top_k=K, capacity_factor=c["cf"])
    halves = [moe_ffn(p, x[i:i + 1], **kw) for i in (0, 1)]
    assert any(not bool(aux["keep"].all()) for _, aux in halves)
    local = torch.cat([y for y, _ in halves]).numpy()
    want = reference["tokens"]
    np.testing.assert_allclose(local, want, rtol=0,
                               atol=TOL * max(1.0, np.abs(want).max()))
    whole, _ = moe_ffn(p, x, **kw)
    assert np.abs(whole.numpy() - want).max() > 1e-3


@pytest.mark.parametrize("n_shared", [0, 1])
def test_without_a_mesh_it_is_moe_ffn(n_shared):
    rng = np.random.default_rng(0)
    c = dict(p=_params(rng, 4, n_shared),
             x=rng.standard_normal((2, 8, D)).astype(np.float32))
    kw = dict(n_experts=4, top_k=K, capacity_factor=8.0)
    p = workers._torch_tree(c["p"])
    x = torch.from_numpy(c["x"])
    y0, _ = moe_ffn(p, x, **kw)
    y1, _ = moe_ffn_manual(p, x, mesh=None, **kw)
    assert torch.equal(y0, y1)
    jy, _ = jmoe_ffn_manual(jax.tree.map(np.asarray, c["p"]), c["x"],
                            mesh=None, **kw)
    np.testing.assert_allclose(y1.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)


def test_reduced_mixtral_moe_manual_serves_as_the_reference(mixtral, port):
    """Unsharded: the plan refused by name, no expert site routed, the
    reference engine's tokens; over both 2 x 1 meshes the same tokens (the
    slots replicate, as the MoE family's do, and ``moe_ffn_manual`` splits
    them over "data" or the experts over "model")."""
    from repro_torch.serving.engine import ServingEngine

    art, want, jstats = mixtral
    eng = ServingEngine(artifact=art, n_slots=4, max_len=32, device="cpu")
    got = [r.tokens for r in eng.generate(workers.SERVE_PROMPTS, 6)]
    assert got == want
    assert eng.plan_stats()["fallbacks"] == jstats["fallbacks"] == \
        {"step": "moe_manual"}
    assert not any(n.startswith("moe.") for n in eng.executor.routed)
    assert eng.executor.routed == {n for n in eng.executor.sites
                                   if not n.startswith("moe.")}
    for mesh in workers.SERVE_MESHES:
        for rank in (0, 1):
            r = port[rank][("serve", mesh)]
            assert r["tokens"] == want, (mesh, rank)
            assert r["stats"]["fallbacks"] == {"step": "moe_manual"}
            # the slots replicate over a "data" axis of 2 ranks
            assert r["stats"]["mesh"]["fallbacks"] == (
                {"slots": "replicate:moe"} if mesh == "data" else {})
            assert not any(n.startswith("moe.") for n in r["routed"])
