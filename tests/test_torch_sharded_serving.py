"""``ServingEngine(mesh=)`` at 2 gloo ranks (one spawn,
``_torch_dist_workers.sharded_serving_run``, killed after TIMEOUT s), over
the reference's two meshes of ``tests/test_distributed.py`` — (2, 1) over
("data", "model") (the slots split over "data") and over ("model", "data")
(the dense leaves and the KV head_dim split over "model") — on three
models: the reduced olmo-1b from raw params, the reference's float32
artifact (its plan route) and that artifact in bf16 (the per-region route).
Each: generated tokens identical to the unsharded port engine and to the
reference's single-device ``ServingEngine``; logits within LOGIT_TOL of the
unsharded port engine's and of the reference's on its ``tok``/``pos`` (the
bf16 case within BF16_ULPS bf16 ulps of the reference's largest logit: the
two packages' bf16 arithmetic rounds apart, the unsharded port engine's
logits as far as the meshed ones); the plan stats and per-step launches of
the unsharded engine; each rank's stored bytes per leaf the spec's share
(the paged pool keeps its block axis whole); the collectives of one step
as predicted below; the pool stats of the unsharded engine; two prompts
sharing a prefix on slots of different data ranks served as unsharded; a
contiguous cache's engine the same tokens.  A 1 x 1 mesh gives the unsharded engine's tokens and logits bit for bit.
The MLA, vlm, ssm, hybrid and audio families and the tokenwise prefill are
served over the same meshes in ``test_torch_sharded_families*.py``."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.serving.engine import ServingEngine as JEngine

from repro_torch.convert import (artifact_from_reference,
                                 config_from_reference, params_from_numpy)
from repro_torch.distributed.device_mesh import run_ranks
from repro_torch.distributed.sharding import decode_state_pspecs

TIMEOUT = 120.0
LOGIT_TOL = 1e-4
BF16_ULPS = 4
CASES = ("raw", "plan", "bf16")
MESHES = tuple(workers.SERVE_MESHES)


def _bf16(jart):
    cfg = dataclasses.replace(jart.config, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jart.params)
    return dataclasses.replace(jart, config=cfg, params=params)


def _reference(jparams=None, jcfg=None, jart=None, max_len=64):
    """The reference engine's tokens on the workers' prompts, and its
    logits of one step at their ``tok``/``pos`` on a fresh paged state."""
    kw = dict(n_slots=4, max_len=max_len, metrics=False)
    eng = (JEngine(artifact=jart, **kw) if jart is not None
           else JEngine(jparams, jcfg, **kw))
    cfg = eng.cfg
    toks = [r.tokens for r in eng.generate(workers.SERVE_PROMPTS, 6)]
    st0 = japi.init_decode_state(cfg, 4, max_len, kv_block=16)
    logits, _ = eng._decode(eng.params, st0,
                            jnp.asarray(workers.LOGIT_TOK, jnp.int32),
                            jnp.asarray(workers.LOGIT_POS, jnp.int32))
    return dict(tokens=toks, logits=np.asarray(logits.astype(jnp.float32)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The engines' small products at one intra-op thread (as the ranks
    run them), restored for the worker's next file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases():
    """The three cases for the port (params / artifacts on the CPU) and
    the reference's outputs on each."""
    jcfg = jreduced(jget_arch("olmo-1b"))
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_reference(jcfg)
    port = {"raw": dict(params=params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, "cpu"), cfg=tcfg,
        max_len=64, contiguous=True)}
    ref = {"raw": _reference(jparams, jcfg)}
    # the reference's layer-plan mesh test's config and compression
    acfg = jreduced(jget_arch("olmo-1b"), d_model=32, n_heads=2, n_kv_heads=2,
                    head_dim=16, d_ff=48, vocab=64, n_layers=2)
    aparams = japi.init_params(jax.random.PRNGKey(0), acfg)
    jart = japi.compress_model(aparams, acfg, jcore.CompressionConfig(
        algorithm="fp", weight_sharing=True, max_share_rel_err=0.06))
    for name, art in (("plan", jart), ("bf16", _bf16(jart))):
        port[name] = dict(artifact=artifact_from_reference(art, "cpu"),
                          max_len=32)
        ref[name] = _reference(jart=art, max_len=32)
    return port, ref


@pytest.fixture(scope="module")
def run(cases):
    port, _ = cases
    return run_ranks(workers.sharded_serving_run, 2, port, timeout=TIMEOUT,
                     threads=1)


@pytest.fixture(scope="module")
def unsharded(cases):
    port, _ = cases
    return {name: workers.serve_case(case) for name, case in port.items()}


@pytest.fixture(scope="module")
def family():
    return workers.family_tokens()


def _layers(case) -> int:
    cfg = case["cfg"] if "cfg" in case else case["artifact"].config
    return cfg.n_layers


def predicted_step(case_name: str, n_layers: int, slots_split: bool) -> dict:
    """The collectives of one decode step.  Every weight of these olmo
    configs is split over both axes (both sizes divide every dimension), by
    the policy's layout: q/k/v/o and down ("model" on the input, "data" on
    the output), gate/up ("data" on the input, "model" on the output), the
    embedding ("model" on the vocabulary, "data" on d).  A use gathers its
    "data" axis (one all_gather), then all-reduces a "model"-split input or
    gathers a "model"-split output.  The step: the embedding (1 gather +
    1 all-reduce), the tied head (2 gathers), the packed tokens gathered
    over "data" when the slots split; per layer on the raw route q/k/v/o
    and down (1 gather + 1 all-reduce each), gate/up (2 gathers each) and
    the attention over the head_dim split (1 all-reduce of the scores +
    1 gather of the output); the per-region route runs the projections on
    whole compressed sites, leaving the attention's; the plan route gathers
    the K and V pools (2 gathers) for its kernels."""
    ag, ar = 1 + 2 + int(slots_split), 1
    if case_name == "raw":
        ag += n_layers * (5 + 4 + 1)
        ar += n_layers * (5 + 1)
    elif case_name == "bf16":
        ag += n_layers
        ar += n_layers
    else:
        ag += 2
    return {"all_gather": ag, "all_reduce": ar}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_tokens_equal_unsharded_and_reference(cases, run, unsharded, case,
                                             mesh):
    _, ref = cases
    r0, r1 = run[0][(case, mesh)], run[1][(case, mesh)]
    want = unsharded[case]
    assert r0["tokens"] == r1["tokens"] == want["tokens"] == ref[case]["tokens"]
    assert r0["pool"] == r1["pool"] == want["pool"]
    if case == "raw":  # the contiguous cache (its slots split too)
        assert r0["contiguous"] == r1["contiguous"] == want["contiguous"] \
            == want["tokens"]
    # the shared-prefix pair (slots 0 and 2): a prefix hit, tokens as
    # unsharded
    assert r0["shared"] == r1["shared"] == want["shared"]
    assert r0["shared_pool"] == want["shared_pool"]
    assert want["shared_pool"]["prefix_hit_tokens"] >= 16


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_logits_within_tolerance_of_the_reference(cases, run, unsharded,
                                                  case, mesh):
    _, ref = cases
    want = ref[case]["logits"]
    tol = LOGIT_TOL
    if case == "bf16":  # ulp(x) = 2^(floor(log2 |x|) - 7)
        tol = BF16_ULPS * 2.0 ** (math.floor(math.log2(np.abs(want).max()))
                                  - 7)
    for rank in (0, 1):
        got = run[rank][(case, mesh)]["logits"]
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        np.testing.assert_allclose(got, unsharded[case]["logits"], rtol=0,
                                   atol=LOGIT_TOL)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_plan_stats_and_launches_are_the_unsharded_engines(run, unsharded,
                                                           case, mesh):
    want = unsharded[case]
    for rank in (0, 1):
        got = run[rank][(case, mesh)]
        st = dict(got["plan_stats"])
        ms = st.pop("mesh")
        assert st == want["plan_stats"]
        assert st["n_layer_plans"] == (1 if case == "plan" else 0)
        assert st["fallbacks"] == ({"step": "cdtype"} if case == "bf16"
                                   else {})
        assert got["launches"] == want["launches"]
        # no fallback of the reference's: the slots split over a 2-way
        # "data" axis, and there is no batch axis to split over "model"
        assert ms["fallbacks"] == {}
        split = mesh == "data"
        assert ms["slot_axes"] == ("data" if split else None)
        assert ms["local_slots"] == ((2 * rank, 2 * rank + 2) if split
                                     else (0, 4))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_stored_bytes_are_the_spec_share(run, case, mesh):
    """Each rank holds the policy's share of every parameter and of every
    decode-state leaf; the paged pool (``k``/``v`` ``[L, Nb, bs, Hkv,
    hd]``) keeps its block axis whole, where the policy would split it
    over the slots' axes."""
    for rank in (0, 1):
        got = run[rank][(case, mesh)]
        sizes = dict(zip(workers.SERVE_MESHES[mesh], (2, 1)))
        for name, (local, spec, whole) in got["param_leaves"].items():
            parts = math.prod(sizes[e] for e in spec if e is not None)
            assert math.prod(local) * parts == math.prod(whole), name
            assert any(e is not None for e in spec) or len(whole) <= 1, name
        for name, (local, spec, whole) in got["state_leaves"].items():
            parts = math.prod(sizes[e] for e in spec if e is not None)
            assert math.prod(local) * parts == math.prod(whole), name
        state = got["state_leaves"]
        for name in ("k", "v"):
            assert state[name][1][1] is None and state[name][1][4] == "model"
        policy = decode_state_pspecs(
            {"k": _Meta(state["k"][2])}, _MeshShape(sizes))["k"]
        assert policy[1] == "data"
        assert state["kpos"][1][1] == ("data" if mesh == "data" else None)
        assert all(e is None for e in state["block_tbl"][1])


class _Meta:
    def __init__(self, shape):
        self.shape = shape
        self.dtype = np.float32


class _MeshShape:
    def __init__(self, sizes):
        self.shape = sizes


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", CASES)
def test_collectives_per_step_as_predicted(cases, run, case, mesh):
    port, _ = cases
    for rank in (0, 1):
        got = run[rank][(case, mesh)]["step_counts"]
        assert got == predicted_step(case, _layers(port[case]),
                                     slots_split=mesh == "data"), (rank, got)


@pytest.mark.parametrize("mesh", [*MESHES, "1x1"])
def test_dry_run_reckons_the_measured_collectives(cases, run, mesh):
    """The dry run's reckoning of one decode step (``launch.dryrun
    .decode_collectives``: the port's step run on the meta device over an
    abstract mesh of the same shape) equals the collectives the raw case's
    engine issued in its step and the predictor above."""
    port, _ = cases
    split = mesh == "data"
    want = predicted_step("raw", _layers(port["raw"]), slots_split=split)
    got = run[0][("raw", mesh)]
    measured = got["counts"] if mesh == "1x1" else got["step_counts"]
    reckoned = got["reckoned"] if mesh == "1x1" else got["reckoned_step"]
    assert reckoned == measured == want


@pytest.mark.parametrize("case", CASES)
def test_one_by_one_mesh_is_the_unsharded_engine_bit_for_bit(cases, run,
                                                              case):
    port, _ = cases
    got = run[0][(case, "1x1")]
    assert got["tokens"] and got["logits"]
    assert got["launches"][0] == got["launches"][1]
    assert got["counts"] == predicted_step(case, _layers(port[case]),
                                           slots_split=False)
    assert (case, "1x1") not in run[1]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", workers.FAMILY_ARCHS)
def test_the_family_serves_as_unsharded(run, family, arch, mesh):
    """qwen2.5-3b's biases gathered at use and mixtral's expert stacks (the
    experts split over "model", or their d_ff), on the dense weights and on
    the plan route: the unsharded engine's tokens on both ranks."""
    want = family
    for rank in (0, 1):
        got = run[rank][("family", mesh)]
        for use_kernel in (False, True):
            assert got[(arch, use_kernel)] == want[(arch, use_kernel)], (
                rank, use_kernel)


def test_a_rank_outside_the_mesh_raises(run):
    assert "outside the mesh" in run[1]["outside"]
    assert "outside" not in run[0]
