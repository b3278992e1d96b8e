"""The port's collectives-side distributed modules at 4 gloo ranks (one
spawn, ``_torch_dist_workers.collectives_run``, killed after TIMEOUT s):
``compressed_psum`` and its residuals bit for bit the reference's under
``jax.vmap(axis_name="pod")`` at 1, 2 and 4 pods over two error-fed rounds
(float32 and bf16 gradients, 1-D to 3-D leaves, a zero row); GPipe at 4
stages against the sequential layers within 1e-5 and the overlapped
all-gather matmul at 4 ranks against ``x @ w`` within 1e-4 (the reference
tests' tolerances); a tuple-axis chunk and its gather; ``reshard_tree``
from a 2 x 2 mesh to two ranks bit for bit; the collectives issued."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as workers
from repro.distributed import compress_grads as jcg

from repro_torch.distributed.device_mesh import run_ranks

TIMEOUT = 120.0
SHAPES = {"w": (6, 40), "v": (33,), "s": (2, 3, 16)}
BF16 = {"w"}


def _psum_inputs(n_pods: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def grads(scale):
        g = {k: (rng.standard_normal((n_pods, *s)) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        g["w"][:, 2] = 0.0  # a zero row: the scale's 1e-12 floor
        g["w"] = np.asarray(jnp.asarray(g["w"], jnp.bfloat16).astype(jnp.float32))
        return g

    return {"g1": grads(1e-3), "g2": grads(2e-3), "bf16": BF16}


def _inputs():
    rng = np.random.default_rng(7)
    d = 16
    return {
        "psum": {n: _psum_inputs(n, n) for n in workers.POD_MESHES},
        "gpipe": {"params": {"w": (rng.standard_normal((8, d, d)) / d ** 0.5
                                   ).astype(np.float32),
                             "b": (rng.standard_normal((8, d)) * 0.1
                                   ).astype(np.float32)},
                  "x": rng.standard_normal((6, 3, d)).astype(np.float32)},
        "overlap": {"x": rng.standard_normal((5, 32)).astype(np.float32),
                    "w": rng.standard_normal((32, 12)).astype(np.float32)},
        "tuple": rng.standard_normal((8, 6)).astype(np.float32),
        "tree": {"blocks_w": rng.standard_normal((2, 8, 6)).astype(np.float32),
                 "embed": rng.standard_normal((10, 4)).astype(np.float32),
                 "norm": rng.standard_normal(6).astype(np.float32),
                 "step": np.array(3, np.int32)},
    }


@pytest.fixture(scope="module")
def run():
    torch.set_num_threads(1)
    inp = _inputs()
    return inp, run_ranks(workers.collectives_run, 4, inp, timeout=TIMEOUT,
                          threads=1)


def _ref_psum(case, n_pods):
    def tree(name):
        return {k: jnp.asarray(v, jnp.bfloat16 if k in BF16 else jnp.float32)
                for k, v in case[name].items()}

    fn = jax.vmap(lambda g, e: jcg.compressed_psum(g, e, "pod"), axis_name="pod")
    g1, g2 = tree("g1"), tree("g2")
    h1, e1 = fn(g1, jax.tree.map(lambda g: jnp.zeros(g.shape, jnp.float32), g1))
    h2, e2 = fn(g2, e1)
    return {"h1": h1, "e1": e1, "h2": h2, "e2": e2}


@pytest.mark.parametrize("n_pods", [1, 2, 4])
def test_compressed_psum_is_the_reference_bit_for_bit(run, n_pods):
    inp, out = run
    ref = _ref_psum(inp["psum"][n_pods], n_pods)
    pods = set()
    for r in range(4):
        got = out[r][("psum", n_pods)]
        pods.add(got["pod"])
        assert got["dtypes"] == {"w": "torch.bfloat16", "v": "torch.float32",
                                 "s": "torch.float32"}
        for name, tree in ref.items():
            for k, want in tree.items():
                want = np.asarray(want[got["pod"]].astype(jnp.float32))
                assert got[name][k].tobytes() == want.tobytes(), (name, k, r)
    assert pods == set(range(n_pods))
    # the residual is what the quantized sum left: g_hat + e' == v per pod
    # at one pod (v = g + 0 in round one)
    if n_pods == 1:
        got = out[0][("psum", 1)]
        for k in ("v", "s"):
            v = inp["psum"][1]["g1"][k][0]
            assert np.allclose(got["h1"][k] + got["e1"][k], v, rtol=0,
                               atol=1e-6 * np.abs(v).max())
    # per leaf: one max of the row amax and one int32 sum, a round each
    assert out[0]["counts"][("psum", n_pods)] == {"all_reduce": 2 * 2 * len(SHAPES)}


def test_gpipe_forward_matches_the_sequential_layers(run):
    inp, out = run
    p = {k: torch.from_numpy(v) for k, v in inp["gpipe"]["params"].items()}
    want = torch.stack([workers.stage_fn(p, x) for x in
                        torch.from_numpy(inp["gpipe"]["x"])]).numpy()
    for r in range(4):
        np.testing.assert_allclose(out[r]["gpipe"], want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(out[r]["gpipe_chunk"], out[r]["gpipe"])
    # S + M - 1 = 9 ticks a call, one ring step each, and the final sum
    assert out[0]["counts"]["gpipe"] == {"send_recv": 2 * 9, "all_reduce": 2}


def test_overlapped_ag_matmul_matches_x_at_w(run):
    inp, out = run
    want = inp["overlap"]["x"] @ inp["overlap"]["w"]
    for r in range(4):
        np.testing.assert_allclose(out[r]["overlap"], want, rtol=0, atol=1e-4)
    assert out[0]["counts"]["overlap"] == {"send_recv": 3}


def test_tuple_axis_chunks_and_gathers_back(run):
    """P(("pod", "data"), "model") on a 2 x 2 x 1 mesh: the rows split as
    one axis of 4, pod outermost; the gather rebuilds the whole leaf."""
    inp, out = run
    x = inp["tuple"]
    for r in range(4):  # rank r sits at pod r // 2, data r % 2
        np.testing.assert_array_equal(out[r]["tuple_chunk"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out[r]["tuple_back"], x)


def test_reshard_tree_from_four_ranks_to_two_bit_for_bit(run):
    """The survivors' specs are the reference policy's on a 1 x 2 mesh and
    each chunk is the block at the rank's coordinate."""
    from collections import OrderedDict
    from types import SimpleNamespace

    from repro.distributed import sharding as jsh

    inp, out = run
    assert out[2]["reshard"] is None and out[3]["reshard"] is None
    tree = inp["tree"]
    want_specs = jsh.params_pspecs(tree, SimpleNamespace(
        shape=OrderedDict(data=1, model=2)))
    assert any("model" in tuple(s) for s in want_specs.values())
    for r in (0, 1):
        got = out[r]["reshard"]
        assert got["coords"] == {"data": 0, "model": r}
        for k, v in tree.items():
            spec = tuple(want_specs[k])
            assert got["specs"][k] == spec, k
            assert got["back"][k].tobytes() == v.tobytes(), k
            block = v
            for d, entry in enumerate(spec):
                if entry == "model":
                    n = v.shape[d] // 2
                    block = np.take(block, range(r * n, (r + 1) * n), axis=d)
            assert got["chunks"][k].tobytes() == np.ascontiguousarray(block).tobytes(), k
