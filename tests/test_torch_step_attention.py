"""K7's decode attention (``layer_plan.step_attention``) on the CPU.

The kernel (``csrc/step_plan.cu``: split over the cache, only the live slots
read, K/V staged by cp.async, the splits merged in order) runs only on the
card.  What the CPU holds:

* the plain version inside ``step_plan_matmul`` against the JAX package's
  ``step_plan_matmul`` in interpret mode: odd and even cache lengths, one
  and three query heads a kv-head, sliding windows (with a ring that has
  wrapped), an idle row, rows at the first and the last slot, scattered
  ``kpos``, paged caches of 4-slot pages; within 1e-5 * max(1, max|ref|);
* the host planner ``plan_attention``: chunks that cover S exactly, whole
  pages, one block on every SM at the serves' shapes, shared memory within
  the limit at every shape it takes, ``ValueError`` for the rest;
* ``chip_smoke.ordered_attention_plain``, the plain arithmetic in the
  kernel's order (splits, live slots only, merge in split order), against
  the plain version within 1e-6, with a wholly masked chunk, the current
  slot in every chunk and an idle row; the bound's row count and the
  ``scaled_dot_product_attention`` yardstick's inputs.
"""
import importlib.util
import re
import zlib
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.kernels import layer_plan as jlp
from repro.models import api as japi
from repro.models.layers import _rope_sincos as j_rope_sincos
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.configs import get_arch, reduced_config
from repro_torch.convert import artifact_from_reference
from repro_torch.kernels import dispatch
from repro_torch.kernels.layer_plan import (ATTN_CHUNK, ATTN_MAX_GROUP,
                                            ATTN_MAX_HD, ATTN_RING, ATTN_TILE,
                                            AttentionPlan, attention_smem,
                                            plan_attention, step_attention,
                                            step_attention_plain,
                                            step_plan_matmul)
from repro_torch.kernels.lcc_chain_matmul import SMEM_LIMIT
from repro_torch.serving.executor import CompressedExecutor

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "step_plan.cu"
SM = 132  # H100 SXM
STEP_TOL = 1e-5
ORDER_TOL = 1e-6


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def chip_smoke():
    return _chip_smoke()


def _close(got, want, tol):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


# ------------------------------------------ the step against the reference


@pytest.fixture(scope="module", params=[1, 3], ids=["G1", "G3"])
def plan_pair(request):
    """A reduced olmo-1b with ``G`` query heads a kv-head, compressed by the
    JAX package; its plan's stages in the port and in the reference."""
    g = request.param
    cfg = jreduced(jget_arch("olmo-1b"), d_model=32, n_heads=2 * g,
                   n_kv_heads=2, head_dim=16, d_ff=48, vocab=64, n_layers=2)
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    jart = japi.compress_model(
        params, cfg,
        jcore.CompressionConfig(algorithm="fp", max_share_rel_err=0.06))
    tart = artifact_from_reference(jart, "cpu")
    tstages = CompressedExecutor(tart, device="cpu").step_plan(tart.config).stages
    jstages = JExecutor(jart, interpret=True).step_plan(jart.config).stages
    return g, tart.config, tstages, jstages


@pytest.mark.parametrize("smax,window,paged", [
    (37, None, False),
    (37, 5, False),
    (96, None, False),
    (96, 7, True),
    (96, None, True),
    (96, 40, True),
])
def test_step_attention_inside_the_step_matches_reference(plan_pair, smax,
                                                          window, paged):
    g, cfg, tst, jst = plan_pair
    n_l, d, nkv, hd = cfg.n_layers, cfg.d_model, cfg.n_kv_heads, cfg.hd
    assert cfg.n_heads // nkv == g
    # the first slot, idle, the last slot, the middle; under a window also a
    # ring that has wrapped
    pos = [0, -1, smax - 1, smax // 2] + ([smax + 3] if window else [])
    pos = np.array(pos, np.int32)
    b = len(pos)
    rng = np.random.default_rng(zlib.crc32(repr((g, smax, window, paged)).encode()))
    x0 = rng.standard_normal((d, b)).astype(np.float32)
    kpos = rng.integers(-1, smax + 4, (n_l, b, smax)).astype(np.int32)
    kc = rng.standard_normal((n_l, b, smax, nkv, hd)).astype(np.float32)
    vc = rng.standard_normal((n_l, b, smax, nkv, hd)).astype(np.float32)
    ln1 = (1.0 + 0.1 * rng.standard_normal((n_l, d))).astype(np.float32)
    ln2 = (1.0 + 0.1 * rng.standard_normal((n_l, d))).astype(np.float32)
    sin, cos = (np.array(a) for a in j_rope_sincos(jnp.asarray(pos), hd,
                                                      cfg.rope_theta))
    common = dict(n_heads=cfg.n_heads, n_kv_heads=nkv, head_dim=hd,
                  d_ff=cfg.d_ff, norm="rms", rope=True, window=window)
    want = jlp.step_plan_matmul(
        jst, **common, x0=jnp.asarray(x0), pos=jnp.asarray(pos),
        cos=jnp.asarray(cos), sin=jnp.asarray(sin), ln1=ln1, ln2=ln2,
        kc=jnp.asarray(kc), vc=jnp.asarray(vc), kpos=jnp.asarray(kpos),
        interpret=True)
    t = torch.from_numpy
    kc_t, vc_t, tbl = t(kc), t(vc), None
    if paged:  # the same view in a pool of 4-slot pages behind a table
        bs, mb = 4, smax // 4
        tbl_np = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
        pool_k = np.zeros((n_l, b * mb + 1, bs, nkv, hd), np.float32)
        pool_v = np.zeros_like(pool_k)
        for r in range(b):
            for j in range(mb):
                pool_k[:, tbl_np[r, j]] = kc[:, r, j * bs:(j + 1) * bs]
                pool_v[:, tbl_np[r, j]] = vc[:, r, j * bs:(j + 1) * bs]
        kc_t, vc_t, tbl = t(pool_k), t(pool_v), t(tbl_np)
    dispatch.reset_launch_count()
    got = step_plan_matmul(
        tst, **common, x0=t(x0), pos=t(pos), cos=t(cos), sin=t(sin),
        ln1=t(ln1), ln2=t(ln2), kc=kc_t, vc=vc_t, kpos=t(kpos), block_tbl=tbl)
    assert dispatch.launch_count() == 0  # the CPU takes the plain versions
    for part, w in zip(got, want):
        _close(part, w, STEP_TOL)


def test_step_attention_takes_the_plain_version_on_the_cpu(chip_smoke):
    cfg = reduced_config(get_arch("mixtral-8x22b"))
    pos = np.array([5, -1, 30, 63], np.int32)
    a = chip_smoke.attention_inputs(cfg, 64, cfg.attn_window, pos,
                                    np.random.default_rng(1), "cpu")
    dispatch.reset_launch_count()
    for x, y in zip(step_attention(**a), step_attention_plain(**a)):
        assert torch.equal(x, y)
    assert dispatch.launch_count() == 0


# ------------------------------------------------------------ the planner


# (B, Hkv, G, S, page, hd) of every shape the serves and chip_smoke.py's
# cases give the kernel: the olmo-1b / mixtral-8x22b plan serves, their long
# caches, the reduced steps (olmo, GQA, mixtral; contiguous and paged)
MAIN_PATH = [(8, 16, 1, 128, 16, 128), (8, 8, 6, 128, 16, 128),
             (8, 16, 1, 2048, 16, 128), (8, 8, 6, 4096, 16, 128),
             (8, 4, 1, 128, 16, 32), (8, 2, 2, 128, 0, 32),
             (8, 2, 2, 128, 16, 32)]


def _check_plan(plan, s, page):
    assert isinstance(plan, AttentionPlan)
    assert plan.merge_smem == 4 * (plan.splits + 1)
    assert plan.splits * plan.chunk >= s > (plan.splits - 1) * plan.chunk
    assert plan.chunk % (page or ATTN_TILE) == 0
    assert plan.chunk <= max(ATTN_CHUNK, page or 0) + (page or ATTN_TILE)
    assert plan.smem <= SMEM_LIMIT and plan.merge_smem <= SMEM_LIMIT


@pytest.mark.parametrize("b,nkv,g,s,page,hd", MAIN_PATH)
def test_plan_attention_at_the_main_path_shapes(b, nkv, g, s, page, hd):
    plan = plan_attention(b, nkv, g, s, SM, page, head_dim=hd)
    _check_plan(plan, s, page)
    blocks = plan.splits * nkv * b
    if s == 128 and hd == 128:  # the serves: one block on every SM at least
        assert blocks >= SM
    if s >= 2048:  # the long caches: several waves
        assert blocks >= 4 * SM


def test_plan_attention_up_to_32k_slots():
    for s in (1, 15, 37, 96, 128, 1000, 2048, 4096, 8191, 16384, 32767, 32768):
        for g in range(1, ATTN_MAX_GROUP + 1):
            for hd in (32, 64, 128, ATTN_MAX_HD):
                for page in (0, 4, 16, 64):
                    for b, nkv in ((1, 1), (8, 8), (64, 16)):
                        plan = plan_attention(b, nkv, g, s, SM, page,
                                              head_dim=hd)
                        _check_plan(plan, s, page)


@pytest.mark.parametrize("g,hd,page", [
    (ATTN_MAX_GROUP + 1, 128, 16), (0, 128, 16), (1, 130, 16), (1, 96, 16),
    (1, 2 * ATTN_MAX_HD, 16), (1, 0, 16), (8, 128, 16384)])
def test_plan_attention_refuses_what_the_kernel_cannot_take(g, hd, page):
    with pytest.raises(ValueError):
        plan_attention(8, 8, g, 32768, SM, page, head_dim=hd)


def test_plan_attention_mirrors_the_kernel_constants():
    text = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kAttnTile") == ATTN_TILE
    assert const("kAttnRing") == ATTN_RING
    assert const("kMaxGroup") == ATTN_MAX_GROUP
    assert "hd > 128" in text and ATTN_MAX_HD == 128
    # the kernel's own byte count, term by term
    assert re.search(r"kAttnRing\) \* kAttnTile \* hd \+\s+static_cast<size_t>"
                     r"\(G \+ 2\) \* hd \+\s+static_cast<size_t>\(kMaxGroup "
                     r"\+ 3\) \* chunk \+ 2 \* kMaxGroup;", text)
    assert "(static_cast<size_t>(splits) + 1) * sizeof(float)" in text
    assert attention_smem(6, 128, 48) == 4 * (3 * 16 * 128 + 8 * 128
                                              + 11 * 48 + 16)
    assert "step_attention_kernel" not in text
    assert not re.search(r"\batomic[A-Z]", text)  # the splits merge in order


# ------------------------------------------------ the kernel's order, bound


def _ordered_case(chip_smoke, pos, *, smax=64, window=None, masked=None,
                  g_cfg="mixtral-8x22b"):
    cfg = reduced_config(get_arch(g_cfg))
    rng = np.random.default_rng(zlib.crc32(repr((pos, smax, window)).encode()))
    torch.manual_seed(7)
    a = chip_smoke.attention_inputs(cfg, smax, window, np.array(pos, np.int32),
                                    rng, "cpu")
    if masked is not None:  # row r's slots [lo, hi) masked
        r, lo, hi = masked
        a["kpos"][r, lo:hi] = -1
    plan = plan_attention(len(pos), cfg.n_kv_heads,
                          cfg.n_heads // cfg.n_kv_heads, smax, SM, 16,
                          head_dim=cfg.hd)
    return a, plan


@pytest.mark.parametrize("pos,window,masked", [
    ([3, 20, 37, 60], None, None),          # the current slot in each chunk
    ([40, -1, 63, 0], None, (0, 16, 32)),   # a wholly masked chunk, idle row
    ([-1, -1, 5, 17], None, None),          # two idle rows
    ([70, 130, 9, -1], 50, None),           # windowed ring, wrapped
    ([64, 100, 200, 63], 64, (2, 0, 48)),   # ring with masked chunks
])
def test_ordered_plain_equals_the_plain_version(chip_smoke, pos, window,
                                                masked):
    a, plan = _ordered_case(chip_smoke, pos, window=window, masked=masked)
    assert plan.splits == 4 and plan.chunk == 16
    want = step_attention_plain(**a)[0]
    got = chip_smoke.ordered_attention_plain(a, plan)
    _close(got, want.numpy(), ORDER_TOL)


def test_live_rows_count_what_the_data_needs(chip_smoke):
    a, _ = _ordered_case(chip_smoke, [40, -1, 63, 0], masked=(0, 16, 32))
    kv, v = chip_smoke.live_rows(a)
    # row 0: slots 0..39 minus 16..31; row 2: 0..62; row 3: none (the hit
    # only); row 1 idle: every V row
    assert (kv, v) == ((40 - 16) + 63 + 0, 64)
    b, s = a["kpos"].shape
    nbytes, flops = chip_smoke.attention_cost(a, kv, v)
    assert nbytes > (2 * kv + v) * a["n_kv_heads"] * a["head_dim"] * 4 + 4 * b * s
    assert flops > 0


def test_sdpa_yardstick_computes_the_same_function(chip_smoke):
    a, _ = _ordered_case(chip_smoke, [70, 130, 9, -1], window=50)
    q, k, v, mask = chip_smoke.sdpa_inputs(a)
    out = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    b, nq = q.shape[0], q.shape[1]
    _close(out.reshape(b, -1).T, step_attention_plain(**a)[0].numpy(), 1e-5)


def test_attention_cases_cover_the_serves_and_the_long_caches(chip_smoke):
    cases = list(chip_smoke.attention_cases(np.random.default_rng(60)))
    labels = [c[0] for c in cases]
    assert labels == ["olmo-1b serve S=128", "olmo-1b S=2048 random",
                      "olmo-1b S=2048 full", "mixtral-8x22b serve S=128",
                      "mixtral-8x22b S=4096 random", "mixtral-8x22b S=4096 full"]
    for label, cfg, smax, window, pos in cases:
        assert len(pos) == chip_smoke.BATCH and window == cfg.attn_window
        if "serve" in label:
            assert (pos < 0).sum() == 2 and pos[pos >= 0].max() < 24
        elif "full" in label:  # every slot valid
            assert (pos >= smax - 1).all()
        else:
            assert pos[1] == -1
        plan_attention(len(pos), cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                       smax, SM, chip_smoke.PAGE, head_dim=cfg.hd)
    serve = replace(get_arch("olmo-1b"))
    assert chip_smoke.LONG_CACHE["olmo-1b"] == 2048 and serve.attn_window is None


def test_route_wrapper_mirrors_the_kernel_constants():
    from repro_torch.kernels import moe_route
    text = (CU.parent / "moe_route.cu").read_text()
    assert f"constexpr int kRouteRows = {moe_route.ROUTE_ROWS};" in text
    assert "moe_route_kernel" not in text  # the one-block route is gone
    assert not re.search(r"\batomic[A-Z]", text)
