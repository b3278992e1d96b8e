"""K6 (stage_matmul) and the layer-plan packers, against the JAX package.

The packers (``pack_stage``/``pack_layer``, ``_fuse_csd_levels``) must build
bitwise the reference's arrays from the same artifact: one compressed by the
JAX package's real compressor at reduced width, with weight sharing forced on
some sites, one site left uncovered (baked dense), FS programs on others
(dense fallbacks) and nonzero q/k/v biases.  The stage's plain version (what
its wrapper runs for CPU tensors) is held against
``repro.kernels.layer_plan.stage_matmul`` in interpret mode: bitwise on the
hand-built dyadic stages of ``tests/test_kernels.py``, <= 1e-5 * max(1,
max|ref|) on packed stages (float32 sums in another order), with and without
``segs``, and where the reference folds the stage into ``eff``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.core.csd import csd_digits
from repro.kernels import layer_plan as jlp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import api as japi
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import artifact_from_reference, stage_from_reference
from repro_torch.kernels import dispatch, ref as tref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.layer_plan import (device_stage, stage_apply_eff,
                                            stage_blocks, stage_matmul,
                                            stage_matmul_plain, stage_slices)
from repro_torch.serving.executor import CompressedExecutor

TOL = 1e-5
SHARED = ("attn.k.l0", "attn.o.l1", "ffn.up.l0")
FS_SITES = ("attn.q.l1", "ffn.down.l0")
UNCOVERED = "attn.v.l1"
STAGES = ("qkv", "o", "gu", "dn")
ARRAYS = ("prep_src", "prep_tgt", "gidx", "gexp", "gsgn", "outg", "fs_mat",
          "dw_mat", "bias", "segs")


def _reduced_cfg():
    return jreduced(jget_arch("olmo-1b"), d_model=32, n_heads=4, n_kv_heads=2,
                    head_dim=16, d_ff=80, vocab=64, n_layers=2, qkv_bias=True)


@pytest.fixture(scope="module")
def plans():
    """(jax stages, port stages, port artifact) of one reduced olmo-1b
    artifact: the JAX executor packs its plan, the port packs its own."""
    cfg = _reduced_cfg()
    params = japi.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    for proj in ("q", "k", "v"):  # nonzero biases, so the stage carries them
        b = params["blocks"]["attn"][proj]["b"]
        params["blocks"]["attn"][proj]["b"] = jnp.asarray(
            rng.standard_normal(b.shape).astype(np.float32) * 0.1)
    fp = jcore.CompressionConfig(algorithm="fp", max_share_rel_err=0.06)
    art = japi.compress_model(params, cfg, fp,
                              include=lambda n: n != UNCOVERED)
    for names, cc in ((SHARED, jcore.CompressionConfig(
            algorithm="fp", weight_sharing=True, max_share_rel_err=None)),
                      (FS_SITES, jcore.CompressionConfig(algorithm="fs"))):
        again = japi.compress_model(art.params, cfg, cc,
                                    include=lambda n, names=names: n in names)
        for name in names:
            art.records[name] = again.records[name]
            art.packed[name] = again.packed[name]
        art.params = again.params
    tart = artifact_from_reference(art, "cpu")
    jplan = JExecutor(art, interpret=True).step_plan(art.config)
    tplan = CompressedExecutor(tart, device="cpu").step_plan(tart.config)
    assert jplan is not None and tplan is not None
    return jplan.stages, tplan.stages, tart


def test_fixture_carries_every_stage_feature(plans):
    _, ts, tart = plans
    assert UNCOVERED not in tart.records
    assert all(tart.records[n].shared is not None for n in SHARED)
    assert ts["qkv"].dw_mat is not None and ts["qkv"].bias is not None
    assert any(ts[n].fs_mat is not None for n in STAGES)
    # weight sharing makes prep targets repeat
    tgt = ts["qkv"].prep_tgt[0]
    real = tgt[tgt < ts["qkv"].k_alloc - 1]
    assert real.size > np.unique(real).size


@pytest.mark.parametrize("name", STAGES)
def test_pack_layer_bitwise_equals_reference(plans, name):
    js, ts, _ = plans
    j, t = js[name], ts[name]
    for f in ARRAYS:
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (j.k_alloc, j.d_src, j.out_dim, j.n_layers, j.site_names) == \
        (t.k_alloc, t.d_src, t.out_dim, t.n_layers, t.site_names)
    assert j.seg_stats == t.seg_stats and j.waste == t.waste
    np.testing.assert_array_equal(j.gcoef, t.gcoef)
    for f in ("eff", "fold_dense"):
        a, b = getattr(j, f), getattr(t, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_eff_is_built_where_the_reference_builds_it(plans):
    """At this width the reference folds some stages (P*R*S past its
    threshold) and evaluates others as streams: both kinds are covered."""
    _, ts, _ = plans
    folded = {n for n in STAGES if ts[n].eff is not None}
    assert folded and folded != set(STAGES)
    # the port's operands are the shift-add streams whatever the size
    for n in STAGES:
        ops_ = ts[n].operands()
        assert any(a is ts[n].gidx for a in ops_)
        assert not any(a is ts[n].eff for a in ops_ if ts[n].eff is not None)


@pytest.mark.parametrize("p", [1, 2, 3, 4, 5, 6])
def test_fuse_csd_levels_bitwise(p):
    """The packer fuses all slices of a decomposition at once; each slice of
    the result equals the reference's per-slice fusion, value for value."""
    rng = np.random.default_rng(100 + p)
    e, rows, s = 3, 10, 2
    idx = rng.integers(0, rows, (e, p, rows, s)).astype(np.int32)
    idx[:, 1:, 0, 1] = 1000  # junk index behind a dead term
    exp = rng.integers(-3, 2, (e, p, rows, s)).astype(np.int8)
    sgn = rng.choice([-1, 0, 1], (e, p, rows, s)).astype(np.int8)
    sgn[:, 1:, 0, 1] = 0
    sgn[:, 0, 5] = 0  # a fully dead parent row
    fused = tops._fuse_csd_levels(idx, exp, sgn)
    for k in range(e):
        for a, b in zip(jops._fuse_csd_levels(idx[k], exp[k], sgn[k]), fused):
            assert a.shape == b[k].shape
            np.testing.assert_array_equal(a, b[k])
    one = tops._fuse_csd_levels(idx[0], exp[0], sgn[0])  # no leading axis
    for a, b in zip(one, fused):
        np.testing.assert_array_equal(a, b[0])


def test_stages_carry_across_from_the_reference(plans):
    js, ts, _ = plans
    for name in STAGES:
        c = stage_from_reference(js[name])
        for f in ARRAYS:
            a, b = getattr(c, f), getattr(ts[name], f)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


# ------------------------------------------------- hand-built dyadic stages


def _csd_stage(mod, idx, exp, sgn, k_in):
    """A 1-layer stage around a raw CSD chain [P, R, S] (``mod``: the JAX
    package's ops or the port's)."""
    p, r, s = idx.shape
    return mod.PackedStage(
        prep_src=np.arange(k_in, dtype=np.int32)[None],
        prep_tgt=np.arange(k_in, dtype=np.int32)[None],
        gidx=np.asarray(idx, np.int32)[None],
        gexp=np.asarray(exp, np.int8)[None],
        gsgn=np.asarray(sgn, np.int8)[None],
        outg=np.arange(r, dtype=np.int32)[None, None],
        fs_mat=None, dw_mat=None, bias=None,
        k_alloc=k_in + 1, d_src=k_in, out_dim=r, n_layers=1,
        site_names=("synthetic",))


def _both(idx, exp, sgn, k_in, x):
    """(port plain, JAX kernel) outputs of the hand-built stage on x [K, B]."""
    got = stage_matmul_plain(_csd_stage(tops, idx, exp, sgn, k_in),
                             torch.from_numpy(x)[None])[0].numpy()
    want = np.asarray(jlp.stage_matmul(_csd_stage(jops, idx, exp, sgn, k_in),
                                       jnp.asarray(x)[None], interpret=True))[0]
    return got, want


def test_stage_csd_shift_add_bitwise():
    rng = np.random.default_rng(11)
    k_in, r, p, s, b = 8, 8, 3, 2, 5
    idx = rng.integers(0, k_in, (p, r, s))
    exp = rng.integers(-2, 3, (p, r, s))
    sgn = rng.choice([-1, 0, 1], (p, r, s))
    sgn[1, 2] = 0  # a fully dead row: exactly 0.0
    x = np.asarray(rng.integers(-4, 5, (k_in, b)), np.float32)
    got, want = _both(idx, exp, sgn, k_in, x)
    np.testing.assert_array_equal(got, want)
    factors = [(torch.from_numpy(idx[q].astype(np.int32)),
                torch.from_numpy(exp[q].astype(np.int8)),
                torch.from_numpy(sgn[q].astype(np.int8))) for q in range(p)]
    np.testing.assert_array_equal(
        got, tref.lcc_chain_apply_ref(factors, torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("p", [3, 4])
def test_stage_fused_levels_bitwise(p):
    """Fused levels (even count: full pairwise fusion; odd: unfused tail)
    == the unfused chain, bit for bit."""
    rng = np.random.default_rng(100 + p)
    k_in, r, s, b = 8, 8, 2, 4
    idx = rng.integers(0, k_in, (p, r, s))
    exp = rng.integers(-2, 3, (p, r, s))
    sgn = rng.choice([-1, 0, 1], (p, r, s))
    sgn[0, 5] = 0
    x = np.asarray(rng.integers(-4, 5, (k_in, b)), np.float32)
    factors = [(jnp.asarray(idx[q], jnp.int32), jnp.asarray(exp[q], jnp.int8),
                jnp.asarray(sgn[q], jnp.int8)) for q in range(p)]
    want_chain = np.asarray(jref.lcc_chain_apply_ref(factors, jnp.asarray(x)))
    fi, fe, fs = tops._fuse_csd_levels(idx, exp, sgn)
    assert fi.shape[0] == (p + 1) // 2
    got, want = _both(fi, fe, fs, k_in, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_chain)


def test_stage_csd_digits_reproduce_constants():
    consts = [2.5, -3.75, 0.625, 1.0]
    digits = [csd_digits(c) for c in consts]
    s = max(len(d) for d in digits)
    idx = np.zeros((1, len(consts), s), np.int64)
    exp = np.zeros_like(idx)
    sgn = np.zeros_like(idx)
    for i, dig in enumerate(digits):
        for j, (e, z) in enumerate(dig):
            exp[0, i, j], sgn[0, i, j] = e, z
    x = np.asarray(np.random.default_rng(3).integers(-8, 9, (1, 6)), np.float32)
    got, want = _both(idx, exp, sgn, 1, x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(consts, np.float32)[:, None] * x)


# -------------------------------------------------- packed stages vs JAX


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _padding_rows(ps) -> bool:
    """A layer of the stage has fewer FP slices than the stage's J: some of
    its output-gather rows are all padding."""
    o = np.asarray(ps.outg)
    return bool(np.all(o == ps.gidx.shape[2], axis=2).any())


@pytest.mark.parametrize("segs", [True, False], ids=["segs", "no_segs"])
@pytest.mark.parametrize("name", STAGES)
def test_stage_plain_matches_reference(plans, name, segs):
    """The reference runs the same stage (its segment path with ``segs``,
    its full-gather path without).  Where a layer has all-padding gather
    rows the reference's segment path cannot run (see the next test); its
    full-gather path — the same map — is the reference there."""
    js, ts, _ = plans
    j, t = js[name], ts[name]
    if not segs:  # a stage packed before segment descriptors existed
        t = dataclasses.replace(t, segs=None, seg_stats=None, waste=None)
    if not segs or _padding_rows(j):
        j = dataclasses.replace(j, segs=None, seg_stats=None, waste=None)
    rng = np.random.default_rng(7)
    src = rng.standard_normal((t.n_layers, t.d_src, 3)).astype(np.float32)
    want = jlp.stage_matmul(j, jnp.asarray(src), interpret=True)
    got = stage_matmul_plain(t, torch.from_numpy(src))
    _close(got, want)
    # one layer at a time, with the residual the decode step folds in
    resid = torch.from_numpy(rng.standard_normal((t.out_dim, 3)).astype(np.float32))
    for l in range(t.n_layers):
        one = stage_matmul_plain(t, torch.from_numpy(src[l]), layer=l, resid=resid)
        _close(one, np.asarray(want)[l] + resid.numpy())


def test_reference_segment_path_refuses_layers_with_fewer_slices(plans):
    """A fault of the reference, recorded so the port's own path is known
    to cover more: when one layer of a stage has fewer FP slices than
    another (a weight-shared or FS-only site in one layer only), the
    reference's segment path trims the all-padding gather rows by indexing a
    kernel operand with a host array, which Pallas refuses as a captured
    constant.  The port evaluates the same stage (test above)."""
    js, _, _ = plans
    irregular = [n for n in STAGES if _padding_rows(js[n])]
    assert irregular
    src = jnp.zeros((2, js[irregular[0]].d_src, 1), jnp.float32)
    with pytest.raises(ValueError, match="captures constants"):
        jlp.stage_matmul(js[irregular[0]], src, interpret=True)


def test_stage_plain_matches_the_folded_matrix(plans):
    """Where the reference folds a stage into ``eff``, the shift-add
    evaluation agrees with that one product (the reference's own folded
    evaluation, ``_stage_apply_eff``, ported as ``stage_apply_eff``)."""
    _, ts, _ = plans
    folded = [ts[n] for n in STAGES if ts[n].eff is not None]
    assert folded
    src = np.random.default_rng(8).standard_normal((256, 4)).astype(np.float32)
    for t in folded:
        x = torch.from_numpy(src[: t.d_src])
        for l in range(t.n_layers):
            _close(stage_matmul_plain(t, x, layer=l), stage_apply_eff(t, x, l))


# ----------------------------------------------------- the kernel's tables


def test_stage_blocks_never_read_across_and_run_every_live_level(plans):
    """The row blocks the kernel runs in shared memory: no live term of a
    level >= 1 reads outside its row's block; every block runs the levels up
    to the last one that is not identity for one of its rows; live terms are
    counted over exactly those levels."""
    _, ts, _ = plans
    for name in STAGES:
        ps = ts[name]
        for l in range(ps.n_layers):
            r0, r1, depth, live = stage_blocks(ps, l)
            n_p, r, s = ps.gidx.shape[1:]
            assert r0[0] == 0 and r1[-1] == r and (r0[1:] == r1[:-1]).all()
            blk = np.repeat(np.arange(r0.size), r1 - r0)  # row -> block
            need = np.ones(r, np.int64)  # levels each row needs
            for row in range(r):
                for p in range(1, n_p):
                    g, sg = ps.gidx[l, p, row], ps.gsgn[l, p, row]
                    assert (blk[g[sg != 0]] == blk[row]).all()
                    ident = (sg[0] == 1 and ps.gexp[l, p, row, 0] == 0
                             and g[0] == row and not sg[1:].any())
                    if not ident and ps.gsgn[l, :, row].any():
                        need[row] = p + 1
            for i in range(r0.size):
                assert depth[i] == need[r0[i]: r1[i]].max()
            assert live == sum(int((ps.gsgn[l, : depth[blk[row]], row] != 0).sum())
                               for row in range(r))


def test_stage_blocks_split_at_instructions_and_merge_dead_rows():
    """Two independent 3-level instructions of 4 rows and a dead tail: the
    finest partition splits between the instructions and the dead rows run
    one level.  The kernel's unit is a slice of the output map, not a piece:
    a slice takes every piece that holds its folded rows (here all of them,
    one slice of 16 rows at the deepest piece's depth), and where the
    outputs read only the first instruction, only its piece."""
    rng = np.random.default_rng(5)
    r, s = 16, 2
    idx = np.zeros((3, r, s), np.int64)
    sgn = np.zeros((3, r, s), np.int64)
    for base in (0, 4):
        idx[:, base: base + 4] = base + rng.integers(0, 4, (3, 4, s))
        sgn[:, base: base + 4] = 1
    idx[0] = rng.integers(0, 8, (r, s))  # level 0 reads the prep buffer
    ps = _csd_stage(tops, idx, np.zeros_like(idx), sgn, 8)
    r0, r1, depth, _ = stage_blocks(ps, 0)
    assert r0.tolist() == [0, 4] + list(range(8, r))
    assert r1.tolist() == [4, 8] + list(range(9, r + 1))
    assert depth.tolist() == [3, 3] + [1] * (r - 8)
    m = stage_slices(ps, 0)
    assert m.sites.tolist() == [[0, r, 0, 1]]
    assert m.slices.tolist() == [[0, r, 3, 0, 0]] and not m.holes
    first = dataclasses.replace(ps, outg=ps.outg[:, :, :4].copy(), out_dim=4)
    m = stage_slices(first, 0)
    assert m.slices.tolist() == [[0, 4, 3, 0, 0]]
    assert m.run_terms == 3 * 4 * s  # the slice runs only the first piece
    assert m.live_terms == stage_blocks(first, 0)[3]  # what the data needs


def test_a_block_beyond_shared_memory_is_refused_by_the_kernel_only():
    """Rows that all read each other form one block; past the shared-memory
    limit the kernel's launch geometry refuses it, the plain version runs."""
    r = 30000
    idx = np.stack([np.zeros((r, 1), np.int64),
                    ((np.arange(r) + 1) % r)[:, None]])
    ps = _csd_stage(tops, idx, np.zeros_like(idx), np.ones_like(idx), 1)
    ds = device_stage(ps, "cpu")
    assert ds.max_rows == r
    with pytest.raises(NotImplementedError, match="shared memory"):
        ds.geometry(8)
    y = stage_matmul_plain(ps, torch.ones((1, 1, 2)))
    assert torch.equal(y, torch.ones((1, r, 2)))


def test_upload_validates_the_streams(plans):
    _, ts, _ = plans
    ps = ts["o"]
    bad = dataclasses.replace(ps, gidx=ps.gidx.copy())
    live = np.argwhere(bad.gsgn[0, 1] != 0)[0]
    bad.gidx[0, 1, live[0], live[1]] = bad.gidx.shape[2]  # past the rows
    with pytest.raises(ValueError):
        stage_blocks(bad, 0)
    bad0 = dataclasses.replace(ps, gidx=ps.gidx.copy())
    live0 = np.argwhere(bad0.gsgn[0, 0] != 0)[0]
    bad0.gidx[0, 0, live0[0], live0[1]] = ps.k_alloc  # past the prep buffer
    with pytest.raises(ValueError):
        device_stage(bad0, "cpu")
    badx = dataclasses.replace(ps, gexp=ps.gexp.copy())
    badx.gexp[0, 0, live0[0], live0[1]] = -127
    with pytest.raises(ValueError):
        device_stage(badx, "cpu")


def test_cpu_wrapper_takes_the_plain_version_and_counts_nothing(plans):
    _, ts, _ = plans
    ps = ts["gu"]
    src = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (ps.n_layers, ps.d_src, 2)).astype(np.float32))
    dispatch.reset_launch_count()
    assert torch.equal(stage_matmul(ps, src), stage_matmul_plain(ps, src))
    assert torch.equal(stage_matmul(ps, src[1], layer=1),
                       stage_matmul_plain(ps, src[1], layer=1))
    assert dispatch.launch_count() == 0
    # the device copy is made once per device and kept on the stage
    assert device_stage(ps, "cpu") is device_stage(ps, torch.device("cpu"))
    assert device_stage(dataclasses.replace(ps), "cpu") is not device_stage(ps, "cpu")
    with pytest.raises(ValueError):
        stage_matmul_plain(ps, src, resid=src[0])
