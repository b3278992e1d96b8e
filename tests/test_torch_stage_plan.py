"""Host side of the K6 chain kernel (``csrc/stage_matmul.cu``).

The kernel runs only on the card; what the CPU can hold is what the host
hands it: the output map derived from ``outg`` at upload
(``layer_plan.stage_slices``) — sites, slices, depths, zero-row masks —
which must reproduce ``outg`` entry by entry or be refused; the geometry
(``plan_stage``: shared-memory budget, register sums) at every stage shape
the three float32 plan routes launch; the slice chunks (``plan_units``) and
the launch tables built from them; and the kernel-order reference
``chip_smoke.ordered_stage_plain`` that the card's results are held against
bit for bit, which walks the same tables.
"""
import importlib.util
import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, reduced_config
from repro_torch.core.lcc import plan_col_slices
from repro_torch.kernels import build, ops
from repro_torch.kernels.layer_plan import (device_stage, plan_stage,
                                            plan_units, stage_blocks,
                                            stage_matmul_plain, stage_slices)
from repro_torch.kernels.lcc_chain_matmul import (MAX_SUMS, SM_SMEM,
                                                  SMEM_LIMIT, plan_staging,
                                                  slot_bytes)
from repro_torch.serving.executor import CompressedExecutor
from repro_torch.testing import (SHARED_SITES, dense_sites, moe_sites,
                                 seeded_artifact)

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "stage_matmul.cu"
SM = 132  # H100 SXM
SUM_TOL = 2e-5
# the longest slice at S = 4 terms a row and one batch column: two [N, 1]
# buffers and two staging slots of one row a thread on 960 row threads
LARGEST_N_S4 = 23284


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fixture_k(k, shared):
    kept = k - min(2, k - 2)
    return kept - max(1, kept // 16) if shared else kept


def _main_path_stages(archs=("olmo-1b", "mixtral-8x22b",
                             "deepseek-v2-lite-16b")):
    """(label, B, [(site width, slices)]) of every stage the float32 plan
    routes of ``archs`` launch, from the configs and the fixture's slice
    grid (no packing)."""
    out = []
    for arch in archs:
        cfg = get_arch(arch)
        dims = {p: (n, k) for p, _, n, k in dense_sites(cfg)}
        dims.update({p: (n, k) for p, _, n, k in moe_sites(cfg)})

        def sites(*names, times=1):
            return [(dims[nm][0], len(plan_col_slices(
                dims[nm][0], _fixture_k(dims[nm][1], nm in SHARED_SITES))))
                for _ in range(times) for nm in names]

        if cfg.moe is None:
            stages = [("qkv", 8, sites("attn.q", "attn.k", "attn.v")),
                      ("o", 8, sites("attn.o")),
                      ("gu", 8, sites("ffn.gate", "ffn.up")),
                      ("dn", 8, sites("ffn.down"))]
        else:
            from repro_torch.kernels.moe_route import capacity
            ne = cfg.moe.n_experts
            cap = capacity(8, cfg.moe.top_k, cfg.moe.capacity_factor, ne)
            a = sites("moe.gate", "moe.up", times=ne)
            b = sites("moe.down", times=ne)
            stages = ([("K9 A", cap, a), ("K9 B", cap, b)] if cfg.mla
                      else [("qkv", 8, sites("attn.q", "attn.k", "attn.v")),
                            ("o", 8, sites("attn.o")), ("eg", cap, a),
                            ("ed", cap, b)])
        out += [(f"{arch} {name}", bsz, st) for name, bsz, st in stages]
    return out


MAIN_PATH = _main_path_stages()
# the dense family's plan routes (qwen2.5-3b's qkv carries its biases)
DENSE_FAMILY = _main_path_stages(("qwen2.5-3b", "llama3.2-3b", "yi-9b"))


def test_the_main_path_has_ten_stage_shapes():
    labels = [label for label, _, _ in MAIN_PATH]
    assert len(labels) == 10
    shapes = {label: (b, max(n for n, _ in st), len(st), sum(e for _, e in st))
              for label, b, st in MAIN_PATH}
    # (B, longest slice, sites, slices): PERF.md's K6 rows
    assert shapes["mixtral-8x22b eg"] == (4, 16384, 16, 6808)
    assert shapes["olmo-1b qkv"] == (8, 2048, 3, 547)
    assert shapes["deepseek-v2-lite-16b K9 A"] == (4, 1408, 128, 25408)


def _check_geometry(n, s, b):
    bb, threads, tile, stages, per_sm = plan_stage(n, s, b)
    rpt = -(-n // threads)
    assert threads % 32 == 0 and threads + 64 <= 1024  # + two copy warps
    assert threads <= 512 or (bb == 1 and n > 16384)
    assert rpt * bb <= MAX_SUMS  # the register sums
    assert bb in (1, 2, 4, 8) and (bb == 1 or bb < 2 * b)
    smem = -(-2 * n * bb * 4 // 16) * 16 + stages * slot_bytes(tile, s)
    assert smem <= SMEM_LIMIT and stages in (2, 3)
    assert tile >= n or tile % threads == 0  # whole rows of every thread
    if 2 * bb <= 8 and 2 * bb < 2 * b and threads <= 512:  # the widest
        t = min(512, -(-n // 32) * 32)
        assert (-(-n // t) * 2 * bb > MAX_SUMS
                or plan_staging(n, s, 2 * bb, t) is None)
    if per_sm == 2:
        assert threads <= 256 and 2 * (smem + 1024) <= SM_SMEM
    return bb, threads, tile, stages, per_sm


@pytest.mark.parametrize("label,b,sites", MAIN_PATH + DENSE_FAMILY,
                         ids=[m[0] for m in MAIN_PATH + DENSE_FAMILY])
def test_planner_fits_every_main_path_stage(label, b, sites):
    """Buffers, staging ring and register sums fit at the longest slice of
    each stage (S = 4: the fused levels), and one wave of chunks covers the
    sites, each at least one chunk."""
    n = max(w for w, _ in sites)
    bb, threads, _, _, per_sm = _check_geometry(n, 4, b)
    want = SM * per_sm // -(-b // bb)
    units = plan_units([np.full(e, float(w)) for w, e in sites], want)
    assert len(units) <= max(want, len(sites))
    assert {u for u, _, _ in units} == set(range(len(sites)))
    if label.endswith("eg"):
        assert (bb, threads) == (1, 512)  # 16384 rows: 32 sums a thread
    if n == 6144:  # mixtral's qkv, o, ed: 12 rows a thread
        assert (bb, threads) == (2, 512)
    # a launch plans each site at its own longest slice: mixtral's 1024-row
    # k and v run at bb = 8 beside the 6144-row q at bb = 2
    geos = {plan_stage(w, 4, b) for w, _ in sites}
    assert len(geos) == len({w for w, _ in sites})
    if label == "mixtral-8x22b qkv":
        assert sorted(g[0] for g in geos) == [2, 8]


def test_largest_slice_at_four_terms():
    assert _check_geometry(LARGEST_N_S4, 4, 8)[:2] == (1, 960)
    with pytest.raises(NotImplementedError, match="shared memory"):
        plan_stage(LARGEST_N_S4 + 1, 4, 8)
    # mixtral-8x22b's expert slices (16384 rows) on 512 row threads
    assert _check_geometry(16384, 4, 4)[:2] == (1, 512)


@pytest.mark.parametrize("seed", range(4))
def test_chunks_cover_every_slice_once_in_order(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        n_sites = int(rng.integers(1, 40))
        costs = [rng.integers(1, 5, int(rng.integers(0, 300))).astype(float)
                 for _ in range(n_sites)]
        want = int(rng.integers(1, 300))
        units = plan_units(costs, want)
        live = [u for u, c in enumerate(costs) if c.size]
        assert len(units) <= max(want, len(live))
        seen = {}
        for u, e0, e1 in units:
            assert 0 <= e0 < e1 <= costs[u].size
            seen.setdefault(u, []).append((e0, e1))
        assert [u for u, _, _ in units] == sorted(u for u, _, _ in units)
        for u in live:
            runs = seen[u]
            assert runs[0][0] == 0 and runs[-1][1] == costs[u].size
            assert all(a[1] == b[0] for a, b in zip(runs, runs[1:]))


# ------------------------------------------------------- the output map


@pytest.fixture(scope="module")
def reduced_stages():
    """The reduced float32 plans of the three families: olmo-1b's step
    plan, mixtral-8x22b's (eg/ed), deepseek-v2-lite-16b's K9 stages."""
    out = {}
    for arch in ("olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b"):
        cfg = reduced_config(get_arch(arch), vocab=64)
        art = seeded_artifact(cfg, seed=3, device="cpu")
        ex = CompressedExecutor(art, device="cpu")
        if cfg.mla is not None:
            plan = ex.moe_plan("l0", n_experts=cfg.moe.n_experts,
                               d_model=cfg.d_model, d_ff=cfg.moe.d_ff_expert)
        else:
            plan = ex.step_plan(cfg)
        for name, ps in plan.stages.items():
            out[f"{arch} {name}"] = ps
    assert {"mixtral-8x22b eg", "mixtral-8x22b ed", "deepseek-v2-lite-16b a",
            "deepseek-v2-lite-16b b", "olmo-1b qkv"} <= set(out)
    return out


def _outg_from_map(m, r, shape):
    """``outg`` rebuilt from an output map alone."""
    got = np.full(shape, r, np.int64)
    for e, (row0, _, _, j, u) in enumerate(m.slices):
        a, w = m.sites[u, 0], m.sites[u, 1]
        got[j, a: a + w] = row0 + np.arange(w)
        if e in m.holes:
            got[j, a + m.holes[e]] = r
    return got


def _check_map(ps, layer, m):
    gidx, gexp, gsgn = ps.gidx[layer], ps.gexp[layer], ps.gsgn[layer]
    n_p, r, _ = gidx.shape
    np.testing.assert_array_equal(_outg_from_map(m, r, ps.outg[layer].shape),
                                  ps.outg[layer])
    order = np.argsort(m.slices[:, 0])
    rows = m.slices[order]
    assert (rows[1:, 0] >= rows[:-1, 0] + rows[:-1, 1]).all()  # disjoint
    for row0, n, depth, _, u in m.slices:
        assert n >= m.sites[u, 1] and 1 <= depth <= n_p
        blk = slice(row0, row0 + n)
        for p in range(1, n_p):
            live = gsgn[p, blk] != 0
            g = gidx[p, blk][live]
            assert ((g >= row0) & (g < row0 + n)).all()  # closed under reads
            if p >= depth:  # identity past the slice's depth
                ident = ((gsgn[p, blk, 0] == 1) & (gexp[p, blk, 0] == 0)
                         & (gidx[p, blk, 0] == np.arange(row0, row0 + n))
                         & ~(gsgn[p, blk, 1:] != 0).any(axis=1))
                dead = ~(gsgn[:, blk] != 0).any(axis=(0, 2))
                assert (ident | dead).all()


def test_output_map_reproduces_outg_on_reduced_plans(reduced_stages):
    for label, ps in reduced_stages.items():
        for layer in range(ps.n_layers):
            m = stage_slices(ps, layer)
            assert m.sites.shape[0] >= 1 and not m.holes, label
            _check_map(ps, layer, m)
            # the slice windows read inside the prep buffer
            assert (m.window[:, 1] <= ps.k_alloc).all()


def test_output_map_of_the_handbuilt_stages_marks_zero_row_entries():
    cs = _chip_smoke()
    for kw in (dict(p=3), dict(p=2, s=3), dict(p=3, dense=True)):
        ps = cs.handbuilt_stage(np.random.default_rng(30), **kw)
        m = stage_slices(ps, 0)
        out = ps.out_dim
        assert m.sites.tolist() == [[0, out, 0, 2]]
        assert m.slices[:, [0, 1, 3]].tolist() == [[0, out, 0], [out, out, 1]]
        assert list(m.holes) == [1]
        np.testing.assert_array_equal(m.holes[1], np.arange(0, out, 7))
        _check_map(ps, 0, m)
        ds = device_stage(ps, "cpu")
        word = int(ds.slice_tab[1, 3])
        bits = ds.hole_bits.numpy().view(np.uint32)[word: word + out // 32]
        marked = np.flatnonzero(np.unpackbits(
            bits.view(np.uint8), bitorder="little"))
        np.testing.assert_array_equal(marked, m.holes[1])
        assert int(ds.slice_tab[0, 3]) == -1


def _one_instruction_stage(outg, r=64, group=16):
    """A one-layer stage of ``r`` rows in instructions of ``group`` rows
    (levels >= 1 read only their own instruction) with the given outg."""
    rng = np.random.default_rng(0)
    idx = np.zeros((2, r, 2), np.int32)
    idx[0] = rng.integers(0, 8, (r, 2))
    base = np.arange(r) // group * group
    idx[1, :, 0] = base + (np.arange(r) + 1) % group  # one piece a group
    idx[1, :, 1] = base + rng.integers(0, group, r)
    outg = np.asarray(outg, np.int32)
    return ops.PackedStage(
        prep_src=np.arange(8, dtype=np.int32)[None],
        prep_tgt=np.arange(8, dtype=np.int32)[None], gidx=idx[None],
        gexp=np.zeros((1, 2, r, 2), np.int8), gsgn=np.ones((1, 2, r, 2), np.int8),
        outg=outg[None], fs_mat=None, dw_mat=None, bias=None, k_alloc=9,
        d_src=8, out_dim=outg.shape[1], n_layers=1, site_names=("odd",))


def test_an_outg_the_map_cannot_express_is_refused():
    r = 64
    ok = _one_instruction_stage(np.stack([np.arange(16), 16 + np.arange(16)]))
    m = stage_slices(ok, 0)
    assert m.slices[:, :2].tolist() == [[0, 16], [16, 16]]
    bad = {
        # one row read by two outputs
        "row read twice": np.stack([np.arange(16), np.arange(16)]),
        # a slice whose first row lies inside an instruction
        "slice inside an instruction": np.arange(8, 24)[None],
        # two outputs of one slice swapped
        "swapped rows": np.array([[1, 0] + list(range(2, 16))]),
    }
    for what, outg in bad.items():
        ps = _one_instruction_stage(outg, r)
        with pytest.raises(ValueError, match="stage odd"):
            stage_slices(ps, 0)
        with pytest.raises(ValueError, match="cannot evaluate"):
            device_stage(ps, "cpu")


def test_a_single_slice_site_beside_a_deeper_one_is_split_not_refused():
    """A one-slice site whose rows end where the next site's begin reads at
    the same offset as that site's first slice; the two become one site only
    where that expresses outg (here they must be split again)."""
    # site A: outputs [0, 16) read rows [0, 16); site B: outputs [16, 32),
    # two slices at rows [16, 32) and [32, 48)
    outg = np.full((2, 32), 64, np.int32)
    outg[0] = np.arange(32)
    outg[1, 16:] = 32 + np.arange(16)
    ps = _one_instruction_stage(outg)
    m = stage_slices(ps, 0)
    assert m.sites.tolist() == [[0, 16, 0, 1], [16, 16, 1, 2]]
    _check_map(ps, 0, m)


# ------------------------------------------------- tables and reference


def test_launch_tables_follow_the_chunks(reduced_stages):
    for label, ps in reduced_stages.items():
        ds = device_stage(ps, "cpu")
        for b, layer in ((8, 0), (4, None), (3, ps.n_layers - 1)):
            plan = ds.launch(b, layer, SM)
            units = plan.units.numpy()
            assert plan.n_units == units.shape[0] == len(plan.chunks)
            # partial rows: one block of the site's width a chunk, in order
            assert (units[:, 3] == np.concatenate(
                [[0], np.cumsum(units[:-1, 4])])).all()
            assert plan.partial_rows == int(units[:, 4].sum())
            es, eb = plan.esites.numpy(), plan.ebegin.numpy()
            nl = ps.n_layers if layer is None else 1
            assert eb.size == nl + 1 and eb[0] == 0
            assert es[:eb[-1], 3].sum() == plan.n_units
            for li in range(nl):
                assert (np.diff(es[eb[li]: eb[li + 1], 0]) > 0).all()
            # every slice of the layers run in exactly one chunk; a site's
            # chunks consecutive and in slice order (a geometry group's
            # sites together)
            layers = range(ps.n_layers) if layer is None else [layer]
            want = [i for l in layers for i in range(
                ds.slice_base[l], ds.slice_base[l] + ds.maps[l].slices.shape[0])]
            got = [e for u in units for e in range(u[1], u[2])]
            assert sorted(got) == want, label
            runs = {}
            for l, u, e0, e1 in plan.chunks:
                runs.setdefault((l, u), []).append((e0, e1))
            assert len(runs) == len({(l, u): 0 for l, u, _, _ in plan.chunks})
            for r in runs.values():
                assert r[0][0] == 0 and all(a[1] == b[0] for a, b in zip(r, r[1:]))
            order = [k for k, _ in itertools.groupby(
                (l, u) for l, u, _, _ in plan.chunks)]
            assert len(order) == len(runs)  # consecutive
            assert sum(g[1] for g in plan.groups) == plan.n_units


@pytest.mark.parametrize("sm", [1, 8, 132])
def test_ordered_reference_follows_the_chunks_and_matches_plain(
        reduced_stages, sm):
    """``chip_smoke.ordered_stage_plain`` (the kernels' order, the launch
    tables' chunks) equals the plain version within SUM_TOL on the reduced
    plans, and bit for bit on the hand-built dyadic stages."""
    cs = _chip_smoke()
    rng = np.random.default_rng(sm)
    for label, ps in reduced_stages.items():
        for b in (8, 3):
            src = torch.from_numpy(rng.standard_normal(
                (ps.d_src, b)).astype(np.float32))
            for layer in range(ps.n_layers):
                got = cs.ordered_stage_plain(ps, src, layer, sm)
                want = stage_matmul_plain(ps, src, layer=layer)
                torch.testing.assert_close(
                    got, want, rtol=0,
                    atol=SUM_TOL * max(1.0, float(want.abs().max())))
        ds = device_stage(ps, "cpu")
        plan = ds.launch(8, 0, sm)  # one wave of chunks a geometry group
        for first, count, bb, _, _, _, per_sm, _ in plan.groups:
            sites = {plan.chunks[i][1] for i in range(first, first + count)}
            assert count <= max(sm * per_sm // -(-8 // bb), len(sites))
    for kw in (dict(p=3), dict(p=2, s=3), dict(p=3, dense=True)):
        ps = cs.handbuilt_stage(np.random.default_rng(31), **kw)
        src = cs.dyadic(rng, (ps.d_src, 8), "cpu")
        got = cs.ordered_stage_plain(ps, src, 0, sm)
        assert torch.equal(got, stage_matmul_plain(ps, src, layer=0))


def test_stage_cost_counts_what_the_data_needs(reduced_stages):
    """The bound of a K6 row: live terms (6 bytes, 2 operations a column),
    the nonzero dense blocks, input and output once — no [R, B] round trip."""
    cs = _chip_smoke()
    ps = reduced_stages["olmo-1b qkv"]
    ds = device_stage(ps, "cpu")
    b = 8
    bytes_, flops = cs.stage_cost(ds, [0], b)
    # the terms of stage_blocks' pieces, not of the kernel's slices
    _, _, _, terms = stage_blocks(ps, 0)
    assert ds.live_terms[0] == stage_slices(ps, 0).live_terms == terms
    dense = (ps.out_dim * ps.k_alloc if ds.fs_live[0] else 0) + (
        ps.out_dim * ps.d_src if ds.dw_live[0] else 0)
    assert bytes_ == 6 * terms + 4 * dense + 4 * b * (ps.d_src + ps.out_dim)
    assert flops == 2 * (terms + dense) * b


def test_header_and_binding_match_the_planner():
    src = CU.read_text()
    assert '#include "lcc_chain.cuh"' in src  # the chain body's helpers
    for used in ("cp_async_wait", "stage_bytes", "slot_bytes", "buffer_bytes",
                 "load_row", "store_row", "signed_pow2", "kCopyThreads",
                 "kMaxSums", "kMaxDynamicSmem"):
        assert used in src
    for absent in ("__cluster_dims__", "cudaLaunchKernelEx", "cp.async.bulk",
                   "mbarrier", "wgmma", "atomicAdd", "outg[", "work["):
        assert absent not in src
    sig = re.search(r'extern "C" int repro_stage_matmul\((.*?)\)\s*\{', src,
                    re.S).group(1)
    kinds = [a.strip().split()[0] for a in sig.split(",")]
    want = build._SIGNATURES["repro_stage_matmul"]
    assert len(kinds) == len(want)
    for kind, ct in zip(kinds, want):
        assert (kind in ("const", "void*", "void")) == (ct is build._P)


@pytest.mark.parametrize("tool, source", [
    ("stage_sweep", "stage_matmul.cu"), ("chain_sweep", "lcc_chain.cuh")])
def test_sweep_diagnostics_match_the_kernel_source(tool, source):
    """Every snippet a diagnostic build of the sweep tools replaces occurs
    in the kernel source it edits (once), so a renamed kernel line fails
    here, not on the card."""
    spec = importlib.util.spec_from_file_location(
        tool, ROOT / "tools" / f"{tool}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = (CU.parent / source).read_text()
    assert mod.DIAGNOSTICS
    for name, edits in mod.DIAGNOSTICS.items():
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)
