"""K3's region prep (``shared_matmul.RegionPrep``): the host composition of
the prune gather with the weight-sharing CSR, the plain region prep against
the per-member path it replaces (``index_select``, ``cluster_segment_sum_plain``,
``torch.cat``) and against the JAX kernel in interpret mode, the kernel-order
reference ``chip_smoke.ordered_prep_plain`` the card's results are held to,
the input layouts it takes and refuses, and the regions ``chip_smoke.py``
checks against the serves' own."""
import importlib.util
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

from repro_torch.configs import get_arch, reduced_config
from repro_torch.kernels.shared_matmul import (RegionPrep,
                                               cluster_segment_sum_plain,
                                               csr_from_labels, member_table,
                                               region_layout,
                                               region_prep_plain)
from repro_torch.serving.executor import region_site, site_prep
from repro_torch.testing import dense_sites, seeded_artifact, seeded_prep

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _labels(k, c, rng):
    """Every cluster used once, the rest at random; one singleton kept."""
    lab = np.concatenate([rng.permutation(c), rng.integers(0, c - 1, k - c)])
    return lab[rng.permutation(k)].astype(np.int64)


def _members(k, rng):
    """Prune-only, weight-shared, identity-keep and a member whose clusters
    include one of a single row (the last cluster appears once)."""
    kept_a = np.sort(rng.permutation(k)[3:])
    kept_b = np.sort(rng.permutation(k)[2:])
    kept_c = np.arange(k)
    kept_d = np.sort(rng.permutation(k)[1:])
    c_b, c_d = kept_b.size - 5, kept_d.size - 7
    return [(kept_a, None, 0), (kept_b, _labels(kept_b.size, c_b, rng), c_b),
            (kept_c, None, 0), (kept_d, _labels(kept_d.size, c_d, rng), c_d)]


def _per_member_path(members, views):
    """The path the region prep replaced: per member the kept-column gather
    (none for a full identity keep), the segment sum on a weight-shared
    member (its input made float32 first), float32 and contiguous, then one
    concatenation."""
    parts = []
    for (kept, labels, c), x in zip(members, views):
        if not (kept.size == x.shape[0] and (kept == np.arange(kept.size)).all()):
            x = x.index_select(0, torch.from_numpy(kept))
        if labels is not None:
            x = cluster_segment_sum_plain(torch.from_numpy(labels),
                                          x.to(torch.float32).contiguous(), c)
        parts.append(x.to(torch.float32).contiguous())
    return torch.cat(parts)


def _input(layout, g, k, b, dtype, rng, dyadic=False):
    shape = (g, b, k) if layout == "stacked" else (b, k)
    a = (rng.integers(-8, 9, size=shape) / 8.0 if dyadic
         else rng.standard_normal(shape)).astype(np.float32)
    x = torch.from_numpy(a).to(dtype)
    if layout == "stacked":
        return [x[e].T for e in range(g)]
    if layout == "transposed":
        return x.T
    return x.T.contiguous()  # a contiguous [K, B] tensor shared by all


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_member_table_composes_kept_with_the_csr(seed):
    rng = np.random.default_rng(seed)
    k = 40 + seed
    kept = np.sort(rng.permutation(k)[4:])
    c = kept.size - 6
    labels = _labels(kept.size, c, rng)
    src, seg = member_table(kept, labels, c)
    order, offsets = csr_from_labels(labels, c)
    assert src.dtype == seg.dtype == np.int32
    np.testing.assert_array_equal(src, kept[order.numpy()])
    np.testing.assert_array_equal(seg, offsets.numpy())
    np.testing.assert_array_equal(src, kept[np.argsort(labels, kind="stable")])
    for r in range(c):  # ascending source rows inside every cluster
        assert (np.diff(src[seg[r]:seg[r + 1]]) > 0).all()
    src, seg = member_table(kept)
    np.testing.assert_array_equal(src, kept)
    np.testing.assert_array_equal(seg, np.arange(kept.size + 1))
    with pytest.raises(ValueError):
        member_table(kept, labels[:-1], c)


def test_region_table_concatenates_the_members():
    rng = np.random.default_rng(3)
    members = _members(30, rng)
    prep = RegionPrep(members)
    rows, base = [0], 0
    for g, (kept, labels, c) in enumerate(members):
        src, seg = member_table(kept, labels, c)
        r0, r1 = prep.out_off[g], prep.out_off[g + 1]
        assert r1 - r0 == seg.size - 1 == (c if labels is not None else kept.size)
        np.testing.assert_array_equal(prep.segptr[r0:r1 + 1] - base, seg)
        np.testing.assert_array_equal(prep.src[base:base + src.size], src)
        np.testing.assert_array_equal(prep.rowinfo[r0:r1],
                                      2 * g + (labels is None))
        base += src.size
        rows.append(r1)
    assert prep.rows == prep.out_off[-1] == rows[-1]
    assert prep.segptr[-1] == prep.src.size and prep.rows_in == 30
    assert not prep.identity


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["transposed", "contiguous", "stacked"])
@pytest.mark.parametrize("b", [1, 4, 9])
def test_plain_prep_equals_the_per_member_path(layout, dtype, b):
    rng = np.random.default_rng(b)
    members = _members(37, rng)
    prep = RegionPrep(members)
    xs = _input(layout, len(members), 37, b, dtype, rng)
    views, step = region_layout(xs, len(members))
    assert step == (b * 37 if layout == "stacked" else 0)
    got = prep(xs)  # a CPU tensor: the plain version
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (prep.rows, b)
    assert torch.equal(got, region_prep_plain(prep, xs))
    assert torch.equal(got, _per_member_path(members, views))
    assert prep.launches(xs) == 1


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "random"])
@pytest.mark.parametrize("b", [3, 8])
def test_plain_prep_matches_the_jax_segment_sum(b, dyadic):
    """Each weight-shared member's rows against the JAX kernel
    (``segment_sum_tpu`` in interpret mode) on its gathered rows; the
    prune-only members are the gathered rows themselves."""
    rng = np.random.default_rng(10 + b)
    members = _members(48, rng)
    prep = RegionPrep(members)
    xs = _input("transposed", len(members), 48, b, torch.float32, rng, dyadic)
    got = prep(xs).numpy()
    x = xs.numpy()
    for g, (kept, labels, c) in enumerate(members):
        rows = got[prep.out_off[g]:prep.out_off[g + 1]]
        if labels is None:
            np.testing.assert_array_equal(rows, x[kept])
            continue
        want = np.asarray(jops.segment_sum_tpu(
            jnp.asarray(labels.astype(np.int32)), jnp.asarray(x[kept]), c,
            interpret=True))
        if dyadic:
            np.testing.assert_array_equal(rows, want)
        else:
            np.testing.assert_allclose(rows, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["transposed", "stacked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_order_reference_equals_the_plain_version(layout, dtype):
    """``chip_smoke.ordered_prep_plain`` (ascending segments from +0.0, a
    copied row from -0.0) is the plain version bit for bit on random input,
    signed zeros included."""
    cs = _chip_smoke()
    rng = np.random.default_rng(7)
    members = _members(33, rng)
    prep = RegionPrep(members)
    xs = _input(layout, len(members), 33, 5, dtype, rng)
    views, _ = region_layout(xs, len(members))
    views[0][int(members[0][0][0]), 0] = -0.0  # a copied negative zero
    want = region_prep_plain(prep, xs)
    got = cs.ordered_prep_plain(prep, xs)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert torch.signbit(got[0, 0])


def test_region_layout_refuses_other_layouts():
    rng = np.random.default_rng(4)
    prep = RegionPrep(_members(20, rng)[:2])
    z = torch.zeros((3, 5, 20))
    with pytest.raises(ValueError, match="stacked"):  # separate tensors
        prep([torch.zeros((20, 5)), torch.zeros((20, 5))])
    with pytest.raises(ValueError, match="stacked"):  # not the same strides
        prep([z[0].T, z[1].T.contiguous()])
    with pytest.raises(ValueError, match="stacked"):  # unequally spaced
        region_layout([z[0].T, z[2].T, z[1].T], 3)
    with pytest.raises(ValueError, match="members"):  # one view missing
        prep([z[0].T])
    with pytest.raises(ValueError, match="K, B"):
        prep(torch.zeros((20, 5, 1)))
    with pytest.raises(ValueError, match="input row"):  # too few rows
        prep(torch.zeros((10, 5)))
    views, step = region_layout([z[0].T, z[1].T, z[2].T], 3)
    assert step == 100 and [v.shape for v in views] == [(20, 5)] * 3
    assert region_layout([z[1].T] * 2, 2)[1] == 0  # one view, shared


def test_identity_site_passes_its_input_through():
    prep = RegionPrep([(np.arange(12), None, 0)])
    x = torch.randn(7, 12).T
    assert prep.identity and prep.launches(x) == 0 and prep(x) is x
    wider = torch.randn(14, 3)  # the keep is not the whole input: a gather
    assert prep.launches(wider) == 1
    assert torch.equal(prep(wider), wider[:12])
    shared = RegionPrep([(np.arange(12), np.arange(12) % 5, 5)])
    assert not shared.identity and shared.launches(torch.zeros(12, 2)) == 1


@pytest.mark.parametrize("arch", ["olmo-1b", "deepseek-v2-lite-16b"])
def test_chip_smoke_regions_are_the_serves_regions(arch):
    """``chip_smoke.region_preps`` without records (the ``--only prep``
    members) has the region shapes of the fixture's own records, and the
    per-step count is one region prep a region (every seeded site prunes)."""
    cs = _chip_smoke()
    cfg = reduced_config(get_arch(arch), vocab=64)
    if cfg.moe is not None:
        cfg = replace(cfg, n_layers=1)
    art = seeded_artifact(cfg, seed=0, device="cpu")
    drawn = cs.region_preps(cfg)
    real = cs.region_preps(cfg, art.records)
    assert [(lb, p.name, p.n_members, p.rows, p.src.size, k, b, st)
            for lb, p, k, b, st, _ in drawn] == \
        [(lb, p.name, p.n_members, p.rows, p.src.size, k, b, st)
         for lb, p, k, b, st, _ in real]
    groups = cs.site_groups(cfg)
    assert sum(len(g) for g in groups) == len(
        [n for n in art.records if ".l0" in n])
    assert cs.region_preps_per_step(cfg, art.records) == \
        len(groups) * cfg.n_layers
    for _, prep, _, _, _, names in real:
        want = site_prep([art.records[n] for n in names])
        assert np.array_equal(prep.src, want.src)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_chip_smoke_regions_of_the_recurrent_serves(arch):
    """The recurrent serves' regions: rwkv6's r+k+v+g read four distinct
    inputs (a stacked buffer, as the experts'), k+r one shared input; the
    hybrid's shared block's regions come once, without a layer, and run
    once an insertion (5 layers at period 2: two insertions and a tail)."""
    cs = _chip_smoke()
    cfg = reduced_config(get_arch(arch), vocab=64)
    if cfg.family == "hybrid":
        cfg = replace(cfg, n_layers=5)
    art = seeded_artifact(cfg, seed=0, device="cpu")
    drawn = cs.region_preps(cfg)
    real = cs.region_preps(cfg, art.records)
    assert [(lb, p.name, p.n_members, p.rows, p.src.size, k, b, st)
            for lb, p, k, b, st, _ in drawn] == \
        [(lb, p.name, p.n_members, p.rows, p.src.size, k, b, st)
         for lb, p, k, b, st, _ in real]
    groups = cs.site_groups(cfg) + cs.shared_groups(cfg)
    assert sorted(n for g in groups for n in g) == sorted(
        n for n in art.records if ".l0" in n or n.startswith("shared_attn."))
    stacked = {names[0]: st for _, _, _, _, st, names in real}
    if cfg.family == "ssm":
        assert stacked == {"tm.r.l0": True, "tm.o.l0": False,
                           "cm.k.l0": False, "cm.v.l0": False}
        per_step = 4 * cfg.n_layers
    else:
        assert not any(stacked.values())
        assert cs.shared_insertions(cfg) == 2
        per_step = 2 * cfg.n_layers + 4 * 2
    assert cs.region_preps_per_step(cfg, art.records) == per_step
    assert cs.region_launches_per_step(cfg) == per_step


def test_chip_smoke_regions_of_the_whisper_serve():
    """whisper's decoder regions a layer: q+k+v (k weight-shared), attn.o,
    xattn.q, xattn.o (shared), fc1 (shared) and fc2 — one region prep and
    one K1/K2 launch each, 12 launches a layer; the encoder's sites and
    xattn.k/v are in the artifact but in no region of a decode step."""
    cs = _chip_smoke()
    cfg = reduced_config(get_arch("whisper-small"), vocab=64)
    art = seeded_artifact(cfg, seed=0, device="cpu")
    drawn = cs.region_preps(cfg)
    real = cs.region_preps(cfg, art.records)
    assert [(lb, p.name, p.n_members, p.rows, p.src.size, k, b, st)
            for lb, p, k, b, st, _ in drawn] == \
        [(lb, p.name, p.n_members, p.rows, p.src.size, k, b, st)
         for lb, p, k, b, st, _ in real]
    in_regions = {n for g in cs.site_groups(cfg) for n in g}
    assert in_regions == {n for n in cs.decoder_routed(art.records)
                          if n.endswith(".l0")}
    assert len(in_regions) == 8 and not any(st for *_, st, _ in real)
    shared = {names[0] for _, p, _, _, _, names in real if p.rows < p.src.size}
    assert shared == {"dec.attn.q.l0", "dec.xattn.o.l0", "dec.mlp.fc1.l0"}
    assert cs.region_preps_per_step(cfg, art.records) == 6 * cfg.n_layers
    assert cs.region_launches_per_step(cfg) == 6 * cfg.n_layers


@pytest.mark.parametrize("name,site", [
    ("attn.q.l3", "attn.q"), ("moe.up.l0.e5", "moe.up"),
    ("attn.dkv.l12", "attn.dkv"), ("head", "head")])
def test_region_site_drops_layer_and_expert(name, site):
    assert region_site(name) == site


def test_regions_of_equal_dimensions_count_apart():
    """Every region of a layer has its own launch key (deepseek's dkv+kr and
    shared gate+up have equal dimensions), and a region keeps its key from
    layer to layer."""
    cfg = replace(reduced_config(get_arch("deepseek-v2-lite-16b"), vocab=64),
                  n_layers=2)
    art = seeded_artifact(cfg, seed=0, device="cpu")
    cs = _chip_smoke()
    keys = [[site_prep([art.records[n] for n in g]).shape_key(
                cfg.d_model, 4, 2) for g in cs.site_groups(cfg, li)]
            for li in range(cfg.n_layers)]
    assert len(set(keys[0])) == len(keys[0])
    names = [k[0] for k in keys[0]]
    assert len(set(names)) == len(names) and all(names)
    assert [k[0] for k in keys[1]] == names


def test_seeded_prep_is_the_fixtures_draw():
    """``testing.seeded_prep`` draws the kept columns and labels that
    ``seeded_artifact`` gives a site from the same generator."""
    cfg = reduced_config(get_arch("olmo-1b"), vocab=64)
    art = seeded_artifact(cfg, seed=3, device="cpu")
    rec = art.records["attn.k.l1"]  # weight-shared
    sites = [s[0] for s in dense_sites(cfg)]
    rng = np.random.default_rng((3, 2, sites.index("attn.k")))
    kept, labels, k_dec = seeded_prep(cfg.d_model, rng, True)
    np.testing.assert_array_equal(kept, rec.kept_columns)
    np.testing.assert_array_equal(labels, rec.shared.labels)
    assert k_dec == rec.shared.n_clusters
