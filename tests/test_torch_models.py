"""Dense-family model code of the port against ``repro.models.api`` at the
reduced olmo-1b config: JAX-initialised parameters are converted (never
re-drawn), the same numpy tokens go through both packages; logits <= 1e-4."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import arch_to_dict as jarch_to_dict
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi

from repro_torch.configs import (arch_from_dict, arch_to_dict, get_arch,
                                 reduced_config)
from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer

TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_arch("olmo-1b"), vocab=256)
    jparams = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = reduced_config(get_arch("olmo-1b"), vocab=256)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def _np(t):
    return t.detach().to(torch.float32).numpy()


def test_configs_agree_field_by_field():
    for red in (False, True):
        j, t = jget_arch("olmo-1b"), get_arch("olmo-1b")
        if red:
            j, t = jreduced(j, vocab=256), reduced_config(t, vocab=256)
        assert jarch_to_dict(j) == arch_to_dict(t)
        assert config_from_reference(j) == t
        assert arch_from_dict(arch_to_dict(t)) == t
    assert get_arch("olmo-1b").pdtype == torch.bfloat16
    assert reduced_config(get_arch("olmo-1b")).cdtype == torch.float32
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_params_convert_leaf_for_leaf_including_bf16(model):
    jcfg, jparams, tcfg, tparams = model
    jl = jax.tree_util.tree_leaves_with_path(jparams)
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            flat[path] = t

    walk(tparams, ())
    assert len(jl) == len(flat)
    for path, leaf in jl:
        key = tuple(p.key for p in path)
        np.testing.assert_array_equal(np.asarray(leaf), flat[key].numpy())
    # bf16 leaves cross through their 16-bit pattern, bit for bit
    bcfg = replace(tcfg, param_dtype="bfloat16")
    a = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)), jnp.bfloat16)
    t = params_from_numpy({"w": np.asarray(a)}, bcfg, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), _np(t))
    t2 = params_from_numpy({"w": np.asarray(a).view(np.uint16)}, bcfg, "cpu")["w"]
    assert torch.equal(t, t2)


def test_init_params_numpy_seeded_has_the_reference_layout(model):
    jcfg, jparams, tcfg, _ = model
    a = ttransformer.init_params_numpy(3, tcfg)
    b = ttransformer.init_params_numpy(3, tcfg)
    js = jax.tree.map(lambda x: x.shape, jparams)
    ts = jax.tree.map(lambda x: x.shape, a)
    assert js == ts
    assert all(np.array_equal(x, y) for x, y in
               zip(jax.tree.leaves(a), jax.tree.leaves(b)))
    w = a["blocks"]["attn"]["q"]["w"]
    assert np.abs(w).max() <= 2.0 / np.sqrt(tcfg.d_model) + 1e-6
    # the numpy-seeded tree feeds both packages
    tok = np.array([[5, 9, 2, 77]], np.int32)
    hj, _ = japi.prefill(jax.tree.map(jnp.asarray, a), jcfg,
                         {"tokens": jnp.asarray(tok)})
    ht, _ = tapi.prefill(tapi.init_params(3, tcfg, "cpu"), tcfg,
                         {"tokens": torch.from_numpy(tok)})
    np.testing.assert_allclose(_np(ht), np.asarray(hj), rtol=0, atol=TOL)


def test_layers_match(model):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 40], [7, 8, 9, 10, 11]], np.int32)
    from repro.models import layers as jlayers
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos))),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=0, atol=1e-5)
    h = rng.standard_normal((3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlayers.non_parametric_ln(torch.from_numpy(h))),
        np.asarray(jlayers.non_parametric_ln(jnp.asarray(h))), rtol=0, atol=1e-5)
    w = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        _np(tlayers.rms_norm(torch.from_numpy(h), torch.from_numpy(w))),
        np.asarray(jlayers.rms_norm(jnp.asarray(h), jnp.asarray(w))),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("s", [8, 13, 128])  # 128 = two query chunks of 64
def test_prefill_logits_and_caches(model, s):
    jcfg, jparams, tcfg, tparams = model
    tok = np.random.default_rng(s).integers(0, 256, (2, s)).astype(np.int32)
    hj, (kj, vj) = japi.prefill(jparams, jcfg, {"tokens": jnp.asarray(tok)},
                                collect_cache=True)
    from repro.models import transformer as jtransformer
    lj = jtransformer.logits_from_hidden(jparams, jcfg, hj)
    with torch.no_grad():
        ht, (kt, vt) = tapi.prefill(tparams, tcfg,
                                    {"tokens": torch.from_numpy(tok)},
                                    collect_cache=True)
        lt = ttransformer.logits_from_hidden(tparams, tcfg, ht)
    np.testing.assert_allclose(_np(lt), np.asarray(lj), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(kt), np.asarray(kj), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(vt), np.asarray(vj), rtol=0, atol=TOL)


def _decode_both(jcfg, jparams, tcfg, tparams, toks, *, smax, kv_block=None,
                 start=0, jstate=None, tstate=None, tbl=None):
    """Run ``toks [T, B]`` through both decoders; returns per-step logits and
    the final states."""
    b = toks.shape[1]
    if jstate is None:
        jstate = japi.init_decode_state(jcfg, b, smax, kv_block=kv_block)
        tstate = tapi.init_decode_state(tcfg, b, smax, kv_block=kv_block,
                                        device="cpu")
        if tbl is not None:
            jstate["block_tbl"] = jnp.asarray(tbl)
            tstate["block_tbl"].copy_(torch.from_numpy(tbl))
    out = []
    for t, row in enumerate(toks):
        pos = np.full(b, start + t, np.int32)
        lj, jstate = japi.decode(jparams, jcfg, jstate, jnp.asarray(row[:, None]),
                                 jnp.asarray(pos))
        with torch.no_grad():
            lt, tstate = tapi.decode(tparams, tcfg, tstate,
                                     torch.from_numpy(row[:, None]),
                                     torch.from_numpy(pos))
        out.append((np.asarray(lj), _np(lt)))
    return out, jstate, tstate


def test_three_decode_steps_contiguous(model):
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(2).integers(0, 256, (3, 2)).astype(np.int32)
    out, jstate, tstate = _decode_both(jcfg, jparams, tcfg, tparams, toks, smax=16)
    for lj, lt in out:
        assert lt.shape == (2, 256)
        np.testing.assert_allclose(lt, lj, rtol=0, atol=TOL)
    for name in ("k", "v", "kpos"):
        np.testing.assert_allclose(_np(tstate[name]), np.asarray(jstate[name]),
                                   rtol=0, atol=TOL)


def test_paged_equals_contiguous_and_reference(model):
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(3).integers(0, 256, (6, 2)).astype(np.int32)
    bs, mb, nb = tapi.paged_layout(tcfg, 16, 4, None, 2)
    assert (bs, mb, nb) == japi.paged_layout(jcfg, 16, 4, None, 2)
    tbl = np.array([[3, 1, 0, 0], [2, 5, 0, 0]], np.int32)  # scattered blocks
    out_p, jstate, tstate = _decode_both(jcfg, jparams, tcfg, tparams, toks,
                                         smax=16, kv_block=4, tbl=tbl)
    out_c, _, _ = _decode_both(jcfg, jparams, tcfg, tparams, toks, smax=16)
    for (lj, lt), (_, lc) in zip(out_p, out_c):
        np.testing.assert_allclose(lt, lj, rtol=0, atol=TOL)
        np.testing.assert_allclose(lt, lc, rtol=0, atol=TOL)
    # pools agree outside the null block (block 0 is a write sink)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tstate[name])[:, 1:],
                                   np.asarray(jstate[name])[:, 1:],
                                   rtol=0, atol=TOL)
    np.testing.assert_array_equal(_np(tstate["kpos"]), np.asarray(jstate["kpos"]))


def test_window_ring_through_a_wrap(model):
    jcfg, jparams, tcfg, tparams = model
    jw, tw = replace(jcfg, attn_window=4), replace(tcfg, attn_window=4)
    toks = np.random.default_rng(4).integers(0, 256, (7, 2)).astype(np.int32)
    out, jstate, tstate = _decode_both(jw, jparams, tw, tparams, toks, smax=16)
    assert tstate["k"].shape[2] == 4  # the ring, not max_len
    for lj, lt in out:
        np.testing.assert_allclose(lt, lj, rtol=0, atol=TOL)
    np.testing.assert_array_equal(_np(tstate["kpos"]), np.asarray(jstate["kpos"]))
    assert _np(tstate["kpos"]).max() == 6 and _np(tstate["kpos"]).min() == 3
    # paged ring: the block shrinks to divide the window
    assert tapi.paged_layout(tw, 16, 3, None, 2) == japi.paged_layout(jw, 16, 3, None, 2)


@pytest.mark.parametrize("kv_block", [None, 4], ids=["contiguous", "paged"])
@pytest.mark.parametrize("window", [None, 4], ids=["full", "ring"])
def test_idle_slot_writes_nothing(model, kv_block, window):
    """pos == -1 (an idle serving slot) must leave its cache row untouched —
    torch would silently wrap a negative index onto a live entry."""
    _, _, tcfg, tparams = model
    cfg = replace(tcfg, attn_window=window)
    st = tapi.init_decode_state(cfg, 3, 8, kv_block=kv_block, device="cpu")
    if kv_block is not None:
        st["block_tbl"].copy_(torch.tensor([[1, 2], [3, 4], [5, 6]])[:, :st["block_tbl"].shape[1]])
    for name in ("k", "v"):
        st[name].normal_(generator=torch.Generator().manual_seed(0))
    st["kpos"][:, :, 0] = 0
    before = {k: v.clone() for k, v in st.items()}
    tok = torch.tensor([[7], [8], [9]])
    pos = torch.tensor([1, -1, 2])  # row 1 is idle
    with torch.no_grad():
        logits, st2 = tapi.decode(tparams, cfg, st, tok, pos)
    assert st2 is st and torch.isfinite(logits).all()
    assert torch.equal(st["kpos"][:, 1], before["kpos"][:, 1])
    assert (st["kpos"][:, 0] == before["kpos"][:, 0]).sum() < before["kpos"][:, 0].numel()
    if kv_block is None:
        for name in ("k", "v"):
            assert torch.equal(st[name][:, 1], before[name][:, 1])
            assert not torch.equal(st[name][:, 0], before[name][:, 0])
    else:
        tblv = st["block_tbl"][1].long()
        for name in ("k", "v"):  # the idle row's own blocks are untouched ...
            assert torch.equal(st[name][:, tblv], before[name][:, tblv])
            changed = (st[name] != before[name]).flatten(2).any(-1).any(0)
            # ... and nothing but the null block and the live rows' blocks moved
            live = set(st["block_tbl"][[0, 2]].flatten().tolist()) | {0}
            assert set(torch.nonzero(changed).flatten().tolist()) <= live


def test_other_families_are_refused(model):
    """What stays refused, by name: a dense config with m-RoPE is not the
    vlm family.  The manual expert-parallel MoE is served (its decode state
    is the MoE family's; ``tests/test_torch_moe_manual.py``), and so is the
    audio family (``tests/test_torch_whisper.py``)."""
    _, _, tcfg, tparams = model
    manual = replace(reduced_config(get_arch("mixtral-8x22b")),
                     moe_manual=True)
    st = tapi.init_decode_state(manual, 1, 8, device="cpu")
    assert set(st) == {"k", "v", "kpos"}
    with pytest.raises(NotImplementedError):
        tapi.prefill(tparams, replace(tcfg, pos="mrope"),
                     {"tokens": torch.zeros((1, 2), dtype=torch.long)})


def test_sampling_is_greedy_at_zero_and_keyed_per_row():
    logits = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 50))
                              .astype(np.float32))
    keys = torch.tensor([tapi.request_key(0, r) for r in (3, 1, 3, 2)])
    counts = torch.tensor([2, 2, 2, 0])
    greedy = tapi.sample_tokens(logits, keys, counts, torch.zeros(4))
    assert torch.equal(greedy, logits.argmax(-1))
    same_rows = logits.clone()
    same_rows[2] = same_rows[0]
    temps = torch.full((4,), 0.9)
    a = tapi.sample_tokens(same_rows, keys, counts, temps)
    assert a[0] == a[2]  # same key, count and logits: same draw in any row
    perm = torch.tensor([2, 3, 0, 1])
    b = tapi.sample_tokens(same_rows[perm], keys[perm], counts[perm], temps)
    assert torch.equal(b, a[perm])  # draws do not depend on row order
    # distribution: 2000 draws of one row under changing counts follow softmax
    row = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).expand(2000, 4)
    draws = tapi.sample_tokens(row, torch.full((2000,), tapi.request_key(7, 0)),
                               torch.arange(2000), torch.ones(2000))
    freq = torch.bincount(draws, minlength=4).float() / 2000
    assert (freq - torch.softmax(row[0], -1)).abs().max() < 0.04
