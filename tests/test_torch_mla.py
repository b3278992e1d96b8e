"""MLA attention of the port (``repro_torch.models.attention``: ``mla_prefill``,
``mla_decode``, the contiguous and paged latent caches) against
``repro.models.attention`` at reduced deepseek-v2-lite widths.

The same numpy weights, activations and caches go through both packages in
float32.  Outputs, the updated latent caches and ``kpos`` agree within 1e-5
* max(1, max|ref|): the same products in other summation orders.  Decode
runs with one idle slot (``pos == -1``), which must write nothing (the JAX
package's ``one_hot(-1)`` is all zeros; the port guards every write), and
with the paged cache behind a block table whose unallocated entries point
at the null block.  Engines on a paged and on a contiguous cache give the
same logits within 1e-4 and the same greedy tokens (the port of the JAX
package's paged-vs-contiguous check for MLA)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models import api as japi
from repro.models import attention as jatt

from repro_torch.convert import config_from_reference, params_from_numpy
from repro_torch.models import api as tapi
from repro_torch.models import attention as tatt
from repro_torch.serving.engine import ServingEngine

TOL = 1e-5
H, DC, NOPE, ROPE, VD, D = 4, 32, 32, 16, 32, 64
KW = dict(n_heads=H, kv_lora=DC, qk_nope=NOPE, qk_rope=ROPE, v_dim=VD,
          rope_theta=10000.0)


def _weights(rng):
    def w(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)}
    return {"q": w(D, H * (NOPE + ROPE)), "dkv": w(D, DC), "kr": w(D, ROPE),
            "uk": w(DC, H * NOPE), "uv": w(DC, H * VD), "o": w(H * VD, D)}


def _jp(p):
    return jax.tree.map(jnp.asarray, p)


def _tp(p):
    return jax.tree.map(torch.from_numpy, p)


def _close(got, want, tol=TOL):
    got = got.detach().to(torch.float32).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_mla_prefill_matches_reference():
    rng = np.random.default_rng(0)
    p = _weights(rng)
    b, s = 2, 9
    x = rng.standard_normal((b, s, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s))
    jy, jc, jr = jatt.mla_prefill(_jp(p), jnp.asarray(x), jnp.asarray(pos), **KW)
    ty, tc, tr = tatt.mla_prefill(_tp(p), torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), **KW)
    for got, want in ((ty, jy), (tc, jc), (tr, jr)):
        _close(got, want)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_mla_decode_matches_reference_with_an_idle_slot(paged):
    rng = np.random.default_rng(1 + int(paged))
    p = _weights(rng)
    b, smax, bs = 4, 8, 4
    mb = smax // bs
    x = rng.standard_normal((b, 1, D)).astype(np.float32)
    pos = np.array([3, -1, 0, 7], np.int32)  # row 1 is idle
    # every row holds its earlier tokens; the idle row's view is stale data
    kpos = np.where(np.arange(smax)[None] < np.maximum(pos, 2)[:, None],
                    np.arange(smax)[None], -1).astype(np.int32)
    c_view = rng.standard_normal((b, smax, DC)).astype(np.float32)
    r_view = rng.standard_normal((b, smax, ROPE)).astype(np.float32)
    if paged:  # the same view in a pool; row 2's second block unallocated
        tbl = (1 + np.arange(b * mb)).reshape(b, mb).astype(np.int32)
        tbl[2, 1] = 0
        kpos[2, bs:] = -1
        c_pool = np.zeros((b * mb + 1, bs, DC), np.float32)
        r_pool = np.zeros((b * mb + 1, bs, ROPE), np.float32)
        for r in range(b):
            for j in range(mb):
                if tbl[r, j]:
                    c_pool[tbl[r, j]] = c_view[r, j * bs:(j + 1) * bs]
                    r_pool[tbl[r, j]] = r_view[r, j * bs:(j + 1) * bs]
        jcache = jatt.PagedMLACache(jnp.asarray(c_pool), jnp.asarray(r_pool),
                                    jnp.asarray(kpos), jnp.asarray(tbl))
        tcache = tatt.PagedMLACache(*(torch.from_numpy(a.copy()) for a in
                                      (c_pool, r_pool, kpos, tbl)))
    else:
        jcache = jatt.MLACache(jnp.asarray(c_view), jnp.asarray(r_view),
                               jnp.asarray(kpos))
        tcache = tatt.MLACache(*(torch.from_numpy(a.copy()) for a in
                                 (c_view, r_view, kpos)))
    jy, jnew = jatt.mla_decode(_jp(p), jnp.asarray(x), jcache, jnp.asarray(pos),
                               **KW)
    ty, tnew = tatt.mla_decode(_tp(p), torch.from_numpy(x), tcache,
                               torch.from_numpy(pos), **KW)
    assert tnew is tcache  # updated in place
    _close(ty, jy)
    for name in ("c_kv", "k_rope"):  # paged: the idle row's write sank
        _close(getattr(tnew, name), getattr(jnew, name))  # into block 0
    np.testing.assert_array_equal(tnew.kpos.numpy(), np.asarray(jnew.kpos))
    # the idle row wrote nothing of its own
    assert (tnew.kpos[1].numpy() == kpos[1]).all()
    if not paged:
        np.testing.assert_array_equal(tnew.c_kv[1].numpy(), c_view[1])


@pytest.fixture(scope="module")
def mla_model():
    jcfg = jreduced(jget_arch("deepseek-v2-lite-16b"), vocab=128)
    params = japi.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = config_from_reference(jcfg)
    return tcfg, params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                   "cpu")


def _stepwise_logits(eng, prompt, n):
    """Greedy-decode ``n`` steps through ``api.decode`` on the engine's own
    state, returning the submitted request's logits row each step."""
    rid = eng.submit(prompt)
    slot = next(s for s, r in eng.slot_req.items() if r == rid)
    tok, pos = prompt[-1], len(prompt)
    rows = []
    for _ in range(n):
        toks = torch.zeros((eng.n_slots, 1), dtype=torch.long)
        toks[slot, 0] = tok
        posv = torch.full((eng.n_slots,), -1, dtype=torch.long)
        posv[slot] = pos - 1
        with torch.no_grad():
            logits, eng.state = tapi.decode(eng.params, eng.cfg, eng.state,
                                            toks, posv)
        row = logits[slot].to(torch.float32).numpy()
        rows.append(row)
        tok, pos = int(row.argmax()), pos + 1
    eng.cancel(rid)
    return np.stack(rows)


def test_paged_matches_contiguous_logits(mla_model):
    cfg, params = mla_model
    kw = dict(n_slots=2, max_len=64, device="cpu")
    ref = ServingEngine(params, cfg, kv_block=None, **kw)
    pag = ServingEngine(params, cfg, kv_block=16, **kw)
    assert set(pag.state) == {"c_kv", "k_rope", "kpos", "block_tbl"}
    prompt = [(7 * i + 3) % cfg.vocab for i in range(24)]
    l_ref = _stepwise_logits(ref, prompt, 6)
    l_pag = _stepwise_logits(pag, prompt, 6)
    assert np.abs(l_ref - l_pag).max() <= 1e-4
    # generate() crosses block boundaries (mid-decode growth)
    r_ref = ref.generate([prompt, prompt[:13]], max_new_tokens=30)
    r_pag = pag.generate([prompt, prompt[:13]], max_new_tokens=30)
    assert [r.tokens for r in r_ref] == [r.tokens for r in r_pag]
    assert pag.pool_stats()["in_use_blocks"] == 0
