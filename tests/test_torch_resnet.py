"""The ResNet, dense, against the reference (``repro.models.resnet``) on the
same parameters (converted from the JAX pytree): ``resnet_forward`` and
``resnet_loss`` within 1e-5 relative at reduced width — the stem, a stride-2
stage transition with its 1x1 ``proj`` ("SAME" padding asymmetric at even
sizes), GroupNorm(1)'s population variance — and their gradients;
``init_resnet``'s tree, ``conv_kernels`` and the site table are the
reference's; ``textures_like`` is bitwise the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as jsyn
from repro.models import compress_adapters as jca
from repro.models import resnet as jres

from repro_torch.convert import config_from_reference, resnet_params_from_numpy
from repro_torch.data import synthetic as tsyn
from repro_torch.models import compress_adapters as tca
from repro_torch.models import resnet as tres
from repro_torch.models.api import family_of

CFGS = {
    "small": jres.resnet_small_config(classes=6),
    "three_stages": jres.ResNetConfig(stages=(2, 1, 1), widths=(8, 12, 16),
                                      classes=5),
}


def _params(cfg, seed=0):
    jp = jres.init_resnet(jax.random.PRNGKey(seed), cfg)
    np_tree = jax.tree.map(np.asarray, jp)
    return jp, resnet_params_from_numpy(np_tree, config_from_reference(cfg),
                                        "cpu")


def _images(n, size, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("size", [8, 15, 16])
def test_forward_matches_the_reference(name, size):
    cfg = CFGS[name]
    jp, tp = _params(cfg)
    x = _images(3, size)
    want = np.asarray(jres.resnet_forward(jp, jnp.asarray(x)))
    got = tres.resnet_forward(tp, torch.from_numpy(x))
    assert got.shape == want.shape == (3, cfg.classes)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("name", sorted(CFGS))
def test_loss_and_gradients_match_the_reference(name):
    cfg = CFGS[name]
    jp, tp = _params(cfg, seed=3)
    x = _images(4, 12, seed=2)
    y = np.random.default_rng(5).integers(0, cfg.classes, 4).astype(np.int32)
    jl, jg = jax.value_and_grad(jres.resnet_loss)(jp, jnp.asarray(x),
                                                  jnp.asarray(y))
    leaves = [t.requires_grad_(True) for t in jax.tree.leaves(tp)]
    tl = tres.resnet_loss(tp, torch.from_numpy(x), torch.from_numpy(y))
    assert _rel(tl.detach().numpy(), np.asarray(jl)) <= 1e-5
    grads = torch.autograd.grad(tl, leaves)
    for g, want in zip(grads, jax.tree.leaves(jg)):
        assert g.shape == want.shape
        assert float(np.abs(g.numpy() - np.asarray(want)).max()) <= \
            1e-5 * max(1.0, float(np.abs(np.asarray(want)).max()))


def test_stride_two_pads_as_xla_same():
    """The stage transition's conv pads (0, 1) at 16 and (1, 1) at 15, as
    ``lax.conv_general_dilated(..., "SAME")``; ``F.conv2d`` would refuse
    ``padding="same"`` at stride 2."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    for size in (15, 16):
        x = rng.standard_normal((2, 3, size, size)).astype(np.float32)
        want = jax.lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(k), (2, 2), "SAME",
            dimension_numbers=("NCHW", "OIHW", "NCHW"))
        got = tres.conv_same(torch.from_numpy(x), torch.from_numpy(k), 2)
        assert got.shape == want.shape
        assert _rel(got.numpy(), np.asarray(want)) <= 1e-6


def test_group_norm_uses_the_population_variance():
    x = torch.from_numpy(_images(2, 5)) * 3 + 1
    y = tres._gn(x, torch.ones(3))
    flat = y.reshape(2, -1).double()
    assert torch.allclose(flat.mean(1), torch.zeros(2, dtype=torch.float64),
                          atol=1e-6)
    assert torch.allclose(flat.var(1, correction=0),
                          torch.ones(2, dtype=torch.float64), atol=1e-4)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_init_tree_sites_and_kernels_are_the_references(name):
    cfg = CFGS[name]
    jp = jres.init_resnet(jax.random.PRNGKey(0), cfg)
    tcfg = config_from_reference(cfg)
    tp = tres.init_resnet(torch.Generator().manual_seed(0), tcfg, "cpu")
    jshape = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jp)
    tshape = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), tp)
    assert jshape == tshape
    assert [tres.block_stride(b) for b in tp["blocks"]] == [
        2 if ("proj" in b and b["proj"].shape[0] != b["proj"].shape[1]) else 1
        for b in jp["blocks"]]
    assert [n for n, _ in tres.conv_kernels(tp)] == [
        n for n, _ in jres.conv_kernels(jp)]
    jsites = jca.sites_for(jp, cfg)
    tsites = tca.sites_for(tp, tcfg)
    assert [(type(s).__name__, s.name, s.path, getattr(s, "transpose", None))
            for s in tsites] == [
        (type(s).__name__, s.name, s.path, getattr(s, "transpose", None))
        for s in jsites]
    assert family_of(tcfg) == "resnet"
    # He-normal scale: the stem's std near sqrt(2 / fan_in)
    fan = cfg.in_ch * cfg.stem_kernel ** 2
    assert abs(float(tp["stem"].std()) / (2.0 / fan) ** 0.5 - 1) < 0.35


@pytest.mark.parametrize("n,size,classes,seed", [(5, 24, 6, 0), (3, 32, 10, 7),
                                                 (4, 64, 200, 1)])
def test_textures_like_bitwise(n, size, classes, seed):
    jx, jy = jsyn.textures_like(n, size=size, classes=classes, seed=seed)
    tx, ty = tsyn.textures_like(n, size=size, classes=classes, seed=seed)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    assert tx.tobytes() == jx.tobytes() and ty.tobytes() == jy.tobytes()


def test_config_crosses_both_ways():
    for cfg in (jres.resnet34_config(), jres.resnet_small_config(classes=6)):
        t = config_from_reference(cfg)
        assert isinstance(t, tres.ResNetConfig)
        assert t == tres.ResNetConfig(**{**cfg.__dict__})
    assert tres.resnet34_config() == config_from_reference(jres.resnet34_config())
