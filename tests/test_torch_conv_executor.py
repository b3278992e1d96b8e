"""Compressed conv serving: the port's ``ConvLCC`` (K2's plain version on the
CPU) against the reference's ``CompressedExecutor(...).conv`` (interpret
mode) on the same artifact — the reference compresses the reduced ResNet
(``resnet_small_config``) in FK and in PK and the port serves its
conversion.  The whole ``resnet_forward`` through either executor within
1e-4, every conv site and the head routed (``routed == sites``); each conv
site alone at stride 1 and 2, "SAME" and "VALID"; channels the compressor
subsampled out go through the residual conv; a site that cannot run
raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core
from repro.models import api as japi
from repro.models import resnet as jres
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import artifact_from_reference
from repro_torch.kernels import dispatch
from repro_torch.models import resnet as tres
from repro_torch.serving.executor import CompressedExecutor, ConvLCC

CFG = jres.resnet_small_config(classes=6)
TOL = 1e-4


def _comp(method):
    return core.CompressionConfig(algorithm="fp", weight_sharing=True,
                                  max_share_rel_err=0.06, conv_method=method)


def _images(n, size, c=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, c, size, size)).astype(np.float32)


def _err(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.fixture(scope="module", params=["fk", "pk"])
def served(request):
    """(method, reference artifact, reference executor, port artifact, port
    executor)."""
    jp = jres.init_resnet(jax.random.PRNGKey(2), CFG)
    jart = japi.compress_model(jp, CFG, _comp(request.param))
    tart = artifact_from_reference(jart, "cpu")
    return (request.param, jart, JExecutor(jart, interpret=None), tart,
            CompressedExecutor(tart, device="cpu"))


def test_forward_matches_the_reference_executor(served):
    method, jart, jex, tart, tex = served
    x = _images(2, 8)
    want = jres.resnet_forward(jart.params, jnp.asarray(x), executor=jex)
    got = tres.resnet_forward(tart.params, torch.from_numpy(x), executor=tex)
    assert _err(got, want) <= TOL
    # and the port's own dense-effective forward
    dense = tres.resnet_forward(tart.params, torch.from_numpy(x))
    assert _err(got, dense) <= TOL
    assert tex.routed == tex.sites == set(tart.records)
    assert {n for n in tex.sites if n != "head"} == set(tex._convs)
    assert tex.plan_fallbacks == {}  # no decode step, no plan to refuse
    for name, cv in tex._convs.items():
        assert cv.method == method
        assert cv.channels == sorted(tart.records[name]["decompositions"])
        assert cv.rest is None  # every channel decomposed


@pytest.mark.parametrize("name,c_in,stride,padding", [
    ("stem", 3, 1, "SAME"), ("block0.conv2", 16, 1, "VALID"),
    ("block1.conv1", 16, 2, "SAME"), ("block1.proj", 16, 2, "SAME"),
    ("block1.conv2", 32, 2, "VALID")])
def test_each_conv_site_matches_the_reference(served, name, c_in, stride,
                                              padding):
    _, _, jex, _, tex = served
    x = _images(2, 9, c_in, seed=3)
    want = jex.conv(name)(jnp.asarray(x), stride=stride, padding=padding)
    got = tex.conv(name)(torch.from_numpy(x), stride=stride, padding=padding)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _err(got, want) <= TOL * max(1.0, float(jnp.abs(want).max()))


def test_conv_launches_one_group_a_site(served, monkeypatch):
    """One grouped (K2) evaluation a conv site; no per-channel route.  On
    the CPU the plain version runs, so the device counts stay zero."""
    from repro_torch.kernels import ops

    _, _, _, tart, tex = served
    calls = []
    real = ops.lcc_group_matmul
    monkeypatch.setattr(ops, "lcc_group_matmul",
                        lambda *a: calls.append(a) or real(*a))
    dispatch.reset_launch_count()
    x = torch.from_numpy(_images(1, 8))
    tres.resnet_forward(tart.params, x, executor=tex)
    assert len(calls) == len(tex._convs)
    # in the forward's order: the stem, block0, then block1's proj first
    order = ["stem", "block0.conv1", "block0.conv2", "block1.proj",
             "block1.conv1", "block1.conv2"]
    assert [a[0].shape[0] for a in calls] == [
        len(tex._convs[n].channels) for n in order]
    # the launch's input is the site's group_input (what the card script
    # rebuilds for its kernel rows): the stem reads the image
    assert torch.equal(calls[0][3], tex._convs["stem"].group_input(x))
    assert dispatch.launch_counts() == {}


@pytest.mark.parametrize("method", ["fk", "pk"])
def test_subsampled_and_pruned_channels_take_the_residual_conv(method):
    jp = jres.init_resnet(jax.random.PRNGKey(4), CFG)
    # a group-lasso-pruned input channel: its kernel is zero everywhere
    jp["blocks"][1]["conv2"] = jp["blocks"][1]["conv2"].at[:, 5].set(0.0)
    jart = japi.compress_model(jp, CFG, _comp(method), conv_channel_subsample=3)
    tart = artifact_from_reference(jart, "cpu")
    jex, tex = JExecutor(jart, interpret=None), CompressedExecutor(tart, device="cpu")
    rec = tart.records["block1.conv2"]
    assert 5 not in rec["channels_nonzero"]
    assert list(rec["decompositions"]) == rec["channels_nonzero"][::3]
    cv = tex._convs["block1.conv2"]
    assert cv.rest is not None and cv.channels == list(rec["decompositions"])
    assert not cv.rest[:, cv.channels].any() and not cv.rest[:, 5].any()
    x = _images(2, 8, seed=5)
    want = jres.resnet_forward(jart.params, jnp.asarray(x), executor=jex)
    got = tres.resnet_forward(tart.params, torch.from_numpy(x), executor=tex)
    assert _err(got, want) <= TOL
    assert _err(got, tres.resnet_forward(tart.params, torch.from_numpy(x))) <= TOL
    assert tex.routed == tex.sites


def test_a_site_that_cannot_run_raises(served):
    _, _, _, tart, tex = served
    rec = tart.records["block0.conv1"]
    kernel = tart.params["blocks"][0]["conv1"].numpy()
    with pytest.raises(ValueError, match="conv method"):
        ConvLCC("block0.conv1", kernel, rec, "xk", device="cpu")
    with pytest.raises(ValueError, match="nothing to execute"):
        ConvLCC("c", np.zeros((4, 2, 3, 3)),
                {"decompositions": {}}, "fk", device="cpu")(
            torch.zeros(1, 2, 5, 5))
    with pytest.raises(ValueError, match="padding"):
        tex.conv("stem")(torch.zeros(1, 3, 8, 8), padding="FULL")
    # no fallback: a tensor on a device without a kernel is refused
    cv = ConvLCC("block0.conv1", kernel, rec, tex._convs["block0.conv1"].method,
                 device="meta")
    with pytest.raises(NotImplementedError, match="no kernel"):
        cv(torch.zeros(1, 16, 8, 8, device="meta"))


@pytest.mark.parametrize("method", ["fk", "pk"])
def test_seeded_conv_artifact_is_a_valid_conv_artifact(method):
    """The card's full-width fixture at a small width: conv records as
    ``finish_conv`` writes them, effective kernels those of
    ``effective_conv_kernel``, and the fused forward equal to the dense
    one (every channel decomposed, so no residual conv)."""
    from repro_torch.models.compress_adapters import effective_conv_kernel
    from repro_torch.testing import seeded_conv_artifact

    cfg = tres.ResNetConfig(stages=(1, 2, 1), widths=(8, 12, 16), classes=5)
    art = seeded_conv_artifact(cfg, seed=1, device="cpu", method=method)
    assert art.compression.conv_method == method and art.family == "resnet"
    rec = art.records["block1.conv1"]
    assert set(rec) == {"decompositions", "channels_nonzero", "baseline_adds",
                        "lcc_adds", "scale"}
    assert list(rec["decompositions"]) == rec["channels_nonzero"] == list(range(8))
    k = art.params["blocks"][1]["conv1"]
    want = effective_conv_kernel(np.zeros(k.shape), rec, method)
    assert np.abs(k.numpy() - want).max() <= 1e-6 * max(1.0, np.abs(want).max())
    ex = CompressedExecutor(art, device="cpu")
    assert all(cv.rest is None for cv in ex._convs.values())
    x = torch.from_numpy(_images(2, 12, seed=6))
    got = tres.resnet_forward(art.params, x, executor=ex)
    assert _err(got, tres.resnet_forward(art.params, x)) <= TOL
    assert ex.routed == ex.sites == set(art.records)
    assert not ex._matvecs["head"].prep.identity  # the head prunes: K3
