"""Conv units end to end against the reference: ``compress_model`` on the
reduced ResNet (``resnet_small_config``, converted params) gives the
reference's records bitwise — conv records channel for channel, the head's
dense record, the report and the dense-effective params; the port's shard
of a converted reference artifact is byte for byte the reference's; each
package loads the other's conv artifact and serves it through its
``ConvLCC`` within 1e-4 of the other's; channel keys come back as
integers in the writer's order (more than ten channels, so string order
would differ); the compress launcher's ``--arch resnet-small``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core
from repro.core.artifact import CompressedModel as JModel
from repro.models import api as japi
from repro.models import resnet as jres
from repro.serving.executor import CompressedExecutor as JExecutor

from repro_torch.convert import (artifact_from_reference, config_from_reference,
                                 resnet_params_from_numpy)
from repro_torch.core.artifact import CompressedModel
from repro_torch.core.compress import CompressionConfig
from repro_torch.models import api as tapi
from repro_torch.models import resnet as tres
from repro_torch.serving.executor import CompressedExecutor

from test_torch_compress import assert_conv_equal, assert_dense_equal, report_rows

CFG = jres.resnet_small_config(classes=6)
TCFG = config_from_reference(CFG)
SHARD = "step_0000000000/shard_0.msgpack"
TOL = 1e-4


def _leaves(t, pre=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{pre}/{k}")
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _leaves(v, f"{pre}/{i}")
    else:
        yield pre, np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)


def _assert_records_equal(a, b):
    assert list(a) == list(b)
    for name, ra in a.items():
        if isinstance(ra, dict):
            assert list(ra["decompositions"]) == list(b[name]["decompositions"])
            assert all(type(ch) is int for ch in b[name]["decompositions"])
            assert_conv_equal(ra, b[name])
        else:
            assert_dense_equal(ra, b[name])


def _assert_params_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert sorted(la) == sorted(lb)
    for k, v in la.items():
        assert v.dtype == lb[k].dtype and v.tobytes() == lb[k].tobytes(), k


def _images(n=2, size=8, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 3, size, size)).astype(np.float32)


def _comp(method, **kw):
    return dict(algorithm="fp", weight_sharing=True, max_share_rel_err=0.06,
                conv_method=method, **kw)


@pytest.fixture(scope="module", params=["fk", "pk"])
def both(request, tmp_path_factory):
    """(reference artifact, the port's own compression of the same params,
    the reference's save dir, the port's save dir of the converted
    reference artifact)."""
    jp = jres.init_resnet(jax.random.PRNGKey(7), CFG)
    jart = japi.compress_model(jp, CFG, core.CompressionConfig(
        **_comp(request.param)))
    tp = resnet_params_from_numpy(jax.tree.map(np.asarray, jp), TCFG, "cpu")
    tart = tapi.compress_model(tp, TCFG, CompressionConfig(**_comp(request.param)))
    root = tmp_path_factory.mktemp(request.param)
    jart.save(str(root / "ref"))
    artifact_from_reference(jart, "cpu").save(str(root / "port"))
    return jart, tart, root / "ref", root / "port"


def test_compress_model_matches_the_reference_bitwise(both):
    jart, tart, _, _ = both
    assert tart.family == "resnet" and tart.config == TCFG
    _assert_records_equal(jart.records, tart.records)
    assert report_rows(jart.report) == report_rows(tart.report)
    _assert_params_equal(jart.params, tart.params)
    assert list(tart.packed) == ["head"]
    jpk, tpk = jart.packed["head"], tart.packed["head"]
    for f in ("idx", "exp", "sign"):
        assert np.asarray(getattr(jpk, f)).tobytes() == getattr(tpk, f).tobytes()
    assert tart.pipeline_stats["units"] == jart.pipeline_stats["units"] == 7
    assert tart.pipeline_stats["jobs"] == jart.pipeline_stats["jobs"]


def test_shard_files_are_byte_identical(both):
    _, _, ref_dir, port_dir = both
    assert (port_dir / SHARD).read_bytes() == (ref_dir / SHARD).read_bytes()


def test_each_package_loads_and_serves_the_others(both):
    jart, _, ref_dir, port_dir = both
    x = _images()
    # the port serves the reference's save ...
    tback = CompressedModel.load(str(ref_dir), device="cpu")
    assert isinstance(tback.config, tres.ResNetConfig)
    _assert_records_equal(jart.records, tback.records)
    _assert_params_equal(jart.params, tback.params)
    tex = CompressedExecutor(tback, device="cpu")
    got = tres.resnet_forward(tback.params, torch.from_numpy(x), executor=tex)
    assert tex.routed == tex.sites == set(jart.records)
    # ... and the reference serves the port's
    jback = JModel.load(str(port_dir))
    assert type(jback.config) is jres.ResNetConfig and jback.config == CFG
    _assert_records_equal(tback.records, jback.records)
    jex = JExecutor(jback, interpret=None)
    want = jres.resnet_forward(jback.params, jnp.asarray(x), executor=jex)
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= TOL
    dense = jres.resnet_forward(jart.params, jnp.asarray(x))
    assert float(np.abs(got.numpy() - np.asarray(dense)).max()) <= TOL


def test_channel_keys_come_back_as_integers_in_the_writers_order(both, tmp_path):
    """16 channels: in string order "10" < "2".  A record written with its
    channels in another order (here reversed) comes back in that order from
    both packages; ``ConvLCC`` packs its members in integer order."""
    jart, _, ref_dir, _ = both
    tback = CompressedModel.load(str(ref_dir), device="cpu")
    rec = tback.records["block0.conv1"]
    assert list(rec["decompositions"]) == list(range(16))
    tart = artifact_from_reference(jart, "cpu")
    rev = tart.records["block0.conv1"]
    rev["decompositions"] = dict(reversed(list(rev["decompositions"].items())))
    jrev = jart.records["block0.conv1"]
    jrev["decompositions"] = dict(reversed(list(jrev["decompositions"].items())))
    try:
        tart.save(str(tmp_path / "port"))
        jart.save(str(tmp_path / "ref"))
    finally:
        jrev["decompositions"] = dict(sorted(jrev["decompositions"].items()))
    assert (tmp_path / "port" / SHARD).read_bytes() == \
        (tmp_path / "ref" / SHARD).read_bytes()
    want = list(range(15, -1, -1))
    back = CompressedModel.load(str(tmp_path / "port"), device="cpu")
    assert list(back.records["block0.conv1"]["decompositions"]) == want
    assert list(JModel.load(str(tmp_path / "port")).records["block0.conv1"]
                ["decompositions"]) == want
    ex = CompressedExecutor(back, device="cpu")
    assert ex._convs["block0.conv1"].channels == list(range(16))
    x = torch.from_numpy(_images(seed=3))
    assert torch.allclose(tres.resnet_forward(back.params, x, executor=ex),
                          tres.resnet_forward(back.params, x), atol=TOL, rtol=0)


def test_compress_launcher_resnet_small(tmp_path):
    """``--arch resnet-small`` (the reference launcher's 6 classes) writes a
    conv artifact that loads and serves through ``ConvLCC``."""
    from repro_torch.launch import compress

    stats = compress.main(["--device", "cpu", "--arch", "resnet-small",
                           "--out", str(tmp_path), "--quiet",
                           "--config", "conv_method=fk", "--conv-subsample", "2"])
    assert stats["units"] == 7
    art = CompressedModel.load(str(tmp_path / "artifact"), device="cpu")
    assert art.config == tres.resnet_small_config(classes=6)
    assert art.compression.conv_method == "fk"
    rec = art.records["block1.conv2"]
    assert list(rec["decompositions"]) == rec["channels_nonzero"][::2]
    ex = CompressedExecutor(art, device="cpu")
    x = torch.from_numpy(_images(seed=4))
    got = tres.resnet_forward(art.params, x, executor=ex)
    assert float((got - tres.resnet_forward(art.params, x)).abs().max()) <= TOL
    assert ex.routed == ex.sites == set(art.records)
