"""The port's sharding policy and host-side distributed arithmetic against
``repro.distributed`` in-process: ``params_pspecs`` on all ten archs'
abstract params (the port's from the meta device) over 16 x 16 and
2 x 16 x 16 meshes and smaller ones, on the reduced olmo's whole
``TrainState`` (adamw and ProxSGD, with and without residuals: the
reference launcher places the whole state, path quirks included);
``batch_pspecs`` on token, label, embedding and ``positions3`` batches;
``decode_state_pspecs`` on each family's decode state, contiguous and
paged; ``plan_batch_spec``; ``plan_for_devices``; ``HeartbeatMonitor`` over
seeded beats; ``constrain``'s resolved spec against the reference's own
``constrain`` (its sharding call captured); ``quantize_int8`` bitwise.
Meshes are shapes only: both packages read nothing of a mesh but
``.shape``, so no process is started."""
from collections import OrderedDict
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.distributed import act_shard as jact
from repro.distributed import compress_grads as jcg
from repro.distributed import elastic as jel
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.optim import optimizers as jo
from repro.training import regularize as jreg
from repro.training import trainer as jtr

from repro_torch.configs import get_arch, reduced_config
from repro_torch.configs.registry import ARCHS
from repro_torch.distributed import act_shard as tact
from repro_torch.distributed import compress_grads as tcg
from repro_torch.distributed import elastic as tel
from repro_torch.distributed import sharding as tsh
from repro_torch.models import api as tapi
from repro_torch.optim import optimizers as to
from repro_torch.training import regularize as treg
from repro_torch.training import trainer as ttr


def _mesh(**axes):
    return SimpleNamespace(shape=OrderedDict(axes))


BIG = {"16x16": _mesh(data=16, model=16),
       "2x16x16": _mesh(pod=2, data=16, model=16)}
SMALL = {"2x2": _mesh(data=2, model=2), "4x2": _mesh(data=4, model=2),
         "2x2x2": _mesh(pod=2, data=2, model=2), "3x5": _mesh(data=3, model=5),
         "8": _mesh(data=8), "1x1": _mesh(data=1, model=1)}
MESHES = {**BIG, **SMALL}


def _flat_port(tree, path=()):
    """{name: spec tuple} of a port spec tree (dicts, lists, dataclasses)."""
    import dataclasses

    if tree is None:
        return {}
    if isinstance(tree, tsh.P):
        return {"/".join(path): tuple(tree)}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat_port(sub, path + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat_port(sub, path + (str(i),)).items()}
    assert dataclasses.is_dataclass(tree)
    return {k: v for f in dataclasses.fields(tree)
            if not f.metadata.get("static")
            for k, v in _flat_port(getattr(tree, f.name),
                                   path + (f".{f.name}",)).items()}


def _flat_ref(tree):
    """{name: spec tuple} of a reference spec tree, named as its policy
    names leaves."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            tuple(spec) for path, spec in flat}


def _same(port, ref):
    a, b = _flat_port(port), _flat_ref(ref)
    assert list(a) == list(b) or sorted(a) == sorted(b)
    bad = {k: (a[k], b[k]) for k in b if a[k] != b[k]}
    assert not bad, bad
    return a


@pytest.mark.parametrize("arch", list(ARCHS))
def test_params_pspecs_equal_the_reference_on_every_arch(arch):
    tparams = tapi.abstract_params(get_arch(arch))
    jparams = japi.abstract_params(jget_arch(arch))
    assert all(t.device.type == "meta" for t in to.tree_leaves(tparams))
    sharded = 0
    for mesh in MESHES.values():
        got = _same(tsh.params_pspecs(tparams, mesh),
                    jsh.params_pspecs(jparams, mesh))
        sharded += sum(any(e is not None for e in s) for s in got.values())
        for fsdp in (False,):
            _same(tsh.params_pspecs(tparams, mesh, fsdp=fsdp),
                  jsh.params_pspecs(jparams, mesh, fsdp=fsdp))
    assert sharded > 0


def _states(opt_name, grad_compression):
    jcfg = jreduced(jget_arch("olmo-1b"), vocab=256)
    tcfg = reduced_config(get_arch("olmo-1b"), vocab=256)
    if opt_name == "prox":
        jspecs = jreg.site_group_specs(japi.abstract_params(jcfg), jcfg, 0.1)
        tspecs = treg.site_group_specs(tapi.abstract_params(tcfg), tcfg, 0.1)
        jopt, topt = (jo.prox_sgd(0.9, specs=jspecs),
                      to.prox_sgd(0.9, specs=tspecs))
    else:
        jspecs = tspecs = None
        jopt, topt = jo.adamw(weight_decay=0.01), to.adamw(weight_decay=0.01)
    js = jtr.abstract_train_state(jcfg, jopt, grad_compression,
                                  prox_specs=jspecs)
    ts = ttr.init_train_state(0, tcfg, topt, grad_compression=grad_compression,
                              prox_specs=tspecs, device="cpu")
    return js, ts


@pytest.mark.parametrize("grad_compression", [False, True], ids=["plain", "efb"])
@pytest.mark.parametrize("opt_name", ["adamw", "prox"])
def test_whole_train_state_specs_equal_the_reference(opt_name,
                                                     grad_compression):
    """The reference launcher calls ``params_pspecs`` on the whole state:
    ``.opt_state/...`` and ``.error_fb/...`` paths, the "blocks" rule
    skipping the residuals' pod axis, the expert rule matching "up" inside
    other names."""
    js, ts = _states(opt_name, grad_compression)
    for mesh in MESHES.values():
        got = _same(tsh.params_pspecs(ts, mesh), jsh.params_pspecs(js, mesh))
        assert ".step" in got and got[".step"] == ()
        assert any(k.startswith(".opt_state/") for k in got)
        assert any(k.startswith(".error_fb/") for k in got) == grad_compression
        if grad_compression:  # the pod axis of a stacked residual: never split
            assert all(v[0] is None for k, v in got.items()
                       if k.startswith(".error_fb/blocks/") and v)


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for b, s in ((1, 64), (2, 32), (3, 16), (4, 24), (8, 512), (16, 8),
                 (32, 4), (64, 2)):
        out.append({"tokens": rng.integers(0, 9, (b, s), dtype=np.int32),
                    "labels": rng.integers(0, 9, (b, s), dtype=np.int32)})
        out.append({"embeds": np.zeros((b, s, 6), np.float32),
                    "positions3": np.zeros((3, b, s), np.int32),
                    "labels": np.zeros((b, s), np.int32)})
    return out


def test_batch_pspecs_equal_the_reference():
    for mesh in MESHES.values():
        for batch in _batches():
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            _same(tsh.batch_pspecs(tb, mesh), jsh.batch_pspecs(batch, mesh))


DECODE_ARCHS = ["olmo-1b", "mixtral-8x22b", "deepseek-v2-lite-16b",
                "qwen2-vl-7b", "rwkv6-1.6b", "zamba2-7b", "whisper-small"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_state_pspecs_equal_the_reference(arch):
    """Each family's decode state, contiguous and (where the family pages)
    paged, at slot counts that divide the meshes and that do not."""
    jcfg = jreduced(jget_arch(arch), vocab=256)
    tcfg = reduced_config(get_arch(arch), vocab=256)
    for b in (1, 4, 6, 32):
        for kv in ((None, None), (8, None), (8, 12)):
            if kv[0] is not None and not tapi.paged_supported(tcfg):
                continue
            js = jax.eval_shape(lambda: japi.init_decode_state(
                jcfg, b, 32, kv_block=kv[0], kv_blocks=kv[1]))
            ts = tapi.init_decode_state(tcfg, b, 32, kv_block=kv[0],
                                        kv_blocks=kv[1], device="cpu")
            for mesh in MESHES.values():
                got = _same(tsh.decode_state_pspecs(ts, mesh),
                            jsh.decode_state_pspecs(js, mesh))
                if kv[0] is not None:
                    assert got["block_tbl"] == ()


def test_plan_batch_spec_equals_the_reference():
    for mesh in MESHES.values():
        for b in range(1, 65):
            want = jsh.plan_batch_spec(mesh, b)
            assert tsh.plan_batch_spec(mesh, b) == want, (dict(mesh.shape), b)
    assert tsh.plan_batch_spec(_mesh(model=4), 8) is None


def test_plan_for_devices_equals_the_reference():
    for n in range(1, 1025):
        for kw in ({}, {"model_parallel": 2}, {"model_parallel": 8},
                   {"multi_pod_threshold": 64}, {"multi_pod_threshold": 1 << 30,
                                                 "model_parallel": 2}):
            a, b = tel.plan_for_devices(n, **kw), jel.plan_for_devices(n, **kw)
            assert (a.shape, a.axes) == (b.shape, b.axes), (n, kw)


def test_mesh_plan_refuses_too_few_ranks_with_the_reference_message():
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        tel.MeshPlan((2, 2), ("data", "model")).build(ranks=[0, 1])


@pytest.mark.parametrize("seed", range(4))
def test_heartbeat_monitor_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    kw = dict(timeout_s=float(rng.uniform(5, 50)),
              straggler_factor=float(rng.uniform(1.5, 4)))
    a, b = tel.HeartbeatMonitor(n, **kw), jel.HeartbeatMonitor(n, **kw)
    pace = rng.uniform(0.5, 3.0, n)
    t = np.zeros(n)
    for _ in range(40):
        p = int(rng.integers(0, n))
        t[p] += pace[p] * rng.uniform(0.8, 1.2)
        a.beat(p, float(t[p]))
        b.beat(p, float(t[p]))
        now = float(t.max() + rng.uniform(0, 60))
        assert a.failed_pods(now) == b.failed_pods(now)
        failed = a.failed_pods(now)
        assert (a.surviving_device_count(8 * n, failed)
                == b.surviving_device_count(8 * n, failed))


def test_constrain_resolves_the_reference_spec(monkeypatch):
    """The reference's ``constrain`` with its sharding call captured (it
    returns the spec it would pin) against the port's ``resolve``, with and
    without a manual pod axis; the port's ``constrain`` returns ``x``."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: tuple(s.spec))
    monkeypatch.setattr(jact, "NamedSharding", lambda mesh, spec: SimpleNamespace(spec=spec))
    axes_sets = [("batch", None, "model"), ("batch",), ("data", "model"),
                 (None, "batch", "data"), ("model", "model"), ()]
    shapes = [(8, 4, 6), (6,), (3, 16), (2, 8, 4), (16, 5), (1, 1, 1)]
    x = torch.zeros(2, 3)
    for mesh in MESHES.values():
        if "data" not in mesh.shape:
            continue
        jact.set_mesh(mesh)
        try:
            for manual in (set(), {"pod"}):
                monkeypatch.setattr(jact.compat, "manual_axis_names",
                                    lambda m=manual: set(m))
                for shape in shapes:
                    for axes in axes_sets:
                        want = jact.constrain(jnp.zeros(shape), *axes)
                        with tact.manual_axes(*manual):
                            got = tact.resolve(shape, axes, mesh)
                        assert tuple(got) == want, (dict(mesh.shape), shape, axes)
                        assert tact.resolve(shape, axes, mesh,
                                            manual=manual) == got
        finally:
            jact.set_mesh(None)
    with tact.mesh_context(BIG["16x16"]) as m:
        assert tact.get_mesh() is m and tact.constrain(x, "batch") is x
    assert tact.get_mesh() is None


def test_quantize_int8_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    for shape in ((7,), (5, 33), (2, 3, 64)):
        x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 3)).astype(np.float32)
        x.reshape(-1)[:3] = [0.0, 1e-20, -0.5]
        jq, js = jcg.quantize_int8(jnp.asarray(x))
        tq, ts = tcg.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert ts.numpy().tobytes() == np.asarray(js).tobytes()
        assert (tcg.dequantize_int8(tq, ts).numpy().tobytes()
                == np.asarray(jcg.dequantize_int8(jq, js)).tobytes())
    z = tcg.init_error_state({"a": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert z["a"].dtype == torch.float32 and not z["a"].any()


def test_spec_type_and_named():
    assert tsh.P(("data",), None) == ("data", None)
    assert tuple(tsh.P(("pod", "data"))) == (("pod", "data"),)
    assert tuple(jsh.P(("data",), None)) == tuple(tsh.P(("data",), None))
    mesh = BIG["16x16"]
    tree = {"a": tsh.P("data"), "b": [tsh.P(), tsh.P(None, "model")]}
    got = tsh.named(mesh, tree)
    assert got["b"][1] == tsh.NamedSharding(mesh, tsh.P(None, "model"))
