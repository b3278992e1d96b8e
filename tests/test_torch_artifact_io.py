"""The artifact on disk, against the reference's format: the quickstart
olmo-1b (vocab 64, 2 layers, d 32) compressed by the reference, its
``plans["step"]`` filled by the packer (``kernels.ops.pack_layer``, bitwise
the reference's), and the MLP at 48-64-10.  The port's ``load`` of the
reference's save is bitwise ``convert.artifact_from_reference`` of the same
object; the reference's ``load`` of the port's save equals the original; the
port's shard file is byte for byte the reference's; the port's engine on the
loaded artifact gives the in-memory artifact's tokens and logits bit for bit
(plain route, CPU); corrupt shards fall back to an older step; ``effective
= None`` is refused; a conv record and a ``ResNetConfig`` save and load
(the ResNet's own round trips: ``test_torch_conv_artifact.py``); loaded
arrays are read-only views of the map."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.core.artifact import CompressedModel as JModel
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import mlp as jmlp

from repro_torch.checkpoint import checkpointer as tck
from repro_torch.convert import artifact_from_reference
from repro_torch.core.artifact import CompressedModel
from repro_torch.models import api as tapi
from repro_torch.models import mlp as tmlp
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executor import CompressedExecutor
from repro_torch.serving.scheduler import Scheduler

from test_torch_compress import assert_dense_equal, report_rows

QUICKSTART = dict(vocab=64, n_layers=2, d_model=32, d_ff=48, n_heads=2,
                  n_kv_heads=2, head_dim=16)
STAGE_FIELDS = ("prep_src", "prep_tgt", "gidx", "gexp", "gsgn", "outg",
                "fs_mat", "dw_mat", "bias", "segs")
SHARD = os.path.join("step_0000000000", "shard_0.msgpack")


def _olmo():
    jcfg = jreduced(jget_arch("olmo-1b"), **QUICKSTART)
    jart = japi.compress_model(japi.init_params(jax.random.PRNGKey(0), jcfg),
                               jcfg)
    # the step plan from the packer: the port's executor packs it (bitwise
    # the reference's pack_layer) and the stages cross back array for array
    tart = artifact_from_reference(jart, "cpu")
    CompressedExecutor(tart, device="cpu").step_plan(tart.config)
    jart.plans = {"step": {
        name: jops.PackedStage(**{f: getattr(ps, f) for f in STAGE_FIELDS},
                               k_alloc=ps.k_alloc, d_src=ps.d_src,
                               out_dim=ps.out_dim, n_layers=ps.n_layers,
                               site_names=ps.site_names)
        for name, ps in tart.plans["step"].items()}}
    return jart


def _mlp():
    jp = jmlp.init_mlp(jax.random.PRNGKey(0), in_dim=48, hidden=64, classes=10)
    return japi.compress_model(jp, jmlp.MLPConfig(48, 64, 10))


@pytest.fixture(scope="module", params=["olmo", "mlp"])
def saved(request, tmp_path_factory):
    """(reference artifact, its port conversion, the reference's directory,
    the port's directory) — each package's save of the same artifact."""
    jart = _olmo() if request.param == "olmo" else _mlp()
    tart = artifact_from_reference(jart, "cpu")
    root = tmp_path_factory.mktemp(request.param)
    jart.save(str(root / "ref"))
    tart.save(str(root / "port"))
    return jart, tart, root / "ref", root / "port"


def _leaves(t, pre=""):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, f"{pre}/{k}")
    else:
        yield pre, t


def _bits(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16).numpy() if a.dtype == torch.bfloat16
                else a.numpy())
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _same_array(a, b):
    a, b = _bits(a), _bits(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _assert_packed_equal(pa, pb):
    assert list(pa) == list(pb)
    for name, a in pa.items():
        b = pb[name]
        for f in ("idx", "exp", "sign"):
            assert _same_array(getattr(a, f), getattr(b, f)), (name, f)
        assert tuple(map(tuple, a.col_slices)) == tuple(map(tuple, b.col_slices))
        assert tuple(a.chain_lengths) == tuple(b.chain_lengths)
        assert (a.in_dim, a.out_dim, a.d_pad, a.first_width) == \
            (b.in_dim, b.out_dim, b.d_pad, b.first_width)
        assert len(a.dense) == len(b.dense)
        for (ca, wa), (cb, wb) in zip(a.dense, b.dense):
            assert tuple(ca) == tuple(cb) and _same_array(wa, wb)


def _assert_plans_equal(pa, pb):
    assert {k: list(v) for k, v in pa.items()} == {k: list(v) for k, v in pb.items()}
    for key, stages in pa.items():
        for name, a in stages.items():
            b = pb[key][name]
            assert (a.k_alloc, a.d_src, a.out_dim, a.n_layers) == \
                (b.k_alloc, b.d_src, b.out_dim, b.n_layers)
            assert tuple(a.site_names) == tuple(b.site_names)
            for f in STAGE_FIELDS:
                x, y = getattr(a, f), getattr(b, f)
                assert (x is None) == (y is None), (key, name, f)
                if x is not None:
                    assert _same_array(x, y), (key, name, f)


def _assert_artifacts_equal(a, b):
    """Records, packed buffers, plans, params, report, configs, per-unit
    plans and run statistics, bitwise (``a`` of either package)."""
    assert list(a.records) == list(b.records)
    for name, ra in a.records.items():
        assert_dense_equal(ra, b.records[name])
        assert ra.effective.dtype == b.records[name].effective.dtype
    _assert_packed_equal(a.packed, b.packed)
    _assert_plans_equal(a.plans, b.plans)
    la, lb = dict(_leaves(a.params)), dict(_leaves(b.params))
    assert sorted(la) == sorted(lb)
    for k, v in la.items():
        assert _same_array(v, lb[k]), k
    assert report_rows(a.report) == report_rows(b.report)
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    assert {n: dataclasses.asdict(c) for n, c in a.unit_configs.items()} == \
        {n: dataclasses.asdict(c) for n, c in b.unit_configs.items()}
    assert dataclasses.asdict(a.compression) == dataclasses.asdict(b.compression)
    assert json.loads(json.dumps(a.pipeline_stats)) == \
        json.loads(json.dumps(b.pipeline_stats))


def test_reference_save_loads_bitwise_in_the_port(saved):
    jart, tart, ref_dir, _ = saved
    back = CompressedModel.load(str(ref_dir), device="cpu")
    assert type(back.config) is type(tart.config)
    _assert_artifacts_equal(back, tart)
    assert all(t.device.type == "cpu" for _, t in _leaves(back.params))


def test_port_save_loads_in_the_reference(saved):
    jart, _, _, port_dir = saved
    back = JModel.load(str(port_dir))
    assert type(back.config) is type(jart.config)
    _assert_artifacts_equal(back, jart)


def test_shard_files_are_byte_identical(saved):
    _, _, ref_dir, port_dir = saved
    ref = (ref_dir / SHARD).read_bytes()
    assert (port_dir / SHARD).read_bytes() == ref
    assert (port_dir / "step_0000000000" / "DONE").exists()


def test_loaded_arrays_are_read_only_views_of_the_map(saved):
    _, _, _, port_dir = saved
    back = CompressedModel.load(str(port_dir), device="cpu")
    for rec in back.records.values():
        for a in (rec.effective, rec.kept_columns,
                  rec.decomposition.slices[0].factors[0].idx):
            assert not a.flags.writeable
            with pytest.raises(ValueError, match="read-only"):
                a[...] = 0
    for pk in back.packed.values():
        assert not pk.idx.flags.writeable
    for stages in back.plans.values():
        for ps in stages.values():
            assert ps.seg_stats is None and ps.waste is None
            assert not ps.gidx.flags.writeable
    # params are tensors of their own, not views of the map
    for _, t in _leaves(back.params):
        t.add_(0)


def _serve(art, prompts, use_plans):
    eng = ServingEngine(artifact=art, n_slots=2, max_len=24, kv_block=4,
                        device="cpu")
    if not use_plans:
        eng.executor = CompressedExecutor(art, use_plans=False, device="cpu")
    sched = Scheduler(eng)
    rids = [sched.enqueue(p, max_new=5) for p in prompts]
    sched.run()
    return eng, [sched.take_result(r).tokens for r in rids]


def _logits(art, use_plans):
    cfg = art.config
    ex = CompressedExecutor(art, use_plans=use_plans, device="cpu")
    st = tapi.init_decode_state(cfg, 2, 8, device="cpu")
    out = []
    with torch.no_grad():
        for t, tok in enumerate(([[3], [41]], [[7], [2]])):
            lg, st = tapi.decode(art.params, cfg, st, torch.tensor(tok),
                                 torch.tensor([t, t]), executor=ex)
            out.append(lg)
    return torch.stack(out), ex


@pytest.mark.parametrize("use_plans", [True, False], ids=["plan", "per_region"])
def test_loaded_artifact_serves_as_the_in_memory_one(saved, use_plans):
    jart, tart, _, port_dir = saved
    back = CompressedModel.load(str(port_dir), device="cpu")
    if isinstance(tart.config, tmlp.MLPConfig):
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (7, 48)).astype(np.float32))
        want = tmlp.mlp_forward_compressed(tart.params, tart.packed["fc1"], x)
        got = tmlp.mlp_forward_compressed(back.params, back.packed["fc1"], x)
        assert torch.equal(got, want)
        return
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, 6).tolist() for _ in range(3)]
    eng_m, want = _serve(tart, prompts, use_plans)
    eng_l, got = _serve(back, prompts, use_plans)
    assert got == want
    assert eng_l.kernel_launches_per_step == eng_m.kernel_launches_per_step
    lm, _ = _logits(tart, use_plans)
    ll, ex = _logits(back, use_plans)
    assert torch.equal(ll, lm)
    if use_plans:  # the stages came from disk: nothing was packed
        plan = ex.step_plan(back.config)
        assert plan.pack_s == 0.0 and plan.stages is back.plans["step"]


def test_a_corrupt_shard_falls_back_to_an_older_step(tmp_path, capsys):
    jart = _mlp()
    tart = artifact_from_reference(jart, "cpu")
    tart.save(str(tmp_path), step=1)
    newer = dataclasses.replace(tart, pipeline_stats={"marker": 2})
    newer.save(str(tmp_path), step=2)
    shard = tmp_path / "step_0000000002" / "shard_0.msgpack"
    size = shard.stat().st_size
    with open(shard, "r+b") as f:  # flip bytes inside the last leaf's data
        f.seek(size - 64)
        f.write(b"\xde\xad\xbe\xef")
    back = CompressedModel.load(str(tmp_path), device="cpu")
    assert "step 2 unreadable" in capsys.readouterr().out
    assert back.pipeline_stats == json.loads(json.dumps(tart.pipeline_stats))
    with pytest.raises(IOError, match="crc"):
        tck.Checkpointer(str(tmp_path)).restore_flat(2)
    shard.unlink()
    (tmp_path / "step_0000000001" / "DONE").unlink()
    with pytest.raises(FileNotFoundError):
        CompressedModel.load(str(tmp_path), device="cpu")


def test_refusals(tmp_path):
    tart = artifact_from_reference(_mlp(), "cpu")
    rec = tart.records["fc1"]
    no_eff = dataclasses.replace(
        tart, records={**tart.records,
                       "fc1": dataclasses.replace(rec, effective=None)})
    with pytest.raises(ValueError, match="effective"):
        no_eff.save(str(tmp_path / "a"))
    assert not (tmp_path / "a" / SHARD).exists()


def test_a_conv_record_and_a_resnet_config_save_and_load(tmp_path):
    """Formerly refused (conv units came with ROADMAP A6): a conv record
    beside the MLP's dense records saves byte for byte as the reference's
    and loads back in both packages; the manifest's ``ResNetConfig`` comes
    back as the port's config."""
    from repro.models.resnet import resnet34_config
    from repro_torch.core import artifact as tart_mod
    from repro_torch.models.resnet import ResNetConfig

    jart = _mlp()
    conv = {"decompositions": {}, "channels_nonzero": [], "baseline_adds": 0,
            "lcc_adds": 0, "scale": 1.0}
    jart.records["c0"] = dict(conv)
    tart = artifact_from_reference(jart, "cpu")
    assert tart.records["c0"] == conv
    tart.save(str(tmp_path / "port"))
    jart.save(str(tmp_path / "ref"))
    assert (tmp_path / "port" / SHARD).read_bytes() == \
        (tmp_path / "ref" / SHARD).read_bytes()
    assert CompressedModel.load(str(tmp_path / "port"),
                                device="cpu").records["c0"] == conv
    assert JModel.load(str(tmp_path / "port")).records["c0"] == conv
    cfg = tart_mod._config_from_manifest(
        "ResNetConfig", json.loads(json.dumps(
            dataclasses.asdict(resnet34_config()))))
    assert cfg == ResNetConfig() and isinstance(cfg.stages, tuple)
    assert tart_mod._config_to_manifest(cfg) == (
        "ResNetConfig", dataclasses.asdict(resnet34_config()))


def test_seeded_report_none_saves_as_the_empty_report(tmp_path):
    tart = dataclasses.replace(artifact_from_reference(_mlp(), "cpu"),
                               report=None)
    tart.save(str(tmp_path))
    back = CompressedModel.load(str(tmp_path), device="cpu")
    assert back.report.layers == []
    assert torch.equal(back.params["fc1"]["w"], tart.params["fc1"]["w"])
    assert JModel.load(str(tmp_path)).report.layers == []
