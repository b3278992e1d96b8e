"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: every
(arch x shape x mesh) cell — 80 records, zero FAIL: the reference's 14
long_500k SKIPs with its reasons, the cells whose meshed path the port
refuses (ROADMAP A7c) SKIPped with the port's own refusal, the rest PASS
with per-rank bytes, FLOPs, collectives and an H100 roofline; per-leaf specs
on both production meshes equal to the reference's ``params_pspecs`` (its
policy over a stub mesh exposing ``.shape``, as the reference's reads no
more); olmo-1b decode_32k's argument bytes on 16 x 16 reckoned by hand;
``--skip-existing`` and ``--variant ws_decode``; ``HW`` the H100's, no TPU
constant left.  The recorded collectives are held against measured ones in
the 2-rank spawns of ``tests/test_torch_distributed_step.py`` and
``tests/test_torch_sharded_serving.py``."""
import dataclasses
import json
import math
import os
from collections import OrderedDict
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPE_CELLS as JCELLS
from repro.configs import cell_supported as jcell_supported
from repro.distributed import sharding as jsh
from repro.models import api as japi
from repro.optim import optimizers as jo
from repro.training.trainer import TrainState as JTrainState

from repro_torch.configs import ARCHS, SHAPE_CELLS
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.collectives import Ledger
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.models import api as tapi
from repro_torch.models import flops as tflops
from repro_torch.optim import optimizers as to
from repro_torch.training.trainer import TrainState

from test_torch_distributed_policy import _same

# the reference dry run's module sets XLA_FLAGS to 512 host devices when it
# is imported; with the backend already up the flag changes nothing, and it
# is put back for whatever runs next in this process
jax.devices()
_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdry  # noqa: E402
if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

MESHES = ("16x16", "2x16x16")
CELLS = [(a, s, m) for a in ARCHS for s in SHAPE_CELLS for m in MESHES]
# the families whose meshed serving path the port refuses (ROADMAP A7c)
A7C = ("deepseek-v2-lite-16b", "qwen2-vl-7b", "rwkv6-1.6b", "zamba2-7b",
       "whisper-small")


def _stub(multi_pod: bool):
    """The reference's production mesh as its policy reads it: ``.shape``."""
    if multi_pod:
        return SimpleNamespace(shape=OrderedDict(pod=2, data=16, model=16))
    return SimpleNamespace(shape=OrderedDict(data=16, model=16))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "results.json"
    dryrun.main(["--arch", "all", "--shape", "all", "--mesh", "both",
                 "--out", str(out)])
    recs = json.loads(out.read_text())
    return {(r["arch"], r["shape"], r["mesh"]): r for r in recs}


def test_eighty_records_zero_fail(records, capsys):
    assert len(records) == 80
    status = [r["status"] for r in records.values()]
    assert status.count("FAIL") == 0
    assert status.count("SKIP") == 14 + 24 and status.count("PASS") == 42
    assert sum(r.get("refused_by") == "port" for r in records.values()) == 24


@pytest.mark.parametrize("arch,shape,mesh", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_record(records, arch, shape, mesh):
    rec = records[(arch, shape, mesh)]
    cfg, cell = ARCHS[arch], SHAPE_CELLS[shape]
    ok, why = jcell_supported(JARCHS[arch], JCELLS[shape])
    assert rec["variant"] == "baseline"
    if not ok:
        assert rec["status"] == "SKIP" and rec["reason"] == why
        assert "refused_by" not in rec
        return
    if arch in A7C and cell.kind != "train":
        assert rec["status"] == "SKIP" and rec["refused_by"] == "port"
        assert "is not served over a mesh" in rec["reason"]
        assert "ROADMAP A7c" in rec["reason"]
        return
    assert rec["status"] == "PASS", rec.get("error")
    n = 512 if mesh == "2x16x16" else 256
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    for k in ("temp_bytes", "alias_bytes"):
        assert mem[k] is None
    for k in ("lower_s", "compile_s", "scanned_cost", "cost_points"):
        assert rec[k] is None
    cost = rec["cost"]
    mf = tflops.model_flops(cfg, cell)
    af = tflops.attention_flops(cfg, cell)
    assert cost["flops"] == (mf + af) / n
    assert cost["bytes"] == mem["argument_bytes"] + mem["output_bytes"]
    counts = cost["coll_counts"]
    assert set(counts) == set(jdry._COLL)
    assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    assert cost["coll_link_bytes"] == cost["coll_by_kind"]["total"] > 0
    assert math.isclose(sum(cost["coll_by_axis"].values()),
                        cost["coll_link_bytes"], rel_tol=1e-12)
    roof = rec["roofline"]
    assert roof["compute_s"] == cost["flops"] / 989e12
    assert roof["memory_s"] == cost["bytes"] / 3.35e12
    # every production axis spans more than one 8-card node
    assert math.isclose(roof["collective_s"], cost["coll_link_bytes"] / 50e9,
                        rel_tol=1e-12)
    assert rec["dominant"] == max(roof, key=roof.get)
    assert rec["model_flops_global"] == mf
    assert rec["model_flops_per_dev"] == mf / n
    assert rec["useful_flop_ratio"] == (mf / n) / cost["flops"]
    assert 0 < rec["roofline_fraction"] <= 1


@pytest.mark.parametrize("arch", list(ARCHS))
def test_production_mesh_specs_equal_the_reference(arch):
    """Each leaf's spec on both production meshes: the parameters (with and
    without FSDP) and the whole AdamW ``TrainState`` the train cell places,
    against the reference's policy over the stub meshes."""
    tparams = tapi.abstract_params(ARCHS[arch])
    jparams = japi.abstract_params(JARCHS[arch])
    topt, jopt = to.adamw(), jo.adamw()
    ts = TrainState(params=tparams, opt_state=topt.init(tparams),
                    step=torch.zeros((), dtype=torch.int32, device="meta"),
                    error_fb=None)
    js = jax.eval_shape(lambda: JTrainState(
        params=japi.abstract_params(JARCHS[arch]),
        opt_state=jopt.init(japi.abstract_params(JARCHS[arch])),
        step=np.zeros((), np.int32), error_fb=None))
    for mp in (False, True):
        mesh, stub = make_production_mesh(multi_pod=mp), _stub(mp)
        assert mesh.shape == stub.shape
        for fsdp in (True, False):
            _same(tsh.params_pspecs(tparams, mesh, fsdp=fsdp),
                  jsh.params_pspecs(jparams, stub, fsdp=fsdp))
        _same(tsh.params_pspecs(ts, mesh), jsh.params_pspecs(js, stub))


def test_olmo_decode_argument_bytes_by_hand(records):
    """olmo-1b decode_32k on 16 x 16: each parameter's numel over the parts
    its reference spec splits it into, at 2 bytes; K and V ``[16, 128,
    32768, 16, 128]`` bf16 split 16 ways over the slots ("data") and 16 over
    head_dim ("model"); ``kpos`` ``[16, 128, 32768]`` int32 over the slots;
    the rank's 8 tokens and positions, int32."""
    stub = _stub(False)
    jparams = japi.abstract_params(JARCHS["olmo-1b"])
    specs = jsh.params_pspecs(jparams, stub)
    flat_p = jax.tree_util.tree_leaves(jparams)
    flat_s = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    params = 0
    for p, s in zip(flat_p, flat_s):
        parts = math.prod(16 for e in s if e is not None)
        params += math.prod(p.shape) // parts * 2
    kv = 2 * (16 * 128 * 32768 * 16 * 128 // (16 * 16)) * 2
    kpos = 16 * 128 * 32768 // 16 * 4
    tokens = 2 * (128 // 16) * 4
    rec = records[("olmo-1b", "decode_32k", "16x16")]
    assert rec["memory"]["argument_bytes"] == params + kv + kpos + tokens


def test_skip_existing_and_ws_decode(tmp_path, capsys):
    out = str(tmp_path / "r.json")
    argv = ["--arch", "olmo-1b", "--shape", "decode_32k", "--mesh", "single",
            "--out", out]
    dryrun.main(argv)
    first = json.loads(open(out).read())
    capsys.readouterr()
    dryrun.main(argv + ["--skip-existing"])
    printed = capsys.readouterr().out
    assert "[olmo-1b x decode_32k x 16x16]" not in printed
    assert "1 PASS / 0 SKIP / 0 FAIL" in printed
    assert json.loads(open(out).read()) == first
    # ws_decode: weight-stationary decode, the parameters without FSDP
    dryrun.main(argv + ["--variant", "ws_decode"])
    recs = {r["variant"]: r for r in json.loads(open(out).read())}
    assert sorted(recs) == ["baseline", "ws_decode"]
    base, ws = recs["baseline"], recs["ws_decode"]
    assert ws["status"] == "PASS"
    params = tapi.abstract_params(ARCHS["olmo-1b"])
    mesh = make_production_mesh()

    def pbytes(fsdp):
        return dryrun.tree_bytes(dryrun.place(
            params, tsh.params_pspecs(params, mesh, fsdp=fsdp), mesh))
    assert (ws["memory"]["argument_bytes"] - base["memory"]["argument_bytes"]
            == pbytes(False) - pbytes(True) > 0)
    # no FSDP storage: no weight is gathered over "data"
    assert ws["cost"]["coll_counts"]["all-gather"] < \
        base["cost"]["coll_counts"]["all-gather"]


@pytest.mark.parametrize("variant", ["causal_skip", "remat_off", "qchunk512",
                                     "ssmchunk64", "moe_manual", "ws_decode",
                                     "causal_skip+qchunk256"])
def test_apply_variant_is_the_reference(variant):
    for arch in ("olmo-1b", "zamba2-7b"):
        got = dataclasses.asdict(dryrun.apply_variant(ARCHS[arch], variant))
        want = dataclasses.asdict(jdry.apply_variant(JARCHS[arch], variant))
        assert got == want
    with pytest.raises(ValueError, match="unknown variant 'bogus'"):
        dryrun.apply_variant(ARCHS["olmo-1b"], "bogus")


def test_moe_manual_train_cell_carries_the_train_step_refusal():
    rec = dryrun.run_cell("mixtral-8x22b", "train_4k", False,
                          variant="moe_manual")
    assert rec["status"] == "SKIP" and rec["refused_by"] == "port"
    assert "moe_manual under the train step's mesh" in rec["reason"]
    assert "A7c" in rec["reason"]


def test_hw_is_the_h100_datasheet_and_no_tpu_constant():
    """The reference's ``HW`` holds a TPU v5e's numbers (197 TFLOP/s,
    819 GB/s, 16 GiB, its ICI link); the port's holds the H100's."""
    vals = {k: v for k, v in vars(HW).items() if k.isupper()}
    assert vals == {"PEAK_FLOPS_BF16": 989e12, "PEAK_FLOPS_F32": 67e12,
                    "HBM_BW": 3.35e12, "HBM_BYTES": 80 * 10**9,
                    "NVLINK_BW": 450e9, "NODE_CARDS": 8, "NET_BW": 50e9}
    from repro.launch.mesh import HW as JHW

    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "HBM_BYTES"):
        assert getattr(HW, name) != getattr(JHW, name)
    assert not hasattr(HW, "ICI_BW")


def test_ledger_ring_accounting():
    """The reference's ring model (``parse_collectives``): a gather moves
    (n-1)/n of its output, an all-reduce 2(n-1)/n of its tensor; a group of
    one rank moves nothing but still counts."""
    from repro_torch.distributed.collectives import all_gather_dim, all_reduce
    from repro_torch.distributed.device_mesh import AbstractMesh

    mesh = AbstractMesh((4, 1), ("data", "model"))
    x = torch.empty((3, 8), dtype=torch.bfloat16, device="meta")
    y = all_gather_dim(x, mesh.group("data"), 0)
    assert tuple(y.shape) == (12, 8) and y.device.type == "meta"
    all_reduce(x, mesh.group("data"))
    all_reduce(x, mesh.group("model"))
    led = mesh.reset()
    assert isinstance(led, Ledger)
    assert led.counts == {"all_gather": 1, "all_reduce": 2}
    assert led.link_bytes == {"all_gather": 3 / 4 * 12 * 8 * 2,
                              "all_reduce": 2 * 3 / 4 * 3 * 8 * 2}
    assert led.axis_bytes == {"data": 3 / 4 * 192 + 1.5 * 48, "model": 0.0}
    assert mesh.ledger.counts == {}
