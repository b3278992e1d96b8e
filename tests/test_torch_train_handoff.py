"""The train launcher's MLP handoff (``--arch mlp --compress-out D
--recover N``): training -> compression -> recovery -> fused serve, the
reference launcher's files and ``train_stats.json`` keys, and the saved
artifact serving fc1 through its packed chains with the residual."""
import json
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.artifact import CompressedModel
from repro_torch.kernels import ops

ARGS = ["--arch", "mlp", "--prox", "--epochs", "1", "--hidden", "32",
        "--train-n", "256", "--test-n", "64", "--recover", "3"]
HANDOFF = ["--compress-config", "algorithm=fp", "prune_tol=-1e-6",
           "weight_sharing=false"]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    from repro_torch.launch import train

    out = tmp_path_factory.mktemp("port_handoff")
    stats = train.main(["--device", "cpu", *ARGS, *HANDOFF,
                        "--compress-out", str(out)])
    return out, stats


def _keys(tree, depth=2):
    """The nested key structure of a stats dict, ``depth`` levels deep."""
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_handoff_writes_the_reference_files_and_keys(port_run, tmp_path,
                                                     monkeypatch):
    from repro.launch import train as jtrain

    out, stats = port_run
    assert sorted(p.name for p in out.iterdir()) == \
        ["artifact", "cache", "run", "train_stats.json"]
    assert any((out / "cache").iterdir()) and any((out / "run").iterdir())
    on_disk = json.loads((out / "train_stats.json").read_text())
    assert on_disk == json.loads(json.dumps(stats))
    ref_out = tmp_path / "ref"
    monkeypatch.setattr(sys, "argv", ["train", *ARGS, *HANDOFF,
                                      "--compress-out", str(ref_out)])
    jtrain.main()
    ref = json.loads((ref_out / "train_stats.json").read_text())
    assert _keys(on_disk) == _keys(ref)
    assert sorted(p.name for p in ref_out.iterdir()) == \
        sorted(p.name for p in out.iterdir())
    assert set(on_disk["accuracy"]) == {"dense", "compressed", "recovered",
                                        "fused"}
    assert on_disk["recover"]["steps"] == 3
    assert on_disk["adds"]["total_with_recover"] == \
        on_disk["adds"]["lcc"] + on_disk["adds"]["recover_residual"]
    # the same pipeline on the same kind of run: the plan agrees
    for k in ("units", "jobs"):
        assert on_disk["pipeline"][k] == ref["pipeline"][k]


def test_saved_artifact_serves_fc1_with_the_residual(port_run):
    out, stats = port_run
    art = CompressedModel.load(str(out / "artifact"), device="cpu")
    assert art.config.hidden == 32
    pk = art.packed["fc1"]
    assert pk.in_dim == 784  # kept in place: the fused forward takes all inputs
    if stats["recover"]["units"].get("fc1", {}).get("nnz", 0):
        assert any(cs == (0, pk.in_dim) for cs, _ in pk.dense)  # the residual
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (784, 5)).astype(np.float32))
    got = ops.apply_packed_decomposition(pk, x)
    want = art.params["fc1"]["w"] @ x
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    assert any("recover" in l.stage_adds for l in art.report.layers)


def test_handoff_without_recovery_skips_its_keys(tmp_path):
    from repro_torch.launch import train

    stats = train.main(["--device", "cpu", "--arch", "mlp", "--epochs", "1",
                        "--hidden", "16", "--train-n", "128", "--test-n", "32",
                        *HANDOFF, "--compress-out", str(tmp_path)])
    assert "recover" not in stats and "recovered" not in stats["accuracy"]
    assert "dead_group_fraction" not in stats  # no --prox
    assert (tmp_path / "artifact").is_dir()


def _same_params(hidden=32, seed=11):
    """MLP weights with prox-dead fc1 inputs (whole zero columns, as the
    prox leaves them), so the compress half skips and shrinks slice jobs."""
    from repro_torch.models.mlp import init_mlp_numpy

    p = init_mlp_numpy(seed, hidden=hidden)
    dead = np.random.default_rng(seed).choice(784, 500, replace=False)
    p["fc1"]["w"][:, dead] = 0.0
    p["fc1"]["w"][:, :28] = 0.0  # the stroke images' blank top row
    return p


@pytest.mark.parametrize("extra", [[], ["--budget", "2500"]],
                         ids=["handoff", "budget"])
def test_compress_half_matches_the_reference_on_the_same_params(
        tmp_path, monkeypatch, extra):
    """Both launchers' compress half (``--epochs 0``: the params go to the
    compressor untrained) on the same converted params: the same adds,
    units, jobs and skipped/shrunk jobs in ``train_stats.json``, and the
    saved records bitwise."""
    import jax.numpy as jnp
    import repro.models.mlp as jmlp_mod
    from repro.core.artifact import CompressedModel as JModel
    from repro.launch import train as jtrain

    import repro_torch.models.mlp as tmlp_mod
    from repro_torch.launch import train

    from test_torch_compress import assert_dense_equal, report_rows

    p = _same_params()
    monkeypatch.setattr(
        tmlp_mod, "init_mlp", lambda seed, hidden, device, **kw: {
            k: {n: torch.from_numpy(a.copy()).to(device) for n, a in l.items()}
            for k, l in p.items()})
    monkeypatch.setattr(jmlp_mod, "init_mlp", lambda key, hidden, **kw: {
        k: {n: jnp.asarray(a) for n, a in l.items()} for k, l in p.items()})
    argv = ["--arch", "mlp", "--epochs", "0", "--hidden", "32",
            "--train-n", "128", "--test-n", "64", *HANDOFF, *extra]
    stats = train.main(["--device", "cpu", *argv, "--compress-out",
                        str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--compress-out",
                                      str(tmp_path / "ref")])
    jtrain.main()
    ref = json.loads((tmp_path / "ref" / "train_stats.json").read_text())
    assert stats["adds"] == ref["adds"]
    assert stats["pipeline"] == ref["pipeline"]
    assert stats["pipeline"]["skipped_jobs"] > 0
    assert stats["accuracy"]["compressed"] == pytest.approx(
        ref["accuracy"]["compressed"], abs=1 / 64 + 1e-9)
    port = CompressedModel.load(str(tmp_path / "port" / "artifact"),
                                device="cpu")
    back = JModel.load(str(tmp_path / "ref" / "artifact"))
    assert list(port.records) == list(back.records) == ["fc1", "fc2"]
    for name, rec in port.records.items():
        assert_dense_equal(rec, back.records[name])
    assert report_rows(port.report) == report_rows(back.report)
