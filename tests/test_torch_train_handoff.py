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
