"""The port's examples (``examples/torch/``) on the CPU, each run in
process through its ``main(argv)`` at a small size: the quickstart's adds,
SNR and kernel lines equal to the reference's ``examples/quickstart.py``
run in the same test; the transformer example (train -> compress -> save ->
load -> serve on the whole-step plan, every site routed) and the paper's
MLP loop (ProxSGD -> compress -> recover -> from disk) end to end.  No
wall time is compared (tier-1 runs on a loaded host)."""
import contextlib
import importlib.util
import io
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"_example_{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(path: Path, argv=None):
    mod = _load(path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = mod.main() if argv is None else mod.main(argv)
    return res, out.getvalue()


def test_quickstart_prints_the_reference_lines(monkeypatch):
    import sys

    monkeypatch.setattr(sys, "argv", ["quickstart.py"])
    _, want = _run(ROOT / "examples" / "quickstart.py")
    res, got = _run(ROOT / "examples" / "torch" / "quickstart.py",
                             ["--device", "cpu"])
    assert got.splitlines() == want.splitlines()
    lines = got.splitlines()
    assert lines[0] == "CSD shift-add baseline:        15501 additions"
    assert lines[1] == "LCC-FP: 7200 additions (ratio 2.15x, SNR 61.0 dB)"
    assert lines[2] == "LCC-FS: 6850 additions (ratio 2.26x, SNR 61.3 dB)"
    assert "relative error 9.09e-04" in lines[3]
    packed, x = res["packed"], res["x"]
    assert (packed.out_dim, packed.in_dim, tuple(x.shape)) == (300, 16, (16, 8))


def test_transformer_example_end_to_end():
    res, out = _run(
        ROOT / "examples" / "torch" / "transformer_compress_serve.py",
        ["--device", "cpu", "--steps", "4"])
    eng, art = res["engine"], res["artifact"]
    assert eng.executor.routed == eng.executor.sites
    assert eng.n_layer_plans == 1 and not eng.plan_stats()["fallbacks"]
    assert len(art.records) == 14
    assert all(p.col_slices for p in art.packed.values())
    assert "reloaded 14 compressed units (14 with fused FP kernel buffers)" in out
    assert res["agreement"] > 0.9 and res["adds_ratio"] > 1
    assert "greedy-token agreement original vs compressed" in out


def test_mlp_example_end_to_end():
    res, out = _run(
        ROOT / "examples" / "torch" / "mlp_mnist_compress.py",
        ["--device", "cpu", "--epochs", "1", "--recover", "4", "--workers", "1"])
    acc = res["accuracy"]
    assert acc["dense"] > 0.9 and acc["compressed"] > 0.9
    assert acc["from_disk"] == acc["recovered"]
    assert res["adds_ratio"] > 1
    for step in ("== 1.", "== 2.", "== 3.", "== 4.", "== result:"):
        assert step in out


@pytest.mark.parametrize("name", ["quickstart", "mlp_mnist_compress",
                                  "resnet_compress",
                                  "transformer_compress_serve"])
def test_examples_mirror_the_reference_and_default_to_the_gpu(name):
    """Each reference example has its port, with ``main(argv=None)`` and a
    ``--device`` flag whose default is the GPU."""
    import inspect

    assert (ROOT / "examples" / f"{name}.py").exists()
    mod = _load(ROOT / "examples" / "torch" / f"{name}.py")
    assert list(inspect.signature(mod.main).parameters) == ["argv"]
    src = (ROOT / "examples" / "torch" / f"{name}.py").read_text()
    assert 'ap.add_argument("--device", default="cuda")' in src
    assert 'if __name__ == "__main__":' in src
