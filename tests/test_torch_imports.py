"""The port stands alone: importing ``repro_torch`` and every sub-module of it
pulls in neither ``jax`` nor the JAX package ``repro``; ``chip_smoke.py``
imports neither; entry points default to the GPU."""
import ast
import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("MODULES", len(names))
print("PLAN", "repro_torch.kernels.layer_plan" in names)
print("SLICE5", all(n in names for n in (
    "repro_torch.kernels.lcc_matmul",
    "repro_torch.configs.deepseek_v2_lite_16b")))
print("TRAIN", all(n in names for n in (
    "repro_torch.kernels.group_prox", "repro_torch.optim.optimizers",
    "repro_torch.training.trainer", "repro_torch.training.regularize",
    "repro_torch.models.compress_adapters", "repro_torch.models.mlp",
    "repro_torch.data.mnist_like", "repro_torch.launch.train")))
print("COMPRESSOR", all(n in names for n in (
    "repro_torch.core.csd", "repro_torch.core.lcc", "repro_torch.core.cost",
    "repro_torch.core.weight_sharing", "repro_torch.core.conv_reshape",
    "repro_torch.core.compress", "repro_torch.pipeline.events",
    "repro_torch.pipeline.cache", "repro_torch.pipeline.jobs",
    "repro_torch.pipeline.allocator", "repro_torch.pipeline.runner",
    "repro_torch.models.compress_adapters", "repro_torch.models.api",
    "repro_torch.models.flops", "repro_torch.models.mlp")))
print("ARTIFACT", all(n in names for n in (
    "repro_torch.checkpoint.msgpack_codec",
    "repro_torch.checkpoint.checkpointer", "repro_torch.core.artifact",
    "repro_torch.pipeline.cache", "repro_torch.launch.compress")))
print("RECOVER", all(n in names for n in (
    "repro_torch.training.recover", "repro_torch.models.compress_adapters",
    "repro_torch.launch.train", "repro_torch.models.attention",
    "repro_torch.serving.engine", "repro_torch.launch.serve")))
print("RESNET", all(n in names for n in (
    "repro_torch.models.resnet", "repro_torch.serving.executor",
    "repro_torch.data.synthetic", "repro_torch.launch.compress")))
print("MSGPACK", sorted(m for m in sys.modules if m.split(".")[0] == "msgpack"))
print("BAD", bad)
"""


def _forbidden(module: str | None) -> bool:
    top = (module or "").split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax", "msgpack")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT),
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert int(lines["MODULES"]) >= 36
    assert lines["PLAN"] == "True"  # the layer-plan kernels (K6, K7) too
    assert lines["TRAIN"] == "True"  # the training path and K5
    assert lines["SLICE5"] == "True"  # K4 and deepseek-v2-lite
    assert lines["COMPRESSOR"] == "True"  # Algorithm 1 and its pipeline
    assert lines["ARTIFACT"] == "True"  # the artifact on disk, its codec
    assert lines["RECOVER"] == "True"  # recovery, the prefix cache's modules
    assert lines["RESNET"] == "True"  # the ResNet and its conv serving
    assert lines["MSGPACK"] == "[]"  # the codec is the port's own
    assert lines["BAD"] == "[]"


_JOBS_PROBE = r"""
import sys
import repro_torch.pipeline.jobs
import torch
print("CUDA_INIT", torch.cuda.is_initialized())
print("MODS", sorted(m for m in sys.modules if m.startswith("repro_torch.")))
"""


def test_worker_job_module_touches_no_cuda():
    """The forkserver preloads ``repro_torch.pipeline.jobs`` (and its
    imports); none of it may initialise CUDA or load the kernel library."""
    out = subprocess.run([sys.executable, "-c", _JOBS_PROBE], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT),
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    assert lines["CUDA_INIT"] == "False"
    mods = lines["MODS"]
    assert "repro_torch.core.compress" in mods
    for heavy in ("repro_torch.kernels", "repro_torch.serving",
                  "repro_torch.models"):
        assert f"'{heavy}" not in mods, heavy
    from repro_torch.pipeline import runner
    assert "repro_torch.pipeline.jobs" in runner._make_executor.__code__.co_consts


def test_no_source_file_of_the_port_names_jax_or_repro():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) >= 36
    assert SRC / "repro_torch" / "kernels" / "layer_plan.py" in files
    assert SRC / "repro_torch" / "training" / "trainer.py" in files
    assert SRC / "repro_torch" / "kernels" / "lcc_matmul.py" in files
    for mod in ("core/csd.py", "core/cost.py", "core/conv_reshape.py",
                "pipeline/jobs.py", "pipeline/runner.py", "models/flops.py",
                "training/recover.py", "models/resnet.py"):
        assert SRC / "repro_torch" / mod in files
    for f in files:
        bad = [m for m in _imports(f) if _forbidden(m)]
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("name", ["quickstart", "mlp_mnist_compress",
                                  "resnet_compress",
                                  "transformer_compress_serve"])
def test_no_example_of_the_port_names_jax_or_repro(name):
    path = ROOT / "examples" / "torch" / f"{name}.py"
    mods = list(_imports(path))
    assert any(m.startswith("repro_torch") for m in mods)
    assert not [m for m in mods if _forbidden(m)], mods


def test_chip_smoke_imports_neither():
    path = ROOT / "chip_smoke.py"
    mods = list(_imports(path))
    assert "torch" in mods and any(m.startswith("repro_torch") for m in mods)
    assert not [m for m in mods if _forbidden(m)]
    assert "torch.cuda.is_available()" in path.read_text()


def test_every_kernel_has_a_cuda_source_with_its_note():
    csrc = SRC / "repro_torch" / "kernels" / "csrc"
    for name, replaced in (("lcc_chain_matmul.cu", "lcc_chain_matmul.py"),
                           ("lcc_group_matmul.cu", "lcc_group_matmul.py"),
                           ("cluster_segment_sum.cu", "shared_matmul.py"),
                           ("lcc_factor_matmul.cu", "lcc_matmul.py"),
                           ("stage_matmul.cu", "layer_plan.py"),
                           ("step_plan.cu", "layer_plan.py"),
                           ("moe_route.cu", "layer_plan.py"),
                           ("group_prox.cu", "group_prox.py")):
        text = (csrc / name).read_text()
        assert "Replaces" in text and replaced in text and "ound by" in text
        assert 'extern "C"' in text and "cudaGetLastError" in (
            text + (csrc / "lcc_chain.cuh").read_text())
        assert "atomicAdd" not in text  # fixed-order sums only
    from repro_torch.kernels import build
    assert [p.name for p in build.sources()] == [
        "cluster_segment_sum.cu", "group_prox.cu", "lcc_chain_matmul.cu",
        "lcc_factor_matmul.cu", "lcc_group_matmul.cu", "moe_route.cu",
        "stage_matmul.cu", "step_plan.cu"]
    for entry in ("repro_stage_matmul", "repro_step_norm",
                  "repro_split_attention", "repro_moe_route",
                  "repro_group_prox", "repro_lcc_factor_matmul"):
        assert entry in build._SIGNATURES
    # SwiGLU and the MoE combine are output modes of the stage's epilogue,
    # the MoE dispatch its gathered input
    for gone in ("repro_step_swiglu", "repro_moe_combine",
                 "repro_moe_dispatch"):
        assert gone not in build._SIGNATURES
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "-use_fast_math" not in build.NVCC_FLAGS
    assert build.build_dir().parts[-2:] == ("build", "repro_torch")


@pytest.mark.parametrize("path", [
    "repro_torch.models.api:init_params",
    "repro_torch.models.api:init_decode_state",
    "repro_torch.models.transformer:init_decode_state",
    "repro_torch.models.attention:init_kv_cache",
    "repro_torch.serving.engine:ServingEngine",
    "repro_torch.serving.executor:CompressedExecutor",
    "repro_torch.serving.executor:LCCMatvec",
    "repro_torch.serving.executor:GroupedLCCMatvec",
    "repro_torch.serving.executor:matvecs_from_artifact",
    "repro_torch.convert:params_from_numpy",
    "repro_torch.convert:artifact_from_reference",
    "repro_torch.testing:seeded_artifact",
    "repro_torch.training.trainer:init_train_state",
    "repro_torch.models.mlp:init_mlp",
    "repro_torch.convert:mlp_params_from_numpy",
    "repro_torch.convert:train_state_from_numpy",
    "repro_torch.core.artifact:CompressedModel.load",
    "repro_torch.core.artifact:CompressedModel.from_flat",
    "repro_torch.models.resnet:init_resnet",
    "repro_torch.convert:resnet_params_from_numpy",
    "repro_torch.serving.executor:ConvLCC",
    "repro_torch.testing:seeded_conv_artifact",
])
def test_entry_points_default_to_the_gpu(path):
    import importlib
    mod, name = path.split(":")
    fn = importlib.import_module(mod)
    for part in name.split("."):
        fn = getattr(fn, part)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_compress_launcher_defaults_to_the_gpu(monkeypatch, tmp_path):
    import torch

    from repro_torch.launch import compress
    assert compress.parse_args(["--out", str(tmp_path)]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        compress.main(["--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_serve_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                "--max-new", "3", "--slots", "2", "--kernel"])
    out = capsys.readouterr().out
    assert "routed 14/14 sites" in out and "6 tokens" in out
    # the reduced config computes in float32: decode takes the whole-step plan
    assert "1 layer plan" in out and "plan fallbacks {}" in out


def test_serve_launcher_runs_deepseek_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "deepseek-v2-lite-16b", "--reduced", "--device",
                "cpu", "--requests", "2", "--max-new", "3", "--slots", "2",
                "--kernel"])
    out = capsys.readouterr().out
    # 2 layers x (6 MLA + 3 x 4 expert + 3 shared-expert sites)
    assert "routed 42/42 sites" in out and "6 tokens" in out
    # MLA refuses the whole-step plan; float32 takes one expert plan a layer
    assert "2 layer plan(s)" in out and "plan fallbacks {'step': 'mla'}" in out
