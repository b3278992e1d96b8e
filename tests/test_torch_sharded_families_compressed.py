"""``ServingEngine(mesh=)`` for the attention families of
``test_torch_sharded_families.py`` on their compressed artifacts:
deepseek-v2-lite-16b's and qwen2-vl-7b's reference artifacts cast to bf16
(the per-region route: K1, K2 and K3's plain versions) and
deepseek-v2-lite-16b's float32 artifact (K9: one expert plan a layer, the
per-region MLA beside it; the recurrent and audio families' artifacts are
in ``test_torch_sharded_families_recurrent.py``), at 2 gloo ranks over the (2, 1) meshes of
``SERVE_MESHES``, with the same checks: tokens identical to the unsharded
port engine's and to the reference's single-device ``ServingEngine`` (on
the artifact's dense-effective weights), logits within LOGIT_TOL of the
unsharded port engine and of the reference (bf16: BF16_ULPS bf16 ulps of
the reference's largest logit), plan stats, launches, stored bytes, the
collectives of one step (a compressed site runs whole on every rank: only
its bias is gathered), a 1 x 1 mesh bit for bit.  The spawn also runs the
serve launcher's rank body (``_rank_main``) on its seeded reduced
rwkv6-1.6b with ``--dp 2`` and ``--tp 2``: rank 0 prints the unsharded
launcher's tokens."""
import contextlib
import io

import pytest
import torch

import _torch_dist_workers as workers
import _torch_family_cases as fc
from repro_torch.distributed.device_mesh import run_ranks
from repro_torch.launch import serve as serve_launch

CASES = ["deepseek-v2-lite-16b:bf16", "deepseek-v2-lite-16b:f32",
         "qwen2-vl-7b:bf16"]
# the serve launcher's seeded reduced rwkv6-1.6b (the ssm family: the
# tokenwise prefill, the per-region route) over the spawn's 2 ranks
LAUNCHER = ["--arch", "rwkv6-1.6b", "--reduced", "--device", "cpu",
            "--requests", "2", "--max-new", "3", "--kernel"]
MESH_FLAGS = (("--dp", "2"), ("--tp", "2"))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases():
    """(port cases, the reference's outputs, the reference configs)."""
    return fc.build_cases(CASES)


@pytest.fixture(scope="module")
def run(cases):
    return run_ranks(workers.sharded_families_run, 2, cases[0],
                     [LAUNCHER + list(f) for f in MESH_FLAGS],
                     timeout=fc.TIMEOUT, threads=1)


@pytest.fixture(scope="module")
def unsharded(cases):
    return {name: workers.family_case(case) for name, case in cases[0].items()}


@pytest.mark.parametrize("mesh", fc.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_tokens_equal_unsharded_and_reference(cases, run, unsharded, case,
                                             mesh):
    fc.check_tokens(cases[1], run, unsharded, case, mesh)


@pytest.mark.parametrize("mesh", fc.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_logits_within_tolerance(cases, run, unsharded, case, mesh):
    fc.check_logits(cases[1], run, unsharded, case, mesh)


@pytest.mark.parametrize("mesh", fc.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_plan_stats_and_launches_are_the_unsharded_engines(run, unsharded,
                                                           case, mesh):
    fc.check_plan_stats(run, unsharded, case, mesh)


@pytest.mark.parametrize("mesh", fc.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_stored_bytes_are_the_spec_share(cases, run, case, mesh):
    fc.check_stored_bytes(cases[2], run, case, mesh)


@pytest.mark.parametrize("mesh", fc.MESHES)
@pytest.mark.parametrize("case", CASES)
def test_collectives_per_step_as_predicted(cases, run, case, mesh):
    fc.check_collectives(cases[2], cases[0], run, case, mesh)


@pytest.mark.parametrize("case", CASES)
def test_one_by_one_mesh_is_the_unsharded_engine_bit_for_bit(cases, run,
                                                              case):
    fc.check_one_by_one(cases[2], cases[0], run, case)


@pytest.mark.parametrize("flags", MESH_FLAGS, ids=["dp2", "tp2"])
def test_launcher_serves_rwkv6_over_a_mesh(run, flags):
    """``launch/serve.py --arch rwkv6-1.6b --reduced --kernel`` with
    ``--dp 2`` / ``--tp 2`` on the spawn's 2 gloo ranks (its rank body,
    ``_rank_main``): rank 0 prints the unsharded launcher's request
    tokens, ``mesh DxT``, the ssm family's plan refusal."""
    meshed = run[0][("launcher", tuple(LAUNCHER + list(flags)))]
    assert run[1][("launcher", tuple(LAUNCHER + list(flags)))] is None
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launch.main(LAUNCHER)
    plain = out.getvalue()

    def reqs(text):
        return [ln for ln in text.splitlines() if ln.startswith("req")]

    assert reqs(meshed) == reqs(plain) and len(reqs(plain)) == 2
    assert "[error" not in meshed
    dp, tp = (flags[1], "1") if flags[0] == "--dp" else ("1", flags[1])
    assert f", mesh {dp}x{tp})" in meshed
    assert "plan fallbacks {'step': 'family:ssm'}" in meshed
