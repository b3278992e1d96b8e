"""``ServingEngine(mesh=)`` for the recurrent and audio families of
``test_torch_sharded_families.py`` on their compressed artifacts:
rwkv6-1.6b's, zamba2-7b's and whisper-small's reference artifacts cast to
bf16 (the per-region route: K1, K2 and K3's plain versions, the tokenwise
prefill; whisper's cross-KV placed from the reference's recipe; the
attention families' artifacts are in
``test_torch_sharded_families_compressed.py``), at 2 gloo ranks over the (2, 1) meshes of
``SERVE_MESHES``, with the same checks: tokens identical to the unsharded
port engine's and to the reference's single-device ``ServingEngine`` (on
the artifact's dense-effective weights), logits within LOGIT_TOL of the
unsharded port engine and of the reference (bf16: BF16_ULPS bf16 ulps of
the reference's largest logit), plan stats, launches, stored bytes, the
collectives of one step (a compressed site runs whole on every rank: only
its bias is gathered), a 1 x 1 mesh bit for bit."""
import pytest
import torch

import _torch_dist_workers as workers
import _torch_family_cases as fc
from repro_torch.distributed.device_mesh import run_ranks

CASES = ["rwkv6-1.6b:bf16", "zamba2-7b:bf16", "whisper-small:bf16"]


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
