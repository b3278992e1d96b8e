"""``ServingEngine(mesh=)`` for the MLA (deepseek-v2-lite-16b), vlm
(qwen2-vl-7b), ssm (rwkv6-1.6b), hybrid (zamba2-7b) and audio
(whisper-small) families on their raw parameters, and the tokenwise prefill
(the reduced olmo-1b with ``bulk_prefill=False``), at 2 gloo ranks (one
spawn, ``_torch_dist_workers.sharded_families_run``, killed after TIMEOUT s)
over the (2, 1) meshes of ``SERVE_MESHES``: ("data", "model") splits the
slots (the MoE family replicates them), ("model", "data") every
partitioned leaf over "model".  Each case: tokens identical to the
unsharded port engine's and to the reference's single-device
``ServingEngine``; one step's logits within LOGIT_TOL of both; the
unsharded engine's plan stats and launches; each rank storing the
reference policy's share of every parameter and decode-state leaf; the
collectives of one step as ``_torch_family_cases.predicted_step`` reckons
them; a 1 x 1 mesh bit for bit the unsharded engine.  The cases and checks
live in ``_torch_family_cases.py``; the artifacts' cases in
``test_torch_sharded_families_compressed.py`` and
``test_torch_sharded_families_recurrent.py``."""
import pytest
import torch

import _torch_dist_workers as workers
import _torch_family_cases as fc
from repro_torch.distributed.device_mesh import run_ranks

CASES = [f"{a}:raw" for a in fc.ARCHS] + ["olmo-1b:tokenwise"]


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

