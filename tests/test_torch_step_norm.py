"""K7's norm (``layer_plan.step_norm``): the kernel's summation order in
plain PyTorch (``chip_smoke.ordered_norm_plain``, what the card's results are
held to) against the plain norm, the host planner's column groups and its
refusals, and the CPU dispatch."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch
from repro_torch.kernels.layer_plan import (norm_geometry, plan_norm,
                                            step_norm, step_norm_plain)
from repro_torch.kernels.lcc_chain_matmul import SMEM_LIMIT

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(d, b, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal((d, b)) + shift)
                            .astype(np.float32))


@pytest.mark.parametrize("norm", ["rms", "nonparam"])
@pytest.mark.parametrize("d", [64, 96])
@pytest.mark.parametrize("b", [1, 3, 8, 12])
def test_kernel_order_is_the_plain_norm(norm, d, b):
    """Within 1e-6 of the plain norm at the planner's geometry and at other
    column groups (a ragged last group included) and row splits (a last
    block with fewer rows, or none)."""
    cs = _chip_smoke()
    x = _x(d, b, d + b, shift=0.5)  # an offset mean: the centring matters
    w = (1.0 + 0.1 * _x(d, 1, 7)[:, 0]) if norm == "rms" else None
    want = step_norm_plain(x, w, norm)
    for cols, split in ((None, None), (1, 1), (2, 8), (4, 3), (8, 2),
                        (32, 5), (4, 7)):
        plan = (plan_norm(d, b) if cols is None
                else norm_geometry(d, b, cols, split))
        got = cs.ordered_norm_plain(x, w, norm, plan)
        assert got.shape == (d, b) and got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_the_step_takes_the_plain_norm_on_the_cpu():
    x, w = _x(64, 5, 1), 1.0 + 0.1 * _x(64, 1, 2)[:, 0]
    dispatch.reset_launch_count()
    assert torch.equal(step_norm(x, w, "rms"), step_norm_plain(x, w, "rms"))
    assert torch.equal(step_norm(x, None, "nonparam"),
                       step_norm_plain(x, None, "nonparam"))
    assert dispatch.launch_count() == 0
    with pytest.raises(ValueError, match="rms"):
        step_norm(x, w, "layer")


@pytest.mark.parametrize("d,b,cols,groups,split", [
    (2048, 8, 1, 8, 8),    # olmo-1b's plan serve: 256 rows a block, 64 blocks
    (6144, 8, 4, 2, 8),    # mixtral-8x22b's: 16-byte copies, 16 blocks
    (3072, 8, 4, 2, 8),    # llama3.2-3b's: 384 rows a block, 4 columns
    (4096, 8, 4, 2, 8),    # yi-9b's: 512 rows a block
    (64, 3, 1, 3, 8),      # small d: one column a cluster
    (96, 12, 1, 12, 8),
    (64, 1, 1, 1, 8),
    (6144, 3, 4, 1, 8),    # B not a multiple of 4: one ragged group
    (6144, 21, 32, 1, 8),
    (100000, 21, 4, 6, 8),  # halved from 32 until the sub-tile fits
    (100000, 8, 4, 2, 8),
])
def test_plan_norm_geometry(d, b, cols, groups, split):
    plan = plan_norm(d, b)
    assert (plan.cols, plan.groups, plan.split) == (cols, groups, split)
    assert plan.rows == -(-d // split) and plan.rows * (split - 1) < d
    assert plan.threads % 32 == 0 and plan.threads % plan.cols == 0
    assert 64 <= plan.threads <= 1024
    assert plan.smem_bytes == 4 * (plan.rows * cols + plan.threads // 32 * cols
                                   + 2 * split * cols + 2 * cols) <= SMEM_LIMIT
    assert plan == norm_geometry(d, b, cols, split)


def test_plan_norm_refusals():
    with pytest.raises(ValueError, match="empty"):
        plan_norm(0, 8)
    with pytest.raises(ValueError, match="empty"):
        plan_norm(64, 0)
    for cols in (3, 0, 64):
        with pytest.raises(ValueError, match="power of two"):
            norm_geometry(64, 8, cols, 8)
    for split in (0, 9):
        with pytest.raises(ValueError, match="split"):
            norm_geometry(64, 8, 4, split)
    with pytest.raises(ValueError, match="shared memory"):
        norm_geometry(6144, 8, 16, 1)  # a [6144, 16] tile needs 393 KB
    with pytest.raises(ValueError, match="shared memory"):
        plan_norm(600000, 8)  # not even one column of 8 blocks fits
