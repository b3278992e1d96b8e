"""m-RoPE (Qwen2-VL's multimodal rotary embedding) on the port against
``repro.models.layers.apply_mrope``.

Seeded x and distinct temporal / height / width positions (below 128, the
serves' cache length), at qwen2-vl-7b's sections (16, 24, 24) and at the
reduced config's.  The two packages' float32 ``exp``/``sin``/``cos`` differ
by one ulp on some inputs (XLA's against ATen's), and an angle is a
position times a frequency, so the difference grows with the position:
the tolerance is two float32 ulps of the largest angle, times the largest
|x| (``2**-22 * max(1, max pos) * max(1, max|x|)``, about 1e-4 here; measured
1.03e-5).  With the three axes at one position (text-only input) m-RoPE is
plain RoPE at theta 10000: bit for bit in the port, float32 and bf16."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs.base import reduced_config as jreduced
from repro.models.layers import apply_mrope as japply_mrope

from repro_torch.configs import get_arch, reduced_config
from repro_torch.models.layers import apply_mrope, apply_rope

FULL = (16, 24, 24)


def _reduced_sections():
    t = reduced_config(get_arch("qwen2-vl-7b")).mrope_sections
    assert t == jreduced(jget_arch("qwen2-vl-7b")).mrope_sections == (4, 6, 6)
    return t


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_mrope_matches_reference_on_distinct_axes(which):
    sections = FULL if which == "full" else _reduced_sections()
    hd = 2 * sum(sections)
    rng = np.random.default_rng(len(which))
    x = rng.standard_normal((2, 7, 3, hd)).astype(np.float32)
    pos3 = rng.integers(0, 128, (3, 2, 7)).astype(np.int32)
    assert all(len(np.unique(pos3[:, b, s])) > 1
               for b in range(2) for s in range(7))  # the axes differ
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), sections)
    want = np.asarray(japply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections))
    tol = 2.0 ** -22 * max(1, int(pos3.max())) * max(1.0, float(np.abs(x).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert got.dtype == torch.float32
    # each band turns with its own axis: moving only the width positions
    # leaves the temporal and height bands as they were
    moved = pos3.copy()
    moved[2] += 5
    y2 = apply_mrope(torch.from_numpy(x), torch.from_numpy(moved), sections)
    half, t, h = hd // 2, sections[0], sections[1]
    same = np.r_[0:t + h, half:half + t + h]
    np.testing.assert_array_equal(y2.numpy()[..., same], got.numpy()[..., same])
    assert not np.array_equal(y2.numpy(), got.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_broadcast_axes_equal_rope_at_default_theta(dtype):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 6, 4, 128)).astype(np.float32)
                         ).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 4096, (2, 6)))
    got = apply_mrope(x, pos[None].expand(3, 2, 6), FULL)
    assert got.dtype == dtype
    assert torch.equal(got, apply_rope(x, pos, 10000.0))


def test_sections_must_cover_half_the_head():
    x = torch.zeros((1, 2, 1, 128))
    pos3 = torch.zeros((3, 1, 2), dtype=torch.int64)
    with pytest.raises(AssertionError):
        apply_mrope(x, pos3, (16, 24, 16))
    with pytest.raises(AssertionError):
        apply_mrope(x[..., :96], pos3, FULL)
