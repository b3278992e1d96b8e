"""K5 (group_prox): the port's plain version (what the wrapper runs for CPU
tensors) and its torch oracle against the JAX kernel in Pallas interpret
mode, on the reference's own cases — zero rows, rows at and around the
threshold, G that is no block multiple, float32 and bf16.  The same numpy
inputs go through both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.group_lasso import group_prox_rows_np
from repro.kernels.group_prox import group_prox as jgroup_prox

from repro_torch.core import group_lasso as tgl
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels.group_prox import group_prox, group_prox_plain

# float32: sums of squares in another order than XLA's; bf16: the reference
# test's own tolerance (one rounding of the output to bf16 either side)
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _hard_rows():
    """The reference's boundary case: structurally zero rows, a row exactly
    at the threshold 2.0, one just under (killed), one just over (kept)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((37, 16))
    a[[3, 17, 36]] = 0.0
    a[5] *= 2.0 / np.linalg.norm(a[5])
    a[9] *= 1.995 / np.linalg.norm(a[9])
    a[11] *= 2.005 / np.linalg.norm(a[11])
    return a.astype(np.float32)


CASES = ([(f"{g}x{m} t={t}", g, m, t, "float32")
          for g, m in ((256, 64), (512, 33), (256, 301))
          for t in (0.0, 0.5, 10.0)]
         + [("256x128 bf16 t=1.3", 256, 128, 1.3, "bfloat16"),
            ("hard 37x16 t=2", 37, 16, 2.0, "float32"),
            ("hard 37x16 bf16 t=2", 37, 16, 2.0, "bfloat16")])


@pytest.mark.parametrize("label,g,m,t,dtype", CASES, ids=[c[0] for c in CASES])
def test_plain_and_oracle_match_the_pallas_kernel(label, g, m, t, dtype):
    if label.startswith("hard"):
        a = _hard_rows()
    else:
        a = np.random.default_rng(g + m).standard_normal((g, m)).astype(np.float32)
    ja = jnp.asarray(a, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    want = np.asarray(jgroup_prox(ja, t), np.float32)
    for fn in (group_prox_plain, ref.group_prox_ref, group_prox):
        got = fn(ta, t)
        assert got.dtype == ta.dtype and got.shape == (g, m)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=TOL[dtype], atol=TOL[dtype])
    got = group_prox_plain(ta, t).float().numpy()
    assert np.isfinite(got).all()
    zero_in = (a == 0).all(axis=1)
    assert (got[zero_in] == 0).all()
    if label.startswith("hard"):
        assert (got[9] == 0).all() and np.abs(got[11]).max() > 0
        np.testing.assert_array_equal((got == 0).all(1), (want == 0).all(1))
        if dtype == "float32":
            np.testing.assert_allclose(got, group_prox_rows_np(a, t),
                                       rtol=1e-5, atol=1e-6)


def test_wrapper_on_the_cpu_takes_the_plain_version_and_counts_nothing():
    a = torch.from_numpy(np.random.default_rng(1).standard_normal((40, 24))
                         .astype(np.float32))
    want = group_prox_plain(a, 0.9)
    dispatch.reset_launch_count()
    out = torch.empty_like(a)
    assert group_prox(a, 0.9, out=out) is out
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    b = a.clone()
    assert group_prox(b, torch.tensor(0.9), out=b) is b  # in place
    torch.testing.assert_close(b, want, rtol=0, atol=0)
    assert dispatch.launch_count("group_prox") == 0
    with pytest.raises(ValueError):
        group_prox(a[0], 0.9)


def test_group_lasso_module_matches_the_reference():
    from repro.core import group_lasso as jgl

    rng = np.random.default_rng(3)
    w = rng.standard_normal((9, 14)).astype(np.float32)
    w[:, [2, 7]] = 0.0
    for t in (0.0, 1.1, 3.0):
        np.testing.assert_array_equal(tgl.group_prox_rows_np(w, t),
                                      jgl.group_prox_rows_np(w, t))
        np.testing.assert_array_equal(tgl.prox_dense_columns_np(w, t),
                                      jgl.prox_dense_columns_np(w, t))
        for fn, jfn, x in ((tgl.group_prox_rows, jgl.group_prox_rows, w),
                           (tgl.prox_dense_columns, jgl.prox_dense_columns, w)):
            np.testing.assert_allclose(fn(torch.from_numpy(x), t).numpy(),
                                       np.asarray(jfn(jnp.asarray(x), t)),
                                       rtol=1e-6, atol=1e-6)
    assert (tgl.prox_dense_columns(torch.from_numpy(w), 1.1)[:, [2, 7]] == 0).all()
    for axis in (0, 1):
        np.testing.assert_allclose(
            tgl.group_norms(torch.from_numpy(w), axis).numpy(),
            np.asarray(jgl.group_norms(jnp.asarray(w), axis)), rtol=1e-6)
        np.testing.assert_allclose(tgl.group_norms(w, axis),
                                   jgl.group_norms(w, axis), rtol=1e-12)
        np.testing.assert_allclose(
            float(tgl.group_lasso_penalty(torch.from_numpy(w), 0.3, axis)),
            float(jgl.group_lasso_penalty(jnp.asarray(w), 0.3, axis)), rtol=1e-6)
