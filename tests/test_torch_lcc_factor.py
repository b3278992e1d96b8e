"""K4 — ``lcc_factor_matmul``, one LCC factor ``y = F x`` — and the
per-factor route (``fused=False``) against the JAX package.

Ports of the reference's factor cases (its shapes and dtypes): the port's
plain version (what the wrapper runs for CPU tensors) equals the JAX kernel
in interpret mode and the port's densifying oracle
(``ref.lcc_factor_matmul_ref``) bit for bit on dyadic inputs, where every
product and sum is exact, and within 1e-5 on Gaussian inputs (bf16: the
reference's 2e-2).  The per-factor route of a real compressor's
decomposition (one ``lcc_factor_matmul`` call per real factor) equals the
reference's ``fused=False`` and the port's fused route within 1e-6, the
reference's own tolerance between its two routes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lcc import lcc_decompose
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.lcc_matmul import lcc_factor_matmul as jfactor

from repro_torch.convert import decomposition_from_reference
from repro_torch.kernels import dispatch
from repro_torch.kernels import lcc_matmul, ops
from repro_torch.kernels.lcc_matmul import (lcc_factor_matmul,
                                            lcc_factor_matmul_plain)
from repro_torch.kernels.ref import lcc_factor_matmul_ref


def _streams(rng, n, k, s, exp_range=(-8, 8), signs=(-1, 0, 1)):
    return (rng.integers(0, k, (n, s)).astype(np.int32),
            rng.integers(*exp_range, (n, s)).astype(np.int8),
            rng.choice(signs, (n, s)).astype(np.int8))


def _dyadic(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


def _both(idx, exp, sign, x, jdtype=jnp.float32, tdtype=torch.float32,
          block_b=128):
    """(port plain, port oracle, JAX interpret kernel) as float32 numpy."""
    t = [torch.from_numpy(a) for a in (idx, exp, sign)]
    xt = torch.from_numpy(x).to(tdtype)
    got = lcc_factor_matmul(*t, xt)
    oracle = lcc_factor_matmul_ref(*t, xt)
    want = jfactor(jnp.asarray(idx), jnp.asarray(exp), jnp.asarray(sign),
                   jnp.asarray(x, jdtype), block_n=128, block_k=128,
                   block_b=block_b)
    return got.numpy(), oracle.numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("n,k,b,s", [(128, 128, 128, 2), (256, 128, 64, 3),
                                     (128, 256, 32, 4), (384, 128, 128, 2)])
@pytest.mark.parametrize("inputs", ["dyadic", "gaussian"])
def test_factor_matches_reference_kernel(n, k, b, s, inputs):
    rng = np.random.default_rng(n + k + b)
    idx, exp, sign = _streams(rng, n, k, s)
    x = (_dyadic(rng, (k, b)) if inputs == "dyadic"
         else rng.standard_normal((k, b)).astype(np.float32))
    dispatch.reset_launch_count()
    got, oracle, want = _both(idx, exp, sign, x, block_b=min(b, 128))
    assert dispatch.launch_count() == 0  # CPU tensors: the plain version
    assert got.shape == (n, b) and got.dtype == np.float32
    if inputs == "dyadic":  # every product and sum exact
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, oracle)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_factor_dtypes(dtype):
    rng = np.random.default_rng(7)
    n, k, b, s = 128, 128, 128, 2
    idx, exp, sign = _streams(rng, n, k, s, exp_range=(-6, 6), signs=(-1, 1))
    bf16 = dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                            torch.float32)
    # dyadic values k/8 are exact in bf16: bit for bit
    got, oracle, want = _both(idx, exp, sign, _dyadic(rng, (k, b)), jdt, tdt)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    # Gaussian input, rounded to the working type on both sides
    x = rng.standard_normal((k, b)).astype(np.float32)
    got, _, want = _both(idx, exp, sign, x, jdt, tdt)
    tol = 2e-2 if bf16 else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_unused_slots_add_nothing():
    rng = np.random.default_rng(9)
    idx, exp, sign = _streams(rng, 64, 32, 3)
    sign[:, 2] = 0
    idx[:, 2] = 10_000  # never read
    x = torch.from_numpy(_dyadic(rng, (32, 5)))
    got = lcc_factor_matmul_plain(*(torch.from_numpy(a) for a in (idx, exp, sign)), x)
    want = lcc_factor_matmul_plain(
        *(torch.from_numpy(np.ascontiguousarray(a[:, :2]))
          for a in (idx, exp, sign)), x)
    assert torch.equal(got, want)


def _decomposition(seed, shape, slice_width):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape)
    jdec = lcc_decompose(w, algorithm="fp", target_snr_db=35.0,
                         slice_width=slice_width)
    return jdec, decomposition_from_reference(jdec), rng


@pytest.mark.parametrize("shape,b,slice_width", [((160, 40), 19, 11),
                                                 ((96, 24), 7, None),
                                                 ((200, 16), 8, 16)])
def test_per_factor_route_equals_reference_and_fused(shape, b, slice_width,
                                                     monkeypatch):
    """Port of the reference's fused-vs-per-factor check (test_kernels:78)."""
    jdec, tdec, rng = _decomposition(21 + b, shape, slice_width)
    jpk, tpk = jops.pack_decomposition(jdec), ops.pack_decomposition(tdec)
    assert tpk.chain_lengths == jpk.chain_lengths
    x = rng.standard_normal((shape[1], b)).astype(np.float32)
    ref_loop = np.asarray(jops.apply_packed_decomposition(
        jpk, jnp.asarray(x), fused=False))
    calls = []
    real = lcc_matmul.lcc_factor_matmul

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)
    monkeypatch.setattr(ops, "lcc_factor_matmul", counting)
    loop = ops.apply_packed_decomposition(tpk, torch.from_numpy(x),
                                          fused=False).numpy()
    fused = ops.apply_packed_decomposition(tpk, torch.from_numpy(x)).numpy()
    assert len(calls) == sum(tpk.chain_lengths)  # one launch a real factor
    np.testing.assert_allclose(loop, ref_loop, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loop, fused, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(loop, jdec.apply(x.astype(np.float64)),
                               rtol=1e-5, atol=1e-5)


def test_per_factor_chain_equals_reference():
    jdec, tdec, rng = _decomposition(22, (200, 16), 16)
    jpc, tpc = jops.pack_chain(jdec.slices[0]), ops.pack_chain(tdec.slices[0])
    x = rng.standard_normal((tpc.in_dim, 8)).astype(np.float32)
    want = np.asarray(jops.apply_packed_chain(jpc, jnp.asarray(x), fused=False))
    got = ops.apply_packed_chain(tpc, torch.from_numpy(x), fused=False).numpy()
    fused = ops.apply_packed_chain(tpc, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (tpc.out_dim, 8)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, fused, rtol=1e-6, atol=1e-6)


def test_oracle_is_the_reference_oracle():
    rng = np.random.default_rng(11)
    idx, exp, sign = _streams(rng, 96, 40, 3)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    got = lcc_factor_matmul_ref(*(torch.from_numpy(a) for a in (idx, exp, sign)),
                                torch.from_numpy(x)).numpy()
    want = np.asarray(jref.lcc_factor_matmul_ref(
        jnp.asarray(idx), jnp.asarray(exp), jnp.asarray(sign), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_a_first_factor_outside_its_slice_is_refused():
    _, tdec, rng = _decomposition(23, (96, 24), 8)
    pk = ops.pack_decomposition(tdec)
    live = np.argwhere(pk.sign[0, 0] != 0)[0]
    pk.idx[0, 0, live[0], live[1]] = 8  # the slice holds rows [0, 8)
    x = torch.from_numpy(rng.standard_normal((24, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="outside"):
        ops.apply_packed_decomposition(pk, x, fused=False)
