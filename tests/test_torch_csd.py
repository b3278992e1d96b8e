"""CSD recoding and addition accounting: the port's ``core.csd`` against the
reference's on the same seeded numpy inputs, bitwise."""
import numpy as np
import pytest

from repro.core import csd as jcsd
from repro_torch.core import csd as tcsd


def _mat(seed, shape=(37, 23), scale=3.0):
    w = np.random.default_rng(seed).standard_normal(shape) * scale
    w[0] = 0.0  # a zero row costs nothing
    w[:, 1] = w[:, 2]  # ties
    return w


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("frac_bits", [4, 8, 12])
def test_counts_and_adds_bitwise(seed, frac_bits):
    w = _mat(seed)
    for fn in ("csd_digit_count", "adds_csd_rowwise"):
        a = getattr(jcsd, fn)(w, frac_bits)
        b = getattr(tcsd, fn)(w, frac_bits)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tcsd.adds_csd_matrix(w, frac_bits) == jcsd.adds_csd_matrix(w, frac_bits)


@pytest.mark.parametrize("word_bits", [None, 6])
def test_quantize_and_snr_bitwise(word_bits):
    w = _mat(3)
    q1, q2 = jcsd.quantize_fixed(w, 6, word_bits), tcsd.quantize_fixed(w, 6, word_bits)
    assert q1.tobytes() == q2.tobytes()
    for fb in (2, 8):
        a = jcsd.quantization_snr_db(w, fb, word_bits)
        b = tcsd.quantization_snr_db(w, fb, word_bits)
        assert a == b
    # an exactly representable matrix: infinite SNR on both sides
    assert tcsd.quantization_snr_db(np.full((2, 2), 0.5)) == np.inf
    assert tcsd.quantization_snr_db(np.zeros((2, 2)), 8) == \
        jcsd.quantization_snr_db(np.zeros((2, 2)), 8)


def test_scalar_digits_and_naf():
    rng = np.random.default_rng(4)
    for v in list(rng.standard_normal(50) * 10) + [0.0, -1.0, 0.75, 255 / 256]:
        assert tcsd.csd_digits(v, 8) == jcsd.csd_digits(v, 8)
    n = rng.integers(-(1 << 40), 1 << 40, size=500)
    assert np.array_equal(tcsd._naf_nonzero_count(n), jcsd._naf_nonzero_count(n))
    with pytest.raises(ValueError):
        tcsd.adds_csd_rowwise(np.zeros(3))
