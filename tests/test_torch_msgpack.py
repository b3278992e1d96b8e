"""The port's msgpack codec against the ``msgpack`` package (the yardstick;
the port does not import it): over hypothesis trees of the subset (ints at
every width boundary and negative edge, floats, unicode strings, bins of
0/255/256/65535/65536 bytes, nested maps and lists) the encoder's bytes equal
``msgpack.packb(obj, use_bin_type=True)`` and the decoder equals
``msgpack.unpackb(b, raw=False)``; codes outside the subset, truncated and
trailing data are refused; a bin above 2**32 - 1 bytes is refused by name
without allocating it."""
import io
import mmap

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.checkpoint import msgpack_codec as mc

EDGES = [0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
         0x100000000, 0xFFFFFFFFFFFFFFFF, -1, -32, -33, -0x80, -0x81,
         -0x8000, -0x8001, -0x80000000, -0x80000001, -0x8000000000000000]
BIN_SIZES = [0, 255, 256, 65535, 65536]

ints = st.one_of(st.sampled_from(EDGES),
                 st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1))
floats = st.floats(allow_nan=False)
texts = st.one_of(st.text(max_size=40),
                  st.sampled_from([n * "é" for n in (15, 16, 127, 128)]
                                  + ["x" * n for n in (31, 32, 255, 256, 65536)]))
bins = st.one_of(st.binary(max_size=40),
                 st.sampled_from(BIN_SIZES).map(lambda n: bytes(range(256)) * (n // 256)
                                                + bytes(n % 256)))
scalars = st.one_of(st.none(), st.booleans(), ints, floats, texts, bins)
trees = st.recursive(
    scalars,
    lambda kids: st.one_of(st.lists(kids, max_size=18),
                           st.dictionaries(st.text(max_size=8), kids, max_size=18)),
    max_leaves=40)


@settings(max_examples=300, deadline=None)
@given(trees)
def test_bytes_and_values_equal_msgpack(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    got = mc.packb(obj)
    assert got == want
    assert mc.unpackb(got) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("n", [16, 65535, 65536], ids=["16", "65535", "65536"])
def test_wide_arrays_and_maps(n):
    for obj in (list(range(n)), {str(i): i for i in range(n)}):
        want = msgpack.packb(obj, use_bin_type=True)
        assert mc.packb(obj) == want
        assert mc.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_numpy_bins_stream_from_the_buffer_and_decode_zero_copy(tmp_path):
    a = np.arange(1000, dtype=np.int32).reshape(10, 100)
    obj = {"a": a, "t": a[:, ::2], "z": np.zeros(0, np.int8), "s": np.float64(2)}
    obj["s"] = np.asarray(obj["s"])
    want = msgpack.packb({k: np.ascontiguousarray(v).tobytes()
                          for k, v in obj.items()}, use_bin_type=True)
    path = tmp_path / "x.msgpack"
    with open(path, "wb") as f:
        mc.pack(obj, f)
    assert path.read_bytes() == want
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    back = mc.unpackb(mm)
    assert isinstance(back["a"], memoryview) and back["a"].readonly
    assert np.array_equal(np.frombuffer(back["a"], np.int32).reshape(10, 100), a)
    assert np.array_equal(np.frombuffer(back["t"], np.int32).reshape(10, 50),
                          a[:, ::2])


@pytest.mark.parametrize("data", [b"\xca\x00\x00\x00\x00", b"\xc1", b"\xd4\x00\x00",
                                  b"\xc7\x01\x00\x00", b"\xd8\x00" + bytes(16)],
                         ids=["float32", "never_used", "fixext1", "ext8", "fixext16"])
def test_codes_outside_the_subset_are_refused(data):
    with pytest.raises(ValueError, match="outside"):
        mc.unpackb(data)


def test_truncated_and_trailing_data_are_refused():
    good = mc.packb({"k": b"abc", "n": [1, 2, 3]})
    for cut in range(len(good)):
        with pytest.raises(ValueError):
            mc.unpackb(good[:cut])
    with pytest.raises(ValueError, match="extra"):
        mc.unpackb(good + b"\xc0")


def test_types_outside_the_subset_are_refused():
    for obj in (np.int64(3), {1: 2}.keys(), set(), 2 ** 64, -(2 ** 63) - 1):
        with pytest.raises((TypeError, OverflowError)):
            mc.packb(obj)


def test_a_bin_above_the_bin32_limit_is_refused_by_name():
    # 4 GiB of zeros by stride: nothing of that size is allocated
    huge = np.broadcast_to(np.zeros(1, np.uint8), (mc.BIN_LIMIT + 1,))
    buf = io.BytesIO()
    with pytest.raises(ValueError, match="params/w/data.*bin32"):
        mc.pack({"params/w": {"data": huge}}, buf)
    assert len(buf.getvalue()) < 64  # refused before its payload
