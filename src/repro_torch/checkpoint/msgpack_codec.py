"""The msgpack subset the checkpointer and the slice cache write, without the
``msgpack`` package (the GPU machine has none).

Types: nil, bool, int (positive and negative fixint, u/int 8-64), float64,
str (fixstr, str8/16/32), bin (8/16/32), array and map (fix/16/32).  Any
other type code raises ``ValueError`` on decode; any other Python type
raises ``TypeError`` on encode.

:func:`pack` streams to a binary file object and its bytes equal
``msgpack.packb(obj, use_bin_type=True)``: the smallest int form (positive
values in the unsigned forms), a float always as float64, a str as str8 or
wider.  A bin's payload is written straight from the object's buffer (a
``bytes``, ``bytearray``, ``memoryview`` or numpy array), never joined into
one ``bytes``.  :func:`unpackb` reads any buffer (``bytes``, ``memoryview``,
``mmap``) and returns what ``msgpack.unpackb(b, raw=False)`` returns, except
that a bin comes back as a zero-copy ``memoryview`` slice of the buffer.
"""
from __future__ import annotations

import io
import struct

import numpy as np

__all__ = ["pack", "packb", "unpackb", "BIN_LIMIT"]

BIN_LIMIT = 0xFFFFFFFF  # bin32 holds at most 2**32 - 1 bytes

_B, _H, _I, _Q = (struct.Struct(">" + c) for c in "BHIQ")
_b, _h, _i, _q = (struct.Struct(">" + c) for c in "bhiq")
_D = struct.Struct(">d")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return _B.pack(v)
    if -32 <= v < 0:
        return _b.pack(v)
    if v > 0:
        for code, s, top in ((0xCC, _B, 0xFF), (0xCD, _H, 0xFFFF),
                             (0xCE, _I, 0xFFFFFFFF),
                             (0xCF, _Q, 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes((code,)) + s.pack(v)
    else:
        for code, s, low in ((0xD0, _b, -0x80), (0xD1, _h, -0x8000),
                             (0xD2, _i, -0x80000000),
                             (0xD3, _q, -0x8000000000000000)):
            if v >= low:
                return bytes((code,)) + s.pack(v)
    raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _header(n: int, fix: int | None, fix_max: int, codes) -> bytes:
    """Length header: the fix form (``fix | n``) up to ``fix_max``, then the
    8/16/32-bit forms of ``codes`` (None: that width does not exist)."""
    if fix is not None and n <= fix_max:
        return _B.pack(fix | n)
    for code, s, top in zip(codes, (_B, _H, _I), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes((code,)) + s.pack(n)
    raise ValueError(f"length {n} above msgpack's 32-bit limit")


class _Oversize(ValueError):
    """A bin above bin32's limit; ``path`` is filled in as it unwinds."""

    def __init__(self, n: int):
        super().__init__(n)
        self.n = n
        self.path: list[str] = []


def _bin_view(obj) -> memoryview:
    """The bytes of a bin leaf as a flat view, refused above bin32's limit
    before any byte is touched."""
    n = obj.nbytes if isinstance(obj, (np.ndarray, memoryview)) else len(obj)
    if n > BIN_LIMIT:
        raise _Oversize(n)
    if isinstance(obj, np.ndarray):
        # reshape(-1): a view with a zero in its shape cannot be cast
        obj = np.ascontiguousarray(obj).reshape(-1)
    return memoryview(obj).cast("B")


_FLUSH = 1 << 20  # buffered bytes written out at a time
_DIRECT = 1 << 16  # a bin payload this large goes straight to the file
_BINS = (bytes, bytearray, memoryview, np.ndarray)


def pack(obj, f) -> None:
    """Write ``obj`` to the binary file object ``f`` (see the module
    docstring).  A bin above the bin32 limit raises ``ValueError`` naming
    its path in the tree before any of its bytes is written."""
    buf = bytearray()
    strs: dict[str, bytes] = {}  # short strings (keys, dtypes) encoded once

    def enc(o):
        t = type(o)
        if t is dict or (t is not str and isinstance(o, dict)):
            buf.extend(_header(len(o), 0x80, 15, (None, 0xDE, 0xDF)))
            for k, v in o.items():
                enc(k)
                try:
                    enc(v)
                except _Oversize as e:
                    e.path.insert(0, str(k))
                    raise
        elif t is str or isinstance(o, str):
            b = strs.get(o)
            if b is None:
                raw = o.encode("utf-8")
                b = _header(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
                if len(o) <= 16:
                    strs[o] = b
            buf.extend(b)
        elif o is None:
            buf.append(0xC0)
        elif o is True:
            buf.append(0xC3)
        elif o is False:
            buf.append(0xC2)
        elif isinstance(o, int):
            buf.extend(_int(o))
        elif isinstance(o, _BINS):
            mv = _bin_view(o)
            buf.extend(_header(mv.nbytes, None, 0, (0xC4, 0xC5, 0xC6)))
            if mv.nbytes >= _DIRECT:
                f.write(buf)
                buf.clear()
                f.write(mv)
            else:
                buf.extend(mv)
        elif isinstance(o, float):  # numpy's float64 too, as msgpack packs it
            buf.append(0xCB)
            buf.extend(_D.pack(o))
        elif isinstance(o, (list, tuple)):
            buf.extend(_header(len(o), 0x90, 15, (None, 0xDC, 0xDD)))
            for i, v in enumerate(o):
                try:
                    enc(v)
                except _Oversize as e:
                    e.path.insert(0, str(i))
                    raise
        else:
            raise TypeError(f"cannot pack {type(o).__name__}: not in the "
                            "msgpack subset of this codec")
        if len(buf) >= _FLUSH:
            f.write(buf)
            buf.clear()

    try:
        enc(obj)
    except _Oversize as e:
        raise ValueError(f"leaf {'/'.join(e.path)!r} is {e.n} bytes, above "
                         f"msgpack's bin32 limit of {BIN_LIMIT} bytes") from None
    f.write(buf)


def packb(obj) -> bytes:
    """``obj`` as one ``bytes`` (small trees: slice-cache entries, tests)."""
    buf = io.BytesIO()
    pack(obj, buf)
    return buf.getvalue()


_OPS = {  # code -> (what follows, the struct of its value or length)
    0xC4: ("bin", _B), 0xC5: ("bin", _H), 0xC6: ("bin", _I),
    0xCB: ("num", _D),
    0xCC: ("num", _B), 0xCD: ("num", _H), 0xCE: ("num", _I), 0xCF: ("num", _Q),
    0xD0: ("num", _b), 0xD1: ("num", _h), 0xD2: ("num", _i), 0xD3: ("num", _q),
    0xD9: ("str", _B), 0xDA: ("str", _H), 0xDB: ("str", _I),
    0xDC: ("seq", _H), 0xDD: ("seq", _I),
    0xDE: ("map", _H), 0xDF: ("map", _I),
}


def unpackb(buf):
    """Decode one object filling all of ``buf``; trailing bytes raise."""
    mv = memoryview(buf).cast("B")
    n = len(mv)
    pos = 0

    def take(k: int) -> memoryview:
        nonlocal pos
        end = pos + k
        if end > n:
            raise ValueError(f"msgpack data truncated at byte {pos} "
                             f"(wanted {k} more of {n})")
        out = mv[pos:end]
        pos = end
        return out

    def num(s: struct.Struct):
        nonlocal pos
        end = pos + s.size
        if end > n:
            raise ValueError(f"msgpack data truncated at byte {pos}")
        (v,) = s.unpack_from(mv, pos)
        pos = end
        return v

    def mapping(k: int) -> dict:
        out = {}
        for _ in range(k):
            key = obj()
            out[key] = obj()
        return out

    def obj():
        nonlocal pos
        if pos >= n:
            raise ValueError(f"msgpack data truncated at byte {pos}")
        code = mv[pos]
        pos += 1
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return str(take(code & 0x1F), "utf-8")
        if 0x80 <= code <= 0x8F:
            return mapping(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [obj() for _ in range(code & 0x0F)]
        if code == 0xC0:
            return None
        if code == 0xC2:
            return False
        if code == 0xC3:
            return True
        op = _OPS.get(code)
        if op is None:
            raise ValueError(f"msgpack type code 0x{code:02x} at byte "
                             f"{pos - 1} is outside this codec's subset")
        kind, width = op
        v = num(width)
        if kind == "num":
            return v
        if kind == "bin":
            return take(v)
        if kind == "str":
            return str(take(v), "utf-8")
        if kind == "seq":
            return [obj() for _ in range(v)]
        return mapping(v)

    out = obj()
    if pos != n:
        raise ValueError(f"{n - pos} bytes of extra data after the msgpack "
                         "object")
    return out
