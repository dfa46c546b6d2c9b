"""The subset of MessagePack that checkpoint shards use, written and read
without the ``msgpack`` wheel.

The encoder emits exactly what ``msgpack.packb(obj, use_bin_type=True)``
emits for maps, arrays (lists and tuples), str, bin (bytes, bytearray,
memoryview), int, float (always float64, ``0xcb``), bool and None: each
value in its smallest encoding.  The decoder reads that subset (and float32,
``0xca``) as ``msgpack.unpackb(raw=False)`` does, arrays as lists, except
that a bin comes back as a ``memoryview`` slice of the input, so a
multi-gigabyte shard is not copied leaf by leaf.
"""

from __future__ import annotations

import struct
from typing import Any, Callable

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")

_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
#: a bin or str of this many bytes or more has no encoding (bin32's limit)
MAX_LEN = 2**32


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return _I8.pack(n)
    if 0 < n <= 0xFF:
        return b"\xcc" + _U8.pack(n)
    if -0x80 <= n < 0:
        return b"\xd0" + _I8.pack(n)
    if 0 < n <= 0xFFFF:
        return b"\xcd" + _U16.pack(n)
    if -0x8000 <= n < 0:
        return b"\xd1" + _I16.pack(n)
    if 0 < n <= 0xFFFFFFFF:
        return b"\xce" + _U32.pack(n)
    if -0x80000000 <= n < 0:
        return b"\xd2" + _I32.pack(n)
    if 0 < n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + _U64.pack(n)
    if -0x8000000000000000 <= n < 0:
        return b"\xd3" + _I64.pack(n)
    raise OverflowError("Integer value out of range")


def _head(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """The length header of a str, bin, array or map of ``n`` items."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for code, width in zip(codes, (_U8, _U16, _U32)):
        if code is not None and n <= (1 << (8 * width.size)) - 1:
            return bytes((code,)) + width.pack(n)
    raise ValueError(f"an object of {n} bytes or items is too large for "
                     "MessagePack")


def pack_to(obj: Any, write: Callable[[Any], Any]) -> None:
    """Encode ``obj`` as a sequence of ``write(chunk)`` calls: the headers
    and small values batched, each bin's buffer passed on as it is (never
    copied)."""
    buf = bytearray()

    def emit(o):
        nonlocal buf
        if o is None:
            buf += b"\xc0"
        elif o is True:
            buf += b"\xc3"
        elif o is False:
            buf += b"\xc2"
        elif isinstance(o, int):
            buf += _int(o)
        elif isinstance(o, float):
            buf += b"\xcb" + _F64.pack(o)
        elif isinstance(o, str):
            b = o.encode("utf-8")
            buf += _head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b
        elif isinstance(o, (bytes, bytearray, memoryview)):
            mv = memoryview(o).cast("B") if isinstance(o, memoryview) else o
            buf += _head(len(mv), None, 0, (0xC4, 0xC5, 0xC6))
            if len(mv) < 4096:
                buf += mv
            else:
                write(bytes(buf))
                buf = bytearray()
                write(mv)
        elif isinstance(o, (list, tuple)):
            buf += _head(len(o), 0x90, 15, (None, 0xDC, 0xDD))
            for v in o:
                emit(v)
        elif isinstance(o, dict):
            buf += _head(len(o), 0x80, 15, (None, 0xDE, 0xDF))
            for k, v in o.items():
                emit(k)
                emit(v)
        else:
            raise TypeError(f"can not serialize {type(o).__name__!r} object")

    emit(obj)
    if buf:
        write(bytes(buf))


def packb(obj: Any) -> bytes:
    parts: list = []
    pack_to(obj, parts.append)
    return b"".join(parts)


def unpackb(data) -> Any:
    """Decode one object that fills ``data`` (bytes-like).  Bins are
    ``memoryview`` slices of ``data``."""
    mv = memoryview(data).cast("B")
    pos = 0

    def take(n: int) -> memoryview:
        nonlocal pos
        if pos + n > len(mv):
            raise ValueError("truncated MessagePack data")
        out = mv[pos:pos + n]
        pos += n
        return out

    def num(s: struct.Struct):
        return s.unpack(take(s.size))[0]

    def read():
        b = take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return read_map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(take(b & 0x1F), "utf-8")
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in (0xC4, 0xC5, 0xC6):
            return take(num((_U8, _U16, _U32)[b - 0xC4]))
        if b in (0xD9, 0xDA, 0xDB):
            return str(take(num((_U8, _U16, _U32)[b - 0xD9])), "utf-8")
        if b == 0xCA:
            return num(_F32)
        if b == 0xCB:
            return num(_F64)
        if 0xCC <= b <= 0xCF:
            return num((_U8, _U16, _U32, _U64)[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return num((_I8, _I16, _I32, _I64)[b - 0xD0])
        if b in (0xDC, 0xDD):
            return [read() for _ in range(num((_U16, _U32)[b - 0xDC]))]
        if b in (0xDE, 0xDF):
            return read_map(num((_U16, _U32)[b - 0xDE]))
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    def read_map(n: int) -> dict:
        out = {}
        for _ in range(n):
            k = read()
            out[k] = read()
        return out

    obj = read()
    if pos != len(mv):
        raise ValueError("extra data after the MessagePack object")
    return obj
