"""The subset of MessagePack that a checkpoint's manifest uses: maps,
strings, integers, booleans, nil, arrays and floats, written as
``msgpack.packb`` writes them by default (the smallest form of each,
floats as float64) and read back as ``msgpack.unpackb`` reads them
(arrays as lists, strings decoded).  The
port keeps its own, so that it reads and writes the JAX package's
checkpoints where the ``msgpack`` package is not installed."""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _sized(out: List[bytes], n: int, fix: Tuple[int, int], forms) -> None:
    """Append the header of a sized item: the fix form when ``n`` is below
    its limit, else the first of ``forms`` (code, struct format, limit)
    that holds it."""
    fix_code, fix_limit = fix
    if n < fix_limit:
        out.append(bytes([fix_code | n]))
        return
    for code, fmt, limit in forms:
        if n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: size {n} too large")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(bytes([obj]))
        elif -32 <= obj < 0:
            out.append(struct.pack(">b", obj))
        elif obj >= 0:
            for code, fmt, limit in ((0xcc, ">B", 1 << 8),
                                     (0xcd, ">H", 1 << 16),
                                     (0xce, ">I", 1 << 32),
                                     (0xcf, ">Q", 1 << 64)):
                if obj < limit:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"msgpack: integer {obj} too large")
        else:
            for code, fmt, low in ((0xd0, ">b", -(1 << 7)),
                                   (0xd1, ">h", -(1 << 15)),
                                   (0xd2, ">i", -(1 << 31)),
                                   (0xd3, ">q", -(1 << 63))):
                if obj >= low:
                    out.append(bytes([code]) + struct.pack(fmt, obj))
                    return
            raise ValueError(f"msgpack: integer {obj} too small")
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _sized(out, len(raw), (0xa0, 32), ((0xd9, ">B", 1 << 8),
                                           (0xda, ">H", 1 << 16),
                                           (0xdb, ">I", 1 << 32)))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), (0x90, 16), ((0xdc, ">H", 1 << 16),
                                           (0xdd, ">I", 1 << 32)))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _sized(out, len(obj), (0x80, 16), ((0xde, ">H", 1 << 16),
                                           (0xdf, ">I", 1 << 32)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        raw = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return raw

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xcb: ">d"}
_STR = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
_ARRAY = {0xdc: ">H", 0xdd: ">I"}
_MAP = {0xde: ">H", 0xdf: ">I"}


def _unpack(r: _Reader) -> Any:
    code = r.take(1)[0]
    if code < 0x80:
        return code
    if code >= 0xe0:
        return code - 0x100
    if 0xa0 <= code < 0xc0:
        return r.take(code & 0x1f).decode("utf-8")
    if 0x90 <= code < 0xa0:
        return [_unpack(r) for _ in range(code & 0x0f)]
    if 0x80 <= code < 0x90:
        return _unpack_map(r, code & 0x0f)
    if code == 0xc0:
        return None
    if code in (0xc2, 0xc3):
        return code == 0xc3
    if code in _FIXED:
        return r.num(_FIXED[code])
    if code in _STR:
        return r.take(r.num(_STR[code])).decode("utf-8")
    if code in _ARRAY:
        return [_unpack(r) for _ in range(r.num(_ARRAY[code]))]
    if code in _MAP:
        return _unpack_map(r, r.num(_MAP[code]))
    raise ValueError(f"msgpack: unsupported type byte 0x{code:02x}")


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, str):
            raise ValueError(f"msgpack: map key {k!r} is not a string")
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes) -> Any:
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("msgpack: extra data after the object")
    return obj
