"""A small MessagePack encoder and decoder: the subset the checkpoint
envelope uses (maps, arrays, str, bin, int, float, bool, nil), written as
`msgpack.packb(obj, use_bin_type=True)` writes it and read as
`msgpack.unpackb(data, raw=False)` reads it.

The port keeps its own codec so that it reads and writes the JAX package's
checkpoint files where the `msgpack` package is not installed. Every
integer takes its smallest encoding (positive ints the unsigned forms,
negative ints the signed ones), floats are float64, str takes fixstr,
str8, str16 or str32 and bin takes bin8, bin16 or bin32 by length: the
choices that decide whether two writers give the same bytes.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple


def _length(out: bytearray, n: int, fix: Optional[Tuple[int, int]],
            forms) -> None:
    """A length header: the fix form (`fix` = (tag base, limit)) when there
    is one and it fits, else the first (tag, struct code, limit) of
    `forms` that does."""
    if fix is not None and n < fix[1]:
        out.append(fix[0] | n)
        return
    for tag, code, lim in forms:
        if n < lim:
            out.append(tag)
            out += struct.pack(">" + code, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v <= 0xFF:
            out += b"\xcc" + struct.pack(">B", v)
        elif v <= 0xFFFF:
            out += b"\xcd" + struct.pack(">H", v)
        elif v <= 0xFFFFFFFF:
            out += b"\xce" + struct.pack(">I", v)
        elif v <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + struct.pack(">Q", v)
        else:
            raise OverflowError(f"msgpack: int {v} too large")
    elif v >= -0x20:
        out += struct.pack(">b", v)
    elif v >= -0x80:
        out += b"\xd0" + struct.pack(">b", v)
    elif v >= -0x8000:
        out += b"\xd1" + struct.pack(">h", v)
    elif v >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", v)
    elif v >= -0x8000000000000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise OverflowError(f"msgpack: int {v} too large")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif type(obj) is int:
        _int(out, obj)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _length(out, len(data), (0xA0, 32),
                ((0xD9, "B", 1 << 8), (0xDA, "H", 1 << 16),
                 (0xDB, "I", 1 << 32)))
        out += data
    elif type(obj) in (bytes, bytearray, memoryview):
        data = bytes(obj)
        _length(out, len(data), None,
                ((0xC4, "B", 1 << 8), (0xC5, "H", 1 << 16),
                 (0xC6, "I", 1 << 32)))
        out += data
    elif type(obj) in (list, tuple):
        _length(out, len(obj), (0x90, 16),
                ((0xDC, "H", 1 << 16), (0xDD, "I", 1 << 32)))
        for v in obj:
            _pack(out, v)
    elif type(obj) is dict:
        _length(out, len(obj), (0x80, 16),
                ((0xDE, "H", 1 << 16), (0xDF, "I", 1 << 32)))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: can not serialize {type(obj).__name__!r} "
                        "object")


def packb(obj) -> bytes:
    """`obj` as MessagePack bytes (`msgpack.packb(obj, use_bin_type=True)`
    for the types listed in the module docstring)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack: data ends inside an object")
        view = self.data[self.pos:end]
        self.pos = end
        return view

    def unpack(self, code: str):
        size = struct.calcsize(">" + code)
        return struct.unpack(">" + code, self.take(size))[0]


# tag -> struct code of the fixed-width scalar forms
_SCALARS = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
            0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
# tag -> (kind, struct code of the length)
_SIZED = {0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
          0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
          0xDC: ("array", "H"), 0xDD: ("array", "I"),
          0xDE: ("map", "H"), 0xDF: ("map", "I")}


def _read(r: _Reader, depth: int = 0):
    if depth > 512:
        raise ValueError("msgpack: nesting too deep")
    tag = r.unpack("B")
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif tag == 0xC0:
        return None
    elif tag == 0xC2:
        return False
    elif tag == 0xC3:
        return True
    elif tag in _SCALARS:
        return r.unpack(_SCALARS[tag])
    elif tag in _SIZED:
        kind, code = _SIZED[tag]
        n = r.unpack(code)
    else:
        raise ValueError(f"msgpack: unsupported type byte 0x{tag:02x}")
    if kind == "str":
        return str(r.take(n), "utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_read(r, depth + 1) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _read(r, depth + 1)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"msgpack: map key of type {type(k).__name__}")
        out[k] = _read(r, depth + 1)
    return out


def unpackb(data: bytes):
    """The object MessagePack `data` holds (str as str, bin as bytes).
    Raises ValueError on malformed or trailing bytes."""
    r = _Reader(data)
    obj = _read(r)
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} bytes of extra "
                         "data after the object")
    return obj
