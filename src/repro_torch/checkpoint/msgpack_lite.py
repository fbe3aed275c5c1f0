"""The msgpack subset of the checkpoint format, in plain Python.

``packb(obj)`` gives the bytes of ``msgpack.packb(obj, use_bin_type=True)``
and ``unpackb(data)`` reads them back as ``msgpack.unpackb(data,
raw=False)`` does, for the types a checkpoint holds: nil, bool, int
(fixints and the 8-64 bit signed and unsigned forms, each int in the
smallest one, as msgpack chooses), float (always float64), str (fixstr,
str8/16/32), bytes (bin8/16/32), list and tuple (fixarray, array16/32, read
back as lists) and dict (fixmap, map16/32).  Anything else raises
``TypeError`` when packed and ``ValueError`` when read.  The port carries
this codec because the msgpack package is not installed everywhere the port
runs.
"""

from __future__ import annotations

import struct

_U8, _U16, _U32, _U64 = (struct.Struct(f) for f in (">B", ">H", ">I", ">Q"))
_I8, _I16, _I32, _I64 = (struct.Struct(f) for f in (">b", ">h", ">i", ">q"))
_F64 = struct.Struct(">d")


def _int(obj: int, out: list) -> None:
    if 0 <= obj < 0x80:
        out.append(_U8.pack(obj))
    elif -0x20 <= obj < 0:
        out.append(_U8.pack(obj & 0xFF))
    elif -0x80 <= obj < 0:
        out.append(b"\xd0" + _I8.pack(obj))
    elif 0x80 <= obj <= 0xFF:
        out.append(b"\xcc" + _U8.pack(obj))
    elif -0x8000 <= obj < 0:
        out.append(b"\xd1" + _I16.pack(obj))
    elif 0xFF < obj <= 0xFFFF:
        out.append(b"\xcd" + _U16.pack(obj))
    elif -0x80000000 <= obj < 0:
        out.append(b"\xd2" + _I32.pack(obj))
    elif 0xFFFF < obj <= 0xFFFFFFFF:
        out.append(b"\xce" + _U32.pack(obj))
    elif -0x8000000000000000 <= obj < 0:
        out.append(b"\xd3" + _I64.pack(obj))
    elif 0xFFFFFFFF < obj <= 0xFFFFFFFFFFFFFFFF:
        out.append(b"\xcf" + _U64.pack(obj))
    else:
        raise OverflowError(f"int {obj} does not fit in 64 bits")


def _header(n: int, fix: int, fix_max: int, codes: bytes, out: list,
            what: str) -> None:
    """The length header of a str / bin / array / map of ``n`` items:
    the fix form (``fix`` | n) when ``fix_max`` allows it, else the 8-bit
    (bin and str only: ``codes`` then has three entries), 16- or 32-bit
    form."""
    if n <= fix_max:
        out.append(_U8.pack(fix | n))
    elif len(codes) == 3 and n <= 0xFF:
        out.append(codes[:1] + _U8.pack(n))
    elif n <= 0xFFFF:
        out.append(codes[-2:-1] + _U16.pack(n))
    elif n <= 0xFFFFFFFF:
        out.append(codes[-1:] + _U32.pack(n))
    else:
        raise ValueError(f"{what} of {n} items is too large for msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(len(data), 0xA0, 31, b"\xd9\xda\xdb", out, "str")
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        _header(n, 0, -1, b"\xc4\xc5\xc6", out, "bin")
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        _header(len(obj), 0x90, 15, b"\xdc\xdd", out, "array")
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _header(len(obj), 0x80, 15, b"\xde\xdf", out, "map")
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` as msgpack bytes (``msgpack.packb(obj, use_bin_type=True)``).
    Bytes-like leaves are copied once, into the result."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: struct.Struct):
        return fmt.unpack(self.take(fmt.size))[0]

    def obj(self):
        code = self.unpack(_U8)
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0xA0 <= code <= 0xBF:
            return self.text(code & 0x1F)
        if 0x90 <= code <= 0x9F:
            return self.array(code & 0x0F)
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if code in _SIMPLE:
            return _SIMPLE[code]
        if code in _NUMBERS:
            return self.unpack(_NUMBERS[code])
        if code in _LENGTHS:
            kind, fmt = _LENGTHS[code]
            n = self.unpack(fmt)
            if kind == "str":
                return self.text(n)
            if kind == "bin":
                return bytes(self.take(n))
            return self.array(n) if kind == "array" else self.map(n)
        raise ValueError(f"msgpack type byte 0x{code:02x} is not part of "
                         "the checkpoint format")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCB: _F64, 0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
            0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}
_LENGTHS = {0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
            0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
            0xDC: ("array", _U16), 0xDD: ("array", _U32),
            0xDE: ("map", _U16), 0xDF: ("map", _U32)}


def unpackb(data):
    """The object of msgpack bytes (``msgpack.unpackb(data, raw=False)``):
    str as str, bin as bytes, arrays as lists.  Raises ``ValueError`` on a
    type outside the format, on truncated data and on trailing bytes."""
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         "msgpack object")
    return obj
