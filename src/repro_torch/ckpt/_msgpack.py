"""A pure-Python reader and writer for the msgpack subset checkpoints use.

The checkpoint format (``repro_torch.ckpt.checkpoint``) is msgpack: nested
maps and arrays of nil, bool, int, float, str and bin. This module encodes
exactly that subset, byte for byte as ``msgpack.packb(obj,
use_bin_type=True)`` does, and decodes what such a writer produces, so
both packages read each other's files without the ``msgpack`` package:

* an int takes its smallest form: positive or negative fixint, then
  uint8/16/32/64 (non-negative) or int8/16/32/64 (negative);
* a float is float64 (``0xcb``), msgpack-python's default;
* ``str`` is fixstr, str8, str16 or str32 by its UTF-8 length, and
  ``bytes``/``bytearray``/``memoryview`` are bin8, bin16 or bin32;
* a list or tuple is an array and a dict a map, in their fix forms below
  16 entries, then 16-bit below 65,536 entries, then 32-bit.

``bool`` is checked before ``int`` (it is a subclass). The writer returns
its output as a list of chunks (:func:`pack_chunks`), so an array's bytes,
passed in as a ``memoryview``, are copied once, into the file; the reader
slices one ``memoryview`` of the payload, and can hand a bin back as a
slice of it (``bin_views``) so its bytes are copied once, into the array.
"""
from __future__ import annotations

import struct
from typing import Any, List

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")
_F64 = struct.Struct(">d")


class UnpackError(ValueError):
    """The bytes are not a complete msgpack value of the supported subset."""


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return _I8.pack(n)
    if n >= 0:
        for tag, s, top in ((0xCC, _U8, 0xFF), (0xCD, _U16, 0xFFFF),
                            (0xCE, _U32, 0xFFFFFFFF),
                            (0xCF, _U64, 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                return bytes((tag,)) + s.pack(n)
    else:
        for tag, s, low in ((0xD0, _I8, -0x80), (0xD1, _I16, -0x8000),
                            (0xD2, _I32, -0x80000000),
                            (0xD3, _I64, -0x8000000000000000)):
            if n >= low:
                return bytes((tag,)) + s.pack(n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, tags) -> bytes:
    """The length header of a str/bin/array/map of ``n`` items or bytes:
    the fix form (``fix | n``) below ``fix_max``, else the 8-, 16- or
    32-bit form from ``tags`` (``None`` where the type has no such form)."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for tag, s, top in zip(tags, (_U8, _U16, _U32),
                           (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            return bytes((tag,)) + s.pack(n)
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _pack(obj: Any, out: List) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_header(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB)))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = obj.nbytes if isinstance(obj, memoryview) else len(obj)
        out.append(_header(n, None, 0, (0xC4, 0xC5, 0xC6)))
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD)))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF)))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack an object of type {type(obj)}")


def pack_chunks(obj: Any) -> List:
    """The encoding of ``obj`` as a list of ``bytes``/``memoryview``
    chunks, in order (their concatenation is :func:`packb`'s output)."""
    out: List = []
    _pack(obj, out)
    return out


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the supported subset."""
    return b"".join(pack_chunks(obj))


class _Reader:
    __slots__ = ("buf", "pos", "bin_views")

    def __init__(self, buf: memoryview, bin_views: bool):
        self.buf = buf
        self.pos = 0
        self.bin_views = bin_views

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise UnpackError(f"truncated: {n} bytes wanted at offset "
                              f"{self.pos}, {len(self.buf) - self.pos} left")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def num(self, s: struct.Struct):
        return s.unpack(self.take(s.size))[0]

    def value(self) -> Any:
        b = self.num(_U8)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SIZED:
            kind, s = _SIZED[b]
            return getattr(self, kind)(self.num(s))
        if b in _NUMS:
            return self.num(_NUMS[b])
        raise UnpackError(f"unsupported msgpack type byte 0x{b:02x} at "
                          f"offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def bin(self, n: int):
        view = self.take(n)
        return view if self.bin_views else bytes(view)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


_SIZED = {0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
          0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
          0xDC: ("array", _U16), 0xDD: ("array", _U32),
          0xDE: ("map", _U16), 0xDF: ("map", _U32)}
_NUMS = {0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: _U64,
         0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64, 0xCB: _F64}


def unpackb(raw, bin_views: bool = False) -> Any:
    """``msgpack.unpackb(raw, raw=False, strict_map_key=False)`` for the
    supported subset: arrays come back as lists, bin as ``bytes`` (with
    ``bin_views``, as ``memoryview`` slices of ``raw``, uncopied). Raises
    :class:`UnpackError` on truncated input, an unsupported type byte or
    bytes left after the value."""
    r = _Reader(memoryview(raw).cast("B"), bin_views)
    try:
        obj = r.value()
    except UnicodeDecodeError as e:
        raise UnpackError(f"invalid UTF-8 in a str: {e}") from e
    if r.pos != len(r.buf):
        raise UnpackError(f"{len(r.buf) - r.pos} bytes of extra data after "
                          "the value")
    return obj
