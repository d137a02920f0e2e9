"""The port's own MessagePack packer and unpacker for the index envelope.

Covers the subset an index file uses: maps, str, bin, int, float, bool,
nil and arrays (lists and tuples). :func:`packb` writes the same bytes as
``msgpack.packb`` (msgpack >= 1.0, ``use_bin_type=True``): the smallest
encoding of each int (unsigned families for non-negative values), float64
for floats, str8 for short strings, bin for bytes. :func:`unpackb` reads
what ``msgpack.unpackb`` reads with its defaults (str as ``str``, bin as
``bytes``, arrays as lists, map keys str or bytes) and also float32.
Anything outside the subset raises ``TypeError`` (packing) or
``ValueError`` (unpacking), so files written by either package read in
the other and the port needs no ``msgpack`` installed.
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _pack_len(out: list, n: int, fix: int | None, fix_max: int,
              codes: tuple) -> None:
    """Append a length header: fix form when ``n < fix_max``, else the
    8/16/32-bit form (``codes``: their type bytes, None when absent)."""
    if fix is not None and n < fix_max:
        out.append(bytes((fix | n,)))
        return
    c8, c16, c32 = codes
    if c8 is not None and n <= 0xFF:
        out.append(struct.pack(">BB", c8, n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", c16, n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", c32, n))
    else:
        raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(struct.pack("B", v))
    elif -0x20 <= v < 0:
        out.append(struct.pack("b", v))
    elif 0x80 <= v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0xFF < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < -0x80:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise ValueError(f"msgpack: integer {v} out of range")


def _pack(out: list, obj) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` -> MessagePack bytes, equal to ``msgpack.packb(obj)``."""
    out: list = []
    _pack(out, obj)
    return b"".join(out)


def bin_header(n: int) -> bytes:
    """The type byte and length of a bin of ``n`` bytes."""
    out: list = []
    _pack_len(out, n, None, 0, (0xC4, 0xC5, 0xC6))
    return out[0]


def array_header(n: int) -> bytes:
    """The header of an array of ``n`` items (the items follow it)."""
    out: list = []
    _pack_len(out, n, 0x90, 16, (None, 0xDC, 0xDD))
    return out[0]


def map_header(n: int) -> bytes:
    """The header of a map of ``n`` pairs (key, value, key, ... follow)."""
    out: list = []
    _pack_len(out, n, 0x80, 16, (None, 0xDE, 0xDF))
    return out[0]


class _Reader:
    def __init__(self, data, bin_views=False):
        self.buf = memoryview(data)
        self.pos = 0
        self.bin_views = bin_views

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack: truncated data")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# type byte -> struct format of its length field (str, bin, array, map)
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARR = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_NUM = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
        0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}


def _str(r: _Reader, n: int) -> str:
    try:
        return str(r.take(n), "utf-8")
    except UnicodeDecodeError as e:
        raise ValueError(f"msgpack: invalid utf-8 string: {e}") from e


def _unpack(r: _Reader):
    t = r.unpack(">B")
    if t <= 0x7F:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0xA0 <= t <= 0xBF:
        return _str(r, t & 0x1F)
    if 0x90 <= t <= 0x9F:
        return [_unpack(r) for _ in range(t & 0x0F)]
    if 0x80 <= t <= 0x8F:
        return _map(r, t & 0x0F)
    if t == 0xC0:
        return None
    if t == 0xC2:
        return False
    if t == 0xC3:
        return True
    if t in _NUM:
        return r.unpack(_NUM[t])
    if t in _STR:
        return _str(r, r.unpack(_STR[t]))
    if t in _BIN:
        view = r.take(r.unpack(_BIN[t]))
        return view if r.bin_views else bytes(view)
    if t in _ARR:
        return [_unpack(r) for _ in range(r.unpack(_ARR[t]))]
    if t in _MAP:
        return _map(r, r.unpack(_MAP[t]))
    raise ValueError(f"msgpack: type byte 0x{t:02x} is outside the subset")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(
                f"msgpack: map key of type {type(k).__name__} is not "
                "str or bytes")
        out[k] = _unpack(r)
    return out


def unpackb(data, *, bin_views: bool = False) -> object:
    """MessagePack bytes -> the object, as ``msgpack.unpackb(data)`` gives
    it; ``ValueError`` on truncated, trailing or out-of-subset data.
    ``bin_views``: each bin as a read-only ``memoryview`` into ``data``
    instead of a copy."""
    r = _Reader(data, bin_views)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError(
            f"msgpack: {len(r.buf) - r.pos} bytes of extra data")
    return obj
