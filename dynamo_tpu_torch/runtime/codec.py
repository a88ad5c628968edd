"""The wire codec of the store and the transport: MessagePack, written here.

``packb(obj)`` gives exactly the bytes of ``msgpack.packb(obj,
use_bin_type=True)`` and ``unpackb(data)`` the value of
``msgpack.unpackb(data, raw=False)`` (msgpack >= 1.0 defaults) for every
value the runtime puts on the wire, so a process of this package and one of
the JAX package share a store and a transport. Encoding:

- ``None``/``False``/``True`` as nil/false/true; ``int`` in its smallest
  form (positive or negative fixint, then uint8..uint64, int8..int64;
  outside [-2**63, 2**64) ``OverflowError``); ``float`` always float64;
- ``str`` as fixstr/str8/str16/str32 of its UTF-8 bytes; ``bytes``,
  ``bytearray`` and ``memoryview`` as bin8/bin16/bin32;
- ``list`` and ``tuple`` as arrays, ``dict`` as a map in insertion order
  (subclasses of these types pack as their base, as msgpack's do);
- anything else (a numpy or torch scalar among them, ``numpy.float64``
  aside, which is a ``float``) raises ``TypeError``; nesting deeper than
  msgpack's 512 levels raises ``ValueError``.

Decoding gives arrays as ``list``, bin as ``bytes``, and raises
``ValueError`` on truncated input, trailing bytes, a map key that is not
``str`` or ``bytes`` (msgpack's ``strict_map_key``), the reserved byte
``0xc1`` and ext types, which this wire never carries.

The machine this package serves on has no ``msgpack``; the tests hold this
codec against it byte for byte.
"""

from __future__ import annotations

import struct
from typing import Any, Iterator, List, Tuple

__all__ = ["packb", "unpackb", "iter_unpack"]

_NEST_LIMIT = 511        # msgpack's DEFAULT_RECURSE_LIMIT
_UNPACK_DEPTH = 1024

_pack_B = struct.Struct(">B").pack
_pack_BB = struct.Struct(">BB").pack
_pack_Bb = struct.Struct(">Bb").pack
_pack_BH = struct.Struct(">BH").pack
_pack_Bh = struct.Struct(">Bh").pack
_pack_BI = struct.Struct(">BI").pack
_pack_Bi = struct.Struct(">Bi").pack
_pack_BQ = struct.Struct(">BQ").pack
_pack_Bq = struct.Struct(">Bq").pack
_pack_Bd = struct.Struct(">Bd").pack

# one-byte encodings: positive fixint 0..127, negative fixint -32..-1
_FIXINT = {i: bytes([i]) for i in range(128)}
_FIXINT.update({i: bytes([i & 0xFF]) for i in range(-32, 0)})


# ------------------------------- encode ----------------------------------


def _int(o: int) -> bytes:
    b = _FIXINT.get(o)
    if b is not None:
        return b
    if o >= 0:
        if o <= 0xFF:
            return _pack_BB(0xCC, o)
        if o <= 0xFFFF:
            return _pack_BH(0xCD, o)
        if o <= 0xFFFFFFFF:
            return _pack_BI(0xCE, o)
        if o <= 0xFFFFFFFFFFFFFFFF:
            return _pack_BQ(0xCF, o)
    else:
        if o >= -0x80:
            return _pack_Bb(0xD0, o)
        if o >= -0x8000:
            return _pack_Bh(0xD1, o)
        if o >= -0x80000000:
            return _pack_Bi(0xD2, o)
        if o >= -0x8000000000000000:
            return _pack_Bq(0xD3, o)
    raise OverflowError("Integer value out of range")


def _str(o: str) -> bytes:
    raw = o.encode("utf-8")
    n = len(raw)
    if n < 32:
        return _pack_B(0xA0 | n) + raw
    if n <= 0xFF:
        return _pack_BB(0xD9, n) + raw
    if n <= 0xFFFF:
        return _pack_BH(0xDA, n) + raw
    if n <= 0xFFFFFFFF:
        return _pack_BI(0xDB, n) + raw
    raise ValueError("String is too large")


def _bin(o) -> bytes:
    raw = bytes(o)
    n = len(raw)
    if n <= 0xFF:
        return _pack_BB(0xC4, n) + raw
    if n <= 0xFFFF:
        return _pack_BH(0xC5, n) + raw
    if n <= 0xFFFFFFFF:
        return _pack_BI(0xC6, n) + raw
    raise ValueError("Bytes is too large")


def _head(n: int, fix: int, b16: int, what: str) -> bytes:
    if n < 16:
        return _pack_B(fix | n)
    if n <= 0xFFFF:
        return _pack_BH(b16, n)
    if n <= 0xFFFFFFFF:
        return _pack_BI(b16 + 1, n)
    raise ValueError(f"{what} is too large")


def _scalar(o) -> bytes:
    """Encoding of a non-container value (exact types first: the token
    frames hold nothing else)."""
    t = type(o)
    if t is str:
        return _str(o)
    if t is int:
        return _int(o)
    if o is None:
        return b"\xc0"
    if o is True:
        return b"\xc3"
    if o is False:
        return b"\xc2"
    if t is bytes:
        return _bin(o)
    if t is float:
        return _pack_Bd(0xCB, o)
    # subclasses, in msgpack's order of checks
    if isinstance(o, int):
        return _int(int(o))
    if isinstance(o, (bytes, bytearray, memoryview)):
        return _bin(o)
    if isinstance(o, str):
        return _str(str(o))
    if isinstance(o, float):
        return _pack_Bd(0xCB, float(o))
    raise TypeError(f"can not serialize {t.__name__!r} object")


def _pack(o, out: List[bytes], depth: int) -> None:
    if isinstance(o, dict):
        if depth >= _NEST_LIMIT and o:
            raise ValueError("recursion limit exceeded.")
        out.append(_head(len(o), 0x80, 0xDE, "Dict"))
        for k, v in o.items():
            # keys and flat values inline; only nested containers recurse
            out.append(_str(k) if type(k) is str else _scalar_or_pack(
                k, depth))
            if isinstance(v, (dict, list, tuple)):
                _pack(v, out, depth + 1)
            else:
                out.append(_scalar(v))
    elif isinstance(o, (list, tuple)):
        if depth >= _NEST_LIMIT and o:
            raise ValueError("recursion limit exceeded.")
        out.append(_head(len(o), 0x90, 0xDC, "list"))
        for v in o:
            if isinstance(v, (dict, list, tuple)):
                _pack(v, out, depth + 1)
            else:
                out.append(_scalar(v))
    else:
        out.append(_scalar(o))


def _scalar_or_pack(k, depth: int) -> bytes:
    """A map key of any type (msgpack packs whatever it is given)."""
    if isinstance(k, (dict, list, tuple)):
        parts: List[bytes] = []
        _pack(k, parts, depth + 1)
        return b"".join(parts)
    return _scalar(k)


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, byte for byte."""
    out: List[bytes] = []
    _pack(obj, out, 0)
    return b"".join(out)


# ------------------------------- decode ----------------------------------

_unpack_H = struct.Struct(">H").unpack_from
_unpack_I = struct.Struct(">I").unpack_from
_unpack_Q = struct.Struct(">Q").unpack_from
_unpack_b = struct.Struct(">b").unpack_from
_unpack_h = struct.Struct(">h").unpack_from
_unpack_i = struct.Struct(">i").unpack_from
_unpack_q = struct.Struct(">q").unpack_from
_unpack_f = struct.Struct(">f").unpack_from
_unpack_d = struct.Struct(">d").unpack_from


class _Incomplete(ValueError):
    pass


def _need(data: bytes, pos: int, n: int) -> None:
    if pos + n > len(data):
        raise _Incomplete("Unpack failed: incomplete input")


def _length(data: bytes, pos: int, size: int) -> Tuple[int, int]:
    _need(data, pos, size)
    if size == 1:
        return data[pos], pos + 1
    if size == 2:
        return _unpack_H(data, pos)[0], pos + 2
    return _unpack_I(data, pos)[0], pos + 4


def _unpack(data: bytes, pos: int, depth: int) -> Tuple[Any, int]:
    _need(data, pos, 1)
    b = data[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:                       # fixstr
        end = pos + (b & 0x1F)
        _need(data, pos, end - pos)
        return data[pos:end].decode("utf-8"), end
    if 0x90 <= b <= 0x9F:
        return _array(data, pos, b & 0x0F, depth)
    if 0x80 <= b <= 0x8F:
        return _map(data, pos, b & 0x0F, depth)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in (0xC4, 0xC5, 0xC6):                 # bin 8/16/32
        n, pos = _length(data, pos, 1 << (b - 0xC4))
        _need(data, pos, n)
        return data[pos:pos + n], pos + n
    if b in (0xD9, 0xDA, 0xDB):                 # str 8/16/32
        n, pos = _length(data, pos, 1 << (b - 0xD9))
        _need(data, pos, n)
        return data[pos:pos + n].decode("utf-8"), pos + n
    if b == 0xCA:
        _need(data, pos, 4)
        return _unpack_f(data, pos)[0], pos + 4
    if b == 0xCB:
        _need(data, pos, 8)
        return _unpack_d(data, pos)[0], pos + 8
    if 0xCC <= b <= 0xD3:                       # uint/int 8..64
        size = 1 << ((b - 0xCC) & 3)
        _need(data, pos, size)
        fn = (_UINTS if b <= 0xCF else _INTS)[size]
        return fn(data, pos)[0], pos + size
    if b in (0xDC, 0xDD):
        n, pos = _length(data, pos, 2 if b == 0xDC else 4)
        return _array(data, pos, n, depth)
    if b in (0xDE, 0xDF):
        n, pos = _length(data, pos, 2 if b == 0xDE else 4)
        return _map(data, pos, n, depth)
    if b == 0xC1:
        raise ValueError("Unpack failed: reserved byte 0xc1")
    raise ValueError(f"Unpack failed: ext type 0x{b:02x} is not used on "
                     "this wire")


def _u8(data, pos):
    return (data[pos],)


def _i8(data, pos):
    return _unpack_b(data, pos)


_UINTS = {1: _u8, 2: _unpack_H, 4: _unpack_I, 8: _unpack_Q}
_INTS = {1: _i8, 2: _unpack_h, 4: _unpack_i, 8: _unpack_q}


def _array(data: bytes, pos: int, n: int, depth: int):
    if n > len(data) - pos:     # every element takes at least one byte
        raise _Incomplete("Unpack failed: incomplete input")
    if depth >= _UNPACK_DEPTH:
        raise ValueError("Unpack failed: nested too deeply")
    out = []
    append = out.append
    for _ in range(n):
        _need(data, pos, 1)
        b = data[pos]
        if b <= 0x7F:       # positive fixint: inline
            append(b)
            pos += 1
        else:
            v, pos = _unpack(data, pos, depth + 1)
            append(v)
    return out, pos


def _map(data: bytes, pos: int, n: int, depth: int):
    if 2 * n > len(data) - pos:
        raise _Incomplete("Unpack failed: incomplete input")
    if depth >= _UNPACK_DEPTH:
        raise ValueError("Unpack failed: nested too deeply")
    out = {}
    for _ in range(n):
        _need(data, pos, 1)
        b = data[pos]
        if 0xA0 <= b <= 0xBF:                   # fixstr key: inline
            end = pos + 1 + (b & 0x1F)
            _need(data, pos + 1, end - pos - 1)
            k = data[pos + 1:end].decode("utf-8")
            pos = end
        else:
            k, pos = _unpack(data, pos, depth + 1)
            if type(k) is not str and type(k) is not bytes:
                raise ValueError(f"{type(k).__name__} is not allowed for "
                                 "map key when strict_map_key=True")
        _need(data, pos, 1)
        b = data[pos]
        if b <= 0x7F:                           # flat values: inline
            out[k] = b
            pos += 1
        elif b == 0xC0 or b == 0xC2 or b == 0xC3:
            out[k] = _CONSTS[b]
            pos += 1
        else:
            out[k], pos = _unpack(data, pos, depth + 1)
    return out, pos


_CONSTS = {0xC0: None, 0xC2: False, 0xC3: True}


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False)``: exactly one value."""
    data = bytes(data)
    obj, pos = _unpack(data, 0, 0)
    if pos != len(data):
        raise ValueError("unpack(b) received extra data.")
    return obj


def iter_unpack(data) -> Iterator[Any]:
    """The values of a stream of concatenated encodings, in order (what
    ``msgpack.Unpacker`` yields); a truncated or corrupt tail raises
    ``ValueError`` after the values before it."""
    data = bytes(data)
    pos = 0
    while pos < len(data):
        obj, pos = _unpack(data, pos, 0)
        yield obj
