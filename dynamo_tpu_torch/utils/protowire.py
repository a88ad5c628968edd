"""Protocol buffers' wire format (proto3) for messages described by small
schema tables.

The port's stand-in for ``google.protobuf`` (which the card's machine does
not install) on the KServe gRPC path: a message is a :class:`Message`
subclass whose ``FIELDS`` table lists its fields, and ``encode``/``decode``
turn it into bytes and back. What the codec does on the wire:

- varints, with ``int32``/``int64`` negatives as ten-byte two's complement
  (an ``int32`` is sign-extended to 64 bits, as protobuf writes it), and
  ``uint32``/``uint64``/``bool``;
- ``float`` and ``double`` as little-endian fixed32/fixed64;
- ``string`` (UTF-8), ``bytes`` and sub-messages as length-delimited fields;
- repeated scalars: decoding takes packed and unpacked runs alike, encoding
  packs them, as proto3 does; repeated strings, bytes and messages are one
  field each;
- maps, as repeated entry messages with the key in field 1 and the value in
  field 2 (an entry may omit either: the default stands in);
- oneofs: setting a member clears its siblings, and a set member is written
  even when it holds its default (proto3 presence), unlike a plain scalar,
  which is written only when it differs from its default;
- a singular sub-message that appears twice is merged, the last scalar
  wins, and fields this schema does not know (or that arrive with another
  wire type than their schema's) are skipped, groups included.

A sub-message field that was never set reads ``None``; a repeated field is a
list and a map a dict.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, FrozenSet, NamedTuple, Optional, Tuple

__all__ = ["DecodeError", "Field", "Message", "field", "map_field"]

VARINT, I64, LEN, SGROUP, EGROUP, I32 = 0, 1, 2, 3, 4, 5

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

# type -> (wire type, default)
_SCALARS = {
    "int32": (VARINT, 0), "int64": (VARINT, 0), "uint32": (VARINT, 0),
    "uint64": (VARINT, 0), "bool": (VARINT, False), "float": (I32, 0.0),
    "double": (I64, 0.0), "string": (LEN, ""), "bytes": (LEN, b""),
}
_PACKABLE = {t for t, (w, _) in _SCALARS.items() if w != LEN}
_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


class DecodeError(ValueError):
    """The bytes are not a valid encoding of the message."""


class Field(NamedTuple):
    number: int
    name: str
    type: str                   # a scalar type, "message" or "map"
    repeated: bool = False
    message: Any = None         # the Message class of "message" / map values
    oneof: Optional[str] = None
    key: Optional[str] = None   # a map's key type
    value: Optional[str] = None  # a map's value type ("message" or scalar)


def field(number: int, name: str, type_: str, *, repeated: bool = False,
          message=None, oneof: Optional[str] = None) -> Field:
    return Field(number, name, type_, repeated, message, oneof)


def map_field(number: int, name: str, key: str, value: str,
              message=None) -> Field:
    return Field(number, name, "map", False, message, None, key, value)


# ------------------------------- varints -----------------------------------


def encode_varint(v: int) -> bytes:
    v &= _M64
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def decode_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _M64, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _from_varint(type_: str, v: int):
    if type_ == "int64":
        return _signed(v, 64)
    if type_ == "int32":
        return _signed(v, 32)
    if type_ == "uint32":
        return v & _M32
    if type_ == "bool":
        return v != 0
    return v


def _encode_scalar(type_: str, v) -> bytes:
    """A scalar's payload, without its tag (strings and bytes without
    their length)."""
    if type_ == "float":
        return _F32.pack(v)
    if type_ == "double":
        return _F64.pack(v)
    if type_ == "string":
        return v.encode("utf-8")
    if type_ == "bytes":
        return bytes(v)
    return encode_varint(int(v))


def _tag(number: int, wire: int) -> bytes:
    return encode_varint((number << 3) | wire)


def _len_field(number: int, payload: bytes) -> bytes:
    return _tag(number, LEN) + encode_varint(len(payload)) + payload


def _skip(buf, pos: int, wire: int, number: int) -> int:
    if wire == VARINT:
        return decode_varint(buf, pos)[1]
    if wire == I64:
        pos += 8
    elif wire == I32:
        pos += 4
    elif wire == LEN:
        n, pos = decode_varint(buf, pos)
        pos += n
    elif wire == SGROUP:
        while True:
            tag, pos = decode_varint(buf, pos)
            if tag & 7 == EGROUP:
                if tag >> 3 != number:
                    raise DecodeError("mismatched end of group")
                return pos
            pos = _skip(buf, pos, tag & 7, tag >> 3)
    else:
        raise DecodeError(f"wire type {wire} out of place")
    if pos > len(buf):
        raise DecodeError("truncated field")
    return pos


def _read_scalar(type_: str, wire: int, buf, pos: int):
    """One scalar of ``type_`` at ``pos`` (its wire type already checked)."""
    if wire == VARINT:
        v, pos = decode_varint(buf, pos)
        return _from_varint(type_, v), pos
    if wire == I32:
        if pos + 4 > len(buf):
            raise DecodeError("truncated fixed32")
        return _F32.unpack_from(buf, pos)[0], pos + 4
    if wire == I64:
        if pos + 8 > len(buf):
            raise DecodeError("truncated fixed64")
        return _F64.unpack_from(buf, pos)[0], pos + 8
    n, pos = decode_varint(buf, pos)
    end = pos + n
    if end > len(buf):
        raise DecodeError("truncated length-delimited field")
    raw = bytes(buf[pos:end])
    if type_ == "string":
        try:
            return raw.decode("utf-8"), end
        except UnicodeDecodeError as e:
            raise DecodeError(f"invalid UTF-8 in a string field: {e}") \
                from None
    return raw, end


# ------------------------------- messages ----------------------------------


class Message:
    """A proto3 message; subclasses set ``FIELDS`` (a sequence of
    :class:`Field`). Keyword arguments set fields by name."""

    FIELDS: Tuple[Field, ...] = ()
    _by_number: Dict[int, Field]
    _names: FrozenSet[str]
    _oneofs: Dict[str, Tuple[str, ...]]
    _oneof_of: Dict[str, str]

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._finish_schema()

    @classmethod
    def _finish_schema(cls) -> None:
        cls._by_number = {f.number: f for f in cls.FIELDS}
        cls._names = frozenset(f.name for f in cls.FIELDS)
        cls._oneofs = {}
        for f in cls.FIELDS:
            if f.oneof:
                cls._oneofs.setdefault(f.oneof, ())
                cls._oneofs[f.oneof] += (f.name,)
        cls._oneof_of = {f.name: f.oneof for f in cls.FIELDS if f.oneof}

    def __init__(self, **values):
        for f in self.FIELDS:
            object.__setattr__(self, f.name, _default(f))
        for name, v in values.items():
            if name not in self._names:
                raise TypeError(f"{type(self).__name__} has no field "
                                f"{name!r}")
            setattr(self, name, v)

    def __setattr__(self, name: str, value) -> None:
        group = self._oneof_of.get(name)
        if group is not None and value is not None:
            for sibling in self._oneofs[group]:
                object.__setattr__(self, sibling, None)
        object.__setattr__(self, name, value)

    def which_oneof(self, group: str) -> Optional[str]:
        """The set member of oneof ``group``, or None."""
        for name in self._oneofs[group]:
            if getattr(self, name) is not None:
                return name
        return None

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and all(
            getattr(self, f.name) == getattr(other, f.name)
            for f in self.FIELDS)

    def __repr__(self) -> str:
        parts = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if v != _default(f):
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    # ------------------------------ encode ---------------------------------

    def encode(self) -> bytes:
        out = []
        for f in self.FIELDS:
            v = getattr(self, f.name)
            if f.type == "map":
                for k, val in v.items():
                    entry = _encode_one(1, f.key, k) + (
                        _len_field(2, val.encode()) if f.value == "message"
                        else _encode_one(2, f.value, val))
                    out.append(_len_field(f.number, entry))
            elif f.type == "message":
                if f.repeated:
                    out.extend(_len_field(f.number, m.encode()) for m in v)
                elif v is not None:
                    out.append(_len_field(f.number, v.encode()))
            elif f.repeated:
                if not v:
                    continue
                if f.type in _PACKABLE:
                    out.append(_len_field(f.number, b"".join(
                        _encode_scalar(f.type, x) for x in v)))
                else:
                    out.extend(_encode_one(f.number, f.type, x) for x in v)
            elif f.oneof:
                if v is not None:
                    out.append(_encode_one(f.number, f.type, v))
            elif v != _SCALARS[f.type][1]:
                out.append(_encode_one(f.number, f.type, v))
        return b"".join(out)

    # ------------------------------ decode ---------------------------------

    @classmethod
    def decode(cls, data) -> "Message":
        msg = cls()
        data = bytes(data)
        msg._merge(data, 0, len(data))
        return msg

    def _merge(self, buf, pos: int, end: int) -> None:
        by_number = self._by_number
        while pos < end:
            tag, pos = decode_varint(buf, pos)
            number, wire = tag >> 3, tag & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = by_number.get(number)
            if f is None or not _wire_fits(f, wire):
                pos = _skip(buf, pos, wire, number)
            elif f.type in ("message", "map"):
                n, pos = decode_varint(buf, pos)
                sub_end = pos + n
                if sub_end > end:
                    raise DecodeError("truncated sub-message")
                if f.type == "map":
                    k, v = _decode_entry(f, buf, pos, sub_end)
                    getattr(self, f.name)[k] = v
                elif f.repeated:
                    sub = f.message()
                    sub._merge(buf, pos, sub_end)
                    getattr(self, f.name).append(sub)
                else:
                    sub = getattr(self, f.name)
                    if sub is None:
                        sub = f.message()
                    sub._merge(buf, pos, sub_end)
                    setattr(self, f.name, sub)
                pos = sub_end
            elif f.repeated and wire == LEN and f.type in _PACKABLE:
                n, pos = decode_varint(buf, pos)
                run_end = pos + n
                if run_end > end:
                    raise DecodeError("truncated packed field")
                out = getattr(self, f.name)
                own = _SCALARS[f.type][0]
                while pos < run_end:
                    v, pos = _read_scalar(f.type, own, buf, pos)
                    out.append(v)
                if pos != run_end:
                    raise DecodeError("packed field overruns its length")
            else:
                v, pos = _read_scalar(f.type, wire, buf, pos)
                if f.repeated:
                    getattr(self, f.name).append(v)
                else:
                    setattr(self, f.name, v)
        if pos != end:
            raise DecodeError("field overruns the message")


def _default(f: Field):
    if f.type == "map":
        return {}
    if f.repeated:
        return []
    if f.type == "message" or f.oneof:
        return None
    return _SCALARS[f.type][1]


def _encode_one(number: int, type_: str, v) -> bytes:
    wire = _SCALARS[type_][0]
    payload = _encode_scalar(type_, v)
    if wire == LEN:
        return _len_field(number, payload)
    return _tag(number, wire) + payload


def _wire_fits(f: Field, wire: int) -> bool:
    if f.type in ("message", "map"):
        return wire == LEN
    own = _SCALARS[f.type][0]
    return wire == own or (f.repeated and wire == LEN and f.type in _PACKABLE)


def _decode_entry(f: Field, buf, pos: int, end: int):
    key = _SCALARS[f.key][1]
    value = None
    while pos < end:
        tag, pos = decode_varint(buf, pos)
        number, wire = tag >> 3, tag & 7
        if number == 1 and wire == _SCALARS[f.key][0]:
            key, pos = _read_scalar(f.key, wire, buf, pos)
        elif number == 2 and f.value == "message" and wire == LEN:
            n, pos = decode_varint(buf, pos)
            if pos + n > end:
                raise DecodeError("truncated map value")
            if value is None:
                value = f.message()
            value._merge(buf, pos, pos + n)
            pos += n
        elif number == 2 and f.value != "message" \
                and wire == _SCALARS[f.value][0]:
            value, pos = _read_scalar(f.value, wire, buf, pos)
        else:
            pos = _skip(buf, pos, wire, number)
    if pos != end:
        raise DecodeError("map entry overruns its length")
    if value is None:
        value = f.message() if f.value == "message" \
            else _SCALARS[f.value][1]
    return key, value
