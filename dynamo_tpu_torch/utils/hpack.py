"""HPACK, the header compression of HTTP/2 (RFC 7541).

The port's own (the card's machine has no ``h2``/``hpack``), for
``utils/http2.py``:

- :class:`Decoder` reads every representation: indexed fields, literals
  with incremental indexing, without indexing and never indexed (each with
  an indexed or a literal name), and dynamic table size updates, which may
  only open a header block and may not exceed the limit this side set
  (``SETTINGS_HEADER_TABLE_SIZE``). It keeps the static table (Appendix A)
  and the dynamic table, evicting entries (32 octets of overhead each) to
  stay within the size, and decodes Huffman-coded strings (Appendix B),
  refusing padding longer than 7 bits, padding that is not the EOS prefix,
  and an EOS symbol in the string. It counts the Huffman-coded strings it
  has read (``huffman_strings``).
- :func:`encode` writes every field as a literal without indexing with a
  literal name and no Huffman coding: the plainest form, which every peer
  must accept, and one that leaves the peer's dynamic table alone.

Header names and values are ``str`` holding one character per octet
(latin-1), so any octets round-trip.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

__all__ = ["HpackError", "Decoder", "encode", "HUFFMAN_CODES",
           "STATIC_TABLE"]

Header = Tuple[str, str]

ENTRY_OVERHEAD = 32
DEFAULT_TABLE_SIZE = 4096


class HpackError(ValueError):
    """A header block that cannot be decoded (HTTP/2 COMPRESSION_ERROR)."""


# Appendix A: the static table, index 1..61
STATIC_TABLE: Tuple[Header, ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
)

# Appendix B: the Huffman code of each symbol 0..255 and EOS (256), as
# (code, length in bits), the code's bits aligned to the right
HUFFMAN_CODES: Tuple[Tuple[int, int], ...] = (
    (0x1ff8, 13), (0x7fffd8, 23), (0xfffffe2, 28), (0xfffffe3, 28),
    (0xfffffe4, 28), (0xfffffe5, 28), (0xfffffe6, 28), (0xfffffe7, 28),
    (0xfffffe8, 28), (0xffffea, 24), (0x3ffffffc, 30), (0xfffffe9, 28),
    (0xfffffea, 28), (0x3ffffffd, 30), (0xfffffeb, 28), (0xfffffec, 28),
    (0xfffffed, 28), (0xfffffee, 28), (0xfffffef, 28), (0xffffff0, 28),
    (0xffffff1, 28), (0xffffff2, 28), (0x3ffffffe, 30), (0xffffff3, 28),
    (0xffffff4, 28), (0xffffff5, 28), (0xffffff6, 28), (0xffffff7, 28),
    (0xffffff8, 28), (0xffffff9, 28), (0xffffffa, 28), (0xffffffb, 28),
    (0x14, 6), (0x3f8, 10), (0x3f9, 10), (0xffa, 12),
    (0x1ff9, 13), (0x15, 6), (0xf8, 8), (0x7fa, 11),
    (0x3fa, 10), (0x3fb, 10), (0xf9, 8), (0x7fb, 11),
    (0xfa, 8), (0x16, 6), (0x17, 6), (0x18, 6),
    (0x0, 5), (0x1, 5), (0x2, 5), (0x19, 6),
    (0x1a, 6), (0x1b, 6), (0x1c, 6), (0x1d, 6),
    (0x1e, 6), (0x1f, 6), (0x5c, 7), (0xfb, 8),
    (0x7ffc, 15), (0x20, 6), (0xffb, 12), (0x3fc, 10),
    (0x1ffa, 13), (0x21, 6), (0x5d, 7), (0x5e, 7),
    (0x5f, 7), (0x60, 7), (0x61, 7), (0x62, 7),
    (0x63, 7), (0x64, 7), (0x65, 7), (0x66, 7),
    (0x67, 7), (0x68, 7), (0x69, 7), (0x6a, 7),
    (0x6b, 7), (0x6c, 7), (0x6d, 7), (0x6e, 7),
    (0x6f, 7), (0x70, 7), (0x71, 7), (0x72, 7),
    (0xfc, 8), (0x73, 7), (0xfd, 8), (0x1ffb, 13),
    (0x7fff0, 19), (0x1ffc, 13), (0x3ffc, 14), (0x22, 6),
    (0x7ffd, 15), (0x3, 5), (0x23, 6), (0x4, 5),
    (0x24, 6), (0x5, 5), (0x25, 6), (0x26, 6),
    (0x27, 6), (0x6, 5), (0x74, 7), (0x75, 7),
    (0x28, 6), (0x29, 6), (0x2a, 6), (0x7, 5),
    (0x2b, 6), (0x76, 7), (0x2c, 6), (0x8, 5),
    (0x9, 5), (0x2d, 6), (0x77, 7), (0x78, 7),
    (0x79, 7), (0x7a, 7), (0x7b, 7), (0x7ffe, 15),
    (0x7fc, 11), (0x3ffd, 14), (0x1ffd, 13), (0xffffffc, 28),
    (0xfffe6, 20), (0x3fffd2, 22), (0xfffe7, 20), (0xfffe8, 20),
    (0x3fffd3, 22), (0x3fffd4, 22), (0x3fffd5, 22), (0x7fffd9, 23),
    (0x3fffd6, 22), (0x7fffda, 23), (0x7fffdb, 23), (0x7fffdc, 23),
    (0x7fffdd, 23), (0x7fffde, 23), (0xffffeb, 24), (0x7fffdf, 23),
    (0xffffec, 24), (0xffffed, 24), (0x3fffd7, 22), (0x7fffe0, 23),
    (0xffffee, 24), (0x7fffe1, 23), (0x7fffe2, 23), (0x7fffe3, 23),
    (0x7fffe4, 23), (0x1fffdc, 21), (0x3fffd8, 22), (0x7fffe5, 23),
    (0x3fffd9, 22), (0x7fffe6, 23), (0x7fffe7, 23), (0xffffef, 24),
    (0x3fffda, 22), (0x1fffdd, 21), (0xfffe9, 20), (0x3fffdb, 22),
    (0x3fffdc, 22), (0x7fffe8, 23), (0x7fffe9, 23), (0x1fffde, 21),
    (0x7fffea, 23), (0x3fffdd, 22), (0x3fffde, 22), (0xfffff0, 24),
    (0x1fffdf, 21), (0x3fffdf, 22), (0x7fffeb, 23), (0x7fffec, 23),
    (0x1fffe0, 21), (0x1fffe1, 21), (0x3fffe0, 22), (0x1fffe2, 21),
    (0x7fffed, 23), (0x3fffe1, 22), (0x7fffee, 23), (0x7fffef, 23),
    (0xfffea, 20), (0x3fffe2, 22), (0x3fffe3, 22), (0x3fffe4, 22),
    (0x7ffff0, 23), (0x3fffe5, 22), (0x3fffe6, 22), (0x7ffff1, 23),
    (0x3ffffe0, 26), (0x3ffffe1, 26), (0xfffeb, 20), (0x7fff1, 19),
    (0x3fffe7, 22), (0x7ffff2, 23), (0x3fffe8, 22), (0x1ffffec, 25),
    (0x3ffffe2, 26), (0x3ffffe3, 26), (0x3ffffe4, 26), (0x7ffffde, 27),
    (0x7ffffdf, 27), (0x3ffffe5, 26), (0xfffff1, 24), (0x1ffffed, 25),
    (0x7fff2, 19), (0x1fffe3, 21), (0x3ffffe6, 26), (0x7ffffe0, 27),
    (0x7ffffe1, 27), (0x3ffffe7, 26), (0x7ffffe2, 27), (0xfffff2, 24),
    (0x1fffe4, 21), (0x1fffe5, 21), (0x3ffffe8, 26), (0x3ffffe9, 26),
    (0xffffffd, 28), (0x7ffffe3, 27), (0x7ffffe4, 27), (0x7ffffe5, 27),
    (0xfffec, 20), (0xfffff3, 24), (0xfffed, 20), (0x1fffe6, 21),
    (0x3fffe9, 22), (0x1fffe7, 21), (0x1fffe8, 21), (0x7ffff3, 23),
    (0x3fffea, 22), (0x3fffeb, 22), (0x1ffffee, 25), (0x1ffffef, 25),
    (0xfffff4, 24), (0xfffff5, 24), (0x3ffffea, 26), (0x7ffff4, 23),
    (0x3ffffeb, 26), (0x7ffffe6, 27), (0x3ffffec, 26), (0x3ffffed, 26),
    (0x7ffffe7, 27), (0x7ffffe8, 27), (0x7ffffe9, 27), (0x7ffffea, 27),
    (0x7ffffeb, 27), (0xffffffe, 28), (0x7ffffec, 27), (0x7ffffed, 27),
    (0x7ffffee, 27), (0x7ffffef, 27), (0x7fffff0, 27), (0x3ffffee, 26),
    (0x3fffffff, 30),
)
EOS = 256
# (length, code) -> symbol
_HUFFMAN_DECODE: Dict[Tuple[int, int], int] = {
    (n, code): sym for sym, (code, n) in enumerate(HUFFMAN_CODES)}
_MIN_BITS = min(n for _, n in HUFFMAN_CODES)
_MAX_BITS = max(n for _, n in HUFFMAN_CODES)


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = n = 0
    table = _HUFFMAN_DECODE
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            if n >= _MIN_BITS:
                sym = table.get((n, code))
                if sym is not None:
                    if sym == EOS:
                        raise HpackError("EOS symbol in a Huffman string")
                    out.append(sym)
                    code = n = 0
                elif n > _MAX_BITS:
                    raise HpackError("invalid Huffman code")
    if n > 7:
        raise HpackError("Huffman padding longer than 7 bits")
    if code != (1 << n) - 1:
        raise HpackError("Huffman padding is not the EOS prefix")
    return bytes(out)


# ------------------------------ primitives ---------------------------------


def encode_int(value: int, prefix_bits: int, flags: int = 0) -> bytes:
    """An integer with an N-bit prefix (5.1); ``flags`` fill the high bits
    of the first octet."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([flags | value])
    out = bytearray([flags | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix_bits: int) -> Tuple[int, int]:
    limit = (1 << prefix_bits) - 1
    if pos >= len(data):
        raise HpackError("truncated integer")
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos
        if shift > 28:
            raise HpackError("integer too large")


def _encode_str(s: str) -> bytes:
    raw = s.encode("latin-1")
    return encode_int(len(raw), 7) + raw


def encode(headers: Sequence[Header]) -> bytes:
    """A header block of literal fields without indexing, literal names,
    no Huffman coding (6.2.2)."""
    return b"".join(b"\x00" + _encode_str(name) + _encode_str(value)
                    for name, value in headers)


# -------------------------------- decoder ----------------------------------


class Decoder:
    """One connection's decoding context: the dynamic table persists from
    one header block to the next."""

    def __init__(self, max_table_size: int = DEFAULT_TABLE_SIZE):
        # the SETTINGS_HEADER_TABLE_SIZE this side advertised: the most a
        # size update may ask for
        self.settings_max = max_table_size
        self.max_size = max_table_size
        self.size = 0
        self.table: List[Header] = []    # newest first
        self.huffman_strings = 0

    def _add(self, name: str, value: str) -> None:
        need = len(name) + len(value) + ENTRY_OVERHEAD
        while self.table and self.size + need > self.max_size:
            old_name, old_value = self.table.pop()
            self.size -= len(old_name) + len(old_value) + ENTRY_OVERHEAD
        if need <= self.max_size:   # larger than the table: it empties
            self.table.insert(0, (name, value))
            self.size += need

    def _resize(self, size: int) -> None:
        if size > self.settings_max:
            raise HpackError(f"table size update {size} above the limit "
                             f"{self.settings_max}")
        self.max_size = size
        while self.size > size:
            old_name, old_value = self.table.pop()
            self.size -= len(old_name) + len(old_value) + ENTRY_OVERHEAD

    def _entry(self, index: int) -> Header:
        if index <= 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.table):
            raise HpackError(f"index {index} beyond the tables")
        return self.table[i]

    def _str(self, data: bytes, pos: int) -> Tuple[str, int]:
        if pos >= len(data):
            raise HpackError("truncated string")
        huffman = data[pos] & 0x80
        n, pos = decode_int(data, pos, 7)
        end = pos + n
        if end > len(data):
            raise HpackError("truncated string")
        raw = data[pos:end]
        if huffman:
            raw = huffman_decode(raw)
            self.huffman_strings += 1
        return raw.decode("latin-1"), end

    def decode(self, data: bytes) -> List[Header]:
        """The header list of one complete header block."""
        out: List[Header] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:                    # 6.1 indexed field
                index, pos = decode_int(data, pos, 7)
                out.append(self._entry(index))
                continue
            if b & 0xE0 == 0x20:            # 6.3 dynamic table size update
                if out:
                    raise HpackError("table size update after a field")
                size, pos = decode_int(data, pos, 5)
                self._resize(size)
                continue
            indexing = b & 0xC0 == 0x40     # 6.2.1, else 6.2.2 / 6.2.3
            index, pos = decode_int(data, pos, 6 if indexing else 4)
            if index:
                name = self._entry(index)[0]
            else:
                name, pos = self._str(data, pos)
            value, pos = self._str(data, pos)
            if indexing:
                self._add(name, value)
            out.append((name, value))
        return out
