"""The port's HPACK (``utils/hpack.py``, RFC 7541): the Huffman table is a
complete prefix code over 257 symbols, the examples of Appendix C.2-C.6
decode to their header lists with the dynamic table's entries and size
after each block, and blocks made by an independent encoder (every
representation, Huffman-coded or not, with evictions and size updates)
and by the port's own encoder round-trip under hypothesis."""

from fractions import Fraction

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu_torch.utils import hpack

DATE1 = "Mon, 21 Oct 2013 20:13:21 GMT"
DATE2 = "Mon, 21 Oct 2013 20:13:22 GMT"
COOKIE = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
AUTH = (":authority", "www.example.com")
REQ_1 = [(":method", "GET"), (":scheme", "http"), (":path", "/"), AUTH]
REQ_2 = REQ_1 + [("cache-control", "no-cache")]
REQ_3 = [(":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
         AUTH, ("custom-key", "custom-value")]
RESP_1 = [(":status", "302"), ("cache-control", "private"),
          ("date", DATE1), ("location", "https://www.example.com")]
RESP_2 = [(":status", "307")] + RESP_1[1:]
RESP_3 = [(":status", "200"), ("cache-control", "private"),
          ("date", DATE2), ("location", "https://www.example.com"),
          ("content-encoding", "gzip"), ("set-cookie", COOKIE)]

# (hex of each block, its header list, the dynamic table after it, newest
# first, and the table's size), one decoder per sequence
REQUESTS = [
    (REQ_1, [AUTH], 57),
    (REQ_2, [("cache-control", "no-cache"), AUTH], 110),
    (REQ_3, [("custom-key", "custom-value"), ("cache-control", "no-cache"),
             AUTH], 164),
]
RESPONSES = [
    (RESP_1, [("location", "https://www.example.com"), ("date", DATE1),
              ("cache-control", "private"), (":status", "302")], 222),
    (RESP_2, [(":status", "307"), ("location", "https://www.example.com"),
              ("date", DATE1), ("cache-control", "private")], 222),
    (RESP_3, [("set-cookie", COOKIE), ("content-encoding", "gzip"),
              ("date", DATE2)], 215),
]
APPENDIX_C = {
    "C.3": (4096, REQUESTS, [
        "828684410f7777772e6578616d706c652e636f6d",
        "828684be58086e6f2d6361636865",
        "828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565"]),
    "C.4": (4096, REQUESTS, [
        "828684418cf1e3c2e5f23a6ba0ab90f4ff",
        "828684be5886a8eb10649cbf",
        "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf"]),
    "C.5": (256, RESPONSES, [
        "4803333032580770726976617465611d4d6f6e2c203231204f637420323031332"
        "032303a31333a323120474d546e1768747470733a2f2f7777772e6578616d706c"
        "652e636f6d",
        "4803333037c1c0bf",
        "88c1611d4d6f6e2c203231204f637420323031332032303a31333a323220474d5"
        "4c05a04677a69707738666f6f3d4153444a4b48514b425a584f5157454f504955"
        "41585157454f49553b206d61782d6167653d333630303b2076657273696f6e3d31"
        ]),
    "C.6": (256, RESPONSES, [
        "488264025885aec3771a4b6196d07abe941054d444a8200595040b8166e082a62"
        "d1bff6e919d29ad171863c78f0b97c8e9ae82ae43d3",
        "4883640effc1c0bf",
        "88c16196d07abe941054d444a8200595040b8166e084a62d1bffc05a839bd9ab7"
        "7ad94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f95"
        "87316065c003ed4ee5b1063d5007"]),
}


def test_huffman_table_is_a_complete_prefix_code():
    codes = hpack.HUFFMAN_CODES
    assert len(codes) == 257
    assert sum(Fraction(1, 2 ** n) for _, n in codes) == 1
    bits = sorted(format(c, f"0{n}b") for c, n in codes)
    assert all(c < 1 << n for c, n in codes)
    assert not any(b.startswith(a) for a, b in zip(bits, bits[1:]))
    assert codes[hpack.EOS] == (2 ** 30 - 1, 30)
    # canonical: codes follow (length, symbol) order
    order = sorted(range(257), key=lambda s: (codes[s][1], s))
    assert [format(codes[s][0], f"0{codes[s][1]}b") for s in order] == bits


@pytest.mark.parametrize("block,want,table", [
    ("400a637573746f6d2d6b65790d637573746f6d2d686561646572",
     [("custom-key", "custom-header")], [("custom-key", "custom-header")]),
    ("040c2f73616d706c652f70617468", [(":path", "/sample/path")], []),
    ("100870617373776f726406736563726574", [("password", "secret")], []),
    ("82", [(":method", "GET")], []),
], ids=["C.2.1", "C.2.2", "C.2.3", "C.2.4"])
def test_appendix_c2(block, want, table):
    dec = hpack.Decoder()
    assert dec.decode(bytes.fromhex(block)) == want
    assert dec.table == table
    assert dec.size == sum(len(n) + len(v) + 32 for n, v in table)


@pytest.mark.parametrize("example", sorted(APPENDIX_C))
def test_appendix_c3_to_c6(example):
    size, steps, blocks = APPENDIX_C[example]
    dec = hpack.Decoder(max_table_size=size)
    for block, (want, table, table_size) in zip(blocks, steps):
        assert dec.decode(bytes.fromhex(block)) == want
        assert dec.table == table
        assert dec.size == table_size
    assert (dec.huffman_strings > 0) == (example in ("C.4", "C.6"))


def huffman_encode(raw: bytes) -> bytes:
    acc = n = 0
    for b in raw:
        code, bits = hpack.HUFFMAN_CODES[b]
        acc, n = (acc << bits) | code, n + bits
    pad = -n % 8
    acc, n = (acc << pad) | ((1 << pad) - 1), n + pad
    return acc.to_bytes(n // 8, "big")


def enc_str(s: str, huffman: bool) -> bytes:
    raw = s.encode("latin-1")
    if huffman:
        raw = huffman_encode(raw)
        return hpack.encode_int(len(raw), 7, 0x80) + raw
    return hpack.encode_int(len(raw), 7) + raw


class ModelEncoder:
    """An encoder written from RFC 7541 section 6 alone, with its own copy
    of the dynamic table, as a peer's would be."""

    def __init__(self, size: int):
        self.size = size
        self.table = []

    def _evict(self):
        while sum(len(n) + len(v) + 32 for n, v in self.table) > self.size:
            self.table.pop()

    def block(self, ops) -> bytes:
        out = b""
        for op in ops:
            kind = op[0]
            if kind == "resize":
                self.size = op[1]
                self._evict()
                out += hpack.encode_int(op[1], 5, 0x20)
                continue
            name, value, huffman = op[1], op[2], op[3]
            full = [i for i, e in enumerate(hpack.STATIC_TABLE
                                            + tuple(self.table))
                    if e == (name, value)]
            named = [i for i, e in enumerate(hpack.STATIC_TABLE
                                             + tuple(self.table))
                     if e[0] == name]
            if kind == "indexed" and full:
                out += hpack.encode_int(full[0] + 1, 7, 0x80)
                continue
            prefix, flags = {"indexed": (6, 0x40), "incremental": (6, 0x40),
                             "without": (4, 0x00), "never": (4, 0x10)}[kind]
            if named:
                out += hpack.encode_int(named[0] + 1, prefix, flags)
            else:
                out += bytes([flags]) + enc_str(name, huffman)
            out += enc_str(value, huffman)
            if flags == 0x40:
                self.table.insert(0, (name, value))
                self._evict()
        return out


NAMES = st.sampled_from([":path", "content-type", "x-a", "x-b", "grpc-status",
                         "custom-key", "user-agent"])
VALUES = st.text(st.characters(max_codepoint=255), max_size=40)
OPS = st.lists(st.one_of(
    st.tuples(st.sampled_from(["indexed", "incremental", "without",
                               "never"]), NAMES, VALUES, st.booleans()),
), min_size=1, max_size=8)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.one_of(st.none(), st.integers(0, 4096)), OPS),
                min_size=1, max_size=6))
def test_blocks_of_an_independent_encoder_decode(blocks):
    dec = hpack.Decoder(max_table_size=4096)
    enc = ModelEncoder(4096)
    for resize, ops in blocks:
        pre = [("resize", resize)] if resize is not None else []
        raw = enc.block(pre + list(ops))
        want = [(o[1], o[2]) for o in ops]
        assert dec.decode(raw) == want
        assert dec.table == enc.table


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.text(st.characters(max_codepoint=255),
                                  max_size=20), VALUES), max_size=10))
def test_the_port_encoder_round_trips(headers):
    dec = hpack.Decoder()
    assert dec.decode(hpack.encode(headers)) == headers
    assert dec.table == [] and dec.huffman_strings == 0


@settings(max_examples=300, deadline=None)
@given(st.binary(max_size=64))
def test_huffman_strings_round_trip(raw):
    assert hpack.huffman_decode(huffman_encode(raw)) == raw


@pytest.mark.parametrize("block,why", [
    (bytes([0x80]), "index 0"),
    (hpack.encode_int(62, 7, 0x80), "beyond"),
    (hpack.encode_int(4097, 5, 0x20), "above the limit"),
    (bytes([0x82]) + hpack.encode_int(0, 5, 0x20), "after a field"),
    # "a" (00011) then 11 one-bits of padding
    (bytes([0x00, 0x82, 0x1F, 0xFF, 0x00]), "longer than 7 bits"),
    # "a" then 000: padding that is not the EOS prefix
    (bytes([0x00, 0x81, 0x18, 0x00]), "not the EOS prefix"),
    # EOS (30 one-bits) inside a string
    (bytes([0x00, 0x84, 0xFF, 0xFF, 0xFF, 0xFF, 0x00]), "EOS symbol"),
    (bytes([0x00, 0x05, 0x61]), "truncated"),
])
def test_bad_blocks_raise(block, why):
    with pytest.raises(hpack.HpackError, match=why):
        hpack.Decoder().decode(block)
