"""The port's MessagePack codec (``dynamo_tpu_torch.runtime.codec``) against
``msgpack`` itself: ``packb`` gives exactly the bytes of
``msgpack.packb(obj, use_bin_type=True)`` and ``unpackb`` the value of
``msgpack.unpackb(data, raw=False)``, on hypothesis-generated values, at
every length and integer boundary of the format, and on every frame shape
the store and the transport write. Refusals match too: a map key that is
not ``str``/``bytes``, a numpy or torch scalar, an integer out of range,
truncated input, trailing bytes, nesting past the limit."""

import math

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu_torch.runtime import codec


def ref_pack(obj):
    return msgpack.packb(obj, use_bin_type=True)


def ref_unpack(data):
    return msgpack.unpackb(data, raw=False)


INTS = st.one_of(
    st.integers(-2 ** 63, 2 ** 64 - 1),
    st.sampled_from([0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                     2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
                     -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]),
)
SCALARS = st.one_of(
    st.none(), st.booleans(), INTS,
    st.floats(allow_nan=False), st.text(), st.binary(),
)
# maps with str keys (what the runtime writes), bytes keys now and then
KEYS = st.one_of(st.text(max_size=20), st.binary(max_size=8))
VALUES = st.recursive(
    SCALARS,
    lambda inner: st.one_of(
        st.lists(inner, max_size=20),
        st.lists(inner, max_size=20).map(tuple),
        st.dictionaries(KEYS, inner, max_size=20),
    ),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(VALUES)
def test_pack_is_byte_equal_to_msgpack(value):
    assert codec.packb(value) == ref_pack(value)


@settings(max_examples=300, deadline=None)
@given(VALUES)
def test_unpack_equals_msgpack_on_msgpack_bytes(value):
    data = ref_pack(value)
    assert codec.unpackb(data) == ref_unpack(data)


@settings(max_examples=100, deadline=None)
@given(st.floats(width=32) | st.floats())
def test_floats_including_nan_and_float32_input(x):
    assert codec.packb(x) == ref_pack(x)
    data = msgpack.packb(x, use_single_float=True)    # 0xca on the wire
    got, want = codec.unpackb(data), ref_unpack(data)
    assert (math.isnan(got) and math.isnan(want)) or got == want


@pytest.mark.parametrize("n", [0, 1, 15, 16, 31, 32, 255, 256, 65535,
                               65536, 70000])
@pytest.mark.parametrize("kind", ["str", "bin", "list", "tuple", "dict"])
def test_length_boundaries(kind, n):
    value = {
        "str": "x" * n,
        "bin": b"\x01" * n,
        "list": [1] * n,
        "tuple": (None,) * n,
        "dict": {f"k{i}": i for i in range(n)},
    }[kind]
    data = codec.packb(value)
    assert data == ref_pack(value)
    assert codec.unpackb(data) == ref_unpack(data)


def test_str_of_multibyte_characters_counts_utf8_bytes():
    for text in ["é" * 16, "中" * 11, "🙂" * 8, "a\x00b"]:
        assert codec.packb(text) == ref_pack(text)
        assert codec.unpackb(ref_pack(text)) == text


def test_subclasses_pack_as_their_base():
    import enum

    class Color(enum.IntEnum):
        RED = 300

    class S(str):
        pass

    class D(dict):
        pass
    for value in [Color.RED, S("abc"), D(a=1), bytearray(b"xy"),
                  memoryview(b"zz"), np.float64(1.5), [Color.RED, S("q")]]:
        assert codec.packb(value) == ref_pack(value)


# every frame shape the store and the transport put on the wire
FRAMES = [
    {"op": "put", "key": "v1/instances/ns/c/e/123", "value": b"\x81\xa1a\x01",
     "lease": 7, "seq": 1},
    {"op": "cas", "key": "k", "expect": None, "value": b"v", "lease": 0,
     "seq": 2},
    {"seq": 3, "ok": True, "kvs": [["k", b"v", 0, 4]], "rev": 9},
    {"seq": 4, "ok": False, "error": "conflict", "value": None},
    {"seq": 5, "ok": True, "watch_id": 2 ** 46 + 5, "caught_up": True,
     "events": [{"event": "put", "key": "k", "value": b"v", "rev": 10}],
     "rev": 10, "incarnation": "0123456789abcdef0123456789abcdef"},
    {"seq": None, "watch_id": 11, "event": "delete", "key": "k",
     "value": None, "rev": 12},
    {"seq": None, "watch_id": 11, "event": "msg", "key": "v1/events/x/",
     "value": b"\x00" * 300, "rev": 0},
    {"op": "lease_grant", "ttl": 2.0, "seq": 6},
    {"seq": 6, "ok": True, "lease": 1761000000 << 16, "ttl": 10.0},
    {"op": "q_pop", "queue": "prefill_queue", "timeout": 30.0, "seq": 7},
    {"header": {"revision": 42, "format": 2}},
    {"kv": ["v1/mdc/m", b"\x00\xff" * 40]},
    {"q": ["prefill_queue", [b"a", b"bb"]]},
    {"eof": True},
    {"t": "req", "rid": "abc-1", "headers": {
        "traceparent": "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
        "x-request-id": "abc", "x-deadline-ms": 599999},
     "payload": ref_pack({"token_ids": list(range(600)), "max_tokens": 64,
                          "temperature": 0.0, "top_p": 1.0, "seed": None,
                          "eos_token_ids": [1, 2], "ignore_eos": True})},
    {"t": "cancel", "rid": "abc-1", "kill": False},
    {"t": "data", "rid": "abc-1", "payload": ref_pack({
        "token_ids": [128000], "index": 63, "finished": True,
        "finish_reason": "length", "num_prompt_tokens": 512})},
    {"t": "end", "rid": "abc-1"},
    {"t": "err", "rid": "abc-1", "error": "draining", "code": "draining"},
    {"t": "ping"}, {"t": "pong"},
]


@pytest.mark.parametrize("frame", FRAMES,
                         ids=lambda f: str(f.get("t") or f.get("op")
                                           or next(iter(f))))
def test_wire_frames(frame):
    data = codec.packb(frame)
    assert data == ref_pack(frame)
    assert codec.unpackb(data) == ref_unpack(data)


@pytest.mark.parametrize("data", [
    b"\x81\x01\x02",            # int key
    b"\x81\xc0\x01",            # nil key
    b"\x81\x92\x01\x02\x03",    # array key
    b"\x81\xcb" + b"\x00" * 8 + b"\x01",   # float key
], ids=["int", "nil", "array", "float"])
def test_strict_map_key_refused_like_msgpack(data):
    with pytest.raises(ValueError):
        ref_unpack(data)
    with pytest.raises(ValueError):
        codec.unpackb(data)


@pytest.mark.parametrize("value", [
    np.int64(3), np.int32(3), np.float32(1.0), np.bool_(True),
    torch.tensor(3), torch.tensor(1.5), 1 + 2j, {1, 2}, object(),
], ids=lambda v: type(v).__name__)
def test_unpackable_types_raise_type_error_like_msgpack(value):
    with pytest.raises(TypeError):
        ref_pack(value)
    with pytest.raises(TypeError):
        codec.packb(value)
    with pytest.raises(TypeError):     # nested too
        codec.packb({"x": [value]})


@pytest.mark.parametrize("value", [2 ** 64, -2 ** 63 - 1])
def test_out_of_range_int_raises_overflow_like_msgpack(value):
    with pytest.raises(OverflowError):
        ref_pack(value)
    with pytest.raises(OverflowError):
        codec.packb(value)


def test_every_truncation_raises():
    data = ref_pack(FRAMES[14])
    for cut in range(len(data)):
        with pytest.raises(ValueError):
            ref_unpack(data[:cut])
        with pytest.raises(ValueError):
            codec.unpackb(data[:cut])


@pytest.mark.parametrize("data", [
    b"\x01\x02",                  # trailing bytes
    b"\xc1",                      # reserved
    b"\xdd\xff\xff\xff\xff",      # array count beyond the input
    b"\xdf\x00\x01\x00\x00",      # map count beyond the input
    b"\xc6\xff\xff\xff\xff",      # bin length beyond the input
    b"\xa2\xff\xfe",              # invalid UTF-8
], ids=["extra", "reserved", "array", "map", "bin", "utf8"])
def test_malformed_input_raises_value_error_like_msgpack(data):
    with pytest.raises(ValueError):
        ref_unpack(data)
    with pytest.raises(ValueError):
        codec.unpackb(data)


def test_nesting_limit_like_msgpack():
    ok, deep = [], []
    for _ in range(511):
        ok = [ok]
    for _ in range(600):
        deep = [deep]
    assert codec.packb(ok) == ref_pack(ok)
    with pytest.raises(ValueError):
        ref_pack(deep)
    with pytest.raises(ValueError):
        codec.packb(deep)


def test_iter_unpack_reads_a_stream_like_unpacker():
    records = FRAMES[10:14]
    stream = b"".join(ref_pack(r) for r in records)
    assert list(codec.iter_unpack(stream)) == list(
        msgpack.Unpacker(__import__("io").BytesIO(stream), raw=False))
    # a torn tail: the whole records before it, then ValueError
    got = []
    with pytest.raises(ValueError):
        for rec in codec.iter_unpack(stream[:-3]):
            got.append(rec)
    assert got == records[:-1]
