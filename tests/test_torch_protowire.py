"""The port's protobuf wire codec (``utils/protowire.py``) and its KServe
messages (``kserve/messages.py``) against ``google.protobuf`` and the JAX
package's generated ``kserve_pb2``: for every message of ``kserve.proto``,
drawn by hypothesis over all its fields, the port's bytes parse with pb2 to
an equal message and pb2's bytes parse with the port to an equal value.
Unpacked repeated scalars, ten-byte negative ``int64``/``int32`` varints,
every ``InferParameter`` oneof member (defaults included), oneof
switching, unknown fields of every wire type and malformed input are
covered too."""

import struct

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.kserve import kserve_pb2 as pb
from dynamo_tpu_torch.kserve import messages as tm
from dynamo_tpu_torch.utils import protowire as pw

SCALARS = {
    "int32": st.integers(-2 ** 31, 2 ** 31 - 1),
    "int64": st.integers(-2 ** 63, 2 ** 63 - 1),
    "uint32": st.integers(0, 2 ** 32 - 1),
    "uint64": st.integers(0, 2 ** 64 - 1),
    "bool": st.booleans(),
    "float": st.floats(width=32, allow_nan=False),
    "double": st.floats(allow_nan=False),
    "string": st.text(max_size=12),
    "bytes": st.binary(max_size=12),
}


def pb_class(name: str):
    cls = pb
    for part in name.split("."):
        cls = getattr(cls, part)
    return cls


def values(cls, depth: int = 0):
    """A strategy of {field name: plain value} for message class ``cls``
    (sub-messages as nested dicts), any subset of its fields set."""
    optional = {}
    oneofs = {}
    for f in cls.FIELDS:
        if f.type == "map":
            optional[f.name] = st.dictionaries(
                st.text(max_size=6), values(f.message, depth + 1),
                max_size=3)
        elif f.type == "message":
            if depth >= 3:
                continue
            sub = values(f.message, depth + 1)
            optional[f.name] = st.lists(sub, max_size=3) if f.repeated \
                else sub
        elif f.oneof:
            oneofs.setdefault(f.oneof, []).append(
                st.tuples(st.just(f.name), SCALARS[f.type]))
        else:
            optional[f.name] = st.lists(SCALARS[f.type], max_size=4) \
                if f.repeated else SCALARS[f.type]
    base = st.fixed_dictionaries({}, optional=optional)
    for members in oneofs.values():
        base = st.tuples(base, st.none() | st.one_of(members)).map(
            lambda pair: {**pair[0], **({pair[1][0]: pair[1][1]}
                                        if pair[1] else {})})
    return base


def build_port(cls, value: dict):
    kw = {}
    for f in cls.FIELDS:
        if f.name not in value:
            continue
        v = value[f.name]
        if f.type == "map":
            v = {k: build_port(f.message, x) for k, x in v.items()}
        elif f.type == "message":
            v = [build_port(f.message, x) for x in v] if f.repeated \
                else build_port(f.message, v)
        kw[f.name] = v
    return cls(**kw)


def build_pb(cls, value: dict):
    msg = pb_class(cls.__qualname__)()
    for f in cls.FIELDS:
        if f.name not in value:
            continue
        v = value[f.name]
        if f.type == "map":
            for k, x in v.items():
                getattr(msg, f.name)[k].CopyFrom(build_pb(f.message, x))
        elif f.type == "message" and f.repeated:
            for x in v:
                getattr(msg, f.name).add().CopyFrom(build_pb(f.message, x))
        elif f.type == "message":
            sub = getattr(msg, f.name)
            sub.SetInParent()
            sub.MergeFrom(build_pb(f.message, v))
        elif f.repeated:
            getattr(msg, f.name).extend(v)
        else:
            setattr(msg, f.name, v)
    return msg


@pytest.mark.parametrize("name", sorted(tm.MESSAGES))
def test_every_message_round_trips_with_pb2(name):
    cls = tm.MESSAGES[name]

    @settings(max_examples=60, deadline=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(values(cls))
    def check(value):
        ours, theirs = build_port(cls, value), build_pb(cls, value)
        assert type(theirs).FromString(ours.encode()) == theirs
        assert cls.decode(theirs.SerializeToString()) == ours
        assert cls.decode(ours.encode()) == ours
    check()


def test_the_schema_covers_every_message_and_field_of_the_proto():
    """Every message of ``kserve.proto`` (pb2's descriptors, maps' entry
    types aside) is in ``MESSAGES`` with the same field names, numbers and
    labels."""
    want = {}

    def walk(desc, prefix=""):
        for m in desc.message_types_by_name.values() if prefix == "" \
                else desc.nested_types:
            if m.GetOptions().map_entry:
                continue
            name = prefix + m.name
            want[name] = sorted(
                (f.number, f.name, f.label == f.LABEL_REPEATED
                 and not (f.message_type and
                          f.message_type.GetOptions().map_entry))
                for f in m.fields)
            walk(m, name + ".")
    walk(pb.DESCRIPTOR)
    got = {name: sorted((f.number, f.name, f.repeated)
                        for f in cls.FIELDS)
           for name, cls in tm.MESSAGES.items()}
    assert got == want


def test_unpacked_repeated_scalars_decode():
    """proto2-style unpacked runs (one tag per element) decode to the same
    lists as the packed runs the encoders write."""
    value = dict(bool_contents=[True, False], int_contents=[-1, 7],
                 int64_contents=[-2 ** 63, 5], uint_contents=[2 ** 32 - 1],
                 uint64_contents=[2 ** 64 - 1, 0], fp32_contents=[1.5, -2.0],
                 fp64_contents=[0.1, -1e300])
    raw = b""
    for f in tm.InferTensorContents.FIELDS:
        for x in value.get(f.name, []):
            raw += pw._encode_one(f.number, f.type, x)
    want = tm.InferTensorContents(**value)
    assert tm.InferTensorContents.decode(raw) == want
    assert pb.InferTensorContents.FromString(raw) == \
        pb.InferTensorContents.FromString(want.encode())
    # a packed run and an unpacked one of the same field concatenate
    mixed = want.encode() + raw
    doubled = {k: v + v for k, v in value.items()}
    assert tm.InferTensorContents.decode(mixed) == \
        tm.InferTensorContents(**doubled)


@pytest.mark.parametrize("v", [-1, -2 ** 63, 2 ** 63 - 1, 0])
def test_negative_int64_is_ten_bytes_as_pb2_writes_it(v):
    ours = tm.InferParameter(int64_param=v).encode()
    assert ours == pb.InferParameter(int64_param=v).SerializeToString()
    if v < 0:
        assert len(ours) == 1 + 10
    assert tm.InferParameter.decode(ours).int64_param == v


def test_negative_int32_is_sign_extended():
    ours = tm.InferTensorContents(int_contents=[-1, -2 ** 31]).encode()
    assert ours == pb.InferTensorContents(
        int_contents=[-1, -2 ** 31]).SerializeToString()
    assert tm.InferTensorContents.decode(ours).int_contents == [-1, -2 ** 31]


@pytest.mark.parametrize("member,value", [
    ("bool_param", False), ("bool_param", True), ("int64_param", 0),
    ("int64_param", -7), ("string_param", ""), ("string_param", "stop"),
    ("double_param", 0.0), ("double_param", 2.5)])
def test_every_infer_parameter_oneof(member, value):
    """A set member is written even at its default (proto3 presence) and
    reads back as the member that is set."""
    ours = tm.InferParameter(**{member: value})
    theirs = pb.InferParameter(**{member: value})
    assert ours.encode() == theirs.SerializeToString()
    back = tm.InferParameter.decode(theirs.SerializeToString())
    assert back.which_oneof("parameter_choice") == member
    assert getattr(back, member) == value
    assert pb.InferParameter.FromString(ours.encode()).WhichOneof(
        "parameter_choice") == member


def test_setting_a_oneof_member_clears_the_others():
    p = tm.InferParameter(int64_param=3)
    p.string_param = "x"
    assert p.which_oneof("parameter_choice") == "string_param"
    assert p.int64_param is None
    assert pb.InferParameter.FromString(p.encode()) == \
        pb.InferParameter(string_param="x")
    # on the wire, the last member wins
    raw = (tm.InferParameter(bool_param=True).encode()
           + tm.InferParameter(double_param=1.0).encode())
    assert tm.InferParameter.decode(raw) == tm.InferParameter(
        double_param=1.0)
    assert tm.InferParameter().which_oneof("parameter_choice") is None


def test_unknown_fields_are_skipped():
    want = tm.ModelInferRequest(model_name="m", id="1")
    unknown = (pw._tag(90, pw.VARINT) + pw.encode_varint(2 ** 63)
               + pw._tag(91, pw.I64) + struct.pack("<d", 1.0)
               + pw._len_field(92, b"\x08\x01whatever")
               + pw._tag(93, pw.I32) + struct.pack("<f", 1.0)
               + pw._tag(94, pw.SGROUP) + pw._tag(1, pw.VARINT) + b"\x05"
               + pw._tag(94, pw.EGROUP)
               # a known field number on another wire type than its own
               + pw._tag(1, pw.VARINT) + b"\x07")
    raw = want.encode() + unknown
    assert tm.ModelInferRequest.decode(raw) == want
    assert tm.ModelInferRequest.decode(unknown + want.encode()) == want
    assert pb.ModelInferRequest.FromString(raw).model_name == "m"


def test_repeated_sub_message_merges():
    """A singular sub-message that appears twice is merged (its lists
    concatenate), as protobuf does."""
    a = tm.ModelInferRequest.InferInputTensor(
        name="a", contents=tm.InferTensorContents(bytes_contents=[b"x"]))
    b = tm.ModelInferRequest.InferInputTensor(
        contents=tm.InferTensorContents(bytes_contents=[b"y"]))
    raw = a.encode() + b.encode()
    ours = tm.ModelInferRequest.InferInputTensor.decode(raw)
    theirs = pb.ModelInferRequest.InferInputTensor.FromString(raw)
    assert ours.name == theirs.name == "a"
    assert ours.contents.bytes_contents == \
        list(theirs.contents.bytes_contents) == [b"x", b"y"]


def test_map_entries_missing_key_or_value_take_defaults():
    entry_no_value = pw._len_field(4, pw._len_field(1, b"k"))
    entry_no_key = pw._len_field(4, pw._len_field(2, pw._tag(
        2, pw.VARINT) + pw.encode_varint(5)))
    raw = entry_no_value + entry_no_key
    ours = tm.ModelInferRequest.decode(raw)
    theirs = pb.ModelInferRequest.FromString(raw)
    assert ours.parameters == {"k": tm.InferParameter(),
                               "": tm.InferParameter(int64_param=5)}
    assert sorted(theirs.parameters) == sorted(ours.parameters)


@pytest.mark.parametrize("raw", [
    b"\x0a\x05ab",                      # length past the end
    b"\x08" + b"\xff" * 11,             # an eleven-byte varint
    b"\x00\x01",                        # field number 0
    b"\x0a\x02\xff\xfe",                # a string that is not UTF-8
    b"\x0c",                            # an end-group with no start
])
def test_malformed_input_raises(raw):
    with pytest.raises(pw.DecodeError):
        tm.ModelInferRequest.decode(raw)
    with pytest.raises(Exception):
        pb.ModelInferRequest.FromString(raw)
