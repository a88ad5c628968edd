"""The port's KServe gRPC entry point against the JAX package's.

Every case runs over the cross matrix {``grpc`` client, port client} x
{JAX ``KserveGrpcService`` on ``grpc.aio``, port ``KserveGrpcService`` on
the port's HTTP/2}, and all four combinations must give equal responses,
status codes and details: the four cases of ``tests/test_kserve_grpc.py``
on its ``EchoEngine``, a prompt and a reply larger than 65,535 octets (flow
control both ways), a ``gzip`` request, a 5 MiB request (RESOURCE_EXHAUSTED
from both servers), a client deadline and a client cancel mid-stream (after
which the engine's generator is closed, on both servers), and 32
concurrent streams on one channel. Below the clients: a message compressed
in an encoding the server does not know gives UNIMPLEMENTED from the port
(as the gRPC protocol asks; grpc's C-core server resets the stream with
INTERNAL_ERROR, pinned here), a message that does not inflate gives both
servers' INTERNAL, and ``-bin`` metadata from the ``grpc`` client reaches a
port handler as bytes.
"""

import asyncio
import base64
import sys
from pathlib import Path

import grpc
import pytest

from dynamo_tpu.frontend.service import ModelEntry as JaxEntry
from dynamo_tpu.frontend.service import ModelManager as JaxManager
from dynamo_tpu.kserve import KserveGrpcService as JaxService
from dynamo_tpu.kserve import kserve_pb2 as jpb
from dynamo_tpu.kserve.service import make_stub as jax_stub
from dynamo_tpu.llm.protocols import BackendOutput
from dynamo_tpu_torch.frontend.service import ModelEntry, ModelManager
from dynamo_tpu_torch.kserve import KserveGrpcService, make_stub
from dynamo_tpu_torch.kserve import grpc as tgrpc
from dynamo_tpu_torch.kserve import messages as tpb
from dynamo_tpu_torch.utils import hpack, http2

sys.path.insert(0, str(Path(__file__).parent))
from test_kserve_grpc import EchoEngine  # noqa: E402

pytestmark = pytest.mark.anyio
COMBOS = [(c, s) for c in ("grpc", "port") for s in ("jax", "port")]
BIG_WORD = 70_000          # two of them: a 140,001-octet prompt and reply


@pytest.fixture
def anyio_backend():
    return "asyncio"


class SlowEngine:
    """Streams the prompt's words with a pause before each, and records
    that its generator was closed (the ``finally`` runs when a cancelled
    handler closes it)."""

    def __init__(self):
        self.closed = 0
        self.finished = 0

    async def generate(self, body, context):
        words = body.get("prompt", "").split()
        try:
            for i, w in enumerate(words):
                await asyncio.sleep(0.05)
                last = i == len(words) - 1
                yield BackendOutput(
                    token_ids=[i], text=w + ("" if last else " "),
                    finish_reason="stop" if last else None,
                    cum_tokens=i + 1, num_prompt_tokens=len(words))
            self.finished += 1
        finally:
            self.closed += 1

    async def wait_closed(self, n: int, timeout: float = 5.0) -> bool:
        loop = asyncio.get_running_loop()
        end = loop.time() + timeout
        while self.closed < n and loop.time() < end:
            await asyncio.sleep(0.02)
        return self.closed >= n


@pytest.fixture
async def servers():
    slow = {"jax": SlowEngine(), "port": SlowEngine()}
    jm = JaxManager()
    jm.register(JaxEntry(name="echo", engine=EchoEngine()))
    jm.register(JaxEntry(name="slow", engine=slow["jax"]))
    tm = ModelManager()
    tm.register(ModelEntry(name="echo", engine=EchoEngine()))
    tm.register(ModelEntry(name="slow", engine=slow["port"]))
    svcs = {"jax": JaxService(jm, host="127.0.0.1", port=0),
            "port": KserveGrpcService(tm, host="127.0.0.1", port=0)}
    for svc in svcs.values():
        await svc.start()
    yield {name: (svc, slow[name]) for name, svc in svcs.items()}
    for svc in svcs.values():
        await svc.stop()


# ------------------------- the two clients, side by side -------------------


def _param_value(p, port: bool):
    which = p.which_oneof("parameter_choice") if port \
        else p.WhichOneof("parameter_choice")
    return (which, getattr(p, which)) if which else None


def normal_response(resp, port: bool) -> dict:
    """A ``ModelInferResponse`` of either package as plain values."""
    return {
        "model_name": resp.model_name, "model_version": resp.model_version,
        "id": resp.id,
        "parameters": {k: _param_value(v, port)
                       for k, v in sorted(resp.parameters.items())},
        "outputs": [(o.name, o.datatype, list(o.shape),
                     list(o.contents.bytes_contents) if o.contents
                     is not None else None) for o in resp.outputs],
        "raw": list(resp.raw_output_contents),
    }


class Client:
    """One client kind over one channel: every call returns plain values,
    an error as ``("error", code name, details)``."""

    def __init__(self, kind: str, port: int):
        self.kind = kind
        self.target = f"127.0.0.1:{port}"
        self.port = kind == "port"
        self.pb = tpb if self.port else jpb

    async def __aenter__(self):
        self.chan = (tgrpc.insecure_channel(self.target) if self.port
                     else grpc.aio.insecure_channel(self.target))
        self.stub = (make_stub if self.port else jax_stub)(self.chan)
        return self

    async def __aexit__(self, *exc):
        await self.chan.close()

    def error(self, e):
        return ("error", e.code().name, e.details())

    @property
    def errors(self):
        return tgrpc.RpcError if self.port else grpc.aio.AioRpcError

    def request(self, model: str, text: str, **params):
        if self.port:
            return tpb.ModelInferRequest(
                model_name=model, id="req-1",
                parameters={k: tpb.InferParameter(**{_kind(v): v})
                            for k, v in params.items()},
                inputs=[tpb.ModelInferRequest.InferInputTensor(
                    name="text_input", datatype="BYTES", shape=[1],
                    contents=tpb.InferTensorContents(
                        bytes_contents=[text.encode()]))])
        req = jpb.ModelInferRequest(model_name=model, id="req-1")
        t = req.inputs.add()
        t.name, t.datatype = "text_input", "BYTES"
        t.shape.append(1)
        t.contents.bytes_contents.append(text.encode())
        for k, v in params.items():
            setattr(req.parameters[k], _kind(v), v)
        return req

    async def call(self, method: str, req, **kw):
        try:
            return await getattr(self.stub, method)(req, **kw)
        except self.errors as e:
            return self.error(e)

    async def basics(self):
        pb = self.pb
        out = [(await self.call("ServerLive", pb.ServerLiveRequest())).live,
               (await self.call("ServerReady", pb.ServerReadyRequest())).ready,
               (await self.call("ModelReady",
                                pb.ModelReadyRequest(name="echo"))).ready,
               (await self.call("ModelReady",
                                pb.ModelReadyRequest(name="nope"))).ready]
        meta = await self.call("ModelMetadata",
                               pb.ModelMetadataRequest(name="echo"))
        out.append((meta.name, list(meta.versions), meta.platform,
                    [(t.name, t.datatype, list(t.shape))
                     for t in (*meta.inputs, *meta.outputs)]))
        out.append(await self.call("ModelMetadata",
                                   pb.ModelMetadataRequest(name="nope")))
        return out

    async def infer(self, model: str, text: str, timeout=None,
                    compression=None, **params):
        kw = {}
        if timeout is not None:
            kw["timeout"] = timeout
        if compression is not None:
            kw["compression"] = (compression if self.port
                                 else grpc.Compression.Gzip)
        got = await self.call("ModelInfer", self.request(model, text,
                                                         **params), **kw)
        return got if isinstance(got, tuple) else normal_response(got,
                                                                   self.port)

    def _stream_item(self, r):
        if r.error_message:
            return ("error_message", r.error_message)
        return normal_response(r.infer_response, self.port)

    async def stream(self, model: str, texts, **params):
        call = self.stub.ModelStreamInfer()
        try:
            for text in texts:
                await call.write(self.request(model, text, **params))
            await call.done_writing()
            return [self._stream_item(r) async for r in call]
        except self.errors as e:
            return self.error(e)

    async def cancel_after_first(self, model: str, text: str):
        call = self.stub.ModelStreamInfer()
        await call.write(self.request(model, text))
        first = self._stream_item(await call.read())
        call.cancel()
        return first, (await call.code()).name


def _kind(v) -> str:
    if isinstance(v, bool):
        return "bool_param"
    if isinstance(v, int):
        return "int64_param"
    if isinstance(v, float):
        return "double_param"
    return "string_param"


async def across(servers, fn):
    """``fn(client, server name)`` for every combination; all results must
    be equal. Returns the one result."""
    results = {}
    for kind, name in COMBOS:
        async with Client(kind, servers[name][0].port) as client:
            results[(kind, name)] = await fn(client, name)
    first = results[COMBOS[0]]
    for combo, got in results.items():
        assert got == first, (combo, got, COMBOS[0], first)
    return first


def _text(resp: dict) -> bytes:
    return resp["outputs"][0][3][0]


# ----------------------------- the four cases ------------------------------


async def test_live_ready_metadata(servers):
    got = await across(servers, lambda c, _: c.basics())
    assert got[:4] == [True, True, True, False]
    assert got[4] == ("echo", ["1"], "dynamo-tpu",
                      [("text_input", "BYTES", [1]),
                       ("text_output", "BYTES", [1])])
    assert got[5] == ("error", "NOT_FOUND", "model 'nope' not found")


async def test_unary_infer_aggregates(servers):
    got = await across(servers, lambda c, _: c.infer(
        "echo", "hello tpu world", max_tokens=16))
    assert _text(got) == b"hello tpu world"
    assert got["parameters"] == {"finish_reason": ("string_param", "stop")}
    assert got["id"] == "req-1" and got["model_name"] == "echo"


async def test_stream_infer_streams_steps(servers):
    got = await across(servers, lambda c, _: c.stream("echo", ["a b c"]))
    assert [_text(r) for r in got] == [b"a ", b"b ", b"c"]
    assert [r["parameters"] for r in got] == [
        {}, {}, {"finish_reason": ("string_param", "stop")}]


async def test_unknown_model_errors(servers):
    got = await across(servers, lambda c, _: c.infer("nope", "x"))
    assert got == ("error", "NOT_FOUND", "\"model 'nope' not found\"")
    got = await across(servers, lambda c, _: c.stream("nope", ["x"]))
    assert got == [("error_message", "\"model 'nope' not found\"")]


# ----------------------------- the wire's edges ----------------------------


async def test_flow_control_past_64k_both_ways(servers):
    text = " ".join(["x" * BIG_WORD, "y" * BIG_WORD])
    got = await across(servers, lambda c, _: c.infer("echo", text))
    assert _text(got) == text.encode()
    got = await across(servers, lambda c, _: c.stream("echo", [text]))
    assert [_text(r) for r in got] == [b"x" * BIG_WORD + b" ",
                                       b"y" * BIG_WORD]


async def test_gzip_request(servers):
    text = "compressible " * 2000
    got = await across(servers, lambda c, _: c.infer(
        "echo", text, compression="gzip"))
    assert _text(got) == text.strip().encode()


async def test_request_over_4mib_is_resource_exhausted(servers):
    got = await across(servers, lambda c, _: c.infer(
        "echo", "z" * (5 << 20)))
    assert got[:2] == ("error", "RESOURCE_EXHAUSTED")
    assert got[2].startswith("SERVER: Received message larger than max (")
    assert got[2].endswith(" vs. 4194304)")


async def test_deadline_cancels_and_closes_the_generator(servers):
    async def run(client, name):
        slow = servers[name][1]
        before = slow.closed
        got = await client.infer("slow", " ".join(["w"] * 40), timeout=0.3)
        assert await slow.wait_closed(before + 1), (client.kind, name)
        return got, slow.finished
    got = await across(servers, run)
    assert got == (("error", "DEADLINE_EXCEEDED", "Deadline Exceeded"), 0)


async def test_cancel_mid_stream_closes_the_generator(servers):
    async def run(client, name):
        slow = servers[name][1]
        before = slow.closed
        got = await client.cancel_after_first("slow",
                                              " ".join(["w"] * 40))
        assert await slow.wait_closed(before + 1), (client.kind, name)
        return got, slow.finished
    first, finished = await across(servers, run)
    assert _text(first[0]) == b"w " and first[1] == "CANCELLED"
    assert finished == 0


async def test_32_concurrent_streams_on_one_channel(servers):
    texts = [" ".join(f"s{i}w{j}" for j in range(i % 5 + 1))
             for i in range(32)]

    async def run(client, _):
        outs = await asyncio.gather(*(client.stream("echo", [t])
                                      for t in texts))
        return [b"".join(_text(r) for r in out) for out in outs]
    got = await across(servers, run)
    assert got == [t.encode() for t in texts]


async def raw_infer(port: int, encoding: str, payload: bytes):
    """One ModelInfer stream sent by hand: the status the server gave
    (code, message), or ``("reset", error code)`` when it reset the stream
    before any status."""
    conn = await http2.connect("127.0.0.1", port)
    try:
        stream = await conn.request([
            (":method", "POST"), (":scheme", "http"),
            (":path", f"/{tpb.SERVICE}/ModelInfer"),
            (":authority", f"127.0.0.1:{port}"),
            ("content-type", "application/grpc"), ("te", "trailers"),
            ("grpc-encoding", encoding)])
        await stream.send_data(tgrpc.frame_message(payload, True),
                               end_stream=True)
        try:
            headers = dict(await stream.read_headers())
            while await stream.read_data() is not None:
                pass
        except http2.StreamReset as e:
            return ("reset", e.code)
        status = headers if "grpc-status" in headers \
            else dict(stream.trailers or [])
        return (int(status["grpc-status"]), status.get("grpc-message", ""))
    finally:
        conn.close()


async def test_unknown_message_encoding(servers):
    got = {name: await raw_infer(svc.port, "snappy", b"\x01\x02")
           for name, (svc, _) in servers.items()}
    assert got == {
        "port": (tgrpc.StatusCode.UNIMPLEMENTED,
                 "Compression algorithm 'snappy' is not supported"),
        "jax": ("reset", http2.INTERNAL_ERROR)}


async def test_message_that_does_not_inflate(servers):
    got = {name: await raw_infer(svc.port, "gzip", b"not gzip")
           for name, (svc, _) in servers.items()}
    assert got["port"] == got["jax"] == (
        tgrpc.StatusCode.INTERNAL,
        "Unexpected error decompressing data for algorithm gzip")


async def test_bin_metadata_from_the_grpc_client(record_property,
                                               monkeypatch):
    """``-bin`` metadata from grpc's C-core client reaches a port handler
    as the bytes sent. Which header strings C-core Huffman-coded is
    recorded (``huffman_decoded``): the base64 of the ``-bin`` value is one
    of them, so a real encoder drives the HPACK decoder's Huffman path."""
    seen = []
    decoded = []
    plain = hpack.huffman_decode

    def recording(data):
        out = plain(data)
        decoded.append(out)
        return out
    monkeypatch.setattr(hpack, "huffman_decode", recording)

    async def echo(request: bytes, context):
        seen.append(dict(context.invocation_metadata()))
        return request

    server = tgrpc.Server({"/t.T/Echo": tgrpc.unary_unary_rpc_method_handler(
        echo, request_deserializer=bytes, response_serializer=bytes)})
    port = await server.start("127.0.0.1", 0)
    value = bytes(range(256)) * 3
    try:
        async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as chan:
            call = chan.unary_unary("/t.T/Echo",
                                    request_serializer=lambda b: b,
                                    response_deserializer=lambda b: b)
            got = await call(b"ping", metadata=(
                ("trace-bin", value), ("plain-key", "plain value")))
    finally:
        await server.stop()
    assert got == b"ping"
    assert seen[0]["trace-bin"] == value
    assert seen[0]["plain-key"] == "plain value"
    b64 = base64.b64encode(value).rstrip(b"=")
    record_property("huffman_decoded", [d[:32] for d in decoded])
    print(f"C-core Huffman-coded {len(decoded)} header string(s); the -bin "
          f"value among them: {b64 in decoded}")
    assert b64 in decoded
