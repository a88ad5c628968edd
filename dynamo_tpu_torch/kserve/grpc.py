"""gRPC over the port's HTTP/2 (``utils/http2.py``): a server for
unary-unary and stream-stream methods, and a client channel.

The port's stand-in for what ``grpc.aio`` does for the KServe service (the
card's machine has no ``grpc``); the handlers take ``(request, context)`` or
``(request_iterator, context)`` and ``context.abort(code, details)`` as
``grpc.aio``'s do. What it does on the wire:

- every message carries gRPC's five-octet prefix (a compressed flag and a
  big-endian length);
- a request compressed with ``gzip`` or ``deflate`` (``grpc-encoding``) is
  inflated with ``zlib``, and ``grpc-accept-encoding`` advertises both; a
  message that does not inflate gives INTERNAL in grpc's words, and one
  flagged compressed under ``identity`` (or no encoding) is taken as it
  is, as grpc's C-core server does; a compressed message in an encoding
  the server does not know gives UNIMPLEMENTED, as the gRPC protocol asks
  (grpc's C-core server resets such a stream with INTERNAL_ERROR before
  any status, ROADMAP.md queue C); responses go out uncompressed;
- a message larger than the receive limit (4 MiB, grpc's default) gives
  RESOURCE_EXHAUSTED with grpc's own words;
- ``grpc-timeout`` sets a deadline: when it passes the handler is cancelled
  and the status is DEADLINE_EXCEEDED;
- a client's RST_STREAM cancels the handler (so the engine's ``generate``
  is closed at the ``await`` it stands on, as under ``grpc.aio``);
- a response ends in ``grpc-status``/``grpc-message`` trailers, the message
  percent-encoded; an error before any message goes out as a trailers-only
  response (one HEADERS frame that ends the stream);
- ``-bin`` metadata is base64 on the wire and bytes to the handler.

The client sends the same framing (optionally ``gzip``-compressed),
``grpc-timeout`` from ``timeout=``, and RST_STREAM(CANCEL) on ``cancel()``
or when its own deadline passes; a non-OK status raises :class:`RpcError`,
whose ``code()``/``details()`` read as ``grpc.aio.AioRpcError``'s.
"""

from __future__ import annotations

import asyncio
import base64
import enum
import zlib
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple
from urllib.parse import quote, unquote_to_bytes

from ..utils import http2
from ..utils.logging import get_logger

log = get_logger("kserve.grpc")

MAX_RECEIVE_MESSAGE_LENGTH = 4 * 1024 * 1024
ACCEPT_ENCODING = "identity, deflate, gzip"
USER_AGENT = "dynamo-tpu-torch-grpc/1"
_DECODERS = {
    "gzip": lambda b: zlib.decompress(b, 16 + zlib.MAX_WBITS),
    "deflate": zlib.decompress,
}


class StatusCode(enum.IntEnum):
    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """A call that ended with a status other than OK."""

    def __init__(self, code: StatusCode, details: str = ""):
        super().__init__(f"{code.name}: {details}")
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


class _Abort(Exception):
    def __init__(self, code: StatusCode, details: str):
        super().__init__(details)
        self.code = code
        self.details = details


# ------------------------------- framing -----------------------------------


def frame_message(payload: bytes, compressed: bool = False) -> bytes:
    return bytes((1 if compressed else 0,)) \
        + len(payload).to_bytes(4, "big") + payload


def encode_grpc_message(text: str) -> str:
    """``grpc-message``: UTF-8, percent-encoding every octet outside
    0x20..0x7E and ``%``."""
    return quote(text.encode("utf-8"),
                 safe=bytes(c for c in range(0x20, 0x7F)
                            if c != 0x25).decode())


def decode_grpc_message(value: str) -> str:
    return unquote_to_bytes(value).decode("utf-8", "replace")


def parse_timeout(value: str) -> float:
    """A ``grpc-timeout`` value (at most 8 digits and a unit) in seconds."""
    units = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6,
             "n": 1e-9}
    if not 2 <= len(value) <= 9 or value[-1] not in units \
            or not value[:-1].isdigit():
        raise ValueError(f"bad grpc-timeout {value!r}")
    return int(value[:-1]) * units[value[-1]]


def format_timeout(seconds: float) -> str:
    for unit, scale in (("n", 1e9), ("u", 1e6), ("m", 1e3), ("S", 1.0),
                        ("M", 1 / 60), ("H", 1 / 3600)):
        n = int(max(seconds, 0.0) * scale)
        if n < 10 ** 8:
            return f"{max(n, 1)}{unit}"
    return "99999999H"


def _metadata_out(metadata) -> List[Tuple[str, str]]:
    out = []
    for key, value in metadata or ():
        key = key.lower()
        if key.endswith("-bin"):
            value = base64.b64encode(bytes(value)).decode().rstrip("=")
        out.append((key, value))
    return out


def _metadata_in(headers) -> List[Tuple[str, Any]]:
    out = []
    for key, value in headers:
        if key.startswith(":") or key in ("te", "content-type",
                                          "grpc-timeout", "grpc-encoding",
                                          "grpc-accept-encoding"):
            continue
        if key.endswith("-bin"):
            value = base64.b64decode(value + "=" * (-len(value) % 4))
        out.append((key, value))
    return out


class _MessageReader:
    """Splits a stream's DATA into gRPC messages."""

    def __init__(self, stream: http2.Stream, encoding: Optional[str],
                 limit: int, side: str = ""):
        self.stream = stream
        self.encoding = encoding
        self.limit = limit
        # grpc's servers open their receive errors with "SERVER: "
        self.side = side
        self._buf = bytearray()

    async def _fill(self, n: int) -> bool:
        while len(self._buf) < n:
            chunk = await self.stream.read_data()
            if chunk is None:
                if self._buf:
                    raise _Abort(StatusCode.INTERNAL,
                                 "Incomplete gRPC message at end of stream")
                return False
            self._buf += chunk
        return True

    async def read(self) -> Optional[bytes]:
        """The next message, or None at the end of the stream."""
        if not await self._fill(5):
            return None
        compressed = self._buf[0]
        length = int.from_bytes(self._buf[1:5], "big")
        if length > self.limit:
            raise _Abort(StatusCode.RESOURCE_EXHAUSTED,
                         f"{self.side}Received message larger than max "
                         f"({length} vs. {self.limit})")
        if not await self._fill(5 + length):
            raise _Abort(StatusCode.INTERNAL, "Incomplete gRPC message")
        payload = bytes(self._buf[5:5 + length])
        del self._buf[:5 + length]
        if compressed and self.encoding not in (None, "identity"):
            decoder = _DECODERS.get(self.encoding)
            if decoder is None:
                raise _Abort(StatusCode.UNIMPLEMENTED,
                             f"Compression algorithm '{self.encoding}' is "
                             "not supported")
            try:
                payload = decoder(payload)
            except zlib.error:
                raise _Abort(StatusCode.INTERNAL,
                             "Unexpected error decompressing data for "
                             f"algorithm {self.encoding}") from None
            if len(payload) > self.limit:
                raise _Abort(StatusCode.RESOURCE_EXHAUSTED,
                             f"{self.side}Received message larger than max "
                             f"({len(payload)} vs. {self.limit})")
        return payload


# -------------------------------- server -----------------------------------


class ServicerContext:
    """What a handler gets beside its request(s)."""

    def __init__(self, metadata):
        self._metadata = metadata

    async def abort(self, code: StatusCode, details: str = "") -> None:
        raise _Abort(code, details)

    def invocation_metadata(self) -> List[Tuple[str, Any]]:
        """The request's custom metadata, ``-bin`` values as bytes."""
        return list(self._metadata)


class MethodHandler:
    def __init__(self, kind: str, fn: Callable, request_deserializer,
                 response_serializer):
        self.kind = kind   # "unary_unary" | "stream_stream"
        self.fn = fn
        self.request_deserializer = request_deserializer
        self.response_serializer = response_serializer


def unary_unary_rpc_method_handler(fn, request_deserializer,
                                   response_serializer) -> MethodHandler:
    return MethodHandler("unary_unary", fn, request_deserializer,
                         response_serializer)


def stream_stream_rpc_method_handler(fn, request_deserializer,
                                     response_serializer) -> MethodHandler:
    return MethodHandler("stream_stream", fn, request_deserializer,
                         response_serializer)


def _status_headers(code: StatusCode, details: str):
    out = [("grpc-status", str(int(code)))]
    if details:
        out.append(("grpc-message", encode_grpc_message(details)))
    return out


_RESPONSE_HEADERS = [(":status", "200"), ("content-type", "application/grpc"),
                     ("grpc-accept-encoding", ACCEPT_ENCODING)]


async def _finish(stream: http2.Stream, headers_sent: bool,
                  code: StatusCode, details: str) -> None:
    """The status: trailers after the responses, or a trailers-only
    response when none went out."""
    if stream.done or stream.local_closed:
        return
    status = _status_headers(code, details)
    if headers_sent:
        await stream.send_headers(status, end_stream=True)
    else:
        await stream.send_headers(
            [(":status", "200"), ("content-type", "application/grpc")]
            + status, end_stream=True)


class _ServerCall:
    """One RPC on the server: reads the requests, runs the handler, sends
    the responses and the status."""

    def __init__(self, stream: http2.Stream, method: MethodHandler,
                 headers: Dict[str, str]):
        self.stream = stream
        self.method = method
        self.headers_sent = False
        self.reader = _MessageReader(stream, headers.get("grpc-encoding"),
                                     MAX_RECEIVE_MESSAGE_LENGTH,
                                     side="SERVER: ")

    async def _send(self, response) -> None:
        if not self.headers_sent:
            self.headers_sent = True
            await self.stream.send_headers(_RESPONSE_HEADERS)
        payload = self.method.response_serializer(response)
        await self.stream.send_data(frame_message(payload))

    async def finish(self, code: StatusCode, details: str = "") -> None:
        await _finish(self.stream, self.headers_sent, code, details)

    async def _requests(self) -> AsyncIterator:
        while True:
            raw = await self.reader.read()
            if raw is None:
                return
            yield self.method.request_deserializer(raw)

    async def run(self, context: ServicerContext) -> None:
        if self.method.kind == "unary_unary":
            raw = await self.reader.read()
            if raw is None:
                raise _Abort(StatusCode.INTERNAL,
                             "Missing request message for a unary call")
            response = await self.method.fn(
                self.method.request_deserializer(raw), context)
            await self._send(response)
        else:
            requests = self._requests()
            try:
                async for response in self.method.fn(requests, context):
                    await self._send(response)
            finally:
                await requests.aclose()


class Server:
    """A gRPC server: ``handlers`` maps ``/package.Service/Method`` to a
    :class:`MethodHandler`."""

    def __init__(self, handlers: Dict[str, MethodHandler]):
        self.handlers = dict(handlers)
        self._h2 = http2.Server(self._serve)
        self.port = 0

    async def start(self, host: str, port: int) -> int:
        self.port = await self._h2.start(host, port)
        return self.port

    async def stop(self, grace: Optional[float] = None) -> None:
        await self._h2.stop(grace)

    async def _serve(self, stream: http2.Stream) -> None:
        headers = dict(stream.headers)
        if headers.get(":method") != "POST" or not headers.get(
                "content-type", "").startswith("application/grpc"):
            await stream.send_headers([(":status", "415")], end_stream=True)
            return
        method = self.handlers.get(headers.get(":path", ""))
        if method is None:
            await _finish(stream, False, StatusCode.UNIMPLEMENTED,
                          "Method not found!")
            return
        call = _ServerCall(stream, method, headers)
        deadline = None
        loop = asyncio.get_running_loop()
        if "grpc-timeout" in headers:
            try:
                deadline = loop.time() + parse_timeout(headers["grpc-timeout"])
            except ValueError as e:
                await call.finish(StatusCode.INTERNAL, str(e))
                return
        context = ServicerContext(_metadata_in(stream.headers))
        task = loop.create_task(call.run(context))
        why: Dict[str, bool] = {}

        def stop(reason: str) -> None:
            if not task.done():
                why[reason] = True
                task.cancel()
        stream.on_reset.append(lambda code: stop("reset"))
        timer = None if deadline is None else loop.call_at(
            deadline, stop, "deadline")
        try:
            await task
            await call.finish(StatusCode.OK)
        except _Abort as e:
            await call.finish(e.code, e.details)
        except asyncio.CancelledError:
            if "deadline" in why:
                await call.finish(StatusCode.DEADLINE_EXCEEDED,
                                  "Deadline Exceeded")
            elif "reset" not in why:
                if not task.done():
                    task.cancel()
                raise
        except http2.StreamReset:
            pass
        except Exception as e:
            log.exception("grpc handler %s failed", headers.get(":path"))
            await call.finish(StatusCode.UNKNOWN,
                              f"Unexpected {type(e)}: {e}")
        finally:
            if timer is not None:
                timer.cancel()
        if not stream.remote_closed and not stream.done:
            # the response is whole: the client may stop sending
            stream.reset(http2.NO_ERROR)


# -------------------------------- client -----------------------------------


class _ClientCall:
    """One RPC from the client."""

    def __init__(self, channel: "Channel", path: str, serializer,
                 deserializer, timeout: Optional[float], metadata,
                 compression: Optional[str]):
        self.channel = channel
        self.path = path
        self.serializer = serializer
        self.deserializer = deserializer
        self.timeout = timeout
        self.metadata = metadata
        self.compression = compression
        self.stream: Optional[http2.Stream] = None
        self.reader: Optional[_MessageReader] = None
        self.error: Optional[RpcError] = None
        self.status: Optional[Tuple[StatusCode, str]] = None
        self._timer = None
        self._headers_read = False

    async def start(self) -> None:
        if self.compression not in (None, "gzip", "deflate"):
            raise ValueError(f"compression {self.compression!r}")
        headers = [(":method", "POST"), (":scheme", "http"),
                   (":path", self.path),
                   (":authority", self.channel.authority),
                   ("content-type", "application/grpc"), ("te", "trailers"),
                   ("grpc-accept-encoding", ACCEPT_ENCODING),
                   ("user-agent", USER_AGENT)]
        loop = asyncio.get_running_loop()
        if self.timeout is not None:
            headers.append(("grpc-timeout", format_timeout(self.timeout)))
            self._timer = loop.call_later(self.timeout, self._expire)
        if self.compression:
            headers.append(("grpc-encoding", self.compression))
        headers += _metadata_out(self.metadata)
        conn = await self.channel._connection()
        try:
            self.stream = await conn.request(headers)
        except http2.StreamReset as e:
            raise RpcError(StatusCode.UNAVAILABLE, str(e)) from None

    def _expire(self) -> None:
        if self.status is None and self.error is None:
            self.error = RpcError(StatusCode.DEADLINE_EXCEEDED,
                                  "Deadline Exceeded")
            if self.stream is not None:
                self.stream.reset(http2.CANCEL)

    def cancel(self) -> bool:
        if self.status is not None or self.error is not None:
            return False
        self.error = RpcError(StatusCode.CANCELLED,
                              "Locally cancelled by application!")
        if self.stream is not None:
            self.stream.reset(http2.CANCEL)
        self._done()
        return True

    def _done(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _reset_error(self, e: http2.StreamReset) -> RpcError:
        if self.error is not None:
            return self.error
        code = StatusCode.CANCELLED if e.code == http2.CANCEL \
            else StatusCode.UNAVAILABLE if e.code == http2.REFUSED_STREAM \
            else StatusCode.INTERNAL
        return RpcError(code, f"Stream reset by the peer ({e.code}): {e}")

    async def write(self, request, end: bool = False) -> None:
        payload = self.serializer(request)
        compressed = False
        if self.compression == "gzip":
            payload, compressed = zlib.compress(payload, wbits=31), True
        elif self.compression == "deflate":
            payload, compressed = zlib.compress(payload), True
        try:
            await self.stream.send_data(frame_message(payload, compressed),
                                        end_stream=end)
        except http2.StreamReset as e:
            raise self._reset_error(e) from None

    async def done_writing(self) -> None:
        try:
            await self.stream.send_data(b"", end_stream=True)
        except http2.StreamReset as e:
            raise self._reset_error(e) from None

    def _status_from(self, headers) -> None:
        h = dict(headers)
        code = h.get("grpc-status")
        if code is None:
            self.status = (StatusCode.UNKNOWN,
                           "Stream ended without a grpc-status")
        else:
            try:
                status = StatusCode(int(code))
            except ValueError:
                status = StatusCode.UNKNOWN
            self.status = (status,
                           decode_grpc_message(h.get("grpc-message", "")))

    async def read(self):
        """The next response, or None when the call ended with OK; raises
        :class:`RpcError` for any other status."""
        if self.error is not None:
            raise self.error
        try:
            if not self._headers_read:
                headers = await self.stream.read_headers()
                self._headers_read = True
                h = dict(headers)
                if h.get(":status") != "200":
                    self.status = (StatusCode.UNKNOWN,
                                   f"HTTP status {h.get(':status')}")
                elif "grpc-status" in h:    # trailers-only
                    self._status_from(headers)
                self.reader = _MessageReader(
                    self.stream, h.get("grpc-encoding"), 2 ** 32)
            raw = None
            if self.status is None:
                raw = await self.reader.read()
                if raw is None:
                    self._status_from(self.stream.trailers or [])
        except http2.StreamReset as e:
            self.error = self._reset_error(e)
            self._done()
            raise self.error from None
        except _Abort as e:
            self.error = RpcError(e.code, e.details)
            self._done()
            raise self.error from None
        if raw is not None:
            return self.deserializer(raw)
        self._done()
        code, details = self.status
        if code != StatusCode.OK:
            raise RpcError(code, details)
        return None


class _UnaryUnary:
    def __init__(self, channel, path, serializer, deserializer):
        self.channel, self.path = channel, path
        self.serializer, self.deserializer = serializer, deserializer

    async def __call__(self, request, *, timeout: Optional[float] = None,
                       metadata=None, compression: Optional[str] = None):
        call = _ClientCall(self.channel, self.path, self.serializer,
                           self.deserializer, timeout, metadata, compression)
        await call.start()
        # the request goes out while the response is read: a server may
        # answer (and stop reading) before the request is whole
        sending = asyncio.get_running_loop().create_task(
            call.write(request, end=True))
        try:
            response = await call.read()
            if response is None:
                raise RpcError(StatusCode.INTERNAL,
                               "No response message for a unary call")
            while await call.read() is not None:
                pass
            return response
        except asyncio.CancelledError:
            call.cancel()
            raise
        finally:
            if not sending.done():
                sending.cancel()
            await asyncio.gather(sending, return_exceptions=True)


class StreamStreamCall:
    """A bidirectional call: ``write``/``done_writing`` on one side,
    ``read`` or ``async for`` on the other."""

    def __init__(self, call: _ClientCall):
        self._call = call

    async def _ensure(self) -> None:
        if self._call.stream is None:
            await self._call.start()

    async def write(self, request) -> None:
        await self._ensure()
        await self._call.write(request)

    async def done_writing(self) -> None:
        await self._ensure()
        await self._call.done_writing()

    async def read(self):
        await self._ensure()
        return await self._call.read()

    def __aiter__(self):
        return self

    async def __anext__(self):
        out = await self.read()
        if out is None:
            raise StopAsyncIteration
        return out

    def cancel(self) -> bool:
        return self._call.cancel()

    async def code(self) -> Optional[StatusCode]:
        if self._call.error is not None:
            return self._call.error.code()
        return None if self._call.status is None else self._call.status[0]

    async def details(self) -> Optional[str]:
        if self._call.error is not None:
            return self._call.error.details()
        return None if self._call.status is None else self._call.status[1]


class _StreamStream:
    def __init__(self, channel, path, serializer, deserializer):
        self.channel, self.path = channel, path
        self.serializer, self.deserializer = serializer, deserializer

    def __call__(self, *, timeout: Optional[float] = None, metadata=None,
                 compression: Optional[str] = None) -> StreamStreamCall:
        return StreamStreamCall(_ClientCall(
            self.channel, self.path, self.serializer, self.deserializer,
            timeout, metadata, compression))


class Channel:
    """A client channel to ``host:port``: one HTTP/2 connection, made at
    the first call and made anew after the server closes or retires it."""

    def __init__(self, target: str):
        host, _, port = target.rpartition(":")
        self.host = host.strip("[]")
        self.port = int(port)
        self.authority = target
        self._conn: Optional[http2.Connection] = None
        self._lock = asyncio.Lock()

    async def _connection(self) -> http2.Connection:
        async with self._lock:
            if self._conn is None or not self._conn.usable:
                try:
                    self._conn = await http2.connect(self.host, self.port)
                except OSError as e:
                    raise RpcError(StatusCode.UNAVAILABLE,
                                   f"failed to connect to {self.authority}: "
                                   f"{e}") from None
            return self._conn

    def unary_unary(self, path: str, request_serializer: Callable,
                    response_deserializer: Callable) -> _UnaryUnary:
        return _UnaryUnary(self, path, request_serializer,
                           response_deserializer)

    def stream_stream(self, path: str, request_serializer: Callable,
                      response_deserializer: Callable) -> _StreamStream:
        return _StreamStream(self, path, request_serializer,
                             response_deserializer)

    async def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    async def __aenter__(self) -> "Channel":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()


def insecure_channel(target: str) -> Channel:
    return Channel(target)
