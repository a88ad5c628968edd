"""Request-push + response-stream transport over TCP with a two-part codec.

The data plane between routers and workers. The reference pushes requests over
NATS and streams responses back over a separate TCP connection with a
length-prefixed two-part (header + payload) codec (ref: lib/runtime/src/
pipeline/network/egress/addressed_router.rs:29-161, tcp/server.rs:62,
codec/two_part.rs:11,157). Redesign: routers hold pooled,
multiplexed TCP connections directly to worker ingress servers — one
round-trip fewer than the NATS-push-then-TCP-connect-back handshake, same
capability (streaming, cancellation, backpressure via TCP flow control).

Frames are msgpack with a 4-byte length prefix (shared with the store codec).
Two-part shape preserved: a small control header dict + an opaque ``payload``
bytes field that hot paths pass through without re-encoding.

A copy of ``dynamo_tpu.runtime.transport`` on the package's own MessagePack
codec (:mod:`.codec`): a worker of either package serves a router of either.

Frame types:
  client → server:  {t: "req",    rid, headers: {...}, payload: bytes}
                    {t: "cancel", rid, kill: bool}
  server → client:  {t: "data",   rid, payload: bytes}
                    {t: "end",    rid}          (stream complete sentinel)
                    {t: "err",    rid, error, code}
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import AsyncIterator, Dict, Optional

from .. import tracing
from ..utils.logging import TraceContext, get_logger
from . import codec, faults
from .context import Context
from .engine import AsyncEngine
from .store import read_frame, write_frame

log = get_logger("transport")

# error codes surfaced to the Migration operator's retry policy
ERR_APP = "application"          # handler raised — not retryable
ERR_UNAVAILABLE = "unavailable"  # connect failed / conn dropped — retryable
ERR_OVERLOADED = "overloaded"    # worker rejected (busy threshold) — retryable
ERR_TIMEOUT = "deadline_exceeded"  # request deadline hit — NOT retryable
# planned drain: retryable divert-elsewhere, but NOT a failure signal — the
# router must never feed a draining rejection into a circuit breaker
ERR_DRAINING = "draining"

# request header carrying the remaining deadline budget in milliseconds;
# relative (not absolute) so clocks never need to agree across hosts
DEADLINE_HEADER = "x-deadline-ms"


class EngineError(RuntimeError):
    def __init__(self, message: str, code: str = ERR_APP):
        super().__init__(message)
        self.code = code


class IngressServer:
    """Worker-side endpoint server: accepts pushed requests, runs the handler
    engine, streams responses back (ref: pipeline/network/ingress/
    push_endpoint.rs)."""

    def __init__(
        self,
        engine: AsyncEngine,
        host: str = "0.0.0.0",
        port: int = 0,
        max_inflight: Optional[int] = None,
    ):
        self._engine = engine
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._inflight: Dict[str, asyncio.Task] = {}
        self._contexts: Dict[str, Context] = {}
        self._conn_writers: set = set()
        # plain counter, not a Semaphore: admission check + increment happen
        # atomically within one event-loop step, so there is no
        # check-then-acquire race window between concurrent requests
        self._max_inflight = max_inflight
        self._active = 0
        self.draining = False
        self._closing = False

    async def start(self) -> None:
        self._closing = False
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        # a connection accepted before this call whose handler has not run
        # yet is not in _conn_writers: its handler closes it on arrival
        # (wait_closed waits for every connection on Python 3.12)
        self._closing = True
        for task in list(self._inflight.values()):
            task.cancel()
        for writer in list(self._conn_writers):
            writer.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def join(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for in-flight requests to finish (graceful shutdown drain).
        Returns False when ``timeout_s`` elapsed with requests still live."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        while self._inflight:
            remaining = None
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
            await asyncio.wait(list(self._inflight.values()), timeout=remaining)
        return True

    async def drain(self, deadline_s: Optional[float] = None,
                    stop_grace_s: float = 2.0) -> bool:
        """Graceful drain: reject new work as ``draining``, wait for in-flight
        streams up to ``deadline_s``, then stop the stragglers gracefully.

        A deadline-stopped stream emits its tokens-so-far and ends WITHOUT a
        ``finished`` marker, which the client's Migration operator re-issues
        on another worker with token carryover — in-flight decodes migrate
        instead of dying. Returns True when fully drained."""
        self.draining = True
        if await self.join(deadline_s):
            return True
        log.warning(
            "drain deadline (%.1fs) hit with %d in-flight — stopping "
            "streams so clients migrate", deadline_s, len(self._inflight),
        )
        for ctx in list(self._contexts.values()):
            ctx.stop_generating()
        return await self.join(stop_grace_s)

    @property
    def num_inflight(self) -> int:
        return len(self._inflight)

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        write_lock = asyncio.Lock()
        conn_rids: set = set()
        if self._closing:
            writer.close()
            return
        self._conn_writers.add(writer)
        try:
            while True:
                msg = await read_frame(reader)
                if msg is None:
                    break
                t = msg.get("t")
                if t == "req":
                    rid = msg["rid"]
                    conn_rids.add(rid)
                    task = asyncio.create_task(
                        self._run_request(msg, writer, write_lock)
                    )
                    self._inflight[rid] = task
                    task.add_done_callback(
                        lambda _t, rid=rid: (
                            self._inflight.pop(rid, None),
                            self._contexts.pop(rid, None),
                            conn_rids.discard(rid),
                        )
                    )
                elif t == "cancel":
                    ctx = self._contexts.get(msg["rid"])
                    if ctx is not None:
                        if msg.get("kill"):
                            ctx.kill()
                        else:
                            ctx.stop_generating()
                elif t == "ping":
                    async with write_lock:
                        write_frame(writer, {"t": "pong"})
                        await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception:  # malformed frame / codec garbage: drop the conn
            log.warning("dropping ingress connection after bad frame",
                        exc_info=True)
        finally:
            # peer gone: kill every stream that was feeding this connection
            for rid in conn_rids:
                ctx = self._contexts.get(rid)
                if ctx is not None:
                    ctx.kill()
            self._conn_writers.discard(writer)
            writer.close()

    async def _run_request(
        self, msg: dict, writer: asyncio.StreamWriter, write_lock: asyncio.Lock
    ) -> None:
        rid = msg["rid"]

        async def send(obj: dict) -> None:
            async with write_lock:
                write_frame(writer, obj)
                await writer.drain()

        # admission control BEFORE any per-request state is registered: a
        # rejected request must leave no context/accounting behind
        if self.draining:
            await send({"t": "err", "rid": rid, "error": "draining",
                        "code": ERR_DRAINING})
            return
        fault = faults.active("worker.admit", rid)
        if fault is not None and fault.kind == faults.REJECT:
            await send({"t": "err", "rid": rid,
                        "error": "injected rejection", "code": fault.code})
            return
        if self._max_inflight is not None and self._active >= self._max_inflight:
            await send({"t": "err", "rid": rid, "error": "worker overloaded",
                        "code": ERR_OVERLOADED})
            return
        self._active += 1
        ctx: Optional[Context] = None
        span = None
        try:
            headers = msg.get("headers") or {}
            if not isinstance(headers, dict):
                headers = {}
            trace = None
            tp = headers.get("traceparent")
            if isinstance(tp, str):
                trace = TraceContext.parse(tp)
            # the worker's process-local root span adopts a child of the wire
            # trace context, so engine spans recorded under ctx parent here
            # while the span itself parents under the client's transport.send
            ing_trace = trace.child() if trace is not None else None
            span = tracing.get_tracer().start_span(
                "worker.ingress", trace=ing_trace,
                parent_span_id=(trace.span_id if trace is not None else None),
                attrs={"rid": rid}, root=True,
            )
            if ing_trace is None:
                ing_trace = TraceContext(
                    trace_id=span.trace_id, span_id=span.span_id
                )
            deadline = None
            budget_ms = headers.get(DEADLINE_HEADER)
            if isinstance(budget_ms, (int, float)):
                deadline = time.monotonic() + float(budget_ms) / 1000.0
            ctx = Context(request_id=headers.get("x-request-id") or rid,
                          trace=ing_trace, deadline=deadline)
            self._contexts[rid] = ctx
            if ctx.is_expired():
                # dead on arrival: never start generating for a request
                # whose client has already given up
                span.set_status("error", "deadline_on_arrival")
                await send({"t": "err", "rid": rid,
                            "error": "deadline expired before start",
                            "code": ERR_TIMEOUT})
                return
            request = codec.unpackb(msg["payload"])
            async for item in self._engine.generate(request, ctx):
                if ctx.is_killed():
                    break
                if ctx.is_expired():
                    # stop worker-side generation: free the slot, tell the
                    # client the budget is gone (not retryable upstream)
                    ctx.stop_generating()
                    span.set_status("error", ERR_TIMEOUT)
                    await send({"t": "err", "rid": rid,
                                "error": "deadline exceeded mid-stream",
                                "code": ERR_TIMEOUT})
                    return
                # with no plan installed this is one None check per frame
                fault = faults.active("worker.stream", rid)
                if fault is not None:
                    await faults.maybe_delay(fault)
                if fault is not None and fault.kind == faults.TRUNCATE:
                    # simulate a worker crash: the connection dies abruptly
                    # mid-stream, taking every stream on it down
                    span.set_status("error", "injected_crash")
                    ctx.kill()
                    writer.close()
                    return
                await send(
                    {"t": "data", "rid": rid,
                     "payload": codec.packb(item)}
                )
            if not ctx.is_killed():
                await send({"t": "end", "rid": rid})
        except asyncio.CancelledError:
            raise
        except (ConnectionResetError, BrokenPipeError):
            if ctx is not None:
                ctx.kill()
            if span is not None:
                span.set_status("error", "connection_lost")
        except EngineError as exc:
            if span is not None:
                span.set_status("error", exc.code)
            try:
                await send({"t": "err", "rid": rid, "error": str(exc),
                            "code": exc.code})
            except (ConnectionResetError, BrokenPipeError):
                pass
        except Exception as exc:  # noqa: BLE001
            log.exception("handler failed for request %s", rid)
            if span is not None:
                span.set_status("error", ERR_APP)
            try:
                await send({"t": "err", "rid": rid, "error": str(exc),
                            "code": ERR_APP})
            except (ConnectionResetError, BrokenPipeError):
                pass
        finally:
            if span is not None:
                span.end()
            self._active -= 1


class _Conn:
    """One multiplexed client connection with a demux reader."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.streams: Dict[str, asyncio.Queue] = {}
        self.write_lock = asyncio.Lock()
        self.reader_task: Optional[asyncio.Task] = None
        self.closed = False

    async def demux(self) -> None:
        while True:
            msg = await read_frame(self.reader)
            if msg is None:
                break
            q = self.streams.get(msg.get("rid"))
            if q is not None:
                q.put_nowait(msg)
        self.closed = True
        for q in self.streams.values():
            q.put_nowait(None)

    def close(self) -> None:
        self.closed = True
        if self.reader_task:
            self.reader_task.cancel()
        self.writer.close()


class TransportClient:
    """Router-side client: pooled multiplexed connections keyed by address."""

    def __init__(self):
        self._conns: Dict[str, _Conn] = {}
        self._rids = itertools.count(1)
        self._conn_locks: Dict[str, asyncio.Lock] = {}

    async def _get_conn(self, addr: str) -> _Conn:
        lock = self._conn_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            fault = await faults.maybe_delay(faults.active("client.connect", addr))
            if fault is not None and fault.kind in (faults.DROP, faults.REJECT):
                raise EngineError(
                    f"cannot connect to worker at {addr}: injected fault",
                    ERR_UNAVAILABLE,
                )
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
            host, port = addr.rsplit(":", 1)
            try:
                reader, writer = await asyncio.open_connection(host, int(port))
            except OSError as exc:
                raise EngineError(
                    f"cannot connect to worker at {addr}: {exc}", ERR_UNAVAILABLE
                ) from exc
            conn = _Conn(reader, writer)
            conn.reader_task = asyncio.create_task(conn.demux())
            self._conns[addr] = conn
            return conn

    async def close(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()

    async def generate(
        self, addr: str, request: object, context: Context
    ) -> AsyncIterator[object]:
        """Push a request to ``addr``; yield the response stream.

        Raises :class:`EngineError` with a retryability code — the Migration
        operator upstream decides whether to re-issue (ref: migration.rs:88).
        """
        remaining = context.time_remaining()
        if remaining is not None and remaining <= 0:
            raise EngineError(
                f"deadline expired before dispatch to {addr}", ERR_TIMEOUT
            )
        # the wire trace context IS the transport span: the worker parses it
        # from the traceparent header and parents its ingress span under it
        wire = context.trace.child()
        span = tracing.get_tracer().start_span(
            "transport.send", trace=wire,
            parent_span_id=context.trace.span_id, attrs={"addr": addr},
        )

        def _fail_span(code: str) -> None:
            if not span.ended:
                span.set_status("error", code)
                span.end()

        try:
            conn = await self._get_conn(addr)
        except EngineError as e:
            _fail_span(e.code)
            raise
        rid = f"{context.id}-{next(self._rids)}"
        queue: asyncio.Queue = asyncio.Queue()
        conn.streams[rid] = queue
        headers = {
            "traceparent": wire.traceparent(),
            "x-request-id": context.id,
        }
        if remaining is not None:
            headers[DEADLINE_HEADER] = int(remaining * 1000)
        fault = faults.active("client.send", addr)
        if fault is not None and fault.kind in (faults.DROP, faults.REJECT):
            conn.streams.pop(rid, None)
            _fail_span(ERR_UNAVAILABLE)
            raise EngineError(
                f"worker {addr} send failed: injected fault", ERR_UNAVAILABLE
            )
        try:
            async with conn.write_lock:
                write_frame(
                    conn.writer,
                    {"t": "req", "rid": rid, "headers": headers,
                     "payload": codec.packb(request)},
                )
                await conn.writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError) as exc:
            conn.streams.pop(rid, None)
            conn.close()
            _fail_span(ERR_UNAVAILABLE)
            raise EngineError(f"worker {addr} send failed: {exc}", ERR_UNAVAILABLE)

        # One long-lived watcher per stream injects a sentinel into the demux
        # queue when cancellation fires, so the per-token hot loop below is a
        # single queue.get() — no task creation per streamed item (the
        # reference keeps this path equally lean, ref: tcp/client.rs).
        _STOPPED = {"t": "_stopped"}

        async def _watch_stop() -> None:
            await context.wait_stopped()
            queue.put_nowait(_STOPPED)
            if not context.is_killed():
                # stop → kill escalation mid-drain needs a second wakeup
                await context.wait_killed()
                queue.put_nowait(_STOPPED)

        stop_task = asyncio.create_task(_watch_stop())
        cancel_sent = False
        try:
            while True:
                budget = context.time_remaining()
                if budget is None:
                    msg = await queue.get()
                else:
                    # a stalled worker must not outlive the request budget:
                    # bound the wait by the remaining deadline, then tell
                    # the worker to abandon the stream
                    try:
                        msg = await asyncio.wait_for(
                            queue.get(), max(budget, 0.001)
                        )
                    except asyncio.TimeoutError:
                        cancel_sent = True
                        await self._send_cancel(conn, rid, True)
                        _fail_span(ERR_TIMEOUT)
                        raise EngineError(
                            f"worker {addr} exceeded the request deadline",
                            ERR_TIMEOUT,
                        )
                if msg is None:
                    _fail_span(ERR_UNAVAILABLE)
                    raise EngineError(
                        f"worker {addr} connection dropped mid-stream",
                        ERR_UNAVAILABLE,
                    )
                t = msg.get("t")
                if t == "_stopped":
                    if context.is_killed():
                        cancel_sent = True
                        await self._send_cancel(conn, rid, True)
                        return
                    if not cancel_sent:
                        cancel_sent = True
                        await self._send_cancel(conn, rid, False)
                    # graceful stop: keep draining until the worker ends the
                    # stream (it emits the tokens generated so far)
                    continue
                if t == "data":
                    if not span.ended:
                        # the span measures push → first response frame;
                        # token streaming after that belongs to the engine
                        span.add_event("first_frame")
                        span.end()
                    yield codec.unpackb(msg["payload"])
                elif t == "end":
                    span.end()
                    return
                elif t == "err":
                    _fail_span(msg.get("code", ERR_APP))
                    raise EngineError(
                        msg.get("error", "worker error"),
                        msg.get("code", ERR_APP),
                    )
        finally:
            stop_task.cancel()
            conn.streams.pop(rid, None)
            _fail_span("closed_before_first_frame")
            if (context.is_stopped() or context.is_killed()) and not cancel_sent:
                await self._send_cancel(conn, rid, context.is_killed())

    async def _send_cancel(self, conn: _Conn, rid: str, kill: bool) -> None:
        if conn.closed:
            return
        try:
            async with conn.write_lock:
                write_frame(conn.writer, {"t": "cancel", "rid": rid, "kill": kill})
                await conn.writer.drain()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
