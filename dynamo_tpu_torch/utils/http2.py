"""An HTTP/2 connection over asyncio streams (RFC 9113), server and client.

The port's own HTTP/2 (the card's machine has no ``grpc`` nor ``h2``), under
the KServe gRPC entry point (``kserve/grpc.py``). One :class:`Connection`
serves either side; :class:`Server` accepts connections and runs a handler
per stream the peer opens, and :func:`connect` opens a client connection.
What it does on the wire:

- the client preface, and a SETTINGS frame from each side, each answered
  with a SETTINGS ACK; the peer's settings are applied as they come (a new
  ``INITIAL_WINDOW_SIZE`` moves every open stream's window by the change);
- HEADERS with CONTINUATION (a header block larger than the peer's
  ``MAX_FRAME_SIZE`` is split, and written as one piece so no other frame
  lands inside it; a received block must not be interleaved either), with
  padding and priority fields stripped; PRIORITY frames are ignored, and so
  are frame types it does not know;
- DATA, with flow control in both directions: it never sends past the
  peer's connection or stream window (a sender waits for WINDOW_UPDATE),
  and it credits the peer with WINDOW_UPDATE as its own reader consumes
  data, once half of the initial window (65,535 octets, never raised) has
  been consumed, so a peer is never stalled; padding is credited at once;
- PING answered with its ACK (grpc's C-core client sends BDP pings);
- RST_STREAM both ways (a stream reset by the peer wakes its reader and
  writer with :class:`StreamReset` and runs its ``on_reset`` callbacks, which
  is how a server learns that a client cancelled);
- ``SETTINGS_MAX_CONCURRENT_STREAMS``: a server refuses streams beyond its
  own limit with REFUSED_STREAM, and a client waits for a free slot under
  the peer's;
- GOAWAY: :meth:`Server.stop` sends it with the last stream it took, lets
  the streams in flight finish for a grace period, then cancels them and
  closes; a protocol error sends GOAWAY with its code and closes.

Header names and values are ``str`` with one character per octet (see
``utils/hpack.py``).
"""

from __future__ import annotations

import asyncio
import struct
from collections import deque
from typing import (
    Awaitable, Callable, Deque, Dict, List, Optional, Sequence, Set, Tuple,
)

from ..utils.logging import get_logger
from . import hpack

log = get_logger("http2")

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types
DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS = 0x0, 0x1, 0x2, 0x3, 0x4
PUSH_PROMISE, PING, GOAWAY, WINDOW_UPDATE, CONTINUATION = \
    0x5, 0x6, 0x7, 0x8, 0x9
# flags
END_STREAM = ACK = 0x1
END_HEADERS, PADDED, PRIORITY_FLAG = 0x4, 0x8, 0x20
# settings (HEADER_TABLE_SIZE, 0x1, and MAX_HEADER_LIST_SIZE, 0x6, need
# nothing here: the encoder never fills the peer's table)
ENABLE_PUSH, MAX_CONCURRENT_STREAMS = 0x2, 0x3
INITIAL_WINDOW_SIZE, MAX_FRAME_SIZE = 0x4, 0x5
# error codes
NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR = 0x0, 0x1, \
    0x2, 0x3
STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL = 0x5, 0x6, 0x7, 0x8
COMPRESSION_ERROR = 0x9

DEFAULT_WINDOW = 65535
MAX_WINDOW = 2 ** 31 - 1
DEFAULT_MAX_FRAME = 16384
MAX_FRAME_LIMIT = 2 ** 24 - 1
DEFAULT_MAX_STREAMS = 100
_HEAD = struct.Struct(">I")

Header = Tuple[str, str]


class H2Error(Exception):
    """A connection error: the connection sends GOAWAY with ``code`` and
    closes."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


class StreamReset(Exception):
    """The stream was reset (by the peer, by this side, or because the
    connection went away)."""

    def __init__(self, code: int, message: str = ""):
        super().__init__(message or f"stream reset with code {code}")
        self.code = code


class Stream:
    """One stream of a :class:`Connection`."""

    def __init__(self, conn: "Connection", stream_id: int):
        self.conn = conn
        self.id = stream_id
        self.headers: Optional[List[Header]] = None   # the first block
        self.trailers: Optional[List[Header]] = None  # a later block
        self.send_window = conn.peer_initial_window
        self.local_closed = False     # this side sent END_STREAM
        self.remote_closed = False    # the peer sent END_STREAM
        self.reset_code: Optional[int] = None
        self.on_reset: List[Callable[[int], None]] = []
        self._chunks: Deque[bytes] = deque()
        self._event = asyncio.Event()   # headers, data, end or reset came
        self._uncredited = 0

    # ------------------------------ receive --------------------------------

    def _wake(self) -> None:
        self._event.set()

    async def _wait(self) -> None:
        self._event.clear()
        await self._event.wait()

    def _check(self) -> None:
        if self.reset_code is not None:
            raise StreamReset(self.reset_code)

    async def read_headers(self) -> List[Header]:
        """The first header block (waits for it)."""
        while self.headers is None:
            self._check()
            await self._wait()
        return self.headers

    async def read_data(self) -> Optional[bytes]:
        """The next DATA payload, or None once the peer ended the stream.
        Reading it credits the peer's windows."""
        while not self._chunks:
            if self.remote_closed:
                return None
            self._check()
            await self._wait()
        chunk = self._chunks.popleft()
        self.conn._consumed(self, len(chunk))
        return chunk

    # ------------------------------- send ----------------------------------

    async def send_headers(self, headers: Sequence[Header],
                           end_stream: bool = False) -> None:
        self._check()
        self.conn._send_headers(self, headers, end_stream)
        await self.conn._drain()

    async def send_data(self, data: bytes, end_stream: bool = False) -> None:
        await self.conn._send_data(self, data, end_stream)

    def reset(self, code: int = CANCEL) -> None:
        """Send RST_STREAM (once) and close the stream on this side."""
        if self.reset_code is None and not (self.local_closed
                                             and self.remote_closed):
            self.conn._write_frame(RST_STREAM, 0, self.id,
                                   _HEAD.pack(code))
            self.conn._closed_stream(self, code, run_callbacks=False)

    @property
    def done(self) -> bool:
        return self.reset_code is not None or (self.local_closed
                                               and self.remote_closed)


class Connection:
    """One HTTP/2 connection. ``handler`` (a server's) is called with each
    stream the peer opens, as a task of its own, once its first header
    block has arrived."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, *, client: bool,
                 handler: Optional[Callable[[Stream], Awaitable]] = None,
                 max_concurrent_streams: int = DEFAULT_MAX_STREAMS):
        self.reader = reader
        self.writer = writer
        self.client = client
        self.handler = handler
        self.max_concurrent_streams = max_concurrent_streams
        self.decoder = hpack.Decoder()
        self.streams: Dict[int, Stream] = {}
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = DEFAULT_MAX_FRAME
        self.peer_max_streams: Optional[int] = None   # no limit until told
        self.send_window = DEFAULT_WINDOW
        self.next_stream_id = 1 if client else 2
        self.last_peer_stream = 0
        self.goaway_sent = False
        self.goaway_received: Optional[int] = None   # the peer's last id
        self.closed = asyncio.Event()
        self.handler_tasks: Set[asyncio.Task] = set()
        self._uncredited = 0
        self._window_event = asyncio.Event()
        self._slot_event = asyncio.Event()
        self._reader_task: Optional[asyncio.Task] = None
        self._block: Optional[Tuple[Stream, int, bytearray]] = None

    # ------------------------------ lifecycle ------------------------------

    def start(self) -> None:
        if self.client:
            self.writer.write(PREFACE)
        # our settings: the defaults, push off (a client), a stream limit
        # (a server); the windows stay at 65,535
        settings = [(ENABLE_PUSH, 0)] if self.client else [
            (MAX_CONCURRENT_STREAMS, self.max_concurrent_streams)]
        self._write_frame(SETTINGS, 0, 0, b"".join(
            struct.pack(">HI", k, v) for k, v in settings))
        self._reader_task = asyncio.get_running_loop().create_task(
            self._read_loop())

    def close(self, code: int = NO_ERROR, message: str = "") -> None:
        """Send GOAWAY (unless sent), reset every stream, drop the
        socket."""
        if self.closed.is_set():
            return
        if not self.goaway_sent:
            self.goaway(code, message)
        self.closed.set()
        for stream in list(self.streams.values()):
            self._closed_stream(stream, CANCEL)
        self._window_event.set()
        self._slot_event.set()
        try:
            self.writer.close()
        except Exception:   # already gone
            pass
        task = self._reader_task
        if task is not None and task is not asyncio.current_task():
            task.cancel()

    def goaway(self, code: int = NO_ERROR, message: str = "") -> None:
        self.goaway_sent = True
        self._write_frame(GOAWAY, 0, 0, struct.pack(
            ">II", self.last_peer_stream, code) + message.encode()[:256])

    @property
    def usable(self) -> bool:
        """Whether a client may still open streams here."""
        return not self.closed.is_set() and self.goaway_received is None \
            and not self.goaway_sent

    # ------------------------------- frames --------------------------------

    def _write_frame(self, type_: int, flags: int, stream_id: int,
                     payload: bytes = b"") -> None:
        if self.closed.is_set():
            return
        n = len(payload)
        self.writer.write(bytes((n >> 16, (n >> 8) & 0xFF, n & 0xFF, type_,
                                 flags)) + _HEAD.pack(stream_id) + payload)

    async def _drain(self) -> None:
        if self.closed.is_set():
            return
        try:
            await self.writer.drain()
        except (ConnectionError, RuntimeError) as e:
            self.close(INTERNAL_ERROR)
            raise StreamReset(CANCEL, f"connection lost: {e}") from None

    async def _read_loop(self) -> None:
        try:
            if not self.client:
                if await self.reader.readexactly(len(PREFACE)) != PREFACE:
                    raise H2Error(PROTOCOL_ERROR, "bad client preface")
            while True:
                head = await self.reader.readexactly(9)
                n = (head[0] << 16) | (head[1] << 8) | head[2]
                type_, flags = head[3], head[4]
                sid = _HEAD.unpack_from(head, 5)[0] & 0x7FFFFFFF
                if n > DEFAULT_MAX_FRAME:
                    raise H2Error(FRAME_SIZE_ERROR, f"frame of {n} octets")
                payload = await self.reader.readexactly(n) if n else b""
                self._on_frame(type_, flags, sid, payload)
        except asyncio.CancelledError:
            raise
        except H2Error as e:
            log.warning("http2 connection error %d: %s", e.code, e)
            self.close(e.code, str(e))
        except hpack.HpackError as e:
            log.warning("http2 header compression error: %s", e)
            self.close(COMPRESSION_ERROR, str(e))
        except (asyncio.IncompleteReadError, ConnectionError, OSError):
            self.close()
        except Exception:
            log.exception("http2 reader failed")
            self.close(INTERNAL_ERROR)

    def _on_frame(self, type_: int, flags: int, sid: int,
                  payload: bytes) -> None:
        if self._block is not None and type_ != CONTINUATION:
            raise H2Error(PROTOCOL_ERROR, "frame inside a header block")
        if type_ == DATA:
            self._on_data(flags, sid, payload)
        elif type_ == HEADERS:
            self._on_headers(flags, sid, payload)
        elif type_ == CONTINUATION:
            if self._block is None or self._block[0].id != sid:
                raise H2Error(PROTOCOL_ERROR, "stray CONTINUATION")
            self._block[2].extend(payload)
            if flags & END_HEADERS:
                stream, end, block = self._block
                self._block = None
                self._header_block(stream, bytes(block), end)
        elif type_ == SETTINGS:
            self._on_settings(flags, sid, payload)
        elif type_ == WINDOW_UPDATE:
            self._on_window_update(sid, payload)
        elif type_ == PING:
            if len(payload) != 8 or sid:
                raise H2Error(FRAME_SIZE_ERROR, "bad PING")
            if not flags & ACK:
                self._write_frame(PING, ACK, 0, payload)
        elif type_ == RST_STREAM:
            if len(payload) != 4 or not sid:
                raise H2Error(PROTOCOL_ERROR, "bad RST_STREAM")
            stream = self.streams.get(sid)
            if stream is not None:
                self._closed_stream(stream, _HEAD.unpack(payload)[0])
        elif type_ == GOAWAY:
            if len(payload) < 8 or sid:
                raise H2Error(FRAME_SIZE_ERROR, "bad GOAWAY")
            last = _HEAD.unpack_from(payload, 0)[0] & 0x7FFFFFFF
            self.goaway_received = last
            for stream in list(self.streams.values()):
                if self._ours(stream.id) and stream.id > last:
                    self._closed_stream(stream, REFUSED_STREAM)
            self._slot_event.set()
        elif type_ == PUSH_PROMISE:
            raise H2Error(PROTOCOL_ERROR, "push is disabled")
        elif type_ == PRIORITY:
            if len(payload) != 5:
                raise H2Error(FRAME_SIZE_ERROR, "bad PRIORITY")
        # unknown frame types are ignored (RFC 9113 4.1)

    def _ours(self, sid: int) -> bool:
        return (sid % 2 == 1) == self.client

    @staticmethod
    def _unpad(flags: int, payload: bytes) -> Tuple[bytes, int]:
        if not flags & PADDED:
            return payload, 0
        if not payload or payload[0] >= len(payload):
            raise H2Error(PROTOCOL_ERROR, "padding exceeds the frame")
        pad = payload[0]
        return payload[1:len(payload) - pad], pad + 1

    def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        if not sid:
            raise H2Error(PROTOCOL_ERROR, "DATA on stream 0")
        body, padding = self._unpad(flags, payload)
        stream = self.streams.get(sid)
        if stream is None or stream.remote_closed:
            # a stream this side reset or finished: the octets still count
            # against the connection window
            self._consumed(None, len(payload))
            return
        if padding:
            self._consumed(stream, padding)
        if body:
            stream._chunks.append(body)
        if flags & END_STREAM:
            self._remote_end(stream)
        stream._wake()

    def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        if not sid:
            raise H2Error(PROTOCOL_ERROR, "HEADERS on stream 0")
        block, _ = self._unpad(flags, payload)
        if flags & PRIORITY_FLAG:
            block = block[5:]
        stream = self.streams.get(sid)
        if stream is None:
            if self._ours(sid) or sid <= self.last_peer_stream:
                # a late block on a stream that is over: it is decoded all
                # the same, to keep the HPACK context in step
                stream = Stream(self, sid)
                stream.reset_code = STREAM_CLOSED
            elif self.client:
                raise H2Error(PROTOCOL_ERROR, f"HEADERS on stream {sid}")
            else:
                self.last_peer_stream = sid
                stream = Stream(self, sid)
                if self.goaway_sent or len(self.streams) \
                        >= self.max_concurrent_streams:
                    self._write_frame(RST_STREAM, 0, sid,
                                      _HEAD.pack(REFUSED_STREAM))
                    stream.reset_code = REFUSED_STREAM
                else:
                    self.streams[sid] = stream
        end = bool(flags & END_STREAM)
        if flags & END_HEADERS:
            self._header_block(stream, block, end)
        else:
            self._block = (stream, end, bytearray(block))

    def _header_block(self, stream: Stream, block: bytes, end: bool) -> None:
        headers = self.decoder.decode(block)
        if stream.reset_code is not None:
            return
        new = stream.headers is None
        if new:
            stream.headers = headers
        else:
            stream.trailers = headers
        if end:
            self._remote_end(stream)
        stream._wake()
        if new and not self.client and self.handler is not None:
            task = asyncio.get_running_loop().create_task(
                self._run_handler(stream))
            self.handler_tasks.add(task)
            task.add_done_callback(self.handler_tasks.discard)

    async def _run_handler(self, stream: Stream) -> None:
        try:
            await self.handler(stream)
        # a reset or cancelled handler ends here: the finally below closes
        # its stream, and nothing awaits the task's result
        except (StreamReset, asyncio.CancelledError):  # dynalint: disable=DT303
            pass
        except Exception:
            log.exception("http2 stream handler failed")
        finally:
            if not stream.done:
                stream.reset(INTERNAL_ERROR if not stream.local_closed
                             else NO_ERROR)

    def _remote_end(self, stream: Stream) -> None:
        stream.remote_closed = True
        if stream.local_closed:
            self._forget(stream)

    def _forget(self, stream: Stream) -> None:
        if self.streams.pop(stream.id, None) is not None:
            self._slot_event.set()

    def _closed_stream(self, stream: Stream, code: int,
                       run_callbacks: bool = True) -> None:
        """The stream is reset (by either side) or the connection is gone:
        wake its reader and writer, and tell its owner."""
        if stream.reset_code is None:
            stream.reset_code = code
            stream._wake()
            if run_callbacks:
                for cb in stream.on_reset:
                    cb(code)
        if not stream.remote_closed:
            # its buffered data is never read now: credit the connection
            # (after the peer's END_STREAM the data is whole, and a
            # RST_STREAM, such as NO_ERROR after a full response, leaves it
            # to be read)
            pending = sum(len(c) for c in stream._chunks)
            stream._chunks.clear()
            if pending and not self.closed.is_set():
                self._consumed(None, pending)
        self._forget(stream)
        self._window_event.set()

    def _on_settings(self, flags: int, sid: int, payload: bytes) -> None:
        if sid:
            raise H2Error(PROTOCOL_ERROR, "SETTINGS on a stream")
        if flags & ACK:
            return
        if len(payload) % 6:
            raise H2Error(FRAME_SIZE_ERROR, "bad SETTINGS length")
        for off in range(0, len(payload), 6):
            key, value = struct.unpack_from(">HI", payload, off)
            if key == INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise H2Error(FLOW_CONTROL_ERROR, "window too large")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                for stream in self.streams.values():
                    stream.send_window += delta
            elif key == MAX_FRAME_SIZE:
                if not DEFAULT_MAX_FRAME <= value <= MAX_FRAME_LIMIT:
                    raise H2Error(PROTOCOL_ERROR, "bad MAX_FRAME_SIZE")
                self.peer_max_frame = value
            elif key == MAX_CONCURRENT_STREAMS:
                self.peer_max_streams = value
            elif key == ENABLE_PUSH and value > 1:
                raise H2Error(PROTOCOL_ERROR, "bad ENABLE_PUSH")
        self._write_frame(SETTINGS, ACK, 0)
        self._notify_window()
        self._slot_event.set()

    def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise H2Error(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
        inc = _HEAD.unpack(payload)[0] & 0x7FFFFFFF
        if not sid:
            if inc == 0:
                raise H2Error(PROTOCOL_ERROR, "WINDOW_UPDATE of 0")
            self.send_window += inc
            if self.send_window > MAX_WINDOW:
                raise H2Error(FLOW_CONTROL_ERROR, "connection window "
                              "overflow")
        else:
            stream = self.streams.get(sid)
            if stream is None:
                return
            if inc == 0:
                stream.reset(PROTOCOL_ERROR)
                return
            stream.send_window += inc
            if stream.send_window > MAX_WINDOW:
                stream.reset(FLOW_CONTROL_ERROR)
                return
        self._notify_window()

    def _notify_window(self) -> None:
        self._window_event.set()

    # ---------------------------- flow control -----------------------------

    def _consumed(self, stream: Optional[Stream], n: int) -> None:
        """``n`` octets left the receive buffers: credit the peer once half
        of a window has been consumed."""
        if not n:
            return
        threshold = DEFAULT_WINDOW // 2
        self._uncredited += n
        if self._uncredited >= threshold:
            self._write_frame(WINDOW_UPDATE, 0, 0,
                              _HEAD.pack(self._uncredited))
            self._uncredited = 0
        if stream is not None and not stream.remote_closed \
                and stream.reset_code is None:
            stream._uncredited += n
            if stream._uncredited >= threshold:
                self._write_frame(WINDOW_UPDATE, 0, stream.id,
                                  _HEAD.pack(stream._uncredited))
                stream._uncredited = 0

    # ------------------------------- sending -------------------------------

    def _send_headers(self, stream: Stream, headers: Sequence[Header],
                      end_stream: bool) -> None:
        if self.closed.is_set():
            raise StreamReset(CANCEL, "connection closed")
        if stream.local_closed:
            raise StreamReset(STREAM_CLOSED, "stream already ended")
        block = hpack.encode(headers)
        size = self.peer_max_frame
        pieces = [block[i:i + size] for i in range(0, len(block), size)] \
            or [b""]
        frames = []
        for i, piece in enumerate(pieces):
            last = i == len(pieces) - 1
            if i == 0:
                flags = (END_STREAM if end_stream else 0) \
                    | (END_HEADERS if last else 0)
                frames.append((HEADERS, flags, piece))
            else:
                frames.append((CONTINUATION, END_HEADERS if last else 0,
                               piece))
        # one write: no frame of another stream can land inside the block
        self.writer.write(b"".join(
            bytes((len(p) >> 16, (len(p) >> 8) & 0xFF, len(p) & 0xFF, t, f))
            + _HEAD.pack(stream.id) + p for t, f, p in frames))
        if end_stream:
            self._local_end(stream)

    def _local_end(self, stream: Stream) -> None:
        stream.local_closed = True
        if stream.remote_closed:
            self._forget(stream)

    async def _send_data(self, stream: Stream, data: bytes,
                         end_stream: bool) -> None:
        view = memoryview(data)
        while True:
            stream._check()
            if self.closed.is_set():
                raise StreamReset(CANCEL, "connection closed")
            if stream.local_closed:
                raise StreamReset(STREAM_CLOSED, "stream already ended")
            if not view:
                if end_stream:
                    self._write_frame(DATA, END_STREAM, stream.id)
                    self._local_end(stream)
                break
            n = min(len(view), stream.send_window, self.send_window,
                    self.peer_max_frame)
            if n <= 0:
                self._window_event.clear()
                await self._window_event.wait()
                continue
            last = n == len(view)
            flags = END_STREAM if (end_stream and last) else 0
            stream.send_window -= n
            self.send_window -= n
            self._write_frame(DATA, flags, stream.id, bytes(view[:n]))
            view = view[n:]
            if flags:
                self._local_end(stream)
                break
            await self._drain()
        await self._drain()

    # -------------------------------- client -------------------------------

    async def request(self, headers: Sequence[Header],
                      end_stream: bool = False) -> Stream:
        """Open a stream (waiting for a slot under the peer's
        ``MAX_CONCURRENT_STREAMS``) and send its header block."""
        while True:
            if not self.usable:
                raise StreamReset(REFUSED_STREAM, "connection going away")
            limit = self.peer_max_streams
            if limit is None or len(self.streams) < limit:
                break
            self._slot_event.clear()
            await self._slot_event.wait()
        stream = Stream(self, self.next_stream_id)
        self.next_stream_id += 2
        self.streams[stream.id] = stream
        # no await between taking the id and sending the block: ids go out
        # in order
        self._send_headers(stream, headers, end_stream)
        await self._drain()
        return stream


async def connect(host: str, port: int) -> Connection:
    reader, writer = await asyncio.open_connection(host, port)
    conn = Connection(reader, writer, client=True)
    conn.start()
    return conn


class Server:
    """Accepts HTTP/2 connections (prior knowledge, no TLS) and runs
    ``handler(stream)`` for each stream a client opens."""

    def __init__(self, handler: Callable[[Stream], Awaitable],
                 max_concurrent_streams: int = DEFAULT_MAX_STREAMS):
        self.handler = handler
        self.max_concurrent_streams = max_concurrent_streams
        self.connections: Set[Connection] = set()
        self._server: Optional[asyncio.AbstractServer] = None
        self.port = 0

    async def start(self, host: str, port: int) -> int:
        self._server = await asyncio.start_server(self._accept, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def _accept(self, reader, writer) -> None:
        conn = Connection(reader, writer, client=False, handler=self.handler,
                          max_concurrent_streams=self.max_concurrent_streams)
        self.connections.add(conn)
        conn.start()
        try:
            await conn.closed.wait()
        finally:
            self.connections.discard(conn)

    async def stop(self, grace: Optional[float] = None) -> None:
        """Stop taking connections and streams (GOAWAY), give the streams
        in flight ``grace`` seconds to finish, cancel the rest, close."""
        if self._server is None:
            return
        self._server.close()
        conns = list(self.connections)
        for conn in conns:
            if not conn.closed.is_set():
                conn.goaway()
        tasks = [t for conn in conns for t in conn.handler_tasks]
        if tasks and grace:
            await asyncio.wait(tasks, timeout=grace)
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        for conn in conns:
            try:   # the last frames out, unless the peer stopped reading
                await asyncio.wait_for(conn._drain(), 1.0)
            except (StreamReset, asyncio.TimeoutError):
                pass
            conn.close()
        await self._server.wait_closed()
        self._server = None
