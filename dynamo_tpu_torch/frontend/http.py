"""A small HTTP/1.1 server on ``asyncio.start_server``.

The port's stand-in for the part of ``aiohttp.web`` that the OpenAI frontend
and the system server use (the card's machine does not install aiohttp): an
:class:`Application` of routes (exact paths, or aiohttp's ``{name}``
segments, read back from ``request.match_info``), :class:`Request` with
``headers``, ``query`` and ``json()``, :class:`Response` /
:func:`json_response` for whole bodies, and :class:`StreamResponse` for
Server-Sent Events. What it does on the wire:

- reads the request line, the headers (at most ``MAX_HEADER_BYTES``, else
  431) and a ``Content-Length`` body (at most ``MAX_BODY_BYTES``, else 413);
- keeps the connection alive between requests unless the client asks to
  close it or speaks HTTP/1.0 without ``keep-alive``;
- sends a streamed response with chunked transfer encoding, draining the
  socket after every chunk;
- watches the socket while a handler runs: when the client goes away, the
  handler task is cancelled, which is how the service learns to kill the
  request (``CancelledError`` at its next ``await``);
- answers a request it cannot parse with 400 and drops the connection,
  logging one WARNING line; the server stays up;
- closes every live connection in :meth:`Application.stop`, since
  ``Server.wait_closed()`` waits for open handlers.
"""

from __future__ import annotations

import asyncio
import json
import re
from http import HTTPStatus
from typing import Any, Awaitable, Callable, Dict, List, Optional, Set, Tuple
from urllib.parse import parse_qsl, unquote

from ..utils.logging import get_logger

log = get_logger("frontend.http")

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 1024 ** 2       # aiohttp's client_max_size


def _reason(status: int) -> str:
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class BadRequest(Exception):
    """The bytes on the connection are not an HTTP/1.x request."""


class _Headers:
    """Case-insensitive, read-only header mapping."""

    def __init__(self, pairs: List[tuple]):
        self._d = {k.lower(): v for k, v in pairs}

    def get(self, name: str, default: Optional[str] = None) -> Optional[str]:
        return self._d.get(name.lower(), default)


class Request:
    def __init__(self, method: str, path: str, version: str,
                 headers: _Headers, body: bytes, conn: "_Connection",
                 query: str = ""):
        self.method = method
        self.path = path
        self.version = version
        self.headers = headers
        # the query string's parameters (the last value of a repeated name)
        self.query: Dict[str, str] = dict(parse_qsl(query))
        # the path's ``{name}`` segments of the route that matched
        self.match_info: Dict[str, str] = {}
        self._body = body
        self._conn = conn

    async def json(self) -> Any:
        return json.loads(self._body.decode("utf-8"))

    @property
    def keep_alive(self) -> bool:
        conn = (self.headers.get("Connection") or "").lower()
        if self.version == "HTTP/1.0":
            return conn == "keep-alive"
        return conn != "close"


class Response:
    """A whole response: status, headers and body sent in one write."""

    def __init__(self, *, status: int = 200, body: bytes = b"",
                 text: Optional[str] = None,
                 content_type: str = "application/octet-stream",
                 charset: Optional[str] = None,
                 headers: Optional[Dict[str, str]] = None):
        if text is not None:
            body, charset = text.encode(), charset or "utf-8"
            if content_type == "application/octet-stream":
                content_type = "text/plain"
        self.status = status
        self.body = body
        self.headers = dict(headers or {})
        self.headers.setdefault(
            "Content-Type",
            content_type + (f"; charset={charset}" if charset else ""))

    def encode(self, keep_alive: bool) -> bytes:
        head = [f"HTTP/1.1 {self.status} {_reason(self.status)}"]
        head += [f"{k}: {v}" for k, v in self.headers.items()]
        head.append(f"Content-Length: {len(self.body)}")
        if not keep_alive:
            head.append("Connection: close")
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + self.body


def json_response(data: Any, *, status: int = 200,
                  headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(status=status, body=json.dumps(data).encode(),
                    content_type="application/json", charset="utf-8",
                    headers=headers)


class StreamResponse:
    """A response whose body the handler writes as it goes, in chunked
    transfer encoding."""

    def __init__(self, *, status: int = 200,
                 headers: Optional[Dict[str, str]] = None):
        self.status = status
        self.headers = dict(headers or {})
        self._conn: Optional[_Connection] = None
        self.finished = False

    async def prepare(self, request: Request) -> None:
        self._conn = request._conn
        head = [f"HTTP/1.1 {self.status} {_reason(self.status)}"]
        head += [f"{k}: {v}" for k, v in self.headers.items()
                 if k.lower() not in ("connection", "transfer-encoding")]
        head += ["Transfer-Encoding: chunked",
                 "Connection: keep-alive" if request.keep_alive
                 else "Connection: close"]
        await self._send(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))

    async def _send(self, data: bytes) -> None:
        writer = self._conn.writer
        if writer.transport.is_closing():
            raise ConnectionResetError("client connection closed")
        writer.write(data)
        await writer.drain()

    async def write(self, data: bytes) -> None:
        if data:
            await self._send(b"%x\r\n%s\r\n" % (len(data), data))

    async def write_eof(self) -> None:
        if not self.finished:
            self.finished = True
            await self._send(b"0\r\n\r\n")


Handler = Callable[[Request], Awaitable[Any]]


class RouteDef:
    def __init__(self, method: str, path: str, handler: Handler):
        self.method, self.path, self.handler = method, path, handler


def get(path: str, handler: Handler) -> List[RouteDef]:
    """A GET route, answering HEAD with the same head and no body."""
    return [RouteDef("GET", path, handler), RouteDef("HEAD", path, handler)]


def post(path: str, handler: Handler) -> RouteDef:
    return RouteDef("POST", path, handler)


def delete(path: str, handler: Handler) -> RouteDef:
    return RouteDef("DELETE", path, handler)


def _pattern(path: str) -> "re.Pattern[str]":
    """A route path with ``{name}`` segments as a regex that captures each
    (one path segment, as aiohttp's default)."""
    out, pos = [], 0
    for m in re.finditer(r"\{(\w+)\}", path):
        out.append(re.escape(path[pos:m.start()]))
        out.append(f"(?P<{m.group(1)}>[^/]+)")
        pos = m.end()
    out.append(re.escape(path[pos:]))
    return re.compile("".join(out))


class _Connection:
    """One client socket: the bytes read ahead of the current request and
    the writer."""

    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.pending = b""

    async def read_head(self, limit: int) -> Optional[bytes]:
        """The request line and headers, or None on a clean EOF between
        requests. Raises BadRequest past ``limit`` bytes or on EOF inside a
        head."""
        buf = bytearray(self.pending)
        self.pending = b""
        while True:
            end = buf.find(b"\r\n\r\n")
            if end > limit or end < 0 and len(buf) > limit:
                raise _TooLarge(431)
            if end >= 0:
                self.pending = bytes(buf[end + 4:])
                return bytes(buf[:end])
            chunk = await self.reader.read(65536)
            if not chunk:
                if buf.strip():
                    raise BadRequest("connection closed inside a request head")
                return None
            buf += chunk

    async def read_body(self, n: int) -> bytes:
        body = self.pending[:n]
        self.pending = self.pending[len(body):]
        if len(body) < n:
            body += await self.reader.readexactly(n - len(body))
        return body


class _TooLarge(Exception):
    def __init__(self, status: int):
        super().__init__(status)
        self.status = status


def _parse_head(head: bytes):
    try:
        lines = head.decode("latin-1").split("\r\n")
        method, target, version = lines[0].split(" ")
    except ValueError:
        raise BadRequest(f"bad request line {head[:60]!r}") from None
    if version not in ("HTTP/1.0", "HTTP/1.1") or not method.isalpha() \
            or not target.startswith("/"):
        raise BadRequest(f"bad request line {lines[0][:60]!r}")
    pairs = []
    for line in lines[1:]:
        name, sep, value = line.partition(":")
        if not sep or not name or name != name.strip():
            raise BadRequest(f"bad header line {line[:60]!r}")
        pairs.append((name, value.strip()))
    path, _, query = target.partition("?")
    return method, path, query, version, _Headers(pairs)


class Application:
    """Routes served over one listening socket: exact paths first, then
    paths with ``{name}`` segments in the order they were added."""

    def __init__(self):
        self._routes: Dict[str, Dict[str, Handler]] = {}
        self._patterns: List[Tuple["re.Pattern[str]", Dict[str, Handler]]] = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: Set[asyncio.Task] = set()
        self.port: Optional[int] = None

    def add_routes(self, routes: List[Any]) -> None:
        for r in routes:
            for one in r if isinstance(r, list) else [r]:
                if "{" not in one.path:
                    self._routes.setdefault(one.path, {})[one.method] = \
                        one.handler
                    continue
                pat = _pattern(one.path)
                for known, methods in self._patterns:
                    if known.pattern == pat.pattern:
                        methods[one.method] = one.handler
                        break
                else:
                    self._patterns.append((pat, {one.method: one.handler}))

    def _resolve(self, path: str):
        """(methods, match_info) of the route for ``path``, or (None, {})."""
        methods = self._routes.get(path)
        if methods is not None:
            return methods, {}
        for pat, methods in self._patterns:
            m = pat.fullmatch(path)
            if m:
                return methods, {k: unquote(v)
                                 for k, v in m.groupdict().items()}
        return None, {}

    async def start(self, host: str, port: int) -> int:
        """Listen; returns the bound port (``port`` 0 picks a free one)."""
        self._server = await asyncio.start_server(self._serve_conn, host,
                                                  port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is None:
            return
        self._server.close()
        for task in list(self._conns):
            task.cancel()
        await asyncio.gather(*self._conns, return_exceptions=True)
        await self._server.wait_closed()
        self._server = None

    # ------------------------------------------------------------------

    async def _serve_conn(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = _Connection(reader, writer)
        try:
            while await self._serve_one(conn):
                pass
        except BadRequest as e:
            peer = writer.get_extra_info("peername")
            log.warning("dropping connection from %s: %s", peer, e)
            await self._send_quietly(conn, Response(
                status=400, text="400: Bad Request"))
        except _TooLarge as e:
            await self._send_quietly(conn, Response(
                status=e.status, text=f"{e.status}: {_reason(e.status)}"))
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    @staticmethod
    async def _send_quietly(conn: _Connection, resp: Response) -> None:
        try:
            conn.writer.write(resp.encode(keep_alive=False))
            await conn.writer.drain()
        except ConnectionError:
            pass

    async def _serve_one(self, conn: _Connection) -> bool:
        """Serve one request; False when the connection is done."""
        head = await conn.read_head(MAX_HEADER_BYTES)
        if head is None:
            return False
        method, path, query, version, headers = _parse_head(head)
        if "chunked" in (headers.get("Transfer-Encoding") or "").lower():
            raise BadRequest("chunked request bodies are not supported")
        try:
            length = int(headers.get("Content-Length") or 0)
        except ValueError:
            raise BadRequest("bad Content-Length") from None
        if length < 0:
            raise BadRequest("bad Content-Length")
        if length > MAX_BODY_BYTES:
            raise _TooLarge(413)
        body = await conn.read_body(length)
        request = Request(method, path, version, headers, body, conn, query)
        methods, request.match_info = self._resolve(path)
        if methods is None:
            resp = Response(status=404, text="404: Not Found")
        elif method not in methods:
            resp = Response(status=405, text="405: Method Not Allowed",
                            headers={"Allow": ",".join(sorted(methods))})
        else:
            resp = await self._run_handler(methods[method], request)
            if resp is None:        # the client went away
                return False
        if isinstance(resp, StreamResponse):
            await resp.write_eof()
        else:
            data = resp.encode(request.keep_alive)
            if method == "HEAD":
                data = data[:len(data) - len(resp.body)]
            conn.writer.write(data)
            await conn.writer.drain()
        return request.keep_alive

    async def _run_handler(self, handler: Handler, request: Request):
        """Run the handler while watching the socket. A client that closes
        its end cancels the handler (None is returned); bytes that arrive
        meanwhile (a pipelined request) are kept for the next read."""
        conn = request._conn
        work = asyncio.ensure_future(handler(request))
        watch = asyncio.ensure_future(conn.reader.read(65536))
        try:
            while True:
                done, _ = await asyncio.wait(
                    {work, watch} if watch is not None else {work},
                    return_when=asyncio.FIRST_COMPLETED)
                if work in done:
                    try:
                        return work.result()
                    except Exception:
                        log.exception("%s %s failed", request.method,
                                      request.path)
                        return Response(status=500,
                                        text="500: Internal Server Error")
                data = watch.result()
                if data:
                    conn.pending += data
                    watch = None
                    continue
                work.cancel()
                try:
                    await work
                except asyncio.CancelledError:
                    if not work.cancelled() or \
                            asyncio.current_task().cancelling():
                        raise
                except Exception:
                    log.exception("handler failed after the client left")
                return None
        finally:
            if not work.done():   # we were cancelled ourselves (stop())
                work.cancel()
                await asyncio.gather(work, return_exceptions=True)
            if watch is not None:
                # the reader takes one waiter at a time: settle the watch
                # before the next read, keeping bytes it got meanwhile
                watch.cancel()
                got = (await asyncio.gather(watch,
                                            return_exceptions=True))[0]
                if isinstance(got, bytes):
                    conn.pending += got
