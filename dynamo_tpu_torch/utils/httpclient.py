"""A small HTTP/1.1 client on ``asyncio.open_connection`` (and ``ssl``).

The port's stand-in for the ``aiohttp`` client, which the card's machine
does not install. It covers what the planner's Kubernetes connector and the
replay driver's HTTP target need: one kept-alive connection per client for
plain requests (JSON and merge-patch bodies, any method, a query string),
responses framed by ``Content-Length``, chunked transfer encoding or the
close of the connection, a total timeout per request, and a body streamed
line by line (server-sent events) on a connection of its own.
"""

from __future__ import annotations

import asyncio
import json
import ssl
from dataclasses import dataclass, field
from typing import AsyncIterator, Dict, Optional, Tuple
from urllib.parse import urlencode, urlsplit


@dataclass
class HttpResponse:
    status: int
    headers: Dict[str, str] = field(default_factory=dict)
    body: bytes = b""

    def text(self) -> str:
        return self.body.decode("utf-8", errors="replace")

    def json(self):
        return json.loads(self.body) if self.body else None


class _Conn:
    def __init__(self, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


async def _read_head(reader: asyncio.StreamReader
                     ) -> Tuple[int, Dict[str, str]]:
    line = await reader.readline()
    if not line:
        raise ConnectionResetError("connection closed before a response")
    parts = line.decode("latin-1").split(None, 2)
    if len(parts) < 2 or not parts[0].startswith("HTTP/"):
        raise ConnectionError(f"bad status line {line[:80]!r}")
    status = int(parts[1])
    headers: Dict[str, str] = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        name, _, value = line.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    return status, headers


async def _body_chunks(reader: asyncio.StreamReader, headers: Dict[str, str],
                       method: str, status: int) -> AsyncIterator[bytes]:
    """The response body's bytes as they arrive, per its framing."""
    if method == "HEAD" or status in (204, 304) or 100 <= status < 200:
        return
    if "chunked" in headers.get("transfer-encoding", "").lower():
        while True:
            size_line = await reader.readline()
            if not size_line:
                raise ConnectionResetError("chunked body cut short")
            size = int(size_line.split(b";")[0].strip() or b"0", 16)
            if size == 0:
                while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return
            yield await reader.readexactly(size)
            await reader.readexactly(2)
    elif "content-length" in headers:
        left = int(headers["content-length"])
        while left > 0:
            data = await reader.read(min(left, 1 << 16))
            if not data:
                raise ConnectionResetError("body cut short")
            left -= len(data)
            yield data
    else:
        while True:
            data = await reader.read(1 << 16)
            if not data:
                return
            yield data


def _reusable(headers: Dict[str, str]) -> bool:
    framed = ("content-length" in headers
              or "chunked" in headers.get("transfer-encoding", "").lower())
    return framed and headers.get("connection", "").lower() != "close"


class HttpClient:
    """Requests against one base URL (``http://host:port`` or ``https://``).

    :meth:`request` keeps one connection alive between calls and opens a new
    one when the server closed it; :meth:`stream_lines` uses a connection of
    its own and closes it when the stream ends."""

    def __init__(self, base_url: str,
                 ssl_context: Optional[ssl.SSLContext] = None,
                 timeout_s: float = 30.0):
        u = urlsplit(base_url)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"unsupported URL scheme in {base_url!r}")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.prefix = u.path.rstrip("/")
        self.ssl = (ssl_context if ssl_context is not None
                    else (ssl.create_default_context()
                          if u.scheme == "https" else None))
        self.timeout_s = timeout_s
        self._conn: Optional[_Conn] = None
        self._lock = asyncio.Lock()

    @property
    def closed(self) -> bool:
        return self._conn is None

    async def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    async def _connect(self) -> _Conn:
        reader, writer = await asyncio.open_connection(
            self.host, self.port, ssl=self.ssl,
            server_hostname=self.host if self.ssl is not None else None)
        return _Conn(reader, writer)

    def _encode(self, method: str, path: str, body: Optional[bytes],
                headers: Optional[Dict[str, str]],
                params: Optional[Dict[str, str]], keep_alive: bool) -> bytes:
        target = self.prefix + path
        if params:
            target += ("&" if "?" in target else "?") + urlencode(params)
        hdrs = {"Host": (self.host if self.port in (80, 443)
                         else f"{self.host}:{self.port}"),
                "Connection": "keep-alive" if keep_alive else "close"}
        hdrs.update(headers or {})
        if body is not None or method in ("POST", "PUT", "PATCH"):
            hdrs["Content-Length"] = str(len(body or b""))
        head = f"{method} {target} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in hdrs.items()) + "\r\n"
        return head.encode("latin-1") + (body or b"")

    async def request(self, method: str, path: str, *,
                      body: Optional[bytes] = None,
                      headers: Optional[Dict[str, str]] = None,
                      params: Optional[Dict[str, str]] = None,
                      timeout_s: Optional[float] = None) -> HttpResponse:
        """One request on the kept-alive connection; the whole exchange is
        bounded by ``timeout_s`` (default: the client's)."""
        async with self._lock:
            return await asyncio.wait_for(
                self._request(method, path, body, headers, params),
                timeout=timeout_s or self.timeout_s)

    async def _request(self, method, path, body, headers, params
                       ) -> HttpResponse:
        payload = self._encode(method, path, body, headers, params, True)
        for attempt in range(2):
            reused = self._conn is not None
            if self._conn is None:
                self._conn = await self._connect()
            conn = self._conn
            try:
                conn.writer.write(payload)
                await conn.writer.drain()
                status, hdrs = await _read_head(conn.reader)
                data = b"".join([c async for c in _body_chunks(
                    conn.reader, hdrs, method, status)])
            except (ConnectionError, asyncio.IncompleteReadError):
                conn.close()
                self._conn = None
                if reused and attempt == 0:
                    continue  # the server closed the idle connection
                raise
            except BaseException:
                conn.close()
                self._conn = None
                raise
            if not _reusable(hdrs):
                conn.close()
                self._conn = None
            return HttpResponse(status, hdrs, data)
        raise ConnectionError("unreachable")

    async def stream_lines(self, method: str, path: str, *,
                           body: Optional[bytes] = None,
                           headers: Optional[Dict[str, str]] = None,
                           status_out: Optional[list] = None,
                           ) -> AsyncIterator[bytes]:
        """The response body line by line, as it arrives, on a connection
        of its own. The status code is appended to ``status_out`` before
        the first line; a status other than 200 ends the stream at once."""
        conn = await self._connect()
        try:
            conn.writer.write(self._encode(method, path, body, headers,
                                           None, False))
            await conn.writer.drain()
            status, hdrs = await _read_head(conn.reader)
            if status_out is not None:
                status_out.append(status)
            if status != 200:
                return
            buf = b""
            async for chunk in _body_chunks(conn.reader, hdrs, method,
                                            status):
                buf += chunk
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line, buf = buf[:nl + 1], buf[nl + 1:]
                    yield line
            if buf:
                yield buf
        finally:
            conn.close()

