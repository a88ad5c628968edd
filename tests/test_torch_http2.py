"""The port's HTTP/2 (``utils/http2.py``) at its edges, driven by a raw
peer that writes and reads frames by hand: SETTINGS and PING answered with
their ACKs, a header block split into CONTINUATION frames, padded HEADERS
and DATA with a priority field, flow control (never past the peer's
window; WINDOW_UPDATE as data is read), ``MAX_CONCURRENT_STREAMS`` on both
sides, RST_STREAM reaching the handler, GOAWAY on stop with its grace
period, and a protocol error closing the connection. grpc's own peers
drive it in ``tests/test_torch_kserve_grpc.py``."""

import asyncio
import struct

import pytest

from dynamo_tpu_torch.utils import hpack, http2

pytestmark = pytest.mark.anyio


@pytest.fixture
def anyio_backend():
    return "asyncio"


def frame(type_, flags, sid, payload=b""):
    n = len(payload)
    return bytes((n >> 16, (n >> 8) & 0xFF, n & 0xFF, type_, flags)) \
        + struct.pack(">I", sid) + payload


class RawPeer:
    """A client that speaks frames by hand."""

    async def open(self, port):
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", port)
        self.writer.write(http2.PREFACE + frame(http2.SETTINGS, 0, 0))
        self.decoder = hpack.Decoder()
        return self

    def send(self, *frames):
        self.writer.write(b"".join(frames))

    async def read(self, timeout=5.0):
        head = await asyncio.wait_for(self.reader.readexactly(9), timeout)
        n = (head[0] << 16) | (head[1] << 8) | head[2]
        payload = await self.reader.readexactly(n) if n else b""
        return head[3], head[4], struct.unpack(">I", head[5:9])[0], payload

    async def read_until(self, pred, timeout=5.0):
        seen = []
        while True:
            f = await self.read(timeout)
            seen.append(f)
            if pred(f):
                return f, seen

    def close(self):
        self.writer.close()


REQ = [(":method", "POST"), (":scheme", "http"), (":path", "/x"),
       (":authority", "t")]


@pytest.fixture
async def server():
    streams = []
    release = asyncio.Event()

    async def handler(stream):
        streams.append(stream)
        path = dict(stream.headers)[":path"]
        if path == "/echo":
            body = b""
            while (chunk := await stream.read_data()) is not None:
                body += chunk
            await stream.send_headers([(":status", "200"),
                                       ("n", str(len(body)))])
            await stream.send_data(body, end_stream=True)
        elif path == "/big":
            await stream.send_headers([(":status", "200")])
            await stream.send_data(b"z" * 200_000, end_stream=True)
        elif path == "/early":
            # a whole response before the request is whole, then
            # RST_STREAM(NO_ERROR): the client may stop sending
            await stream.send_headers([(":status", "200")])
            await stream.send_data(b"abc" * 10_000, end_stream=True)
            stream.reset(http2.NO_ERROR)
        elif path == "/read":
            stream.seen = []
            stream.on_reset.append(lambda code: stream.seen.append(code))
            try:
                await stream.read_data()
            except http2.StreamReset as e:
                stream.seen.append(("raised", e.code))
        elif path == "/hold":
            try:
                await release.wait()
            except asyncio.CancelledError:
                stream.cancelled = True
                raise
            await stream.send_headers([(":status", "200")], end_stream=True)
        else:
            await stream.send_headers(
                [(":status", "200"), ("got", str(len(stream.headers)))],
                end_stream=True)

    srv = http2.Server(handler, max_concurrent_streams=2)
    port = await srv.start("127.0.0.1", 0)
    yield srv, port, streams, release
    await srv.stop()


async def test_settings_and_ping_are_acked(server):
    _, port, _, _ = server
    peer = await RawPeer().open(port)
    try:
        ftype, flags, _, payload = await peer.read()
        assert ftype == http2.SETTINGS and not flags & http2.ACK
        assert struct.unpack(">HI", payload) == (
            http2.MAX_CONCURRENT_STREAMS, 2)
        peer.send(frame(http2.SETTINGS, http2.ACK, 0),
                  frame(http2.PING, 0, 0, b"12345678"))
        f, seen = await peer.read_until(lambda f: f[0] == http2.PING)
        assert f == (http2.PING, http2.ACK, 0, b"12345678")
        assert (http2.SETTINGS, http2.ACK, 0, b"") in seen
    finally:
        peer.close()


async def test_continuation_padding_and_priority(server):
    _, port, _, _ = server
    peer = await RawPeer().open(port)
    try:
        headers = REQ + [(f"x-{i}", "v" * 500) for i in range(60)]
        block = hpack.encode(headers)
        assert len(block) > 16384
        first, rest = block[:9000], block[9000:]
        # HEADERS: padded, with a priority field, then CONTINUATIONs
        pad = 7
        payload = bytes([pad]) + b"\0\0\0\0\x10" + first + b"\0" * pad
        pieces = [rest[i:i + 10000] for i in range(0, len(rest), 10000)]
        assert len(pieces) >= 2
        peer.send(frame(http2.HEADERS, http2.PADDED | http2.PRIORITY_FLAG
                        | http2.END_STREAM, 1, payload),
                  *(frame(http2.CONTINUATION, http2.END_HEADERS
                          if i == len(pieces) - 1 else 0, 1, piece)
                    for i, piece in enumerate(pieces)))
        f, _ = await peer.read_until(lambda f: f[0] == http2.HEADERS)
        got = dict(peer.decoder.decode(f[3]))
        assert got["got"] == str(len(headers))
        assert f[1] & http2.END_STREAM
    finally:
        peer.close()


async def test_server_never_sends_past_the_window(server):
    _, port, _, _ = server
    peer = await RawPeer().open(port)
    try:
        peer.send(frame(http2.HEADERS, http2.END_HEADERS | http2.END_STREAM,
                        1, hpack.encode([(k, "/big" if k == ":path" else v)
                                         for k, v in REQ])))
        got = 0
        while got < http2.DEFAULT_WINDOW:
            f = await peer.read()
            if f[0] == http2.DATA:
                got += len(f[3])
        assert got == http2.DEFAULT_WINDOW
        with pytest.raises(asyncio.TimeoutError):
            while True:   # nothing more until the window opens
                f = await peer.read(timeout=0.3)
                assert f[0] != http2.DATA
        rest = 200_000 - got
        peer.send(frame(http2.WINDOW_UPDATE, 0, 0, struct.pack(">I", rest)),
                  frame(http2.WINDOW_UPDATE, 0, 1, struct.pack(">I", rest)))
        while got < 200_000:
            f = await peer.read()
            if f[0] == http2.DATA:
                got += len(f[3])
        assert got == 200_000 and f[1] & http2.END_STREAM
    finally:
        peer.close()


async def test_reader_credits_the_sender():
    """A client sends 300 kB to a server that reads it: the server's
    WINDOW_UPDATEs carry it past the 65,535-octet window (and padding
    counts against it, credited at once)."""
    async def handler(stream):
        n = 0
        while (chunk := await stream.read_data()) is not None:
            n += len(chunk)
        await stream.send_headers([(":status", "200"), ("n", str(n))],
                                  end_stream=True)
    srv = http2.Server(handler)
    port = await srv.start("127.0.0.1", 0)
    peer = await RawPeer().open(port)
    try:
        peer.send(frame(http2.HEADERS, http2.END_HEADERS, 1,
                        hpack.encode(REQ)))
        windows = {0: http2.DEFAULT_WINDOW, 1: http2.DEFAULT_WINDOW}
        sent, total = 0, 300_000
        credited = 0
        while sent < total:
            # one pad-length octet and 9 of padding: 10 octets more a frame
            n = min(16384 - 10, total - sent, min(windows.values()) - 10)
            if n <= 0:
                f = await peer.read()
                if f[0] == http2.WINDOW_UPDATE:
                    inc = struct.unpack(">I", f[3])[0]
                    windows[f[2]] += inc
                    credited += inc
                continue
            end = http2.END_STREAM if sent + n == total else 0
            peer.send(frame(http2.DATA, http2.PADDED | end, 1,
                            bytes([9]) + b"d" * n + b"\0" * 9))
            for sid in windows:
                windows[sid] -= n + 10
            sent += n
        f, _ = await peer.read_until(lambda f: f[0] == http2.HEADERS)
        assert dict(peer.decoder.decode(f[3]))["n"] == str(total)
        assert credited > 0
    finally:
        peer.close()
        await srv.stop()


async def test_max_concurrent_streams_both_sides(server):
    srv, port, streams, release = server
    peer = await RawPeer().open(port)
    try:
        hold = hpack.encode([(k, "/hold" if k == ":path" else v)
                             for k, v in REQ])
        for sid in (1, 3, 5):
            peer.send(frame(http2.HEADERS, http2.END_HEADERS
                            | http2.END_STREAM, sid, hold))
        f, _ = await peer.read_until(lambda f: f[0] == http2.RST_STREAM)
        assert f[2] == 5 and struct.unpack(">I", f[3])[0] == \
            http2.REFUSED_STREAM
    finally:
        peer.close()
    # the port's client waits for a slot under the server's limit
    conn = await http2.connect("127.0.0.1", port)
    try:
        await asyncio.sleep(0.1)           # the server's SETTINGS
        assert conn.peer_max_streams == 2
        held = [await conn.request([(k, "/hold" if k == ":path" else v)
                                    for k, v in REQ], end_stream=True)
                for _ in range(2)]
        third = asyncio.ensure_future(conn.request(REQ, end_stream=True))
        await asyncio.sleep(0.2)
        assert not third.done()
        release.set()
        for s in held:
            assert dict(await s.read_headers())[":status"] == "200"
        stream = await asyncio.wait_for(third, 5)
        assert dict(await stream.read_headers())[":status"] == "200"
    finally:
        conn.close()


async def test_reset_reaches_the_handler(server):
    """The peer's RST_STREAM runs the stream's ``on_reset`` callbacks (how
    the gRPC layer cancels a handler) and wakes a reader with
    :class:`StreamReset`."""
    _, port, streams, _ = server
    conn = await http2.connect("127.0.0.1", port)
    try:
        stream = await conn.request([(k, "/read" if k == ":path" else v)
                                     for k, v in REQ])
        for _ in range(200):
            if streams and hasattr(streams[0], "seen"):
                break
            await asyncio.sleep(0.01)
        stream.reset(http2.CANCEL)
        for _ in range(200):
            if len(streams[0].seen) == 2:
                break
            await asyncio.sleep(0.01)
        assert streams[0].seen == [http2.CANCEL, ("raised", http2.CANCEL)]
    finally:
        conn.close()


async def test_whole_response_survives_a_late_reset(server):
    """DATA and END_STREAM, then RST_STREAM(NO_ERROR) (what a server sends
    when it answered before the request was whole): the reader still gets
    every octet, and the writer stops."""
    _, port, _, _ = server
    conn = await http2.connect("127.0.0.1", port)
    try:
        stream = await conn.request([(k, "/early" if k == ":path" else v)
                                     for k, v in REQ])
        await asyncio.sleep(0.3)          # the reset arrives before reading
        assert stream.reset_code == http2.NO_ERROR
        assert dict(await stream.read_headers())[":status"] == "200"
        body = b""
        while (chunk := await stream.read_data()) is not None:
            body += chunk
        assert body == b"abc" * 10_000
        with pytest.raises(http2.StreamReset):
            await stream.send_data(b"more")
    finally:
        conn.close()


async def test_goaway_on_stop_with_grace():
    done = []

    async def handler(stream):
        await asyncio.sleep(float(dict(stream.headers)["sleep"]))
        await stream.send_headers([(":status", "200")], end_stream=True)
        done.append(stream.id)

    srv = http2.Server(handler)
    port = await srv.start("127.0.0.1", 0)
    conn = await http2.connect("127.0.0.1", port)
    try:
        quick = await conn.request(REQ + [("sleep", "0.2")], end_stream=True)
        slow = await conn.request(REQ + [("sleep", "30")], end_stream=True)
        await asyncio.sleep(0.1)
        stopping = asyncio.ensure_future(srv.stop(grace=1.0))
        await asyncio.sleep(0.05)
        assert conn.goaway_received == slow.id      # the last one it took
        assert not conn.usable
        assert dict(await quick.read_headers())[":status"] == "200"
        await asyncio.wait_for(stopping, 5)
        assert done == [quick.id]
        with pytest.raises(http2.StreamReset):
            await slow.read_headers()
    finally:
        conn.close()


async def test_protocol_error_sends_goaway_and_closes(server):
    _, port, _, _ = server
    peer = await RawPeer().open(port)
    try:
        # DATA on stream 0 is a connection error
        peer.send(frame(http2.DATA, 0, 0, b"x"))
        f, _ = await peer.read_until(lambda f: f[0] == http2.GOAWAY)
        assert struct.unpack(">I", f[3][4:8])[0] == http2.PROTOCOL_ERROR
        assert await asyncio.wait_for(peer.reader.read(), 5) == b""
    finally:
        peer.close()
