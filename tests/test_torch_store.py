"""The port's lease-KV store (``dynamo_tpu_torch.runtime.store``) against the
JAX package's: the same seeded sequence of raw operations (put/get/prefix
get, create, CAS, lease grant/keepalive/expiry with its keys deleted, watch
and watch from a revision, publish/subscribe, queue push/pop, locks, bad
requests) sent to a JAX ``StoreServer`` and to the port's gives the same
responses and watch events, frame for frame (lease and watch ids and the
server incarnation, which are drawn per server, are numbered in order of
appearance). Persisted snapshots are byte-equal and each package restores
the other's. Across packages, every pairing of ``StoreClient`` and
``StoreServer`` gives the same results for the same client script."""

import asyncio
import random

import pytest

from dynamo_tpu.runtime import store as jstore
from dynamo_tpu_torch.runtime import store as tstore

PKGS = {"jax": jstore, "port": tstore}
IDS = ("lease", "watch_id")


class Raw:
    """One raw store connection: sends frames, records every frame read."""

    def __init__(self, mod, reader, writer):
        self.mod, self.reader, self.writer = mod, reader, writer
        self.frames = []
        self.seq = 0

    async def call(self, **msg):
        self.seq += 1
        msg["seq"] = self.seq
        self.mod.write_frame(self.writer, msg)
        await self.writer.drain()
        while True:
            frame = await asyncio.wait_for(
                self.mod.read_frame(self.reader), 10)
            self.frames.append(frame)
            if frame.get("seq") == self.seq:
                return frame


def normalize(frames):
    """Number lease/watch ids and incarnations in order of appearance."""
    seen = {}

    def fix(obj, key=None):
        if isinstance(obj, dict):
            return {k: fix(v, k) for k, v in obj.items()}
        if isinstance(obj, list):
            return [fix(v) for v in obj]
        if key in IDS + ("incarnation",) and obj not in (None, 0):
            return f"{key}#{seen.setdefault((key, obj), len(seen))}"
        return obj
    return [fix(f) for f in frames]


async def raw_script(mod, seed=0):
    server = mod.StoreServer(host="127.0.0.1", port=0)
    await server.start()
    rng = random.Random(seed)
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1",
                                                       server.port)
        c = Raw(mod, reader, writer)
        w = await c.call(op="watch", prefix="a/")
        for i in range(6):
            await c.call(op="put", key=f"a/{rng.randrange(4)}",
                         value=rng.randbytes(rng.randrange(1, 40)), lease=0)
        await c.call(op="get", key="a/1")
        await c.call(op="get", key="a/missing")
        await c.call(op="get_prefix", prefix="a/")
        await c.call(op="create", key="a/new", value=b"n", lease=0)
        await c.call(op="create", key="a/new", value=b"m", lease=0)
        await c.call(op="cas", key="a/new", expect=b"wrong", value=b"x",
                     lease=0)
        await c.call(op="cas", key="a/new", expect=b"n", value=b"x",
                     lease=0)
        await c.call(op="cas", key="a/none", expect=None, value=b"y",
                     lease=0)
        await c.call(op="delete", key="a/none")
        await c.call(op="delete", key="a/none")
        lease = (await c.call(op="lease_grant", ttl=0.4))["lease"]
        await c.call(op="put", key="a/leased", value=b"L", lease=lease)
        await c.call(op="lease_keepalive", lease=lease)
        await c.call(op="put", key="a/bad", value=b"B", lease=999)
        await c.call(op="lock", name="l1", lease=lease)
        await c.call(op="lock", name="l1", lease=lease)
        await c.call(op="unlock", name="l1", lease=lease)
        await c.call(op="subscribe", subject="ev/")
        await c.call(op="publish", subject="ev/x", payload=b"p1")
        await c.call(op="publish", subject="other/x", payload=b"p2")
        await c.call(op="q_push", queue="q1", payload=b"job1")
        await c.call(op="q_push", queue="q1", payload=b"job2")
        await c.call(op="q_len", queue="q1")
        await c.call(op="q_pop", queue="q1", timeout=1.0)
        await c.call(op="q_pop", queue="q1", timeout=1.0)
        await c.call(op="q_pop", queue="q1", timeout=0.1)   # times out
        ping = await c.call(op="ping")
        # the lease expires (TTL 0.4 s, 0.25 s sweep): its key is deleted
        await asyncio.sleep(1.0)
        await c.call(op="lease_keepalive", lease=lease)
        await c.call(op="get_prefix", prefix="a/")
        # watch from a revision: exactly the missed events
        await c.call(op="watch", prefix="a/", since_rev=ping["rev"] - 3,
                     incarnation=ping["incarnation"])
        await c.call(op="watch", prefix="a/", since_rev=1,
                     incarnation="another-server")     # snapshot instead
        await c.call(op="unwatch", watch_id=w["watch_id"])
        await c.call(op="delete_prefix", prefix="a/")
        await c.call(op="nonsense")
        writer.close()
        return normalize(c.frames)
    finally:
        await server.stop()


def test_raw_operations_give_identical_frames():
    want = asyncio.run(raw_script(jstore))
    got = asyncio.run(raw_script(tstore))
    assert len(got) == len(want) > 40
    assert got == want
    # the script covered what it claims
    events = {f.get("event") for f in want if f.get("seq") is None}
    assert {"put", "delete", "msg"} <= events


async def persist_run(mod, path):
    server = mod.StoreServer(host="127.0.0.1", port=0,
                             persist_path=str(path))
    await server.start()
    client = await mod.StoreClient.connect(f"127.0.0.1:{server.port}",
                                           lease_ttl_s=5.0)
    for i in range(5):
        await client.put(f"cfg/{i}", bytes([i]) * (i * 70))
    await client.put("live/x", b"leased", lease=client.primary_lease)
    await client.q_push("work", b"a")
    await client.q_push("work", b"bb")
    await client.delete("cfg/2")
    await client.close()
    await server.stop()


async def restored(mod, path):
    server = mod.StoreServer(host="127.0.0.1", port=0,
                             persist_path=str(path))
    await server.start()
    client = await mod.StoreClient.connect(f"127.0.0.1:{server.port}")
    try:
        return (await client.get_prefix(""), await client.q_len("work"),
                await client.q_pop("work", 1.0), server._revision)
    finally:
        await client.close()
        await server.stop()


def test_persisted_snapshots_are_byte_equal_and_cross_restore(tmp_path):
    paths = {}
    for name, mod in PKGS.items():
        paths[name] = tmp_path / f"{name}.snap"
        asyncio.run(persist_run(mod, paths[name]))
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    results = {}
    for reader in PKGS:
        for writer in PKGS:
            # the restore pops a queue item and persists again: use a copy
            copy = tmp_path / f"{reader}-reads-{writer}.snap"
            copy.write_bytes(paths[writer].read_bytes())
            results[reader, writer] = asyncio.run(restored(PKGS[reader],
                                                           copy))
    want = results["jax", "jax"]
    assert [k for k, _ in want[0]] == ["cfg/0", "cfg/1", "cfg/3", "cfg/4"]
    assert want[1:3] == (2, b"a")
    for key, got in results.items():
        assert got == want, key


def test_torn_snapshot_restores_the_records_before_the_tear(tmp_path):
    path = tmp_path / "s.snap"
    asyncio.run(persist_run(jstore, path))
    data = path.read_bytes()
    path.write_bytes(data[:-20])
    want = asyncio.run(restored(jstore, path))
    path.write_bytes(data[:-20])
    assert asyncio.run(restored(tstore, path)) == want


async def client_script(client_mod, server_mod):
    server = server_mod.StoreServer(host="127.0.0.1", port=0)
    await server.start()
    addr = f"127.0.0.1:{server.port}"
    out = []
    c = await client_mod.StoreClient.connect(addr, lease_ttl_s=0.6)
    other = await client_mod.StoreClient.connect(addr, lease_ttl_s=0.6)
    try:
        snap, stream = await c.watch_prefix("w/")
        out.append(snap)
        await c.put("w/a", b"1")
        await other.put("w/b", b"2", lease=other.primary_lease)
        out.append(await c.get("w/a"))
        out.append(await c.get_prefix("w/"))
        out.append(await c.create("w/a", b"x"))
        out.append(await c.create("w/c", b"3"))
        out.append(await c.cas("w/a", b"1", b"4"))
        out.append(await c.cas("w/a", b"1", b"5"))
        for _ in range(4):
            ev = await asyncio.wait_for(stream.next(), 5)
            out.append((ev["event"], ev["key"], ev["value"]))
        sub = await c.subscribe("s/")
        out.append(await other.publish("s/1", b"m" * 300))
        ev = await asyncio.wait_for(sub.next(), 5)
        out.append((ev["event"], ev["key"], ev["value"]))
        out.append(await c.q_push("q", b"j"))
        out.append(await other.q_pop("q", 1.0))
        out.append(await other.q_pop("q", 0.1))
        out.append(await c.lock("lk"))
        out.append(await other.lock("lk"))
        await c.unlock("lk")
        out.append(await other.lock("lk"))
        out.append(await c.wait_for_key_count("w/", 3, timeout_s=5))
        rsnap, rstream = await c.watch_prefix_resilient("w/")
        out.append(rsnap)
        # the other client dies without revoking: its leased key goes at
        # lease expiry, and both watches see the delete
        other._closed = True
        other._keepalive_task.cancel()
        other._writer.close()
        ev = await asyncio.wait_for(stream.next(), 5)
        out.append((ev["event"], ev["key"]))
        ev = await asyncio.wait_for(rstream.next(), 5)
        out.append((ev["event"], ev["key"]))
        out.append(await c.get_prefix("w/"))
        out.append(await c.delete_prefix("w/"))
        await stream.cancel()
        await rstream.cancel()
        await sub.cancel()
        return out
    finally:
        await c.close()
        await server.stop()


@pytest.mark.parametrize("client,server", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_clients_and_servers_interoperate(client, server):
    want = asyncio.run(client_script(jstore, jstore))
    got = asyncio.run(client_script(PKGS[client], PKGS[server]))
    assert got == want
    assert ("delete", "w/b") in want


async def stop_with_a_pending_connection(make, loop_turns: int) -> bool:
    """Start a server, connect to it from a blocking socket, let the loop
    turn ``loop_turns`` times (the connection accepted, its handler maybe
    not yet run), then stop it: True when ``stop()`` returns in time."""
    import socket

    server = make()
    await server.start()
    sock = socket.create_connection(("127.0.0.1", server.port))
    try:
        for _ in range(loop_turns):
            await asyncio.sleep(0)
        await asyncio.wait_for(server.stop(), 5)
        return True
    except asyncio.TimeoutError:
        return False
    finally:
        sock.close()


@pytest.mark.parametrize("which", ["store", "ingress"])
def test_stop_closes_a_connection_accepted_before_its_handler_ran(which):
    """On Python 3.12 ``Server.wait_closed`` waits for every accepted
    connection, so a connection accepted just before ``stop()`` whose
    handler had not run yet (a client reconnecting as the runtime shuts
    down) used to hang ``stop()``: the handler registered it after stop
    closed the others and read from it forever. Each loop turn from the
    connect to the handler is tried."""
    from dynamo_tpu_torch.runtime.transport import IngressServer

    async def echo(request, context):
        yield request

    make = {"store": lambda: tstore.StoreServer(host="127.0.0.1", port=0),
            "ingress": lambda: IngressServer(echo, host="127.0.0.1",
                                             port=0)}[which]
    for turns in range(8):
        assert asyncio.run(stop_with_a_pending_connection(make, turns)), turns
