"""Lease-KV discovery store: the control-plane brain of the cluster.

Plays the role etcd plays in the reference (ref: lib/runtime/src/transports/
etcd.rs:35-324): a small TCP service holding a revisioned key-value map with

- **leases**: TTL'd handles with keepalive; when a lease dies every key
  attached to it is deleted and watchers are notified — this is the liveness
  mechanism (worker death ⇒ its ``instances/…`` and ``models/…`` keys vanish,
  ref: etcd.rs:89-95),
- **watches**: prefix subscriptions that stream put/delete events,
- **atomic create** (fails if key exists) and compare-and-swap,
- **distributed locks** built on atomic create + leases (ref: etcd.rs:300),
- **barriers** for leader/worker rendezvous (via ``wait_for_key_count``,
  ref: utils/leader_worker_barrier.rs:24).

It also carries the two roles NATS plays in the reference:

- **pub/sub subjects** (no storage, fan-out to live subscribers) for KV
  events and metrics (ref: transports/nats.rs, kv_router.rs:60-66),
- **work queues** (push + blocking pull) used as the disaggregation prefill
  queue (ref: ``NatsQueue`` transports/nats.rs:426).

Framing: 4-byte big-endian length + msgpack body. Requests carry a ``seq``;
responses echo it; watch events are pushed with ``seq: None`` and a
``watch_id``. One asyncio server task per connection; state is single-threaded
within the server loop, so operations are atomic without locks.

A copy of ``dynamo_tpu.runtime.store`` on the package's own MessagePack codec
(:mod:`.codec`, byte-equal to ``msgpack``), so servers, clients and snapshot
files of both packages interoperate.

Run standalone: ``python -m dynamo_tpu_torch.runtime.store --port 3280``.
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import random
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple

from ..utils.logging import get_logger
from . import codec, faults

log = get_logger("store")

DEFAULT_PORT = 3280
_MAX_FRAME = 256 * 1024 * 1024
_MAX_SUB_BUFFER = 8 * 1024 * 1024   # slow-subscriber drop threshold
_MAX_ORPHAN_EVENTS = 256            # per unclaimed watch id
_MAX_EVENT_HISTORY = 4096           # retained events for watch rev catch-up


# ------------------------------- framing ---------------------------------


async def read_frame(reader: asyncio.StreamReader) -> Optional[dict]:
    try:
        header = await reader.readexactly(4)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    size = int.from_bytes(header, "big")
    if size > _MAX_FRAME:
        raise ValueError(f"frame too large: {size}")
    try:
        body = await reader.readexactly(size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    return codec.unpackb(body)


def write_frame(writer: asyncio.StreamWriter, obj: dict) -> None:
    body = codec.packb(obj)
    writer.write(len(body).to_bytes(4, "big") + body)


# ------------------------------- server ----------------------------------


@dataclass
class _Lease:
    lease_id: int
    ttl_s: float
    deadline: float
    keys: set = field(default_factory=set)


@dataclass
class _KvEntry:
    value: bytes
    lease_id: int  # 0 = no lease
    create_rev: int
    mod_rev: int


@dataclass
class _Watch:
    watch_id: int
    prefix: str
    writer: asyncio.StreamWriter


class _WorkQueue:
    """Push/blocking-pull queue (the JetStream work-queue role)."""

    def __init__(self) -> None:
        self.items: List[bytes] = []
        self.waiters: List[asyncio.Future] = []

    def push(self, payload: bytes) -> int:
        while self.waiters:
            fut = self.waiters.pop(0)
            if not fut.done():
                fut.set_result(payload)
                return len(self.items)
        self.items.append(payload)
        return len(self.items)

    def pop_nowait(self) -> Optional[bytes]:
        return self.items.pop(0) if self.items else None


class StoreServer:
    """In-memory revisioned lease-KV store served over TCP.

    With ``persist_path`` set, unleased KV entries, work-queue items, and
    the revision counter are snapshotted to disk (msgpack, atomic rename)
    whenever dirty and restored on start — the durability role etcd's raft
    log plays in the reference (ref: transports/etcd.rs). Leased keys are
    deliberately NOT persisted: they are liveness claims whose owners must
    re-assert them (clients re-put leased keys on reconnect, see
    :class:`StoreClient`), exactly like etcd leases dying with the cluster.
    """

    def __init__(self, host: str = "0.0.0.0", port: int = DEFAULT_PORT,
                 persist_path: Optional[str] = None,
                 persist_interval_s: float = 1.0):
        self.host = host
        self.port = port
        self.persist_path = persist_path
        self.persist_interval_s = persist_interval_s
        self._kv: Dict[str, _KvEntry] = {}
        self._leases: Dict[int, _Lease] = {}
        self._watches: Dict[int, _Watch] = {}
        self._subs: Dict[int, _Watch] = {}  # pub/sub subjects (no storage)
        self._queues: Dict[str, "_WorkQueue"] = {}
        self._locks: Dict[str, Tuple[int, int]] = {}  # name -> (lease_id, watch count)
        self._revision = 0
        # identifies this server process: a re-watching client presents the
        # incarnation it was watching; a mismatch (store restarted) forces a
        # full snapshot resync instead of a bogus revision catch-up
        self.incarnation = uuid.uuid4().hex
        # recent (rev, event, key, value) for revision catch-up on re-watch
        self._history: deque = deque(maxlen=_MAX_EVENT_HISTORY)
        # time-seeded so a restarted store never re-issues watch/lease ids a
        # client still holds from the previous incarnation (a stale
        # WatchStream.cancel would otherwise unwatch a stranger's fresh id)
        self._ids = itertools.count(int(time.time()) % (1 << 30) << 16)
        self._server: Optional[asyncio.AbstractServer] = None
        self._expiry_task: Optional[asyncio.Task] = None
        self._persist_task: Optional[asyncio.Task] = None
        self._dirty = False
        self._conn_writers: set = set()
        self._closing = False

    # -- lifecycle --

    async def start(self) -> None:
        self._closing = False
        if self.persist_path:
            self._restore()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        self._expiry_task = asyncio.create_task(self._expire_loop())
        if self.persist_path:
            self._persist_task = asyncio.create_task(self._persist_loop())
        log.info("store listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        # a connection accepted before this call whose handler has not run
        # yet is not in _conn_writers: its handler closes it on arrival,
        # else wait_closed (which waits for every connection on Python
        # 3.12) would wait for a client that never sends
        self._closing = True
        if self._expiry_task:
            self._expiry_task.cancel()
        if self._persist_task:
            self._persist_task.cancel()
            self._persist_task = None
        if self.persist_path and self._dirty:
            self._persist()
        for writer in list(self._conn_writers):
            writer.close()
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    # -- durability --

    def _restore(self) -> None:
        import os

        if not os.path.exists(self.persist_path):
            return
        # The snapshot is a stream of msgpack frames: a header record, one
        # record per kv pair / queue, and a trailing {"eof": True}. A crash
        # mid-write leaves a truncated or corrupt trailing frame — restore
        # keeps everything up to the last good record instead of failing
        # startup. (The legacy single-blob format is still readable.)
        records: List[dict] = []
        clean = False
        try:
            with open(self.persist_path, "rb") as f:
                data = f.read()
            try:
                for rec in codec.iter_unpack(data):
                    if not isinstance(rec, dict):
                        log.warning("store snapshot: non-dict frame — "
                                    "stopping at last good record")
                        break
                    if rec.get("eof"):
                        clean = True
                        break
                    records.append(rec)
            except Exception as exc:
                log.warning(
                    "store snapshot truncated/corrupt after %d records "
                    "(%s) — continuing from last good record",
                    len(records), exc,
                )
        except Exception:
            log.exception("store restore failed — starting empty")
            return
        if not records:
            return
        try:
            first = records[0]
            if "header" in first:
                revision = int(first["header"].get("revision", 0))
                kv: Dict[str, _KvEntry] = {}
                queues: Dict[str, _WorkQueue] = {}
                for rec in records[1:]:
                    if "kv" in rec:
                        key, value = rec["kv"]
                        kv[key] = _KvEntry(value, 0, revision, revision)
                    elif "q" in rec:
                        name, items = rec["q"]
                        q = _WorkQueue()
                        q.items.extend(bytes(i) for i in items)
                        queues[name] = q
            else:
                # legacy format: one blob {revision, kv, queues}
                revision = int(first.get("revision", 0))
                kv = {
                    key: _KvEntry(value, 0, revision, revision)
                    for key, value in first.get("kv", [])
                }
                queues = {}
                for name, items in first.get("queues", {}).items():
                    q = _WorkQueue()
                    q.items.extend(bytes(i) for i in items)
                    queues[name] = q
                clean = True
            self._revision = revision
            self._kv = kv
            self._queues = queues
            log.info(
                "restored %d keys, %d queues at revision %d from %s%s",
                len(self._kv), len(self._queues), self._revision,
                self.persist_path, "" if clean else " (truncated tail)",
            )
        except Exception:
            log.exception("store restore failed — starting empty")
            self._revision = 0
            self._kv = {}
            self._queues = {}

    def _persist(self) -> None:
        import os
        import tempfile

        try:
            d = os.path.dirname(os.path.abspath(self.persist_path))
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(codec.packb(
                    {"header": {"revision": self._revision, "format": 2}}
                ))
                # leased keys are liveness claims — never persisted
                for k, e in sorted(self._kv.items()):
                    if e.lease_id == 0:
                        f.write(codec.packb({"kv": [k, e.value]}))
                for name, q in self._queues.items():
                    if q.items:
                        f.write(codec.packb({"q": [name, q.items]}))
                f.write(codec.packb({"eof": True}))
            os.replace(tmp, self.persist_path)
            self._dirty = False
        except Exception:
            log.exception("store persist failed")

    async def _persist_loop(self) -> None:
        while True:
            await asyncio.sleep(self.persist_interval_s)
            if self._dirty:
                self._persist()

    async def serve_forever(self) -> None:
        await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- lease expiry --

    async def _expire_loop(self) -> None:
        while True:
            await asyncio.sleep(0.25)
            now = time.monotonic()
            dead = [l for l in self._leases.values() if l.deadline < now]
            for lease in dead:
                log.info("lease %d expired (ttl %.1fs)", lease.lease_id, lease.ttl_s)
                self._revoke(lease.lease_id)

    def _revoke(self, lease_id: int) -> None:
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        for key in list(lease.keys):
            self._delete_key(key)
        for name, (owner, _) in list(self._locks.items()):
            if owner == lease_id:
                del self._locks[name]

    # -- kv ops (single-threaded within the event loop => atomic) --

    def _push_event(self, registry: Dict[int, _Watch], watch: _Watch,
                    frame: dict) -> bool:
        """Write an event frame to a watcher with backpressure protection.

        Fan-out happens in sync code (no ``drain()``), so a slow consumer
        would otherwise accumulate unbounded write buffers under event storms
        (the KV-events subject is the hottest, ref: kv_router.rs:60). Policy:
        when the connection's socket buffer exceeds the limit, unregister the
        watch being written (under a storm that is the hot subject) and send
        it a final small ``dropped`` event — the NATS slow-consumer contract.
        The connection stays open: it also carries RPCs and the primary-lease
        keepalive, so closing it would turn one slow subscription into a
        spurious whole-worker death. Clients resubscribe on ``dropped``.
        """
        writer = watch.writer
        if writer.is_closing():
            registry.pop(watch.watch_id, None)
            return False
        if writer.transport.get_write_buffer_size() > _MAX_SUB_BUFFER:
            log.warning(
                "watch %d too slow (%d bytes buffered) — dropping watch",
                watch.watch_id, writer.transport.get_write_buffer_size(),
            )
            registry.pop(watch.watch_id, None)
            try:
                write_frame(writer, {"seq": None, "watch_id": watch.watch_id,
                                     "event": "dropped", "key": watch.prefix,
                                     "value": None, "rev": 0})
            except Exception:
                pass
            return False
        try:
            write_frame(writer, frame)
            return True
        except Exception:
            registry.pop(watch.watch_id, None)
            return False

    def _notify(self, event: str, key: str, value: Optional[bytes], rev: int) -> None:
        self._history.append((rev, event, key, value))
        for watch in list(self._watches.values()):
            if key.startswith(watch.prefix):
                self._push_event(
                    self._watches, watch,
                    {
                        "seq": None,
                        "watch_id": watch.watch_id,
                        "event": event,
                        "key": key,
                        "value": value,
                        "rev": rev,
                    },
                )

    def _put(self, key: str, value: bytes, lease_id: int) -> int:
        # validate the lease BEFORE mutating: a put under an expired/unknown
        # lease must have no side effects (no orphan keys, no notifications)
        lease = None
        if lease_id:
            lease = self._leases.get(lease_id)
            if lease is None:
                raise KeyError(f"unknown lease {lease_id}")
        self._revision += 1
        prev = self._kv.get(key)
        create_rev = prev.create_rev if prev else self._revision
        if prev and prev.lease_id and prev.lease_id != lease_id:
            old = self._leases.get(prev.lease_id)
            if old:
                old.keys.discard(key)
        self._kv[key] = _KvEntry(value, lease_id, create_rev, self._revision)
        if lease is not None:
            lease.keys.add(key)
        # dirty when the persisted set changes: an unleased write, or a
        # leased write shadowing a previously-persisted unleased key
        if lease_id == 0 or (prev is not None and prev.lease_id == 0):
            self._dirty = True
        self._notify("put", key, value, self._revision)
        return self._revision

    def _delete_key(self, key: str) -> bool:
        entry = self._kv.pop(key, None)
        if entry is None:
            return False
        self._revision += 1
        if entry.lease_id:
            lease = self._leases.get(entry.lease_id)
            if lease:
                lease.keys.discard(key)
        else:
            self._dirty = True
        self._notify("delete", key, None, self._revision)
        return True

    # -- request dispatch --

    async def _handle_conn(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn_watches: List[int] = []
        conn_leases: List[int] = []
        if self._closing:
            writer.close()
            return
        self._conn_writers.add(writer)
        try:
            while True:
                msg = await read_frame(reader)
                if msg is None:
                    break
                resp = self._dispatch(msg, writer, conn_watches, conn_leases)
                if resp is not None:
                    write_frame(writer, resp)
                    await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        except Exception:  # malformed frame / codec garbage: drop the conn
            log.warning("dropping store connection after bad frame", exc_info=True)
        finally:
            for wid in conn_watches:
                self._watches.pop(wid, None)
                self._subs.pop(wid, None)
            # leases owned by this connection survive until TTL expiry — a
            # reconnecting client can re-attach via keepalive (etcd semantics)
            self._conn_writers.discard(writer)
            writer.close()

    def _dispatch(
        self,
        msg: dict,
        writer: asyncio.StreamWriter,
        conn_watches: List[int],
        conn_leases: List[int],
    ) -> Optional[dict]:
        op = msg.get("op")
        seq = msg.get("seq")
        try:
            if op == "put":
                rev = self._put(msg["key"], msg["value"], msg.get("lease", 0))
                return {"seq": seq, "ok": True, "rev": rev}
            if op == "create":  # atomic create: fail if key exists (kv_create)
                if msg["key"] in self._kv:
                    return {"seq": seq, "ok": False, "error": "exists"}
                rev = self._put(msg["key"], msg["value"], msg.get("lease", 0))
                return {"seq": seq, "ok": True, "rev": rev}
            if op == "cas":
                entry = self._kv.get(msg["key"])
                expect = msg.get("expect")  # None = must not exist
                actual = entry.value if entry else None
                if actual != expect:
                    return {"seq": seq, "ok": False, "error": "conflict",
                            "value": actual}
                rev = self._put(msg["key"], msg["value"], msg.get("lease", 0))
                return {"seq": seq, "ok": True, "rev": rev}
            if op == "get":
                entry = self._kv.get(msg["key"])
                if entry is None:
                    return {"seq": seq, "ok": True, "kvs": []}
                return {
                    "seq": seq,
                    "ok": True,
                    "kvs": [[msg["key"], entry.value, entry.lease_id, entry.mod_rev]],
                }
            if op == "get_prefix":
                prefix = msg["prefix"]
                kvs = [
                    [k, e.value, e.lease_id, e.mod_rev]
                    for k, e in sorted(self._kv.items())
                    if k.startswith(prefix)
                ]
                return {"seq": seq, "ok": True, "kvs": kvs, "rev": self._revision}
            if op == "delete":
                existed = self._delete_key(msg["key"])
                return {"seq": seq, "ok": True, "deleted": existed}
            if op == "delete_prefix":
                keys = [k for k in self._kv if k.startswith(msg["prefix"])]
                for k in keys:
                    self._delete_key(k)
                return {"seq": seq, "ok": True, "deleted": len(keys)}
            if op == "lease_grant":
                lease_id = next(self._ids)
                ttl = float(msg.get("ttl", 10.0))
                self._leases[lease_id] = _Lease(
                    lease_id, ttl, time.monotonic() + ttl
                )
                conn_leases.append(lease_id)
                return {"seq": seq, "ok": True, "lease": lease_id, "ttl": ttl}
            if op == "lease_keepalive":
                lease = self._leases.get(msg["lease"])
                if lease is None:
                    return {"seq": seq, "ok": False, "error": "lease_expired"}
                if lease.deadline < time.monotonic():
                    # already past the deadline — the expire loop just hasn't
                    # ticked yet. A late keepalive must NOT resurrect the
                    # lease (watchers may already be reacting to the expiry);
                    # revoke now so keepalive-vs-expiry ordering is settled
                    # here, atomically, not by loop-tick luck.
                    self._revoke(lease.lease_id)
                    return {"seq": seq, "ok": False, "error": "lease_expired"}
                lease.deadline = time.monotonic() + lease.ttl_s
                return {"seq": seq, "ok": True, "ttl": lease.ttl_s}
            if op == "lease_revoke":
                self._revoke(msg["lease"])
                return {"seq": seq, "ok": True}
            if op == "watch":
                watch_id = next(self._ids)
                prefix = msg["prefix"]
                self._watches[watch_id] = _Watch(watch_id, prefix, writer)
                conn_watches.append(watch_id)
                # revision catch-up: a re-watching client that presents the
                # revision it had seen (against the SAME server incarnation)
                # gets exactly the events it missed instead of a snapshot —
                # no reconcile diff needed on its side
                since = msg.get("since_rev")
                if (since is not None
                        and msg.get("incarnation") == self.incarnation
                        and self._covers(int(since))):
                    events = [
                        {"event": ev, "key": k, "value": v, "rev": rev}
                        for rev, ev, k, v in self._history
                        if rev > int(since) and k.startswith(prefix)
                    ]
                    return {
                        "seq": seq,
                        "ok": True,
                        "watch_id": watch_id,
                        "caught_up": True,
                        "events": events,
                        "rev": self._revision,
                        "incarnation": self.incarnation,
                    }
                # current state snapshot so the watcher can't miss anything
                kvs = [
                    [k, e.value, e.lease_id, e.mod_rev]
                    for k, e in sorted(self._kv.items())
                    if k.startswith(prefix)
                ]
                return {
                    "seq": seq,
                    "ok": True,
                    "watch_id": watch_id,
                    "kvs": kvs,
                    "rev": self._revision,
                    "incarnation": self.incarnation,
                }
            if op == "unwatch":
                self._watches.pop(msg["watch_id"], None)
                return {"seq": seq, "ok": True}
            if op == "lock":
                name, lease_id = msg["name"], msg["lease"]
                if lease_id not in self._leases:
                    return {"seq": seq, "ok": False, "error": "lease_expired"}
                holder = self._locks.get(name)
                if holder is None or holder[0] not in self._leases:
                    self._locks[name] = (lease_id, 0)
                    return {"seq": seq, "ok": True, "acquired": True}
                return {"seq": seq, "ok": True, "acquired": holder[0] == lease_id}
            if op == "unlock":
                holder = self._locks.get(msg["name"])
                if holder and holder[0] == msg["lease"]:
                    del self._locks[msg["name"]]
                return {"seq": seq, "ok": True}
            if op == "subscribe":
                sub_id = next(self._ids)
                self._subs[sub_id] = _Watch(sub_id, msg["subject"], writer)
                conn_watches.append(sub_id)  # cleaned with watches on disconnect
                return {"seq": seq, "ok": True, "watch_id": sub_id}
            if op == "unsubscribe":
                self._subs.pop(msg["watch_id"], None)
                return {"seq": seq, "ok": True}
            if op == "publish":
                subject, payload = msg["subject"], msg["payload"]
                n = 0
                for sub in list(self._subs.values()):
                    if subject.startswith(sub.prefix):
                        if self._push_event(
                            self._subs, sub,
                            {"seq": None, "watch_id": sub.watch_id,
                             "event": "msg", "key": subject,
                             "value": payload, "rev": 0},
                        ):
                            n += 1
                return {"seq": seq, "ok": True, "delivered": n}
            if op == "q_push":
                q = self._queues.setdefault(msg["queue"], _WorkQueue())
                depth = q.push(msg["payload"])
                self._dirty = True
                return {"seq": seq, "ok": True, "depth": depth}
            if op == "q_pop":
                q = self._queues.setdefault(msg["queue"], _WorkQueue())
                item = q.pop_nowait()
                if item is not None:
                    self._dirty = True
                    return {"seq": seq, "ok": True, "payload": item}
                self._q_pop_async(q, msg, writer)
                return None  # response written when an item arrives / timeout
            if op == "q_len":
                q = self._queues.get(msg["queue"])
                return {"seq": seq, "ok": True,
                        "depth": len(q.items) if q else 0}
            if op == "ping":
                return {"seq": seq, "ok": True, "rev": self._revision,
                        "incarnation": self.incarnation}
            return {"seq": seq, "ok": False, "error": f"unknown op {op!r}"}
        except Exception as exc:  # noqa: BLE001 — report, don't kill the conn
            log.exception("store op %s failed", op)
            return {"seq": seq, "ok": False, "error": str(exc)}

    def _covers(self, since_rev: int) -> bool:
        """True when the retained event history holds every revision after
        ``since_rev`` (so a catch-up replay misses nothing)."""
        if since_rev >= self._revision:
            return True
        return bool(self._history) and self._history[0][0] <= since_rev + 1

    def _q_pop_async(
        self, q: "_WorkQueue", msg: dict, writer: asyncio.StreamWriter
    ) -> None:
        """Blocking pull: respond when an item arrives or the timeout fires.
        If the consumer vanished by delivery time, the item is re-queued
        (at-least-once, the JetStream work-queue contract)."""
        seq = msg.get("seq")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        q.waiters.append(fut)

        def _deliver(f: asyncio.Future) -> None:
            if f.cancelled():
                payload = None
            else:
                payload = f.result()
                self._dirty = True
            if writer.is_closing():
                if payload is not None:
                    q.push(payload)
                return
            try:
                write_frame(writer, {"seq": seq, "ok": True, "payload": payload})
            except Exception:
                if payload is not None:
                    q.push(payload)

        fut.add_done_callback(_deliver)
        timeout = float(msg.get("timeout", 30.0))

        def _expire() -> None:
            if not fut.done():
                fut.cancel()
                try:
                    q.waiters.remove(fut)
                except ValueError:
                    pass

        asyncio.get_running_loop().call_later(timeout, _expire)


# ------------------------------- client ----------------------------------


class StoreError(RuntimeError):
    pass


class LeaseExpired(StoreError):
    pass


class StoreClient:
    """Async client for :class:`StoreServer`.

    Holds one multiplexed connection; a background reader routes responses by
    ``seq`` and fans watch events out to per-watch queues. A *primary lease*
    with automatic keepalive mirrors the reference runtime's liveness contract:
    if the primary lease cannot be kept alive, ``on_lease_lost`` fires (the
    runtime uses this to trigger shutdown, ref: etcd.rs:89-95).
    """

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._seq = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watch_queues: Dict[int, asyncio.Queue] = {}
        # events that raced ahead of watch registration (the server can push
        # events for a fresh watch_id before the watch/subscribe response is
        # processed by the caller); drained into the queue on registration
        self._orphan_events: Dict[int, List[dict]] = {}
        self._reader_task: Optional[asyncio.Task] = None
        self._keepalive_task: Optional[asyncio.Task] = None
        self.primary_lease: int = 0
        self.on_lease_lost: Optional[Callable[[], None]] = None
        self._closed = False
        self._lease_ttl_s: float = 10.0
        # keys this client holds under its primary lease, re-asserted after
        # a reconnect (a restarted store forgot them; the reference's etcd
        # survives via raft — here the client replays its own claims)
        self._leased_keys: Dict[str, bytes] = {}
        self._recover_task: Optional[asyncio.Task] = None
        # how long reconnect attempts may run before declaring lease loss
        self.recover_timeout_s: float = 30.0
        # reconnect pacing: jittered exponential backoff between attempts
        self.reconnect_base_s: float = 0.25
        self.reconnect_cap_s: float = 5.0
        self._reconnect_rng = random.Random()
        self.num_recoveries = 0
        # failed RPC attempts (injected faults + dead-connection calls):
        # the store-seam evidence the replay fault-attribution check reads
        self.num_call_errors = 0

    @staticmethod
    async def connect(
        addr: str, *, lease_ttl_s: float = 10.0, retries: int = 40,
        retry_delay_s: float = 0.25, recover_timeout_s: float = 30.0,
        reconnect_base_s: float = 0.25, reconnect_cap_s: float = 5.0,
    ) -> "StoreClient":
        host, port = addr.rsplit(":", 1)
        client = StoreClient(host, int(port))
        client.recover_timeout_s = recover_timeout_s
        client.reconnect_base_s = reconnect_base_s
        client.reconnect_cap_s = reconnect_cap_s
        last: Optional[Exception] = None
        for _ in range(retries):
            try:
                await client._open()
                break
            except OSError as exc:
                last = exc
                await asyncio.sleep(retry_delay_s)
        else:
            raise StoreError(f"cannot connect to store at {addr}: {last}")
        client._lease_ttl_s = lease_ttl_s
        client.primary_lease = await client.lease_grant(lease_ttl_s)
        client._keepalive_task = asyncio.create_task(
            client._keepalive_loop(lease_ttl_s)
        )
        return client

    async def _open(self) -> None:
        fault = await faults.maybe_delay(
            faults.active("store.connect", f"{self.host}:{self.port}")
        )
        if fault is not None and fault.kind in (faults.DROP, faults.REJECT):
            # OSError so both the initial connect-retry loop and the
            # recovery loop treat it exactly like a refused dial
            raise OSError(f"injected store.connect fault "
                          f"({self.host}:{self.port})")
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port
        )
        self._reader_task = asyncio.create_task(self._read_loop())

    async def close(self) -> None:
        self._closed = True
        if self._keepalive_task:
            self._keepalive_task.cancel()
        # revoke while the reader is still alive so the response resolves
        if self.primary_lease and self._writer and not self._writer.is_closing():
            try:
                await asyncio.wait_for(
                    self._call({"op": "lease_revoke", "lease": self.primary_lease}),
                    timeout=2.0,
                )
            except Exception:
                pass
        if self._reader_task:
            self._reader_task.cancel()
        if self._writer:
            self._writer.close()

    async def _read_loop(self) -> None:
        assert self._reader is not None
        while True:
            msg = await read_frame(self._reader)
            if msg is None:
                # mark the connection dead FIRST so a racing _call() raises
                # instead of registering a future nothing will ever resolve
                if self._writer is not None:
                    self._writer.close()
                self._fail_pending()
                # watchers see "dropped" (not a silent end): consumers
                # resubscribe on dropped, retrying through the reconnect
                # window
                for wid, q in list(self._watch_queues.items()):
                    q.put_nowait(
                        None if self._closed
                        else {"watch_id": wid, "event": "dropped",
                              "key": "", "value": None, "rev": 0}
                    )
                if not self._closed:
                    self._start_recovery()
                return
            seq = msg.get("seq")
            if seq is None:
                wid = msg.get("watch_id")
                q = self._watch_queues.get(wid)
                if q is not None:
                    q.put_nowait(msg)
                elif wid is not None:
                    # bounded: an id that is never claimed (caller died between
                    # the watch RPC and claiming) must not leak memory — past
                    # the cap the buffer collapses to a single 'dropped'
                    # tombstone so a late claimer knows it has a gap and must
                    # resynchronise, instead of silently missing events
                    buf = self._orphan_events.setdefault(wid, [])
                    if buf and buf[0].get("event") == "dropped":
                        continue
                    buf.append(msg)
                    if len(buf) > _MAX_ORPHAN_EVENTS:
                        self._orphan_events[wid] = [
                            {"watch_id": wid, "event": "dropped"}
                        ]
            else:
                fut = self._pending.pop(seq, None)
                if fut and not fut.done():
                    fut.set_result(msg)

    async def _call(self, msg: dict) -> dict:
        fault = await faults.maybe_delay(
            faults.active("store.call", msg.get("op") or "")
        )
        if fault is not None and fault.kind in (faults.DROP, faults.REJECT):
            self.num_call_errors += 1
            raise StoreError(f"injected store fault on {msg.get('op')!r}")
        if self._writer is None or self._writer.is_closing():
            self.num_call_errors += 1
            raise StoreError("store client not connected")
        seq = next(self._seq)
        msg["seq"] = seq
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        write_frame(self._writer, msg)
        await self._writer.drain()
        return await fut

    async def _keepalive_loop(self, ttl_s: float) -> None:
        period = max(ttl_s / 3.0, 0.2)
        while not self._closed:
            await asyncio.sleep(period)
            try:
                resp = await asyncio.wait_for(
                    self._call(
                        {"op": "lease_keepalive", "lease": self.primary_lease}
                    ),
                    timeout=ttl_s,
                )
                if not resp.get("ok"):
                    raise LeaseExpired("primary lease expired")
            except Exception:
                if self._closed:
                    return
                # lease unknown / connection gone: try recovery (a restarted
                # store grants a fresh lease and we re-assert our keys)
                # before declaring the worker dead
                log.warning("primary lease keepalive failed — recovering")
                self._start_recovery()
                return

    async def kick_keepalive(self) -> bool:
        """Send one primary-lease keepalive now, outside the periodic loop.

        Chaos-replay hook: a ``store.call``/``lease_keepalive`` fault rule
        gates an op the replay clock does not control — the periodic loop's
        phase is set at client spawn, so whether a finite-``times`` rule
        fires within a replay window depends on wall-clock luck. Kicking at
        wave install pins each firing to a deterministic point. A failed
        kick takes the same recovery path as a failed periodic tick.
        """
        try:
            resp = await asyncio.wait_for(
                self._call(
                    {"op": "lease_keepalive", "lease": self.primary_lease}
                ),
                timeout=self._lease_ttl_s,
            )
            if not resp.get("ok"):
                raise LeaseExpired("primary lease expired")
            return True
        except Exception:
            if not self._closed:
                log.warning("kicked keepalive failed — recovering")
                self._start_recovery()
            return False

    # -- reconnect / lease recovery --

    def _fail_pending(self) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(StoreError("store connection closed"))
        self._pending.clear()

    def _start_recovery(self) -> None:
        if self._closed or self._recover_task is not None:
            return
        self._recover_task = asyncio.create_task(self._recover())

    async def _recover(self) -> None:
        """Reconnect, re-grant the primary lease, re-assert leased keys.

        Key identity is preserved: instance records carry their original
        instance_id in the VALUE, so watchers see the same worker come back
        (a put on the same key), not a new one. Gives up after
        ``recover_timeout_s`` and fires ``on_lease_lost``.
        """
        deadline = time.monotonic() + self.recover_timeout_s
        attempt = 0
        try:
            while not self._closed:
                try:
                    if self._keepalive_task:
                        self._keepalive_task.cancel()
                        self._keepalive_task = None
                    if self._reader_task:
                        self._reader_task.cancel()
                    if self._writer is not None:
                        self._writer.close()
                    # in-flight RPCs from the keepalive-triggered path (the
                    # reader may still have been alive) must fail, not hang
                    self._fail_pending()
                    await self._open()
                    self.primary_lease = await self.lease_grant(
                        self._lease_ttl_s
                    )
                    for key, value in list(self._leased_keys.items()):
                        await self.put(key, value, lease=self.primary_lease)
                    self._keepalive_task = asyncio.create_task(
                        self._keepalive_loop(self._lease_ttl_s)
                    )
                    self.num_recoveries += 1
                    log.info(
                        "store connection recovered (lease %d, %d keys "
                        "re-asserted)", self.primary_lease,
                        len(self._leased_keys),
                    )
                    return
                except Exception as exc:
                    if time.monotonic() > deadline:
                        log.error(
                            "store recovery failed for %.0fs (%s) — "
                            "signalling lease loss",
                            self.recover_timeout_s, exc,
                        )
                        if self.on_lease_lost:
                            self.on_lease_lost()
                        return
                    # jittered exponential backoff: avoids a thundering herd
                    # of reconnect dials when a whole cluster loses the store
                    delay = min(
                        self.reconnect_base_s * (2 ** attempt),
                        self.reconnect_cap_s,
                    ) * (0.5 + 0.5 * self._reconnect_rng.random())
                    attempt += 1
                    await asyncio.sleep(delay)
        finally:
            self._recover_task = None

    # -- public kv api --

    def _track_leased(self, key: str, value: bytes, lease: int) -> None:
        if lease and lease == self.primary_lease:
            self._leased_keys[key] = value

    async def put(self, key: str, value: bytes, lease: int = 0) -> int:
        resp = await self._call(
            {"op": "put", "key": key, "value": value, "lease": lease}
        )
        if not resp["ok"]:
            raise StoreError(resp.get("error", "put failed"))
        self._track_leased(key, value, lease)
        return resp["rev"]

    async def create(self, key: str, value: bytes, lease: int = 0) -> bool:
        """Atomic create; False if the key already exists (ref: kv_create)."""
        resp = await self._call(
            {"op": "create", "key": key, "value": value, "lease": lease}
        )
        if resp["ok"]:
            self._track_leased(key, value, lease)
        return bool(resp["ok"])

    async def cas(
        self, key: str, expect: Optional[bytes], value: bytes, lease: int = 0
    ) -> bool:
        resp = await self._call(
            {"op": "cas", "key": key, "expect": expect, "value": value,
             "lease": lease}
        )
        if resp["ok"]:
            self._track_leased(key, value, lease)
        return bool(resp["ok"])

    async def get(self, key: str) -> Optional[bytes]:
        resp = await self._call({"op": "get", "key": key})
        kvs = resp.get("kvs", [])
        return kvs[0][1] if kvs else None

    async def get_prefix(self, prefix: str) -> List[Tuple[str, bytes]]:
        resp = await self._call({"op": "get_prefix", "prefix": prefix})
        return [(k, v) for k, v, _lease, _rev in resp.get("kvs", [])]

    async def delete(self, key: str) -> bool:
        # untrack BEFORE the RPC: if the store is down the delete raises, and
        # a later lease recovery must not resurrect a key we meant to remove
        self._leased_keys.pop(key, None)
        resp = await self._call({"op": "delete", "key": key})
        return bool(resp.get("deleted"))

    async def delete_prefix(self, prefix: str) -> int:
        for key in [k for k in self._leased_keys if k.startswith(prefix)]:
            del self._leased_keys[key]
        resp = await self._call({"op": "delete_prefix", "prefix": prefix})
        return int(resp.get("deleted", 0))

    async def lease_grant(self, ttl_s: float) -> int:
        resp = await self._call({"op": "lease_grant", "ttl": ttl_s})
        if not resp["ok"]:
            raise StoreError(resp.get("error", "lease_grant failed"))
        return resp["lease"]

    async def lease_revoke(self, lease: int) -> None:
        await self._call({"op": "lease_revoke", "lease": lease})

    async def lock(self, name: str, lease: Optional[int] = None) -> bool:
        resp = await self._call(
            {"op": "lock", "name": name, "lease": lease or self.primary_lease}
        )
        return bool(resp.get("acquired"))

    async def unlock(self, name: str, lease: Optional[int] = None) -> None:
        await self._call(
            {"op": "unlock", "name": name, "lease": lease or self.primary_lease}
        )

    async def _watch_raw(
        self, prefix: str, *, since_rev: Optional[int] = None,
        incarnation: Optional[str] = None,
    ) -> Tuple[dict, "WatchStream"]:
        """Low-level watch subscribe; returns the full server response (which
        carries either a ``kvs`` snapshot or a ``caught_up`` event delta) plus
        the claimed event stream."""
        fault = await faults.maybe_delay(faults.active("store.watch", prefix))
        if fault is not None and fault.kind in (faults.DROP, faults.REJECT):
            raise StoreError(f"injected store.watch fault on {prefix!r}")
        msg: dict = {"op": "watch", "prefix": prefix}
        if since_rev is not None:
            msg["since_rev"] = since_rev
            msg["incarnation"] = incarnation
        resp = await self._call(msg)
        if not resp["ok"]:
            raise StoreError(resp.get("error", "watch failed"))
        return resp, WatchStream(
            self, resp["watch_id"], self._claim_watch_queue(resp["watch_id"])
        )

    async def watch_prefix(
        self, prefix: str
    ) -> Tuple[List[Tuple[str, bytes]], "WatchStream"]:
        """Subscribe to a prefix; returns (current snapshot, event stream)."""
        resp, stream = await self._watch_raw(prefix)
        snapshot = [(k, v) for k, v, _l, _r in resp.get("kvs", [])]
        return snapshot, stream

    async def watch_prefix_resilient(
        self, prefix: str, *, grace_s: float = 0.0,
        rewatch_delay_s: float = 0.25,
    ) -> Tuple[List[Tuple[str, bytes]], "ResilientWatchStream"]:
        """Watch a prefix across store outages (stale-while-revalidate).

        Like :meth:`watch_prefix`, but the returned stream survives dropped
        watches and store restarts: it re-subscribes on its own, replays the
        missed event delta when the server can still cover our revision
        (same incarnation, history not overrun), and otherwise reconciles
        against a fresh snapshot — emitting synthetic puts for new/changed
        keys and synthetic deletes for keys that vanished. Deletes arising
        from a reconcile are deferred ``grace_s`` seconds and re-verified
        with a direct get, so keys whose owners are *also* mid-recovery
        (their lease re-put races ours) aren't flapped out of the last-known
        snapshot. During an outage consumers simply see no events and keep
        serving ``stream.state`` — the last-known view."""
        resp, inner = await self._watch_raw(prefix)
        snapshot = [(k, v) for k, v, _l, _r in resp.get("kvs", [])]
        stream = ResilientWatchStream(
            self, prefix, inner, snapshot,
            last_rev=resp.get("rev", 0),
            incarnation=resp.get("incarnation"),
            grace_s=grace_s, rewatch_delay_s=rewatch_delay_s,
        )
        return snapshot, stream

    def _claim_watch_queue(self, watch_id: int) -> asyncio.Queue:
        """Register the event queue, draining any events that arrived between
        the server creating the watch and the caller claiming it."""
        queue: asyncio.Queue = asyncio.Queue()
        for event in self._orphan_events.pop(watch_id, []):
            queue.put_nowait(event)
        self._watch_queues[watch_id] = queue
        return queue

    # -- pub/sub (NATS-subject role) --

    async def publish(self, subject: str, payload: bytes) -> int:
        resp = await self._call(
            {"op": "publish", "subject": subject, "payload": payload}
        )
        return int(resp.get("delivered", 0))

    async def subscribe(self, subject_prefix: str) -> "WatchStream":
        """Subscribe to a subject prefix; events have ``event == 'msg'``."""
        resp = await self._call({"op": "subscribe", "subject": subject_prefix})
        if not resp["ok"]:
            raise StoreError(resp.get("error", "subscribe failed"))
        watch_id = resp["watch_id"]
        return WatchStream(
            self, watch_id, self._claim_watch_queue(watch_id), kind="subscribe"
        )

    # -- work queues (JetStream pull-consumer role, ref: nats.rs:426) --

    async def q_push(self, queue: str, payload: bytes) -> int:
        resp = await self._call({"op": "q_push", "queue": queue, "payload": payload})
        return int(resp.get("depth", 0))

    async def q_pop(self, queue: str, timeout_s: float = 30.0) -> Optional[bytes]:
        resp = await self._call(
            {"op": "q_pop", "queue": queue, "timeout": timeout_s}
        )
        return resp.get("payload")

    async def q_len(self, queue: str) -> int:
        resp = await self._call({"op": "q_len", "queue": queue})
        return int(resp.get("depth", 0))

    async def wait_for_key_count(
        self, prefix: str, count: int, timeout_s: float = 60.0
    ) -> List[Tuple[str, bytes]]:
        """Block until >= ``count`` keys exist under ``prefix``
        (ref: leader_worker_barrier.rs:24)."""
        snapshot, stream = await self.watch_prefix(prefix)
        try:
            seen = dict(snapshot)
            deadline = time.monotonic() + timeout_s
            while len(seen) < count:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"barrier timeout: {len(seen)}/{count} under {prefix!r}"
                    )
                event = await asyncio.wait_for(stream.next(), timeout=remaining)
                if event is None:
                    raise StoreError("store connection lost during barrier")
                if event["event"] == "dropped":
                    # watch shed under backpressure — resubscribe and resync
                    await stream.cancel()
                    snapshot, stream = await self.watch_prefix(prefix)
                    seen = dict(snapshot)
                elif event["event"] == "put":
                    seen[event["key"]] = event["value"]
                else:
                    seen.pop(event["key"], None)
            return sorted(seen.items())
        finally:
            await stream.cancel()


class WatchStream:
    """Stream of {'event': 'put'|'delete', 'key', 'value', 'rev'} dicts."""

    def __init__(
        self,
        client: StoreClient,
        watch_id: int,
        queue: asyncio.Queue,
        kind: str = "watch",
    ):
        self._client = client
        self.watch_id = watch_id
        self._queue = queue
        self._kind = kind

    async def next(self) -> Optional[dict]:
        return await self._queue.get()

    def __aiter__(self) -> AsyncIterator[dict]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[dict]:
        while True:
            event = await self._queue.get()
            if event is None:
                return
            yield event

    async def cancel(self) -> None:
        self._client._watch_queues.pop(self.watch_id, None)
        op = "unwatch" if self._kind == "watch" else "unsubscribe"
        try:
            await self._client._call({"op": op, "watch_id": self.watch_id})
        except StoreError:
            pass
        # events in flight between pop and the unwatch ack land in the orphan
        # buffer; discard them so cancelled watches don't leak memory
        self._client._orphan_events.pop(self.watch_id, None)


class ResilientWatchStream:
    """A prefix watch that outlives dropped watches and store restarts.

    Same ``next()`` contract as :class:`WatchStream` (None == client closed
    for good), but ``'dropped'`` never reaches the consumer: the stream
    re-subscribes, replays the missed delta when the server still covers our
    revision, and otherwise reconciles a fresh snapshot into synthetic
    put/delete events. ``state`` is the last-known key->value view — safe to
    read at any time, including mid-outage (stale-while-revalidate).
    """

    def __init__(
        self,
        client: StoreClient,
        prefix: str,
        inner: WatchStream,
        snapshot: List[Tuple[str, bytes]],
        *,
        last_rev: int = 0,
        incarnation: Optional[str] = None,
        grace_s: float = 0.0,
        rewatch_delay_s: float = 0.25,
    ):
        self._client = client
        self.prefix = prefix
        self._inner = inner
        self.state: Dict[str, bytes] = dict(snapshot)
        self.last_rev = last_rev
        self.incarnation = incarnation
        self.grace_s = grace_s
        self.rewatch_delay_s = rewatch_delay_s
        self._out: asyncio.Queue = asyncio.Queue()
        self._pending_stale: Dict[str, asyncio.Task] = {}
        self.num_resyncs = 0
        self.num_catchups = 0
        self._driver = asyncio.create_task(self._run())

    def _track(self, event: dict) -> None:
        key = event.get("key")
        if event["event"] == "put":
            self.state[key] = event.get("value")
            self._cancel_stale(key)
        elif event["event"] == "delete":
            self.state.pop(key, None)
            self._cancel_stale(key)
        self.last_rev = max(self.last_rev, event.get("rev") or 0)

    def _cancel_stale(self, key: str) -> None:
        task = self._pending_stale.pop(key, None)
        if task is not None:
            task.cancel()

    async def _run(self) -> None:
        while True:
            event = await self._inner.next()
            if event is None:
                self._out.put_nowait(None)
                return
            if event["event"] == "dropped":
                if not await self._resync():
                    self._out.put_nowait(None)
                    return
                continue
            self._track(event)
            self._out.put_nowait(event)

    async def _resync(self) -> bool:
        """Re-subscribe after a drop; replay the delta or reconcile a
        snapshot. Returns False only when the client itself is closed."""
        # the old watch belongs to a dead (or shed) server registration;
        # drop the local queue and best-effort unwatch
        try:
            await self._inner.cancel()
        except Exception:
            pass
        while True:
            if self._client._closed:
                return False
            try:
                resp, inner = await self._client._watch_raw(
                    self.prefix, since_rev=self.last_rev,
                    incarnation=self.incarnation,
                )
                break
            except (StoreError, OSError):
                # store still down (or mid-recovery) — the consumer keeps
                # serving ``state`` while we retry
                await asyncio.sleep(self.rewatch_delay_s)
        self._inner = inner
        self.num_resyncs += 1
        self.incarnation = resp.get("incarnation")
        if resp.get("caught_up"):
            self.num_catchups += 1
            for event in resp.get("events", []):
                self._track(event)
                self._out.put_nowait(event)
            self.last_rev = max(self.last_rev, resp.get("rev") or 0)
            return True
        # snapshot reconcile: diff last-known state against the fresh view
        live = {k: v for k, v, _l, _r in resp.get("kvs", [])}
        rev = resp.get("rev") or 0
        for key, value in live.items():
            if self.state.get(key) != value:
                event = {"event": "put", "key": key, "value": value,
                         "rev": rev, "resync": True}
                self._track(event)
                self._out.put_nowait(event)
        for key in [k for k in self.state if k not in live]:
            if self.grace_s <= 0:
                event = {"event": "delete", "key": key, "value": None,
                         "rev": rev, "resync": True}
                self._track(event)
                self._out.put_nowait(event)
            elif key not in self._pending_stale:
                # the key's owner may itself be mid-recovery (its lease
                # re-put races our re-watch) — verify before evicting
                self._pending_stale[key] = asyncio.create_task(
                    self._stale_check(key)
                )
        self.last_rev = max(self.last_rev, rev)
        return True

    async def _stale_check(self, key: str) -> None:
        try:
            await asyncio.sleep(self.grace_s)
            while True:
                try:
                    value = await self._client.get(key)
                    break
                except (StoreError, OSError):
                    if self._client._closed:
                        return
                    await asyncio.sleep(self.rewatch_delay_s)
            if value is None and key in self.state:
                event = {"event": "delete", "key": key, "value": None,
                         "rev": self.last_rev, "resync": True}
                self.state.pop(key, None)
                self._out.put_nowait(event)
            elif value is not None and self.state.get(key) != value:
                event = {"event": "put", "key": key, "value": value,
                         "rev": self.last_rev, "resync": True}
                self.state[key] = value
                self._out.put_nowait(event)
        finally:
            self._pending_stale.pop(key, None)

    async def reconcile(self) -> Dict[str, List[str]]:
        """Diff the last-known view against the store. Empty lists mean the
        stream has fully converged with the live store."""
        live = dict(await self._client.get_prefix(self.prefix))
        return {
            "missing": sorted(k for k in self.state if k not in live),
            "extra": sorted(k for k in live if k not in self.state),
            "changed": sorted(
                k for k, v in self.state.items()
                if k in live and live[k] != v
            ),
        }

    async def next(self) -> Optional[dict]:
        return await self._out.get()

    def __aiter__(self) -> AsyncIterator[dict]:
        return self._iter()

    async def _iter(self) -> AsyncIterator[dict]:
        while True:
            event = await self._out.get()
            if event is None:
                return
            yield event

    async def cancel(self) -> None:
        self._driver.cancel()
        for task in list(self._pending_stale.values()):
            task.cancel()
        self._pending_stale.clear()
        try:
            await self._inner.cancel()
        except Exception:
            pass


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="dynamo-tpu-torch discovery store")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=DEFAULT_PORT)
    parser.add_argument(
        "--persist", default=None, metavar="PATH",
        help="snapshot unleased KV + work queues to PATH (msgpack, atomic "
             "rename) and restore from it on start",
    )
    return parser.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    server = StoreServer(args.host, args.port, persist_path=args.persist)
    asyncio.run(server.serve_forever())


if __name__ == "__main__":
    main()
