"""The port's disaggregated prefill/decode (``dynamo_tpu_torch.disagg``)
held against the JAX package: the relay's wire frames are the same bytes
(through the port's codec and msgpack) and each package decodes the
other's, corrupt frames raise ``KvIntegrityError`` in both; a port prefill
engine and a port decode engine give the aggregated streams of both
packages (f32, identical) through the device plane, the host relay and the
store's pull queue; a JAX prefill handler feeds a port decode handler over
the wire; a stale epoch is refused before the write with the cache
unchanged bit for bit; the handoff breaker falls back to local prefill and
counts as JAX's does. CPU, ``ModelConfig.tiny``, numpy seeds."""

import asyncio
import zlib

import jax
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.disagg import handlers as jhandlers
from dynamo_tpu.disagg import protocol as jproto
from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.engine import InferenceEngine as JEngine
from dynamo_tpu.runtime.context import Context as JContext
from dynamo_tpu_torch.disagg import handlers as thandlers
from dynamo_tpu_torch.disagg import protocol as tproto
from dynamo_tpu_torch.disagg.ici import DevicePlane, StaleEpochError
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine, Request
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.store import StoreClient, StoreServer
from dynamo_tpu_torch.runtime.transport import IngressServer

# ------------------------------- the wire ---------------------------------

L, N, KV, BS, HD = 2, 3, 2, 4, 8
WIRE_KINDS = {
    "float32": (np.float32, torch.float32, False),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, False),
    "int8": (np.int8, torch.int8, True),
    "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, True),
}


def _payloads(kind: str, seed: int = 0):
    """The same payload as numpy (ml_dtypes) arrays and as torch tensors."""
    ndt, tdt, scaled = WIRE_KINDS[kind]
    rng = np.random.default_rng(seed)
    shape = (L, N, KV, BS, HD)
    np_data, t_data = {}, {}
    for key in ("k", "v"):
        if ndt is np.int8:
            a = rng.integers(-127, 128, size=shape).astype(np.int8)
        else:
            a = (rng.standard_normal(shape) * 2).astype(np.float32).astype(ndt)
        np_data[key] = a
        view = {1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize]
        t_data[key] = torch.from_numpy(a.view(view).copy()).view(tdt)
    if scaled:
        for key in ("ks", "vs"):
            a = rng.random(shape[:-1]).astype(np.float32)
            np_data[key] = a
            t_data[key] = torch.from_numpy(a.copy())
    return np_data, t_data


@pytest.mark.parametrize("kind", sorted(WIRE_KINDS))
def test_frames_equal_jax_bytes(kind):
    np_data, t_data = _payloads(kind)
    want = msgpack.packb(jproto.kv_to_wire(np_data))
    got = codec.packb(tproto.kv_to_wire(t_data))
    assert got == want


@pytest.mark.parametrize("kind", sorted(WIRE_KINDS))
def test_each_package_decodes_the_others_frames(kind):
    np_data, t_data = _payloads(kind, seed=1)
    # a JAX frame through msgpack, decoded by the port
    port_got = tproto.kv_from_wire(codec.unpackb(
        msgpack.packb(jproto.kv_to_wire(np_data))))
    # a port frame through the port codec, decoded by JAX
    jax_got = jproto.kv_from_wire(msgpack.unpackb(
        codec.packb(tproto.kv_to_wire(t_data)), raw=False))
    assert set(port_got) == set(jax_got) == set(np_data)
    for key, a in np_data.items():
        assert port_got[key].dtype == t_data[key].dtype
        assert tproto.tensor_bytes(port_got[key]) == a.tobytes()
        assert jax_got[key].dtype == a.dtype
        assert jax_got[key].tobytes() == a.tobytes()


def _corrupt(kind: str, how: str, wire: dict) -> dict:
    wire = dict(wire)
    if how == "truncated":
        wire["k"] = wire["k"][: len(wire["k"]) // 2]
    elif how == "bit_flip":
        kb = bytearray(wire["v"])
        kb[len(kb) // 3] ^= 0x10
        wire["v"] = bytes(kb)
    elif how == "dtype":
        # a dtype of another width (a same-width name passes the size
        # check in both packages: the bytes are all the frame can verify)
        wire["dtype"] = "float32" if kind != "bfloat16" else "int8"
    elif how == "scale_flip":
        sb = bytearray(wire["ks"])
        sb[0] ^= 0x01
        wire["ks"] = bytes(sb)
    return wire


@pytest.mark.parametrize("kind,how", [
    (kind, how) for kind in ("bfloat16", "int8", "float8_e4m3fn")
    for how in ("truncated", "bit_flip", "dtype")
] + [("int8", "scale_flip"), ("float8_e4m3fn", "scale_flip")])
def test_corrupt_frames_raise_in_both_packages(kind, how):
    np_data, t_data = _payloads(kind, seed=2)
    jw = _corrupt(kind, how, jproto.kv_to_wire(np_data))
    tw = _corrupt(kind, how, tproto.kv_to_wire(t_data))
    with pytest.raises(jproto.KvIntegrityError):
        jproto.kv_from_wire(jw)
    with pytest.raises(tproto.KvIntegrityError):
        tproto.kv_from_wire(tw)


def test_unknown_dtype_and_crcless_frames():
    _, t_data = _payloads("float32")
    w = tproto.kv_to_wire(t_data)
    for pkg in (jproto, tproto):
        with pytest.raises(pkg.KvIntegrityError):
            pkg.kv_from_wire(dict(w, dtype="no_such_dtype"))
    older = {k: v for k, v in w.items() if not k.endswith("_crc")}
    got = tproto.kv_from_wire(older)
    assert torch.equal(got["k"], t_data["k"])
    assert zlib.crc32(tproto.tensor_bytes(got["v"])) == w["v_crc"]


# ---------------------------- engines in one process ----------------------

MC_KW = dict(vocab_size=256)
ENG_KW = dict(num_blocks=64, block_size=4, max_model_len=128,
              max_num_batched_tokens=128, prefill_buckets=(128,),
              decode_buckets=(4,), max_num_seqs=4)
PROMPTS = [list(range(1, 40)), [int(t) for t in
                                np.random.default_rng(5).integers(1, 250, 29)]]
REQUEST = {"max_tokens": 8, "ignore_eos": True}


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's parameters (numpy) and its aggregated greedy
    streams for PROMPTS."""
    engine = JEngine(JModelConfig.tiny(**MC_KW), JEngineConfig(**ENG_KW),
                     seed=0)
    tree = jax.tree.map(np.asarray, engine.params)

    async def run():
        out = []
        try:
            for p in PROMPTS:
                out.append(await _collect(engine.generate(
                    dict(REQUEST, token_ids=p), JContext())))
        finally:
            await engine.stop()
        return out

    return tree, asyncio.run(run())


def _engine(tree, **kw):
    mc = ModelConfig.tiny(**MC_KW)
    return InferenceEngine(mc, EngineConfig(**dict(ENG_KW, **kw)),
                           params=params_from_numpy(tree, mc, "cpu"),
                           device="cpu")


async def _collect(stream):
    toks = []
    async for out in stream:
        toks.extend(out["token_ids"])
    return toks


class LocalPrefillClient:
    """Stands in for the component Client: routes straight to an in-process
    prefill handler (the relay hop still rides the real transport)."""

    def __init__(self, handler, context_cls=Context):
        self.handler = handler
        self.context_cls = context_cls

    def instance_ids(self):
        return [1]

    def round_robin(self, request, context):
        return self.handler.generate(request, self.context_cls())


async def _decode_side(engine, prefill_client, plane, **cfg):
    dh = thandlers.DecodeHandler(
        engine, prefill_client=prefill_client, plane=plane,
        config=thandlers.DisaggConfig(min_remote_prefill_tokens=8, **cfg))
    server = IngressServer(dh.inject_handler(), host="127.0.0.1", port=0)
    await server.start()
    dh.kv_inject_addr = f"127.0.0.1:{server.port}"
    return dh, server


@pytest.mark.parametrize("path", ["device_plane", "relay"])
def test_disagg_streams_equal_aggregated_and_jax(reference, path):
    tree, jax_streams = reference

    async def run():
        pre, dec, agg = _engine(tree), _engine(tree), _engine(tree)
        plane = DevicePlane()
        ph = thandlers.PrefillHandler(pre, plane=plane)
        dh, server = await _decode_side(dec, LocalPrefillClient(ph), plane)
        if path == "relay":
            plane.unregister(dh.plane_id)   # not addressable: relay
        try:
            agg_streams, got = [], []
            for p in PROMPTS:
                req = dict(REQUEST, token_ids=p)
                agg_streams.append(await _collect(
                    agg.generate(dict(req), Context())))
                got.append(await _collect(dh.generate(dict(req),
                                                      Context())))
            counts = (dh.num_remote_prefills, dh.num_local_prefills,
                      ph.num_device_transfers, ph.num_relay_transfers)
            held = len(pre.scheduler.pool._evictable), pre.scheduler.running
            return agg_streams, got, counts, held
        finally:
            dh.close()
            if hasattr(ph, "_transport"):
                await ph._transport.close()
            await server.stop()
            for e in (pre, dec, agg):
                await e.stop()

    agg_streams, got, counts, (_, running) = asyncio.run(run())
    assert agg_streams == jax_streams
    assert got == jax_streams
    n = len(PROMPTS)
    want = (n, 0, n, 0) if path == "device_plane" else (n, 0, 0, n)
    assert counts == want
    assert not running


def test_queue_mode_streams_equal_jax(reference):
    tree, jax_streams = reference

    async def run():
        store = StoreServer(host="127.0.0.1", port=0)
        await store.start()
        addr = f"127.0.0.1:{store.port}"
        p_store, d_store = (await StoreClient.connect(addr),
                            await StoreClient.connect(addr))
        pre, dec = _engine(tree), _engine(tree)
        plane = DevicePlane()
        ph = thandlers.PrefillHandler(pre, plane=plane)
        qw = thandlers.PrefillQueueWorker(ph, p_store, queue_name="q")
        qw.start()
        dh, server = await _decode_side(
            dec, None, plane, use_queue=True, queue_name="q",
            queue_wait_s=30.0)
        dh.store = d_store
        plane.unregister(dh.plane_id)
        try:
            got = [await _collect(dh.generate(dict(REQUEST, token_ids=p),
                                              Context())) for p in PROMPTS]
            return got, dh.num_remote_prefills, qw.num_pulled
        finally:
            await qw.stop()
            dh.close()
            if hasattr(ph, "_transport"):
                await ph._transport.close()
            await server.stop()
            await pre.stop()
            await dec.stop()
            await p_store.close()
            await d_store.close()
            await store.stop()

    got, remote, pulled = asyncio.run(run())
    assert got == jax_streams
    assert remote == pulled == len(PROMPTS)


def test_jax_prefill_feeds_port_decode_over_the_wire(reference):
    """A JAX ``PrefillHandler`` (JAX engine) pushes its KV with the JAX
    transport and msgpack into a port ``DecodeHandler``'s ``kv_inject``
    ingress: the port decodes and streams the JAX aggregated tokens."""
    tree, jax_streams = reference

    async def run():
        jpre = JEngine(JModelConfig.tiny(**MC_KW), JEngineConfig(**ENG_KW),
                       seed=0)
        jph = jhandlers.PrefillHandler(jpre)
        dec = _engine(tree)
        dh, server = await _decode_side(
            dec, LocalPrefillClient(jph, JContext), DevicePlane())
        try:
            got = [await _collect(dh.generate(dict(REQUEST, token_ids=p),
                                              Context())) for p in PROMPTS]
            return got, jph.num_relay_transfers, dh.num_remote_prefills
        finally:
            dh.close()
            if hasattr(jph, "_transport"):
                await jph._transport.close()
            await server.stop()
            await jpre.stop()
            await dec.stop()

    got, relayed, remote = asyncio.run(run())
    assert got == jax_streams
    assert relayed == remote == len(PROMPTS)


def _cache_bytes(engine):
    return {key: [tproto.tensor_bytes(t) for t in layers]
            for key, layers in engine.cache.items()}


def test_stale_epoch_is_refused_before_the_write(reference):
    """A delayed transfer aimed at a recycled reservation — through the
    device plane and through the relay inject — raises / is answered as a
    permanent reject, and the destination cache is unchanged bit for bit;
    the live epoch is accepted."""
    import time

    tree, _ = reference

    async def run():
        src, dst = _engine(tree), _engine(tree)
        plane = DevicePlane()
        dh = thandlers.DecodeHandler(dst, prefill_client=None, plane=plane)
        try:
            seq_p, _ = await src.prefill_held(Request("p", list(range(1, 17)),
                                                      1))
            seq_a = dst.reserve_sequence(Request("r", list(range(1, 17)), 4))
            old_epoch, old_blocks = seq_a.kv_epoch, list(seq_a.block_table)
            dst.cancel_reservation(seq_a)
            seq_b = dst.reserve_sequence(Request("r", list(range(1, 17)), 4))
            assert seq_b.kv_epoch > old_epoch
            before = _cache_bytes(dst)
            with pytest.raises(StaleEpochError):
                await plane.transfer(src, seq_p.block_table, dst, old_blocks,
                                     dst_seq_id="r", dst_epoch=old_epoch)
            after_plane = _cache_bytes(dst)
            # the relay half: the same payload, stamped with the old epoch
            data = await src.extract_kv(seq_p)
            done = asyncio.get_running_loop().create_future()
            dh.pending["r"] = thandlers.PendingHandoff(
                seq=seq_b, done=done, epoch=seq_b.kv_epoch,
                deadline=time.monotonic() + 30.0)
            payload = tproto.kv_to_wire(data)
            payload.update(request_id="r", epoch=old_epoch, first_token=7)
            inj = dh.inject_handler()
            acks = [a async for a in inj.generate(payload, Context())]
            after_relay = _cache_bytes(dst)
            # the stale check inside the scatter itself (past the handler)
            with pytest.raises(StaleEpochError):
                await dst.inject_kv(seq_b, data, epoch=old_epoch)
            after_inject = _cache_bytes(dst)
            payload["epoch"] = seq_b.kv_epoch
            ok = [a async for a in inj.generate(payload, Context())]
            got = await dst.extract_kv(seq_b)
            dh.pending.pop("r")
            dst.cancel_reservation(seq_b)
            src.release_held(seq_p)
            return (before, after_plane, after_relay, after_inject, acks,
                    ok, done.result(), dh.num_epoch_rejects, data, got)
        finally:
            dh.close()
            await src.stop()
            await dst.stop()

    (before, after_plane, after_relay, after_inject, acks, ok, first,
     rejects, data, got) = asyncio.run(run())
    assert after_plane == before
    assert after_relay == before
    assert after_inject == before
    assert acks[0]["ok"] is False and acks[0]["permanent"] is True
    assert rejects == 1
    assert ok == [{"ok": True}] and first == 7
    for key in data:
        assert tproto.tensor_bytes(got[key]) == tproto.tensor_bytes(data[key])


class FailingClient:
    def instance_ids(self):
        return [1]

    async def round_robin(self, request, context):
        raise RuntimeError("prefill worker exploded")
        yield  # pragma: no cover


def test_breaker_fallback_counts_equal_jax(reference):
    """Five long prompts against a prefill client that always fails, with a
    breaker threshold of 3: both packages fall back to local prefill for
    each, trip the breaker after the third failure (the last two never try
    the remote path) and publish the same disagg gauges."""
    tree, _ = reference

    async def drive(pkg):
        if pkg == "jax":
            engine = JEngine(JModelConfig.tiny(**MC_KW),
                             JEngineConfig(**ENG_KW), seed=0)
            mod, ctx = jhandlers, JContext
        else:
            engine, mod, ctx = _engine(tree), thandlers, Context
        dh = mod.DecodeHandler(
            engine, prefill_client=FailingClient(),
            config=mod.DisaggConfig(min_remote_prefill_tokens=8,
                                    breaker_failure_threshold=3,
                                    breaker_cooldown_s=60.0))
        dh.kv_inject_addr = "127.0.0.1:9"
        try:
            streams = [await _collect(dh.generate(
                dict(REQUEST, token_ids=PROMPTS[0], max_tokens=3), ctx()))
                for _ in range(5)]
            return (streams, dh.num_fallbacks, dh.num_local_prefills,
                    dh.num_remote_prefills, dh.metrics_extra(),
                    dict(dh.pending), engine.scheduler.pool.num_free)
        finally:
            dh.close()
            await engine.stop()

    jax_out = asyncio.run(drive("jax"))
    port_out = asyncio.run(drive("port"))
    assert port_out == jax_out
    assert port_out[1:4] == (3, 5, 0)
    assert port_out[4]["disagg"]["breaker_open"] == 1.0
