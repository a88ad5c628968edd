"""The port's metrics aggregator (``dynamo_tpu_torch/metrics_aggregator.py``
on its own codec and exposition) held against the JAX package's: a JAX and
a port aggregator subscribe to one store, the same load-metrics snapshots
(every optional block present, absent, cleared), KV events and planner
events are published once, and both expositions hold the same series with
the same values (``_created`` samples aside: the port's exposition leaves
them out). The planner-signals feeds they publish decode alike, and stale
expiry drops the same label sets. Tolerance: none. The perf recorder copy
(``llm/recorder.py``) is held against the JAX one on the same streams."""

import asyncio
import json

import msgpack
import pytest

from dynamo_tpu import metrics_aggregator as jagg
from dynamo_tpu.llm import recorder as jrec
from dynamo_tpu.runtime.component import DistributedRuntime as JaxRuntime
from dynamo_tpu.runtime.store import StoreServer
from dynamo_tpu.utils.config import RuntimeConfig as JaxRuntimeConfig
from dynamo_tpu_torch import metrics_aggregator as tagg
from dynamo_tpu_torch.llm import recorder as trec
from dynamo_tpu_torch.runtime import codec
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.utils.config import RuntimeConfig

SNAPSHOTS = [
    # an older worker: no optional block at all
    {"worker_id": 1, "kv_usage": 0.1, "num_requests_running": 0,
     "num_requests_waiting": 2, "prefix_cache_hits": 3,
     "prefix_cache_queries": 12},
    # every block the port's workers publish
    {"worker_id": 2, "kv_usage": 0.5, "num_requests_running": 4,
     "num_requests_waiting": 1, "prefix_cache_hits": 30,
     "prefix_cache_queries": 60,
     "spec": {"drafted": 40, "accepted": 17},
     "obs": {"mfu": 0.0123, "goodput_tok_s": 812.5,
             "padding_waste_ratio": 0.25, "total_goodput_tokens": 4096.0,
             "total_steps": 77.0, "spec_reject_waste_ratio": 0.1},
     "disagg": {"fallback_total": 2, "breaker_open": 1,
                "transfer_retries_total": 3, "orphans_reaped_total": 4},
     "kvbm": {"host_pool_bytes": 4096, "spills_total": 3,
              "onboard_requests_total": 5, "g4_puts_total": 6,
              "g4_hits_total": 7, "peer_hits_total": 8, "prefix_nodes": 9,
              "prefix_hit_tokens_total": 160,
              "prefix_evictions_total": 2},
     "preempt": {"notices": 2, "evacuated_total": 5},
     "faults": {"worker.stream/truncate": 1, "engine.stall/delay": 2}},
    # worker 2 again: a cleared fault plan and new spec counters
    {"worker_id": 2, "kv_usage": 0.6, "num_requests_running": 3,
     "num_requests_waiting": 0, "spec": {"drafted": 50, "accepted": 30},
     "faults": {"engine.stall/delay": 2}},
    {"worker_id": "w3", "kv_usage": 0.25, "num_requests_running": 1,
     "num_requests_waiting": 4, "obs": {"mfu": 0.5},
     "preempt": {"notices": 1}},
]
KV_EVENTS = [{"event": {"kind": "stored"}}, {"event": {"kind": "removed"}},
             {"event": {"kind": "stored"}}, {"event": {}}]
PLANNER_EVENTS = [
    {"kind": "degradation", "direction": "engage", "step": "shed_low_tier",
     "level": 1, "pressure": 2.0},
    {"kind": "scale", "prefill": 2, "decode": 5},
    {"kind": "preemption", "worker": "w2", "notices": 1},
    {"kind": "preemption", "notices": 3},
    {"kind": "replay_wave", "wave": "storewave", "windows_to_recover": 2},
    {"kind": "replay_wave", "wave": "stallwave",
     "windows_to_recover": None},
    {"kind": "degradation", "direction": "release",
     "step": "shed_low_tier", "level": 0},
    {"kind": "unknown"},
]


def _series(text: str) -> list:
    """The aggregator's samples, HELP and TYPE lines (every series it
    registers carries the component label)."""
    names = set()
    for line in text.splitlines():
        if 'component="backend"' in line and not line.startswith("#"):
            names.add(line.split("{")[0])
    keep = []
    for line in text.splitlines():
        if line.startswith("#"):
            parts = line.split()
            if len(parts) > 2 and any(
                    parts[2] == n or n.startswith(parts[2] + "_")
                    for n in names):
                keep.append(line)
        elif line.split("{")[0] in names \
                and not line.split("{")[0].endswith("_created"):
            keep.append(line)
    return sorted(keep)


async def _wait(cond, what):
    for _ in range(400):
        if cond():
            return
        await asyncio.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture
def loop():
    loop = asyncio.new_event_loop()
    yield loop
    loop.close()


def test_exposition_and_signals_equal_jax(loop):
    async def scenario():
        server = StoreServer(host="127.0.0.1", port=0)
        await server.start()
        addr = f"127.0.0.1:{server.port}"
        jrt = await JaxRuntime.from_settings(JaxRuntimeConfig(
            store_addr=addr))
        trt = await DistributedRuntime.from_settings(RuntimeConfig(
            store_addr=addr))
        now = [0.0]
        aggs = {"jax": jagg.MetricsAggregator(jrt, "backend",
                                              stale_after_s=5.0,
                                              clock=lambda: now[0]),
                "port": tagg.MetricsAggregator(trt, "backend",
                                               stale_after_s=5.0,
                                               clock=lambda: now[0])}
        ns = trt.namespace().name
        sig = None
        try:
            for a in aggs.values():
                await a.start(signals_interval_s=0.05)
            comp = trt.namespace().component("backend")
            load = comp.event_subject("load_metrics")
            kv = comp.event_subject("kv_events")
            planner = tagg.planner_events_subject(ns)
            for i, snap in enumerate(SNAPSHOTS):
                await trt.store.publish(load + str(i),
                                        msgpack.packb(snap))
                await _wait(lambda: all(
                    a.worker_stats.get(str(snap["worker_id"])) == snap
                    for a in aggs.values()), f"snapshot {i}")
            for ev in KV_EVENTS:
                await trt.store.publish(kv + "1", codec.packb(ev))
            for ev in PLANNER_EVENTS:
                await trt.store.publish(planner, codec.packb(ev))
            await asyncio.sleep(0.3)
            texts = {s: rt.metrics.render().decode()
                     for s, rt in (("jax", jrt), ("port", trt))}
            # the signals each aggregator publishes from now on, decoded
            sig = await trt.store.subscribe(f"{ns}/planner_signals")
            payloads = []
            while len(payloads) < 6:
                ev = await asyncio.wait_for(sig.next(), 5.0)
                if ev["event"] == "msg":
                    payloads.append(codec.unpackb(ev["value"]))
            calls = {s: (a.queue_depth(), a.spec_acceptance(),
                         a.preempt_notices(), a.goodput_tok_s(),
                         a.goodput_tokens_total(), a._obs_mean("mfu"))
                     for s, a in aggs.items()}
            # worker 2 goes silent: both drop the same label sets
            now[0] = 4.0
            await trt.store.publish(load + "x", msgpack.packb(SNAPSHOTS[0]))
            await _wait(lambda: all(
                a._last_seen.get("1") == 4.0 for a in aggs.values()),
                "refresh")
            now[0] = 7.0
            for a in aggs.values():
                a.expire_stale()
            expired = {s: rt.metrics.render().decode()
                       for s, rt in (("jax", jrt), ("port", trt))}
            return texts, payloads, calls, expired
        finally:
            for a in aggs.values():
                await a.stop()
            if sig is not None:
                await sig.cancel()
            await jrt.shutdown()
            await trt.shutdown()
            await server.stop()

    texts, payloads, calls, expired = loop.run_until_complete(scenario())
    want, got = _series(texts["jax"]), _series(texts["port"])
    assert got == want
    assert any('kind="replay_wave"' in ln for ln in got)
    assert any('site="worker.stream"' in ln and ln.endswith(" 0.0")
               for ln in got)
    assert calls["port"] == calls["jax"]
    # both aggregators publish the same signal payloads (one stream)
    distinct = {json.dumps(p, sort_keys=True) for p in payloads}
    assert len(distinct) == 1, payloads
    assert payloads[0]["queue_depth"] == 2 + 0 + 4
    assert _series(expired["port"]) == _series(expired["jax"])
    assert 'worker="2"' not in expired["port"]


def test_recorder_equals_jax_on_the_same_streams(tmp_path):
    async def run(mod, path):
        rec = mod.Recorder(path=str(path), capture_payloads=True)

        async def stream(n, fail=False):
            for i in range(n):
                yield {"i": i}
            if fail:
                raise RuntimeError("dead")

        for rid, n in (("a", 3), ("b", 5)):
            async for _ in rec.record_stream(rid, stream(n), trace_id="t"):
                pass
        with pytest.raises(RuntimeError):
            async for _ in rec.record_stream("c", stream(2, True)):
                pass
        agg = rec.aggregate()
        rows = mod.load_jsonl(str(path))
        shape = [(r["request_id"], [(e["kind"], e.get("payload"))
                                    for e in r["events"]],
                  r["summary"]["num_items"], r["summary"]["finished"],
                  r.get("trace_id")) for r in rows]
        return agg["num_streams"], agg["total_items"], shape

    want = asyncio.run(run(jrec, tmp_path / "j.jsonl"))
    got = asyncio.run(run(trec, tmp_path / "t.jsonl"))
    assert got == want
    assert trec._pct([1.0, 2.0, 3.0, 4.0], 50) == jrec._pct(
        [1.0, 2.0, 3.0, 4.0], 50)
