"""The port's control plane held against the JAX package: the system server
(the port's own HTTP server against JAX's aiohttp one: the same status
codes and JSON for the same probes, drain handlers, traces and fault
plans, and the exposition's content type), the ``engine_*`` gauges on
``/metrics``, ``HealthCheckManager`` under a scripted probe, the
degradation ladder and ``apply_engine_clamps``, a JAX planner's order in
the store shedding tier 0 at a port frontend, the load snapshot's ``spec``
and ``obs`` keys beside a JAX worker's, and a port worker process that
answers ``/health`` and exits 0 after ``POST /drain``. CPU."""

import asyncio
import dataclasses
import json
import os
import signal
import time
import types

import aiohttp
import jax
import msgpack
import numpy as np
import prometheus_client
import pytest

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.observability import gauges as jgauges
from dynamo_tpu.planner import connector as jconnector
from dynamo_tpu.planner import degradation as jdeg
from dynamo_tpu.router import publisher as jpublisher
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import health as jhealth
from dynamo_tpu.runtime import store as jstore
from dynamo_tpu.runtime import system_server as jsys
from dynamo_tpu.runtime.context import Context as JaxContext
from dynamo_tpu.utils import metrics as jmetrics
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.observability import gauges as tgauges
from dynamo_tpu_torch.planner import degradation as tdeg
from dynamo_tpu_torch.router import publisher as tpublisher
from dynamo_tpu_torch.runtime import codec as tcodec
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime import health as thealth
from dynamo_tpu_torch.runtime import store as tstore
from dynamo_tpu_torch.runtime import system_server as tsys
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.utils import metrics as tmetrics
from test_torch_distributed import (  # noqa: F401
    ROOT, Proc, free_port, tok_file,
)
from test_torch_frontend_http import TIMEOUT, fetch, make_service

SIDES = {
    "jax": types.SimpleNamespace(sys=jsys, faults=jfaults, metrics=jmetrics,
                                 health=jhealth, deg=jdeg, gauges=jgauges),
    "port": types.SimpleNamespace(sys=tsys, faults=tfaults, metrics=tmetrics,
                                  health=thealth, deg=tdeg, gauges=tgauges),
}
ENG = dict(block_size=16, num_blocks=64, max_num_seqs=4,
           max_num_batched_tokens=128, max_model_len=128,
           prefill_buckets=(64, 128), decode_buckets=(4,))


@pytest.fixture(autouse=True)
def _clean_faults():
    yield
    tfaults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def tree():
    return jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jcfg.ModelConfig.tiny(512)))


def port_engine(tree, **kw):
    mc = tcfg.ModelConfig.tiny(512)
    return InferenceEngine(mc, tcfg.EngineConfig(**ENG, **kw),
                           params=params_from_numpy(tree, mc, "cpu"),
                           device="cpu")


def jax_engine(tree, **kw):
    return JaxEngine(jcfg.ModelConfig.tiny(512),
                     jcfg.EngineConfig(attention_impl="einsum", **ENG, **kw),
                     params=jax.tree.map(jax.numpy.asarray, tree))


async def _get(s, port, method, path, **kw):
    async with s.request(method, f"http://127.0.0.1:{port}{path}",
                         **kw) as r:
        raw = await r.read()
        ctype = r.headers.get("Content-Type", "")
        body = json.loads(raw) if "json" in ctype else raw.decode()
        return r.status, body


# ---------------------------- system server ------------------------------

PLAN = {"seed": 7, "rules": [
    {"site": "engine.stall", "kind": "delay", "match": "decode",
     "delay_s": 0.5, "times": 2, "wave": "w1"},
    {"site": "transport.send", "kind": "error", "times": None,
     "wave": "w2"}]}


async def _system_script(side):
    """One script of probes and admin calls against ``side``'s server."""
    m = SIDES[side]
    registry = m.metrics.MetricsRegistry(prefix="cp")
    registry.gauge("engine_mfu", "live mfu").set(0.25)
    registry.counter("requests_total", "served", ["kind"]).labels(
        kind="a").inc(3)
    server = m.sys.SystemServer(metrics=registry, host="127.0.0.1", port=0)
    await server.start()
    out = []
    drained = []
    try:
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            async def call(method, path, **kw):
                out.append((method, path, await _get(s, server.port, method,
                                                     path, **kw)))
            await call("GET", "/health")               # no probes: healthy
            await call("POST", "/drain")               # nothing drainable
            server.register_probe("a", lambda: {"healthy": True, "n": 1})
            await call("GET", "/health")
            server.register_probe("b", lambda: {"healthy": False})
            await call("GET", "/health")
            server.register_probe("c", lambda: 1 / 0)
            await call("GET", "/health")
            server.unregister_probe("b")
            server.unregister_probe("c")
            await call("GET", "/health")
            await call("GET", "/live")
            server.set_live(False)
            await call("GET", "/live")
            server.register_drain("w/1", lambda: drained.append(1))
            server.register_drain("bad", lambda: 1 / 0)
            await call("POST", "/drain")
            await call("GET", "/drain")                # wrong method
            await call("GET", "/nope")
            await call("GET", "/debug/traces/nope")
            await call("GET", "/debug/faults")
            await call("DELETE", "/debug/faults")
            await call("POST", "/debug/faults", data=b"{not json")
            await call("POST", "/debug/faults", json={"seed": 1, "rules": [
                {"site": "x", "kind": "bogus"}]})
            await call("POST", "/debug/faults", json=PLAN)
            await call("POST", "/debug/faults", json=dict(PLAN, rules=[
                {"site": "store.call", "kind": "error", "times": 1,
                 "wave": "w3"}]))                      # same seed: merged
            await call("GET", "/debug/faults")
            await call("DELETE", "/debug/faults?wave=w1")
            await call("GET", "/debug/faults")
            await call("DELETE", "/debug/faults")
            await call("GET", "/debug/faults")
            async with s.get(f"http://127.0.0.1:{server.port}/metrics") as r:
                ctype = r.headers["Content-Type"]
                metrics = [ln for ln in (await r.text()).splitlines()
                           if "_created" not in ln]
    finally:
        await server.stop()
    return out, drained, ctype, metrics


def test_system_server_answers_as_the_jax_server():
    want = asyncio.run(_system_script("jax"))
    got = asyncio.run(_system_script("port"))
    for w, g in zip(want[0], got[0]):
        assert g == w
    assert len(got[0]) == len(want[0]) == 23
    assert got[1:] == want[1:]
    statuses = [status for _, _, (status, _) in got[0]]
    assert statuses[:9] == [200, 404, 200, 503, 503, 200, 200, 503, 202]
    assert got[0][8][2][1] == {"draining": ["w/1"]}
    assert got[2] == prometheus_client.CONTENT_TYPE_LATEST
    assert "cp_engine_mfu 0.25" in got[3]


@pytest.mark.parametrize("path", ["/debug/traces", "/debug/traces/{id}"])
def test_trace_routes_answer_as_the_jax_server(monkeypatch, path):
    """Both servers over the same spans in their tracer's buffer: the ids
    and the assembled trace (path parameter routed) are equal."""
    from dynamo_tpu import tracing as jtracing
    from dynamo_tpu_torch import tracing as ttracing

    tid = "0af7651916cd43dd8448eb211c80319c"
    spans = [
        {"name": "http.request", "trace_id": tid, "span_id": "a" * 16,
         "parent_id": None, "start_unix": 1.0, "duration_s": 0.5,
         "status": "ok", "attrs": {"route": "/v1/chat"}, "events": [],
         "service": "frontend"},
        {"name": "engine.decode", "trace_id": tid, "span_id": "b" * 16,
         "parent_id": "a" * 16, "start_unix": 1.1, "duration_s": 0.3,
         "status": "ok", "attrs": {"spec_drafted": 3}, "events": [],
         "service": "worker"},
    ]
    fakes = [types.SimpleNamespace(to_dict=lambda d=d: dict(d))
             for d in spans]
    for mod in (jtracing, ttracing):
        tracer = mod.get_tracer()
        monkeypatch.setattr(tracer, "trace_ids", lambda limit=50: [tid])
        monkeypatch.setattr(tracer, "get_trace",
                            lambda t: fakes if t == tid else [])

    async def script(side):
        server = SIDES[side].sys.SystemServer(host="127.0.0.1", port=0)
        await server.start()
        try:
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                return [await _get(s, server.port, "GET",
                                   path.replace("{id}", t))
                        for t in (tid, "f" * 32)]
        finally:
            await server.stop()
    want, got = asyncio.run(script("jax")), asyncio.run(script("port"))
    assert got == want
    assert got[0][0] == 200


def test_unported_admin_routes_are_refused_by_name(tmp_path):
    """No admin route is left unported: ``/debug/profile``, the last one
    (refused with 501 until profiling was ported), answers 200 with a
    ``torch.profiler`` trace, as the JAX server answers with its own;
    ``/preempt`` is served (below)."""
    async def script():
        server = tsys.SystemServer(host="127.0.0.1", port=0)
        await server.start()
        try:
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                return [await _get(s, server.port, "GET",
                                   f"/debug/profile?ms=20&dir={tmp_path}")]
        finally:
            await server.stop()
    for status, body in asyncio.run(script()):
        assert status == 200
        assert os.path.isfile(body["trace_file"])
        assert body["requested_ms"] == 20


def test_preempt_route_answers_as_the_jax_server():
    """``POST /preempt`` with nothing registered (404), then with two
    maintenance-notice triggers, one of which raises (202 naming the one
    that fired): the same statuses, bodies and firings as JAX's server."""
    async def script(side):
        server = SIDES[side].sys.SystemServer(host="127.0.0.1", port=0)
        fired = []
        await server.start()
        try:
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                out = [await _get(s, server.port, "POST", "/preempt")]
                server.register_preempt("w/1", lambda: fired.append("w/1"))

                def broken():
                    raise RuntimeError("boom")

                server.register_preempt("w/2", broken)
                out.append(await _get(s, server.port, "POST", "/preempt"))
                return out, fired
        finally:
            await server.stop()

    want, got = asyncio.run(script("jax")), asyncio.run(script("port"))
    assert got == want
    assert got[0][0][0] == 404
    assert got[0][1] == (202, {"evacuating": ["w/1"]})
    assert got[1] == ["w/1"]


# ------------------------------ gauges -----------------------------------


def _families(text):
    return sorted(ln for ln in text.splitlines()
                  if ln.startswith(("# HELP", "# TYPE")))


def test_metrics_carry_the_engine_gauges(tree):
    """After a served spec request, the port's gauges render the JAX
    gauges' families (names, labels, help text) on the system server's
    ``/metrics``, with decode MFU and the spec-reject waste series."""
    texts = {}
    for side, make in (("jax", jax_engine), ("port", port_engine)):
        m = SIDES[side]
        engine = make(tree, spec_mode="ngram")
        registry = m.metrics.MetricsRegistry(prefix="dynamo")
        gauges = m.gauges.EngineObsGauges(registry, engine)

        async def go(engine=engine):
            await engine.start()
            try:
                ctx = Context() if side == "port" else JaxContext()
                async for _ in engine.generate(
                        {"token_ids": [3, 5, 7] * 10, "max_tokens": 12},
                        ctx):
                    pass
            finally:
                await engine.stop()
        asyncio.run(go())
        wire = gauges.refresh()
        texts[side] = (registry.render().decode(), wire)
    port_text, port_wire = texts["port"]
    assert _families(port_text) == _families(texts["jax"][0])
    assert 'dynamo_engine_wasted_flops_ratio{cause="spec_reject"}' \
        in port_text
    line = next(ln for ln in port_text.splitlines() if ln.startswith(
        'dynamo_engine_mfu_by_class{step="decode"}'))
    assert float(line.split()[-1]) > 0
    assert port_wire["spec_drafted"] > 0
    # the wire dict carries the JAX recorder's keys the port's has
    assert set(port_wire) <= set(texts["jax"][1]) | {
        "stalls_total", "stall_dead", "stall_quarantined_shapes",
        "pressure_level", "pressure_peak", "pressure_spills_total",
        "pressure_shed_total"}


def test_load_snapshot_carries_the_jax_keys(tree):
    """A port worker's load snapshot (spec engine, recorder on) has the
    JAX worker's top-level keys and the same ``spec`` and ``obs`` fields,
    and its bytes unpack with msgpack."""
    snaps = {}
    for side, make, pub_mod in (("jax", jax_engine, jpublisher),
                                ("port", port_engine, tpublisher)):
        engine = make(tree, spec_mode="ngram")
        registry = SIDES[side].metrics.MetricsRegistry(prefix="dynamo")
        gauges = SIDES[side].gauges.EngineObsGauges(registry, engine)
        component = types.SimpleNamespace(event_subject=lambda s: s)
        pub = pub_mod.WorkerMetricsPublisher(
            component, 7, lambda engine=engine: engine.stats,
            spec_fn=engine.spec_stats.to_dict, obs_fn=gauges.refresh)
        snaps[side] = pub.snapshot()
    port, want = snaps["port"], snaps["jax"]
    assert set(port) == set(want) >= {"spec", "obs"}
    assert set(port["spec"]) == set(want["spec"])
    assert port["spec"] == want["spec"]
    assert set(port["obs"]) <= set(want["obs"]) | {
        "stalls_total", "stall_dead", "stall_quarantined_shapes",
        "pressure_level", "pressure_peak", "pressure_spills_total",
        "pressure_shed_total"}
    assert msgpack.unpackb(tcodec.packb(port), raw=False) == port


# ---------------------------- health probes ------------------------------

SCRIPT = [True, False, False, True, False, False, False, True, True,
          False, "hang", "hang", "hang", True]


def test_health_manager_transitions_equal_jax():
    """The same probe script (failures, a hang past the timeout,
    recoveries) through both managers: equal states and callbacks."""
    async def run(side):
        m = SIDES[side].health
        events = []
        mgr = m.HealthCheckManager(
            m.HealthCheckConfig(period_s=0.01, timeout_s=0.05,
                                failure_threshold=3),
            on_unhealthy=lambda n: events.append(("down", n)),
            on_recovered=lambda n: events.append(("up", n)))
        steps = iter(SCRIPT)

        async def probe():
            r = next(steps)
            if r == "hang":
                await asyncio.sleep(1.0)
            elif not r:
                raise RuntimeError("canary failed")
        mgr.register("backend/generate", probe)
        trace = []
        for _ in SCRIPT:
            await mgr._probe_once("backend/generate", probe)
            st = mgr.status("backend/generate")
            trace.append((st["healthy"], st["probes"],
                          st["consecutive_failures"], st["last_error"]))
        return trace, events, mgr.healthy, mgr.status("other")
    got, want = asyncio.run(run("port")), asyncio.run(run("jax"))
    assert got == want
    assert got[1] == [("down", "backend/generate"),
                      ("up", "backend/generate"),
                      ("down", "backend/generate"),
                      ("up", "backend/generate")]


def test_engine_canary_runs_through_generate(tree):
    engine = port_engine(tree)

    async def go():
        try:
            await thealth.engine_canary(engine)()
        finally:
            await engine.stop()
    asyncio.run(go())
    assert engine.num_generated_tokens == 1


# ----------------------------- degradation -------------------------------

PRESSURES = [0.5, 1.6, 1.2, 2.0, 1.5, 3.0, 9.0, 1.1, 1.0, 0.2, 0.9, 1.7,
             0.5, 0.1, 0.1, 0.1]


def test_degradation_ladder_equals_jax():
    got = {}
    for side in ("jax", "port"):
        m = SIDES[side].deg
        ladder = m.DegradationLadder(m.DegradationConfig(
            shed_tier=2, spec_k_clamp=2, chunk_clamp_tokens=128))
        seq = [(ladder.update(p), ladder.level, ladder.actions())
               for p in PRESSURES]
        got[side] = (seq, ladder.transitions, m.STEPS, m.NO_DEGRADATION)
    assert got["port"] == got["jax"]


def test_ladder_emits_its_span():
    from dynamo_tpu_torch import tracing
    from dynamo_tpu_torch.tracing import InMemorySpanExporter

    tracing.reset()
    try:
        tracer = tracing.get_tracer()
        tracer.configure(sample_ratio=1.0)
        exp = InMemorySpanExporter()
        tracer.add_exporter(exp)
        tdeg.DegradationLadder().update(2.0)
        span, = [s for s in exp.spans if s.name == "planner.degradation"]
        assert span.attrs == {"step": "evict_to_host", "direction": "engage",
                              "level": 1, "pressure": 2.0}
    finally:
        tracing.reset()


@pytest.mark.parametrize("start", [0, 512], ids=["whole-bucket", "chunked"])
def test_apply_engine_clamps_equals_jax(start):
    orders = [{"spec_k_max": 1, "prefill_chunk_tokens_max": 256},
              {"spec_k_max": 2}, dict(tdeg.NO_DEGRADATION),
              {"prefill_chunk_tokens_max": 1024}, {}]
    got = {}
    for side in ("jax", "port"):
        cfg = types.SimpleNamespace(spec_k=4, prefill_chunk_tokens=start)
        originals = {}
        got[side] = [(SIDES[side].deg.apply_engine_clamps(
            cfg, o, originals), dict(vars(cfg)), dict(originals))
            for o in orders]
    assert got["port"] == got["jax"]
    # a live engine's config is frozen in both packages: a clamp order
    # raises there (the watcher logs it), the same in each
    for side, mod in (("jax", jcfg), ("port", tcfg)):
        with pytest.raises(dataclasses.FrozenInstanceError):
            SIDES[side].deg.apply_engine_clamps(
                mod.EngineConfig(), {"spec_k_max": 1}, {})


async def _order_then_tiers():
    """A port store and port frontend pieces (HttpService with admission,
    DegradationWatcher on the port's StoreClient); a JAX planner's
    connector writes the orders."""
    store = tstore.StoreServer(host="127.0.0.1", port=0)
    await store.start()
    addr = f"127.0.0.1:{store.port}"
    tclient = await tstore.StoreClient.connect(addr)
    jclient = await jstore.StoreClient.connect(addr)
    svc = make_service("port", max_concurrent_requests=4)
    await svc.start()
    watcher = tdeg.DegradationWatcher(tclient, "dynamo",
                                      svc.apply_degradation, poll_s=0.05)
    watcher.start()
    conn = jconnector.VirtualConnector(jclient, "dynamo")
    out = []

    async def tiers():
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            return [(await fetch(s, svc.port, "POST", "/v1/completions",
                                 {"model": "m1", "prompt": "x"},
                                 headers={"X-Request-Tier": t}))[0]
                    for t in ("0", "3")]
    try:
        out.append(await tiers())
        ladder = jdeg.DegradationLadder()
        ladder.update(2.0)
        ladder.update(2.0)                          # shed_low_tier engaged
        await conn.set_degradation(ladder.actions())
        t0 = time.monotonic()
        while svc.admission.min_tier != 1:
            assert time.monotonic() - t0 < 5
            await asyncio.sleep(0.02)
        out.append(await tiers())
        await conn.set_degradation(dict(jdeg.NO_DEGRADATION))
        while svc.admission.min_tier != 0:
            assert time.monotonic() - t0 < 10
            await asyncio.sleep(0.02)
        out.append(await tiers())
    finally:
        await watcher.stop()
        await svc.stop()
        await jclient.close()
        await tclient.close()
        await store.stop()
    return out


def test_jax_planner_order_sheds_tier_zero_at_the_port_frontend():
    assert asyncio.run(_order_then_tiers()) == [
        [200, 200], [429, 200], [200, 200]]


# ------------------------ a worker process -------------------------------


def test_worker_process_answers_health_and_drains(tmp_path,
                                                  tok_file):  # noqa: F811
    """``python -m dynamo_tpu_torch.worker --spec-mode ngram`` with the
    system server and health probes on: ``/health`` names the canary and
    answers 200 once it has run, ``/live`` answers, ``/metrics`` carries
    the engine gauges, and ``POST /drain`` ends the process with exit 0 and
    its keys leave the store within its lease's TTL."""
    sys_port = free_port()
    env = dict(os.environ, DYNTPU_LEASE_TTL_S="1.0", PYTHONPATH=str(ROOT),
               DYNTPU_SYSTEM_ENABLED="1", DYNTPU_SYSTEM_PORT=str(sys_port),
               DYNTPU_HEALTH_CHECK_ENABLED="1",
               DYNTPU_HEALTH_CHECK_PERIOD_S="0.2",
               DYNTPU_PLANNER_APPLY_DEGRADATION="1")
    addr = f"127.0.0.1:{free_port()}"
    store = Proc(tmp_path, "store", "dynamo_tpu_torch.runtime.store",
                 "--host", "127.0.0.1", "--port", addr.split(":")[1],
                 env=dict(os.environ, PYTHONPATH=str(ROOT)))
    worker = None
    try:
        store.wait_for(r"store listening")
        worker = Proc(tmp_path, "worker", "dynamo_tpu_torch.worker",
                      "--model", "tiny", "--device", "cpu", "--tokenizer",
                      str(tok_file), "--store-addr", addr, "--num-blocks",
                      "64", "--max-model-len", "128", "--spec-mode", "ngram",
                      "--spec-k", "4", env=env)
        worker.wait_for(r"registered model tiny")

        async def probe():
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                t0 = time.monotonic()
                while True:
                    status, body = await _get(s, sys_port, "GET", "/health")
                    probes = body.get("probes", {})
                    if probes.get("backend/generate", {}).get("probes"):
                        break
                    assert time.monotonic() - t0 < 15, body
                    await asyncio.sleep(0.1)
                live = await _get(s, sys_port, "GET", "/live")
                metrics = await _get(s, sys_port, "GET", "/metrics")
                drain = await _get(s, sys_port, "POST", "/drain")
                return (status, body), live, metrics, drain
        health, live, metrics, drain = asyncio.run(probe())
        assert health[0] == 200 and health[1]["status"] == "healthy"
        assert health[1]["probes"]["backend/generate"]["healthy"] is True
        assert live == (200, {"live": True})
        assert metrics[0] == 200
        assert "dynamo_engine_mfu " in metrics[1]
        assert drain[0] == 202 and drain[1]["draining"] == [
            "dynamo/backend/generate"]
        assert worker.proc.wait(timeout=20) == 0
        log = worker.log.read_text()
        assert "drain requested" in log

        async def keys_left():
            # the drained worker revokes its lease as it closes; under load
            # the revoke may time out, and the lease (TTL 1 s) expires
            client = await tstore.StoreClient.connect(addr)
            try:
                t0 = time.monotonic()
                while time.monotonic() - t0 < 5.0:
                    keys = [k for root in ("v1/instances/", "v1/models/")
                            for k, _ in await client.get_prefix(root)]
                    if not keys:
                        break
                    await asyncio.sleep(0.1)
                return keys
            finally:
                await client.close()
        assert asyncio.run(keys_left()) == []
    finally:
        if worker is not None:
            worker.stop(signal.SIGKILL)
        store.stop(signal.SIGKILL)
