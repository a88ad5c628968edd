"""The port's distributed runtime (``runtime/{component,transport}.py``,
``llm/migration.py``) against the JAX package's. An endpoint served through
either package's ``DistributedRuntime`` streams the same items to a
``Client`` of either package; ``stop_generating`` and ``kill`` reach the
worker and free the request; a dead instance gives
``EngineError(code="unavailable")``; a draining server rejects new work with
the draining code while it finishes what it holds; ``Migration`` carries
tokens over (same fake sink, same seeded backoff) exactly as the JAX
``Migration`` does; the same seeded ``FaultPlan`` injects the same faults
into either package's store and transport, with the same outcome."""

import asyncio
import random

import pytest

from dynamo_tpu.llm import migration as jmigration
from dynamo_tpu.runtime import component as jcomponent
from dynamo_tpu.runtime import context as jcontext
from dynamo_tpu.runtime import faults as jfaults
from dynamo_tpu.runtime import store as jstore
from dynamo_tpu.runtime import transport as jtransport
from dynamo_tpu.utils import config as jconfig
from dynamo_tpu_torch.llm import migration as tmigration
from dynamo_tpu_torch.runtime import component as tcomponent
from dynamo_tpu_torch.runtime import context as tcontext
from dynamo_tpu_torch.runtime import faults as tfaults
from dynamo_tpu_torch.runtime import store as tstore
from dynamo_tpu_torch.runtime import transport as ttransport
from dynamo_tpu_torch.utils import config as tconfig

SIDES = {
    "jax": (jcomponent, jcontext, jstore, jtransport, jconfig),
    "port": (tcomponent, tcontext, tstore, ttransport, tconfig),
}


async def runtime(side, addr):
    comp, _, _, _, cfg = SIDES[side]
    return await comp.DistributedRuntime.from_settings(
        cfg.RuntimeConfig(store_addr=addr, lease_ttl_s=1.0,
                          store_reconcile_grace_s=0.0))


async def echo(request, context):
    """Yields one item per prompt token, with every wire type in it."""
    for i, t in enumerate(request["token_ids"]):
        await asyncio.sleep(0)
        yield {"token_ids": [t * 3], "index": i, "text": f"t{t}",
               "finished": i == len(request["token_ids"]) - 1,
               "logprob": -0.5 * i, "extra": None, "raw": bytes([t % 256])}


async def serve_and_stream(server_side, client_side):
    _, _, store_mod, _, _ = SIDES[server_side]
    store = store_mod.StoreServer(host="127.0.0.1", port=0)
    await store.start()
    addr = f"127.0.0.1:{store.port}"
    srv = await runtime(server_side, addr)
    cli = await runtime(client_side, addr)
    try:
        ep = srv.namespace("rt").component("backend").endpoint("generate")
        await ep.serve_endpoint(echo, host="127.0.0.1")
        client = await (cli.namespace("rt").component("backend")
                        .endpoint("generate").client())
        await client.wait_for_instances(1, 10)
        ctx_mod = SIDES[client_side][1]
        out = []
        for req in ({"token_ids": [1, 2, 300, 70000]},
                    {"token_ids": list(range(40)), "nested": {"a": [1.5]}}):
            out.append([item async for item in
                        client.round_robin(req, ctx_mod.Context())])
        await client.stop()
        return out
    finally:
        await cli.shutdown()
        await srv.shutdown()
        await store.stop()


@pytest.mark.parametrize("server,client", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_streams_equal_across_packages(server, client):
    want = asyncio.run(serve_and_stream("jax", "jax"))
    got = asyncio.run(serve_and_stream(server, client))
    assert got == want
    assert [len(s) for s in want] == [4, 40]


async def cancel_case(how):
    side = SIDES["port"]
    comp, ctx_mod, store_mod, transport, _ = side
    store = store_mod.StoreServer(host="127.0.0.1", port=0)
    await store.start()
    addr = f"127.0.0.1:{store.port}"
    rt = await runtime("port", addr)
    seen = []

    async def forever(request, context):
        seen.append(context)
        i = 0
        while not context.is_stopped():
            await asyncio.sleep(0.01)
            yield {"i": i}
            i += 1
        yield {"i": -1, "stopped": True}

    try:
        ep = rt.namespace("rt").component("c").endpoint("e")
        served = await ep.serve_endpoint(forever, host="127.0.0.1")
        client = await ep.client()
        await client.wait_for_instances(1, 10)
        ctx = ctx_mod.Context()
        items = []
        async for item in client.round_robin({}, ctx):
            items.append(item)
            if len(items) == 3:
                ctx.kill() if how == "kill" else ctx.stop_generating()
        for _ in range(200):
            if not served.server.num_inflight:
                break
            await asyncio.sleep(0.01)
        await client.stop()
        return items, seen[0], served.server.num_inflight
    finally:
        await rt.shutdown()
        await store.stop()


def test_stop_generating_drains_the_worker_stream():
    items, worker_ctx, inflight = asyncio.run(cancel_case("stop"))
    assert worker_ctx.is_stopped() and not worker_ctx.is_killed()
    # the graceful stop keeps the stream until the worker ends it
    assert items[-1] == {"i": -1, "stopped": True}
    assert inflight == 0


def test_kill_abandons_the_stream_and_frees_the_worker():
    items, worker_ctx, inflight = asyncio.run(cancel_case("kill"))
    assert worker_ctx.is_killed()
    assert len(items) == 3 and inflight == 0


async def dead_and_draining(side):
    comp, ctx_mod, store_mod, transport, _ = SIDES[side]
    store = store_mod.StoreServer(host="127.0.0.1", port=0)
    await store.start()
    rt = await runtime(side, f"127.0.0.1:{store.port}")
    codes = {}
    release = asyncio.Event()

    async def slow(request, context):
        await release.wait()
        yield {"done": True}

    try:
        ep = rt.namespace("rt").component("c").endpoint("e")
        served = await ep.serve_endpoint(slow, host="127.0.0.1")
        client = await ep.client()
        await client.wait_for_instances(1, 10)
        held = asyncio.ensure_future(
            _collect(client.round_robin({}, ctx_mod.Context())))
        while not served.server.num_inflight:
            await asyncio.sleep(0.01)
        served.server.draining = True
        try:
            await _collect(client.round_robin({}, ctx_mod.Context()))
        except transport.EngineError as e:
            codes["draining"] = e.code
        drain = asyncio.ensure_future(served.server.drain(5.0))
        await asyncio.sleep(0.05)
        release.set()
        codes["held"] = await held
        codes["drained"] = await drain
        # the listener is gone but the instance is still registered
        await served.server.stop()
        try:
            await _collect(client.round_robin({}, ctx_mod.Context()))
        except transport.EngineError as e:
            codes["dead"] = e.code
        try:
            client.direct(12345, {}, ctx_mod.Context())
        except transport.EngineError as e:
            codes["unknown"] = e.code
        await client.stop()
        return codes
    finally:
        await rt.shutdown()
        await store.stop()


async def _collect(stream):
    return [item async for item in stream]


def test_dead_instance_and_drain_codes_match_jax():
    want = asyncio.run(dead_and_draining("jax"))
    got = asyncio.run(dead_and_draining("port"))
    assert got == want == {
        "draining": "draining", "held": [{"done": True}], "drained": True,
        "dead": "unavailable", "unknown": "unavailable"}


def flaky_sink(side, plan, log):
    """A sink that fails each attempt per ``plan``: (tokens to emit, error
    code or None for a clean finish)."""
    _, _, _, transport, _ = SIDES[side]
    attempts = iter(plan)

    class Sink:
        async def generate(self, request, context):
            log.append({k: request[k] for k in ("token_ids", "max_tokens")})
            emit, code = next(attempts)
            base = len(request["token_ids"])
            for i in range(emit):
                last = code is None and i == emit - 1
                yield {"token_ids": [1000 + base + i], "finished": last,
                       "num_prompt_tokens": base}
            if code is not None:
                raise transport.EngineError("boom", code)
    return Sink()


async def migrate(side, plan, limit):
    comp, ctx_mod, _, transport, _ = SIDES[side]
    mig_mod = jmigration if side == "jax" else tmigration
    log = []
    mig = mig_mod.Migration(flaky_sink(side, plan, log), limit,
                            backoff_base_s=0.001, rng=random.Random(7))
    out = []
    try:
        async for item in mig.generate(
                {"token_ids": [1, 2, 3], "max_tokens": 8},
                ctx_mod.Context()):
            out.append(item)
        err = None
    except transport.EngineError as e:
        err = e.code
    return out, log, err, mig.num_retries


@pytest.mark.parametrize("plan,limit", [
    ([(3, "unavailable"), (5, None)], 3),
    ([(2, "overloaded"), (0, "draining"), (6, None)], 3),
    ([(2, "unavailable"), (2, "unavailable")], 1),
    ([(4, "application")], 3),
    ([(8, "unavailable")], 3),
], ids=["carry", "retryable-codes", "exhausted", "fatal", "all-emitted"])
def test_migration_matches_jax(plan, limit):
    want = asyncio.run(migrate("jax", plan, limit))
    got = asyncio.run(migrate("port", plan, limit))
    assert got == want


async def faulted(side):
    """Eight requests, one after another, under one seeded plan: a rejection
    at admission, a worker crash mid-stream, seeded dropped sends, delayed
    store writes. Returns each request's items or error code, and the plan's
    firings (site, kind) in order."""
    comp, ctx_mod, store_mod, transport, _ = SIDES[side]
    faults = jfaults if side == "jax" else tfaults
    plan = faults.FaultPlan(seed=3)
    plan.reject("worker.admit", after=2, times=1, code="overloaded")
    plan.truncate_stream("worker.stream", after=5)
    plan.drop_connection("client.send", prob=0.3)
    plan.delay("store.call", 0.001, match="put", times=2)
    store = store_mod.StoreServer(host="127.0.0.1", port=0)
    await store.start()
    rt = await runtime(side, f"127.0.0.1:{store.port}")
    faults.install(plan)
    out = []
    try:
        ep = rt.namespace("rt").component("c").endpoint("e")
        await ep.serve_endpoint(echo, host="127.0.0.1")
        client = await ep.client()
        await client.wait_for_instances(1, 10)
        for n in range(3, 11):
            try:
                out.append(await _collect(client.round_robin(
                    {"token_ids": list(range(n))}, ctx_mod.Context())))
            except transport.EngineError as e:
                out.append(e.code)
        await client.stop()
    finally:
        faults.clear()
        await rt.shutdown()
        await store.stop()
    return out, [(e.site, e.kind) for e in plan.log]


def test_fault_plan_injects_the_same_faults_as_jax():
    want = asyncio.run(faulted("jax"))
    got = asyncio.run(faulted("port"))
    assert got == want
    assert set(want[1]) == {
        ("worker.admit", "reject"), ("worker.stream", "truncate"),
        ("client.send", "drop"), ("store.call", "delay")}
    assert "overloaded" in want[0] and "unavailable" in want[0]


def test_runtime_config_reads_the_jax_settings(monkeypatch, tmp_path):
    """Every setting the port reads comes from the same config-file key and
    environment variable, with the same default and coercion, as the JAX
    package's (``prefix_enabled`` included: on by default in both)."""
    import dataclasses

    fields = [f.name for f in dataclasses.fields(tconfig.RuntimeConfig)]
    jdefault, tdefault = jconfig.RuntimeConfig(), tconfig.RuntimeConfig()
    for name in fields:
        assert getattr(tdefault, name) == getattr(jdefault, name), name
    assert jdefault.prefix_enabled and tdefault.prefix_enabled
    values = {"namespace": "ns1", "store_addr": "10.0.0.1:1", "spec_mode":
              "ngram", "weight_dtype": "int8", "trace_export_path": "/t"}
    for name in fields:
        v = getattr(tdefault, name)
        env = "DYNTPU_" + name.upper()
        if isinstance(v, bool):
            monkeypatch.setenv(env, "yes" if not v else "off")
        elif isinstance(v, (int, float)) and name != "lease_ttl_s":
            monkeypatch.setenv(env, str(type(v)(v * 3 + 2)))
        elif isinstance(v, str):
            monkeypatch.setenv(env, values.get(name, "x"))
    cfg_file = tmp_path / "cfg.json"
    cfg_file.write_text('{"lease_ttl_s": 4.5, "namespace": "from-file"}')
    monkeypatch.setenv("DYNTPU_CONFIG", str(cfg_file))
    want = jconfig.RuntimeConfig.from_settings()
    got = tconfig.RuntimeConfig.from_settings()
    for name in fields:
        assert getattr(got, name) == getattr(want, name), name
    assert got.lease_ttl_s == 4.5 and got.namespace == "ns1"
