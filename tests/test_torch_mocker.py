"""The port's mocker (``dynamo_tpu_torch/mocker/``) held against the JAX
package's on the CPU:

* ``MockEngine`` streams and KV events equal JAX's, block hashes included
  (the port's XXH3-64 draws the tokens; tolerance: none);
* ``SimCluster`` role flips keep byte-exact parity (the ScriptedWorker
  convention, ``1000 + prompt_len + j``) while the flipped worker drains;
* a short closed-loop ``run_scenario`` (planner, orchestrator, degradation
  watcher, aggregator, a kill) ends with no dropped stream, no parity
  failure and every target within the chip budget;
* the real-engine harnesses run on port engines (on the CPU here): a
  preemption storm and a disaggregated storm keep token parity with their
  serial references and leak nothing.

Wall-clock latencies are not asserted (the JAX suite's SLO-recovery test
is timing-sensitive on a loaded CPU).
"""

import asyncio
import logging
import random

import pytest

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.engine import Request as JaxRequest
from dynamo_tpu.mocker import MockEngine as JaxMockEngine
from dynamo_tpu.mocker import MockerConfig as JaxMockerConfig
from dynamo_tpu_torch import tracing
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Request
from dynamo_tpu_torch.llm.migration import Migration
from dynamo_tpu_torch.mocker import MockEngine, MockerConfig
from dynamo_tpu_torch.mocker import __main__ as tmain
from dynamo_tpu_torch.mocker.cluster import (
    DisaggChaosScenario, PreemptionChaosScenario, SimCluster, SimScenario,
    SimTiming, run_disagg_scenario, run_preemption_scenario, run_scenario,
)
from dynamo_tpu_torch.router.kv_router import KvPushRouter, KvRouter
from dynamo_tpu_torch.router.scheduler import KvRouterConfig
from dynamo_tpu_torch.runtime.component import DistributedRuntime
from dynamo_tpu_torch.runtime.context import Context
from dynamo_tpu_torch.runtime.store import StoreServer
from dynamo_tpu_torch.utils.config import RuntimeConfig

ENG_KW = dict(block_size=4, num_blocks=64, max_num_seqs=4,
              max_num_batched_tokens=32, max_model_len=96)
PROMPTS = [list(range(2, 13)), list(range(2, 13)) + [40, 41, 42, 43, 44],
           [7] * 9, list(range(100, 121))]
MAX_TOKENS = [6, 9, 3, 12]


@pytest.fixture
def quiet_logs():
    """Spawns at INFO dilate the event loop the sim's windows run on."""
    loggers = [logging.getLogger(n) for n in ("dynamo_tpu_torch",
                                              "dynamo_tpu")]
    prev = [lg.level for lg in loggers]
    for lg in loggers:
        lg.setLevel(logging.WARNING)
    yield
    for lg, lvl in zip(loggers, prev):
        lg.setLevel(lvl)


@pytest.mark.parametrize("concurrent", [False, True])
def test_mock_engine_streams_and_kv_events_equal_jax(concurrent):
    async def serve(engine, request_cls):
        events = []
        engine.kv_event_sink = events.append

        async def one(i):
            req = request_cls(request_id=f"m{i}", token_ids=PROMPTS[i],
                              max_tokens=MAX_TOKENS[i])
            return [o.token_id async for o in engine.submit(req)]
        try:
            if concurrent:
                toks = await asyncio.gather(*(one(i)
                                              for i in range(len(PROMPTS))))
            else:
                toks = [await one(i) for i in range(len(PROMPTS))]
        finally:
            await engine.stop()
        return toks, events

    want = asyncio.run(serve(JaxMockEngine(
        JaxEngineConfig(**ENG_KW),
        JaxMockerConfig(vocab_size=300, speedup_ratio=1e4)), JaxRequest))
    got = asyncio.run(serve(MockEngine(
        EngineConfig(**ENG_KW),
        MockerConfig(vocab_size=300, speedup_ratio=1e4)), Request))
    assert got[0] == want[0]
    assert [len(t) for t in got[0]] == MAX_TOKENS
    if not concurrent:      # batch composition is timing-free only serially
        assert got[1] == want[1]
    assert any(e["kind"] == "stored" for e in got[1])


@pytest.mark.parametrize("seq_id,position", [
    ("a", 0), ("req-17", 511), ("x" * 40, 1 << 20), ("", 3)])
def test_mock_sample_equals_jax(seq_id, position):
    for vocab in (5, 300, 128256):
        j = JaxMockEngine(JaxEngineConfig(**ENG_KW),
                          JaxMockerConfig(vocab_size=vocab))
        t = MockEngine(EngineConfig(**ENG_KW), MockerConfig(vocab_size=vocab))
        assert t._sample(seq_id, position) == j._sample(seq_id, position)


def test_mocker_cli_parses_as_jax():
    from dynamo_tpu.mocker import __main__ as jmain
    argv = ["--model-name", "m", "--speedup-ratio", "3", "--num-blocks",
            "128", "--max-num-seqs", "8"]
    assert vars(tmain.parse_args(argv)) == vars(jmain.parse_args(argv))


def _runtime_cfg(port):
    return RuntimeConfig(
        store_addr=f"127.0.0.1:{port}",
        store_reconnect_base_s=0.05, store_reconnect_cap_s=0.2,
        store_recover_timeout_s=15.0, store_reconcile_grace_s=0.5,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_role_flip_parity(tmp_path, seed, quiet_logs):
    """A decode stream migrated off a worker flipping to prefill finishes
    byte-identical to an undisturbed run."""
    async def scenario():
        tracing.reset()
        store = StoreServer("127.0.0.1", 0,
                            persist_path=str(tmp_path / "store.snap"))
        await store.start()
        cfg = _runtime_cfg(store.port)
        timing = SimTiming(prefill_time_per_token_s=1e-3,
                           decode_time_per_step_s=0.4, speedup_ratio=20.0)
        cluster = SimCluster(cfg, timing=timing, drain_deadline_s=0.1)
        await cluster.start(n_prefill=1, n_decode=2)
        front = await DistributedRuntime.from_settings(cfg)
        client = await (front.namespace("sim").component("backend")
                        .endpoint("generate").client())
        await client.wait_for_instances(2, timeout_s=10.0)
        router = KvRouter(
            client, client.endpoint.component, block_size=16,
            use_events=False, seed=0,
            config=KvRouterConfig(replica_sync=False, snapshot_threshold=0))
        mig = Migration(KvPushRouter(router), migration_limit=4,
                        backoff_base_s=0.01, rng=random.Random(seed))
        prompt, n_tokens = [7, 8, 9], 30

        async def run_once(tag):
            out = []
            req = {"token_ids": prompt, "max_tokens": n_tokens}
            async for item in mig.generate(req, Context(request_id=tag)):
                out.append(item)
            return out

        try:
            control = await run_once(f"flip-control-{seed}")
            task = asyncio.create_task(run_once(f"flip-disturbed-{seed}"))
            await asyncio.sleep(0.15)
            victim = next(w.wid for w in cluster._workers.values()
                          if w.component == "backend"
                          and w.engine.active > 0)
            await cluster.flip(victim, "prefill")
            disturbed = await asyncio.wait_for(task, timeout=20.0)
            return (control, disturbed, victim,
                    cluster.workers("prefill"), cluster.prefill_pool.capacity)
        finally:
            await router.stop()
            await client.stop()
            await front.shutdown()
            await cluster.shutdown()
            await store.stop()

    control, disturbed, victim, prefill, capacity = asyncio.run(scenario())

    def flat(out):
        return [t for o in out for t in o["token_ids"]]

    assert flat(control) == [1000 + 3 + j for j in range(30)]
    assert flat(disturbed) == flat(control)
    assert disturbed[-1]["finished"]
    assert all(o["num_prompt_tokens"] == 3 for o in disturbed)
    assert victim in prefill and capacity == 2


def test_short_scenario_loses_no_token_and_holds_the_budget(tmp_path,
                                                            quiet_logs):
    sc = SimScenario(seed=3, n_prefill=2, n_decode=4, base_rps=15.0,
                     burst_factor=3.0, warmup_s=0.5, burst_s=1.0,
                     cooldown_s=0.5, window_s=0.5, max_chip_budget=10,
                     min_endpoint=2)
    tracing.reset()
    rep = asyncio.run(run_scenario(sc, str(tmp_path)))
    assert rep["num_requests"] > 0
    assert rep["dropped"] == []
    assert rep["parity_failures"] == []
    assert rep["num_kills"] >= 1
    for w in rep["windows"]:
        p, d = w["targets"]
        assert p + d <= sc.max_chip_budget
        assert w["live_prefill"] + w["live_decode"] <= sc.max_chip_budget
    assert "planner_transitions_total" in rep["metrics_text"]


@pytest.fixture
def cpu_engines(monkeypatch):
    """The harnesses build engines on the default device (the card); on
    the CPU they get ``device="cpu"``."""
    real = teng.InferenceEngine

    def cpu_engine(model_cfg, eng_cfg, **kw):
        kw.setdefault("device", "cpu")
        return real(model_cfg, eng_cfg, **kw)

    monkeypatch.setattr(teng, "InferenceEngine", cpu_engine)


def _assert_clean(report):
    assert report["completed"] == report["num_requests"], report
    assert report["parity_failures"] == 0, report
    assert not report["canary_corrupted"], report
    assert report["leaked_blocks"] == 0, report
    assert report["leaked_pending"] == 0, report
    assert report["leaked_reservations"] == 0, report


def test_preemption_storm_on_port_engines(cpu_engines):
    report = asyncio.run(run_preemption_scenario(PreemptionChaosScenario(
        name="notice_then_kill", mode="notice-then-kill", seed=0)))
    _assert_clean(report)
    assert report["notices"] == 1 and not report["notice_lost"], report
    assert report["evacuated_peer"] >= 1, report


def test_disagg_storm_on_port_engines(cpu_engines):
    def plan(p):
        p.drop_connection("disagg.transfer", times=2)

    report = asyncio.run(run_disagg_scenario(DisaggChaosScenario(
        name="device_transfer_flaky", seed=0, num_requests=4,
        plan_fn=plan)))
    _assert_clean(report)
    assert report["faults_fired"] >= 2, report
    assert report["transfer_retries"] >= 2, report
    assert report["remote_prefills"] >= 1, report
