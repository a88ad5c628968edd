"""``/debug/profile`` on ``torch.profiler`` and the graph-capture watch,
against the JAX package's.

On the CPU the port's system server answers ``GET /debug/profile`` with 200
and a Chrome trace of the CPU's profiler, 409 to a request that arrives
during a capture, 400 to a bad ``ms`` (the JAX server's statuses for the
same requests); ``ms`` is clamped as JAX clamps it. The compile watch's
snapshot has the JAX watch's keys, its steady-state and label semantics are
the JAX watch's, and an engine's snapshot and gauges carry them.
"""

import asyncio
import json
import os

import aiohttp
import jax
import numpy as np
import pytest

from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.observability import compilewatch as jcw
from dynamo_tpu.observability import profiling as jprof
from dynamo_tpu.runtime import system_server as jsys
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine.engine import InferenceEngine, Request
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.observability import compilewatch as tcw
from dynamo_tpu_torch.observability import gauges as tgauges
from dynamo_tpu_torch.observability import profiling as tprof
from dynamo_tpu_torch.runtime import system_server as tsys
from dynamo_tpu_torch.utils import metrics as tmetrics

SERVERS = {"jax": jsys.SystemServer, "port": tsys.SystemServer}
TIMEOUT = aiohttp.ClientTimeout(total=60)


async def _get(s, port, path, **params):
    async with s.get(f"http://127.0.0.1:{port}{path}", params=params) as r:
        return r.status, await r.json()


def _serve(side, script):
    async def run():
        server = SERVERS[side](host="127.0.0.1", port=0)
        await server.start()
        try:
            async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
                return await script(s, server.port)
        finally:
            await server.stop()
    return asyncio.run(run())


def test_profile_route_answers_200_with_a_cpu_trace(tmp_path):
    async def script(s, port):
        ok = await _get(s, port, "/debug/profile", ms="50",
                        dir=str(tmp_path / "p"))
        bad = await _get(s, port, "/debug/profile", ms="oops")
        return ok, bad

    (status, body), bad = _serve("port", script)
    (jstatus, jbody), jbad = _serve("jax", lambda s, p: script(s, p))
    assert (status, bad[0]) == (jstatus, jbad[0]) == (200, 400)
    assert bad[1] == jbad[1]
    for key in ("trace_dir", "requested_ms", "captured_ms"):
        assert key in body and key in jbody
    assert body["trace_dir"].startswith(str(tmp_path / "p"))
    assert body["requested_ms"] == 50 and body["captured_ms"] >= 50
    assert body["activities"] == ["CPU"]    # no card in this process
    assert os.path.dirname(body["trace_file"]) == body["trace_dir"]
    with open(body["trace_file"]) as f:
        trace = json.load(f)
    assert "traceEvents" in trace


def test_profile_route_answers_409_during_a_capture(tmp_path):
    async def script(s, port):
        first = asyncio.ensure_future(
            _get(s, port, "/debug/profile", ms="600", dir=str(tmp_path)))
        await asyncio.sleep(0.2)
        second = await _get(s, port, "/debug/profile", ms="50",
                            dir=str(tmp_path))
        return await first, second

    (s1, b1), (s2, b2) = _serve("port", script)
    assert (s1, s2) == (200, 409)
    assert "already running" in b2["error"]
    # the JAX server's answer to a request during a capture
    assert jprof._capture_lock.acquire(blocking=False)
    try:
        jstatus = _serve("jax", lambda s, p: _get(s, p, "/debug/profile",
                                                  ms="10"))[0]
    finally:
        jprof._capture_lock.release()
    assert jstatus == s2
    # and the lock is free again: the next capture runs
    assert _serve("port", lambda s, p: _get(
        s, p, "/debug/profile", ms="10", dir=str(tmp_path)))[0] == 200


def test_ms_is_clamped_as_jax_clamps_it(tmp_path, monkeypatch):
    slept = []

    async def no_wait(seconds):
        slept.append(seconds)
    monkeypatch.setattr(asyncio, "sleep", no_wait)

    async def both(ms):
        got = await tprof.capture(ms, base_dir=str(tmp_path / "t"))
        want = await jprof.capture(ms, base_dir=str(tmp_path / "j"))
        return got["requested_ms"], want["requested_ms"]

    for ms in (-5, 0, 1, 50, tprof.MAX_MS, tprof.MAX_MS + 1, 10 ** 9):
        got, want = asyncio.run(both(ms))
        assert got == want == max(1, min(ms, jprof.MAX_MS))
    assert tprof.MAX_MS == jprof.MAX_MS and \
        tprof.DEFAULT_MS == jprof.DEFAULT_MS
    assert max(slept) == tprof.MAX_MS / 1000.0


@pytest.fixture
def watch():
    w = tcw.get_watch()
    w.reset()
    yield w
    w.reset()


def test_compilewatch_snapshot_has_the_jax_keys(watch):
    jcw.install()
    assert set(tcw.snapshot()) == set(jcw.snapshot())
    snap = tcw.snapshot()
    assert snap["involuntary_remats_total"] == 0 and snap["steady"] is False


def test_compilewatch_steady_state_and_labels(watch):
    tcw.note("decode_window:B=16:stochastic=0", 0.25)
    fn = tcw.label(lambda x: tcw.note() or x + 1, "window")
    assert fn(1) == 2 and fn.__compile_label__ == "window"
    tcw.note()
    snap = watch.snapshot()
    assert snap["compiles_by_fn"] == {
        "decode_window:B=16:stochastic=0": 1, "window": 1,
        tcw.UNATTRIBUTED: 1}
    assert snap["compile_secs_by_fn"]["decode_window:B=16:stochastic=0"] \
        == 0.25
    assert snap["recompiles_steady_state"] == 0
    with tcw.assert_no_recompiles():
        pass
    assert watch.snapshot()["steady"] is True
    with pytest.raises(AssertionError, match="decode_window:B=8"):
        with tcw.assert_no_recompiles():
            tcw.note("decode_window:B=8:stochastic=0")
    assert watch.steady_by_label() == {"decode_window:B=8:stochastic=0": 1}
    assert watch.steady_total() == 1


def test_engine_snapshot_and_gauges_carry_the_watch(watch, monkeypatch):
    """A port engine with ladders on: its snapshot has the watch's keys and
    the ladder keys of the JAX engine's, and the ``engine_*`` ladder and
    recompile families get series."""
    monkeypatch.setenv("DYNTPU_LADDER_MIN_DISPATCHES", "6")
    monkeypatch.setenv("DYNTPU_LADDER_HYSTERESIS", "1")
    tree = jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jcfg.ModelConfig.tiny(512)))
    mc = tcfg.ModelConfig.tiny(512)
    engine = InferenceEngine(
        mc, tcfg.EngineConfig(block_size=4, num_blocks=64, max_num_seqs=4,
                              max_num_batched_tokens=64, max_model_len=128,
                              decode_buckets=(16,), prefill_buckets=(16, 32),
                              adaptive_buckets=True),
        params=params_from_numpy(tree, mc, "cpu"), device="cpu")
    registry = tmetrics.MetricsRegistry(prefix="dynamo")
    gauges = tgauges.EngineObsGauges(registry, engine)

    async def go():
        await engine.start()
        try:
            for i in range(12):
                async for _ in engine.submit(Request(
                        request_id=f"g{i}", token_ids=[i + 1, 2, 3],
                        max_tokens=4, ignore_eos=True)):
                    pass
                if i == 0:
                    engine.mark_obs_warmup_done()
        finally:
            await engine.stop()
    asyncio.run(go())
    snap = engine.obs_snapshot()
    jcw.install()
    assert set(jcw.snapshot()) <= set(snap)
    for kind in ("decode", "prefill"):
        for key in ("rungs", "rungs_n", "splits_total", "retires_total",
                    "budget_remaining", "converged"):
            assert f"ladder_{kind}_{key}" in snap
    assert snap["ladder_decode_rungs"] == (8, 16)
    gauges.refresh()
    text = registry.render().decode()
    assert 'dynamo_engine_ladder_rungs{kind="decode"} 2.0' in text
    assert 'dynamo_engine_ladder_splits_total{kind="decode"} 1.0' in text
    assert ('dynamo_engine_recompiles_total{fn="decode_window:B=8:'
            'stochastic=0"} 1.0') in text


def test_launch_gate_keeps_toggles_and_launches_apart():
    """A toggle waits for the launch in flight and holds new launches back
    until it is done; launches on several threads run together."""
    import threading

    gate = tprof.LaunchGate()
    order = []
    in_launch, release = threading.Event(), threading.Event()

    def launcher(name, hold=None):
        with gate.launching():
            order.append(f"{name} in")
            if hold is not None:
                in_launch.set()
                hold.wait(5)
            order.append(f"{name} out")

    def toggler():
        with gate.toggling():
            order.append("toggle")
            late = threading.Thread(target=launcher, args=("late",))
            late.start()
            late.join(0.2)
            assert late.is_alive()          # held back by the toggle
            order.append("toggle done")
        late.join(5)

    a = threading.Thread(target=launcher, args=("a", release))
    a.start()
    assert in_launch.wait(5)
    with gate.launching():                  # a second launcher runs at once
        order.append("b")
    t = threading.Thread(target=toggler)
    t.start()
    t.join(0.2)
    assert t.is_alive() and "toggle" not in order   # waits for a
    release.set()
    a.join(5)
    t.join(5)
    assert order == ["a in", "b", "a out", "toggle", "toggle done",
                     "late in", "late out"]


def test_engine_step_thread_and_capture_share_the_gate(tmp_path):
    """Every task of an engine's step thread holds the launch gate, and a
    capture under load takes it to start and stop: the streams served
    during a capture are whole."""
    tree = jax.tree.map(np.asarray, jm.init_params(
        jax.random.PRNGKey(0), jcfg.ModelConfig.tiny(512)))
    mc = tcfg.ModelConfig.tiny(512)
    engine = InferenceEngine(
        mc, tcfg.EngineConfig(block_size=4, num_blocks=64, max_num_seqs=4,
                              max_num_batched_tokens=64, max_model_len=128,
                              decode_buckets=(4,), prefill_buckets=(16,)),
        params=params_from_numpy(tree, mc, "cpu"), device="cpu")
    held = engine._step_executor().submit(
        lambda: tprof.LAUNCH_GATE._launching).result()
    assert held == 1 and tprof.LAUNCH_GATE._launching == 0

    async def one(i):
        out = []
        async for o in engine.submit(Request(
                request_id=f"p{i}", token_ids=[i + 1, 2, 3], max_tokens=24,
                ignore_eos=True)):
            out.append(o.token_id)
        return out

    async def go():
        await engine.start()
        try:
            capture = asyncio.ensure_future(
                tprof.capture(20, base_dir=str(tmp_path)))
            outs = await asyncio.gather(*(one(i) for i in range(4)))
            return await capture, outs
        finally:
            await engine.stop()
    meta, outs = asyncio.run(go())
    assert os.path.getsize(meta["trace_file"]) > 0
    assert [len(o) for o in outs] == [24] * 4
    assert not tprof.LAUNCH_GATE._toggling
