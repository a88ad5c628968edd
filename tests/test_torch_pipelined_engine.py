"""The port's run-ahead (pipelined) engine, mirroring
``tests/test_pipelined_engine.py``: at every pipeline depth and window
length the port's greedy streams equal the JAX engine's at its defaults
(same parameters, carried across by ``params_from_numpy``); EOS
mid-window reaps cleanly once in-flight windows land; seeded sampling is
the same pipelined and synchronous; a starved token budget rebuilds the
seat map without corrupting streams; many requests churn slots; the
fetcher waits once per landed window. CPU, ``ModelConfig.tiny()``,
float32."""

import asyncio
import threading

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.engine.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine.engine import Request as JaxRequest
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import (
    InferenceEngine, Request, _BatchingFetcher, _Landing,
)
from dynamo_tpu_torch.engine.weights import params_from_numpy

BASE = dict(num_blocks=128, max_model_len=256, max_num_batched_tokens=64,
            prefill_buckets=(64,), decode_buckets=(8,), max_num_seqs=8)


def _cfg(decode_steps=1, pipeline_depth=2, **kw):
    base = dict(BASE)
    base.update(kw)
    return EngineConfig(decode_steps=decode_steps,
                        pipeline_depth=pipeline_depth, **base)


def _mk_req(i, n_prompt=10, max_tokens=12, request_cls=Request, **kw):
    rng = np.random.default_rng(100 + i)
    return request_cls(
        request_id=f"r{i}",
        token_ids=[int(t) for t in rng.integers(1, 250, size=n_prompt)],
        max_tokens=max_tokens, ignore_eos=kw.pop("ignore_eos", True), **kw,
    )


async def _collect(engine, req):
    return [out.token_id async for out in engine.submit(req)]


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX engine at its defaults (pipeline_depth 2, decode_steps 1):
    its parameters as numpy and its greedy streams for four concurrent
    requests."""
    assert JaxEngineConfig(**BASE).pipeline_depth == 2
    engine = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**BASE),
                       seed=0)
    tree = jax.tree.map(np.asarray, engine.params)

    async def run():
        try:
            return await asyncio.gather(*(
                _collect(engine, _mk_req(i, request_cls=JaxRequest))
                for i in range(4)))
        finally:
            await engine.stop()

    return tree, [list(s) for s in asyncio.run(run())]


def _port_engine(tree, cfg):
    return InferenceEngine(
        ModelConfig.tiny(), cfg,
        params=params_from_numpy(tree, ModelConfig.tiny(), "cpu"),
        device="cpu")


def test_default_pipeline_depth_is_the_jax_engines():
    assert EngineConfig().pipeline_depth == JaxEngineConfig().pipeline_depth
    assert EngineConfig().pipeline_depth == 2
    with pytest.raises(ValueError):
        EngineConfig(stall_dead_threshold=0)
    with pytest.raises(ValueError):
        EngineConfig(pressure_shed_threshold=1.5)


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("pipeline_depth", [1, 2, 3])
def test_greedy_streams_match_jax_engine(jax_reference, pipeline_depth,
                                         decode_steps):
    """Identical tokens to the JAX engine at its defaults, whatever the
    port's depth and window length."""
    tree, want = jax_reference
    engine = _port_engine(tree, _cfg(decode_steps, pipeline_depth))
    assert engine.pipeline_depth == pipeline_depth

    async def run():
        try:
            return await asyncio.gather(*(
                _collect(engine, _mk_req(i)) for i in range(4)))
        finally:
            await engine.stop()

    got = asyncio.run(run())
    assert [list(g) for g in got] == want
    # the fetcher waited once per landed window
    assert engine.num_fetch_syncs == engine.num_steps > 0


def test_eos_mid_window_reaps():
    """A seq that stops mid-window (EOS honoured) discards the window tail;
    its slot and blocks come back once in-flight windows land."""
    eng = InferenceEngine(ModelConfig.tiny(), _cfg(4, 3), seed=0,
                          device="cpu")

    async def run():
        probe = await _collect(eng, _mk_req(0, max_tokens=16))
        eos = probe[5]  # force EOS at output index 5 (mid 4-token window)
        req = _mk_req(0, max_tokens=16, ignore_eos=False)
        req.eos_token_ids = (eos,)
        toks = await _collect(eng, req)
        for _ in range(100):
            s = eng.scheduler
            if (not s.zombies and not s.running
                    and len(s._free_slots) == eng.config.max_num_seqs):
                break
            await asyncio.sleep(0.05)
        free_before = eng.scheduler.pool.num_free
        zombies = list(eng.scheduler.zombies)
        free_slots = len(eng.scheduler._free_slots)
        await eng.stop()
        return probe, eos, toks, free_before, zombies, free_slots

    probe, eos, toks, free_before, zombies, free_slots = asyncio.run(run())
    assert toks == probe[:probe.index(eos) + 1]  # stopped AT the eos token
    assert not zombies
    assert free_slots == eng.config.max_num_seqs
    assert free_before == eng.scheduler.pool.num_free


def test_seeded_sampling_pipelined_equals_sync():
    """Per-request seeded stochastic decode: the run-ahead engine (depth 3,
    4-token windows) draws the same tokens as the synchronous one (depth 1,
    1-token windows); another seed draws others. (The draws differ from
    the JAX engine's threefry streams by design.)"""
    def run(cfg):
        eng = InferenceEngine(ModelConfig.tiny(), cfg, seed=0, device="cpu")

        async def go():
            try:
                return [await _collect(eng, _mk_req(1, temperature=0.9,
                                                    seed=s))
                        for s in (42, 42, 43)]
            finally:
                await eng.stop()
        return asyncio.run(go())

    a, b, c = run(_cfg(4, 3))
    sa, sb, sc = run(_cfg(1, 1))
    assert a == b == sa == sb
    assert c == sc
    assert a != c


def test_starved_budget_seatmap_rebuild():
    """Token-budget and block-pool starvation force LIVE seqs to be skipped
    in some decode rounds. A skipped-but-live seat must NOT keep its column
    in a reused device seat map. Greedy outputs must match the unstarved
    synchronous engine exactly."""
    reqs = [dict(n_prompt=6 + i % 3, max_tokens=8 + i % 5)
            for i in range(6)]

    async def reference():
        eng = InferenceEngine(ModelConfig.tiny(), _cfg(1, 1), seed=0,
                              device="cpu")
        try:
            return [await _collect(eng, _mk_req(i, **kw))
                    for i, kw in enumerate(reqs)]
        finally:
            await eng.stop()

    # 3 batched tokens/round vs 6 decoding seqs, 8 blocks vs ~12 needed
    eng = InferenceEngine(
        ModelConfig.tiny(),
        _cfg(4, 3, max_num_batched_tokens=3, num_blocks=8,
             prefill_buckets=(8,), max_model_len=64),
        seed=0, device="cpu")

    async def starved():
        async def one(i, kw):
            await asyncio.sleep(0.005 * i)
            return await _collect(eng, _mk_req(i, **kw))
        try:
            return await asyncio.gather(*(one(i, kw)
                                          for i, kw in enumerate(reqs)))
        finally:
            await eng.stop()

    ref = asyncio.run(reference())
    got = asyncio.run(starved())
    assert [list(g) for g in got] == ref


def test_many_requests_slot_churn():
    """More requests than slots, staggered arrivals: every request
    completes with the right token count and the pool drains clean."""
    eng = InferenceEngine(ModelConfig.tiny(), _cfg(2, 4), seed=0,
                          device="cpu")

    async def run():
        async def one(i):
            await asyncio.sleep(0.01 * (i % 5))
            return await _collect(
                eng, _mk_req(i, n_prompt=6 + i % 7, max_tokens=5 + i % 9))
        outs = await asyncio.gather(*(one(i) for i in range(24)))
        for _ in range(100):
            if (not eng.scheduler.zombies
                    and len(eng.scheduler._free_slots)
                    == eng.config.max_num_seqs):
                break
            await asyncio.sleep(0.05)
        free_slots = len(eng.scheduler._free_slots)
        await eng.stop()
        return outs, free_slots

    outs, free_slots = asyncio.run(run())
    for i, toks in enumerate(outs):
        assert len(toks) == 5 + i % 9, (i, len(toks))
    assert free_slots == eng.config.max_num_seqs
    assert eng.num_fetch_syncs == eng.num_steps


class _Event:
    """Stands in for a CUDA event: records the thread that waits on it."""

    def __init__(self):
        self.waited_on = None

    def synchronize(self):
        self.waited_on = threading.current_thread().name


def test_fetcher_waits_once_per_window_off_the_loop():
    """A landing with an event is waited on by the fetch thread, once per
    window, and resolves its future on the event loop in order; a landing
    without one (the CPU's) lands at submit. After stop, a new thread
    serves later submits."""
    syncs = []
    fetcher = _BatchingFetcher(
        lambda batch, landing: (batch, landing.host.tolist()),
        on_sync=lambda: syncs.append(1))

    def landing(i, event):
        return _Landing(n_prefill=1, decode_shape=None, cols=None,
                        host=torch.tensor([i], dtype=torch.int32),
                        event=event)

    async def run():
        loop = asyncio.get_running_loop()
        events = [_Event() for _ in range(5)]
        futs = [fetcher.submit(loop, i, landing(i, e))
                for i, e in enumerate(events)]
        immediate = fetcher.submit(loop, "cpu", landing(9, None))
        assert immediate.done()
        got = await asyncio.gather(*futs)
        fetcher.stop()
        again = await fetcher.submit(loop, 7, landing(7, _Event()))
        fetcher.stop()
        return events, got, immediate.result(), again

    events, got, immediate, again = asyncio.run(run())
    assert got == [(i, [i]) for i in range(5)]
    assert immediate == ("cpu", [9]) and again == (7, [7])
    assert all(e.waited_on == "device-fetch" for e in events)
    assert len(syncs) == 7
