"""The port's engine-side radix prefix cache (``prefix/manager.py``) held
against the JAX package: for the same traffic — shared prefixes, a repeat,
``evict_to_host`` demotions and their re-onboarding, ``clear_kv_blocks`` —
the port's ``PrefixCacheManager.snapshot()`` and its index (every node with
its parent, depth, tier holders and logical clock) equal JAX's, and so do
the greedy streams; a prompt whose prefix lives only in a peer engine's G1
is pulled over the device plane; the worker attaches the cache by default,
as the JAX worker does. CPU, ``ModelConfig.tiny``, numpy seeds."""

import asyncio
import random

import jax
import numpy as np
import pytest

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.engine import InferenceEngine as JEngine
from dynamo_tpu.engine.engine import Request as JRequest
from dynamo_tpu.kvbm.manager import KvbmConfig as JKvbmConfig
from dynamo_tpu.tokens import compute_block_hashes_for_seq
from dynamo_tpu_torch.disagg.ici import DevicePlane
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine, Request
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kvbm.manager import KvbmConfig
from dynamo_tpu_torch.prefix.radix import TIER_G1, TIER_G2

BS = 4
MC_KW = dict(vocab_size=256)
ENG_KW = dict(num_blocks=48, block_size=BS, max_model_len=128,
              max_num_batched_tokens=128, prefill_buckets=(128,),
              decode_buckets=(4,), max_num_seqs=4)


@pytest.fixture(scope="module")
def tree():
    engine = JEngine(JModelConfig.tiny(**MC_KW), JEngineConfig(**ENG_KW),
                     seed=0)
    return jax.tree.map(np.asarray, engine.params)


def make_engine(pkg, tree, **kw):
    if pkg == "jax":
        return JEngine(JModelConfig.tiny(**MC_KW),
                       JEngineConfig(**dict(ENG_KW, **kw)), seed=0)
    mc = ModelConfig.tiny(**MC_KW)
    return InferenceEngine(mc, EngineConfig(**dict(ENG_KW, **kw)),
                           params=params_from_numpy(tree, mc, "cpu"),
                           device="cpu")


async def run_req(engine, prompt, rid, n=4):
    cls = JRequest if isinstance(engine, JEngine) else Request
    return [o.token_id async for o in engine.submit(cls(
        request_id=rid, token_ids=list(prompt), max_tokens=n,
        ignore_eos=True))]


def shared_prompts(seed, n=3, shared=16, tail=6):
    rng = random.Random(seed)
    base = [rng.randrange(1, 200) for _ in range(shared)]
    return [base + [rng.randrange(1, 200) for _ in range(tail)]
            for _ in range(n)]


def index_dump(index):
    """Every node of the index with all of its state, in key order."""
    return {h: (n.block_hash, n.parent, n.depth, sorted(n.children),
                {t: sorted(ws) for t, ws in n.holders.items()}, n.last_use)
            for h, n in sorted(index._nodes.items())}


async def settle(engine):
    for _ in range(400):
        kvbm = engine.kvbm
        if (not engine.scheduler.running
                and (kvbm is None or not kvbm._pending)):
            return
        await asyncio.sleep(0.01)
    raise AssertionError("engine never went idle")


async def prefix_scenario(pkg, tree, with_kvbm: bool):
    engine = make_engine(pkg, tree)
    if with_kvbm:
        engine.attach_kvbm((JKvbmConfig if pkg == "jax" else KvbmConfig)(
            host_blocks=64))
    engine.attach_prefix_cache(worker_id=7)
    prompts = shared_prompts(11) + shared_prompts(12, n=2, shared=24)
    streams, snaps, dumps, demoted = [], [], [], []
    try:
        for i, p in enumerate(prompts + prompts[:2]):
            streams.append(await run_req(engine, p, f"r{i}"))
            await settle(engine)
            if with_kvbm and i in (2, 5):
                demoted.append(await engine.prefix.evict_to_host(6))
            snaps.append(engine.prefix.snapshot())
            dumps.append(index_dump(engine.prefix.index))
        engine.clear_kv_blocks()
        snaps.append(engine.prefix.snapshot())
        dumps.append(index_dump(engine.prefix.index))
        streams.append(await run_req(engine, prompts[0], "last"))
        await settle(engine)
        snaps.append(engine.prefix.snapshot())
        dumps.append(index_dump(engine.prefix.index))
        kv = engine.kvbm.snapshot() if with_kvbm else None
        return streams, snaps, dumps, demoted, kv
    finally:
        await engine.stop()


@pytest.mark.parametrize("with_kvbm", [False, True],
                         ids=["index_only", "with_host_tier"])
def test_prefix_manager_equals_jax(tree, with_kvbm):
    want = asyncio.run(prefix_scenario("jax", tree, with_kvbm))
    got = asyncio.run(prefix_scenario("port", tree, with_kvbm))
    names = ("streams", "snapshots", "index", "demoted", "kvbm")
    for name, g, w in zip(names, got, want):
        assert g == w, name
    snaps = got[1]
    assert snaps[-1]["prefix_hit_tokens_total"] > 0
    if with_kvbm:
        assert sum(got[3]) > 0
        assert snaps[-1]["prefix_demoted_total"] == sum(got[3])
        assert got[4]["onboarded_total"] > 0


def test_peer_g1_onboard_over_the_device_plane(tree):
    """B pulls a prefix only A's G1 holds through ``DevicePlane`` (gather
    on A's stream, in-place scatter into B's adopted blocks) and streams
    A's tokens, which are the JAX engine's."""
    prompt = list(range(1, 33))                      # 8 complete blocks

    async def run():
        plane = DevicePlane()
        a, b = make_engine("port", tree), make_engine("port", tree)
        j = make_engine("jax", tree)
        a.attach_prefix_cache(worker_id=1, plane=plane)
        b.attach_prefix_cache(worker_id=2, plane=plane)
        plane.register("pa", a)
        plane.register("pb", b)
        b.prefix.peer_planes[1] = "pa"
        try:
            got_a = await run_req(a, prompt, "warm")
            hashes = compute_block_hashes_for_seq(prompt, BS)
            blocks, parent = [], None
            for h in hashes:
                blocks.append({"digest": h, "block_hash": h,
                               "parent": parent})
                parent = h
            b.prefix.ingest_router_event(1, {"kind": "stored",
                                             "blocks": blocks})
            cache = b.cache
            got_b = await run_req(b, prompt, "cold")
            assert b.cache is cache
            want = await run_req(j, prompt, "ref")
            return (got_a, got_b, want, b.prefix.ici_onboarded_blocks,
                    len(hashes), b.prefix.snapshot())
        finally:
            for e in (a, b, j):
                await e.stop()

    got_a, got_b, want, pulled, n, snap = asyncio.run(run())
    assert pulled >= n
    assert got_a == got_b == want
    assert snap["prefix_ici_onboarded_total"] == pulled


def test_evicted_blocks_leave_g1_and_stay_in_g2(tree):
    """``evict_to_host`` unregisters the demoted blocks from G1 (the
    pool's removed events clear the index's G1 marks; an evictable cached
    page already counted as free) and marks them G2, as in JAX."""
    async def run(pkg):
        engine = make_engine(pkg, tree)
        engine.attach_kvbm((JKvbmConfig if pkg == "jax" else KvbmConfig)(
            host_blocks=64))
        engine.attach_prefix_cache(worker_id=0)
        try:
            await run_req(engine, list(range(1, 25)), "a")
            await settle(engine)
            free0 = engine.scheduler.pool.num_free
            n = await engine.prefix.evict_to_host(64)
            idx = engine.prefix.index
            return (n, engine.scheduler.pool.num_free - free0,
                    idx.tier_blocks(TIER_G1, 0), idx.tier_blocks(TIER_G2, 0))
        finally:
            await engine.stop()

    want, got = asyncio.run(run("jax")), asyncio.run(run("port"))
    assert got == want
    assert got[0] > 0 and got[2] == 0 and got[3] >= got[0]


def test_worker_attaches_the_prefix_cache_by_default():
    from dynamo_tpu_torch.utils.config import RuntimeConfig

    from dynamo_tpu.utils.config import RuntimeConfig as JRuntimeConfig

    assert RuntimeConfig().prefix_enabled is True
    assert JRuntimeConfig().prefix_enabled is True
