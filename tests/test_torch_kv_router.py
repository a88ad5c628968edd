"""The port's KV-aware router against the JAX package's.

- The router's pieces, run as the JAX package's own tests run them
  (``tests/test_router.py`` for the indexer, scheduler and breaker,
  ``tests/test_prefix_radix.py`` for the radix index): each scenario runs
  on both packages' objects with the same seeded inputs and must give the
  same trace (matches, scores, selections at temperatures 0 and 0.5 with
  one seed, eviction orders, a 400-operation seeded churn checked with
  ``check_invariants`` at every step).
- A tiny float32 port engine and the JAX engine, given the same prompts,
  emit identical ``kv_events``, hashes and block ids included.
- Over one store, a JAX ``KvRouter`` and the port's pick the same worker,
  with the same overlap, whether the workers publishing the events are JAX
  workers or port workers; a router of one package warm-starts from the
  other's index snapshot and sees the other's in-flight load.
- ``python -m dynamo_tpu_torch.frontend --router-mode kv`` over two port
  worker processes sends a repeated prefix to its holder and drops a
  SIGKILLed worker from its index.
"""

import asyncio
import json
import random
import re
import signal
import time
from types import SimpleNamespace

import aiohttp
import jax
import numpy as np
import pytest

from dynamo_tpu import tokens as jtokens
from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu.prefix import radix as jradix
from dynamo_tpu.router import indexer as jindexer
from dynamo_tpu.router import kv_router as jkv
from dynamo_tpu.router import publisher as jpublisher
from dynamo_tpu.router import scheduler as jscheduler
from dynamo_tpu.runtime import circuit as jcircuit
from dynamo_tpu.runtime import component as jcomp
from dynamo_tpu.runtime import store as jstore
from dynamo_tpu.runtime import transport as jtransport
from dynamo_tpu.utils import config as jconfig
from dynamo_tpu_torch import tokens as ttokens
from dynamo_tpu_torch.engine import (
    EngineConfig, InferenceEngine, ModelConfig, Request,
)
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.prefix import radix as tradix
from dynamo_tpu_torch.router import indexer as tindexer
from dynamo_tpu_torch.router import kv_router as tkv
from dynamo_tpu_torch.router import publisher as tpublisher
from dynamo_tpu_torch.router import scheduler as tscheduler
from dynamo_tpu_torch.runtime import circuit as tcircuit
from dynamo_tpu_torch.runtime import codec as tcodec
from dynamo_tpu_torch.runtime import component as tcomp
from dynamo_tpu_torch.runtime import store as tstore
from dynamo_tpu_torch.runtime import transport as ttransport
from dynamo_tpu_torch.utils import config as tconfig
from test_torch_distributed import start_cluster, tok_file  # noqa: F401
from test_torch_engine import ENG_KW, MAX_TOKENS, PROMPTS
from test_torch_frontend_http import TIMEOUT, fetch

BS = 4  # block size of the unit scenarios, as in the JAX tests
SEED = 7
SIDES = {
    "jax": SimpleNamespace(
        tokens=jtokens, radix=jradix, indexer=jindexer, sched=jscheduler,
        kv=jkv, circuit=jcircuit, transport=jtransport, comp=jcomp,
        store=jstore, config=jconfig, publisher=jpublisher),
    "port": SimpleNamespace(
        tokens=ttokens, radix=tradix, indexer=tindexer, sched=tscheduler,
        kv=tkv, circuit=tcircuit, transport=ttransport, comp=tcomp,
        store=tstore, config=tconfig, publisher=tpublisher),
}


def chain(S, tokens, bs=BS):
    return S.tokens.compute_block_hashes_for_seq(tokens, bs)


def insert_chain(idx, hashes, tier, worker=0):
    parent = None
    for h in hashes:
        idx.insert(h, h, parent, tier, worker)
        parent = h


def structure(idx):
    """Order-independent fingerprint of a radix index."""
    return {
        h: (n.parent, n.depth, tuple(sorted(n.children)),
            tuple((t, tuple(sorted(ws)))
                  for t, ws in sorted(n.holders.items())))
        for h, n in idx._nodes.items()
    }


def match(m):
    return (m.blocks, [n.seq_hash for n in m.nodes], m.scores,
            m.worker_blocks)


# ------------------------------ radix index ------------------------------


def radix_partial_tail(S):
    R = S.radix
    toks = list(range(1, 11))             # 10 tokens, block 4 → 2 complete
    assert len(chain(S, toks)) == 2 == len(chain(S, toks[:12]))
    assert chain(S, toks) == chain(S, toks + [99])[:2]
    idx = R.RadixPrefixIndex(BS)
    insert_chain(idx, chain(S, toks), R.TIER_G1)
    m = idx.find_matches(chain(S, toks + [99, 100]))
    assert m.blocks == 2 and len(idx) == 2
    return [match(m), structure(idx)]


def radix_split(S):
    R = S.radix
    shared = list(range(1, 9))
    a = chain(S, shared + [10, 11, 12, 13])
    b = chain(S, shared + [20, 21, 22, 23])
    assert a[:2] == b[:2] and a[2] != b[2]
    idx = R.RadixPrefixIndex(BS)
    insert_chain(idx, a, R.TIER_G1, worker=1)
    insert_chain(idx, b, R.TIER_G1, worker=2)
    idx.check_invariants()
    assert idx.get(a[1]).children == {a[2], b[2]}
    assert idx.get(a[0]).workers() == {1, 2}
    return [structure(idx), match(idx.find_matches(a)),
            match(idx.find_matches(b))]


def radix_insert_permutations(S):
    R = S.radix
    rng = random.Random(SEED)
    shared = [rng.randrange(1, 200) for _ in range(8)]
    chains = [chain(S, shared + [rng.randrange(1, 200) for _ in range(8)])
              for _ in range(3)]
    ops = []
    for ci, hs in enumerate(chains):
        parent = None
        for h in hs:
            ops.append((h, parent, ci % 2))
            parent = h
    out = []
    for _ in range(6):
        perm = list(ops)
        rng.shuffle(perm)
        idx = R.RadixPrefixIndex(BS)
        for h, parent, w in perm:
            idx.insert(h, h, parent, R.TIER_G1, w)
        idx.check_invariants()
        assert not idx._orphans
        out.append(structure(idx))
    assert all(s == out[0] for s in out)
    return out


def radix_orphan(S):
    R = S.radix
    hs = chain(S, list(range(1, 13)))
    idx = R.RadixPrefixIndex(BS)
    idx.insert(hs[2], hs[2], hs[1], R.TIER_G1, 0)     # grandchild first
    idx.insert(hs[1], hs[1], hs[0], R.TIER_G1, 0)
    trace = [structure(idx), dict(idx._orphans)]
    idx.insert(hs[0], hs[0], None, R.TIER_G1, 0)
    idx.check_invariants()
    assert idx._roots == {hs[0]}
    return trace + [structure(idx), match(idx.find_matches(hs))]


def radix_tiers(S):
    R = S.radix
    hs = chain(S, list(range(1, 9)))
    idx = R.RadixPrefixIndex(BS)
    insert_chain(idx, hs, R.TIER_G1, worker=1)
    insert_chain(idx, hs, R.TIER_G4, worker=2)
    trace = [match(idx.find_matches(hs))]
    for h in hs:
        trace.append((idx.mark(h, R.TIER_G2, 1), idx.unmark(h, R.TIER_G1, 1)))
    trace += [idx.tier_blocks(R.TIER_G1, 1), idx.tier_blocks(R.TIER_G2, 1),
              match(idx.find_matches(hs)), idx.drop_worker(1),
              idx.drop_worker(2), len(idx)]
    idx.check_invariants()
    return trace


def radix_interior_and_holes(S):
    R = S.radix
    hs = chain(S, list(range(1, 17)))                  # 4 blocks
    idx = R.RadixPrefixIndex(BS)
    insert_chain(idx, hs[:3], R.TIER_G1)
    idx.unmark(hs[1], R.TIER_G1, 0)                  # interior stays
    trace = [hs[1] in idx, structure(idx)]
    idx.unmark(hs[2], R.TIER_G1, 0)                  # then unwinds
    idx.check_invariants()
    trace += [hs[1] in idx, hs[2] in idx, hs[0] in idx]
    holes = R.RadixPrefixIndex(BS)
    insert_chain(holes, hs, R.TIER_G1, worker=1)
    insert_chain(holes, hs, R.TIER_G1, worker=2)
    holes.unmark(hs[1], R.TIER_G1, 1)
    m = holes.find_matches(hs)
    assert m.blocks == 4 and m.worker_blocks == {1: 1, 2: 4}
    return trace + [match(m)]


def radix_lru_eviction(S):
    R = S.radix
    shared = list(range(1, 9))
    a = chain(S, shared + [10, 11, 12, 13])
    b = chain(S, shared + [20, 21, 22, 23])
    idx = R.RadixPrefixIndex(BS)
    insert_chain(idx, a, R.TIER_G1)
    insert_chain(idx, b, R.TIER_G1)
    idx.find_matches(a)
    trace = [idx.lru_subtree(R.TIER_G1), idx.evict_lru_subtree(R.TIER_G1),
             idx.find_matches(a).blocks, idx.evictions_total]
    assert trace[:2] == [[b[2]], [b[2]]]
    idx.check_invariants()
    # a seeded tree drained whole: the eviction order is a pure function
    # of the operations (logical clock, ties on seq_hash)
    rng = random.Random(SEED)
    idx = R.RadixPrefixIndex(BS)
    for _ in range(12):
        toks = [rng.randrange(1, 50) for _ in range(rng.choice((8, 12)))]
        insert_chain(idx, chain(S, toks), R.TIER_G1,
                     worker=rng.randrange(2))
    while True:
        ev = idx.evict_lru_subtree(R.TIER_G1)
        trace.append(ev)
        if not ev:
            break
    assert len(idx) == 0
    return trace


def radix_seeded_churn(S):
    R = S.radix
    rng = random.Random(SEED)
    idx = R.RadixPrefixIndex(BS)
    live, trace = [], []
    for _ in range(400):
        op = rng.randrange(6)
        if op <= 1 or not live:
            toks = [rng.randrange(1, 40)
                    for _ in range(4 * rng.randrange(1, 5))]
            hs = chain(S, toks)
            insert_chain(idx, hs, rng.choice(R.TIERS), rng.randrange(3))
            live.append(hs)
            out = len(idx)
        elif op == 2:
            hs = rng.choice(live)
            out = idx.mark(rng.choice(hs), rng.choice(R.TIERS),
                           rng.randrange(3))
        elif op == 3:
            hs = rng.choice(live)
            out = idx.unmark(rng.choice(hs), rng.choice(R.TIERS),
                             rng.randrange(3))
        elif op == 4:
            out = idx.evict_lru_subtree(rng.choice(R.TIERS),
                                        worker=rng.randrange(3))
        else:
            out = idx.drop_worker(rng.randrange(3))
        idx.check_invariants()
        trace.append((op, out, match(idx.find_matches(rng.choice(live)))))
    assert idx.inserted_total > 0
    return trace + [structure(idx), idx.stats()]


def radix_hits_and_events(S):
    R = S.radix
    hs = chain(S, list(range(1, 17)))
    idx = R.RadixPrefixIndex(BS)
    insert_chain(idx, hs[:3], R.TIER_G1)
    trace = [idx.record_hit_blocks(hs, R.TIER_G1, worker=0),
             idx.record_hit_blocks(hs, R.TIER_G2, worker=0),
             idx.record_hit_blocks(hs, R.TIER_G1, worker=9),
             idx.hit_tokens_total]
    assert trace[0] == 3 * BS
    idx = R.RadixPrefixIndex(BS)
    blocks, parent = [], None
    for h in hs[:3]:
        blocks.append({"digest": h, "seq_hash": h, "block_hash": h,
                       "parent": parent})
        parent = h
    idx.apply_event(3, {"kind": "stored", "blocks": blocks})
    idx.apply_event(4, {"kind": "stored", "tier": R.TIER_G2, "blocks": [
        {**b, "tier": R.TIER_G2} for b in blocks[:2]]})
    trace += [match(idx.find_matches(hs)), idx.tier_blocks(R.TIER_G2, 4)]
    idx.apply_event(3, {"kind": "removed", "blocks": [hs[2]]})
    trace.append(match(idx.find_matches(hs)))
    idx.apply_event(3, {"kind": "cleared"})
    idx.check_invariants()
    return trace + [idx.tier_blocks(R.TIER_G1, 3),
                    idx.tier_blocks(R.TIER_G2, 4), structure(idx)]


# ----------------------- indexer, scheduler, breaker ---------------------


def stored(S, worker, hashes):
    return S.indexer.RouterEvent(
        worker_id=worker, kind="stored",
        blocks=tuple({"seq_hash": h} for h in hashes))


def indexer_matches(S):
    I = S.indexer
    idx = I.KvIndexer(BS)
    h = chain(S, list(range(16)))
    idx.apply_event(stored(S, 1, h[:2]))
    idx.apply_event(stored(S, 2, h))
    trace = [idx.find_matches(h).scores]
    assert trace[0] == {1: 2, 2: 4}
    hole = I.KvIndexer(BS)
    hole.apply_event(stored(S, 1, [h[1]]))     # prefix matching never skips
    trace.append(hole.find_matches(h).scores)
    idx.apply_event(I.RouterEvent(worker_id=1, kind="removed",
                                  blocks=(h[1],)))
    trace.append(idx.find_matches(h).scores)
    idx.apply_event(I.RouterEvent(worker_id=2, kind="cleared", blocks=()))
    trace.append(idx.find_matches(h).scores)
    idx.remove_worker(1)
    trace += [idx.find_matches(h).scores, idx.num_blocks(),
              idx.events_applied]
    warm = I.KvIndexer(BS)
    warm.apply_event(stored(S, 7, h))
    copy = I.KvIndexer(BS)
    for ev in warm.dump_events():
        copy.apply_event(I.RouterEvent.from_dict(ev.to_dict()))
    trace += [copy.find_matches_for_tokens(list(range(18))).scores,
              [e.to_dict() for e in warm.dump_events()]]
    return trace


def indexer_approx(S):
    approx = S.indexer.ApproxKvIndexer(BS, ttl_s=0.3)
    toks = list(range(12))
    approx.record_routing_decision(5, toks)
    trace = [approx.find_matches_for_tokens(toks).scores]
    approx.record_routing_decision(6, toks[:8])
    approx.remove_worker(5)
    trace.append(approx.find_matches_for_tokens(toks).scores)
    time.sleep(0.35)
    trace.append(approx.find_matches_for_tokens(toks).scores)
    assert trace == [{5: 3}, {6: 2}, {}]
    return trace


def scheduler_softmax(S):
    rng = random.Random(0)
    ties = [S.sched.softmax_sample({1: 5.0, 2: 1.0, 3: 1.0}, 0.0, rng)
            for _ in range(50)]
    assert set(ties) == {2, 3}
    warm = [S.sched.softmax_sample({1: 0.0, 2: 10.0}, 1.0, rng)
            for _ in range(200)]
    assert warm.count(1) > 190
    return [ties, warm]


def scheduler_costs(S):
    C, L = S.sched.KvRouterConfig, S.sched.PotentialLoads
    rng = random.Random(0)
    sel = S.sched.select_worker([1, 2], 32, {1: 8}, L(BS), BS, C(), rng=rng)
    assert (sel.worker_id, sel.overlap_blocks, sel.logit) == (1, 8, 8.0)
    trace = [vars(sel)]
    loads = L(BS)
    for i in range(3):
        loads.add(f"r{i}", 1, isl_tokens=32, overlap_blocks=0)
    trace.append(vars(S.sched.select_worker([1, 2], 32, {}, loads, BS, C(),
                                            rng=rng)))
    loads = L(BS)
    loads.add("r1", 1, isl_tokens=30, overlap_blocks=2)
    trace.append((loads.prefill_tokens(1), loads.decode_blocks(1)))
    loads.prefill_done("r1")
    trace.append((loads.prefill_tokens(1), loads.decode_blocks(1)))
    loads.free("r1")
    loads.free("r1")
    trace.append((loads.decode_blocks(1), loads.num_active))
    loads = L(BS)
    for i in range(4):
        loads.add(f"d{i}", 2, isl_tokens=64, overlap_blocks=0)
        loads.prefill_done(f"d{i}")
    for w in (100.0, 0.0):
        trace.append(vars(S.sched.select_worker(
            [1, 2], 32, {2: 8}, loads, BS, C(), overlap_weight=w, rng=rng)))
    assert [t["worker_id"] for t in trace[-2:]] == [2, 1]
    return trace


def scheduler_seeded_selections(S):
    """300 selections over 4 workers with random overlaps and a changing
    load, at temperature 0 (ties drawn by the seeded rng) and 0.5."""
    data = random.Random(SEED)
    rng = random.Random(0)
    loads = S.sched.PotentialLoads(16)
    cfg = S.sched.KvRouterConfig()
    trace, live = [], []
    for i in range(300):
        isl = data.randrange(1, 600)
        overlaps = {w: data.randrange(0, isl // 16 + 1)
                    for w in range(4) if data.random() < 0.6}
        sel = S.sched.select_worker(
            [0, 1, 2, 3], isl, overlaps, loads, 16, cfg,
            temperature=(0.0, 0.5)[i % 2], rng=rng)
        loads.add(f"q{i}", sel.worker_id, isl, sel.overlap_blocks)
        live.append(f"q{i}")
        if data.random() < 0.4:
            loads.prefill_done(data.choice(live))
        if data.random() < 0.3:
            loads.free(live.pop(data.randrange(len(live))))
        trace.append(vars(sel))
    assert {t["worker_id"] for t in trace} == {0, 1, 2, 3}
    return trace


def circuit_breaker(S):
    now = [0.0]
    reg = S.circuit.CircuitBreakerRegistry(clock=lambda: now[0])
    cfg = reg.config
    assert (cfg.failure_threshold, cfg.open_timeout_s,
            cfg.half_open_probes) == (3, 5.0, 1)
    trace = []
    for step in ("f", "f", "s", "f", "f", "f", "t4.9", "t0.2", "b", "f",
                 "t5.0", "b", "s", "trip", "t5", "b", "f"):
        if step == "f":
            reg.record_failure(9)
        elif step == "s":
            reg.record_success(9)
        elif step == "b":
            reg.begin(9)
        elif step == "trip":
            reg.trip(9)
        else:
            now[0] += float(step[1:])
        trace.append((step, reg.states(), reg.allow(9),
                      reg.breaker(9).num_trips))
    reg.remove(9)
    return trace + [reg.states(), reg.allow(9)]


def router_busy_threshold(S):
    """``find_best_match`` over a fake client: the busy threshold, the
    breaker and drain filters, and the seeded choice among the rest."""
    class FakeClient:
        class endpoint:
            path = "t/backend/generate"
        on_instance_removed, on_instance_added = [], []

        def instance_ids(self):
            return [1, 2, 3]

    router = S.kv.KvRouter.__new__(S.kv.KvRouter)
    router.client = FakeClient()
    router.component = None
    router.block_size = BS
    router.config = S.sched.KvRouterConfig(busy_threshold=0.8,
                                           replica_sync=False)
    router.indexer = S.indexer.KvIndexer(BS)
    router.approx = None
    router.prefix_index = None
    router.loads = S.sched.PotentialLoads(BS)
    router.worker_stats = {w: {"kv_usage": 0.9} for w in (1, 2, 3)}
    router.breakers = S.circuit.CircuitBreakerRegistry()
    router.draining = set()
    router._rng = random.Random(0)
    trace = []
    with pytest.raises(S.transport.EngineError) as exc:
        router.find_best_match("r0", list(range(8)))
    trace.append(exc.value.code)
    router.worker_stats[2]["kv_usage"] = router.worker_stats[3][
        "kv_usage"] = 0.1
    router.indexer.apply_event(stored(S, 3, chain(S, list(range(8)))))
    for i in range(6):
        sel = router.find_best_match(f"r{i + 1}", list(range(8 + i)),
                                     temperature=0.5)
        trace.append(vars(sel))
        router.free(f"r{i + 1}")
    for _ in range(3):
        router.breakers.record_failure(3)
    router.mark_draining(2)
    with pytest.raises(S.transport.EngineError) as exc:
        router.find_best_match("r9", list(range(8)))
    trace.append(exc.value.code)
    return trace


SCENARIOS = {f.__name__: f for f in (
    radix_partial_tail, radix_split, radix_insert_permutations,
    radix_orphan, radix_tiers, radix_interior_and_holes, radix_lru_eviction,
    radix_seeded_churn, radix_hits_and_events, indexer_matches,
    indexer_approx, scheduler_softmax, scheduler_costs,
    scheduler_seeded_selections, circuit_breaker, router_busy_threshold)}


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_router_pieces_match_jax(scenario):
    run = SCENARIOS[scenario]
    assert run(SIDES["port"]) == run(SIDES["jax"])


# ------------------------------ KV events --------------------------------


def test_engine_kv_events_equal_jax():
    """The same prompts through a float32 JAX engine and the port engine
    holding its parameters: identical ``kv_events``, block for block
    (sequence hashes, block hashes, parents and block ids)."""
    async def serve(engine, request_cls):
        events = []
        engine.kv_event_sink = events.append

        async def one(i):
            req = request_cls(request_id=f"r{i}", token_ids=PROMPTS[i],
                              max_tokens=MAX_TOKENS[i])
            return [o.token_id async for o in engine.submit(req)]
        try:
            for i in range(len(PROMPTS)):    # one at a time: a fixed order
                await one(i)
        finally:
            await engine.stop()
        return events

    jengine = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**ENG_KW),
                        seed=0)
    tree = jax.tree.map(np.asarray, jengine.params)
    want = asyncio.run(serve(jengine, JaxRequest))
    tengine = InferenceEngine(
        ModelConfig.tiny(), EngineConfig(**ENG_KW),
        params=params_from_numpy(tree, ModelConfig.tiny(), "cpu"),
        device="cpu")
    got = asyncio.run(serve(tengine, Request))
    assert got == want
    assert sum(len(e["blocks"]) for e in want if e["kind"] == "stored") \
        == sum((len(p) + n - 1) // ENG_KW["block_size"]
               for p, n in zip(PROMPTS, MAX_TOKENS))


# ---------------------- routers over one store ---------------------------


def tiny_engine(side):
    kw = dict(num_blocks=64, block_size=4, max_model_len=128,
              max_num_batched_tokens=128, prefill_buckets=(128,),
              decode_buckets=(4,), max_num_seqs=4)
    if side == "jax":
        return JaxEngine(JaxModelConfig.tiny(vocab_size=256),
                         JaxEngineConfig(**kw))
    return InferenceEngine(ModelConfig.tiny(vocab_size=256),
                           EngineConfig(**kw), device="cpu")


async def wait_until(cond, what, tries=200):
    for _ in range(tries):
        if await cond():
            return
        await asyncio.sleep(0.05)
    pytest.fail(what)


async def routers_over_one_store(worker_side):
    """Two workers of ``worker_side`` publish KV events onto one store; a
    JAX router and a port router read them. Returns each router's trace."""
    W = SIDES[worker_side]
    store = W.store.StoreServer(host="127.0.0.1", port=0)
    await store.start()
    addr = f"127.0.0.1:{store.port}"
    workers, runtimes, routers, clients = [], [], {}, []
    try:
        for _ in range(2):
            rt = await W.comp.DistributedRuntime.from_settings(
                W.config.RuntimeConfig(store_addr=addr))
            runtimes.append(rt)
            engine = tiny_engine(worker_side)
            await engine.start()
            ep = rt.namespace("rtest").component("backend").endpoint(
                "generate")
            served = await ep.serve_endpoint(engine)
            pub = W.publisher.KvEventPublisher(ep.component, rt.primary_lease)
            pub.start()
            engine.kv_event_sink = pub.sink
            workers.append(dict(rt=rt, engine=engine, served=served,
                                pub=pub, id=rt.primary_lease))
        ids = [w["id"] for w in workers]
        for side in ("jax", "port"):
            S = SIDES[side]
            rt = await S.comp.DistributedRuntime.from_settings(
                S.config.RuntimeConfig(store_addr=addr))
            runtimes.append(rt)
            ep = rt.namespace("rtest").component("backend").endpoint(
                "generate")
            client = await ep.client()
            clients.append(client)
            await client.wait_for_instances(2)
            # the JAX router persists its index; the port router reads it
            router = S.kv.KvRouter(client, ep.component, block_size=BS,
                                   seed=0, config=S.sched.KvRouterConfig(
                                       replica_sync=False,
                                       snapshot_threshold=int(side == "jax")))
            await router.start()
            routers[side] = router
        prompt = list(range(1, 33))                 # 8 blocks of 4
        request_cls = JaxRequest if worker_side == "jax" else Request
        async for _ in workers[0]["engine"].submit(
                request_cls(request_id="warm", token_ids=prompt,
                            max_tokens=4)):
            pass

        async def indexed():
            return all(r.indexer.num_blocks(ids[0]) >= 8
                       for r in routers.values())
        await wait_until(indexed, "kv events never reached both routers")
        trace = {side: [] for side in routers}
        for side, router in routers.items():
            sel = router.find_best_match("q", prompt + [99, 100])
            router.free("q")
            trace[side].append((ids.index(sel.worker_id), sel.overlap_blocks))
            for i in range(12):                     # seeded, temperature 0.5
                sel = router.find_best_match(
                    f"t{i}", prompt[:4 * (i % 9)] + [200 + i] * 5,
                    temperature=0.5)
                router.free(f"t{i}")
                trace[side].append((ids.index(sel.worker_id),
                                    sel.overlap_blocks, sel.logit))

        # a port router warm-starts from the JAX router's snapshot
        S = SIDES["port"]
        key = routers["jax"]._snapshot_key()

        async def persisted():
            raw = await runtimes[-1].store.get(key)
            return raw and len(tcodec.unpackb(raw)["workers"].get(
                str(ids[0]), ())) >= 8
        await wait_until(persisted, "the JAX router never wrote a snapshot")
        warm = S.kv.KvRouter(clients[1], routers["port"].component,
                             block_size=BS, seed=0,
                             config=S.sched.KvRouterConfig(
                                 replica_sync=False, snapshot_threshold=0))
        await warm.start()
        try:
            assert warm.indexer.num_blocks(ids[0]) >= 8
            sel = warm.find_best_match("after-restart", prompt)
            assert (sel.worker_id, sel.overlap_blocks) == (ids[0], 8)
        finally:
            await warm.stop()

        # replica sync across the packages: no double booking
        peers = {side: SIDES[side].kv.KvRouter(
            client, routers[side].component, block_size=BS, seed=0)
            for side, client in zip(("jax", "port"), clients)}
        for r in peers.values():
            await r.start()
        try:
            for first, second in (("jax", "port"), ("port", "jax")):
                a, b = peers[first], peers[second]
                sel_a = a.find_best_match(f"sync-{first}", list(range(
                    300, 332)))

                async def booked(w=sel_a.worker_id, b=b):
                    return b.loads.decode_blocks(w) > 0
                await wait_until(booked, f"{second} router never saw the "
                                 f"{first} router's booking")
                sel_b = b.find_best_match(f"sync-{second}",
                                          list(range(400, 432)))
                assert sel_b.worker_id != sel_a.worker_id
                a.free(f"sync-{first}")
                b.free(f"sync-{second}")

                async def freed(w=sel_a.worker_id, b=b):
                    return b.loads.decode_blocks(w) == 0
                await wait_until(freed, "the peer free never arrived")
        finally:
            for r in peers.values():
                await r.stop()

        # worker 0 leaves: both routers drop its blocks, route to worker 1
        await workers[0]["served"].stop()

        async def dropped():
            return all(r.indexer.num_blocks(ids[0]) == 0
                       and ids[0] not in r.client.instance_ids()
                       for r in routers.values())
        await wait_until(dropped, "a router kept the departed worker")
        for side, router in routers.items():
            sel = router.find_best_match("gone", prompt)
            router.free("gone")
            trace[side].append((ids.index(sel.worker_id), sel.overlap_blocks))
        return trace
    finally:
        for router in routers.values():
            await router.stop()
        for c in clients:
            await c.stop()
        for w in workers:
            await w["pub"].stop()
            await w["engine"].stop()
        for rt in runtimes:
            await rt.shutdown()
        await store.stop()


@pytest.mark.parametrize("workers", ["jax", "port"])
def test_jax_and_port_routers_pick_alike(workers):
    """Fed the KV events of JAX workers or of port workers, the JAX router
    and the port router make the same choices: the prefix holder with all
    8 blocks, the same seeded sequence at temperature 0.5, and worker 1
    once worker 0 has left."""
    trace = asyncio.run(routers_over_one_store(workers))
    assert trace["port"] == trace["jax"]
    assert trace["jax"][0] == (0, 8)
    assert trace["jax"][-1] == (1, 0)
    assert {t[0] for t in trace["jax"][1:-1]} == {0, 1}


# ------------------------ the frontend process ---------------------------


def test_frontend_router_mode_kv_routes_prefix_to_holder(tmp_path,
                                                         tok_file):  # noqa: F811
    """``--router-mode kv`` over two port worker processes: a repeated
    64-token prefix goes to the worker that served it first, with its 4
    blocks matched (read from the frontend's ``router.select`` spans);
    once that worker is SIGKILLed and its lease expires, the same prefix
    goes to the survivor with no overlap left in the index."""
    spans = tmp_path / "spans.jsonl"
    procs, port = start_cluster(
        tmp_path, tok_file, 2, frontend_flags=["--router-mode", "kv"],
        frontend_env={"DYNTPU_TRACE_SAMPLE_RATIO": "1",
                      "DYNTPU_TRACE_EXPORT_PATH": str(spans)})
    instance = {}
    for name in ("worker0", "worker1"):
        m = procs[name].wait_for(r"serving \S+/generate as instance (\d+)")
        instance[int(m.group(1))] = name
    prefix = list(range(10, 74))                     # 4 blocks of 16

    def selections():
        if not spans.exists():
            return []
        return [s["attrs"] for s in map(json.loads,
                                        spans.read_text().splitlines())
                if s["name"] == "router.select"]

    async def complete(tail):
        async with aiohttp.ClientSession(timeout=TIMEOUT) as s:
            for _ in range(200):
                _, _, body = await fetch(s, port, "GET", "/v1/models")
                if body["data"]:
                    break
                await asyncio.sleep(0.05)
            status, _, body = await fetch(s, port, "POST", "/v1/completions",
                                          {"model": "tiny",
                                           "prompt": prefix + tail,
                                           "max_tokens": 3,
                                           "temperature": 0})
        assert status == 200, body
        assert body["usage"]["completion_tokens"] == 3
        return selections()[-1]

    async def drive():
        # a second subscriber on the store: the store fans each kv_events
        # message out to every subscriber at once, the frontend's router
        # among them, and the store's instance keys are what its client
        # watches
        addr = "127.0.0.1:" + procs["store"].proc.args[-1]
        rt = await tcomp.DistributedRuntime.from_settings(
            tconfig.RuntimeConfig(store_addr=addr))
        component = rt.namespace().component("backend")
        stream = await rt.store.subscribe(
            component.event_subject(tkv.KV_EVENTS_SUBJECT))
        client = await component.endpoint("generate").client()
        try:
            first = await complete([200, 201, 202])
            assert first["overlap_blocks"] == 0
            stored = 0
            while stored < 4:
                event = await asyncio.wait_for(stream.next(), 60)
                assert event is not None
                if event["event"] != "msg":
                    continue
                ev = tindexer.RouterEvent.from_dict(
                    tcodec.unpackb(event["value"]))
                if ev.worker_id == first["worker_id"] and ev.kind == "stored":
                    stored += len(ev.blocks)
            await asyncio.sleep(0.5)   # the frontend applies the same events
            second = await complete([300, 301, 302])
            assert second == {"worker_id": first["worker_id"],
                              "overlap_blocks": 4}
            holder = instance[first["worker_id"]]
            procs[holder].stop(signal.SIGKILL)

            async def gone():
                return first["worker_id"] not in client.instance_ids()
            # lease TTL 1 s, then the store's sweep deletes the key
            await wait_until(gone, "the killed worker's key stayed",
                             tries=1200)
            await asyncio.sleep(0.5)   # the frontend's watch sees the same
            third = await complete([400, 401, 402])
            assert third["worker_id"] != first["worker_id"]
            assert instance[third["worker_id"]] != holder
            assert third["overlap_blocks"] == 0
        finally:
            await client.stop()
            await stream.cancel()
            await rt.shutdown()

    try:
        asyncio.run(drive())
        assert procs["frontend"].stop() == 0
    finally:
        for p in procs.values():
            p.stop(signal.SIGKILL)
    assert not re.search(r"Traceback", procs["frontend"].log.read_text())
