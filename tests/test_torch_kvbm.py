"""The port's KVBM (``dynamo_tpu_torch.kvbm``) held against the JAX
package: G3 spill files one package writes the other reads (bf16, fp8,
int8 with scales); the host pool's LRU, byte bound and spill counters move
as JAX's for the same puts; the same traffic through offload,
``clear_kv_blocks`` and onboarding gives the same greedy stream and the same
``snapshot()`` counters on a port and a JAX engine; a G4 block written to
the store by either package is onboarded by a port engine; a port worker
onboards a prefix from a peer's G2 (port or JAX) and a JAX worker from a
port peer; the group barrier refuses a layout mismatch across the
packages. CPU, ``ModelConfig.tiny``, numpy seeds."""

import asyncio
import dataclasses

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.config import ModelConfig as JModelConfig
from dynamo_tpu.engine.engine import InferenceEngine as JEngine
from dynamo_tpu.engine.engine import Request as JRequest
from dynamo_tpu.kvbm import distributed as jdist
from dynamo_tpu.kvbm.host_pool import HostBlockPool as JHostBlockPool
from dynamo_tpu.kvbm.manager import KvbmConfig as JKvbmConfig
from dynamo_tpu.kvbm.manager import StoreRemoteTier as JStoreRemoteTier
from dynamo_tpu.runtime.store import StoreClient as JStoreClient
from dynamo_tpu_torch.disagg.protocol import tensor_bytes
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine, Request
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.kvbm import distributed as tdist
from dynamo_tpu_torch.kvbm.host_pool import HostBlockPool
from dynamo_tpu_torch.kvbm.manager import KvbmConfig, StoreRemoteTier
from dynamo_tpu_torch.runtime.store import StoreClient, StoreServer

BLOCK = (2, 2, 4, 8)   # [L, KV, bs, hd]
SPILL_KINDS = {
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, False),
    "float8_e4m3fn": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn, True),
    "int8": (np.int8, torch.int8, True),
}


def _block(kind: str, seed: int):
    ndt, tdt, scaled = SPILL_KINDS[kind]
    rng = np.random.default_rng(seed)
    np_b, t_b = {}, {}
    for key in ("k", "v"):
        if ndt is np.int8:
            a = rng.integers(-127, 128, size=BLOCK).astype(np.int8)
        else:
            a = rng.standard_normal(BLOCK).astype(np.float32).astype(ndt)
        np_b[key] = a
        view = np.uint8 if a.dtype.itemsize == 1 else np.int16
        t_b[key] = torch.from_numpy(a.view(view).copy()).view(tdt)
    if scaled:
        for key in ("ks", "vs"):
            a = rng.random(BLOCK[:-1]).astype(np.float32)
            np_b[key], t_b[key] = a, torch.from_numpy(a.copy())
    return np_b, t_b


@pytest.mark.parametrize("kind", sorted(SPILL_KINDS))
def test_spill_files_cross_read(kind, tmp_path):
    """A block the port spills to G3 is read back by JAX's pool with its
    dtype and bytes, and a block JAX spills is read back by the port's."""
    np_b, t_b = _block(kind, 0)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port = HostBlockPool(1, str(port_dir), 4)
    port.put(11, t_b)
    port.put(12, _block(kind, 1)[1])                     # spills 11
    jax_pool = JHostBlockPool(1, str(jax_dir), 4)
    jax_pool.put(11, np_b)
    jax_pool.put(12, _block(kind, 1)[0])
    assert sorted(p.name for p in port_dir.iterdir()) == \
        sorted(p.name for p in jax_dir.iterdir())
    # each package reads the other's directory
    reader_j = JHostBlockPool(1, str(port_dir), 4)
    reader_j._disk[11] = port_dir / f"{11:016x}.npz"
    reader_t = HostBlockPool(1, str(jax_dir), 4)
    reader_t._disk[11] = jax_dir / f"{11:016x}.npz"
    got_j, got_t = reader_j.get(11), reader_t.get(11)
    assert set(got_j) == set(got_t) == set(np_b)
    for key, a in np_b.items():
        assert got_j[key].dtype == a.dtype
        assert got_j[key].tobytes() == a.tobytes()
        assert got_t[key].dtype == t_b[key].dtype
        assert tensor_bytes(got_t[key]) == a.tobytes()


def test_host_pool_counters_equal_jax(tmp_path):
    """The same puts and gets — over the block and the byte bound, into a
    small G3 — leave both pools with the same stats, members and drops."""
    pools = [
        HostBlockPool(3, str(tmp_path / "t"), 2, capacity_bytes=5000),
        JHostBlockPool(3, str(tmp_path / "j"), 2, capacity_bytes=5000),
    ]
    drops = [[], []]
    for i, pool in enumerate(pools):
        pool.on_drop = drops[i].append
    rng = np.random.default_rng(3)
    for step in range(40):
        h = int(rng.integers(0, 9))
        kind = ("bfloat16", "int8")[step % 2]
        np_b, t_b = _block(kind, step)
        if rng.random() < 0.6:
            pools[0].put(h, t_b)
            pools[1].put(h, np_b)
        else:
            a, b = pools[0].get(h), pools[1].get(h)
            assert (a is None) == (b is None)
    assert (dataclasses.asdict(pools[0].stats)
            == dataclasses.asdict(pools[1].stats))
    assert list(pools[0]._mem) == list(pools[1]._mem)
    assert list(pools[0]._disk) == list(pools[1]._disk)
    assert drops[0] == drops[1]


# ------------------------------ engines ----------------------------------

MC_KW = dict(vocab_size=256)


def _eng_kw(num_blocks):
    return dict(num_blocks=num_blocks, block_size=4, max_model_len=128,
                max_num_batched_tokens=128, prefill_buckets=(128,),
                decode_buckets=(4,), max_num_seqs=4)


@pytest.fixture(scope="module")
def tree():
    engine = JEngine(JModelConfig.tiny(**MC_KW),
                     JEngineConfig(**_eng_kw(64)), seed=0)
    return jax.tree.map(np.asarray, engine.params)


def make_engine(pkg, tree, num_blocks=64, **kw):
    if pkg == "jax":
        return JEngine(JModelConfig.tiny(**MC_KW),
                       JEngineConfig(**_eng_kw(num_blocks), **kw), seed=0)
    mc = ModelConfig.tiny(**MC_KW)
    return InferenceEngine(mc, EngineConfig(**_eng_kw(num_blocks), **kw),
                           params=params_from_numpy(tree, mc, "cpu"),
                           device="cpu")


async def run_request(engine, prompt, rid, n=4):
    cls = JRequest if isinstance(engine, JEngine) else Request
    return [out.token_id async for out in engine.submit(cls(
        request_id=rid, token_ids=list(prompt), max_tokens=n,
        ignore_eos=True))]


async def settle(engine):
    """Wait until the idle drain has offloaded every pending block."""
    for _ in range(400):
        if not engine.kvbm._pending and not engine.scheduler.running:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("offload backlog never drained")


PROMPT_A = list(range(1, 41))                       # 10 blocks
PROMPT_B = list(range(1, 33)) + [60, 61, 62, 63, 64, 65]


async def kvbm_scenario(pkg, tree, disk_dir=None):
    """offload → clear_kv_blocks → onboard, then a shared-prefix prompt and
    filler traffic that evicts G1 under a small pool."""
    kcfg = (JKvbmConfig if pkg == "jax" else KvbmConfig)(
        host_blocks=8 if disk_dir else 64,
        disk_dir=disk_dir, disk_blocks=64 if disk_dir else 0)
    engine = make_engine(pkg, tree, num_blocks=24)
    engine.attach_kvbm(kcfg)
    streams, snaps = [], []
    try:
        for i, prompt in enumerate([PROMPT_A, None, PROMPT_A, PROMPT_B,
                                    [100 + j for j in range(40)],
                                    PROMPT_A]):
            if prompt is None:
                engine.clear_kv_blocks()
                continue
            streams.append(await run_request(engine, prompt, f"r{i}"))
            await settle(engine)
            snaps.append(engine.kvbm.snapshot())
        return (streams, snaps,
                dataclasses.asdict(engine.kvbm.host_pool.stats))
    finally:
        await engine.stop()


@pytest.mark.parametrize("tier", ["host", "disk"])
def test_kvbm_scenario_equals_jax(tree, tier, tmp_path):
    disk = {"host": (None, None),
            "disk": (str(tmp_path / "j"), str(tmp_path / "t"))}[tier]
    want = asyncio.run(kvbm_scenario("jax", tree, disk[0]))
    got = asyncio.run(kvbm_scenario("port", tree, disk[1]))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[1][-1]["onboarded_total"] > 0
    if tier == "disk":
        assert got[2]["spills"] > 0 and got[2]["g3_hits"] > 0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_g4_store_tier_feeds_a_port_engine(tree, writer):
    """An engine of either package writes its offloaded blocks through to
    the store (G4); a fresh port engine with empty local tiers onboards
    them and streams the writer's tokens."""
    async def run():
        server = StoreServer(host="127.0.0.1", port=0)
        await server.start()
        addr = f"127.0.0.1:{server.port}"
        if writer == "jax":
            w_client = await JStoreClient.connect(addr)
            w_remote = JStoreRemoteTier(w_client, namespace="t")
            w_cfg = JKvbmConfig(host_blocks=64)
        else:
            w_client = await StoreClient.connect(addr)
            w_remote = StoreRemoteTier(w_client, namespace="t")
            w_cfg = KvbmConfig(host_blocks=64)
        r_client = await StoreClient.connect(addr)
        try:
            e1 = make_engine(writer, tree)
            e1.attach_kvbm(w_cfg, remote=w_remote)
            first = await run_request(e1, PROMPT_A, "w")
            await settle(e1)
            puts = e1.kvbm.stats.g4_puts
            await e1.stop()
            e2 = make_engine("port", tree)
            e2.attach_kvbm(KvbmConfig(host_blocks=64),
                           remote=StoreRemoteTier(r_client, namespace="t"))
            again = await run_request(e2, PROMPT_A, "r")
            hits = e2.kvbm.stats.g4_hits
            await e2.stop()
            return first, again, puts, hits
        finally:
            await w_client.close()
            await r_client.close()
            await server.stop()

    first, again, puts, hits = asyncio.run(run())
    assert puts >= 10
    assert hits >= 10
    assert again == first


@pytest.mark.parametrize("holder,fetcher", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_peer_g2_onboard(tree, holder, fetcher):
    """Worker A (holder) offloads a prefix to its G2 and advertises it;
    worker B (fetcher) onboards it over the presence plane and the TCP
    fetch, and streams what A streamed — across the packages too."""
    async def run():
        server = StoreServer(host="127.0.0.1", port=0)
        await server.start()
        addr = f"127.0.0.1:{server.port}"
        items = []
        try:
            for wid, pkg in ((1, holder), (2, fetcher)):
                engine = make_engine(pkg, tree)
                if pkg == "jax":
                    manager = engine.attach_kvbm(JKvbmConfig(host_blocks=64))
                    store = await JStoreClient.connect(addr)
                    dist = jdist.DistributedKvbm(manager, store,
                                                 worker_id=wid)
                else:
                    manager = engine.attach_kvbm(KvbmConfig(host_blocks=64))
                    store = await StoreClient.connect(addr)
                    dist = tdist.DistributedKvbm(manager, store,
                                                 worker_id=wid)
                await dist.start()
                items.append((engine, manager, dist, store))
            (ea, ma, da, _), (eb, mb, db, _) = items
            assert da.prefix == db.prefix      # one presence plane
            got_a = await run_request(ea, PROMPT_A[:32], "a")
            await settle(ea)
            for _ in range(200):
                if da.num_published >= 8:
                    break
                await asyncio.sleep(0.01)
            got_b = await run_request(eb, PROMPT_A[:32], "b")
            return got_a, got_b, mb.stats.peer_hits, da.num_served
        finally:
            for engine, _m, dist, store in items:
                await dist.stop()
                await engine.stop()
                await store.close()
            await server.stop()

    got_a, got_b, peer_hits, served = asyncio.run(run())
    assert peer_hits >= 8 and served >= 8
    assert got_b == got_a


@pytest.mark.parametrize("leader", ["port", "jax"])
def test_group_barrier_validates_layout_across_packages(tree, leader):
    async def run():
        server = StoreServer(host="127.0.0.1", port=0)
        await server.start()
        addr = f"127.0.0.1:{server.port}"
        lead_mod = jdist if leader == "jax" else tdist
        lead_cls = JStoreClient if leader == "jax" else StoreClient
        lead_store = await lead_cls.connect(addr)
        good, bad = (await StoreClient.connect(addr),
                     await StoreClient.connect(addr))
        eng = make_engine("port", tree)
        jeng = make_engine("jax", tree)
        try:
            layout = tdist.engine_layout(eng)
            assert layout == jdist.engine_layout(jeng)
            lead = asyncio.create_task(
                lead_mod.KvbmGroup.lead(lead_store, "g1", 1, layout,
                                        timeout_s=20))
            with pytest.raises(RuntimeError, match="layout mismatch"):
                await tdist.KvbmGroup.join(bad, "g1", "w2",
                                           dict(layout, block_size=8),
                                           timeout_s=20)
            assert not lead.done()
            joined = await tdist.KvbmGroup.join(good, "g1", "w1", layout,
                                                timeout_s=20)
            return layout, joined, await lead
        finally:
            await eng.stop()
            await jeng.stop()
            for c in (lead_store, good, bad):
                await c.close()
            await server.stop()

    layout, joined, payloads = asyncio.run(run())
    assert joined == layout
    assert payloads == [layout]
