"""The single-rank paths on a multi-rank engine, held against the JAX
package: ``ModelConfig.tiny()`` in float32 (vocab 256), the JAX
parameters carried across by ``params_from_numpy``, each port rank a
process of a gloo world on the CPU (``torch_tp_world.py``; rank 0 leads,
rank 1 replays its plans).

- KV extract on a ``(1, 2)`` and a ``(2, 1)`` world returns the JAX
  payload layout (every KV head, in head order) and equals the JAX
  engine's extract on a ``(1, 2)`` mesh within 1e-5; an int8 payload's
  pages and scales come out in head order; inject then extract round-trips
  bitwise; a stale epoch, and a payload whose shape, block count, dtype
  or keys do not fit, raise on the leader before any plan (the followers
  replay only the ``ki`` plans emitted and never block); the decode
  from the injected KV equals the JAX mesh engine's stream.
- Disaggregated serving across tp: a ``(1, 2)`` prefill engine hands
  its KV to a one-rank decode engine, and a one-rank prefill engine to a
  ``(1, 2)`` decode engine, both over the host relay (a multi-rank engine
  is never registered on the device plane); greedy streams equal the JAX
  engine's aggregated ones.
- The KVBM host tier with prefix demotion, and preemption evacuation (to
  a peer and by spill), on a ``(1, 2)`` engine equal the JAX scenarios
  of ``tests/test_torch_prefix_cache.py`` and
  ``tests/test_torch_preemption.py``.
- ``embed`` on ``(1, 2)`` equals the JAX engine's on the same mesh, and
  on a pp-2 engine the JAX pp engine's, within 1e-5; ``mrp`` (an image
  prompt on ``(1, 2)``) gives the JAX mesh engine's greedy streams, and
  the follower replays every ``mrp`` plan and splices the delivered
  embeddings.
"""

import asyncio
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu_torch.disagg import handlers as th
from dynamo_tpu_torch.disagg.ici import DevicePlane
from dynamo_tpu_torch.engine.config import EngineConfig, ModelConfig
from dynamo_tpu_torch.engine.engine import InferenceEngine
from dynamo_tpu_torch.engine.weights import params_from_numpy

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_preemption as tpre_test  # noqa: E402
import test_torch_prefix_cache as tpc_test  # noqa: E402
import torch_tp_world as tw  # noqa: E402

ATOL = 1e-5
MC_KW = dict(vocab_size=256)
ENG_KW = dict(num_blocks=64, block_size=4, max_model_len=128,
              max_num_batched_tokens=128, prefill_buckets=(128,),
              decode_buckets=(4,), max_num_seqs=4)
PROMPT = [int(x) for x in np.random.RandomState(3).randint(1, 250, 37)]
PROMPTS = [list(range(1, 40)), [int(t) for t in
                                np.random.default_rng(5).integers(1, 250, 29)]]
MESHES = [(1, 2), (2, 1)]


@pytest.fixture(scope="module")
def world2():
    with tw.World(2) as w:
        yield w


@pytest.mark.parametrize("mesh", [(1, 1), (1, 2), (2, 1), (2, 2), (1, 4)])
def test_kv_payload_specs_equal_jax(cpu_devices, mesh):
    """The payload layout (``kv_payload_shardings``): KV heads over tp,
    pages and scales."""
    from dynamo_tpu.parallel.layout import SpecLayout as JaxSpecLayout
    from dynamo_tpu.parallel.layout import kv_payload_shardings
    from dynamo_tpu.parallel.layout import make_mesh as jax_make_mesh
    from dynamo_tpu_torch.parallel.layout import SpecLayout

    jmesh = jax_make_mesh(mesh, cpu_devices)
    keys = ("k", "v", "ks", "vs")
    want = {k: tuple(v.spec)
            for k, v in kv_payload_shardings(jmesh, keys).items()}
    lay = SpecLayout.for_mesh(mesh)
    assert lay.kv_payload_specs(keys) == want
    jlay = JaxSpecLayout.for_mesh(jmesh)
    assert lay.kv_blocks() == tuple(jlay.kv_blocks())
    assert lay.kv_scale_blocks() == tuple(jlay.kv_scale_blocks())


def _jax_engine(mesh=(1, 2), **kw):
    return JaxEngine(JaxModelConfig.tiny(**MC_KW),
                     JaxEngineConfig(mesh_shape=mesh, **dict(ENG_KW, **kw)),
                     seed=0, devices=jax.devices("cpu"))


def _tree(engine):
    return jax.tree.map(np.asarray, engine.params)


async def _jax_kv(engine, prompt, max_tokens):
    """The JAX engine's held prefill, its extract, and the aggregated
    greedy stream of the same prompt."""
    try:
        seq, first = await engine.prefill_held(JaxRequest(
            request_id="held", token_ids=list(prompt), max_tokens=1))
        payload = await engine.extract_kv_blocks(seq.block_table)
        engine.release_held(seq)
        stream = [o.token_id async for o in engine.submit(JaxRequest(
            request_id="agg", token_ids=list(prompt),
            max_tokens=max_tokens, ignore_eos=True))]
        return {k: np.asarray(v) for k, v in payload.items()}, first, stream
    finally:
        await engine.stop()


def _check_plans(got, kinds):
    lead = got[0]
    for follower in got[1:]:
        assert follower["replayed"] == lead["emitted"]
    for kind in kinds:
        assert lead["emitted"].get(kind, 0) > 0, (kind, lead["emitted"])


@pytest.fixture(scope="module")
def jax_kv():
    engine = _jax_engine()
    tree = _tree(engine)
    return tree, asyncio.run(_jax_kv(engine, PROMPT, 6))


@pytest.mark.parametrize("mesh", MESHES, ids=["tp2", "dp2"])
def test_kv_payload_equals_the_jax_mesh_extract(world2, jax_kv, mesh):
    tree, (want, first, stream) = jax_kv
    got = world2.run(tw.mesh_script, MC_KW, tree,
                     dict(mesh_shape=mesh, **ENG_KW), "kv", PROMPT, 6)
    r = got[0]["result"]
    cfg = ModelConfig.tiny(**MC_KW)
    assert sorted(r["payload"]) == ["k", "v"]
    for key, w in want.items():
        assert r["payload"][key].shape == w.shape
        assert w.shape[2] == cfg.num_kv_heads          # every head
        np.testing.assert_allclose(r["payload"][key], w, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(r["back"][key], r["payload"][key])
    assert r["stale"] is not None and "stale" in r["stale"]
    # a payload that does not fit raises on the leader, before its plan
    assert all(m is not None and "does not fit" in m
               for m in r["misfits"].values()), r["misfits"]
    assert r["first"] == first
    assert r["stream"] == stream
    _check_plans(got, ("kx", "ki"))
    # two extracts, and one inject: the stale and the ill-fitting ones
    # emitted no plan, and the follower replayed what was emitted
    assert got[0]["emitted"]["kx"] == 2 and got[0]["emitted"]["ki"] == 1
    lead, fol = got[0]["stats"], got[1]["stats"]
    assert lead["kv_deliver_calls"] == fol["kv_deliver_calls"] == 2
    if mesh == (1, 2):
        assert lead["kv_gather_calls"] == fol["kv_gather_calls"] == 4
    else:   # one head group: no gather, the leader's heads are all heads
        assert lead["kv_gather_calls"] == fol["kv_gather_calls"] == 0


def test_int8_payload_pages_and_scales_in_head_order(world2):
    engine = _jax_engine(kv_dtype="int8")
    tree = _tree(engine)
    want, first, stream = asyncio.run(_jax_kv(engine, PROMPT, 6))
    got = world2.run(tw.mesh_script, MC_KW, tree,
                     dict(mesh_shape=(1, 2), kv_dtype="int8", **ENG_KW),
                     "kv", PROMPT, 6)
    r = got[0]["result"]
    assert sorted(r["payload"]) == ["k", "ks", "v", "vs"]
    for key in ("ks", "vs"):
        np.testing.assert_allclose(r["payload"][key], want[key], rtol=1e-5,
                                   atol=1e-7)
    for key in ("k", "v"):
        assert r["payload"][key].dtype == np.int8
        diff = np.abs(r["payload"][key].astype(np.int32)
                      - want[key].astype(np.int32))
        assert diff.max() <= 1, key
    for key in r["payload"]:
        np.testing.assert_array_equal(r["back"][key], r["payload"][key])
    assert r["stream"] == stream


@pytest.fixture(scope="module")
def disagg_reference():
    """The JAX engine's aggregated greedy streams of PROMPTS (one
    device) and its parameters."""
    engine = JaxEngine(JaxModelConfig.tiny(**MC_KW),
                       JaxEngineConfig(**ENG_KW), seed=0)
    tree = _tree(engine)

    async def run():
        try:
            return [[o.token_id async for o in engine.submit(JaxRequest(
                request_id=f"r{i}", token_ids=p, max_tokens=8,
                ignore_eos=True))] for i, p in enumerate(PROMPTS)]
        finally:
            await engine.stop()
    return tree, asyncio.run(run())


@pytest.mark.parametrize("role", ["prefill", "decode"],
                         ids=["tp2_prefill_to_one_rank",
                              "one_rank_prefill_to_tp2"])
def test_cross_tp_handoff_streams_equal_jax(world2, disagg_reference, role):
    """The JAX package's ``test_device_transfer_cross_tp`` moves KV
    between meshes of different tp; here between a ``(1, 2)`` engine and
    a one-rank engine, by the relay: the multi-rank side is never on the
    device plane (the decode handler does not register it, the prefill
    handler does not gather over it, and the plane refuses it)."""
    tree, want = disagg_reference
    got = world2.run(tw.mesh_script, MC_KW, tree,
                     dict(mesh_shape=(1, 2), **ENG_KW), "disagg", role,
                     PROMPTS, {"max_tokens": 8, "ignore_eos": True})
    r = got[0]["result"]
    n = len(PROMPTS)
    assert r["streams"] == want
    assert r["counts"] == (n, 0, 0, n)           # remote, by the relay
    assert r["decode_registered"] == (role == "prefill")
    assert "never the device plane" in r["refused"]
    _check_plans(got, ("kx",) if role == "prefill" else ("ki",))


def test_kvbm_tier_and_prefix_demotion_equal_jax(world2):
    jengine = JaxEngine(JaxModelConfig.tiny(**tpc_test.MC_KW),
                        JaxEngineConfig(**tpc_test.ENG_KW), seed=0)
    tree = _tree(jengine)
    asyncio.run(jengine.stop())
    want = asyncio.run(tpc_test.prefix_scenario("jax", tree, True))
    got = world2.run(tw.mesh_script, tpc_test.MC_KW, tree,
                     dict(mesh_shape=(1, 2), **tpc_test.ENG_KW),
                     "kvbm_prefix")
    names = ("streams", "snapshots", "index", "demoted", "kvbm")
    for name, g, w in zip(names, got[0]["result"], want):
        assert g == w, name
    assert sum(want[3]) > 0 and want[4]["onboarded_total"] > 0
    _check_plans(got, ("kx", "ki"))


@pytest.mark.parametrize("mode", ["peer", "spill"])
def test_evacuation_from_a_mesh_equals_jax(world2, mode):
    jengine = JaxEngine(JaxModelConfig.tiny(**tpre_test.MC_KW),
                        JaxEngineConfig(**tpre_test.ENG_KW), seed=0)
    tree = _tree(jengine)
    asyncio.run(jengine.stop())
    want = asyncio.run(tpre_test.scenario("jax", tree, mode))
    got = world2.run(tw.mesh_script, tpre_test.MC_KW, tree,
                     dict(mesh_shape=(1, 2), **tpre_test.ENG_KW), "evac",
                     mode, tpre_test.PROMPT, 8)
    r = got[0]["result"]
    assert r["reason"] == want["reason"] == "evacuated"
    assert r["stream"] == r["want"] == want["stream"]
    assert r["mode"] == mode and r["moved"]
    assert r["src_running"] == 0
    _check_plans(got, ("kx",))


EMBED_BATCH = [[5, 9, 200, 17, 3], list(range(1, 40)), [42] * 12]


def test_embed_on_a_tp_mesh_equals_jax(world2):
    engine = _jax_engine()
    tree = _tree(engine)
    want = np.asarray(asyncio.run(engine.embed(EMBED_BATCH)), np.float32)
    asyncio.run(engine.stop())
    got = world2.run(tw.mesh_script, MC_KW, tree,
                     dict(mesh_shape=(1, 2), **ENG_KW), "embed", EMBED_BATCH)
    np.testing.assert_allclose(got[0]["result"], want, rtol=0, atol=ATOL)
    _check_plans(got, ("emb",))
    # one plan per (B, T) group: T 8, 64 and 16
    assert got[0]["emitted"]["emb"] == 3
    assert got[1]["stats"]["all_reduce_calls"] > 0


def test_embed_on_a_pp_engine_equals_jax(world2):
    """The JAX pp engine embeds with a mesh-less encode fn over its whole
    tree; the port's stages run the encode together (stage 0 embeds, the
    hidden state hops, the last stage pools and broadcasts)."""
    cfg = JaxModelConfig.tiny(**MC_KW)
    engine = JaxEngine(cfg, JaxEngineConfig(pp_stages=2, **ENG_KW), seed=0,
                       devices=jax.devices("cpu")[:2])
    tree = _tree(engine)
    want = np.asarray(asyncio.run(engine.embed(EMBED_BATCH)), np.float32)
    asyncio.run(engine.stop())
    got = world2.run(tw.mesh_script, MC_KW, tree,
                     dict(pp_stages=2, **ENG_KW), "embed", EMBED_BATCH)
    np.testing.assert_allclose(got[0]["result"], want, rtol=0, atol=ATOL)
    _check_plans(got, ("emb",))
    for r in got:
        # one hop and one broadcast of the pooled vectors per group
        assert r["stats"]["ppermute_calls"] == 3
        assert r["stats"]["broadcast_calls"] == 3


N_IMG = 16


def _mm_requests():
    """Two image prompts (an image at row 10, and one at row 0 of a
    short prompt), as ``Request`` fields."""
    rng = np.random.RandomState(7)
    out = []
    for at, tail in ((10, 20), (0, 6)):
        text = rng.randint(1, 250, at).tolist()
        after = rng.randint(1, 250, tail).tolist()
        prompt = text + [0] * N_IMG + after
        hash_ids = text + [0x80000000 | (977 * (at + 1) + j)
                           for j in range(N_IMG)] + after
        out.append(dict(
            token_ids=prompt, max_tokens=6, temperature=0.0,
            ignore_eos=True, mm_positions=list(range(at, at + N_IMG)),
            mm_embeddings=rng.randn(N_IMG, 64).astype(np.float32),
            mm_hash_token_ids=hash_ids))
    return out


def test_multimodal_prefill_on_a_mesh_equals_jax(world2):
    engine = _jax_engine(max_num_batched_tokens=32, prefill_buckets=(32,))
    tree = _tree(engine)
    requests = _mm_requests()

    async def jax_streams():
        try:
            return [[o.token_id async for o in engine.submit(
                JaxRequest(request_id=f"m{i}", **r))]
                for i, r in enumerate(requests)]
        finally:
            await engine.stop()
    want = asyncio.run(jax_streams())
    got = world2.run(tw.mesh_script, MC_KW, tree,
                     dict(mesh_shape=(1, 2), **dict(
                         ENG_KW, max_num_batched_tokens=32,
                         prefill_buckets=(32,))), "mm", requests)
    r = got[0]["result"]
    assert r["streams"] == want
    _check_plans(got, ("mrp",))
    # the first image spans rows 10..25 of a 46-token prompt in 32-token
    # chunks: one mrp chunk; the second one chunk too
    assert got[0]["emitted"]["mrp"] == r["mm_prefills"] == 2
    assert got[1]["mm_prefills"] == 2
    assert got[0]["stats"]["mm_deliver_calls"] == 2
    assert got[0]["stats"]["mm_deliver_bytes"] == 2 * 32 * 64 * 4


def test_a_multi_rank_engine_is_never_on_the_device_plane():
    """The plane refuses to register or move a multi-rank engine (a rank
    of a world of two, as a ``(1, 2)`` or ``(2, 1)`` rank holds), and a
    decode handler over one leaves it off the plane."""
    mc = ModelConfig.tiny(**MC_KW)
    solo = InferenceEngine(mc, EngineConfig(**ENG_KW), device="cpu")
    ranked = InferenceEngine(mc, EngineConfig(**ENG_KW),
                             params=params_from_numpy(
                                 _tree(JaxEngine(JaxModelConfig.tiny(**MC_KW),
                                                 JaxEngineConfig(**ENG_KW),
                                                 seed=0)), mc, "cpu"),
                             device="cpu")
    ranked.world = 2
    plane = DevicePlane()
    with pytest.raises(ValueError, match="never the device plane"):
        plane.register("x", ranked)
    plane.register("solo", solo)
    for src, dst in ((ranked, solo), (solo, ranked)):
        with pytest.raises(ValueError, match="multi-rank engine"):
            asyncio.run(plane.transfer(src, [1], dst, [2]))
    dh = th.DecodeHandler(ranked, plane=plane)
    assert dh.plane_id is None
    dh_solo = th.DecodeHandler(solo, plane=plane)
    assert plane.get(dh_solo.plane_id) is solo
    dh_solo.close()
