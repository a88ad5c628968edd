"""Sequence-parallel (ring) prefill and data-parallel rows in the port,
held against the JAX package on the same ``(dp, tp)`` mesh, mirroring
``tests/test_sp_prefill.py`` and ``tests/test_mesh_parity.py``:
``ModelConfig.tiny()`` (and ``tiny_moe``) in float32, the JAX parameters
carried across by ``params_from_numpy``, each port rank a process of a
gloo world on the CPU (``torch_tp_world.py``).

- The sp forward's hidden states and logits (a 50-token prompt in a
  64-token chunk, then a decode step over the cache it wrote) are within
  1e-5 of the JAX ``forward`` with ``ring_mesh`` on meshes (2, 1), (4, 1),
  (2, 2), (1, 2), (1, 2, 2) and (2, 2, 1), also when a mesh of another
  shape was made after the engine's in the same ranks; each rank runs
  T/(dp*fsdp) rows of the sp chunk (its seq column's share).
- Greedy streams of a 96-token prompt (threshold 64, budget 32) equal the
  JAX engine's on that mesh and the one-device chunked run, with one sp
  prefill on every rank and every follower replaying the one ``rsp``
  plan the leader emitted.
- Short prompts stay on the chunked path; a prefix-cache hit does not take
  the sp path (streams unchanged).
- int8 and fp8 KV: after the sp prefill a decode step's logprobs are
  within ``tests/test_quantized.py``'s budgets of the unquantized run, and
  agree with the JAX package's.

The dense dp rows, MoE with sp and the replay of several ``rsp`` plans
are in ``tests/test_torch_dp_serving.py``.
"""

import asyncio
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu.engine import model as jm
from dynamo_tpu.parallel.layout import make_mesh as jax_make_mesh

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402

ATOL = 1e-5
MESHES = [(2, 1), (4, 1), (2, 2), (1, 2), (1, 2, 2), (2, 2, 1)]
MESH_IDS = ["2x1", "4x1", "2x2", "1x2", "1x2x2", "2x2x1"]
FWD_KW = dict(block_size=4, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(8,), prefill_buckets=(16, 64))
# tests/test_sp_prefill.py's engine: a 96-token prompt is 3x the budget
ENG_KW = dict(block_size=4, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=32, max_model_len=256,
              decode_buckets=(8,), prefill_buckets=(32,))
SP = 64
SP_PROMPT = [int(x) for x in np.random.RandomState(0).randint(1, 500, 96)]
SP_PROMPT2 = [int(x) for x in np.random.RandomState(1).randint(1, 500, 80)]
SHORT_PROMPT = [int(x) for x in np.random.RandomState(2).randint(1, 500, 20)]
DECODE_PROMPT = [int(x) for x in np.random.RandomState(10).randint(1, 500, 12)]
LOGPROB_BUDGET = {"int8": 0.25, "fp8": 0.80}   # tests/test_quantized.py


def _req(prompt, n=6):
    return dict(token_ids=prompt, max_tokens=n, temperature=0.0,
                ignore_eos=True)


@pytest.fixture(scope="module")
def world2():
    with tw.World(2) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with tw.World(4) as w:
        yield w


def _world(shape, world2, world4):
    return {2: world2, 4: world4}[int(np.prod(shape))]


def _seq(shape):
    """The ranks an sp chunk splits over: dp * fsdp (the seq column)."""
    return int(np.prod(shape[:-1]))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


async def _jax_streams(engine, requests, sequential=True):
    async def one(i, r):
        req = JaxRequest(request_id=f"r{i}", **r)
        return [o.token_id async for o in engine.submit(req)]
    try:
        if sequential:
            return [await one(i, r) for i, r in enumerate(requests)]
        return await asyncio.gather(*(one(i, r)
                                      for i, r in enumerate(requests)))
    finally:
        await engine.stop()


def _jax_engine(cfg_name="tiny", shape=(1, 1), **kw):
    devices = jax.devices("cpu")
    if shape == (1, 1):
        devices = devices[:1]
    return JaxEngine(getattr(JaxModelConfig, cfg_name)(),
                     JaxEngineConfig(mesh_shape=shape, **{**ENG_KW, **kw}),
                     seed=0, devices=devices)


@pytest.fixture(scope="module")
def one_device():
    """The one-device chunked run (no sp) of every prompt, one at a time,
    and the weights every engine here shares (seed 0)."""
    engine = _jax_engine()
    tree = numpy_tree(engine.params)
    prompts = {"sp": SP_PROMPT, "sp2": SP_PROMPT2, "short": SHORT_PROMPT}
    streams = asyncio.run(_jax_streams(engine, [_req(p) for p in
                                                prompts.values()]))
    assert engine.num_sp_prefills == 0
    return tree, dict(zip(prompts, streams))


def _check_ranks(got, n_sp):
    """Every rank made ``n_sp`` sp prefills; every follower replayed
    exactly what the leader emitted."""
    lead = got[0]
    assert lead["emitted"].get("rsp", 0) == n_sp
    for r in got:
        assert r["sp_prefills"] == n_sp
    for follower in got[1:]:
        assert follower["replayed"] == lead["emitted"]


# ------------------------------ forward ------------------------------------


def _sp_feed():
    """A 50-token prompt in one 64-token sp chunk, then one decode step
    over the cache it wrote."""
    rng = np.random.RandomState(0)
    toks = np.zeros((1, 64), np.int32)
    pos = np.full((1, 64), -1, np.int32)
    toks[0, :50] = rng.randint(1, 512, 50)
    pos[0, :50] = np.arange(50)
    tables = np.zeros((1, 16), np.int32)
    tables[0, :13] = np.arange(1, 14)
    dt = np.array([[rng.randint(1, 512)]], np.int32)
    return [(toks, pos, tables, True), (dt, np.array([[50]], np.int32),
                                        tables, False)]


def jax_sp_forward(shape, params, steps, kv_dtype="bf16"):
    """The JAX forward + logits jitted on mesh ``shape``: sp steps with
    ``ring_mesh`` (the engine's sp prefill), the others dense."""
    jc = JaxModelConfig.tiny()
    je = JaxEngineConfig(mesh_shape=shape, attention_impl="einsum",
                         kv_dtype=kv_dtype, **FWD_KW)
    mesh = jax_make_mesh(shape, jax.devices("cpu"))
    p = jm.shard_params(params, mesh, jc)
    cache = jm.shard_cache(jm.init_cache(jc, je), mesh, jc, kv_dtype)
    fwd = {sp: jax.jit(functools.partial(
        jm.forward, jc, je, mesh=mesh, ring_mesh=mesh if sp else None))
        for sp in (True, False)}
    outs = []
    for toks, pos, tables, sp in steps:
        cache, h = fwd[sp](p, cache, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(tables))
        outs.append((np.asarray(h), np.asarray(jm.logits_fn(jc, p, h))))
    return outs


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(jax.random.PRNGKey(0), JaxModelConfig.tiny())


@pytest.mark.parametrize(
    "shape,other", [(m, None) for m in MESHES] + [((2, 1), (1, 2)),
                                                  ((1, 2), (2, 1))],
    ids=MESH_IDS + ["2x1_after_1x2", "1x2_after_2x1"])
def test_sp_forward_matches_jax_mesh(shape, other, world2, world4, jparams):
    """With ``other``, a mesh of that shape is made in the ranks after the
    engine's (a second engine in the process would make one): the
    forward's collectives stay on its own tp row and dp column."""
    steps = _sp_feed()
    want = jax_sp_forward(shape, jparams, steps)
    got = _world(shape, world2, world4).run(
        tw.forward_logits, "tiny", numpy_tree(jparams),
        dict(mesh_shape=shape, **FWD_KW), steps, "bf16", other)
    for _, shapes in got:   # the sp chunk's rows per rank, then decode's 1
        assert shapes["tl"] == [64 // _seq(shape), 1]
    for outs, _ in got:
        for (h, logits), (jh, jl), (_, pos, _, _) in zip(outs, want, steps):
            valid = pos >= 0
            np.testing.assert_allclose(h[valid], jh[valid], rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(logits[valid], jl[valid], rtol=0,
                                       atol=ATOL)
    for outs, _ in got[1:]:             # every rank: the same logits
        for (_, logits), (_, l0) in zip(outs, got[0][0]):
            np.testing.assert_array_equal(logits, l0)


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_sp_prefill_step_samples_as_jax(shape, world2, world4, jparams):
    """``make_sp_prefill_fn`` (the sp unified step) samples the JAX
    package's ``make_sp_prefill_fn`` token (greedy) on every rank, for a
    last row owned by either dp row."""
    toks, pos, tables, _ = _sp_feed()[0]
    jc = JaxModelConfig.tiny()
    je = JaxEngineConfig(mesh_shape=shape, attention_impl="einsum",
                         **FWD_KW)
    mesh = jax_make_mesh(shape, jax.devices("cpu"))
    step = jm.make_sp_prefill_fn(jc, je, mesh)
    for last in (49, 20):
        p = pos.copy()
        p[0, last + 1:] = -1
        _, want = step(
            jm.shard_params(jparams, mesh, jc),
            jm.shard_cache(jm.init_cache(jc, je), mesh, jc),
            jnp.asarray(toks), jnp.asarray(p), jnp.asarray(tables),
            jnp.asarray([last], jnp.int32), jax.random.PRNGKey(0),
            jnp.zeros(1), jnp.zeros(1, jnp.int32), jnp.ones(1),
            jnp.full((1,), -1, jnp.int32))
        got = _world(shape, world2, world4).run(
            tw.sp_step_sample, "tiny", numpy_tree(jparams),
            dict(mesh_shape=shape, **FWD_KW), toks, p, tables,
            np.array([last], np.int32))
        assert got == [[int(np.asarray(want)[0])]] * len(got)


def _logprobs(logits):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8"])
def test_quantized_kv_after_sp_prefill_within_budget(kv_dtype, world2,
                                                     jparams):
    """The sp prefill writes 1-byte pages (quantized after the gather);
    the decode step that reads them is within the JAX package's
    quantized-KV logprob budget of the unquantized run, and agrees with
    the JAX package's quantized run on the same mesh."""
    shape = (2, 1)
    steps = _sp_feed()
    tree = numpy_tree(jparams)
    got = world2.run(tw.forward_logits, "tiny", tree,
                     dict(mesh_shape=shape, kv_dtype=kv_dtype, **FWD_KW),
                     steps)
    ref = world2.run(tw.forward_logits, "tiny", tree,
                     dict(mesh_shape=shape, **FWD_KW), steps)
    want = jax_sp_forward(shape, jparams, steps, kv_dtype)
    lp = _logprobs(got[0][0][1][1])
    worst = float(np.max(np.abs(lp - _logprobs(ref[0][0][1][1]))))
    assert 0.0 < worst <= LOGPROB_BUDGET[kv_dtype]
    np.testing.assert_allclose(lp, _logprobs(want[1][1]), rtol=0, atol=1e-3)
    # the prefill itself attends over the unquantized K/V, as in JAX
    np.testing.assert_allclose(got[0][0][0][1][0, :50],
                               ref[0][0][0][1][0, :50], rtol=0, atol=0)


# ------------------------------ engine -------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sp_streams_match_jax_mesh_and_one_device(shape, world2, world4,
                                                  one_device):
    tree, ref = one_device
    jengine = _jax_engine(shape=shape, sp_prefill_threshold=SP)
    want = asyncio.run(_jax_streams(jengine, [_req(SP_PROMPT)]))
    assert jengine.num_sp_prefills == 1
    got = _world(shape, world2, world4).run(
        tw.serve, "tiny", tree,
        dict(mesh_shape=shape, sp_prefill_threshold=SP, **ENG_KW),
        [_req(SP_PROMPT)])
    _check_ranks(got, 1)
    assert got[0]["streams"] == want == [ref["sp"]]
    layers = JaxModelConfig.tiny().num_layers
    for r in got:   # K and V hop dp*fsdp - 1 times per layer
        assert r["ppermute_calls"] == 2 * (_seq(shape) - 1) * layers


def test_short_prompts_stay_on_the_chunked_path(world2, one_device):
    tree, ref = one_device
    got = world2.run(tw.serve, "tiny", tree,
                     dict(mesh_shape=(2, 1), sp_prefill_threshold=SP,
                          **ENG_KW), [_req(SHORT_PROMPT)])
    _check_ranks(got, 0)
    assert got[0]["emitted"]["pp"] == 1
    assert got[0]["streams"] == [ref["short"]]


def test_prefix_cache_hit_does_not_take_the_sp_path(world2, one_device):
    """The same long prompt twice: the second hits the prefix cache, its
    remaining chunk starts mid-prompt, so it is chunked — one sp prefill
    in all, and the same stream."""
    tree, ref = one_device
    got = world2.run(tw.serve, "tiny", tree,
                     dict(mesh_shape=(2, 1), sp_prefill_threshold=SP,
                          **ENG_KW), [_req(SP_PROMPT)] * 2, "bf16", None,
                     True)
    _check_ranks(got, 1)
    assert got[0]["streams"] == [ref["sp"]] * 2
