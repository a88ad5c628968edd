"""Tensor- and expert-parallel serving in the port, held against the JAX
package on the same mesh: ``ModelConfig.tiny()`` (and ``tiny_moe``) in
float32, the JAX parameters carried across by ``params_from_numpy``, each
port rank a process of a gloo world on the CPU (``torch_tp_world.py``).

- ``forward`` and ``logits_fn`` at tp 2 and 4 agree with the JAX
  ``forward`` jitted over mesh ``(1, tp)`` within 1e-5 (both f32, in a
  different summation order); every rank holds the same hidden states and
  the same full logits, and the shard shapes are the layout's.
- Greedy token streams of the port's tensor-parallel engine (rank 0 leads,
  the others replay its plans) equal the JAX engine's on the same mesh for
  plain decode, chunked prefill and ngram spec decode; the followers
  replayed exactly the plans the leader emitted.
- int8 weights: logprobs within 1e-4 of the JAX int8 forward on the same
  mesh and inside ``tests/test_quantized.py``'s int8 budget against the
  unquantized forward.
- ``tiny_moe`` with experts over tp 2: streams on the synchronous loop
  equal the JAX engine's on mesh ``(1, 2)`` (experts over tp, as
  ``tests/test_moe.py``'s expert-parallel step).
- ``load_hf_params_sharded``: each rank's leaves are bitwise equal to
  slicing ``load_hf_params``'s, and to the JAX sharded loader's shards.
"""

import asyncio
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu.engine import model as jm
from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.parallel.layout import make_mesh as jax_make_mesh
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import weights as tweights
from dynamo_tpu_torch.parallel import comm
from dynamo_tpu_torch.parallel.layout import Mesh, SpecLayout, shard_tensor

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402

ATOL = 1e-5
FWD_KW = dict(block_size=4, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(8,), prefill_buckets=(16, 64))
# the mesh-parity engine shape (tests/test_mesh_parity.py): a 96-token
# prompt prefills in three 32-token chunks
ENG_KW = dict(block_size=4, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=32, max_model_len=256,
              decode_buckets=(8,), prefill_buckets=(32,))
DECODE_PROMPT = [int(x) for x in np.random.RandomState(10).randint(1, 500, 12)]
CHUNKED_PROMPT = [int(x) for x in
                  np.random.RandomState(11).randint(1, 500, 96)]
SPEC_PROMPT = [5, 7, 11, 13, 17, 19] * 4


@pytest.fixture(scope="module")
def world2():
    with tw.World(2) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with tw.World(4) as w:
        yield w


@pytest.fixture
def world(request, world2, world4):
    return {2: world2, 4: world4}[request.param]


def numpy_tree(tree):
    """JAX params as numpy leaves (fp8 as uint8 bits)."""
    def leaf(x):
        a = np.asarray(x)
        return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a
    return jax.tree.map(leaf, tree)


def _feed():
    """A ragged prefill batch, then two decode steps with a padding row."""
    rng = np.random.RandomState(0)
    toks = np.zeros((2, 16), np.int32)
    pos = np.full((2, 16), -1, np.int32)
    toks[0, :13] = rng.randint(1, 512, 13)
    pos[0, :13] = np.arange(13)
    toks[1, :5] = rng.randint(1, 512, 5)
    pos[1, :5] = np.arange(5)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :4] = [1, 2, 3, 4]
    tables[1, :2] = [5, 6]
    steps = [(toks, pos, tables)]
    for t in range(2):
        dt = np.array([[rng.randint(1, 512)], [rng.randint(1, 512)], [0]],
                      np.int32)
        dp = np.array([[13 + t], [5 + t], [-1]], np.int32)
        dtab = np.zeros((3, 8), np.int32)
        dtab[0, :4] = [1, 2, 3, 4]
        dtab[1, :2] = [5, 6]
        steps.append((dt, dp, dtab))
    return steps


def jax_forward(tp, params, steps, weight_dtype="bf16"):
    """The JAX forward + logits jitted over mesh (1, tp)."""
    jc = JaxModelConfig.tiny()
    je = JaxEngineConfig(mesh_shape=(1, tp), attention_impl="einsum",
                         weight_dtype=weight_dtype, **FWD_KW)
    mesh = jax_make_mesh((1, tp), jax.devices("cpu"))
    p = jm.shard_params(params, mesh, jc, weight_dtype)
    cache = jm.shard_cache(jm.init_cache(jc, je), mesh, jc)
    fwd = jax.jit(functools.partial(jm.forward, jc, je))
    outs = []
    for toks, pos, tables in steps:
        cache, h = fwd(p, cache, jnp.asarray(toks), jnp.asarray(pos),
                       jnp.asarray(tables))
        outs.append((np.asarray(h), np.asarray(jm.logits_fn(jc, p, h))))
    return outs


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(jax.random.PRNGKey(0), JaxModelConfig.tiny())


@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["tp2", "tp4"])
def test_forward_and_logits_match_jax_mesh(world, jparams):
    tp = world.n
    steps = _feed()
    want = jax_forward(tp, jparams, steps)
    got = world.run(tw.forward_logits, "tiny", numpy_tree(jparams),
                    dict(mesh_shape=(1, tp), **FWD_KW), steps)
    cfg = tcfg.ModelConfig.tiny()
    for outs, shapes in got:
        assert shapes["wq"] == (cfg.num_layers, cfg.hidden_size,
                                cfg.num_heads * cfg.head_dim_ // tp)
        assert shapes["cache_k"][1] == cfg.num_kv_heads // tp
        for (h, logits), (jh, jl), (_, pos, _) in zip(outs, want, steps):
            valid = pos >= 0
            np.testing.assert_allclose(h[valid], jh[valid], rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(logits[valid], jl[valid], rtol=0,
                                       atol=ATOL)
    # every rank ends with the same hidden states and full logits
    for outs, _ in got[1:]:
        for (h, logits), (h0, l0) in zip(outs, got[0][0]):
            np.testing.assert_array_equal(logits, l0)
            np.testing.assert_array_equal(h, h0)


def _logprobs(logits):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


def test_int8_weights_within_the_quantized_budget(world2, jparams):
    """int8 weights at tp 2: logprobs within 1e-4 of the JAX int8 forward
    on mesh (1, 2), and inside test_quantized.py's int8 budget (0.25 nats)
    against the unquantized forward."""
    steps = _feed()[:1]
    qparams = jquant.quantize_params(jparams, "int8")
    want = jax_forward(2, qparams, steps, weight_dtype="int8")
    ref = jax_forward(2, jparams, steps)
    got = world2.run(tw.forward_logits, "tiny", numpy_tree(qparams),
                     dict(mesh_shape=(1, 2), **FWD_KW), steps, "int8")
    valid = steps[0][1] >= 0
    lp = _logprobs(got[0][0][0][1])[valid]
    np.testing.assert_allclose(lp, _logprobs(want[0][1])[valid], rtol=0,
                               atol=1e-4)
    worst = float(np.max(np.abs(lp - _logprobs(ref[0][1])[valid])))
    assert 0.0 < worst <= 0.25


# ------------------------------ engine streams -----------------------------


async def _jax_streams(engine, requests):
    async def one(i, r):
        req = JaxRequest(request_id=f"r{i}", **r)
        return [o.token_id async for o in engine.submit(req)]
    try:
        return await asyncio.gather(*(one(i, r)
                                      for i, r in enumerate(requests)))
    finally:
        await engine.stop()


def _check_replay(got):
    lead = got[0]
    for follower in got[1:]:
        assert follower["replayed"] == lead["emitted"]
        assert follower["all_reduce_calls"] == lead["all_reduce_calls"] > 0


def _served(world, cfg_name, eng_kw, requests):
    tp = world.n
    jc = getattr(JaxModelConfig, cfg_name)()
    jengine = JaxEngine(jc, JaxEngineConfig(mesh_shape=(1, tp), **eng_kw),
                        seed=0, devices=jax.devices("cpu"))
    tree = numpy_tree(jengine.params)
    want = asyncio.run(_jax_streams(jengine, requests))
    got = world.run(tw.serve, cfg_name, tree,
                    dict(mesh_shape=(1, tp), **eng_kw), requests)
    _check_replay(got)
    return want, got[0]


@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["tp2", "tp4"])
def test_decode_and_chunked_prefill_streams_match_jax(world):
    requests = [
        dict(token_ids=DECODE_PROMPT, max_tokens=8, ignore_eos=True),
        dict(token_ids=CHUNKED_PROMPT, max_tokens=6, ignore_eos=True),
    ]
    want, lead = _served(world, "tiny", ENG_KW, requests)
    assert lead["streams"] == want
    assert [len(s) for s in lead["streams"]] == [8, 6]
    assert lead["emitted"]["pp"] >= 4 and lead["emitted"]["w"] > 0


@pytest.mark.parametrize("world", [2, 4], indirect=True, ids=["tp2", "tp4"])
def test_spec_decode_streams_match_jax(world):
    requests = [dict(token_ids=SPEC_PROMPT, max_tokens=16, ignore_eos=True)]
    want, lead = _served(world, "tiny",
                         dict(spec_mode="ngram", spec_k=4, **ENG_KW),
                         requests)
    assert lead["streams"] == want
    assert lead["spec_drafted"] > 0, "spec path never engaged"
    assert lead["emitted"]["sw"] > 0 and lead["emitted"]["sph"] > 0


def test_moe_experts_over_tp_streams_match_jax(world2):
    """tiny_moe, experts over tp 2, the synchronous loop (both engines
    batch alike there, ROADMAP finding c)."""
    requests = [
        dict(token_ids=list(range(1, 13)), max_tokens=6, ignore_eos=True),
        dict(token_ids=list(range(40, 80)), max_tokens=5, ignore_eos=True),
    ]
    want, lead = _served(world2, "tiny_moe",
                         dict(pipeline_depth=1, **ENG_KW), requests)
    assert lead["streams"] == want


def test_unified_step_plans_replay_on_every_rank(world2, jparams):
    """The ``p`` and ``d`` plans (a prefill chunk and a decode batch of the
    unified step, as a pipeline-parallel leader emits them) replay on
    every stage of a pp-2 engine: each rank's K pages are its one layer
    of the one-rank forward's, within 1e-5. An engine without
    ``pp_stages`` has no unified step and refuses them."""
    import torch

    from dynamo_tpu_torch.engine import model as tm
    from dynamo_tpu_torch.engine.weights import params_from_numpy

    steps = _feed()[:2]
    plans = []
    for kind, (toks, pos, tables) in zip("pd", steps):
        B = toks.shape[0]
        last = np.maximum((pos >= 0).sum(1) - 1, 0).astype(np.int32)
        plans.append((kind, {
            "tokens": toks, "positions": pos, "tables": tables,
            "last_idx": last, "temp": np.zeros((B,), np.float32),
            "top_k": np.zeros((B,), np.int32),
            "top_p": np.ones((B,), np.float32),
            "seeds": np.full((B,), -1, np.int32)}))
    got = world2.run(tw.step_plans, "tiny", numpy_tree(jparams),
                     dict(pp_stages=2, **FWD_KW), plans)
    cfg = tcfg.ModelConfig.tiny()
    eng = tcfg.EngineConfig(**FWD_KW)
    params = params_from_numpy(numpy_tree(jparams), cfg, "cpu")
    cache = tm.init_cache(cfg, eng, torch.device("cpu"))
    for toks, pos, tables in steps:
        cache, _ = tm.forward(cfg, eng, params, cache,
                              torch.from_numpy(toks), torch.from_numpy(pos),
                              torch.from_numpy(tables))
    assert cfg.num_layers == 2                  # one layer per stage
    for rank, (k, replayed) in enumerate(got):
        assert replayed == {"p": 1, "d": 1}
        np.testing.assert_allclose(k[1:], cache["k"][rank].numpy()[1:],
                                   rtol=0, atol=ATOL)
    from dynamo_tpu_torch.engine import InferenceEngine
    from dynamo_tpu_torch.parallel.multihost import replay_plan

    one = InferenceEngine(cfg, eng, params=params, device="cpu")
    with pytest.raises(RuntimeError, match="without pp_stages"):
        replay_plan(one, *plans[0])


# ------------------------------ sharded loader -----------------------------


def test_engine_serves_its_shard_of_a_checkpoint(world2, tmp_path):
    """Each rank builds its engine from ``load_hf_params_sharded`` (the
    worker's ``--weights`` path under ``--mesh 1,2``): the engine keeps the
    shard as it is, and the streams equal the JAX engine's on mesh (1, 2)
    with the same weights."""
    requests = [dict(token_ids=DECODE_PROMPT, max_tokens=8,
                     ignore_eos=True)]
    jengine = JaxEngine(JaxModelConfig.tiny(),
                        JaxEngineConfig(mesh_shape=(1, 2), **ENG_KW),
                        seed=0, devices=jax.devices("cpu"))
    tc = tcfg.ModelConfig.tiny()
    tweights.save_hf_params(tmp_path, tweights.params_from_numpy(
        numpy_tree(jengine.params), tc, "cpu"), tc)
    want = asyncio.run(_jax_streams(jengine, requests))
    got = world2.run(tw.serve, "tiny", None,
                     dict(mesh_shape=(1, 2), **ENG_KW), requests, "bf16",
                     str(tmp_path))
    _check_replay(got)
    assert got[0]["streams"] == want



def _assert_bitwise(a, b):
    a = a.contiguous()
    b = b.contiguous()
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _jax_shard(arr, rank):
    """The numpy of the JAX array's shard on device ``rank`` of the
    mesh (addressable shards, device order)."""
    for sh in arr.addressable_shards:
        if sh.device == jax.devices("cpu")[rank]:
            return np.asarray(sh.data)
    raise AssertionError(f"no shard on device {rank}")


@pytest.mark.parametrize("cfg_name,weight_dtype", [
    ("tiny", "bf16"), ("tiny", "int8"), ("tiny_moe", "bf16"),
])
def test_sharded_loader_slices_equal_full_load_and_jax(tmp_path, cfg_name,
                                                       weight_dtype):
    tp = 2
    tc = getattr(tcfg.ModelConfig, cfg_name)()
    jc = getattr(JaxModelConfig, cfg_name)()
    params = tweights.params_from_numpy(
        numpy_tree(jm.init_params(jax.random.PRNGKey(0), jc)), tc, "cpu")
    tweights.save_hf_params(tmp_path, params, tc, n_shards=2)
    full = tweights.load_hf_params(tmp_path, tc, weight_dtype, device="cpu")
    jmesh = jax_make_mesh((1, tp), jax.devices("cpu"))
    jshards = jweights.load_hf_params_sharded(str(tmp_path), jc, jmesh,
                                              weight_dtype)
    for rank in range(tp):
        mesh = Mesh({"dp": 1, "tp": tp}, {"dp": 0, "tp": rank})
        got = tweights.load_hf_params_sharded(tmp_path, tc, mesh,
                                              weight_dtype, device="cpu")
        stats = tweights.last_load_stats
        assert stats["shard"] == (rank, tp)
        assert stats["peak_staging_bytes"] <= max(
            t.numel() * t.element_size()
            for _, t in tweights.hf_tensors(params, tc))
        specs = SpecLayout.for_mesh((1, tp)).param_specs(tc, weight_dtype)

        def check(leaf, ref, sp, jleaf):
            _assert_bitwise(leaf, shard_tensor(ref, sp, mesh))
            want = _jax_shard(jleaf, rank)
            if want.dtype.name == "float8_e4m3fn":
                want = want.view(np.uint8)
            np.testing.assert_array_equal(
                leaf.view(torch.uint8).numpy()
                if leaf.dtype == torch.float8_e4m3fn else leaf.numpy(),
                want)

        def walk(a, r, s, j):
            if isinstance(s, dict):
                for k in s:
                    walk(a[k], r[k], s[k], j[k])
            else:
                check(a, r, s, j)

        walk(got, full, specs, jshards)


def test_nccl_refuses_two_ranks_on_one_device():
    """NCCL wants one device per rank: two ranks on one card under nccl
    raise at init (no silent switch to gloo); gloo carries them."""
    cuda = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="DYNTPU_DIST_BACKEND=gloo"):
        comm.check_backend("nccl", cuda, local_ranks=2, device_count=1)
    comm.check_backend("gloo", cuda, local_ranks=2, device_count=1)
    comm.check_backend("nccl", cuda, local_ranks=2, device_count=2)
    with pytest.raises(ValueError, match="CUDA"):
        comm.check_backend("nccl", torch.device("cpu"), 1, 0)


def test_default_backend_follows_the_device(monkeypatch):
    monkeypatch.delenv(comm.BACKEND_ENV, raising=False)
    assert comm.default_backend(torch.device("cuda", 0)) == "nccl"
    assert comm.default_backend(torch.device("cpu")) == "gloo"
    monkeypatch.setenv(comm.BACKEND_ENV, "gloo")
    assert comm.default_backend(torch.device("cuda", 0)) == "gloo"
