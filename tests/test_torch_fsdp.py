"""The 3-D ``(dp, fsdp, tp)`` serving mesh in the port, held against the
JAX package on the same mesh: ``ModelConfig.tiny()`` (and ``tiny_moe``) in
float32, the JAX parameters carried across by ``params_from_numpy``, each
port rank a process of a gloo world on the CPU (``torch_tp_world.py``).

- The spec table, and every rank's slice of every leaf, equal the JAX
  ``SpecLayout`` and the JAX addressable shards on meshes (1, 2, 1),
  (1, 2, 2) and (2, 2, 1), with bf16 and int8 weights.
- ``forward``'s hidden states and logits on those meshes are within 1e-5
  of the JAX ``forward`` jitted on the same mesh, and bitwise equal to the
  port's ``(1, tp)`` mesh: each rank stores its fsdp slices and gathers a
  layer's weights whole just before the layer (the ``(1, tp)`` slices,
  exact copies), so it runs the ``(1, tp)`` arithmetic. int8 weights:
  logprobs within 1e-4 of JAX's int8 forward on the mesh, inside
  ``tests/test_quantized.py``'s int8 budget, and bitwise the ``(1, tp)``
  mesh's.
- A KV extract on (1, 2, 2) equals the JAX mesh engine's payload, joined
  on the leader's tp row alone; inject round-trips it.
- ``load_hf_params_sharded`` on each rank of a 3-D mesh equals slicing
  the full load, and the JAX sharded loader's shards.
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
from dynamo_tpu.engine import config as jcfg
from dynamo_tpu.engine import model as jm
from dynamo_tpu.engine import quant as jquant
from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.parallel.layout import SpecLayout as JaxSpecLayout
from dynamo_tpu.parallel.layout import make_mesh as jax_make_mesh
from dynamo_tpu_torch.engine import config as tcfg
from dynamo_tpu_torch.engine import weights as tweights
from dynamo_tpu_torch.parallel import layout
from dynamo_tpu_torch.parallel.layout import Mesh, SpecLayout, shard_tensor

sys.path.insert(0, str(Path(__file__).parent))
import test_torch_layout as tlayout  # noqa: E402
import torch_tp_world as tw  # noqa: E402

ATOL = 1e-5
MESHES = [(1, 2, 1), (1, 2, 2), (2, 2, 1)]
IDS = ["1x2x1", "1x2x2", "2x2x1"]
FWD_KW = dict(block_size=4, num_blocks=64, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(8,), prefill_buckets=(16, 64))
MC_KW = dict(vocab_size=256)
MESH_ENG_KW = dict(num_blocks=64, block_size=4, max_model_len=128,
                   max_num_batched_tokens=128, prefill_buckets=(128,),
                   decode_buckets=(4,), max_num_seqs=4)
KV_PROMPT = [int(x) for x in np.random.RandomState(3).randint(1, 250, 37)]


@pytest.fixture(scope="module")
def world2():
    with tw.World(2) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with tw.World(4) as w:
        yield w


def _world(shape, world2, world4):
    """The world of ``shape``'s ranks (a one-rank mesh runs on each rank
    of the world of 2 alone)."""
    return {1: world2, 2: world2, 4: world4}[int(np.prod(shape))]


def _tp_mesh(shape):
    """The ``(1, tp)`` mesh whose arithmetic a 3-D mesh repeats."""
    return (1, shape[-1])


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jparams():
    return jm.init_params(jax.random.PRNGKey(0), JaxModelConfig.tiny())


# ------------------------------ the layout ---------------------------------


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
@pytest.mark.parametrize("model", ["tiny", "tiny_moe", "llama3_1b"])
def test_spec_table_and_rank_slices_equal_jax(cpu_devices, model, shape,
                                               weight_dtype):
    """Every leaf's spec is the JAX table's, and every rank's index range
    of every leaf is the JAX addressable shard's on the device JAX's
    ``make_mesh`` puts at the rank's coordinate (rank order)."""
    jmesh = jax_make_mesh(shape, cpu_devices)
    jlay = JaxSpecLayout.for_mesh(jmesh)
    lay = SpecLayout.for_mesh(shape)
    assert (lay.dp, lay.fsdp, lay.tp, lay.ep) == (
        jlay.dp, jlay.fsdp, jlay.tp, jlay.ep)
    assert lay.fsdp == "fsdp"
    jc = getattr(jcfg.ModelConfig, model)()
    tc = getattr(tcfg.ModelConfig, model)()
    specs = tlayout._flat(lay.param_specs(tc, weight_dtype))
    assert specs == tlayout._flat(jax.tree.map(
        tuple, jlay.param_specs(jc, weight_dtype), is_leaf=tlayout._is_spec))
    assert specs["/layers/wq" + ("/q" if weight_dtype == "int8" else "")] \
        == (None, "fsdp", "tp" if shape[-1] > 1 else None)
    jshard = tlayout._flat(jlay.param_shardings(jmesh, jc, weight_dtype))
    leaves = tlayout._flat(tlayout._meta_tree(tc, weight_dtype))
    dp, fs, tp = shape
    for rank in range(dp * fs * tp):
        coords = {"dp": rank // (fs * tp), "fsdp": (rank // tp) % fs,
                  "tp": rank % tp}
        mesh = Mesh({"dp": dp, "fsdp": fs, "tp": tp}, coords)
        dev = cpu_devices[rank]
        for path, t in leaves.items():
            idx = jshard[path].addressable_devices_indices_map(
                tuple(t.shape))[dev]
            want = [(s.start or 0, n if s.stop is None else s.stop)
                    for s, n in zip(idx, t.shape)]
            got = [layout.shard_range(n, ax, mesh)
                   for n, ax in zip(t.shape, specs[path])]
            assert got == want, (path, rank)


# ------------------------------ forward ------------------------------------


def jax_forward(shape, params, steps, weight_dtype="bf16"):
    """The JAX forward + logits jitted over mesh ``shape``."""
    jc = JaxModelConfig.tiny()
    je = JaxEngineConfig(mesh_shape=shape, attention_impl="einsum",
                         weight_dtype=weight_dtype, **FWD_KW)
    mesh = jax_make_mesh(shape, jax.devices("cpu"))
    p = jm.shard_params(params, mesh, jc, weight_dtype)
    cache = jm.shard_cache(jm.init_cache(jc, je), mesh, jc)
    fwd = jax.jit(functools.partial(jm.forward, jc, je))
    outs = []
    for toks, pos, tables in steps:
        cache, h = fwd(p, cache, jnp.asarray(toks), jnp.asarray(pos),
                       jnp.asarray(tables))
        outs.append((np.asarray(h), np.asarray(jm.logits_fn(jc, p, h))))
    return outs


def _feed():
    """A ragged prefill batch, then two decode steps with a padding row
    (``tests/test_torch_tensor_parallel.py``'s)."""
    sys.path.insert(0, str(Path(__file__).parent))
    import test_torch_tensor_parallel as ttp

    return ttp._feed()


def _assert_same_run(got, ref):
    """Every rank's hidden states and logits bitwise the reference
    rank's."""
    for outs, _ in got:
        for (h, logits), (rh, rl) in zip(outs, ref[0][0]):
            np.testing.assert_array_equal(h, rh)
            np.testing.assert_array_equal(logits, rl)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_forward_matches_jax_and_the_tp_mesh_bitwise(shape, world2, world4,
                                                      jparams):
    steps = _feed()
    want = jax_forward(shape, jparams, steps)
    world = _world(shape, world2, world4)
    tree = numpy_tree(jparams)
    got = world.run(tw.forward_logits, "tiny", tree,
                    dict(mesh_shape=shape, **FWD_KW), steps)
    ref = _world(_tp_mesh(shape), world2, world4).run(
        tw.forward_logits, "tiny", tree,
        dict(mesh_shape=_tp_mesh(shape), **FWD_KW), steps)
    cfg = tcfg.ModelConfig.tiny()
    fs, tp = shape[1], shape[2]
    for outs, shapes in got:
        # each rank stores D / fsdp of the column leaf's contraction dim
        assert shapes["wq"] == (cfg.num_layers, cfg.hidden_size // fs,
                                cfg.num_heads * cfg.head_dim_ // tp)
        assert shapes["cache_k"][1] == cfg.num_kv_heads // tp
        for (h, logits), (jh, jl), (_, pos, _) in zip(outs, want, steps):
            valid = pos >= 0
            np.testing.assert_allclose(h[valid], jh[valid], rtol=0,
                                       atol=ATOL)
            np.testing.assert_allclose(logits[valid], jl[valid], rtol=0,
                                       atol=ATOL)
    _assert_same_run(got, ref)


def _logprobs(logits):
    return np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 2, 2)],
                         ids=["1x2x1", "1x2x2"])
def test_int8_weights_within_the_quantized_budget(shape, world2, world4,
                                                  jparams):
    """int8 weights: the column leaves' scales are amaxes over the whole
    contraction dim (quantized before sharding, as JAX does), the gathered
    weights are the ``(1, tp)`` mesh's, and the logprobs are within 1e-4
    of the JAX int8 forward on the mesh and inside the int8 budget (0.25
    nats) against the unquantized forward."""
    steps = _feed()[:1]
    qparams = jquant.quantize_params(jparams, "int8")
    want = jax_forward(shape, qparams, steps, weight_dtype="int8")
    ref = jax_forward(shape, jparams, steps)
    world = _world(shape, world2, world4)
    tree = numpy_tree(qparams)
    got = world.run(tw.forward_logits, "tiny", tree,
                    dict(mesh_shape=shape, **FWD_KW), steps, "int8")
    tp_run = _world(_tp_mesh(shape), world2, world4).run(
        tw.forward_logits, "tiny", tree,
        dict(mesh_shape=_tp_mesh(shape), **FWD_KW), steps, "int8")
    _assert_same_run(got, tp_run)
    valid = steps[0][1] >= 0
    lp = _logprobs(got[0][0][0][1])[valid]
    np.testing.assert_allclose(lp, _logprobs(want[0][1])[valid], rtol=0,
                               atol=1e-4)
    worst = float(np.max(np.abs(lp - _logprobs(ref[0][1])[valid])))
    assert 0.0 < worst <= 0.25


# ------------------------------ KV movement --------------------------------


def test_kv_extract_on_1x2x2_equals_the_jax_mesh_payload(world4):
    sys.path.insert(0, str(Path(__file__).parent))
    import test_torch_mesh_paths as tmp

    shape = (1, 2, 2)
    engine = JaxEngine(JaxModelConfig.tiny(**MC_KW),
                       JaxEngineConfig(mesh_shape=shape, **MESH_ENG_KW),
                       seed=0, devices=jax.devices("cpu"))
    tree = numpy_tree(engine.params)
    want, first, stream = asyncio.run(tmp._jax_kv(engine, KV_PROMPT, 6))
    got = world4.run(tw.mesh_script, MC_KW, tree,
                     dict(mesh_shape=shape, **MESH_ENG_KW), "kv", KV_PROMPT,
                     6)
    r = got[0]["result"]
    cfg = tcfg.ModelConfig.tiny(**MC_KW)
    for key, w in want.items():
        assert w.shape[2] == cfg.num_kv_heads          # every head
        np.testing.assert_allclose(r["payload"][key], w, rtol=0, atol=ATOL)
        np.testing.assert_array_equal(r["back"][key], r["payload"][key])
    assert r["first"] == first and r["stream"] == stream
    for follower in got[1:]:
        assert follower["replayed"] == got[0]["emitted"]
    gathers = [g["stats"]["kv_gather_calls"] for g in got]
    # the leader's tp row (ranks 0, 1) joins the heads; the fsdp replica
    # row (ranks 2, 3) gathers nothing
    assert gathers == [4, 4, 0, 0]
    assert all(g["stats"]["kv_deliver_calls"] == 2 for g in got)


EMBED_BATCH = [[5, 9, 200, 17, 3], list(range(1, 40)), [42] * 12]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_embed_on_a_3d_mesh_equals_jax(shape, world2, world4):
    """``engine.embed`` on a 3-D mesh: every layer of the encode gathers
    its slices over fsdp as the spec table says, so the vectors equal the
    JAX engine's on the same mesh, and the port's ``(1, tp)`` mesh's
    bitwise."""
    engine = JaxEngine(JaxModelConfig.tiny(**MC_KW),
                       JaxEngineConfig(mesh_shape=shape, **MESH_ENG_KW),
                       seed=0, devices=jax.devices("cpu"))
    tree = numpy_tree(engine.params)
    want = np.asarray(asyncio.run(engine.embed(EMBED_BATCH)), np.float32)
    asyncio.run(engine.stop())
    world = _world(shape, world2, world4)
    got = world.run(tw.mesh_script, MC_KW, tree,
                    dict(mesh_shape=shape, **MESH_ENG_KW), "embed",
                    EMBED_BATCH)
    np.testing.assert_allclose(got[0]["result"], want, rtol=0, atol=ATOL)
    for follower in got[1:]:
        assert follower["replayed"] == got[0]["emitted"]
    assert all(g["stats"]["fsdp_gather_calls"] > 0 for g in got)
    tp = world2.run(tw.mesh_script, MC_KW, tree,
                    dict(mesh_shape=_tp_mesh(shape), **MESH_ENG_KW),
                    "embed", EMBED_BATCH)
    np.testing.assert_array_equal(got[0]["result"], tp[0]["result"])


# ------------------------------ sharded loader -----------------------------


def _assert_bitwise(a, b):
    a, b = a.contiguous(), b.contiguous()
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 1)],
                         ids=["1x2x2", "2x2x1"])
@pytest.mark.parametrize("cfg_name,weight_dtype", [
    ("tiny", "bf16"), ("tiny", "int8"), ("tiny_moe", "bf16"),
])
def test_sharded_loader_slices_equal_full_load_and_jax(tmp_path, shape,
                                                       cfg_name,
                                                       weight_dtype):
    tc = getattr(tcfg.ModelConfig, cfg_name)()
    jc = getattr(JaxModelConfig, cfg_name)()
    params = tweights.params_from_numpy(
        numpy_tree(jm.init_params(jax.random.PRNGKey(0), jc)), tc, "cpu")
    tweights.save_hf_params(tmp_path, params, tc, n_shards=2)
    full = tweights.load_hf_params(tmp_path, tc, weight_dtype, device="cpu")
    jmesh = jax_make_mesh(shape, jax.devices("cpu"))
    jshards = jweights.load_hf_params_sharded(str(tmp_path), jc, jmesh,
                                              weight_dtype)
    specs = SpecLayout.for_mesh(shape).param_specs(tc, weight_dtype)
    dp, fs, tp = shape
    for rank in range(dp * fs * tp):
        coords = {"dp": rank // (fs * tp), "fsdp": (rank // tp) % fs,
                  "tp": rank % tp}
        mesh = Mesh({"dp": dp, "fsdp": fs, "tp": tp}, coords)
        got = tweights.load_hf_params_sharded(tmp_path, tc, mesh,
                                              weight_dtype, device="cpu")
        assert tweights.last_load_stats["fsdp_shard"] == (coords["fsdp"], fs)

        def check(leaf, ref, sp, jleaf):
            _assert_bitwise(leaf, shard_tensor(ref, sp, mesh))
            for sh in jleaf.addressable_shards:
                if sh.device == jax.devices("cpu")[rank]:
                    np.testing.assert_array_equal(leaf.numpy(),
                                                  np.asarray(sh.data))

        def walk(a, r, s, j):
            if isinstance(s, dict):
                for k in s:
                    walk(a[k], r[k], s[k], j[k])
            else:
                check(a, r, s, j)

        walk(got, full, specs, jshards)
