"""The port's checkpoints (``dynamo_tpu_torch.engine.weights``
``save_checkpoint`` / ``load_checkpoint`` / ``abstract_params``) against
the JAX package's orbax ones:

- a bitwise round trip of the tiny model at f32 and bf16, of int8 and fp8
  quantized trees, of tiny_moe, across several files, with the same bytes
  for the same tree and the manifest the format promises;
- one numpy tree saved and restored by JAX's orbax pair and by the port's,
  both equal to the numpy tree leaf for leaf;
- sharded restores in gloo worlds of 2 and 4 ranks: each rank's leaves
  equal ``shard_params`` of the full tree bitwise and the matching
  addressable shard of JAX's ``load_checkpoint(cfg=, mesh=)``, and each
  rank reads only its slices;
- a wrong target raises naming the leaf; ``abstract_params`` equals JAX's
  (shapes, dtypes, and each leaf's spec the axes of its NamedSharding);
- a restored tree serves the same greedy streams as the original and as
  the JAX engine.
"""

import asyncio
import dataclasses
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import ModelConfig as JaxModelConfig
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu.engine import model as jm
from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.parallel.layout import make_mesh as jax_make_mesh
from dynamo_tpu_torch.engine import (
    EngineConfig, InferenceEngine, ModelConfig, Request,
)
from dynamo_tpu_torch.engine import model as tm
from dynamo_tpu_torch.engine import quant as tquant
from dynamo_tpu_torch.engine import weights as tweights
from dynamo_tpu_torch.engine.safetensors import SafeFile
from dynamo_tpu_torch.parallel.layout import Mesh

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402

MESHES = [(1, 2), (2, 1), (1, 2, 1), (1, 2, 2)]
IDS = ["1x2", "2x1", "1x2x1", "1x2x2"]


def numpy_tree(tree):
    """JAX params as numpy leaves: bf16 as uint16 bits, fp8 as uint8."""
    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return a.view(np.uint16)
        if a.dtype.name == "float8_e4m3fn":
            return a.view(np.uint8)
        return a
    return jax.tree.map(leaf, tree)


def flat(tree):
    return dict(tweights._flatten(tree))


def assert_bitwise(a, b):
    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert (tw._np_bits(fa[k]).tobytes()
                == tw._np_bits(fb[k]).tobytes()), k


def tree_of(cfg_name, weight_dtype="bf16", dtype=None, seed=0):
    cfg = getattr(ModelConfig, cfg_name)()
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    params = tm.init_params(torch.Generator().manual_seed(seed), cfg)
    if tquant.is_quantized(weight_dtype):
        params = tquant.quantize_params(params, weight_dtype)
    return cfg, params


# ------------------------------ round trips --------------------------------


@pytest.mark.parametrize("cfg_name,weight_dtype,dtype", [
    ("tiny", "bf16", None), ("tiny", "bf16", "bfloat16"),
    ("tiny", "int8", "bfloat16"), ("tiny", "fp8", "bfloat16"),
    ("tiny_moe", "bf16", None), ("tiny_moe", "int8", None),
], ids=["f32", "bf16", "int8", "fp8", "moe", "moe-int8"])
def test_round_trip_is_bitwise(tmp_path, cfg_name, weight_dtype, dtype):
    cfg, params = tree_of(cfg_name, weight_dtype, dtype)
    tweights.save_checkpoint(tmp_path, params, cfg)
    assert_bitwise(tweights.load_checkpoint(tmp_path, device="cpu"), params)
    # with cfg the target comes from abstract_params: the same tree
    assert_bitwise(tweights.load_checkpoint(tmp_path, cfg=cfg,
                                            device="cpu"), params)
    man = tweights.read_manifest(tmp_path)
    assert man["format"] == tweights.CHECKPOINT_FORMAT
    assert man["version"] == tweights.CHECKPOINT_VERSION
    assert man["config"] == dataclasses.asdict(cfg)
    dtypes = {e["path"]: e["dtype"] for e in man["leaves"]}
    shapes = {e["path"]: e["shape"] for e in man["leaves"]}
    assert set(dtypes) == set(flat(params))
    for k, t in flat(params).items():
        assert shapes[k] == list(t.shape)
    if weight_dtype == "fp8":
        assert dtypes["layers/wq/q"] == "F8_E4M3"
        assert dtypes["layers/wq/s"] == "F32"
    if cfg.is_moe:
        # MoE stacks stay whole: one [L, E, D, F] leaf
        assert shapes["layers/w_gate" + ("/q" if weight_dtype != "bf16"
                                         else "")] == [
            cfg.num_layers, cfg.num_experts, cfg.hidden_size,
            cfg.intermediate_size]


def test_same_tree_gives_same_bytes_across_files(tmp_path, monkeypatch):
    cfg, params = tree_of("tiny")
    monkeypatch.setattr(tweights, "CHECKPOINT_FILE_BYTES", 100_000)
    for d in ("a", "b"):
        tweights.save_checkpoint(tmp_path / d, params, cfg)
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert len(names) > 1 and names == sorted(
        p.name for p in (tmp_path / "b").iterdir())
    for n in names:
        assert (tmp_path / "a" / n).read_bytes() == (
            tmp_path / "b" / n).read_bytes()
    assert_bitwise(tweights.load_checkpoint(tmp_path / "a", device="cpu"),
                   params)
    # every file carries the whole manifest; a later save replaces them
    with SafeFile(tmp_path / "a" / names[-1]) as sf:
        assert json.loads(sf.metadata()["manifest"]) == \
            tweights.read_manifest(tmp_path / "a")
    monkeypatch.undo()
    tweights.save_checkpoint(tmp_path / "a", params, cfg)
    assert len(list((tmp_path / "a").iterdir())) == 1


def test_orbax_and_port_restore_the_same_numpy_tree(tmp_path):
    jc = JaxModelConfig.tiny()
    jtree = jm.init_params(jax.random.PRNGKey(0), jc)
    want = numpy_tree(jtree)
    jweights.save_checkpoint(str(tmp_path / "orbax"), jtree)
    jgot = jweights.load_checkpoint(str(tmp_path / "orbax"))
    tc = ModelConfig.tiny()
    tweights.save_checkpoint(
        tmp_path / "port", tweights.params_from_numpy(want, tc, "cpu"), tc)
    tgot = tweights.load_checkpoint(tmp_path / "port", device="cpu")
    jflat = flat(jax.tree.map(np.asarray, jgot))
    for k, a in flat(want).items():
        np.testing.assert_array_equal(jflat[k], a)
        np.testing.assert_array_equal(flat(tgot)[k].numpy(), a)


# ------------------------------ sharded restore -----------------------------


@pytest.fixture(scope="module")
def world2():
    with tw.World(2) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with tw.World(4) as w:
        yield w


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The JAX tiny tree saved by orbax and by the port."""
    d = tmp_path_factory.mktemp("ckpt")
    jc = JaxModelConfig.tiny()
    jtree = jm.init_params(jax.random.PRNGKey(0), jc)
    jweights.save_checkpoint(str(d / "orbax"), jtree)
    tc = ModelConfig.tiny()
    tweights.save_checkpoint(
        d / "port", tweights.params_from_numpy(numpy_tree(jtree), tc, "cpu"),
        tc)
    return d


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sharded_restore_equals_shard_params_and_jax_shards(
        saved, world2, world4, cpu_devices, shape):
    world = world4 if np.prod(shape) == 4 else world2
    out = world.run(tw.ckpt_restore, str(saved / "port"), "tiny", shape)
    jmesh = jax_make_mesh(shape, cpu_devices)
    jgot = flat(jweights.load_checkpoint(
        str(saved / "orbax"), cfg=JaxModelConfig.tiny(), mesh=jmesh))
    full = sum(t.numel() * t.element_size() for t in flat(
        tweights.load_checkpoint(saved / "port", device="cpu")).values())
    for rank, (same, read, leaves) in enumerate(out):
        assert same, f"rank {rank}: restore != shard_params"
        assert read == sum(a.nbytes for a in leaves.values())
        if shape[-1] * (shape[1] if len(shape) == 3 else 1) > 1:
            assert read < full    # a rank reads its slices only
        for k, a in leaves.items():
            shard, = [s for s in jgot[k].addressable_shards
                      if s.device == cpu_devices[rank]]
            np.testing.assert_array_equal(a, np.asarray(shard.data),
                                          err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_runs_read_exactly_the_slice(seed):
    """The contiguous runs a sharded restore reads (one ``pread`` each)
    hold exactly the slice's bytes, in its C order."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        shape = tuple(int(x) for x in rng.integers(1, 6, rng.integers(0, 5)))
        idx = []
        for n in shape:
            lo = int(rng.integers(0, n))
            idx.append(slice(lo, int(rng.integers(lo + 1, n + 1))))
        arr = np.arange(int(np.prod(shape)), dtype=np.int32).reshape(shape)
        raw = arr.tobytes()
        runs = tweights._block_runs(shape, tuple(idx), 4)
        assert b"".join(raw[o:o + n] for o, n in runs) == \
            arr[tuple(idx)].tobytes()
        # a run never stops where the next one goes on
        assert all(a + n < b for (a, n), (b, _) in zip(runs, runs[1:]))


@pytest.mark.parametrize("weight_dtype", ["int8", "fp8"])
def test_quantized_sharded_restore_equals_shard_params(tmp_path, world2,
                                                       weight_dtype):
    # the ranks build the tiny preset, so the tree is the preset's (f32)
    cfg, params = tree_of("tiny", weight_dtype, seed=1)
    tweights.save_checkpoint(tmp_path, params, cfg)
    for shape in ((1, 2), (1, 2, 1)):
        out = world2.run(tw.ckpt_restore, str(tmp_path), "tiny", shape,
                         weight_dtype)
        assert all(same for same, _, _ in out)


def test_moe_sharded_restore_reads_its_experts_only(tmp_path, world2):
    cfg, params = tree_of("tiny_moe")
    tweights.save_checkpoint(tmp_path, params, cfg)
    out = world2.run(tw.ckpt_restore, str(tmp_path), "tiny_moe", (1, 2))
    for rank, (same, _, leaves) in enumerate(out):
        assert same
        assert leaves["layers/w_gate"].shape[1] == cfg.num_experts // 2
        np.testing.assert_array_equal(
            leaves["layers/w_gate"],
            params["layers"]["w_gate"][:, rank * 4:(rank + 1) * 4].numpy())


# ------------------------------ targets ------------------------------------


def test_wrong_target_raises_naming_the_leaf(tmp_path):
    cfg, params = tree_of("tiny")
    tweights.save_checkpoint(tmp_path, params, cfg)
    target = tweights.abstract_params(cfg)
    wq = target["layers"]["wq"]
    target["layers"]["wq"] = dataclasses.replace(
        wq, shape=(wq.shape[0], wq.shape[1], wq.shape[2] + 1))
    with pytest.raises(ValueError, match="layers/wq "):
        tweights.load_checkpoint(tmp_path, target=target, device="cpu")
    target = tweights.abstract_params(cfg)
    target["final_norm"] = dataclasses.replace(target["final_norm"],
                                               dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="final_norm"):
        tweights.load_checkpoint(tmp_path, target=target, device="cpu")
    target = tweights.abstract_params(cfg)
    del target["layers"]["mlp_norm"]
    with pytest.raises(ValueError, match="layers/mlp_norm"):
        tweights.load_checkpoint(tmp_path, target=target, device="cpu")
    # a cfg that differs from the saved one is refused by field
    with pytest.raises(ValueError, match="num_layers"):
        tweights.load_checkpoint(
            tmp_path, cfg=dataclasses.replace(cfg, num_layers=3),
            device="cpu")
    # a target of tensors (the original tree) is a valid target
    assert_bitwise(tweights.load_checkpoint(tmp_path, target=params,
                                            device="cpu"), params)


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1), (1, 2, 2),
                                   (2, 2, 2)],
                         ids=["1x1", "1x2", "2x1", "1x2x2", "2x2x2"])
def test_abstract_params_equal_jax(cpu_devices, shape, weight_dtype):
    jmesh = jax_make_mesh(shape, cpu_devices)
    jabs = flat(jweights.abstract_params(JaxModelConfig.tiny(), jmesh,
                                         weight_dtype))
    names = ("dp", "tp") if len(shape) == 2 else ("dp", "fsdp", "tp")
    mesh = Mesh(dict(zip(names, shape)), {n: 0 for n in names})
    tabs = flat(tweights.abstract_params(ModelConfig.tiny(), mesh,
                                         weight_dtype))
    assert set(tabs) == set(jabs)
    for k, a in tabs.items():
        j = jabs[k]
        assert a.shape == tuple(j.shape), k
        assert str(a.dtype).removeprefix("torch.") == j.dtype.name, k
        if np.prod(shape) == 1:
            assert a.spec is None and j.sharding is None
        else:
            jspec = tuple(j.sharding.spec)
            assert a.spec == jspec + (None,) * (len(a.shape) - len(jspec)), k


# ------------------------------ serving ------------------------------------

ENG_KW = dict(block_size=4, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=64, max_model_len=128,
              decode_buckets=(4, 8), prefill_buckets=(16, 64))
PROMPTS = [[5, 6, 7], list(range(20, 41)), list(range(100, 170))]
MAX_TOKENS = [6, 9, 7]


async def _serve(engine, request_cls):
    async def one(i):
        req = request_cls(request_id=f"r{i}", token_ids=PROMPTS[i],
                          max_tokens=MAX_TOKENS[i])
        return [o.token_id async for o in engine.submit(req)]
    try:
        return await asyncio.gather(*(one(i) for i in range(len(PROMPTS))))
    finally:
        await engine.stop()


def test_restored_tree_serves_the_same_streams(tmp_path):
    jengine = JaxEngine(JaxModelConfig.tiny(), JaxEngineConfig(**ENG_KW),
                        seed=0)
    tree = numpy_tree(jengine.params)
    want = asyncio.run(_serve(jengine, JaxRequest))
    cfg = ModelConfig.tiny()
    params = tweights.params_from_numpy(tree, cfg, "cpu")
    tweights.save_checkpoint(tmp_path, params, cfg)
    streams = []
    for p in (params, tweights.load_checkpoint(tmp_path, cfg=cfg,
                                               device="cpu")):
        engine = InferenceEngine(cfg, EngineConfig(**ENG_KW), params=p,
                                 device="cpu")
        streams.append(asyncio.run(_serve(engine, Request)))
    assert [len(s) for s in streams[1]] == MAX_TOKENS
    assert streams[1] == streams[0] == want
