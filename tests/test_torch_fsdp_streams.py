"""Greedy streams of the port's 3-D ``(dp, fsdp, tp)`` engine held
against the JAX engine on the same mesh (``tests/test_torch_fsdp.py``
holds the layout, ``forward``, the loader and KV movement):
``ModelConfig.tiny()`` and ``tiny_moe`` in float32, the JAX parameters
carried across by ``params_from_numpy``, each port rank a process of a
gloo world on the CPU (``torch_tp_world.py``; rank 0 leads, the others
replay its plans).

- Decode and chunked prefill on (1, 2, 1), (1, 2, 2) and (2, 2, 1), and
  ``tiny_moe`` on the synchronous loop (ROADMAP finding c) on (1, 2, 1)
  and (1, 2, 2): the streams equal the JAX engine's, the followers
  replayed exactly the leader's plans, every rank gathered its weights
  over its fsdp group, and after the run every rank still stores its
  shards (the gathered layers are never kept).
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
from dynamo_tpu_torch.engine import config as tcfg

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402

MESHES = [(1, 2, 1), (1, 2, 2), (2, 2, 1)]
IDS = ["1x2x1", "1x2x2", "2x2x1"]
ENG_KW = dict(block_size=4, num_blocks=128, max_num_seqs=8,
              max_num_batched_tokens=32, max_model_len=256,
              decode_buckets=(8,), prefill_buckets=(32,))
DECODE_PROMPT = [int(x) for x in np.random.RandomState(10).randint(1, 500, 12)]
CHUNKED_PROMPT = [int(x) for x in
                  np.random.RandomState(11).randint(1, 500, 96)]


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


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


async def _jax_streams(engine, requests):
    async def one(i, r):
        req = JaxRequest(request_id=f"r{i}", **r)
        return [o.token_id async for o in engine.submit(req)]
    try:
        return await asyncio.gather(*(one(i, r)
                                      for i, r in enumerate(requests)))
    finally:
        await engine.stop()


def _served(world, shape, cfg_name, eng_kw, requests):
    jc = getattr(JaxModelConfig, cfg_name)()
    jengine = JaxEngine(jc, JaxEngineConfig(mesh_shape=shape, **eng_kw),
                        seed=0, devices=jax.devices("cpu"))
    tree = numpy_tree(jengine.params)
    want = asyncio.run(_jax_streams(jengine, requests))
    got = world.run(tw.serve, cfg_name, tree,
                    dict(mesh_shape=shape, **eng_kw), requests)
    lead = got[0]
    for follower in got[1:]:
        assert follower["replayed"] == lead["emitted"]
    cfg = getattr(tcfg.ModelConfig, cfg_name)()
    for r in got:
        # the stored tree is still the shard after the steps
        assert r["wq"][1] == cfg.hidden_size // shape[1]
        assert r["fsdp_gather_calls"] > 0
    return want, lead


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_decode_and_chunked_prefill_streams_match_jax(shape, world2, world4):
    requests = [
        dict(token_ids=DECODE_PROMPT, max_tokens=8, ignore_eos=True),
        dict(token_ids=CHUNKED_PROMPT, max_tokens=6, ignore_eos=True),
    ]
    want, lead = _served(_world(shape, world2, world4), shape, "tiny",
                         ENG_KW, requests)
    assert lead["streams"] == want
    assert [len(s) for s in lead["streams"]] == [8, 6]
    assert lead["emitted"]["pp"] >= 4 and lead["emitted"]["w"] > 0


@pytest.mark.parametrize("shape", [(1, 2, 1), (1, 2, 2)],
                         ids=["1x2x1", "1x2x2"])
def test_moe_streams_match_jax(shape, world2, world4):
    """tiny_moe (expert stacks carry no fsdp entry; the attention leaves
    do) on the synchronous loop (ROADMAP finding c)."""
    requests = [
        dict(token_ids=list(range(1, 13)), max_tokens=6, ignore_eos=True),
        dict(token_ids=list(range(40, 80)), max_tokens=5, ignore_eos=True),
    ]
    want, lead = _served(_world(shape, world2, world4), shape, "tiny_moe",
                         dict(pipeline_depth=1, **ENG_KW), requests)
    assert lead["streams"] == want
