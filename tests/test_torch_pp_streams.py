"""Pipeline-parallel engines' streams in the port, held against the JAX
package and the port's one-rank engine: the port's pp-2 engine (rank 0
leads, rank 1 replays its ``p``/``d`` plans) over a gloo world on the CPU
(``torch_tp_world.py``), the JAX pp-2 engine over virtual CPU devices,
on the JAX engine's weights.

- greedy streams: port pp-2 = JAX pp-2 = port one-rank, for one prompt and
  for 6 concurrent prompts (dense; ``tiny_moe`` in
  ``test_torch_pp_moe_streams.py``);
- seeded sampling equals the port's one-rank engine (the draws differ
  from JAX's threefry by design);
- each stage posts one hop per microbatch, and only stage 0 sends.
"""

import asyncio
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig
from dynamo_tpu.engine import InferenceEngine as JaxEngine
from dynamo_tpu.engine import Request as JaxRequest
from dynamo_tpu_torch.engine import EngineConfig, InferenceEngine, Request
from dynamo_tpu_torch.engine.weights import params_from_numpy

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402
from test_torch_pp_serving import (  # noqa: E402
    ENG_KW, PP_KW, S, _jcfg, numpy_tree,
)

ONE_PROMPT = [dict(token_ids=[int(x) for x in
                              np.random.RandomState(0).randint(1, 500, 21)],
                   max_tokens=6, ignore_eos=True)]
CONCURRENT = [dict(token_ids=[int(x) for x in np.random.RandomState(i)
                              .randint(1, 500, 9 + 3 * i)],
                   max_tokens=5, ignore_eos=True) for i in range(6)]


@pytest.fixture(scope="module")
def world2():
    with tw.World(S) as w:
        yield w


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


def _port_one_rank(cfg_name, tree, requests, **kw):
    cfg = tw._cfg(cfg_name)
    engine = InferenceEngine(cfg, EngineConfig(**ENG_KW, **kw),
                             params=params_from_numpy(tree, cfg, "cpu"),
                             device="cpu")

    async def go():
        async def one(i, r):
            req = Request(request_id=f"r{i}", **r)
            return [o.token_id async for o in engine.submit(req)]
        try:
            return await asyncio.gather(*(one(i, r)
                                          for i, r in enumerate(requests)))
        finally:
            await engine.stop()
    return asyncio.run(go())


def _port_pp(world, cfg_name, tree, requests, M=4):
    got = world.run(tw.serve, cfg_name, tree,
                    dict(PP_KW, pp_microbatches=M), requests)
    lead, follower = got
    assert follower["replayed"] == lead["emitted"]
    assert set(lead["emitted"]) == {"p", "d"}
    # at S = 2 each stage posts one hop per microbatch: a prefill chunk
    # one (M clamps to 1), a decode batch of 8 rows M; only stage 0 sends
    assert lead["ppermute_calls"] == follower["ppermute_calls"] == (
        lead["emitted"]["p"] + M * lead["emitted"]["d"])
    assert lead["ppermute_bytes"] > 0 == follower["ppermute_bytes"]
    return lead["streams"]


def _three_ways(world, cfg_name, requests, M, devices):
    """(JAX pp-2, port pp-2, port one-rank) streams on the JAX engine's
    weights; the one-rank engine on the synchronous loop (ROADMAP finding
    c: an MoE stream on the run-ahead loop depends on landing times)."""
    jengine = JaxEngine(_jcfg(cfg_name),
                        JaxEngineConfig(**dict(PP_KW, pp_microbatches=M)),
                        seed=0, devices=devices[:S])
    tree = numpy_tree(jengine.params)
    want = asyncio.run(_jax_streams(jengine, requests))
    got = _port_pp(world, cfg_name, tree, requests, M)
    one = _port_one_rank(cfg_name, tree, requests, pipeline_depth=1)
    assert [len(s) for s in got] == [r["max_tokens"] for r in requests]
    return want, got, one


@pytest.mark.parametrize("requests", [ONE_PROMPT, CONCURRENT],
                         ids=["one_prompt", "concurrent"])
def test_engine_streams_match_jax_and_one_rank(world2, requests,
                                               cpu_devices):
    """Dense at M = 4 (the MoE engines are in
    ``test_torch_pp_moe_streams.py``)."""
    want, got, one = _three_ways(world2, "tiny:4", requests, 4, cpu_devices)
    assert got == want
    assert got == one


def test_seeded_sampling_matches_one_rank(world2):
    """Seeded rows key on (seed, position), so the pp engine's draws equal
    the one-rank engine's (both the port's counter-based hash)."""
    import dynamo_tpu_torch.engine.model as tm

    p = tm.init_params(torch.Generator().manual_seed(5), tw._cfg("tiny:4"))
    tree = {k: ({n: t.numpy() for n, t in v.items()}
                if isinstance(v, dict) else v.numpy())
            for k, v in p.items()}
    requests = [dict(token_ids=list(range(3, 20)), max_tokens=8,
                     temperature=0.9, seed=77, ignore_eos=True),
                dict(token_ids=list(range(30, 41)), max_tokens=8,
                     temperature=0.7, top_k=20, seed=5, ignore_eos=True)]
    got = _port_pp(world2, "tiny:4", tree, requests)
    one = _port_one_rank("tiny:4", tree, requests)
    assert got == one
    greedy = _port_one_rank("tiny:4", tree, [
        dict(r, temperature=0.0) for r in requests])
    assert got != greedy, "the sampled streams never left greedy"
