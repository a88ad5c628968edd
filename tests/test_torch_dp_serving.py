"""Data-parallel rows and sequence-parallel prefill across several
requests in the port, held against the JAX package on the same ``(dp,
tp)`` mesh (the helpers and prompts of
``tests/test_torch_sequence_parallel.py``; each port rank a process of a
gloo world on the CPU):

- the dense path (no sp threshold) on (2, 2) and (2, 1): the dp rows
  replicate the tensor-parallel step, and the streams equal the JAX
  engine's on that mesh (the JAX worker's ``--mesh D,N`` with D > 1);
- ``tiny_moe`` on (2, 2) with sp, on the synchronous loop (ROADMAP
  finding c): the JAX engine's streams;
- two long prompts one after another on (2, 2): two sp prefills on every
  rank, every follower replays both ``rsp`` plans, and the streams are
  the one-device chunked run's.
"""

import asyncio
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402
from test_torch_sequence_parallel import (  # noqa: E402
    DECODE_PROMPT, ENG_KW, SHORT_PROMPT, SP, SP_PROMPT, SP_PROMPT2,
    _check_ranks, _jax_engine, _jax_streams, _req, _world, numpy_tree,
    one_device,
)


@pytest.fixture(scope="module")
def world2():
    with tw.World(2) as w:
        yield w


@pytest.fixture(scope="module")
def world4():
    with tw.World(4) as w:
        yield w


def test_followers_replay_every_rsp_plan(world4, one_device):
    tree, ref = one_device
    got = world4.run(tw.serve, "tiny", tree,
                     dict(mesh_shape=(2, 2), sp_prefill_threshold=SP,
                          **ENG_KW), [_req(SP_PROMPT), _req(SP_PROMPT2)],
                     "bf16", None, True)
    _check_ranks(got, 2)
    assert got[0]["streams"] == [ref["sp"], ref["sp2"]]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)], ids=["2x2", "2x1"])
def test_dense_dp_tp_streams_match_jax(shape, world2, world4):
    """No threshold: the dp rows replicate the tensor-parallel step (the
    JAX worker's dp > 1 without sp)."""
    requests = [_req(DECODE_PROMPT, 8), _req(SP_PROMPT)]
    jengine = _jax_engine(shape=shape)
    want = asyncio.run(_jax_streams(jengine, requests, sequential=False))
    got = _world(shape, world2, world4).run(
        tw.serve, "tiny", numpy_tree(jengine.params),
        dict(mesh_shape=shape, **ENG_KW), requests)
    _check_ranks(got, 0)
    assert got[0]["streams"] == want


def test_moe_sp_streams_match_jax_on_the_synchronous_loop(world4):
    """tiny_moe, experts over tp 2, prompts split over dp 2: capacity
    routing sees the whole chunk in order (each rank gathers its MoE input
    rows over the dp column), as the JAX package's GSPMD program does."""
    shape = (2, 2)
    requests = [_req(SP_PROMPT), _req(SHORT_PROMPT)]
    kw = dict(sp_prefill_threshold=SP, pipeline_depth=1)
    jengine = _jax_engine("tiny_moe", shape=shape, **kw)
    want = asyncio.run(_jax_streams(jengine, requests))
    assert jengine.num_sp_prefills == 1
    got = world4.run(tw.serve, "tiny_moe", numpy_tree(jengine.params),
                     dict(mesh_shape=shape, **kw, **ENG_KW), requests,
                     "bf16", None, True)
    _check_ranks(got, 1)
    assert got[0]["streams"] == want
