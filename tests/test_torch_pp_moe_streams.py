"""Pipeline-parallel MoE engines' streams in the port, held against the
JAX package and the port's one-rank engine, as ``test_torch_pp_streams.py``
holds the dense ones: ``tiny_moe`` at 4 layers, 6 concurrent prompts.

- at M = 1 a decode batch is one microbatch, so the experts' capacity is
  the one-rank engine's: port pp-2 = JAX pp-2 = port one-rank;
- at M = 4 an MoE layer's capacity is per microbatch, as in JAX: port
  pp-2 = JAX pp-2, parting from the one-rank engine.

Both cases run on the same weights (the JAX engine's, seed 0).
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).parent))
import torch_tp_world as tw  # noqa: E402
from test_torch_pp_serving import S  # noqa: E402
from test_torch_pp_streams import CONCURRENT, _three_ways  # noqa: E402


@pytest.fixture(scope="module")
def world2():
    with tw.World(S) as w:
        yield w


def test_moe_streams_match_jax_and_one_rank_at_one_microbatch(
        world2, cpu_devices):
    """M = 1: a decode batch is one microbatch, so its experts' capacity
    is the one-rank engine's (see the next test)."""
    want, got, one = _three_ways(world2, "tiny_moe:4", CONCURRENT, 1,
                                 cpu_devices)
    assert got == want
    assert got == one


def test_moe_capacity_is_per_microbatch_as_in_jax(world2, cpu_devices):
    """At M = 4 an MoE layer routes each microbatch of 2 decode rows on its
    own, with a capacity of ``ceil(2 * k / E * factor)`` = 1 slot per
    expert where the whole batch of 8 has 4: a row can lose an expert the
    one-rank engine gives it. The JAX pp step does the same
    (``dynamo_tpu/parallel/pp_serving.py`` ``_stage_layers``), so the
    port's streams equal JAX's and part from the one-rank engine's here
    (ROADMAP.md queue A, finding d)."""
    want, got, one = _three_ways(world2, "tiny_moe:4", CONCURRENT, 4,
                                 cpu_devices)
    assert got == want
    assert got != one
